"""End-to-end entry point of the port: an agent serving loop (paper Fig. 1).

    python -m repro_torch.serve_agent [--arch granite-3-2b] [--device cpu]

The counterpart of ``examples/serve_agent.py``: a reduced LM and the
agentic memory service run the paper's full loop,
  1. the agent holds "memories" (embedded interactions),
  2. each user request embeds the prompt and retrieves its top-k memories,
  3. retrieval output conditions generation (soft-prefix splice),
  4. the turn itself goes back into the memory as a concurrent insert
     through the service's windowed scheduler — queries keep flowing while
     the memory learns (query-update hybrid template).

It runs `repro_torch.launch.serve` turn by turn, on the CUDA card unless
``--device`` names another (the reference's ``use_kernel=False`` only
spared its CPU interpret mode: on the card the kernels run).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import EngineConfig
from repro_torch.device import resolve_device
from repro_torch.launch import serve
from repro_torch.models import lm


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b",
                    choices=[a for a in registry.list_archs()
                             if registry.get_arch(a).family != "encdec"])
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = registry.reduced_arch(args.arch)
    ecfg = EngineConfig(dim=cfg.d_model, n_clusters=128, list_capacity=64,
                        nprobe=16, k=4)
    dev = resolve_device(args.device)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)

    rng = np.random.default_rng(0)
    seed_mem = rng.standard_normal((1024, ecfg.dim), dtype=np.float32)
    svc, agent_mem, _ = serve.build_memory(
        ecfg, seed_mem / np.linalg.norm(seed_mem, axis=1, keepdims=True),
        device=dev, name="agent")
    try:
        print(f"agent memory online: {agent_mem.stats()['live']} memories "
              f"on {serve.device_name(dev)}")
        out = serve.serve(cfg, ecfg, params, svc, agent_mem, requests=2,
                          prompt_len=64, decode_steps=args.decode_steps,
                          turns=args.turns, insert_queries=True)
        for turn, t in enumerate(out["turns"]):
            print(f"turn {turn}: retrieved memories {t['ids'][0].tolist()}"
                  f" -> generated tokens {t['tokens'][0].tolist()}")
        st = svc.stats()
        print(f"after {args.turns} turns: "
              f"{st['collections']['agent']['live']} memories, "
              f"scheduler {st['scheduler'].get('completed', 0)} tasks")
    finally:
        serve.close(svc)
    return out


if __name__ == "__main__":
    main()
