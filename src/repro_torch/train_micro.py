"""Train a ~100M-parameter LM for a few hundred steps on the port.

    python -m repro_torch.train_micro [--steps 200] [--device cpu]

The counterpart of ``examples/train_micro.py``: the granite family at a
~100M scale (12 layers x 768, vocab 16,384) with the production `Trainer`
(checkpoint/restart, preemption guard, straggler monitor), on the CUDA
card unless ``--device`` names another.  The loss should fall from
~ln(V) as the model memorizes the synthetic stream's bigram structure.
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.configs import registry
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import Prefetcher, TokenDataset
from repro_torch.models import api
from repro_torch.train.trainer import Trainer


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    # ~100M params: 12L x 768d, vocab 16384
    cfg = registry.get_arch("granite-3-2b").replace(
        name="granite-100m", num_layers=12, d_model=768, num_heads=12,
        num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=16_384,
        scan_period=1)
    print(f"params: {cfg.param_count():,}")

    tc = TrainConfig(learning_rate=1e-3, warmup_steps=20,
                     total_steps=args.steps, grad_accum=1)
    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="ame_ckpt_")
    trainer = Trainer(cfg, tc, checkpoint_dir=ckpt_dir, checkpoint_every=100,
                      device=args.device)
    if trainer.maybe_restore():
        print(f"resumed from step {trainer.step_num}")

    ds = TokenDataset(None, vocab_size=cfg.vocab_size, seq_len=args.seq,
                      batch_size=args.batch, synthetic_tokens=1 << 20)
    batches = Prefetcher(api.adapt_batches(ds, cfg), depth=2)
    try:
        hist = trainer.train(batches, args.steps, log_every=20)
    finally:
        batches.close()
    losses = [h["loss"] for h in hist]
    print(f"loss: first={losses[0]:.3f} last={losses[-1]:.3f} "
          f"(improved {losses[0] - losses[-1]:.3f})")
    trainer.save(async_=False)
    print(f"checkpoint at step {trainer.step_num} -> {ckpt_dir}")
    return hist


if __name__ == "__main__":
    main()
