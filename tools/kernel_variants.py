#!/usr/bin/env python3
"""What bounds kmeans_assign's kernels, on one NVIDIA card.

    python3 tools/kernel_variants.py [--seed N] [--out FILE]

Builds diagnostic variants of ``src/repro_torch/csrc/kmeans_assign.cu``,
each the committed source with one text substitution (one nvcc each, all
started together, into ``build/kernel_variants/<name>/``), loads each with
ctypes and times it beside the committed kernel, in turns (CUDA events,
launches queued behind a spin kernel), at the main path's shapes:

* the ``wgmma`` variant's streamed mode at phase 11a's build (M =
  1,000,000, C = 1024, D = 2048): its x ring cut from 6 slots to 3, its
  centroid ring from 4 to 2, and no slab traffic at all (the producer
  arrives on each slot's barrier without a TMA load, so the consumers
  multiply stale shared memory): a kernel whose time does not move
  without its loads is bound by its consumers, not by its stream;
* the f32-product rung at the PAPER_1M build (M = 1,000,000, C = D =
  1024): no slab traffic, and a block barrier between slabs in place of
  the per-slot empty barriers.

The variants' results are wrong by design; only the committed kernel's are
checked against the plain version.  Prints one JSON object (ms by shape
and variant, ``torch.mm`` beside each, the card); with ``--out`` also
writes it to FILE.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402

STREAMED = {
    "x_ring_3": [("constexpr int S_XSTAGES = 6;",
                  "constexpr int S_XSTAGES = 3;")],
    "c_ring_2": [("constexpr int S_CSTAGES = 4;",
                  "constexpr int S_CSTAGES = 2;")],
    "no_traffic": [
        ("bar_expect_tx(&x_full[rx.stage], S_XSTAGE_BYTES);\n"
         "              tma_load_multicast(",
         "scan_stream::bar_arrive(&x_full[rx.stage]);\n"
         "              if (false) tma_load_multicast("),
        ("bar_expect_tx(&c_full[rc.stage], HALVES * HALF_BYTES);\n"
         "              for (int h = 0; h < HALVES; ++h)",
         "scan_stream::bar_arrive(&c_full[rc.stage]);\n"
         "              for (int h = 0; h < 0; ++h)")],
}
F32 = {
    "no_traffic": [
        ("    scan_stream::bar_expect_tx(bar, TMA_STAGE_BYTES);\n"
         "    scan_stream::tma_load(st, &x_map, bar, (s % nk) * TMA_BK, m0);\n"
         "    scan_stream::tma_load(st + TMA_A_BYTES, &c_map, bar,",
         "    scan_stream::bar_arrive(bar);\n"
         "    if (false) scan_stream::tma_load(st + TMA_A_BYTES, &c_map, bar,")],
    "block_barrier": [
        ("      __syncwarp();\n"
         "      if (lane == 0) scan_stream::bar_arrive(&empty[s % TMA_STAGES]);\n"
         "      if (tid == 0 && s > 0 && s - 1 + TMA_STAGES < total) {\n"
         "        scan_stream::bar_wait(&empty[(s - 1) % TMA_STAGES],\n"
         "                              ((s - 1) / TMA_STAGES) & 1);\n"
         "        issue(s - 1 + TMA_STAGES);\n"
         "      }",
         "      __syncthreads();\n"
         "      if (tid == 0 && s + TMA_STAGES < total) "
         "issue(s + TMA_STAGES);")],
}


def build_variants(variants: dict) -> dict:
    """name -> loaded library of each variant (and of the committed source,
    "committed")."""
    from repro_torch.kernels import build

    src = (build.CSRC / "kmeans_assign.cu").read_text()
    out_root = os.path.join(ROOT, "build", "kernel_variants")
    procs = {}
    for name, subs in {"committed": [], **variants}.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: the source has no "
                                   f"{old.splitlines()[0]!r}")
            text = text.replace(old, new)
        d = os.path.join(out_root, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "kmeans_assign.cu"), "w") as f:
            f.write(text)
        shutil.copy(build.CSRC / "scan_stream.cuh", d)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o",
               os.path.join(d, "lib.so"), os.path.join(d, "kmeans_assign.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        libs[name] = ctypes.CDLL(os.path.join(out_root, name, "lib.so"))
    return libs


def streamed_call(lib, x, cent):
    """The wrapper's streamed launch, through `lib`."""
    from repro_torch.kernels import kmeans_assign as ka

    (m, d), c, dev = x.shape, cent.shape[0], x.device
    fn = lib.kmeans_assign_wgmma_launch
    fn.argtypes, fn.restype = list(ka._WGMMA_ARGTYPES), ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cp, dp = ka._round_up(c, ka.CTILE), ka._round_up(d, ka.KSLAB)
    cb = torch.empty((cp, dp), dtype=torch.bfloat16, device=dev)
    cnorm = torch.empty((cp,), device=dev)
    keys = torch.empty((m + ka._streamed_tiles(m),), dtype=torch.int64,
                       device=dev)
    idx = torch.empty((m,), dtype=torch.int32, device=dev)
    dist = torch.empty((m,), device=dev)
    split = ka.c_split(m, c, sms, "streamed")
    halves = ka.tile_width(m, sms) // ka.HALF

    def run():
        err = fn(x.data_ptr(), cent.data_ptr(), cb.data_ptr(),
                 cnorm.data_ptr(), idx.data_ptr(), dist.data_ptr(),
                 keys.data_ptr(), m, c, d, cp, dp, split, 1, halves,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err} at launch")
        return idx, dist
    return run


def f32_call(lib, x, cent):
    """The wrapper's f32-product launch, through `lib`."""
    from repro_torch.kernels import kmeans_assign as ka

    (m, d), c, dev = x.shape, cent.shape[0], x.device
    fn = lib.kmeans_assign_launch
    fn.argtypes, fn.restype = list(ka._ARGTYPES), ctypes.c_int
    cnorm = (cent ** 2).sum(1)
    idx = torch.empty((m,), dtype=torch.int32, device=dev)
    dist = torch.empty((m,), device=dev)

    def run():
        err = fn(x.data_ptr(), cent.data_ptr(), cnorm.data_ptr(),
                 idx.data_ptr(), dist.data_ptr(), m, c, d, 1, 1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err} at launch")
        return idx, dist
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_variants({**{f"streamed_{k}": v for k, v in STREAMED.items()},
                           **{f"f32_{k}": v for k, v in F32.items()}})
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    out = {"card": chip_smoke.nvidia_smi(), "torch": torch.__version__}
    for label, (m, c, d), kind, call in (
            ("streamed M=1000000 C=1024 D=2048", (1_000_000, 1024, 2048),
             "streamed", streamed_call),
            ("f32 M=1000000 C=1024 D=1024", (1_000_000, 1024, 1024), "f32",
             f32_call)):
        x = torch.randn(m, d, generator=g, device=dev)
        cent = torch.randn(c, d, generator=g, device=dev)
        runs = {n: call(lib, x, cent) for n, lib in libs.items()
                if n == "committed" or n.startswith(kind + "_")}
        idx, dist = runs["committed"]()
        chip_smoke.check_assign(x, cent, idx, dist, fused=kind != "f32")
        if kind == "f32":
            runs["torch.mm f32"] = lambda: torch.mm(x, cent.t())
        else:
            xb, cbf = x.to(torch.bfloat16), cent.to(torch.bfloat16)
            runs["torch.mm bf16"] = lambda: torch.mm(xb, cbf.t())
        out[label] = chip_smoke.race(runs, 10 if kind == "streamed" else 3)
        print(label, json.dumps(out[label]), flush=True)
        del x, cent, runs
        torch.cuda.empty_cache()
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
