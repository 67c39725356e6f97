"""Build the Hopper kernels in ``repro_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with ``ctypes``.
Libraries go to ``build/repro_torch_kernels/<digest>/`` at the repository
root, keyed by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is reused.  The first use builds; nothing is
compiled when a module is imported.  Without ``nvcc`` a build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

KERNELS = ("scan_scores", "scan_scores_q8", "kmeans_assign", "segsum_gemm")
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[tuple, ctypes._CFuncPtr] = {}
# nvcc's diagnostics per kernel (ptxas registers / shared memory / spills)
build_log: Dict[str, str] = {}


class LaunchCounter:
    """Launches of one kernel, counted by its wrapper where it launches."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        with self._lock:
            return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


def entry(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point `symbol` of kernel `name` with its ctypes signature
    (every pointer and the stream as c_void_p, so none is cut to 32 bits)."""
    lib = load(name)
    with _lock:
        fn = _entries.get((name, symbol))
        if fn is None:
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _entries[(name, symbol)] = fn
        return fn


def check_launch(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's Hopper kernels are compiled from "
            f"{CSRC} at first use and need the CUDA toolkit")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_ROOT / _digest() / f"lib{name}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile the named kernels that are not built yet, one nvcc each, all
    started together.  Returns the seconds each build took (0.0 = reused).
    Raises RuntimeError with nvcc's output when a build fails."""
    names = list(names)
    out = {n: 0.0 for n in names}
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        dst = library_path(name)
        dst.parent.mkdir(parents=True, exist_ok=True)
        tmp = dst.with_name(f"{dst.name}.tmp.{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, dst, time.perf_counter())
    failed = []
    for name, (proc, tmp, dst, t0) in procs.items():
        log, _ = proc.communicate()
        out[name] = time.perf_counter() - t0
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, dst)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if name not in KERNELS:
                raise ValueError(f"unknown kernel {name!r}; have {KERNELS}")
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib
