"""Atomic, async checkpointing; port of ``src/repro/checkpoint/checkpointer.py``
(the reference's on-disk layout, without jax).

Layout: <dir>/step_<N>/
  manifest.json   — tree structure, shapes, dtypes, leaf filenames
  arr_<i>.npy     — one file per leaf (full arrays, on the host)
  COMMIT          — written last; a checkpoint without COMMIT is ignored
                    (crash-safe: partial writes never load)

Leaves are numbered in the order ``jax.tree.flatten`` gives the same tree —
a dict's keys sorted, a list's or tuple's items in order, ``None`` no leaf —
so each package restores the other's checkpoints.  `save_async` snapshots
the tensors to the host, then writes on a background thread; ``keep_n``
garbage-collects old steps.  `restore` rebuilds the tree, as numpy arrays,
as tensors on a given device, or placed on a mesh (``shardings=``: each
full array cut onto its shards, a `repro_torch.models.sharding.Placed`).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike


def _flatten(tree: Any, out: List[Any]) -> str:
    """Append the leaves of `tree` to `out` in jax's flatten order; returns
    the structure in the reference's ``PyTreeDef`` notation."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        parts = [f"{k!r}: {_flatten(tree[k], out)}" for k in sorted(tree)]
        return "{" + ", ".join(parts) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_flatten(v, out) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    out.append(tree)
    return "*"


def _unflatten(like: Any, leaves) -> Any:
    """`like`'s structure with its leaves taken from the iterator `leaves`."""
    if like is None:
        return None
    if isinstance(like, dict):
        # fill in sorted-key order, keep the caller's key order
        filled = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: filled[k] for k in like}
    if isinstance(like, (list, tuple)):
        items = [_unflatten(v, leaves) for v in like]
        return items if isinstance(like, list) else tuple(items)
    return next(leaves)


def _host(leaf: Any, copy: bool = False) -> np.ndarray:
    """`leaf` as a host array; with `copy`, one that shares no memory with
    it (``.cpu()`` of a host tensor and ``np.asarray`` of an array return
    the same memory, which the caller may go on changing in place).  A
    leaf placed on a mesh is saved whole; one spread over processes
    raises, as the reference's ``np.asarray`` of an array spread over hosts
    does (there is no distributed checkpoint in either package)."""
    if hasattr(leaf, "full"):        # a sharding.Placed, a specs.Stacked
        owners = getattr(getattr(leaf, "mesh", None), "owners", None)
        if owners is not None and len(set(owners)) > 1:
            raise RuntimeError(
                "the Checkpointer saves whole leaves from one process and "
                "this leaf is spread over several (a mesh over processes): "
                "as the reference's, it has no distributed checkpoint")
        return leaf.full("cpu").numpy()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if copy and t.device == leaf.device:
            t = t.clone()
        return t.numpy()
    return np.array(leaf) if copy else np.asarray(leaf)


class Checkpointer:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any) -> str:
        leaves: List[Any] = []
        treedef = _flatten(tree, leaves)
        return self._write(step, [_host(x) for x in leaves], treedef)

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()
        leaves: List[Any] = []
        treedef = _flatten(tree, leaves)
        host = [_host(x, copy=True) for x in leaves]   # snapshot now

        def work():
            try:
                self._write(step, host, treedef)
            except BaseException as e:   # noqa: BLE001 — raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    # ------------------------------------------------------------------
    def _write(self, step: int, host_leaves, treedef: str) -> str:
        path = os.path.join(self.dir, f"step_{step:08d}")
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "treedef": f"PyTreeDef({treedef})",
                    "leaves": []}
        for i, arr in enumerate(host_leaves):
            fname = f"arr_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append(
                {"file": fname, "shape": list(arr.shape),
                 "dtype": str(arr.dtype)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write("ok")
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)          # atomic publish
        self._gc()
        return path

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_n] if self.keep_n else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for d in sorted(os.listdir(self.dir)):
            if d.startswith("step_") and not d.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, d, "COMMIT")):
                out.append(int(d.split("_")[1]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, step: Optional[int] = None,
                device: DeviceLike = None, shardings: Any = None) -> Any:
        """Restore into the structure of `tree_like`: numpy leaves, tensors
        on `device` when one is given, or with `shardings` (a tree of the
        same structure whose leaves are
        `repro_torch.models.sharding.NamedSharding`s) each full array
        placed on its mesh."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint found in {self.dir!r}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves_meta = manifest["leaves"]
        target: List[Any] = []
        _flatten(tree_like, target)
        if len(leaves_meta) != len(target):
            raise ValueError(f"checkpoint has {len(leaves_meta)} leaves, "
                             f"target structure {len(target)}")
        arrs = (np.load(os.path.join(path, m["file"])) for m in leaves_meta)
        if shardings is not None:
            places: List[Any] = []
            _flatten(shardings, places)
            if len(places) != len(target):
                raise ValueError(f"{len(places)} shardings for "
                                 f"{len(target)} leaves")
            arrs = (sh.place(torch.from_numpy(a))
                    for a, sh in zip(arrs, places))
        elif device is not None:
            arrs = (torch.from_numpy(a).to(device) for a in arrs)
        return _unflatten(tree_like, arrs)
