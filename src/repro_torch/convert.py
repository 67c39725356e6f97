"""Carry an IVF state, or a model's weights, across between the JAX package
and the port.

A state of the reference, brought to the host (``jax.device_get``), is a
NamedTuple of numpy arrays with the same field names, shapes and dtypes as
the port's `IVFState`; these two functions move it bit for bit.  The parity
tests run both packages on one index this way.

A sharded state of the reference is one such NamedTuple in its global
layout (lists ``[C, L*S, D]``, per-shard scalars stacked); the port holds
it as a tuple of S shard-local states on a `ShardMesh`.  The sharded pair
moves between the two, bit for bit, through
`repro_torch.core.distributed.split_host` / `assemble_host`.

A model of the reference is the pytree `repro.models.lm.init_params`
returns (host arrays: ``embed.table``, ``head.w`` unless tied,
``final_norm``, the blocks' leaves stacked ``[L, ...]`` — the MoE
experts' ``mlp.*``, rwkv6's and mamba2's flat leaves — zamba2's
unstacked ``shared_attn``, and the enc-dec family's ``enc_blocks`` and
``dec_blocks`` (with ``ln_cross`` and ``cross``), each stacked over its
own depth, and ``enc_final_norm``); `lm_params_from_numpy` / `lm_params_to_numpy`
move it onto the port's modules and back, and `lm_params_to_mesh` cuts it
straight onto a mesh (`repro_torch.models.specs.ShardedLM`) without
building the whole model on a device.  Weight matrices are cast to
``cfg.dtype`` once on the way in (bit-equal to the reference's cast at
every use); vectors and rwkv6's bonus ``u`` stay f32, as the reference
uses them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distributed import ShardMesh, assemble_host, \
    share_centroids, split_host
from repro_torch.core.index import IVFState
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm, specs


def ivf_state_from_numpy(state, device: DeviceLike = None) -> IVFState:
    """The port's IVFState on `device` from any NamedTuple of host arrays
    with IVFState's fields (unset ``q_*`` fields stay None)."""
    dev = resolve_device(device)
    fields = {}
    for name in IVFState._fields:
        value = getattr(state, name, None)
        fields[name] = None if value is None else torch.from_numpy(
            np.array(value, copy=True)).to(dev)
    return IVFState(**fields)


def ivf_state_to_numpy(state: IVFState) -> IVFState:
    """An IVFState of host numpy arrays (the reference's host layout)."""
    return IVFState(**{
        name: None if value is None else value.detach().cpu().numpy()
        for name, value in state._asdict().items()})


def sharded_state_from_numpy(state, mesh: ShardMesh) -> tuple:
    """The port's sharded state on `mesh` (shard i on ``mesh.devices[i]``,
    one centroids tensor per device) from a reference state in the global
    sharded layout, as host arrays."""
    return share_centroids([
        ivf_state_from_numpy(local, dev)
        for local, dev in zip(split_host(state, mesh.size), mesh.devices)])


def sharded_state_to_numpy(state) -> IVFState:
    """A port sharded state as one IVFState of numpy arrays in the
    reference's global layout."""
    return assemble_host(state)


def _stacks(cfg: ModelConfig) -> dict:
    """The model's stacked block groups and their depths."""
    if cfg.family == "encdec":
        return {"enc_blocks": cfg.num_enc_layers,
                "dec_blocks": cfg.num_dec_layers}
    return {"blocks": cfg.num_layers}


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def _port_leaves(cfg: ModelConfig, tree, want: dict):
    """(parameter name, host array) of every leaf of the reference's params
    tree, block leaves unstacked along their layer axis, each checked
    against `want`'s {name: shape}; every parameter must be set."""
    todo = set(want)
    stacks = _stacks(cfg)
    for key, value in _flatten(tree):
        value = np.asarray(value)
        group, _, leaf = key.partition(".")
        if group in stacks:
            n = stacks[group]
            if value.shape[0] != n:
                raise ValueError(f"{key}: {value.shape[0]} stacked layers, "
                                 f"config has {n}")
            pairs = [(f"{group}.{i}.{leaf}", value[i]) for i in range(n)]
        else:
            pairs = [(key, value)]
        for name, arr in pairs:
            if name not in want:
                raise KeyError(f"the port's model has no parameter {name!r}")
            if tuple(arr.shape) != tuple(want[name]):
                raise ValueError(f"{name}: shape {arr.shape} != the port's "
                                 f"{tuple(want[name])}")
            todo.discard(name)
            yield name, arr
    if todo:
        raise KeyError(f"leaves missing from the tree: {sorted(todo)}")


def lm_params_from_numpy(cfg: ModelConfig, tree,
                         device: DeviceLike = None) -> lm.LM:
    """The port's model on `device` from the reference's params pytree of
    host arrays (``jax.device_get(lm.init_params(key, cfg))``): every leaf
    copied into its parameter (block leaves unstacked along their layer
    axis), matrices cast to ``cfg.dtype``.  Every parameter must be set."""
    model = lm.LM(cfg, device=resolve_device(device))
    params = dict(model.named_parameters())
    for name, arr in _port_leaves(cfg, tree, {n: p.shape for n, p in
                                              params.items()}):
        params[name].copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    return model


def lm_params_to_mesh(cfg: ModelConfig, tree,
                      mesh: ShardMesh) -> "specs.ShardedLM":
    """The reference's params pytree of host arrays cut straight onto
    `mesh` by the reference's placements (`specs.place_tree`), each leaf
    in the dtype the port's model holds it in: the whole model is never on
    a device."""
    return specs.place_tree(cfg, {
        key: torch.from_numpy(np.array(value, dtype=np.float32))
        for key, value in _flatten(tree)}, mesh)


def lm_params_to_numpy(model: lm.LM) -> dict:
    """The reference's params pytree (f32 host arrays, block leaves stacked
    ``[L, ...]``, ``head`` empty when tied) from the port's model."""
    tree: dict = {"head": {}}
    stacked: dict = {}
    for name, p in model.named_parameters():
        arr = p.detach().float().cpu().numpy()
        if name.split(".", 1)[0] in ("blocks", "enc_blocks", "dec_blocks"):
            group, i, leaf = name.split(".", 2)
            stacked.setdefault(group, {}).setdefault(leaf, {})[int(i)] = arr
            continue
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
    for group, leaves in stacked.items():
        blocks = tree[group] = {}
        for leaf, by_layer in leaves.items():
            node = blocks
            *path, last = leaf.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[last] = np.stack([by_layer[i] for i in range(len(by_layer))])
    return tree


def rag_projections_from_numpy(proj, unproj, device: DeviceLike = None):
    """The reference's RAG projection matrices (``q @ proj`` [d_model,
    dim], ``mem_vec @ unproj`` [dim, d_model]) as f32 tensors on `device`,
    for `repro_torch.serving.rag.make_rag_prefill(proj=, unproj=)`."""
    dev = resolve_device(device)
    return tuple(torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
                 for a in (proj, unproj))
