"""RAG serving — the paper's *query template* end to end.

Port of ``src/repro/serving/rag.py``.  `make_rag_prefill`: embed the query
tokens (mean-pooled model embeddings as the stub embedder), query the
agentic memory with the engine's full scan (the ``scan_scores`` kernel on
the card), splice the softmax-weighted top-k memory rows into the prompt
as a soft-prefix embedding, then prefill.  Memory and model share the card
and the stream, so no host round trip sits between them.

Where the engine's dim differs from d_model, the reference draws its two
projection matrices inside the step from ``PRNGKey(0)`` and ``PRNGKey(1)``;
the port cannot reproduce jax's generator, so `RagPrefill` holds them as
buffers: by default drawn from a ``torch.Generator`` seeded 0 and 1 (on the
CPU, the same on every device), or passed in (``repro_torch.convert``
carries the reference's across).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import EngineConfig, ModelConfig
from repro_torch.core import index as ivf
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers, lm, sharding, specs


def memory_state(mem) -> ivf.IVFState:
    """Accept a `repro_torch.api.Collection` (or the engine shim) or a raw
    IVFState."""
    if hasattr(mem, "snapshot"):
        return mem.snapshot()
    if hasattr(mem, "state"):
        return mem.state
    return mem


@torch.no_grad()
def embed_query(params: lm.LM, cfg: ModelConfig, tokens) -> torch.Tensor:
    """Stub embedder: mean-pooled token embeddings, L2-normalized f32[B, D]
    (over a mesh: each data block's, on shard 0's device)."""
    if isinstance(params, specs.ShardedLM):
        xs, call = lm.embed_mesh(params, cfg, tokens)
        return _mesh_query(xs, call)
    return _pooled(layers.embed_apply(params.embed, tokens, cfg))


def _pooled(x) -> torch.Tensor:
    q = x.float().mean(1)
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=1e-6)


def _mesh_query(xs, call, device=None) -> torch.Tensor:
    """The data blocks' pooled queries, whole, on `device`."""
    return sharding.Placed(tuple(_pooled(x) for x in xs),
                           (call.batch_entry, None), call.mesh,
                           (call.batch, xs[0].shape[-1])).full(device)


def retrieve(state: ivf.IVFState, q, ecfg: EngineConfig, k: int):
    """Memory lookup (full-scan template; one fused scan + top_k).
    Returns (ids [B,k], scores [B,k], rows [B,k,D])."""
    return ivf.query_full_scan_rows(memory_state(state), q, ecfg, k)


def default_projection(seed: int, d_in: int, d_out: int) -> torch.Tensor:
    """normal(d_in, d_out) / sqrt(d_in) from a CPU generator seeded `seed`."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((d_in, d_out), generator=g).div_(math.sqrt(d_in))


class RagPrefill(nn.Module):
    """(params, engine_state, batch) -> (logits, caches, pos, ids).

    The retrieved memory vectors (dim = engine dim, projected to d_model if
    needed) are prepended as a soft prompt embedding: the fused
    retrieval -> generation path the paper's hybrid template schedules.
    """

    def __init__(self, cfg: ModelConfig, ecfg: EngineConfig, s_max: int,
                 k: int, proj: Optional[torch.Tensor],
                 unproj: Optional[torch.Tensor]):
        super().__init__()
        self.cfg, self.ecfg, self.s_max, self.k = cfg, ecfg, s_max, k
        self.register_buffer("proj", proj)
        self.register_buffer("unproj", unproj)

    @torch.no_grad()
    def query(self, params: lm.LM, tokens) -> torch.Tensor:
        """The memory-space query f32[B, dim] the step retrieves with."""
        q = embed_query(params, self.cfg, tokens)
        return q if self.proj is None else q.to(self.proj.device) @ self.proj

    def _prefix(self, scores, rows) -> torch.Tensor:
        """The retrieved memories as one soft-prefix embedding [B, 1, D],
        softmax-weighted by retrieval score."""
        w = torch.softmax(scores, dim=-1).float()
        mem_vec = torch.einsum("bk,bkd->bd", w, rows.float())
        if self.unproj is not None:
            mem_vec = mem_vec @ self.unproj
        return mem_vec[:, None, :].to(layers.torch_dtype(self.cfg.dtype))

    @torch.no_grad()
    def forward(self, params: lm.LM, mem_state, batch):
        cfg = self.cfg
        tokens = batch["tokens"]
        if lm.mesh_of(params, cfg) is not None:
            return self._forward_mesh(params, mem_state, batch)
        ids, scores, rows = retrieve(mem_state, self.query(params, tokens),
                                     self.ecfg, self.k)
        # retrieved memories enter the prompt as soft-prefix embeddings
        x_mem = self._prefix(scores, rows)
        emb = layers.embed_apply(params.embed, tokens, cfg)
        emb = torch.cat([x_mem, emb[:, :-1]], dim=1)
        out, caches, pos = _prefill_with_embeddings(params, cfg, emb, batch,
                                                    self.s_max)
        return out, caches, pos, ids

    def _forward_mesh(self, sp: specs.ShardedLM, mem_state, batch):
        """The step over a mesh: the data blocks' queries to the memory's
        device, one retrieval for the batch, each block's prefix back to
        its shards, then the mesh prefill (`batch`'s ``mrope_pos`` for
        qwen2-vl; the caches at s_max for every family)."""
        state = memory_state(mem_state)
        xs, call = lm.embed_mesh(sp, self.cfg, batch["tokens"])
        q = _mesh_query(xs, call, state.centroids.device)
        if self.proj is not None:
            q = q @ self.proj.to(q.device)
        ids, scores, rows = retrieve(state, q, self.ecfg, self.k)
        prefix = sharding.place(self._prefix(scores, rows),
                                (call.batch_entry, None, None),
                                call.mesh).parts
        xs = [torch.cat([m, x[:, :-1]], dim=1) for m, x in zip(prefix, xs)]
        out, caches, pos = lm.prefill_embedded_mesh(
            sp, self.cfg, xs, call, self.s_max, batch.get("mrope_pos"))
        return out, caches, pos, ids


def make_rag_prefill(cfg: ModelConfig, ecfg: EngineConfig, s_max: int,
                     k: int = 4, *, proj: Optional[torch.Tensor] = None,
                     unproj: Optional[torch.Tensor] = None,
                     device: DeviceLike = None) -> RagPrefill:
    """The RAG prefill step.  With ``ecfg.dim != cfg.d_model`` it holds the
    query projection [d_model, dim] and the memory's way back [dim,
    d_model] on `device` (the card unless named): `proj`/`unproj` if given,
    else `default_projection` seeded 0 and 1."""
    if ecfg.dim == cfg.d_model:
        return RagPrefill(cfg, ecfg, s_max, k, None, None)
    dev = resolve_device(device)
    if proj is None:
        proj = default_projection(0, cfg.d_model, ecfg.dim)
    if unproj is None:
        unproj = default_projection(1, ecfg.dim, cfg.d_model)
    if proj.shape != (cfg.d_model, ecfg.dim) or \
            unproj.shape != (ecfg.dim, cfg.d_model):
        raise ValueError(f"projections {tuple(proj.shape)} / "
                         f"{tuple(unproj.shape)} do not map d_model "
                         f"{cfg.d_model} <-> dim {ecfg.dim}")
    return RagPrefill(cfg, ecfg, s_max, k,
                      proj.to(device=dev, dtype=torch.float32),
                      unproj.to(device=dev, dtype=torch.float32))


@torch.no_grad()
def _prefill_with_embeddings(params: lm.LM, cfg: ModelConfig, x, batch,
                             s_max: int):
    """Prefill given already-computed input embeddings (the SSM families
    from zero states; `batch`'s ``mrope_pos`` for qwen2-vl)."""
    x, caches, _ = lm._run_stack(params, x, cfg, mode="prefill",
                                 caches=lm._train_caches(cfg, x),
                                 s_max=s_max,
                                 mrope_pos=batch.get("mrope_pos"))
    caches = lm._prefill_caches(cfg, caches, s_max)
    logits = lm._final_logits(params, cfg, x[:, -1:])
    pos = torch.full((x.shape[0],), x.shape[1] - 1, dtype=torch.int32,
                     device=x.device)
    return logits[:, 0], caches, pos
