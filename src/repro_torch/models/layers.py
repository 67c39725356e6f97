"""Shared model layers: norms, MLPs, embeddings, RoPE (incl. M-RoPE).

Port of ``src/repro/models/layers.py``.  The reference keeps f32 weights
and casts them to the activations' dtype at every use; a serving model of
the port holds the weight matrices in the model's dtype (cast once when
the model is made or carried across), which is bit-equal, and a trained
one holds them in f32 (the master weights) and casts them at each use, as
the reference does.  Norm scales are f32 in both.  Norms compute in f32 and cast back; products run in
the activations' dtype.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ("bfloat16", "float32",
    "float64")."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def upcast(x: torch.Tensor) -> torch.Tensor:
    """x for the f32 arithmetic of norms and recurrences: in f32, or in
    f64 when x is (a float64 model computes in f64 throughout)."""
    return x if x.dtype == torch.float64 else x.float()


def param(t: torch.Tensor) -> nn.Parameter:
    """A weight, built without autograd: serving never differentiates, and
    the trainer turns ``requires_grad`` on for its master weights."""
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    """normal / sqrt(fan_in), drawn from `gen` on its device."""
    fan_in = shape[in_axis]
    x = torch.randn(tuple(shape), generator=gen, device=gen.device)
    return x.div_(math.sqrt(fan_in)).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float, *, gemma_style: bool = False,
             dtype=None):
    """RMS norm in f32 (`upcast`), the result in `dtype` (default: x's)."""
    dt = dtype or x.dtype
    x = upcast(x)
    var = (x * x).mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    scale = scale.float()
    scale = (1.0 + scale) if gemma_style else scale
    return (x * scale).to(dt)


def layer_norm(x, scale, bias, eps: float):
    """Layer norm in f32 (`upcast`), the result in x's dtype."""
    dt = x.dtype
    x = upcast(x)
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * scale + bias).to(dt)


# ---------------------------------------------------------------------------
# MLP (gated: SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def _expanded(x) -> bool:
    """A 16-bit tensor on the CPU: XLA's CPU backend expands the logistic
    into 1 / (1 + exp(-x)) and rounds after each step, and the port does
    the same there.  Elsewhere (f32, or any tensor on the card) the fused
    op runs: one launch that rounds once, which the 16-bit decode on the
    card, bound by its launches, keeps."""
    return x.device.type == "cpu" and x.dtype in (torch.bfloat16,
                                                  torch.float16)


def sigmoid(x):
    """``jax.nn.sigmoid`` (see `_expanded` for its rounding)."""
    if _expanded(x):
        return torch.reciprocal(torch.exp(-x) + 1)
    return torch.sigmoid(x)


def silu(x):
    """``jax.nn.silu``: x * sigmoid(x) (see `_expanded`)."""
    return x * sigmoid(x) if _expanded(x) else F.silu(x)


def gelu(x):
    """``jax.nn.gelu``'s default tanh approximation.  On a 16-bit CPU
    tensor it is expanded as jax writes it, with the constants in x's dtype
    and a rounding after each step, as XLA's CPU backend computes it;
    elsewhere the fused op (see `_expanded`)."""
    if not _expanded(x):
        return F.gelu(x, approximate="tanh")
    c1 = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    c2 = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c2 * (x + c1 * (x * x * x)))))


class MLP(nn.Module):
    """wi (gate) and wu (up) [d_model, d_ff], wo [d_ff, d_model]."""

    def __init__(self, d_model: int, d_ff: int, dtype, device=None):
        super().__init__()
        for name, shape in (("wi", (d_model, d_ff)), ("wu", (d_model, d_ff)),
                            ("wo", (d_ff, d_model))):
            setattr(self, name, param(torch.empty(shape, dtype=dtype,
                                                  device=device)))

    def forward(self, x, act: str):
        h = x @ self.wi.to(x.dtype)
        u = x @ self.wu.to(x.dtype)
        h = (gelu(h) if act == "gelu" else silu(h)) * u
        return h @ self.wo.to(x.dtype)


def mlp_specs():
    """Logical axes of the MLP's leaves (the reference's; `models/specs.py`
    maps them onto a mesh's axes)."""
    return {"wi": ("fsdp", "model"), "wu": ("fsdp", "model"),
            "wo": ("model", "fsdp")}


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    """table [vocab_padded, d_model]."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.table = param(torch.empty((cfg.vocab_padded, cfg.d_model),
                                       dtype=_dtype(cfg), device=device))


class Head(nn.Module):
    """w [d_model, vocab_padded]; no weight when the embeddings are tied."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if not cfg.tie_embeddings:
            self.w = param(torch.empty((cfg.d_model, cfg.vocab_padded),
                                       dtype=_dtype(cfg), device=device))


def embed_apply(p: Embed, tokens, cfg: ModelConfig):
    dt = _dtype(cfg)
    x = p.table.index_select(0, tokens.reshape(-1)).view(
        *tokens.shape, -1).to(dt)
    if cfg.emb_scale:
        # sqrt(d_model) in f32, then in the activations' dtype
        s = torch.tensor(math.sqrt(float(cfg.d_model)), dtype=torch.float32)
        x = x * s.to(device=x.device, dtype=dt)
    return x


def unembed_apply(p_embed: Embed, p_head: Head, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        w = p_embed.table.to(x.dtype).T               # [D, V]
    else:
        w = p_head.w.to(x.dtype)
    logits = x @ w
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# ---------------------------------------------------------------------------
# RoPE (+ M-RoPE for qwen2-vl)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x, ang):
    """Rotate the split halves of x [..., S, H, Dh] by ang [..., S, Dh/2]."""
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x [..., S, H, Dh], positions [..., S] int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # [Dh/2]
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x, positions3, sections: Tuple[int, ...], theta: float):
    """M-RoPE (qwen2-vl): positions3 [..., S, 3] = (t, h, w) coordinates.

    The Dh/2 frequency slots are partitioned into `sections` (t, h, w); each
    section rotates by its own coordinate stream.
    """
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                   # [Dh/2]
    if sum(sections) != dh // 2:
        raise ValueError(f"M-RoPE sections {sections} do not split {dh // 2}")
    sec_id = torch.tensor([i for i, n in enumerate(sections)
                           for _ in range(n)], device=x.device)
    pos = positions3.float().index_select(-1, sec_id)         # [..., S, Dh/2]
    return _rotate(x, pos * freqs)
