"""Mixture-of-Experts layer (olmoe / deepseek-moe).

Port of ``src/repro/models/moe.py``, its no-mesh path (``_expert_ffn``'s
``shard_map`` branch has no counterpart on one card).  Dispatch is
gather-based and per sequence: for each (batch row, expert) the top-C
tokens that routed to that expert (C = capacity_factor * S * top_k / E,
rounded up to 8, at most S) are gathered into a dense [E, B, C, D] buffer,
the expert FFNs run as three batched products over E, and the weighted
results are combined back.  Tokens beyond capacity are dropped.

Two choices keep the reference's answer on the card:

- the top-C over S is a stable descending sort, so a tie keeps the lower
  token index as ``lax.top_k`` does (``torch.topk`` promises no order);
- the combine is the reference's scatter-add of ``ye`` into zeros, as one
  ``index_put_(accumulate=True)``: linear in S, and on the card it sorts
  the slots by token and sums each token's slots in expert order with no
  atomics, so reruns and decode-vs-forward give the same bits (an atomic
  ``index_add_`` would not).

deepseek-moe: ``num_shared_experts`` always-on experts run as a plain gated
MLP of width shared * d_ff_expert beside the routed ones.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers


class MoE(nn.Module):
    """router [d, E], wi/wu [E, d, f], wo [E, f, d] (the reference's
    `moe_init`; drawn by `lm.init_params`, each normal/sqrt(shape[0]));
    `shared` an MLP of width num_shared_experts * d_ff_expert."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff_expert
        dt = layers.torch_dtype(cfg.dtype)
        for name, shape in (("router", (d, e)), ("wi", (e, d, f)),
                            ("wu", (e, d, f)), ("wo", (e, f, d))):
            setattr(self, name, layers.param(
                torch.empty(shape, dtype=dt, device=device)))
        if cfg.num_shared_experts:
            self.shared = layers.MLP(d, cfg.num_shared_experts * f, dt,
                                     device)


def moe_specs(cfg: ModelConfig):
    """Logical axes of the MoE layer's leaves (the reference's)."""
    sp = {"router": (None, None),
          "wi": ("expert", "fsdp", None),
          "wu": ("expert", "fsdp", None),
          "wo": ("expert", None, "fsdp")}
    if cfg.num_shared_experts:
        sp["shared"] = layers.mlp_specs()
    return sp


def _capacity(cfg: ModelConfig, seq: int) -> int:
    c = int(cfg.capacity_factor * seq * cfg.moe_top_k / cfg.num_experts)
    return min(seq, max(8, -(-c // 8) * 8))


def moe_apply(p: MoE, x, cfg: ModelConfig) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """x [B,S,D] -> (y [B,S,D], aux_loss f32 scalar)."""
    dt = x.dtype
    e, k = cfg.num_experts, cfg.moe_top_k
    cap = _capacity(cfg, x.shape[1])

    logits = (x @ p.router.to(dt)).float()
    probs = torch.softmax(logits, dim=-1)                    # [B,S,E]

    # top-k mask per token, by threshold: every tie with the k-th is kept
    thresh = torch.topk(probs, k, dim=-1).values[..., -1:]
    sel = probs >= thresh
    gate = torch.where(sel, probs, 0.0)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # load-balancing auxiliary loss (Switch-style)
    frac_tokens = sel.float().mean((0, 1))                   # [E]
    frac_probs = probs.mean((0, 1))
    aux = e * (frac_tokens * frac_probs).sum()

    # per-(row, expert) top-C token selection, ties to the lower index
    esc = torch.where(sel, probs, -1.0).transpose(1, 2)      # [B,E,S]
    cval, cidx = torch.sort(esc, dim=-1, descending=True, stable=True)
    cval, cidx = cval[..., :cap], cidx[..., :cap]            # [B,E,C]
    cgate = torch.gather(gate.transpose(1, 2), -1, cidx)
    cgate = torch.where(cval > 0.0, cgate, 0.0)

    y = _ffn_body(x, cidx, cgate, p.wi, p.wu, p.wo, act=cfg.act)
    if cfg.num_shared_experts:
        y = y + p.shared(x, cfg.act)
    return y, aux


def _ffn_body(x, cidx, cgate, wi, wu, wo, *, act: str):
    """Dispatch + grouped FFN + combine.  x [B,S,D]; cidx/cgate [B,E,C]."""
    dt = x.dtype
    b, s, d = x.shape
    e, c = cidx.shape[1], cidx.shape[2]
    # each slot's row of x viewed [B*S, D], expert-major: [E*B*C]
    dst = cidx + torch.arange(0, b * s, s, device=x.device)[:, None, None]
    dst = dst.transpose(0, 1).reshape(-1)
    xe = x.reshape(b * s, d).index_select(0, dst).view(e, b * c, d)
    h = torch.bmm(xe, wi.to(dt))
    u = torch.bmm(xe, wu.to(dt))
    h = (layers.gelu(h) if act == "gelu" else layers.silu(h)) * u
    ye = torch.bmm(h, wo.to(dt))                              # [E,B*C,D]
    ye = ye * cgate.transpose(0, 1).reshape(e, b * c, 1).to(dt)
    # scatter-add back in that order: through the card's stable sort a
    # token's slots stay in ascending expert order
    y = torch.zeros_like(x).view(b * s, d)
    return y.index_put_((dst,), ye.view(-1, d), accumulate=True).view(b, s, d)
