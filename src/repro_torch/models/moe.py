"""Mixture-of-Experts layer (olmoe / deepseek-moe).

Port of ``src/repro/models/moe.py``.  Dispatch is gather-based and per
sequence: for each (batch row, expert) the top-C tokens that routed to
that expert (C = capacity_factor * S * top_k / E, rounded up to 8, at most
S) are gathered into a dense [E, B, C, D] buffer, the expert FFNs run as
three batched products over E, and the weighted results are combined
back.  Tokens beyond capacity are dropped.

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

On a mesh, `moe_apply_sharded` is the reference's ``_expert_ffn``:
routing and capacity are computed once per data block; where the
reference takes its ``shard_map`` branch (``model > 1``, the batch
dividing over the data axes, E dividing over 'model') each 'model' shard
runs `_ffn_body` on its E/M experts and one sum over 'model' combines
them (expert parallelism), else every shard runs all experts, gathered
(the reference's plain GSPMD path).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, sharding


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
    cidx, cgate, frac_tokens, frac_probs = _route(p.router, x, cfg)
    aux = cfg.num_experts * (frac_tokens * frac_probs).sum()
    y = _ffn_body(x, cidx, cgate, p.wi, p.wu, p.wo, act=cfg.act)
    if cfg.num_shared_experts:
        y = y + p.shared(x, cfg.act)
    return y, aux


def _route(router, x, cfg: ModelConfig):
    """The router over x [B,S,D]: (cidx, cgate [B,E,C], and the per-expert
    token and probability fractions of the load-balancing loss [E])."""
    dt = x.dtype
    k = cfg.moe_top_k
    cap = _capacity(cfg, x.shape[1])

    logits = (x @ router.to(dt)).float()
    probs = torch.softmax(logits, dim=-1)                    # [B,S,E]

    # top-k mask per token, by threshold: every tie with the k-th is kept
    thresh = torch.topk(probs, k, dim=-1).values[..., -1:]
    sel = probs >= thresh
    gate = torch.where(sel, probs, 0.0)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # load-balancing auxiliary loss (Switch-style)
    frac_tokens = sel.float().mean((0, 1))                   # [E]
    frac_probs = probs.mean((0, 1))

    # per-(row, expert) top-C token selection, ties to the lower index
    esc = torch.where(sel, probs, -1.0).transpose(1, 2)      # [B,E,S]
    cval, cidx = torch.sort(esc, dim=-1, descending=True, stable=True)
    cval, cidx = cval[..., :cap], cidx[..., :cap]            # [B,E,C]
    cgate = torch.gather(gate.transpose(1, 2), -1, cidx)
    cgate = torch.where(cval > 0.0, cgate, 0.0)
    return cidx, cgate, frac_tokens, frac_probs


def moe_apply_sharded(ps, xs, cfg: ModelConfig, mesh, *, ep: bool,
                      batch_split: bool, shared_tp: bool = False):
    """The MoE layer on a mesh.  `ps`: per shard the layer's leaves,
    gathered over 'data' (with `ep` False: gathered whole); `xs`: per
    shard its data block's activations [B_l, S, D], equal on the 'model'
    shards of a block.  With `ep`, model shard j of M runs experts
    [j*E/M, (j+1)*E/M) and the partial outputs are summed over 'model' in
    shard order; `shared_tp`: deepseek's shared experts cut over 'model'
    (a partial sum too); `batch_split`: the data blocks hold different
    rows (else each holds the whole batch).  Returns (y per shard, the
    batch's aux loss)."""
    e = cfg.num_experts
    n = mesh.size
    routes: List[Optional[tuple]] = [None] * n
    srcs, takes = [0] * n, [None] * n
    firsts = []
    for g in sharding.groups(mesh, ("model",)):        # one data block
        # routing and capacity once per block, on its first shard, which
        # hands each expert shard its experts' slice (`sharding.fetch`)
        routes[g[0]] = _route(ps[g[0]].router, xs[g[0]], cfg)
        firsts.append(g[0])
        el = e // len(g) if ep else e
        for j, i in enumerate(g):
            srcs[i] = g[0]
            takes[i] = (1, j * el, el) if ep else None
    cidx = sharding.fetch([r and r[0] for r in routes], mesh, srcs, takes)
    cgate = sharding.fetch([r and r[1] for r in routes], mesh, srcs, takes)
    ys = [_ffn_body(xs[i], cidx[i], cgate[i], ps[i].wi, ps[i].wu, ps[i].wo,
                    act=cfg.act) for i in range(n)]
    if ep:
        ys = sharding.all_sum(ys, mesh, "model")
    if cfg.num_shared_experts:
        sh = [layers.mlp_apply(p.shared, x, cfg.act) for p, x in zip(ps, xs)]
        if shared_tp:
            sh = sharding.all_sum(sh, mesh, "model")
        ys = [y + s for y, s in zip(ys, sh)]
    # the fractions of the whole batch: the mean over equal data blocks,
    # whole values (`sharding.to_home`)
    if not (batch_split and len(firsts) > 1):
        firsts = firsts[:1]
    fracs = sharding.to_home([routes[i][k] for i in firsts for k in (2, 3)],
                             mesh, [i for i in firsts for _ in (2, 3)])
    frac_tokens, frac_probs = fracs[0], fracs[1]
    if len(firsts) > 1:
        frac_tokens, frac_probs = (torch.stack(fracs[k::2]).mean(0)
                                   for k in (0, 1))
    return ys, e * (frac_tokens * frac_probs).sum()


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
