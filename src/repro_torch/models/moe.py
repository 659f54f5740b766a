"""Mixture-of-Experts MLP: top-k routing, capacity-based scatter dispatch,
shared (always-on) experts, and a Switch-style load-balance auxiliary loss.

The port of the flat path of ``repro/models/moe.py``, step for step.
Expert weights are stacked ``(E, d, ff)`` with the expert count padded as
JAX pads it (qwen2-moe 60 -> 64); the router stays at the logical count,
so padded experts never receive tokens.  The three expert products are
batched matmuls over the padded experts, plain ``torch.bmm`` as the base
GEMMs are: JAX computes them outside any Pallas body.

Determinism: every kept (expert, position) slot of the dispatch buffer
receives exactly one token, so its ``index_add`` is exact in any order;
only the drop slot ``ep * cap`` collects several, and it is sliced off and
never read.  The top-k is a stable descending sort, so exact ties go to
the lower expert index first, as ``jax.lax.top_k`` orders them.

JAX's grouped dispatch (``_moe_apply_grouped``, switched on by the
sharding option ``moe_grouped``) is not ported: it belongs with the mesh.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def padded_experts(m) -> int:
    """The expert count padded to a multiple of 16 (e.g. 60 -> 64), as the
    JAX package pads it for 16-way expert parallelism."""
    e = m.num_experts
    return e if e <= 16 else -(-e // 16) * 16


def moe_params(cfg, generator, *, lead=()):
    """Router, padded expert stacks and (if any) shared experts, drawn from
    ``generator`` on its device; ``lead`` prepends stacked layer dims.
    Each leaf is scaled in place, so a full-size expert stack needs no
    second copy while it is drawn."""
    m = cfg.moe
    d = cfg.d_model
    dt = getattr(torch, cfg.param_dtype)
    e = padded_experts(m)
    ff = m.d_ff_expert

    def draw(shape, scale):
        w = torch.randn(tuple(lead) + shape, generator=generator,
                        device=generator.device, dtype=torch.float32)
        return w.mul_(scale).to(dt)

    s = d ** -0.5
    p = {"router": draw((d, m.num_experts), s),
         "w_gate": draw((e, d, ff), s),
         "w_up": draw((e, d, ff), s),
         "w_down": draw((e, ff, d), ff ** -0.5)}
    if m.num_shared_experts:
        sf = m.d_ff_shared
        p["shared_gate"] = draw((d, sf), s)
        p["shared_up"] = draw((d, sf), s)
        p["shared_down"] = draw((sf, d), sf ** -0.5)
        p["shared_router"] = draw((d, 1), s)
    return p


def route(cfg, params, xf, top_i=None):
    """The router on flattened tokens ``xf`` (t, d): (probs (t, e) fp32,
    top_p (t, k) renormalised, top_i (t, k) int64), top_i in descending
    probability with ties to the lower index, or the given ``top_i``."""
    k = cfg.moe.top_k
    logits = xf.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    if top_i is None:
        top_i = torch.sort(probs, dim=-1, descending=True,
                           stable=True)[1][:, :k]
    top_p = torch.gather(probs, 1, top_i)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_p, top_i


def capacity(cfg, t: int) -> int:
    """Slots per expert for ``t`` tokens, from Python numbers as JAX
    computes it: ``max(1, int(t k / e * capacity_factor))`` rounded up to a
    multiple of 8."""
    m = cfg.moe
    cap = max(1, int(t * m.top_k / m.num_experts * m.capacity_factor))
    return -(-cap // 8) * 8


def moe_apply(cfg, params, x, adapters=None, *, top_i=None):
    """x (b, s, d) -> (out (b, s, d), aux_loss 0-d fp32).

    Capacity and position-in-expert run over the whole flattened batch, so
    one request's tokens can be dropped because of another's, as in JAX.
    ``adapters`` is accepted for uniformity with the other block kinds; no
    config adapts an expert projection.  ``top_i`` (t, k), when given,
    replaces the router's choice of experts (the routing weights still
    come from this router's probabilities): it holds one run to another's
    routing, so that an fp32 near-tie in the router cannot send a token to
    other experts in the two (``chip_smoke.py`` holds the plain tier to the
    kernel tier's choices so)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.num_experts, m.top_k
    ep = padded_experts(m)
    xf = x.reshape(t, d)
    probs, top_p, top_i = route(cfg, params, xf, top_i)

    # load-balance aux (Switch): E * sum_e frac_tokens_e * mean_prob_e
    assign = F.one_hot(top_i, e).sum(1)                       # (t, e) int
    frac = assign.float().mean(0)
    aux = e * torch.sum(frac * probs.mean(0)) * m.router_aux_coef

    # capacity and position-in-expert, over the flattened (b, s) order
    cap = capacity(cfg, t)
    pos = torch.cumsum(assign, dim=0) - 1                     # (t, e)
    pos_k = torch.gather(pos, 1, top_i)                       # (t, k)
    keep = pos_k < cap
    w = torch.where(keep, top_p, torch.zeros_like(top_p))

    # scatter tokens into (ep*cap, d) expert buffers; dropped -> slot ep*cap
    flat_idx = torch.where(keep, top_i * cap + pos_k,
                           torch.full_like(pos_k, ep * cap))
    src = xf[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = torch.zeros((ep * cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf = buf.index_add(0, flat_idx.reshape(-1), src)
    ex_in = buf[:-1].reshape(ep, cap, d)

    # expert FFN (swiglu), batched over the padded experts
    g = F.silu(torch.bmm(ex_in, params["w_gate"]))
    u = torch.bmm(ex_in, params["w_up"])
    ex_out = torch.bmm(g * u, params["w_down"])

    # gather back and combine with the routing weights, in fp32
    flat_out = torch.cat([ex_out.reshape(ep * cap, d),
                          ex_out.new_zeros((1, d))], 0)
    tok_out = flat_out[flat_idx]                              # (t, k, d)
    out = torch.einsum("tkd,tk->td", tok_out.float(), w.float())

    # shared experts (always on) under their sigmoid gate
    if m.num_shared_experts:
        sg = F.silu(xf @ params["shared_gate"]) * (xf @ params["shared_up"])
        sh = sg @ params["shared_down"]
        gate = torch.sigmoid(xf.float() @ params["shared_router"].float())
        out = out + gate * sh.float()

    return out.reshape(b, s, d).to(x.dtype), aux
