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

With the sharding switch ``moe_grouped`` on, :func:`moe_apply_grouped`
(JAX's ``_moe_apply_grouped``) dispatches each batch row as a routing
group of its own: capacity, position-in-expert and the scatter are local
to the row, so which tokens a full expert drops changes, on one device
too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding import opts


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


def _batch_rows(x):
    """The placements of a DTensor ``x`` with its batch-axis row split
    gathered (None where it has none)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.sharding.specs import BATCH_AXES
    if not isinstance(x, DTensor):
        return None
    names = x.device_mesh.mesh_dim_names or (None,) * x.device_mesh.ndim
    rows = [Replicate() if n in BATCH_AXES and p == Shard(0) else p
            for n, p in zip(names, x.placements)]
    return None if rows == list(x.placements) else rows


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
    kernel tier's choices so).  With ``moe_grouped`` on,
    :func:`moe_apply_grouped`.

    A DTensor x whose batch rows split over a batch axis (the dry-run's
    prefill and decode) is gathered over that axis first, so capacity
    and position-in-expert stay those of the whole batch, and each device
    keeps its own rows of the output.  Every device of the batch axes
    then routes and runs the whole batch's tokens through its experts:
    the buffers split only their expert dim over "model", the layout JAX
    constrains them to (``ex_in`` / ``ex_out`` on ``("model", None,
    None)``), so the MoE work does not shrink with the batch axes."""
    rows = _batch_rows(x)
    if rows is not None:
        out, aux = moe_apply(cfg, params, x.redistribute(x.device_mesh, rows),
                             adapters, top_i=top_i)
        return out.redistribute(x.device_mesh, x.placements), aux
    if opts.enabled("moe_grouped"):
        return moe_apply_grouped(cfg, params, x, top_i=top_i)
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

    out = _with_shared(cfg, params, xf, out)
    return out.reshape(b, s, d).to(x.dtype), aux


def _with_shared(cfg, params, xf, out):
    """``out`` (t, d) fp32 plus the shared experts (always on) under their
    sigmoid gate, where the config has them."""
    if not cfg.moe.num_shared_experts:
        return out
    sg = F.silu(xf @ params["shared_gate"]) * (xf @ params["shared_up"])
    sh = sg @ params["shared_down"]
    gate = torch.sigmoid(xf.float() @ params["shared_router"].float())
    return out + gate * sh.float()


def moe_apply_grouped(cfg, params, x, *, top_i=None):
    """The grouped dispatch (GShard-style; ``_moe_apply_grouped`` of the
    JAX package, step for step): each batch row is a routing group with
    its own capacity ``capacity(cfg, s)``, so the position-in-expert
    cumsum and the dispatch scatter are local to the row.  The router, the
    aux loss and the shared experts are the flat path's; ``top_i`` (t, k)
    replays a routing as :func:`moe_apply` does.  x (b, s, d) -> (out,
    aux)."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    ep = padded_experts(m)
    xf = x.reshape(b * s, d)
    probs, top_p, top_i = route(cfg, params, xf, top_i)
    probs = probs.reshape(b, s, e)
    top_p, top_i = top_p.reshape(b, s, k), top_i.reshape(b, s, k)

    assign = F.one_hot(top_i, e).sum(2)                       # (b, s, e)
    frac = assign.float().mean((0, 1))
    aux = e * torch.sum(frac * probs.mean((0, 1))) * m.router_aux_coef

    cap = capacity(cfg, s)
    pos = torch.cumsum(assign, dim=1) - 1                     # per group
    pos_k = torch.gather(pos, 2, top_i)                       # (b, s, k)
    keep = pos_k < cap
    w = torch.where(keep, top_p, torch.zeros_like(top_p))

    # row r's tokens land in its own (ep*cap + 1, d) buffer; dropped ->
    # the row's slot ep*cap
    slots = ep * cap + 1
    flat_idx = torch.where(keep, top_i * cap + pos_k,
                           torch.full_like(pos_k, ep * cap)).reshape(b, s * k)
    rows = torch.arange(b, device=x.device)[:, None] * slots
    src = x[:, :, None, :].expand(b, s, k, d).reshape(b * s * k, d)
    buf = torch.zeros((b * slots, d), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, (flat_idx + rows).reshape(-1), src)
    ex_in = buf.reshape(b, slots, d)[:, :-1].reshape(b, ep, cap, d)

    # expert FFN (swiglu), batched over the padded experts
    xe = ex_in.transpose(0, 1).reshape(ep, b * cap, d)
    g = F.silu(torch.bmm(xe, params["w_gate"]))
    u = torch.bmm(xe, params["w_up"])
    ex_out = torch.bmm(g * u, params["w_down"])
    ex_out = ex_out.reshape(ep, b, cap, d).transpose(0, 1)   # (b, ep, cap, d)

    flat_out = torch.cat([ex_out.reshape(b, ep * cap, d),
                          ex_out.new_zeros((b, 1, d))], 1)
    tok_out = torch.gather(flat_out, 1, flat_idx[..., None].expand(
        b, s * k, d)).reshape(b * s, k, d)
    out = torch.einsum("tkd,tk->td", tok_out.float(),
                       w.reshape(b * s, k).float())
    out = _with_shared(cfg, params, xf, out)
    return out.reshape(b, s, d).to(x.dtype), aux
