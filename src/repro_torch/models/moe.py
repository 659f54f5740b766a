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
    None)``), so the MoE work does not shrink with the batch axes.  Under
    ``moe_grouped`` nothing is gathered: each device dispatches its own
    rows (:func:`_grouped_on_rows`), as JAX splits the grouped buffers
    over the batch axes."""
    rows = _batch_rows(x)
    if rows is not None and opts.enabled("moe_grouped"):
        return _grouped_on_rows(cfg, params, x, top_i)
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
    out, assign, probs = _grouped_experts(cfg, params, x, top_i)
    frac = assign.float().mean((0, 1))
    aux = m.num_experts * torch.sum(frac * probs.mean((0, 1))) \
        * m.router_aux_coef
    out = _with_shared(cfg, params, x.reshape(b * s, d), out)
    return out.reshape(b, s, d).to(x.dtype), aux


def _grouped_experts(cfg, params, x, top_i, experts=None):
    """The routed half of :func:`moe_apply_grouped`: (out (b s, d) fp32,
    assign (b, s, e), probs (b, s, e)).  ``experts`` (lo, hi): the expert
    stacks in ``params`` hold only experts lo..hi-1 (a device's share), and
    ``out`` sums only their contributions."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    ep = padded_experts(m)
    xf = x.reshape(b * s, d)
    probs, top_p, top_i = route(cfg, params, xf, top_i)
    probs = probs.reshape(b, s, e)
    top_p, top_i = top_p.reshape(b, s, k), top_i.reshape(b, s, k)
    assign = F.one_hot(top_i, e).sum(2)                       # (b, s, e)

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
    lo, hi = experts or (0, ep)
    ex_in = ex_in[:, lo:hi]

    # expert FFN (swiglu), batched over the (held) padded experts
    xe = ex_in.transpose(0, 1).reshape(hi - lo, b * cap, d)
    g = F.silu(torch.bmm(xe, params["w_gate"]))
    u = torch.bmm(xe, params["w_up"])
    ex_out = torch.bmm(g * u, params["w_down"])
    ex_out = ex_out.reshape(hi - lo, b, cap, d).transpose(0, 1)
    if experts is not None:                  # the other devices' experts
        ex_out = F.pad(ex_out, (0, 0, 0, 0, lo, ep - hi))

    flat_out = torch.cat([ex_out.reshape(b, ep * cap, d),
                          ex_out.new_zeros((b, 1, d))], 1)
    tok_out = torch.gather(flat_out, 1, flat_idx[..., None].expand(
        b, s * k, d)).reshape(b * s, k, d)
    out = torch.einsum("tkd,tk->td", tok_out.float(),
                       w.reshape(b * s, k).float())
    return out, assign, probs


def _grouped_on_rows(cfg, params, x, top_i):
    """:func:`moe_apply_grouped` on a DTensor x whose batch rows split over
    batch axes, on each device's rows: a row is its own routing group, so
    no row leaves its device.  Each device runs the experts it holds (the
    expert stacks keep their placement over "model"), and the routed
    outputs are summed across the devices that split the experts.  The aux
    loss reduces both of its means over the batch axes before their
    product."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    if top_i is not None:
        raise ValueError("moe_grouped on batch-split rows routes by its own "
                         "router: top_i= is not taken here")
    mesh = x.device_mesh
    b, s, d = x.shape
    keys = ["router", "w_gate", "w_up", "w_down"]
    ws = [params[k] for k in keys]
    split = [i for i, p in enumerate(ws[1].placements) if p == Shard(0)]
    if len(split) > 1 or any(p.is_shard() and p != Shard(0)
                             for p in ws[1].placements):
        raise NotImplementedError("expert stacks split other than by "
                                  "expert over one mesh dim")
    n_held = ws[1].to_local().shape[0]
    lo = mesh.get_local_rank(split[0]) * n_held if split else 0
    rows = tuple(x.placements)
    out_pl = tuple(Partial() if i in split else p
                   for i, p in enumerate(rows))
    sums_pl = tuple(Partial() if p == Shard(0) else Replicate()
                    for p in rows)

    def local(xl, router, wg, wu, wd):
        out, assign, probs = _grouped_experts(
            cfg, {"router": router, "w_gate": wg, "w_up": wu, "w_down": wd},
            xl, None, (lo, lo + n_held))
        return (out.reshape(xl.shape), assign.float().sum((0, 1)),
                probs.sum((0, 1)))

    out, n_tok, p_sum = local_map(
        local, out_placements=(out_pl, sums_pl, sums_pl),
        in_placements=(rows,) + tuple(tuple(w.placements) for w in ws),
        device_mesh=mesh)(x, *ws)
    out = out.redistribute(mesh, rows)
    n_tok, p_sum = (t.redistribute(mesh, [Replicate()] * mesh.ndim)
                    for t in (n_tok, p_sum))
    m = cfg.moe
    aux = m.num_experts * torch.sum((n_tok / (b * s)) * (p_sum / (b * s))) \
        * m.router_aux_coef
    out = _with_shared(cfg, params, x.reshape(b * s, d), out.reshape(b * s, d))
    return out.reshape(b, s, d).to(x.dtype), aux
