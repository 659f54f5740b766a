"""xLSTM blocks (arXiv:2405.04517): the mLSTM (matrix memory) and the sLSTM
(scalar memory, a sequential scan).

The port of ``repro/models/xlstm.py``, with its names.  The mLSTM trains
and prefills in the stabilized chunkwise-parallel form (an O(C^2) product
within a chunk of ``MLSTM_CHUNK`` tokens, the recurrent matrix-memory carry
across chunks) and decodes with the O(1) recurrent step.  Where JAX scans
over the chunks under ``jax.checkpoint``, this module loops over them in
Python and keeps each chunk's activations for the backward: the checkpoint
is a memory policy, not numerics, and the port takes none.  The sLSTM is
sequential (its hidden state feeds back through the gates) and runs as an
eager loop of s steps; the four recurrent products of a step are one
``torch.bmm`` over the heads, with the gate pre-activations kept in that
product's layout for the whole loop.

q, k and v go through the adapted ``linear``, so an adapter (q and v by
default) reaches ``kernels/dispatch.py``: on the card #1 / #2 when serving
and #5-#8 when training.  Everything else is plain PyTorch in fp32, as the
JAX package computes it outside any Pallas body.  Caches stay fp32 whatever
the activation dtype; a prefill or decode step updates its cache in place
(and returns it), as the other blocks do.

Two behaviours of the reference are kept: the ``o`` and ``ogate`` products
are plain matmuls, so an ``o`` adapter changes nothing; and the sLSTM's
``z`` gate-input adapter applies in the full-sequence and prefill forms
only, decode ignoring it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models.layers import linear
from repro_torch.sharding.specs import (full_local, merge_heads, rejoin,
                                        replicated, split_heads)

MLSTM_CHUNK = 256
_NEG = -1e30          # the stabilizer's "no state yet", as in JAX


def _drawer(cfg, generator, lead):
    dt = getattr(torch, cfg.param_dtype)

    def draw(shape, scale):
        w = torch.randn(lead + shape, generator=generator,
                        device=generator.device, dtype=torch.float32)
        return (w * scale).to(dt)

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=dt,
                          device=generator.device)

    return draw, full


# ================================================================== mLSTM

def mlstm_params(cfg, generator, *, lead=()):
    """The mLSTM block's weights drawn from ``generator`` (on its device),
    in the JAX tree; ``lead`` prepends stacked layer dims."""
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    draw, full = _drawer(cfg, generator, tuple(lead))
    s = d ** -0.5
    return {
        "q": draw((d, h * hd), s),
        "k": draw((d, h * hd), s),
        "v": draw((d, h * hd), s),
        "w_i": draw((d, h), s),
        "w_f": draw((d, h), s),
        "b_f": full((h,), 3.0),               # bias toward remembering
        "o": draw((h * hd, d), (h * hd) ** -0.5),
        "ogate": draw((d, h * hd), s),
    }


def _mlstm_qkv(cfg, params, x, adapters):
    h, hd = cfg.num_heads, cfg.head_dim
    adapters = adapters or {}
    q, k, v = (split_heads(linear(x, params[n], adapters.get(n)), h, hd)
               for n in ("q", "k", "v"))
    return q.float(), k.float() * hd ** -0.5, v.float()


def _gates(params, xf):
    """(log input gate, log forget gate), fp32, (..., h); on a model axis
    from the all-gathered weights (``logsigmoid``'s backward has no
    DTensor rule)."""
    log_i = xf @ full_local(params["w_i"]).float()
    log_f = F.logsigmoid(xf @ full_local(params["w_f"]).float()
                         + full_local(params["b_f"]).float())
    return log_i, log_f


def _chunk_step(carry, qb, kb, vb, li, lf, band):
    """One chunk of the stabilized parallel form from the carry (C (b, h,
    hd, hd), n (b, h, hd), m (b, h)): qb, kb, vb (b, c, h, hd), li, lf (b,
    c, h).  ``band`` (1, c, c, 1) is the causal band: the decay matrix is
    -inf off it and its weights 0.  Maxima are ``torch.amax`` and
    ``torch.maximum``, which share the gradient among ties as ``jnp.max``
    and ``jnp.maximum`` do.  Returns (new carry, out (b, c, h, hd))."""
    c_st, n_st, m_st = carry
    bacc = torch.cumsum(lf, dim=1)                       # (b, c, h)
    total = bacc[:, -1]                                  # (b, h)
    # intra-chunk decay matrix D[t, u] = bacc[t] - bacc[u] + li[u]
    dmat = bacc[:, :, None, :] - bacc[:, None, :, :] + li[:, None, :, :]
    dmat = torch.where(band, dmat, float("-inf"))
    m_intra = torch.amax(dmat, dim=2)                    # (b, c, h)
    m_inter = m_st[:, None, :] + bacc                    # (b, c, h)
    m_t = torch.maximum(torch.maximum(m_intra, m_inter),
                        m_intra.new_full((), _NEG))
    w = torch.where(band, torch.exp(dmat - m_t[:, :, None, :]), 0.0)
    sc = torch.einsum("bthd,buhd->btuh", qb, kb) * w
    num = torch.einsum("btuh,buhd->bthd", sc, vb)
    nvec = torch.einsum("btuh,buhd->bthd", w, kb)
    inter_w = torch.exp(m_inter - m_t)                   # (b, c, h)
    num = num + inter_w[..., None] * torch.einsum("bthd,bhde->bthe", qb,
                                                  c_st)
    nvec = nvec + inter_w[..., None] * n_st[:, None]
    den = torch.maximum(torch.einsum("bthd,bthd->bth", qb, nvec).abs(),
                        torch.exp(-m_t))
    out = num / den[..., None]                           # (b, c, h, hd)
    # ---- the state at the chunk's end
    key_d = li + total[:, None] - bacc                   # (b, c, h)
    m_new = torch.maximum(m_st + total, torch.amax(key_d, dim=1))
    kw = torch.exp(key_d - m_new[:, None])               # (b, c, h)
    carry_w = torch.exp(m_st + total - m_new)            # (b, h)
    c_new = (carry_w[..., None, None] * c_st
             + torch.einsum("buh,buhd,buhe->bhde", kw, kb, vb))
    n_new = (carry_w[..., None] * n_st
             + torch.einsum("buh,buhd->bhd", kw, kb))
    return (c_new, n_new, m_new), out


def _mlstm_fullseq(cfg, params, x, adapters=None, carry0=None):
    """Stabilized chunkwise-parallel form over x (b, s, d).  Returns (out,
    final carry): the carry after the LAST REAL token, so that prefill can
    hand it to the recurrent decode form as its cache.  On a model axis
    the projections run on their shards and the cell runs whole on every
    device (q, k, v and x all-gathered, ``full_local``)."""
    h, hd = cfg.num_heads, cfg.head_dim
    q, k, v = (full_local(t) for t in _mlstm_qkv(cfg, params, x, adapters))
    xf = full_local(x).float()
    b, s, _ = xf.shape                     # this device's batch rows
    log_i, log_f = _gates(params, xf)                    # (b, s, h)

    c = min(MLSTM_CHUNK, s)
    pad = (-s) % c
    if pad:
        # identity-safe padding: pad forget gates decay 0 (log_f = 0) and
        # pad input gates -1e30, so pad tokens neither decay nor write the
        # carried state; pad outputs are sliced off
        q, k, v, log_f = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
                          for t in (q, k, v, log_f))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=_NEG)
    band = torch.ones(c, c, dtype=torch.bool,
                      device=x.device).tril()[None, :, :, None]
    if carry0 is None:
        carry0 = mlstm_init_cache(cfg, b, None, device=x.device)
        carry0 = (carry0["C"], carry0["n"], carry0["m"])
    carry0 = tuple(full_local(t) for t in carry0)
    carry, outs = carry0, []
    for j in range(0, q.shape[1], c):
        carry, out = _chunk_step(carry, q[:, j:j + c], k[:, j:j + c],
                                 v[:, j:j + c], log_i[:, j:j + c],
                                 log_f[:, j:j + c], band)
        outs.append(out)
    out = torch.cat(outs, dim=1)[:, :s]
    ogate = torch.sigmoid(xf @ full_local(params["ogate"]).float())
    out = rejoin(out.reshape(b, s, h * hd) * ogate, x)
    return replicated(out @ params["o"].float()).to(x.dtype), carry


def mlstm_apply_fullseq(cfg, params, x, adapters=None):
    return _mlstm_fullseq(cfg, params, x, adapters)[0]


def mlstm_apply_prefill(cfg, params, x, cache, positions=None,
                        adapters=None):
    """Whole-prompt mLSTM continuing from ``cache``; the chunk loop's final
    carry (exact, thanks to identity-safe padding) is written back as the
    decode cache.  Returns (y, cache)."""
    out, carry = _mlstm_fullseq(cfg, params, x, adapters,
                                carry0=(cache["C"], cache["n"], cache["m"]))
    for key, t in zip(("C", "n", "m"), carry):
        cache[key].copy_(rejoin(t, cache[key]))
    return out, cache


def mlstm_init_cache(cfg, batch: int, dtype, *, device):
    """Zero matrix memory and normaliser, stabilizer -1e30; fp32 whatever
    ``dtype`` is."""
    h, hd = cfg.num_heads, cfg.head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros(batch, h, hd, hd, **f32),
            "n": torch.zeros(batch, h, hd, **f32),
            "m": torch.full((batch, h), _NEG, **f32)}


def _mlstm_step(q, k, v, qn, kn, log_i, log_f, C, n, m):
    """The recurrent step's state update, in place, on one device's
    pieces (or whole tensors): C (b, h, d, e) takes k (whole d) and v (C's
    e), n (b, h, d) kn (n's d); returns num = q . C (b, h, e) and qn . n
    (b, h), a partial sum where n's d is split."""
    m_new = torch.maximum(log_f + m, log_i)
    fw = torch.exp(log_f + m - m_new)[..., None]
    iw = torch.exp(log_i - m_new)[..., None]
    C.mul_(fw[..., None]).add_(iw[..., None] * (k[..., :, None]
                                                * v[..., None, :]))
    n.mul_(fw).add_(iw * kn)
    m.copy_(m_new)
    return (torch.einsum("bhd,bhde->bhe", q, C),
            torch.einsum("bhd,bhd->bh", qn, n))


def _mlstm_step_sharded(q, k, v, log_i, log_f, cache):
    """:func:`_mlstm_step` on a cache placed by ``rules.cache_sharding``:
    each device updates its pieces of C (batch rows, C's last dim) and n
    (batch rows, n's last dim) in place through ``local_map``, and one
    all-reduce sums the partial q . n."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.kernels.dispatch import _as_dtensor
    C, n, m = cache["C"], cache["n"], cache["m"]
    mesh = C.device_mesh

    def like(batch, last):         # by C's split: its rows, its last dim
        return tuple(batch if p == Shard(0) else last if p != Replicate()
                     else Replicate() for p in C.placements)
    rows = like(Shard(0), Replicate())         # batch rows only
    pls = {"q": rows, "k": rows, "v": like(Shard(0), Shard(2)),
           "qn": like(Shard(0), Shard(2)), "kn": like(Shard(0), Shard(2)),
           "gate": rows}
    args = [_as_dtensor(t, mesh).redistribute(mesh, pls[key])
            for t, key in ((q, "q"), (k, "k"), (v, "v"), (q, "qn"),
                           (k, "kn"), (log_i, "gate"), (log_f, "gate"))]
    in_pl = tuple(pls[key] for key in ("q", "k", "v", "qn", "kn", "gate",
                                       "gate")) + tuple(
        tuple(t.placements) for t in (C, n, m))
    num, qn = local_map(_mlstm_step, out_placements=(
        like(Shard(0), Shard(2)), like(Shard(0), Partial())),
        in_placements=in_pl, device_mesh=mesh)(*args, C, n, m)
    return num, qn.redistribute(mesh, rows)


def mlstm_apply_decode(cfg, params, x, cache, pos=None, adapters=None):
    """The recurrent matrix-memory step, x (b, 1, d).  Returns (y (b, 1,
    d), cache); the matrix memory is updated in place (on a sharded cache
    shard by shard, :func:`_mlstm_step_sharded`)."""
    q, k, v = (t[:, 0] for t in _mlstm_qkv(cfg, params, x, adapters))
    xf = x[:, 0].float()
    log_i, log_f = _gates(params, xf)                    # (b, h)
    if isinstance(cache["C"], DTensor):
        num, qn = _mlstm_step_sharded(q, k, v, log_i, log_f, cache)
    else:
        num, qn = _mlstm_step(q, k, v, q, k, log_i, log_f, cache["C"],
                              cache["n"], cache["m"])
    den = torch.maximum(qn.abs(), torch.exp(-cache["m"]))
    out = num / den[..., None]
    ogate = torch.sigmoid(xf @ params["ogate"].float())
    out = merge_heads(out) * ogate
    y = (out @ params["o"].float()).to(x.dtype)
    return y[:, None, :], cache


# ================================================================== sLSTM

GATES = ("z", "i", "f", "o")


def slstm_params(cfg, generator, *, lead=()):
    """The sLSTM block's weights drawn from ``generator``, in the JAX tree:
    gate inputs ``w_*`` (d, d), per-head recurrences ``r_*`` (nh, hd, hd),
    the forget bias and the output projection; ``lead`` prepends stacked
    layer dims."""
    d, nh = cfg.d_model, cfg.slstm_num_heads
    hd = d // nh
    draw, full = _drawer(cfg, generator, tuple(lead))
    p = {f"w_{g}": draw((d, d), d ** -0.5) for g in GATES}
    p.update({f"r_{g}": draw((nh, hd, hd), hd ** -0.5) for g in GATES})
    p["b_f"] = full((d,), 3.0)
    p["w_proj"] = draw((d, d), d ** -0.5)
    return p


def _slstm_gate_inputs(params, x):
    xf = x.float()
    return torch.stack([xf @ params[f"w_{g}"].float() for g in GATES],
                       dim=-2)                           # (b, s, 4, d)


def _slstm_scan(cfg, params, gi, carry):
    """The sLSTM recurrence over gi (b, s, 4, d) from carry (h, c, n, m),
    each (b, d).  The loop runs in the recurrent product's layout: state
    (nh, b, hd), pre-activations (s, nh, b, 4, hd), and the four ``r_*``
    side by side as one (nh, hd, 4 hd) operand of a ``torch.bmm`` a step.
    Returns (carry, hs (b, s, d)).  On a model axis the recurrence runs
    whole on every device: gi and the recurrent weights are all-gathered
    first (``full_local``), as the loop's head-major reshapes of a sharded
    DTensor do not map onto its shards; with its batch split over a batch
    axis, each device runs its own rows (the carry too)."""
    gi = full_local(gi)
    b, s, _, d = gi.shape
    nh = cfg.slstm_num_heads
    hd = d // nh

    def heads(t):                                  # (b, d) -> (nh, b, hd)
        return t.reshape(b, nh, hd).transpose(0, 1).contiguous()

    rec_w = torch.cat([full_local(params[f"r_{g}"]).float() for g in GATES],
                      dim=-1)
    b_f = full_local(params["b_f"]).float().reshape(nh, 1, hd)
    floor = gi.new_full((), 1e-6)
    pre_all = gi.reshape(b, s, 4, nh, hd).permute(1, 3, 0, 2, 4)
    h, c, n, m = (heads(full_local(t)) for t in carry)
    hs = []
    for t in range(s):
        pre = pre_all[t] + torch.bmm(h, rec_w).reshape(nh, b, 4, hd)
        z, log_i, log_f, o = pre.unbind(2)
        z = torch.tanh(z)
        log_f = F.logsigmoid(log_f + b_f)
        o = torch.sigmoid(o)
        decayed = log_f + m
        m = torch.maximum(decayed, log_i)
        iw = torch.exp(log_i - m)
        fw = torch.exp(decayed - m)
        c = fw * c + iw * z
        n = torch.maximum(fw * n + iw, floor)
        h = o * c / n
        hs.append(h)

    def flat(t):                                   # (nh, b, hd) -> (b, d)
        return t.transpose(0, 1).reshape(b, d)

    hs = torch.stack(hs).permute(2, 0, 1, 3).reshape(b, s, d)
    return tuple(flat(t) for t in (h, c, n, m)), hs


def _slstm_fullseq(cfg, params, x, adapters=None, carry=None):
    gi = _slstm_gate_inputs(params, x)
    if adapters is not None and "z" in adapters:
        # gate-input adapter (prepared form: scale already folded into B)
        za, zb = adapters["z"]["a"], adapters["z"]["b"]
        gz = gi[:, :, 0] + (x @ za.T) @ zb.T
        gi = torch.cat([gz[:, :, None], gi[:, :, 1:]], dim=2)
    gi = full_local(gi)
    if carry is None:
        cache = slstm_init_cache(cfg, gi.shape[0], None, device=x.device)
        carry = tuple(cache[k] for k in ("h", "c", "n", "m"))
    carry, hs = _slstm_scan(cfg, params, gi, carry)
    y = replicated(rejoin(hs, x) @ params["w_proj"].float())
    return y.to(x.dtype), carry


def slstm_apply_fullseq(cfg, params, x, adapters=None):
    return _slstm_fullseq(cfg, params, x, adapters)[0]


def slstm_apply_prefill(cfg, params, x, cache, positions=None,
                        adapters=None):
    """Whole-prompt sLSTM continuing from ``cache``; the scan's carry is
    written back as the decode cache, so prefill-then-decode matches the
    token-by-token path.  Returns (y, cache)."""
    keys = ("h", "c", "n", "m")
    out, carry = _slstm_fullseq(cfg, params, x, adapters,
                                carry=tuple(cache[k] for k in keys))
    for key, t in zip(keys, carry):
        cache[key].copy_(rejoin(t, cache[key]))
    return out, cache


def slstm_init_cache(cfg, batch: int, dtype, *, device):
    """Zero hidden and cell state, normaliser 1e-6, stabilizer -1e30; fp32
    whatever ``dtype`` is (four separate tensors: they are updated in
    place)."""
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros(batch, d, **f32),
            "c": torch.zeros(batch, d, **f32),
            "n": torch.full((batch, d), 1e-6, **f32),
            "m": torch.full((batch, d), _NEG, **f32)}


def slstm_apply_decode(cfg, params, x, cache, pos=None, adapters=None):
    """One step, x (b, 1, d); a ``z`` adapter is ignored here, as in the
    JAX package.  Returns (y (b, 1, d), cache)."""
    keys = ("h", "c", "n", "m")
    gi = _slstm_gate_inputs(params, x)                   # (b, 1, 4, d)
    carry, _ = _slstm_scan(cfg, params, gi, tuple(cache[k] for k in keys))
    for key, t in zip(keys, carry):
        cache[key].copy_(rejoin(t, cache[key]))
    y = replicated(rejoin(carry[0], x) @ params["w_proj"].float())
    return y.to(x.dtype)[:, None, :], cache
