"""Paged-attention decode: the CUDA kernel and its plain version.

One query token per request attends over its blocks of a shared KV pool,
named by its row of the block table (``models/attention.py`` keeps the
pool and the table):

    q (B, h, hd), k_pool / v_pool (P, bs, kh, hd), pos_pool (P, bs) int32
    (-1 = never written), table (B, mb) int32, qpos (B,) -> (B, h, hd)

A position p is attendable iff ``0 <= p <= qpos`` (and ``qpos - p <
window``), exactly the ring cache's mask; an optional soft cap tames the
scores.

Tier rule: a CUDA tensor launches the hand-written kernel in
``csrc/paged_attention.cu``; a CPU tensor takes the plain version; anything
else raises.  There is no fallback from the kernel to the plain version.

Kernel note (what it replaces, what bounds it on an H100, what the design
does about it): ``paged_attention`` replaces
``repro/kernels/paged_attention.py:_paged_attn_kernel``, which walks a
request's blocks in a sequential grid dimension with the running softmax
(m, l, acc) in VMEM.  GPU blocks run in no order, so one CUDA block owns a
(request, kv head) and loops over its table row itself, with (m, l, acc)
for that kv head's query heads in shared memory.  At gemma-2b decode
(B = 4, kh = 1) only 4 blocks run on 132 SMs: the kernel is bound by
latency, not by its bytes (about 1.3 MB of K, V and pos per layer at 160
positions, 0.4 us at 3.35 TB/s).  Splitting the table's columns over
blocks, with a fixed-order combine pass, is the next design.

The plain version is the exact-softmax oracle of
``repro/kernels/ref.py:paged_attention_ref`` (gather the request's view,
one softmax); the kernel's running softmax is mathematically the same and
differs in rounding only.  A request with no attendable position gets the
oracle's uniform average but the kernel's zeros; the decode path always
has the query's own position, so it never meets that case.

:data:`launches` counts kernel launches, one per wrapper call that
launches, and nothing else.  Forward only: the kernel has no backward.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import (DTYPES, forward_only, raise_on,
                                        route, stream)

NEG_INF = -1e30

# kernel launches since the last reset_launches()
launches = {"paged_attention": 0}

_MAX_SMEM = 227 * 1024        # bytes of shared memory one block may use


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def paged_attention_plain(q, k_pool, v_pool, pos_pool, table, qpos, *,
                          window=None, softcap=None):
    """Plain PyTorch version of :func:`paged_attention`: gather each
    request's view of the pool, then one exact softmax in fp32."""
    b, h, hd = q.shape
    _, bs, kh, _ = k_pool.shape
    mb = table.shape[1]
    g = h // kh
    idx = table.long()
    k = k_pool[idx].reshape(b, mb * bs, kh, hd).float()
    v = v_pool[idx].reshape(b, mb * bs, kh, hd).float()
    pos = pos_pool[idx].reshape(b, mb * bs)
    qg = q.reshape(b, kh, g, hd).float()
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k) * hd ** -0.5
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    qp = qpos.reshape(b, 1).to(pos.dtype)
    valid = (pos >= 0) & (pos <= qp)
    if window is not None:
        valid &= qp - pos < window
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v)
    return out.reshape(b, h, hd).to(q.dtype)


def _check(q, k_pool, v_pool, pos_pool, table, qpos, window):
    """Everything the kernel assumes, checked before any pointer leaves
    Python: device, dtype, shape, contiguity.  The table's entries are
    checked by the kernel itself (a device-side trap on an entry outside
    the pool), which costs no host synchronisation."""
    dev, dt = q.device, q.dtype
    if dt not in DTYPES:
        raise TypeError(f"paged_attention takes float32 or bfloat16, got {dt}")
    want = {"q": dt, "k_pool": dt, "v_pool": dt, "pos_pool": torch.int32,
            "table": torch.int32, "qpos": torch.int32}
    ops = {"q": q, "k_pool": k_pool, "v_pool": v_pool, "pos_pool": pos_pool,
           "table": table, "qpos": qpos}
    for name, t in ops.items():
        if t.device != dev or t.dtype != want[name]:
            raise TypeError(f"paged_attention: {name} is {t.dtype} on "
                            f"{t.device}, expected {want[name]} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    b, h, hd = q.shape
    npool, bs, kh, hd_k = k_pool.shape
    mb = table.shape[1] if table.ndim == 2 else -1
    if (hd_k != hd or tuple(v_pool.shape) != tuple(k_pool.shape)
            or tuple(pos_pool.shape) != (npool, bs)
            or tuple(table.shape) != (b, mb) or tuple(qpos.shape) != (b,)
            or kh < 1 or h % kh):
        raise ValueError(
            f"paged_attention shapes disagree: q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)} / "
            f"{tuple(pos_pool.shape)}, table {tuple(table.shape)}, qpos "
            f"{tuple(qpos.shape)}")
    if min(b, h, hd, bs, mb) < 1:
        raise ValueError("paged_attention needs nonempty operands")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    g = h // kh
    smem = 4 * (2 * g * hd + g * bs + 3 * g)
    if smem > _MAX_SMEM:
        raise ValueError(f"paged_attention: {g} query heads x head_dim {hd} "
                         f"need {smem} bytes of shared memory > {_MAX_SMEM}")


def paged_attention(q, k_pool, v_pool, pos_pool, table, qpos, *,
                    window=None, softcap=None):
    """Kernel #13: one-token attention over the pool through the block
    table.  Returns (B, h, hd) in q's dtype."""
    if not route(q, "paged_attention"):
        return paged_attention_plain(q, k_pool, v_pool, pos_pool, table,
                                     qpos, window=window, softcap=softcap)
    from repro_torch.kernels.build import load
    forward_only("paged_attention", q, k_pool, v_pool)
    _check(q, k_pool, v_pool, pos_pool, table, qpos, window)
    b, h, hd = q.shape
    _, bs, kh, _ = k_pool.shape
    out = torch.empty_like(q)
    err = load().paged_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        pos_pool.data_ptr(), table.data_ptr(), qpos.data_ptr(),
        out.data_ptr(), b, k_pool.shape[0], h, kh, hd, bs, table.shape[1],
        0 if window is None else int(window),
        float(softcap) if softcap else 0.0, hd ** -0.5, DTYPES[q.dtype],
        stream(q))
    raise_on(err, "paged_attention")
    launches["paged_attention"] += 1
    return out
