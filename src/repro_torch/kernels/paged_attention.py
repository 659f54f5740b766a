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
``repro/kernels/paged_attention.py:_paged_attn_kernel`` (``:45``), which
walks a request's blocks in a sequential grid dimension with the running
softmax (m, l, acc) in VMEM.  On the card it is bound by bytes, and at the
paths' shapes by latency: the K and V a gemma-2b decode step may attend
(B = 4, kh = 1, 160 positions) are 1.1 MB, 0.34 us at 3.35 TB/s, and 16
query heads on a kv head do about 8 FLOP a byte, under the fp32 ridge.
One CUDA block per (request, kv head), as the TPU grid suggests, put 4
blocks on 132 SMs (143 us, PERF.md).  So the grid is (request, kv head,
chunk): ``common.paged_split`` splits the table's columns into chunks that
fill the SMs about once, each block carries (m, l, acc) over its chunk and
writes fp32 partials, and a second kernel merges a request's partials in
chunk order (no atomics: a run repeats bit for bit; with one chunk the
block writes the output itself).  Inside a block, positions are staged in
sub-blocks of up to 16 through a 4-stage cp.async ring, q is held once,
and each staged K and V element is read once for all the kv head's query
heads (4 x 4 score tiles over float4 quads, 4 heads x 4 dims of p V a
thread); see ``csrc/paged_attention.cu``.

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

from repro_torch.kernels.common import (DTYPES, forward_only, num_sms,
                                        paged_split, ptr, raise_on, route,
                                        stream)

NEG_INF = -1e30

# kernel launches since the last reset_launches()
launches = {"paged_attention": 0}

_MAX_SMEM = 227 * 1024        # bytes of shared memory one block may use
_SUB = 16                     # csrc/paged_attention.cu kSub: the most
                              # positions a sub-block stages
_STAGES = 4                   # and kStages: sub-blocks in its ring


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


def _smem(g: int, hd: int, sub: int, itemsize: int) -> int:
    """Bytes of shared memory one block of ``csrc/paged_attention.cu``
    uses (its ``Layout``): a ring of _STAGES sub-blocks of K and V (``sub``
    rows each, of hd rounded up to 4 elements plus 16 bytes, to 8 plus 16
    bytes for bf16) and q (g rows, hd rounded up to 4, to 8 for bf16) in
    the pools' type; fp32 acc (g rows of hd rounded up to 4), the
    probabilities and scores (16 positions of g rounded up to 4 heads), m,
    l, corr, and pos."""
    g4, hq4 = -(-g // 4) * 4, -(-hd // 4) * 4
    ldk = hq4 + 4 if itemsize == 4 else -(-hq4 // 8) * 8 + 8
    ldq = hq4 if itemsize == 4 else -(-hq4 // 8) * 8
    return ((_STAGES * 2 * sub * ldk + g * ldq) * itemsize
            + 4 * (g * hq4 + 2 * g4 * _SUB + 3 * g4 + _STAGES * _SUB))


def sub_block(g: int, hd: int, bs: int, itemsize: int) -> int:
    """Positions a sub-block of the kernel stages: 16, or bs if fewer,
    halved (to 1 at the least) only where heads too large for 16 would not
    fit in shared memory; 0 where even one position does not (fp32: g = 1
    past hd 5784, g = 8 past 2404, g = 16 past 1436, where the first
    kernel's layout of q, acc and one block's scores went to 29046, 3622
    and 1806; every head of the repo's configs has hd <= 256)."""
    for sub in (_SUB, 8, 4, 2, 1):
        if _smem(g, hd, sub, itemsize) <= _MAX_SMEM:
            return min(sub, bs)
    return 0


def _check(q, k_pool, v_pool, pos_pool, table, qpos, window):
    """Everything the kernel assumes, checked before any pointer leaves
    Python: device, dtype, shape, contiguity, and a sub-block that fits in
    shared memory; returns its size.  The table's entries are checked by
    the kernel itself (a device-side trap on an entry outside the pool),
    which costs no host synchronisation."""
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
    sub = sub_block(g, hd, bs, q.element_size())
    if not sub:
        raise ValueError(
            f"paged_attention: {g} query heads x head_dim {hd} need "
            f"{_smem(g, hd, 1, q.element_size())} bytes of shared memory > "
            f"{_MAX_SMEM}")
    return sub


def paged_attention(q, k_pool, v_pool, pos_pool, table, qpos, *,
                    window=None, softcap=None):
    """Kernel #13: one-token attention over the pool through the block
    table.  Returns (B, h, hd) in q's dtype."""
    if not route(q, "paged_attention"):
        return paged_attention_plain(q, k_pool, v_pool, pos_pool, table,
                                     qpos, window=window, softcap=softcap)
    from repro_torch.kernels.build import load
    forward_only("paged_attention", q, k_pool, v_pool)
    sub = _check(q, k_pool, v_pool, pos_pool, table, qpos, window)
    b, h, hd = q.shape
    npool, bs, kh, _ = k_pool.shape
    mb = table.shape[1]
    nsplit, cols = paged_split(b, kh, mb, num_sms(q.device))
    out = torch.empty_like(q)
    # the chunks' partials (acc, m, l) per query head, merged in order
    part = (torch.empty(b * h * nsplit * (hd + 2), dtype=torch.float32,
                        device=q.device) if nsplit > 1 else None)
    err = load().paged_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        pos_pool.data_ptr(), table.data_ptr(), qpos.data_ptr(),
        out.data_ptr(), ptr(part), b, npool, h, kh, hd, bs, mb, nsplit, cols,
        sub, 0 if window is None else int(window),
        float(softcap) if softcap else 0.0, hd ** -0.5, DTYPES[q.dtype],
        stream(q))
    raise_on(err, "paged_attention")
    launches["paged_attention"] += 1
    return out
