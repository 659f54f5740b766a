"""Flash attention (forward): the CUDA kernel and its plain version.

    q (bh, s, d), k / v (bkv, t, d) with bh = bkv * group -> (bh, s, d)

Folded query head i attends with key / value head ``i // group``
(``kernels/ops.flash_mha`` folds heads so that the query heads of one kv
head are neighbours).  Scores are ``(q . k) * d ** -0.5`` in fp32; a score is
kept iff ``k_pos <= q_pos`` (``causal``) and ``q_pos - k_pos < window``
(``window`` not None), with positions the row and column indices.  The
rules of ``repro/kernels/flash_attention.py:_kernel`` hold in both
versions: masked scores are -1e30, ``p = 0`` where a score is <= -1e30 / 2,
and the output is ``acc / max(l, 1e-30)``; so a row with no kept score is
0 (``ref.flash_attention_ref`` would give it the uniform average).  Output
in q's dtype.

The shape contract of the JAX wrapper holds on every device: ``s`` and ``t``
must be multiples of ``min(512, s)`` and ``min(512, t)`` (its 512-row
blocks), else ValueError.

Tier rule: a CUDA tensor launches the hand-written kernel in
``csrc/flash_attention.cu``; a CPU tensor takes the plain version; anything
else raises.  There is no fallback from the kernel to the plain version.

Kernel note (what it replaces, what bounds it on an H100, what the design
does about it): ``flash_attention`` replaces
``repro/kernels/flash_attention.py:_kernel``, whose sequential innermost
grid dimension walks key blocks with (acc, m, l) in VMEM.  GPU blocks run
in no order, so one CUDA block owns a (folded head, 64-row query tile),
loops over 64-key tiles itself and skips the tiles outside the causal /
window band.  It is bound by operations (4 * bh * attended pairs * d FLOPs
in fp32 FMA, no TF32: 1.54 ms at recurrentgemma-9b's local attention, s = t
= 4096, window 2048, 16 heads of 256) and keeps the (s, t) scores out of
device memory.  A block is two teams of 8 warps on one query tile: each
team walks half of the tile's key tiles, streaming K and V through its own
3-stage ring of 16 KB shared-memory slabs, filled by cp.async (fp32) two
slabs ahead of the FMAs and handed over by mbarriers, and the two teams'
running softmaxes join in a fixed order at the end.  A thread owns 4 x 4
scores and 8 x 8 outputs (at d 256), read as float4; at most 128
registers a thread, 205 KB of shared memory a block; query tiles run
longest first.  It replaced a kernel with synchronous scalar K / V loads,
2 x 4 scores a thread and one block of 8 warps per SM, at 2.12x SDPA on
gemma-2b's attention (``PERF.md``).

:data:`launches` counts kernel launches, one per wrapper call that
launches, and nothing else.  Forward only: on CUDA the wrapper raises when
grad mode is on and an operand requires grad.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import (DTYPES, forward_only, raise_on,
                                        route, stream)

NEG_INF = -1e30
MAX_HEAD_DIM = 256            # csrc/flash_attention.cu tiles up to d = 256

# kernel launches since the last reset_launches()
launches = {"flash_attention": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def band_mask(s: int, t: int, *, causal: bool, window, device):
    """(s, t) bool: True where query row i may attend key column j."""
    qp = torch.arange(s, device=device)[:, None]
    kp = torch.arange(t, device=device)[None, :]
    mask = torch.ones(s, t, dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= qp - kp < window
    return mask


def flash_attention_plain(q, k, v, *, causal=True, window=None):
    """Plain PyTorch version of :func:`flash_attention`: the whole (s, t)
    score matrix, one max and one sum per row, under the kernel's rules."""
    bh, s, d = q.shape
    bkv, t = k.shape[:2]
    qf = q.float().reshape(bkv, bh // bkv, s, d)
    sc = torch.einsum("kgsd,ktd->kgst", qf, k.float()) * d ** -0.5
    mask = band_mask(s, t, causal=causal, window=window, device=q.device)
    sc = sc.masked_fill(~mask, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(sc <= NEG_INF / 2, sc.new_zeros(()), torch.exp(sc - m))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("kgst,ktd->kgsd", p, v.float()) / l.clamp_min(1e-30)
    return out.reshape(bh, s, d).to(q.dtype)


def check_shape_contract(s: int, t: int):
    """The JAX wrapper's assertion (``flash_attention.py:67-68``): its query
    and key blocks are ``min(512, n)`` rows and must tile ``s`` and ``t``."""
    if s < 1 or t < 1 or s % min(512, s) or t % min(512, t):
        raise ValueError(
            f"flash_attention needs s and t that are <= 512 or multiples of "
            f"512 (the JAX kernel's blocks); got s={s}, t={t}")


def _check(q, k, v, window):
    """Everything the kernel assumes, checked before any pointer leaves
    Python: device, dtype, shape, contiguity."""
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != q.device:
            raise TypeError(f"flash_attention: {name} is {x.dtype} on "
                            f"{x.device}, q is {q.dtype} on {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    bh, _, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} > {MAX_HEAD_DIM}")
    if bh > 65535:
        raise ValueError(f"flash_attention: {bh} folded heads > 65535")


def _check_shapes(q, k, v):
    if q.ndim != 3 or k.ndim != 3 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(
            f"flash_attention takes q (bh, s, d) and k, v (bkv, t, d); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, s, d = q.shape
    bkv, t, dk = k.shape
    if dk != d or bkv < 1 or bh % bkv:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
            "need one head dim and a query head count that the kv head "
            "count divides")
    check_shape_contract(s, t)


def flash_attention(q, k, v, *, causal=True, window=None):
    """Kernel #14: attention with online softmax, causal and / or a sliding
    window.  Returns (bh, s, d) in q's dtype."""
    _check_shapes(q, k, v)
    if not route(q, "flash_attention"):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    forward_only("flash_attention", q, k, v)
    _check(q, k, v, window)
    bh, s, d = q.shape
    bkv, t = k.shape[:2]
    out = torch.empty_like(q)
    from repro_torch.kernels.build import load
    err = load().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s, t,
        d, bh // bkv, int(bool(causal)), 0 if window is None else int(window),
        d ** -0.5, DTYPES[q.dtype], stream(q))
    raise_on(err, "flash_attention")
    launches["flash_attention"] += 1
    return out
