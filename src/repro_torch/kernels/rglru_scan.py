"""RG-LRU diagonal linear recurrence: the CUDA kernels and their plain
versions, and the autograd Function that trains through them.

    a, b (bt, s, d) -> h (bt, s, d),  h_t = a_t * h_{t-1} + b_t,  h_0 = 0

in fp32 or bf16; the carry is fp32, and only the stored h_t is rounded to
a's type (``repro/kernels/rglru_scan.py:_kernel``, ``ref.rglru_scan_ref``).
A nonzero initial state folds into ``b[:, 0]`` before the call
(``models/rglru.rglru_scan``).  Its backward, for the cotangent g of h:

    dh_{s-1} = g_{s-1},  dh_t = g_t + a_{t+1} dh_{t+1},
    da_t = dh_t h_{t-1} (h_{-1} = 0),  db_t = dh_t

with an fp32 carry, da and db stored in a's type.

Tier rule: a CUDA tensor launches the hand-written kernel in
``csrc/rglru_scan.cu``; a CPU tensor takes the plain version; anything
else raises.  There is no fallback from a kernel to its plain version.

Kernel notes (what each replaces, what bounds it on an H100, what the
design does about it): ``rglru_scan`` (#15) replaces
``repro/kernels/rglru_scan.py:_kernel`` (``rglru_scan_pallas``), which
carries h across sequence blocks of a sequential TPU grid in VMEM.  GPU
blocks run in no order, so one CUDA thread owns one (row, channel) column
and walks the whole sequence, h in a register; loads are coalesced across
channels and prefetched a few steps ahead of the dependent chain.  It is
bound by bytes (25.2 MB at the RG-LRU prefill's (4, 128, 4096) fp32, 7.5
us at 3.35 TB/s), but with bt * d threads it under-fills the card; a
chunked two-pass scan is the next design.  ``rglru_scan_bwd`` replaces no
Pallas body (the JAX package differentiates ``jax.lax.associative_scan``,
``repro/models/rglru.py:rglru_scan``): the same layout walking t from s - 1
down to 0, dh in a register, bound by bytes (a, h, g read, da, db written:
41.9 MB at (4, 128, 4096) fp32, 12.5 us).  Each step of either rounds the
product and the sum separately, as the plain versions' two elementwise ops
do, so kernel and plain version agree bit for bit.

:data:`launches` counts kernel launches, one per wrapper call that
launches, and nothing else.  The raw wrappers are forward-only (on CUDA
they raise when grad mode is on and an operand requires grad, as
``ops.rglru_scan_op`` mirrors a Pallas op JAX does not differentiate
either); :class:`RGLRUScan` is the differentiable scan, its forward #15
and its backward ``rglru_scan_bwd``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.common import (DTYPES, forward_only, raise_on,
                                        route, stream)

# kernel launches since the last reset_launches()
launches = {"rglru_scan": 0, "rglru_scan_bwd": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def rglru_scan_plain(a, b):
    """Plain PyTorch version of :func:`rglru_scan`: the sequential loop of
    ``ref.rglru_scan_ref``, fp32 carry, one product and one sum per step."""
    af, bf = a.float(), b.float()
    h = torch.zeros_like(af[:, 0])
    out = torch.empty_like(af)
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out.to(a.dtype)


def rglru_scan_bwd_plain(a, h, g):
    """Plain PyTorch version of :func:`rglru_scan_bwd`: the reverse loop,
    fp32 carry, one product and one sum per step.  Returns (da, db) in a's
    dtype."""
    af, hf, gf = a.float(), h.float(), g.float()
    dh = torch.zeros_like(af[:, 0])
    a_next = torch.zeros_like(dh)
    da, db = torch.empty_like(af), torch.empty_like(af)
    for t in range(a.shape[1] - 1, -1, -1):
        dh = gf[:, t] + a_next * dh
        a_next = af[:, t]
        da[:, t] = dh * (hf[:, t - 1] if t else torch.zeros_like(dh))
        db[:, t] = dh
    return da.to(a.dtype), db.to(a.dtype)


def _check(name, a, *others):
    """Everything the kernel assumes, checked before any pointer leaves
    Python: device, dtype, shape, contiguity."""
    if a.dtype not in DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {a.dtype}")
    for t in others:
        if t.dtype != a.dtype or t.device != a.device:
            raise TypeError(f"{name}: an operand is {t.dtype} on "
                            f"{t.device}, a is {a.dtype} on {a.device}")
    if a.ndim != 3 or any(tuple(t.shape) != tuple(a.shape) for t in others):
        raise ValueError(f"{name} takes operands (bt, s, d) of one shape; "
                         f"got {[tuple(t.shape) for t in (a, *others)]}")
    if not all(t.is_contiguous() for t in (a, *others)):
        raise ValueError(f"{name}: the operands must be contiguous")
    if a.shape[0] > 65535:
        raise ValueError(f"{name}: bt {a.shape[0]} > 65535 (grid rows)")


def rglru_scan(a, b):
    """Kernel #15: h_t = a_t h_{t-1} + b_t over axis 1 from h_0 = 0.
    Returns (bt, s, d) in a's dtype."""
    if not route(a, "rglru_scan"):
        return rglru_scan_plain(a, b)
    forward_only("rglru_scan", a, b)
    _check("rglru_scan", a, b)
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    from repro_torch.kernels.build import load
    bt, s, d = a.shape
    err = load().rglru_scan_launch(a.data_ptr(), b.data_ptr(),
                                   out.data_ptr(), bt, s, d,
                                   DTYPES[a.dtype], stream(a))
    raise_on(err, "rglru_scan")
    launches["rglru_scan"] += 1
    return out


def rglru_scan_bwd(a, h, g):
    """The backward of #15: (da, db) for a, the forward's output h and the
    cotangent g, all (bt, s, d) of a's dtype; each in a's dtype."""
    if not route(a, "rglru_scan_bwd"):
        return rglru_scan_bwd_plain(a, h, g)
    forward_only("rglru_scan_bwd", a, h, g)
    _check("rglru_scan_bwd", a, h, g)
    da, db = torch.empty_like(a), torch.empty_like(a)
    if a.numel() == 0:
        return da, db
    from repro_torch.kernels.build import load
    bt, s, d = a.shape
    err = load().rglru_scan_bwd_launch(a.data_ptr(), h.data_ptr(),
                                       g.data_ptr(), da.data_ptr(),
                                       db.data_ptr(), bt, s, d,
                                       DTYPES[a.dtype], stream(a))
    raise_on(err, "rglru_scan_bwd")
    launches["rglru_scan_bwd"] += 1
    return da, db


class RGLRUScan(torch.autograd.Function):
    """h = scan(a, b) with gradients for a and b.

    ``apply(a, b)``: (bt, s, d) operands of one dtype.  The forward picks
    the tier once, by :func:`~repro_torch.kernels.dispatch._use_kernel`
    (the kernels on CUDA, the plain versions on the CPU and under
    ``dispatch.plain_tier()``), and keeps it for the backward, which may
    run where the forward's context is not visible.  It runs #15 (or its
    plain version) and saves a and h; the backward runs
    :func:`rglru_scan_bwd` (or its plain version) and returns only the
    gradients autograd asks for."""

    @staticmethod
    def forward(ctx, a, b):
        kernel = dispatch._use_kernel(a)
        a, b = a.contiguous(), b.contiguous()
        h = rglru_scan(a, b) if kernel else rglru_scan_plain(a, b)
        ctx.save_for_backward(a, h)
        ctx.kernel = kernel
        return h

    @staticmethod
    def backward(ctx, g):
        need_a, need_b = ctx.needs_input_grad
        a, h = ctx.saved_tensors
        bwd = rglru_scan_bwd if ctx.kernel else rglru_scan_bwd_plain
        da, db = bwd(a, h, g.to(a.dtype).contiguous())
        return (da if need_a else None), (db if need_b else None)
