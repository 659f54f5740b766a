"""RG-LRU diagonal linear recurrence: the CUDA kernel and its plain version.

    a, b (bt, s, d) -> h (bt, s, d),  h_t = a_t * h_{t-1} + b_t,  h_0 = 0

in fp32 or bf16; the carry is fp32, and only the stored h_t is rounded to
a's type (``repro/kernels/rglru_scan.py:_kernel``, ``ref.rglru_scan_ref``).
A nonzero initial state folds into ``b[:, 0]`` before the call
(``models/rglru.rglru_scan``).

Tier rule: a CUDA tensor launches the hand-written kernel in
``csrc/rglru_scan.cu``; a CPU tensor takes the plain version; anything
else raises.  There is no fallback from the kernel to the plain version.

Kernel note (what it replaces, what bounds it on an H100, what the design
does about it): ``rglru_scan`` replaces
``repro/kernels/rglru_scan.py:_kernel`` (``rglru_scan_pallas``), which
carries h across sequence blocks of a sequential TPU grid in VMEM.  GPU
blocks run in no order, so one CUDA thread owns one (row, channel) column
and walks the whole sequence, h in a register; loads are coalesced across
channels and prefetched a few steps ahead of the dependent chain.  It is
bound by bytes (25.2 MB at the RG-LRU prefill's (4, 128, 4096) fp32, 7.5
us at 3.35 TB/s), but with bt * d threads it under-fills the card; a
chunked two-pass scan is the next design.  Each step rounds the product
and the sum separately, as the plain version's two elementwise ops do, so
kernel and plain version agree bit for bit.

:data:`launches` counts kernel launches, one per wrapper call that
launches, and nothing else.  Forward only: the kernel has no backward, so
on CUDA the wrapper raises when grad mode is on and an operand requires
grad.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import (DTYPES, forward_only, raise_on,
                                        route, stream)

# kernel launches since the last reset_launches()
launches = {"rglru_scan": 0}


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


def _check(a, b):
    """Everything the kernel assumes, checked before any pointer leaves
    Python: device, dtype, shape, contiguity."""
    if a.dtype not in DTYPES:
        raise TypeError(f"rglru_scan takes float32 or bfloat16, got "
                        f"{a.dtype}")
    if b.dtype != a.dtype or b.device != a.device:
        raise TypeError(f"rglru_scan: b is {b.dtype} on {b.device}, a is "
                        f"{a.dtype} on {a.device}")
    if a.ndim != 3 or tuple(b.shape) != tuple(a.shape):
        raise ValueError(f"rglru_scan takes a, b (bt, s, d) of one shape; "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("rglru_scan: a and b must be contiguous")
    if a.shape[0] > 65535:
        raise ValueError(f"rglru_scan: bt {a.shape[0]} > 65535 (grid rows)")


def rglru_scan(a, b):
    """Kernel #15: h_t = a_t h_{t-1} + b_t over axis 1 from h_0 = 0.
    Returns (bt, s, d) in a's dtype."""
    if not route(a, "rglru_scan"):
        return rglru_scan_plain(a, b)
    forward_only("rglru_scan", a, b)
    _check(a, b)
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
