"""Multi-adapter BGMV for banked LoRA serving: CUDA kernels and plain versions.

Row i of ``x`` is served with tenant ``ids[i]``'s (A, B) pair out of a
stacked :class:`~repro_torch.core.lora.AdapterBank`:

    y[i] = x[i] @ W + (x[i] @ A[ids[i]]^T) @ B[ids[i]]^T

``bgmv_matmul`` takes x (B, s, k) (prefill), ``bgmv_gemv`` x (B, k) (one
decode token per request).  ``bgmv_matmul_quant`` and ``bgmv_gemv_quant``
are the same over a packed frozen base W (a
:class:`~repro_torch.core.quant.QuantizedLinear`, int8 or int4).  All
return fp32.  The bank is gamma-free:
registration folds each tenant's scale into its B.  ``ids=None`` is the
identity map (row i <-> adapter i), the layout of a bank already gathered
per request; it needs no range check.

Tier rule: a CUDA tensor launches the hand-written kernel in
``csrc/bgmv.cu``; a CPU tensor takes the plain PyTorch version; anything
else raises.  There is no fallback from the kernel to the plain version.

Kernel notes (what they replace, what bounds them on an H100, what the
design does about it):

* ``bgmv_matmul`` replaces ``repro/kernels/bgmv.py:_bgmv_kernel``.  At the
  prefill shapes (B*s = 512 rows, k = 2048) it is bound by operations: it
  runs fp32 FMA on the CUDA cores (67 TFLOP/s peak; no TF32, so the fp32
  tolerances hold).  Rows of all requests are flattened into one M, so a
  64 x 64 output tile reads its W tile once for every request in it.
* ``bgmv_gemv`` replaces ``repro/kernels/bgmv.py:_bgmv_gemv_kernel``.  A
  decode step is bound by the bytes of W (the q projection reads 16.8 MB,
  about 5 us at 3.35 TB/s).  One block computes a 32-column tile for up
  to 8 requests, so W is read once per step for a batch of up to 8 (once
  per 8 requests beyond) instead of once per request as in the TPU grid,
  and the k range is split over blocks so that enough loads are in
  flight; a second kernel adds the partial sums in a fixed order.
* ``bgmv_matmul_quant`` and ``bgmv_gemv_quant`` replace
  ``_bgmv_kernel_q`` and ``_bgmv_gemv_kernel_q``: the two kernels above
  with the W-tile load replaced by a dequantizing load (one template body
  per kernel, instantiated for an fp, an int8 and an int4 W loader).  They
  move 4x (int8) or 8x (int4) fewer W bytes than fp32, which is what bounds
  the decode form.  Each W element is formed as ``dequantize`` forms it
  (one fp32 product, rounded to bf16 for a base packed from bf16 weights),
  so kernel and plain version differ only in the order of their sums.
* All: the TPU kernel carries p = x A^T in VMEM across its sequential
  grid.  GPU blocks run in no order, so a shrink pre-pass writes p to an
  fp32 scratch (rank <= 512, small) that the main kernel reads.

Each wrapper call adds one to its entry of :data:`launches` (the shrink
pre-pass included), and nowhere else.  The kernels have no backward: on
CUDA, a wrapper raises when grad mode is on and an operand requires grad.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import QuantizedLinear
from repro_torch.kernels.common import (DTYPES, check_packed, forward_only,
                                        gemv_split, num_sms, raise_on, route,
                                        stream)

# kernel launches per wrapper since the last reset_launches()
launches = {"bgmv_matmul": 0, "bgmv_gemv": 0, "bgmv_matmul_quant": 0,
            "bgmv_gemv_quant": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ------------------------------------------------------------ plain versions

def bgmv_matmul_plain(x, w, a, b, ids=None):
    """Plain PyTorch version of :func:`bgmv_matmul` (the semantics of
    ``repro/kernels/bgmv.py:bgmv_reference``, computed in fp32 as the
    kernel does): gather, then the base product and two batched einsums."""
    xf = x.float()
    ar, br = a.float(), b.float()
    if ids is not None:
        idx = ids.long()
        ar, br = ar.index_select(0, idx), br.index_select(0, idx)
    y = xf @ w.float()
    xa = torch.einsum("bsk,brk->bsr", xf, ar)
    return y + torch.einsum("bsr,bor->bso", xa, br)


def bgmv_gemv_plain(x, w, a, b, ids=None):
    """Plain PyTorch version of :func:`bgmv_gemv`: x (B, k) -> (B, n)."""
    return bgmv_matmul_plain(x[:, None, :], w, a, b, ids)[:, 0]


def bgmv_matmul_quant_plain(x, wq, a, b, ids=None):
    """Plain version of :func:`bgmv_matmul_quant`: dequantize, then
    :func:`bgmv_matmul_plain`."""
    return bgmv_matmul_plain(x, wq.dequantize(), a, b, ids)


def bgmv_gemv_quant_plain(x, wq, a, b, ids=None):
    """Plain version of :func:`bgmv_gemv_quant`."""
    return bgmv_gemv_plain(x, wq.dequantize(), a, b, ids)


# ------------------------------------------------------------------ wrappers

def _check(x, w, a, b, ids, nreq: int):
    """Everything the kernels assume, checked before any pointer leaves
    Python: device, dtype, shape, contiguity, id range.  ``w`` is a tensor
    of x's dtype or a packed QuantizedLinear whose layout the caller has
    checked (``common.check_packed``)."""
    dev = x.device
    dense = [("x", x), ("a", a), ("b", b)]
    if isinstance(w, QuantizedLinear):
        for name, t in (("W data", w.data), ("W scales", w.scales)):
            if t.device != dev or t.ndim != 2 or not t.is_contiguous():
                raise ValueError(f"bgmv: {name} must be a contiguous matrix "
                                 f"on {dev}, got {tuple(t.shape)} on "
                                 f"{t.device}")
    else:
        dense.append(("w", w))
    for name, t in dense:
        if t.device != dev:
            raise ValueError(f"bgmv: {name} on {t.device}, x on {dev}")
        if t.dtype != x.dtype:
            raise TypeError(f"bgmv: {name} is {t.dtype}, x is {x.dtype}; "
                            "all four operands must share one dtype")
        if not t.is_contiguous():
            raise ValueError(f"bgmv: {name} must be contiguous")
    if x.dtype not in DTYPES:
        raise TypeError(f"bgmv kernels take float32 or bfloat16, got "
                        f"{x.dtype}")
    k, n = w.shape
    n_adapters, r, ka = a.shape
    if x.shape[-1] != k or ka != k or tuple(b.shape) != (n_adapters, n, r):
        raise ValueError(f"bgmv shapes disagree: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}")
    if min(nreq, k, n, r) < 1 or x.numel() == 0:
        raise ValueError("bgmv kernels need nonempty operands")
    if ids is None:
        if n_adapters != nreq:
            raise ValueError(f"ids=None pairs row i with adapter i, but x has "
                             f"{nreq} requests and the bank {n_adapters}")
        return None
    if (ids.device != dev or ids.dtype != torch.int32
            or tuple(ids.shape) != (nreq,) or not ids.is_contiguous()):
        raise ValueError(f"bgmv ids must be a contiguous ({nreq},) int32 "
                         f"tensor on {dev}, got {ids.dtype} "
                         f"{tuple(ids.shape)} on {ids.device}")
    # a kernel would read out of bounds: check on the host (waits for the
    # device; the serving engine passes ids=None and skips it)
    lo, hi = int(ids.min()), int(ids.max())
    if lo < 0 or hi >= n_adapters:
        raise ValueError(f"bgmv ids out of range [0, {n_adapters}): "
                         f"min {lo}, max {hi}")
    return ids.data_ptr()


def bgmv_matmul(x, w, a, b, ids=None):
    """y[i] = x[i] @ W + (x[i] @ A[ids[i]]^T) @ B[ids[i]]^T.

    x (B, s, k), w (k, n), a (K, r, k), b (K, n, r), ids (B,) int32 or
    None.  Returns (B, s, n) fp32."""
    if not route(x, "bgmv"):
        return bgmv_matmul_plain(x, w, a, b, ids)
    from repro_torch.kernels.build import load
    forward_only("bgmv_matmul", x, w, a, b)
    nreq, s, k = x.shape
    ids_ptr = _check(x, w, a, b, ids, nreq)
    n, r = w.shape[1], a.shape[1]
    p = torch.empty(nreq * s, r, dtype=torch.float32, device=x.device)
    out = torch.empty(nreq, s, n, dtype=torch.float32, device=x.device)
    err = load().bgmv_matmul_launch(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), ids_ptr,
        p.data_ptr(), out.data_ptr(), nreq, s, k, n, r, DTYPES[x.dtype],
        stream(x))
    raise_on(err, "bgmv_matmul")
    launches["bgmv_matmul"] += 1
    return out


def bgmv_gemv(x, w, a, b, ids=None):
    """Single-token form: x (B, k) -> (B, n) fp32."""
    if not route(x, "bgmv"):
        return bgmv_gemv_plain(x, w, a, b, ids)
    from repro_torch.kernels.build import load
    forward_only("bgmv_gemv", x, w, a, b)
    nreq, k = x.shape
    ids_ptr = _check(x, w, a, b, ids, nreq)
    n, r = w.shape[1], a.shape[1]
    ksplit, kchunk = gemv_split(nreq, k, n, num_sms(x.device))
    p = torch.empty(nreq, r, dtype=torch.float32, device=x.device)
    partial = torch.empty(ksplit, nreq, n, dtype=torch.float32,
                          device=x.device)
    out = torch.empty(nreq, n, dtype=torch.float32, device=x.device)
    err = load().bgmv_gemv_launch(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), ids_ptr,
        p.data_ptr(), partial.data_ptr(), out.data_ptr(), nreq, k, n, r,
        ksplit, kchunk, DTYPES[x.dtype], stream(x))
    raise_on(err, "bgmv_gemv")
    launches["bgmv_gemv"] += 1
    return out


def _quant_args(wq):
    return (wq.data.data_ptr(), wq.scales.data_ptr())


def bgmv_matmul_quant(x, wq, a, b, ids=None):
    """Kernel #3: :func:`bgmv_matmul` over a packed base ``wq`` (logical
    (k, n)).  Returns (B, s, n) fp32."""
    if not route(x, "bgmv"):
        return bgmv_matmul_quant_plain(x, wq, a, b, ids)
    from repro_torch.kernels.build import load
    forward_only("bgmv_matmul_quant", x, a, b)
    group, bf16w = check_packed(wq, "bgmv_matmul_quant")
    nreq, s, k = x.shape
    ids_ptr = _check(x, wq, a, b, ids, nreq)
    n, r = wq.shape[1], a.shape[1]
    p = torch.empty(nreq * s, r, dtype=torch.float32, device=x.device)
    out = torch.empty(nreq, s, n, dtype=torch.float32, device=x.device)
    err = load().bgmv_matmul_quant_launch(
        x.data_ptr(), *_quant_args(wq), a.data_ptr(), b.data_ptr(), ids_ptr,
        p.data_ptr(), out.data_ptr(), nreq, s, k, n, r, wq.bits, group,
        bf16w, DTYPES[x.dtype], stream(x))
    raise_on(err, "bgmv_matmul_quant")
    launches["bgmv_matmul_quant"] += 1
    return out


def bgmv_gemv_quant(x, wq, a, b, ids=None):
    """Kernel #4: :func:`bgmv_gemv` over a packed base ``wq``: x (B, k) ->
    (B, n) fp32."""
    if not route(x, "bgmv"):
        return bgmv_gemv_quant_plain(x, wq, a, b, ids)
    from repro_torch.kernels.build import load
    forward_only("bgmv_gemv_quant", x, a, b)
    group, bf16w = check_packed(wq, "bgmv_gemv_quant")
    nreq, k = x.shape
    ids_ptr = _check(x, wq, a, b, ids, nreq)
    n, r = wq.shape[1], a.shape[1]
    ksplit, kchunk = gemv_split(nreq, k, n, num_sms(x.device))
    p = torch.empty(nreq, r, dtype=torch.float32, device=x.device)
    partial = torch.empty(ksplit, nreq, n, dtype=torch.float32,
                          device=x.device)
    out = torch.empty(nreq, n, dtype=torch.float32, device=x.device)
    err = load().bgmv_gemv_quant_launch(
        x.data_ptr(), *_quant_args(wq), a.data_ptr(), b.data_ptr(), ids_ptr,
        p.data_ptr(), partial.data_ptr(), out.data_ptr(), nreq, k, n, r,
        ksplit, kchunk, wq.bits, group, bf16w, DTYPES[x.dtype], stream(x))
    raise_on(err, "bgmv_gemv_quant")
    launches["bgmv_gemv_quant"] += 1
    return out
