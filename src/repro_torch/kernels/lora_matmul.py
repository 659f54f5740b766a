"""Fused LoRA matmul with its backward: CUDA kernels, plain versions and the
autograd Function that wires them.

    y = x W + gamma (x A^T) B^T        x (m, k), W (k, n), A (r, k), B (n, r)

The port of ``repro/kernels/lora_matmul.py:lora_matmul_vjp``, the
``jax.custom_vjp`` the JAX package trains through.  Four pieces, each a
hand-written kernel in ``csrc/lora_matmul.cu`` beside its plain PyTorch
version:

  lora_fwd     (#5)  y = x W + gamma p B^T, p = x A^T     -> (y, p)
  lora_bwd_dx  (#6)  dx = g W^T + gamma q A, q = g B      -> (dx, q)
  lora_bwd_da  (#7)  dA = gamma q^T x
  lora_bwd_db  (#8)  dB = gamma g^T p

All return fp32.  dW is never computed: the base is frozen.  Beside them,
the base-only GEMM over a packed frozen base:

  quant_matmul (#11) y = x dequant(W)                     -> y

Tier rule: a CUDA tensor launches the kernel; a CPU tensor takes the plain
version; anything else raises.  There is no fallback from the kernel to the
plain version.  :class:`LoRAMatmul` runs the same wiring of residuals and
pieces on either tier, so the CPU tests exercise exactly what the card
runs.

Kernel notes (what they replace, what bounds them on an H100, what the
design does about it):

* ``lora_fwd`` replaces ``_fwd_kernel`` (``lora_matmul.py:55``, called by
  ``_fwd_call`` and ``_fwd_call_scratch``).  At the training path's shapes
  (m = 512, k = 2048, n = 2048 or 256, r = 64) it is bound by operations:
  fp32 FMA on the CUDA cores (67 TFLOP/s peak; no TF32, so the fp32
  tolerances hold), in 64 x 64 shared-memory tiles.  The TPU kernel builds
  p in VMEM during its n == 0 sweep; GPU blocks run in no order, so a
  pre-pass writes p (m x r, fp32) first and each tile adds gamma p B^T
  after its base product.  p is the residual the backward reuses; without
  grad it is scratch.
* ``lora_bwd_dx`` replaces ``_bwd_dx_kernel`` (``:147``, ``_bwd_dx_call``):
  the mirror of the forward, a q = g B pre-pass, then tiles that contract
  over n and read W by rows.  Bound by operations like the forward.
* ``lora_bwd_da`` and ``lora_bwd_db`` replace ``_bwd_da_kernel`` (``:201``)
  and ``_bwd_db_kernel`` (``:230``), which accumulate over m in an output
  block the TPU grid revisits.  Here each block owns an output tile and
  loops over all m itself, in a fixed order: no atomics, so a training run
  repeats bit for bit.  Small (2 m r k operations); bound by the latency
  of that loop.
* ``quant_matmul`` replaces ``_qmm_kernel`` (``:514``, ``_qmm_call``): for
  m > 8 rows (admission prefills, bound by operations) the #5 tile with no
  rank term and a W slab that is dequantized as it is loaded (int8 per
  channel or int4 per group, ``csrc/loaders.cuh``), with the k loop inside
  the block, so no reduction crosses blocks.  At decode shapes (m <= 8) it
  is bound by the packed bytes of W (int4 ``w_up`` at gemma-2b: 2048 x
  16384 / 2 = 16.8 MB, about 5 us at 3.35 TB/s), and the tile's k loop
  over 60 empty rows was bound by its latency instead (PERF.md); there it
  takes the split-k GEMV body of the BGMV decode kernel
  (``csrc/gemv.cuh``), which reads each packed element once, and a
  fixed-order pass adds the k-split partials.  Forward only: its backward
  (#12) is not ported yet, so on CUDA it raises when x requires grad.

Each kernel wrapper adds one to its entry of :data:`launches` where it
launches its kernel (the rank pre-pass included), and nowhere else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import (DTYPES, GEMV_MAX_ROWS, check_packed,
                                        gemv_split, num_sms, raise_on, route,
                                        stream)

# kernel launches per wrapper since the last reset_launches()
launches = {"lora_fwd": 0, "lora_bwd_dx": 0, "lora_bwd_da": 0,
            "lora_bwd_db": 0, "quant_matmul": 0}

_MAX_GRID_Y = 65535 * 64          # rows of one operand a tile grid covers


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ------------------------------------------------------------ plain versions
#
# fp32 accumulation as in the kernels; float64 inputs stay float64 (so
# gradcheck can run the Function on its plain pieces).

def _acc(t):
    return t if t.dtype == torch.float64 else t.float()


def lora_fwd_plain(x, w, a, b, gamma: float):
    """Plain version of :func:`lora_fwd`: (y, p = x A^T)."""
    xf = _acc(x)
    p = xf @ _acc(a).T
    return xf @ _acc(w) + gamma * (p @ _acc(b).T), p


def lora_bwd_dx_plain(g, w, a, b, gamma: float):
    """Plain version of :func:`lora_bwd_dx`: (dx, q = g B)."""
    gf = _acc(g)
    q = gf @ _acc(b)
    return gf @ _acc(w).T + gamma * (q @ _acc(a)), q


def lora_bwd_da_plain(q, x, gamma: float):
    """Plain version of :func:`lora_bwd_da`: dA = gamma q^T x (r, k)."""
    return gamma * (_acc(q).T @ _acc(x))


def lora_bwd_db_plain(g, p, gamma: float):
    """Plain version of :func:`lora_bwd_db`: dB = gamma g^T p (n, r)."""
    return gamma * (_acc(g).T @ _acc(p))


def quant_matmul_plain(x, wq):
    """Plain version of :func:`quant_matmul`: x @ dequantize(W) in fp32."""
    return _acc(x) @ _acc(wq.dequantize())


# ------------------------------------------------------------------ wrappers

def _check(name, ops, fp32=None, packed=None):
    """Everything the kernels assume, checked before any pointer leaves
    Python: device, dtype, contiguity, nonempty 2-D operands.  ``ops`` share
    one dtype (fp32 or bf16); ``fp32`` operands (residuals) are fp32;
    ``packed`` operands (a packed W's data and scales, whose dtypes
    ``common.check_packed`` checks) keep their own."""
    first = next(iter(ops.values()))
    dev, dt = first.device, first.dtype
    if dt not in DTYPES:
        raise TypeError(f"{name}: kernels take float32 or bfloat16, got {dt}")
    checks = [(label, t, dt) for label, t in ops.items()]
    checks += [(label, t, torch.float32) for label, t in (fp32 or {}).items()]
    checks += [(label, t, t.dtype) for label, t in (packed or {}).items()]
    for label, t, want in checks:
        if t.device != dev:
            raise ValueError(f"{name}: {label} on {t.device}, not {dev}")
        if t.dtype != want:
            raise TypeError(f"{name}: {label} is {t.dtype}, expected {want}")
        if t.ndim != 2 or t.numel() == 0:
            raise ValueError(f"{name}: {label} must be a nonempty matrix, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if max(t.shape) > _MAX_GRID_Y:
            raise ValueError(f"{name}: {label} {tuple(t.shape)} exceeds the "
                             f"kernels' grid ({_MAX_GRID_Y} rows)")


def _shapes(name, x_or_g, w, a, b):
    m = x_or_g.shape[0]
    k, n = w.shape
    r = a.shape[0]
    if tuple(a.shape) != (r, k) or tuple(b.shape) != (n, r):
        raise ValueError(f"{name}: shapes disagree: w {tuple(w.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}")
    return m, k, n, r


def lora_fwd(x, w, a, b, gamma: float):
    """Kernel #5: (y (m, n) fp32, p = x A^T (m, r) fp32)."""
    if not route(x, "lora_matmul"):
        return lora_fwd_plain(x, w, a, b, gamma)
    from repro_torch.kernels.build import load
    _check("lora_fwd", {"x": x, "w": w, "a": a, "b": b})
    m, k, n, r = _shapes("lora_fwd", x, w, a, b)
    if x.shape[1] != k:
        raise ValueError(f"lora_fwd: x {tuple(x.shape)} vs w "
                         f"{tuple(w.shape)}")
    p = torch.empty(m, r, dtype=torch.float32, device=x.device)
    y = torch.empty(m, n, dtype=torch.float32, device=x.device)
    err = load().lora_fwd_launch(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), p.data_ptr(),
        y.data_ptr(), m, k, n, r, float(gamma), DTYPES[x.dtype], stream(x))
    raise_on(err, "lora_fwd")
    launches["lora_fwd"] += 1
    return y, p


def lora_bwd_dx(g, w, a, b, gamma: float):
    """Kernel #6: (dx (m, k) fp32, q = g B (m, r) fp32)."""
    if not route(g, "lora_matmul"):
        return lora_bwd_dx_plain(g, w, a, b, gamma)
    from repro_torch.kernels.build import load
    _check("lora_bwd_dx", {"g": g, "w": w, "a": a, "b": b})
    m, k, n, r = _shapes("lora_bwd_dx", g, w, a, b)
    if g.shape[1] != n:
        raise ValueError(f"lora_bwd_dx: g {tuple(g.shape)} vs w "
                         f"{tuple(w.shape)}")
    q = torch.empty(m, r, dtype=torch.float32, device=g.device)
    dx = torch.empty(m, k, dtype=torch.float32, device=g.device)
    err = load().lora_bwd_dx_launch(
        g.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), q.data_ptr(),
        dx.data_ptr(), m, k, n, r, float(gamma), DTYPES[g.dtype], stream(g))
    raise_on(err, "lora_bwd_dx")
    launches["lora_bwd_dx"] += 1
    return dx, q


def lora_bwd_da(q, x, gamma: float):
    """Kernel #7: dA = gamma q^T x, (r, k) fp32, reduced over m in a fixed
    order."""
    if not route(x, "lora_matmul"):
        return lora_bwd_da_plain(q, x, gamma)
    from repro_torch.kernels.build import load
    _check("lora_bwd_da", {"x": x}, fp32={"q": q})
    (m, k), r = x.shape, q.shape[1]
    if q.shape[0] != m:
        raise ValueError(f"lora_bwd_da: q {tuple(q.shape)} vs x "
                         f"{tuple(x.shape)}")
    da = torch.empty(r, k, dtype=torch.float32, device=x.device)
    err = load().lora_bwd_da_launch(
        q.data_ptr(), x.data_ptr(), da.data_ptr(), m, k, r, float(gamma),
        DTYPES[x.dtype], stream(x))
    raise_on(err, "lora_bwd_da")
    launches["lora_bwd_da"] += 1
    return da


def lora_bwd_db(g, p, gamma: float):
    """Kernel #8: dB = gamma g^T p, (n, r) fp32, reduced over m in a fixed
    order."""
    if not route(g, "lora_matmul"):
        return lora_bwd_db_plain(g, p, gamma)
    from repro_torch.kernels.build import load
    _check("lora_bwd_db", {"g": g}, fp32={"p": p})
    (m, n), r = g.shape, p.shape[1]
    if p.shape[0] != m:
        raise ValueError(f"lora_bwd_db: p {tuple(p.shape)} vs g "
                         f"{tuple(g.shape)}")
    db = torch.empty(n, r, dtype=torch.float32, device=g.device)
    err = load().lora_bwd_db_launch(
        g.data_ptr(), p.data_ptr(), db.data_ptr(), m, n, r, float(gamma),
        DTYPES[g.dtype], stream(g))
    raise_on(err, "lora_bwd_db")
    launches["lora_bwd_db"] += 1
    return db


# ---------------------------------------------------------------- autograd

class LoRAMatmul(torch.autograd.Function):
    """y = x W + gamma (x A^T) B^T with gradients for x, A and B.

    ``apply(x, w, a, b, gamma, kernel)``: 2-D operands of one dtype, a
    python-float ``gamma``, and ``kernel`` choosing the pieces (True: the
    kernel wrappers, which launch on CUDA tensors; False: the plain
    versions, as :func:`~repro_torch.kernels.dispatch.plain_tier` asks).
    The output has x's dtype.

    Forward runs #5 and saves x, A, B and the residual p, and a reference
    to W.  Backward runs #6 (whose q #7 needs), then #7 and #8; dx is
    returned only where x needs it.  W is frozen: a W that requires grad
    raises, since no piece computes dW."""

    @staticmethod
    def forward(ctx, x, w, a, b, gamma, kernel):
        if w.requires_grad:
            raise ValueError(
                "LoRAMatmul never computes dW (the base weight is frozen); "
                "pass a W that does not require grad")
        fwd = lora_fwd if kernel else lora_fwd_plain
        y, p = fwd(x, w, a, b, gamma)
        ctx.save_for_backward(x, a, b, p)
        ctx.w = w
        ctx.gamma, ctx.kernel = gamma, kernel
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, a, b, p = ctx.saved_tensors
        gamma = ctx.gamma
        if ctx.kernel:
            dx_fn, da_fn, db_fn = lora_bwd_dx, lora_bwd_da, lora_bwd_db
        else:
            dx_fn, da_fn, db_fn = (lora_bwd_dx_plain, lora_bwd_da_plain,
                                   lora_bwd_db_plain)
        g = g.to(x.dtype).contiguous()
        dx, q = dx_fn(g, ctx.w, a, b, gamma)
        da = da_fn(q, x, gamma)
        db = db_fn(g, p, gamma)
        need = ctx.needs_input_grad
        return (dx.to(x.dtype) if need[0] else None, None,
                da.to(a.dtype) if need[2] else None,
                db.to(b.dtype) if need[3] else None, None, None)


def quant_matmul(x, wq):
    """Kernel #11: y = x dequant(W), x (m, k), ``wq`` a packed
    :class:`~repro_torch.core.quant.QuantizedLinear` of logical shape
    (k, n).  Returns (m, n) fp32."""
    if not route(x, "lora_matmul"):
        return quant_matmul_plain(x, wq)
    from repro_torch.kernels.build import load
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            "quant_matmul: the packed-base GEMM has no backward yet (kernel "
            "#12, _qmm_dx_kernel, is not yet ported), but x requires grad; "
            "run it under torch.no_grad() or torch.inference_mode()")
    group = check_packed(wq, "quant_matmul")
    _check("quant_matmul", {"x": x}, packed={"W data": wq.data,
                                             "W scales": wq.scales})
    (m, k), n = x.shape, wq.shape[1]
    if wq.k != k:
        raise ValueError(f"quant_matmul: x {tuple(x.shape)} vs W "
                         f"{tuple(wq.shape)}")
    y = torch.empty(m, n, dtype=torch.float32, device=x.device)
    ksplit = kchunk = 0
    partial = None
    if m <= GEMV_MAX_ROWS:           # the decode form: split-k GEMV
        ksplit, kchunk = gemv_split(m, k, n, num_sms(x.device))
        partial = torch.empty(ksplit, m, n, dtype=torch.float32,
                              device=x.device)
    err = load().quant_matmul_launch(
        x.data_ptr(), wq.data.data_ptr(), wq.scales.data_ptr(),
        None if partial is None else partial.data_ptr(), y.data_ptr(), m, k,
        n, ksplit, kchunk, wq.bits, group, DTYPES[x.dtype], stream(x))
    raise_on(err, "quant_matmul")
    launches["quant_matmul"] += 1
    return y
