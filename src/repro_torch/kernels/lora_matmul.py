"""Fused LoRA matmul with its backward, over an fp or a packed frozen base:
CUDA kernels, plain versions and the autograd Functions that wire them.

    y = x W + gamma (x A^T) B^T        x (m, k), W (k, n), A (r, k), B (n, r)

The port of ``repro/kernels/lora_matmul.py``'s ``jax.custom_vjp``s that the
JAX package trains through: ``lora_matmul_vjp`` (an fp W),
``lora_matmul_quant_vjp`` (a packed W) and ``quant_matmul_vjp`` (a packed W
and no adapter).  Each piece is a hand-written kernel in
``csrc/lora_matmul.cu`` beside its plain PyTorch version:

  lora_fwd          (#5)  y = x W + gamma p B^T, p = x A^T   -> (y, p)
  lora_bwd_dx       (#6)  dx = g W^T + gamma q A, q = g B    -> (dx, q)
  lora_bwd_da       (#7)  dA = gamma q^T x
  lora_bwd_db       (#8)  dB = gamma g^T p
  lora_fwd_quant    (#9)  #5 over a packed W                 -> (y, p)
  lora_bwd_dx_quant (#10) #6 over a packed W                 -> (dx, q)
  quant_matmul      (#11) y = x dequant(W)
  quant_matmul_dx   (#12) dx = g dequant(W)^T

All return fp32.  dW is never computed: the base is frozen.  A packed W is
a :class:`~repro_torch.core.quant.QuantizedLinear` (int8 per channel or
int4 per group, packed from fp32 or bf16 weights); every packed kernel
dequantizes each W element as it loads it, as ``dequantize`` forms it.

Tier rule: a CUDA tensor launches the kernel; a CPU tensor takes the plain
version; anything else raises.  There is no fallback from the kernel to the
plain version.  :class:`LoRAMatmul` (#5; #6-#8), :class:`LoRAMatmulQuant`
(#9; #10, #7, #8) and :class:`QuantMatmul` (#11; #12) run the same wiring
of residuals and pieces on either tier, so the CPU tests exercise exactly
what the card runs.

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
  block the TPU grid revisits.  Small (2 m r k operations) with few output
  tiles (32 for dA at q), so a block that walked all m would be bound by
  that loop's latency: the m loop is split into chunks, one block per
  (output tile, chunk), about two blocks per SM, and a second pass adds
  the chunks' partial sums in a fixed order.  No atomics, so a training
  run repeats bit for bit.
* ``lora_fwd_quant`` and ``lora_bwd_dx_quant`` replace ``_fwd_kernel_q``
  (``:345``, ``_fwd_call_q``) and ``_bwd_dx_kernel_q`` (``:414``,
  ``_bwd_dx_call_q``): the tiles of #5 and #6 with W read through a
  dequantizing loader (``csrc/loaders.cuh``), by column for the forward and
  by row for dx, after the same p / q pre-passes (the TPU kernels build them
  in their first sweep).  Bound by operations like #5 and #6 (the packed W's
  fewer bytes lower a bound that was not binding); the loader adds integer
  work and a scale load per staged element.  An int4 W may hold kq > k
  rows: x's columns, W's rows and dx's columns are masked at the logical k.
* ``quant_matmul`` replaces ``_qmm_kernel`` (``:514``, ``_qmm_call``): for
  m > 8 rows (prefills, training; bound by operations) the forward tile of
  #9 with no rank term.  At decode shapes (m <= 8) it is bound by the
  packed bytes of W (int4 ``w_up`` at gemma-2b: 2048 x 16384 / 2 = 16.8 MB,
  about 5 us at 3.35 TB/s), and the tile's k loop over 60 empty rows was
  bound by its latency instead (PERF.md); there it takes the split-k GEMV
  body of the BGMV decode kernel (``csrc/gemv.cuh``), which reads each
  packed element once, and a fixed-order pass adds the k-split partials.
* ``quant_matmul_dx`` replaces ``_qmm_dx_kernel`` (``:544``,
  ``_qmm_dx_call``): the dx tile of #10 with no rank term, bound by
  operations (2 m n k; 2 x 512 x 2048 x 16384 at the MLP's projections).
  Training runs it at m = 512 only, so it has no GEMV form; it is right at
  any m.

Each kernel wrapper adds one to its entry of :data:`launches` where it
launches its kernel (the rank pre-pass included), and nowhere else.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import QuantizedLinear
from repro_torch.kernels.common import (DTYPES, GEMV_MAX_ROWS, check_packed,
                                        gemv_split, num_sms, raise_on, route,
                                        stream)

# kernel launches per wrapper since the last reset_launches()
launches = {"lora_fwd": 0, "lora_bwd_dx": 0, "lora_bwd_da": 0,
            "lora_bwd_db": 0, "lora_fwd_quant": 0, "lora_bwd_dx_quant": 0,
            "quant_matmul": 0, "quant_matmul_dx": 0}

_MAX_GRID_Y = 65535 * 64          # rows of one operand a tile grid covers
_TILE, _SLAB = 64, 16             # the tile kernel's output tile and k step


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


def lora_fwd_quant_plain(x, wq, a, b, gamma: float):
    """Plain version of :func:`lora_fwd_quant`: :func:`lora_fwd_plain` over
    ``dequantize(W)``."""
    return lora_fwd_plain(x, wq.dequantize(), a, b, gamma)


def lora_bwd_dx_quant_plain(g, wq, a, b, gamma: float):
    """Plain version of :func:`lora_bwd_dx_quant`: :func:`lora_bwd_dx_plain`
    over ``dequantize(W)``."""
    return lora_bwd_dx_plain(g, wq.dequantize(), a, b, gamma)


def quant_matmul_plain(x, wq):
    """Plain version of :func:`quant_matmul`: x @ dequantize(W) in fp32."""
    return _acc(x) @ _acc(wq.dequantize())


def quant_matmul_dx_plain(g, wq):
    """Plain version of :func:`quant_matmul_dx`: g @ dequantize(W)^T in
    fp32."""
    return _acc(g) @ _acc(wq.dequantize()).T


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


def _m_split(m: int, ni: int, nj: int, device):
    """(msplit, mchunk) for #7 / #8 over an (ni, nj) output: split the m
    loop so that about two blocks per SM are in flight, in chunks of whole
    k steps."""
    tiles = -(-ni // _TILE) * -(-nj // _TILE)
    want = max(1, min(-(-2 * num_sms(device) // tiles), -(-m // _SLAB)))
    mchunk = -(-m // want)
    mchunk = -(-mchunk // _SLAB) * _SLAB
    return -(-m // mchunk), mchunk


def _m_split_out(m: int, ni: int, nj: int, device):
    """(out (ni, nj) fp32, partial scratch (msplit, ni, nj) fp32 or None,
    msplit, mchunk) for #7 / #8 with the m split of :func:`_m_split`."""
    msplit, mchunk = _m_split(m, ni, nj, device)
    out = torch.empty(ni, nj, dtype=torch.float32, device=device)
    partial = (torch.empty(msplit, ni, nj, dtype=torch.float32, device=device)
               if msplit > 1 else None)
    return out, partial, msplit, mchunk


def _ptr(t):
    return None if t is None else t.data_ptr()


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
    da, partial, msplit, mchunk = _m_split_out(m, r, k, x.device)
    err = load().lora_bwd_da_launch(
        q.data_ptr(), x.data_ptr(), _ptr(partial), da.data_ptr(), m, k, r,
        msplit, mchunk, float(gamma), DTYPES[x.dtype], stream(x))
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
    db, partial, msplit, mchunk = _m_split_out(m, n, r, g.device)
    err = load().lora_bwd_db_launch(
        g.data_ptr(), p.data_ptr(), _ptr(partial), db.data_ptr(), m, n, r,
        msplit, mchunk, float(gamma), DTYPES[g.dtype], stream(g))
    raise_on(err, "lora_bwd_db")
    launches["lora_bwd_db"] += 1
    return db


def _check_quant(name, ops, wq):
    """:func:`_check` of ``ops`` and of a packed W's data and scales, after
    its layout and dtype (``common.check_packed``).  Returns (group, bf16w)
    for the C entry point."""
    group, bf16w = check_packed(wq, name)
    _check(name, ops, packed={"W data": wq.data, "W scales": wq.scales})
    return group, bf16w


def lora_fwd_quant(x, wq, a, b, gamma: float):
    """Kernel #9: :func:`lora_fwd` over a packed W ``wq`` (a
    :class:`~repro_torch.core.quant.QuantizedLinear` of logical shape (k,
    n)): (y (m, n) fp32, p = x A^T (m, r) fp32)."""
    if not route(x, "lora_matmul"):
        return lora_fwd_quant_plain(x, wq, a, b, gamma)
    from repro_torch.kernels.build import load
    group, bf16w = _check_quant("lora_fwd_quant", {"x": x, "a": a, "b": b},
                                wq)
    m, k, n, r = _shapes("lora_fwd_quant", x, wq, a, b)
    if x.shape[1] != k:
        raise ValueError(f"lora_fwd_quant: x {tuple(x.shape)} vs W "
                         f"{tuple(wq.shape)}")
    p = torch.empty(m, r, dtype=torch.float32, device=x.device)
    y = torch.empty(m, n, dtype=torch.float32, device=x.device)
    err = load().lora_fwd_quant_launch(
        x.data_ptr(), wq.data.data_ptr(), wq.scales.data_ptr(), a.data_ptr(),
        b.data_ptr(), p.data_ptr(), y.data_ptr(), m, k, n, r, float(gamma),
        wq.bits, group, bf16w, DTYPES[x.dtype], stream(x))
    raise_on(err, "lora_fwd_quant")
    launches["lora_fwd_quant"] += 1
    return y, p


def lora_bwd_dx_quant(g, wq, a, b, gamma: float):
    """Kernel #10: :func:`lora_bwd_dx` over a packed W: (dx (m, k) fp32,
    q = g B (m, r) fp32)."""
    if not route(g, "lora_matmul"):
        return lora_bwd_dx_quant_plain(g, wq, a, b, gamma)
    from repro_torch.kernels.build import load
    group, bf16w = _check_quant("lora_bwd_dx_quant",
                                {"g": g, "a": a, "b": b}, wq)
    m, k, n, r = _shapes("lora_bwd_dx_quant", g, wq, a, b)
    if g.shape[1] != n:
        raise ValueError(f"lora_bwd_dx_quant: g {tuple(g.shape)} vs W "
                         f"{tuple(wq.shape)}")
    q = torch.empty(m, r, dtype=torch.float32, device=g.device)
    dx = torch.empty(m, k, dtype=torch.float32, device=g.device)
    err = load().lora_bwd_dx_quant_launch(
        g.data_ptr(), wq.data.data_ptr(), wq.scales.data_ptr(), a.data_ptr(),
        b.data_ptr(), q.data_ptr(), dx.data_ptr(), m, k, n, r, float(gamma),
        wq.bits, group, bf16w, DTYPES[g.dtype], stream(g))
    raise_on(err, "lora_bwd_dx_quant")
    launches["lora_bwd_dx_quant"] += 1
    return dx, q


def quant_matmul(x, wq):
    """Kernel #11: y = x dequant(W), x (m, k), ``wq`` a packed W of logical
    shape (k, n).  Returns (m, n) fp32."""
    if not route(x, "lora_matmul"):
        return quant_matmul_plain(x, wq)
    from repro_torch.kernels.build import load
    group, bf16w = _check_quant("quant_matmul", {"x": x}, wq)
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
        _ptr(partial), y.data_ptr(), m, k,
        n, ksplit, kchunk, wq.bits, group, bf16w, DTYPES[x.dtype], stream(x))
    raise_on(err, "quant_matmul")
    launches["quant_matmul"] += 1
    return y


def quant_matmul_dx(g, wq):
    """Kernel #12: dx = g dequant(W)^T, g (m, n), ``wq`` a packed W of
    logical shape (k, n).  Returns (m, k) fp32."""
    if not route(g, "lora_matmul"):
        return quant_matmul_dx_plain(g, wq)
    from repro_torch.kernels.build import load
    group, bf16w = _check_quant("quant_matmul_dx", {"g": g}, wq)
    (m, n), k = g.shape, wq.k
    if wq.shape[1] != n:
        raise ValueError(f"quant_matmul_dx: g {tuple(g.shape)} vs W "
                         f"{tuple(wq.shape)}")
    dx = torch.empty(m, k, dtype=torch.float32, device=g.device)
    err = load().quant_matmul_dx_launch(
        g.data_ptr(), wq.data.data_ptr(), wq.scales.data_ptr(),
        dx.data_ptr(), m, k, n, wq.bits, group, bf16w, DTYPES[g.dtype],
        stream(g))
    raise_on(err, "quant_matmul_dx")
    launches["quant_matmul_dx"] += 1
    return dx


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
        dx, da, db = _lora_grads(
            ctx, g, lora_bwd_dx if ctx.kernel else lora_bwd_dx_plain)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, None, da if need[2] else None,
                db if need[3] else None, None, None)


def _lora_grads(ctx, g, dx_fn):
    """The backward wiring both LoRA Functions share: ``dx_fn`` (#6 or #10,
    or its plain version) gives dx and the residual q, then #7 and #8 (or
    their plain versions) give dA and dB; each in its operand's dtype."""
    x, a, b, p = ctx.saved_tensors
    da_fn, db_fn = ((lora_bwd_da, lora_bwd_db) if ctx.kernel
                    else (lora_bwd_da_plain, lora_bwd_db_plain))
    g = g.to(x.dtype).contiguous()
    dx, q = dx_fn(g, ctx.w, a, b, ctx.gamma)
    return (dx.to(x.dtype), da_fn(q, x, ctx.gamma).to(a.dtype),
            db_fn(g, p, ctx.gamma).to(b.dtype))


def packed_meta(wq):
    """The static fields of a packed W, which the Functions below take
    beside its data and scales tensors (a QuantizedLinear is not a tensor,
    so autograd could not see through it)."""
    return (wq.bits, wq.group_size, wq.k, wq.out_dtype)


def _frozen_scales(name, ws):
    if ws.requires_grad:
        raise ValueError(
            f"{name} never computes gradients of the packed base (it is "
            "frozen); pass scales that do not require grad")


class LoRAMatmulQuant(torch.autograd.Function):
    """:class:`LoRAMatmul` over a packed W: the port of ``_vjp_op_q``.

    ``apply(x, wd, ws, a, b, meta, gamma, kernel)``: ``wd`` and ``ws`` the
    packed W's data and scales, ``meta`` its :func:`packed_meta`, the rest
    as in :class:`LoRAMatmul`.  Forward runs #9 and saves x, A, B and the
    residual p.  Backward runs #10 (whose q #7 needs), then #7 and #8; dx
    only where x needs it.  No gradient reaches the packed data or scales:
    scales that require grad raise."""

    @staticmethod
    def forward(ctx, x, wd, ws, a, b, meta, gamma, kernel):
        _frozen_scales("LoRAMatmulQuant", ws)
        wq = QuantizedLinear(wd, ws, *meta)
        fwd = lora_fwd_quant if kernel else lora_fwd_quant_plain
        y, p = fwd(x, wq, a, b, gamma)
        ctx.save_for_backward(x, a, b, p)
        ctx.w = wq
        ctx.gamma, ctx.kernel = gamma, kernel
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        dx, da, db = _lora_grads(
            ctx, g,
            lora_bwd_dx_quant if ctx.kernel else lora_bwd_dx_quant_plain)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, None, None,
                da if need[3] else None, db if need[4] else None, None, None,
                None)


class QuantMatmul(torch.autograd.Function):
    """y = x dequant(W) with the gradient of x: the port of ``_qmm_op``.

    ``apply(x, wd, ws, meta, kernel)``: forward #11 (its tile, or its GEMV
    form for m <= 8), backward #12.  No gradient reaches the packed data or
    scales: scales that require grad raise."""

    @staticmethod
    def forward(ctx, x, wd, ws, meta, kernel):
        _frozen_scales("QuantMatmul", ws)
        wq = QuantizedLinear(wd, ws, *meta)
        ctx.wq, ctx.kernel, ctx.dtype = wq, kernel, x.dtype
        y = (quant_matmul if kernel else quant_matmul_plain)(x, wq)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        dx_fn = quant_matmul_dx if ctx.kernel else quant_matmul_dx_plain
        dx = dx_fn(g.to(ctx.dtype).contiguous(), ctx.wq)
        return dx.to(ctx.dtype), None, None, None, None
