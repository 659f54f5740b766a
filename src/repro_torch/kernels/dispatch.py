"""Route LoRA-adapted projections to the hand-written kernels or their plain
versions.

The port of ``repro/kernels/dispatch.py:lora_linear``/``lora_linear_batched``.
The JAX package picks a tier from the config's ``use_pallas`` and the
backend; here the device of the activations decides:

  cuda   the hand-written kernels of ``kernels/bgmv.py`` (banked and
         per-request adapters, forward only) and ``kernels/lora_matmul.py``
         (a single adapter, and a packed base with no adapter, forward and
         backward)
  cpu    the plain PyTorch versions beside them

Nothing else is taken, and nothing falls back from one to the other.
:func:`plain_tier` runs the plain versions on CUDA tensors too, so a run on
the card can be held against them (``chip_smoke.py``).

Base-only projections (no adapter) over an fp base are one ``torch.matmul``
on every device, as the JAX package leaves them to XLA.

A packed frozen base (:class:`~repro_torch.core.quant.QuantizedLinear`):

  banked adapters   kernel #4 (``bgmv_gemv_quant``) when s == 1, else #3
                    (``bgmv_matmul_quant``)
  no adapter        the ``QuantMatmul`` Function (#11 forward, #12
                    backward) where x requires grad, else #11 alone
  single adapter    the ``LoRAMatmulQuant`` Function (#9 forward; #10, #7
                    and #8 backward) where autograd needs its gradients,
                    else #9 alone, as ``fused_lora_apply_quant`` does
  cpu / plain tier  dequantize, then the fp expressions above

The serving engine dequantizes a packed base once per generation on the
plain tier (``launch/serve._prepare_base``), so the per-projection
dequantization here serves direct callers only.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.core.quant import QuantizedLinear
from repro_torch.kernels import bgmv, lora_matmul

_plain = contextvars.ContextVar("repro_torch_plain_tier", default=False)

# calls per route since the last reset_stats(): "bgmv" and "plain" count
# batched projections (kernel / plain version), "lora_matmul" single
# adapter projections on either tier, "quant" projections over a packed
# base that a kernel (#3, #4, #9, #11) serves, "paged" decode attentions that
# kernel #13 serves (models/attention.attention_decode_paged)
stats = {"bgmv": 0, "plain": 0, "lora_matmul": 0, "quant": 0, "paged": 0}


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0


@contextlib.contextmanager
def plain_tier():
    """Within this block, CUDA tensors take the plain versions."""
    token = _plain.set(True)
    try:
        yield
    finally:
        _plain.reset(token)


def _use_kernel(x) -> bool:
    """True where a tensor on x's device takes the kernels: CUDA, outside
    :func:`plain_tier`."""
    if x.device.type == "cpu" or _plain.get():
        return False
    if x.device.type == "cuda":
        return True
    raise ValueError(f"lora_linear takes CUDA or CPU tensors, got {x.device}")


def _result_type(*ts) -> torch.dtype:
    out = ts[0].dtype
    for t in ts[1:]:
        out = torch.promote_types(out, t.dtype)
    return out


def lora_linear_batched(x, w, lora, gamma: float = 1.0):
    """Per-request adapters: batch row i of x (B, s, d_in) is served with
    its own adapter.  ``lora`` is either materialized (``a`` (B, r, d_in),
    ``b`` (B, d_out, r)) or a lazy bank (``a`` (K, r, d_in), ``b``
    (K, d_out, r) plus ``ids`` (B,)).  s == 1 takes the GEMV kernel, s > 1
    the matmul kernel.  Output dtype is the promotion of x, w, a and b (the
    kernels return fp32)."""
    a, b = lora["a"], lora["b"]
    ids = lora.get("ids")
    nreq = (a if ids is None else ids).shape[0]
    if x.ndim != 3 or nreq != x.shape[0]:
        raise ValueError(
            f"batched adapters need x (B, s, d_in) with B requests; got x "
            f"{tuple(x.shape)}, a {tuple(a.shape)}, ids "
            f"{None if ids is None else tuple(ids.shape)}")
    if float(gamma) != 1.0:
        b = b * gamma
    out_dtype = _result_type(x, w, a, b)
    packed = isinstance(w, QuantizedLinear)
    empty = 0 in (*x.shape, w.shape[-1], a.shape[-2])
    if empty or not _use_kernel(x):
        # plain version (an empty operand has nothing to launch a kernel on)
        stats["plain"] += 1
        wf = w.dequantize() if packed else w
        return bgmv.bgmv_matmul_plain(x, wf, a, b, ids).to(out_dtype)
    stats["bgmv"] += 1
    x, a, b = (t.to(out_dtype).contiguous() for t in (x, a, b))
    if packed:
        stats["quant"] += 1
        if x.shape[1] == 1:
            return bgmv.bgmv_gemv_quant(x[:, 0], w, a, b,
                                        ids)[:, None, :].to(out_dtype)
        return bgmv.bgmv_matmul_quant(x, w, a, b, ids).to(out_dtype)
    w = w.to(out_dtype)
    if x.shape[1] == 1:
        return bgmv.bgmv_gemv(x[:, 0], w, a, b, ids)[:, None, :].to(out_dtype)
    return bgmv.bgmv_matmul(x, w, a, b, ids).to(out_dtype)


def quant_linear(x, wq):
    """y = x dequant(W) for a packed base ``wq`` and no adapter: on the card
    the :class:`~repro_torch.kernels.lora_matmul.QuantMatmul` Function (#11,
    backward #12) where x requires grad, else #11 alone; ``x @
    dequantize(W)`` on the CPU and the plain tier.  ``x`` may have any
    number of leading dims; the output dtype is the promotion of x and the
    weight's fp dtype."""
    if 0 in (*x.shape, wq.shape[-1]) or not _use_kernel(x):
        return x @ wq.dequantize()
    stats["quant"] += 1
    out_dtype = _result_type(x, wq)
    lead, n = x.shape[:-1], wq.shape[-1]
    x2 = x.reshape(-1, x.shape[-1]).to(out_dtype).contiguous()
    if torch.is_grad_enabled() and x2.requires_grad:
        y = lora_matmul.QuantMatmul.apply(x2, wq.data, wq.scales,
                                          lora_matmul.packed_meta(wq), True)
    else:
        y = lora_matmul.quant_matmul(x2, wq)
    return y.to(out_dtype).reshape(*lead, n)


def lora_linear(x, w, lora=None, gamma: float = 0.0):
    """y = x W (+ gamma * (x A^T) B^T).

    ``lora`` is ``{"a": (r, d_in), "b": (d_out, r)}`` or None; ``x`` may
    have any number of leading dims.  Leaves with a leading request dim
    (``a`` 3-D) take :func:`lora_linear_batched`.  A single adapter takes
    the fused LoRA matmul, as ``fused_lora_apply`` and
    ``fused_lora_apply_quant`` do in the JAX package: where autograd needs
    its gradients, the
    :class:`~repro_torch.kernels.lora_matmul.LoRAMatmul` Function (#5
    forward, #6-#8 backward), or over a packed W on the card
    :class:`~repro_torch.kernels.lora_matmul.LoRAMatmulQuant` (#9; #10, #7,
    #8); otherwise the forward piece #5 or #9 alone.  Output dtype is the
    promotion of x, w, a and b."""
    packed = isinstance(w, QuantizedLinear)
    if lora is None:
        return quant_linear(x, w) if packed else x @ w
    a, b = lora["a"], lora["b"]
    if a.ndim == 3:
        return lora_linear_batched(x, w, lora, gamma)
    kernel = _use_kernel(x)
    if packed and not kernel:
        w, packed = w.dequantize(), False
    stats["lora_matmul"] += 1
    out_dtype = _result_type(x, w, a, b)
    lead, n = x.shape[:-1], w.shape[-1]
    x2, a, b = (t.to(out_dtype) for t in (x.reshape(-1, x.shape[-1]), a, b))
    if 0 in (*x2.shape, n, a.shape[0]):
        # nothing to launch a kernel on; the expression gives the shape
        wf = (w.dequantize() if packed else w).to(out_dtype)
        return (x2 @ wf + gamma * ((x2 @ a.T) @ b.T)).reshape(*lead, n)
    x2, a, b = x2.contiguous(), a.contiguous(), b.contiguous()
    lm = lora_matmul
    if packed:
        stats["quant"] += 1
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (x2, a, b)):
            y = lm.LoRAMatmulQuant.apply(x2, w.data, w.scales, a, b,
                                         lm.packed_meta(w), float(gamma),
                                         True)
        else:
            y = lm.lora_fwd_quant(x2, w, a, b, float(gamma))[0].to(out_dtype)
        return y.reshape(*lead, n)
    w = w.to(out_dtype).contiguous()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x2, w, a, b)):
        y = lm.LoRAMatmul.apply(x2, w, a, b, float(gamma), kernel)
    else:
        fwd = lm.lora_fwd if kernel else lm.lora_fwd_plain
        y = fwd(x2, w, a, b, float(gamma))[0].to(out_dtype)
    return y.reshape(*lead, n)
