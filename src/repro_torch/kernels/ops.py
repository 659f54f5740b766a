"""The public kernel API: the port of ``repro/kernels/ops.py``.

  fused_lora_matmul(x, w, a, b, gamma)    kernel #5 (``LoRAMatmul``)
  flash_mha(q, k, v, causal=, window=)    kernel #14 (``flash_attention``)
  rglru_scan_op(a, b)                     kernel #15 (``rglru_scan``)

The JAX module picks the Pallas interpreter or the compiled kernels from
``REPRO_KERNEL_INTERPRET`` and the backend; here the device of the tensors
does (CUDA: the hand-written kernels; CPU: their plain versions).  The
shapes each JAX wrapper accepts are the shapes accepted here: what the JAX
kernel's block tiling refuses raises ValueError on every device.
"""
from __future__ import annotations

from repro_torch.kernels.common import route
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lora_matmul import LoRAMatmul
from repro_torch.kernels.rglru_scan import rglru_scan

RGLRU_BLOCK_SEQ = 128     # rglru_scan_pallas's default block_seq


def fused_lora_matmul(x, w, a, b, gamma: float):
    """Batched fused y = x W + gamma (x A^T) B^T; x (..., m, k), W (k, n),
    A (r, k), B (n, r), one dtype.  Output in x's dtype."""
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    y = LoRAMatmul.apply(x2, w.contiguous(), a.contiguous(), b.contiguous(),
                         float(gamma), route(x2, "fused_lora_matmul"))
    return y.reshape(*x.shape[:-1], w.shape[1])


def flash_mha(q, k, v, *, causal=True, window=None):
    """q (b, s, h, d), k / v (b, t, kh, d) with h a multiple of kh ->
    (b, s, h, d).  Heads fold into the kernel's leading dim, query heads
    of one kv head next to each other, so the kernel reads kv head
    ``i // (h // kh)`` for folded query head i: the GQA expansion without
    a repeated K / V."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or h % kh:
        raise ValueError(
            f"flash_mha takes q (b, s, h, d) and k, v (b, t, kh, d) with kh "
            f"dividing h; got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    qf, kf, vf = (x.transpose(1, 2).reshape(-1, x.shape[1], d).contiguous()
                  for x in (q, k, v))
    o = flash_attention(qf, kf, vf, causal=causal, window=window)
    return o.reshape(b, h, s, d).transpose(1, 2)


def rglru_scan_op(a, b):
    """Diagonal linear recurrence h_t = a_t h_{t-1} + b_t from h_0 = 0;
    a, b (bt, s, d), with s <= 128 or a multiple of 128 (the JAX kernel's
    sequence blocks)."""
    s = a.shape[1] if a.ndim == 3 else 0
    if s < 1 or s % min(RGLRU_BLOCK_SEQ, s):
        raise ValueError(
            f"rglru_scan_op needs a, b (bt, s, d) with s <= "
            f"{RGLRU_BLOCK_SEQ} or a multiple of it (the JAX kernel's "
            f"sequence blocks); got {tuple(a.shape)}")
    return rglru_scan(a.contiguous(), b.contiguous())
