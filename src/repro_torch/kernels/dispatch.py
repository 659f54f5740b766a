"""Route LoRA-adapted projections to the BGMV kernels or their plain versions.

The port of ``repro/kernels/dispatch.py:lora_linear``/``lora_linear_batched``.
The JAX package picks a tier from the config's ``use_pallas`` and the
backend; here the device of the activations decides:

  cuda   the hand-written kernels of ``kernels/bgmv.py``
  cpu    the plain PyTorch versions beside them

Nothing else is taken, and nothing falls back from one to the other.
:func:`plain_tier` runs the plain versions on CUDA tensors too, so a run on
the card can be held against them (``chip_smoke.py``).

Base-only projections (no adapter) are one ``torch.matmul`` on every
device, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.kernels import bgmv

_plain = contextvars.ContextVar("repro_torch_plain_tier", default=False)

# projections per route since the last reset_stats()
stats = {"bgmv": 0, "plain": 0}


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
    empty = 0 in (*x.shape, w.shape[-1], a.shape[-2])
    if empty or not _use_kernel(x):
        # plain version (an empty operand has nothing to launch a kernel on)
        stats["plain"] += 1
        return bgmv.bgmv_matmul_plain(x, w, a, b, ids).to(out_dtype)
    stats["bgmv"] += 1
    x, w, a, b = (t.to(out_dtype) for t in (x, w, a, b))
    x = x.contiguous()
    if x.shape[1] == 1:
        return bgmv.bgmv_gemv(x[:, 0], w, a, b, ids)[:, None, :].to(out_dtype)
    return bgmv.bgmv_matmul(x, w, a, b, ids).to(out_dtype)


def lora_linear(x, w, lora=None, gamma: float = 0.0):
    """y = x W (+ gamma * (x A^T) B^T).

    ``lora`` is ``{"a": (r, d_in), "b": (d_out, r)}`` or None; ``x`` may
    have any number of leading dims.  Leaves with a leading request dim
    (``a`` 3-D) take :func:`lora_linear_batched`.  A single adapter on CUDA
    runs the BGMV matmul kernel as a bank of one: every row of x is one
    request row of adapter 0."""
    if lora is None:
        return x @ w
    if lora["a"].ndim == 3:
        return lora_linear_batched(x, w, lora, gamma)
    lead = x.shape[:-1]
    x3 = x.reshape(1, -1, x.shape[-1])
    one = {"a": lora["a"][None], "b": lora["b"][None]}
    y = lora_linear_batched(x3, w, one, gamma)
    return y.reshape(*lead, w.shape[-1])
