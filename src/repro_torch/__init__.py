"""PyTorch / CUDA port of the SFed-LoRA system, for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference this package is held against;
the module names and layout follow it, so each module here has its
counterpart under ``src/repro/``.  This package imports torch and numpy,
never jax and nothing of ``repro``.

Ported so far: banked multi-tenant LoRA serving of dense decoders
(``launch/serve.py``), with the two BGMV kernels (``kernels/bgmv.py``);
synchronous federated LoRA training (``launch/train.py``,
``core/federated.py``), with the fused LoRA matmul and its backward
(``kernels/lora_matmul.py``); and continuous-batching serving over a paged
KV pool (``serve_scheduled``, ``kernels/paged_attention.py``), optionally
over a packed int8 / int4 frozen base (``core/quant.py``, the quantized
BGMV kernels and the packed GEMM).  All ten kernels are written by hand in
CUDA C++ for ``sm_90a``.

Device rule: entry points run on ``cuda`` unless the caller passes
``device="cpu"``.  Asking for CUDA where there is none raises; nothing
falls back to the CPU quietly.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises if it names CUDA and
    this process has no CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} asked for, but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev
