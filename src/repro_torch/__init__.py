"""PyTorch / CUDA port of the SFed-LoRA system, for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference this package is held against;
the module names and layout follow it, so each module here has its
counterpart under ``src/repro/``.  This package imports torch and numpy,
never jax and nothing of ``repro``.

Ported so far: banked multi-tenant LoRA serving of dense decoders
(``launch/serve.py``), with the two BGMV kernels (``kernels/bgmv.py``);
synchronous federated LoRA training (``launch/train.py``,
``core/federated.py``), with the fused LoRA matmul and its backward
(``kernels/lora_matmul.py``); continuous-batching serving over a paged KV
pool (``serve_scheduled``, ``kernels/paged_attention.py``), optionally
over a packed int8 / int4 frozen base (``core/quant.py``, the quantized
BGMV kernels and the packed GEMM); serving and training of the RG-LRU
hybrid family (recurrentgemma-9b, ``models/rglru.py``), over an fp or a
packed base, whose recurrence runs the scan kernel and its backward
(``kernels/rglru_scan.py``); and the public kernel API
(``kernels/ops.py``), with flash attention (``kernels/flash_attention.py``)
behind it; and the fault-tolerant federated engine (buffered aggregation,
fault injection, screening, the Theorem 4.2 sentinel and its collapse
watchdog: ``core/federated.py``, ``core/faults.py``,
``analysis/stability_check.py``) with the train-to-serve publish hook;
and the MoE family (qwen2-moe, granite-moe: ``models/moe.py``), served and
trained, with federated batches drawn on the device
(``data/synthetic.DeviceFederatedData``, ``data_mode="device"``); the
xLSTM family (xlstm-1.3b), the audio encoder-decoder (whisper-medium), the
VLM (paligemma-3b) and the encoder family (roberta-large, the MLM loss);
and the chunked cross-entropy behind ``sharding/opts.py``.  All fifteen
TPU kernels have a counterpart written by hand in CUDA C++ for
``sm_90a``, and so has the scan's backward.

Device rule: entry points run on ``cuda`` unless the caller passes
``device="cpu"``.  Asking for CUDA where there is none raises; nothing
falls back to the CPU quietly.  ``"meta"`` is accepted too: a shape-only
device that holds no data, on which the dry-run (``launch/dryrun.py``)
traces a step's shapes, FLOPs and bytes; nothing runs a step for real
there.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises if it names CUDA and
    this process has no CUDA device.  ``"meta"`` (shapes only, no data)
    is accepted for the dry-run."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} asked for, but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(
            f"unsupported device {str(dev)!r} (cuda, cpu, or meta for "
            "shapes only)")
    return dev
