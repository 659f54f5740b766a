"""Wrapper plumbing shared by the kernel modules (``bgmv``, ``lora_matmul``,
``paged_attention``): the tier rule, the dtype codes the C entry points
take, the caller's stream, launch-error reporting, the forward-only guard,
and the k split of the split-k GEMV body (``csrc/gemv.cuh``) that #1, #4
and #11's decode form share.

Nothing here builds or loads a kernel; ``kernels/build.py`` does that at
first use.
"""
from __future__ import annotations

import torch

# dtype codes of the C entry points: 0 = float32, 1 = bfloat16
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/gemv.cuh kGvCols, kGvWarps, kGvMaxB: columns, warps and rows of x
# per block
GEMV_COLS, GEMV_WARPS, GEMV_MAX_ROWS = 32, 8, 8

_sm_counts = {}


def route(t, name: str) -> bool:
    """The tier rule.  True: a CUDA tensor, launch the kernel.  False: a
    CPU tensor, take the plain version.  Any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name} takes CUDA or CPU tensors, got {t.device}")


def forward_only(name, *ts):
    """Forward-only kernels (BGMV, paged attention, the packed GEMM):
    refuse operands autograd would need gradients for, rather than return
    an output without a grad_fn."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            f"{name}: the kernel has no backward, but an operand requires "
            "grad; run it under torch.no_grad() or torch.inference_mode(), "
            "or train a single adapter (the LoRA matmul Function)")


def stream(t):
    """The caller's current CUDA stream on ``t``'s device, as a handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def check_packed(wq, name: str):
    """Raise unless the packed W ``wq`` (a QuantizedLinear) has the byte
    layout the kernels read and dequantizes to fp32 or bf16; return
    ``(group, bf16w)``: the group size they index scales with (0 for int8)
    and the flag (1 or 0) that makes their loaders round each fp32 product
    ``float(q) * scale`` to bf16, as ``dequantize`` does for a base packed
    from bf16 weights (``csrc/loaders.cuh``)."""
    if wq.out_dtype not in ("float32", "bfloat16"):
        raise TypeError(
            f"{name}: the kernels take a base packed from float32 or "
            f"bfloat16 weights; this one dequantizes to {wq.out_dtype}")
    return (wq.check_layout(f"{name} W"),
            int(wq.out_dtype == "bfloat16"))


def gemv_split(nreq: int, k: int, n: int, num_sms: int):
    """(ksplit, kchunk) for the GEMV body: split k so that about four
    blocks per SM are in flight, with at least one row per warp."""
    tiles = -(-n // GEMV_COLS) * -(-nreq // GEMV_MAX_ROWS)
    want = -(-4 * num_sms // tiles)
    ksplit = max(1, min(want, -(-k // GEMV_WARPS), 65535))
    kchunk = -(-k // ksplit)
    return -(-k // kchunk), kchunk


def num_sms(device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]
