"""Quantized storage for the frozen base weights.

The port of ``repro/core/quant.py``, with the same byte layout, so packed
bases and packed checkpoints move between the two packages unchanged:

  int8   per-output-channel symmetric absmax.  data int8 (..., k, n),
         scales fp32 (..., 1, n) - scale_j = max_i |w_ij| / 127.
  int4   grouped absmax along the contraction dim.  k is padded up to a
         multiple of ``group_size``, two 4-bit values pack per byte along
         k (even row in the low nibble, odd row in the high nibble): data
         uint8 (..., kq/2, n), scales fp32 (..., kq/G, n) - scale_gj =
         max_{i in g} |w_ij| / 7.

Rounding is half to even (``torch.round``, as ``jnp.round``), so the same
fp32 weights pack to the same bytes in both packages.

Only GEMM weights that route through ``kernels/dispatch`` quantize
(:data:`ELIGIBLE`).  Embedding, head, norms and every LoRA leaf stay fp: a
quantized tree is a params tree where some leaves are
:class:`QuantizedLinear` nodes instead of tensors.

Tier policy (``kernels/dispatch``): the plain tier dequantizes to fp first
(bit-exact against :func:`dequantize`); on the card the packed bytes go to
the kernels, which dequantize each W element as they load it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

MODES = ("none", "int8", "int4")

# a power of two <= 128, as in the JAX package (its kernels' k blocks are
# multiples of the 128-wide lane tile)
GROUP_SIZES = (2, 4, 8, 16, 32, 64, 128)
DEFAULT_GROUP = 64


@dataclasses.dataclass(frozen=True)
class QuantizedLinear:
    """A packed frozen GEMM weight: ``data`` and ``scales`` (tensors, or
    numpy arrays straight from a checkpoint) plus the static fields.

    ``.shape``, ``.dtype`` and ``.ndim`` report the LOGICAL fp view, so
    shape-walking code (LoRA init) works unchanged.  Leading stacked dims
    (the repeat-layer layout) ride along on both ``data`` and ``scales``;
    ``repro_torch.tree.tree_map`` maps over the two together, so slicing
    one layer off a stacked leaf slices both."""
    data: Any       # int8 (..., k, n) | uint8 (..., kq/2, n) packed pairs
    scales: Any     # fp32 (..., 1, n) | fp32 (..., kq/G, n)
    bits: int = 8
    group_size: int = 0   # 0 = per-channel (int8)
    k: int = 0            # logical contraction dim (before padding)
    out_dtype: str = "float32"

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape[:-2]) + (self.k, self.data.shape[-1])

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.out_dtype)

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nbytes(self) -> int:
        """Packed bytes (data + scales)."""
        return math.prod(self.data.shape) + 4 * math.prod(self.scales.shape)

    def dequantize(self) -> torch.Tensor:
        return dequantize(self)

    def check_layout(self, name: str = "packed W") -> int:
        """Raise unless data and scales hold the byte layout above for this
        ``bits``, ``group_size`` and ``k``; return the group size the
        kernels index scales with (0 for int8)."""
        d, s = self.data, self.scales
        n = d.shape[-1]
        if self.bits == 8:
            ok = (d.dtype == torch.int8 and d.shape[-2] == self.k
                  and tuple(s.shape[-2:]) == (1, n))
            group = 0
        else:
            group = self.group_size
            kq = 2 * d.shape[-2]
            ok = (self.bits == 4 and d.dtype == torch.uint8
                  and group in GROUP_SIZES and kq % group == 0
                  and kq - group < self.k <= kq
                  and tuple(s.shape[-2:]) == (kq // group, n))
        if not ok or s.dtype != torch.float32:
            raise ValueError(
                f"{name}: not a valid int{self.bits} layout: data "
                f"{d.dtype} {tuple(d.shape)}, scales {s.dtype} "
                f"{tuple(s.shape)}, k {self.k}, group {self.group_size}")
        return group


# --------------------------------------------------------------- quant / deq

def quantize(w, bits: int = 8, group_size: int = DEFAULT_GROUP
             ) -> QuantizedLinear:
    """One-shot post-load quantization of a (..., k, n) GEMM weight."""
    w = torch.as_tensor(w)
    if w.ndim < 2:
        raise ValueError(f"quantize expects a >=2-D GEMM weight, got "
                         f"{tuple(w.shape)}")
    out_dtype = str(w.dtype).removeprefix("torch.")
    k = w.shape[-2]
    wf = w.float()
    if bits == 8:
        amax = wf.abs().amax(dim=-2, keepdim=True)                # (..., 1, n)
        scales = amax.clamp_min(1e-12) / 127.0
        data = torch.clamp(torch.round(wf / scales), -127, 127).to(torch.int8)
        return QuantizedLinear(data, scales, 8, 0, k, out_dtype)
    if bits != 4:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if group_size not in GROUP_SIZES:
        raise ValueError(f"group_size must be a power of two <= 128 (got "
                         f"{group_size})")
    kq = -(-k // group_size) * group_size
    if kq != k:       # pad k to a group multiple; zero rows dequantize to 0
        wf = torch.nn.functional.pad(wf, (0, 0, 0, kq - k))
    lead, n = wf.shape[:-2], wf.shape[-1]
    wg = wf.reshape(*lead, kq // group_size, group_size, n)
    amax = wg.abs().amax(dim=-2, keepdim=True)             # (..., ng, 1, n)
    scales = amax.clamp_min(1e-12) / 7.0
    q = torch.clamp(torch.round(wg / scales), -7, 7).to(torch.int32)
    qu = q.reshape(*lead, kq, n) & 0xF
    # pack row pairs: even row -> low nibble, odd row -> high nibble
    data = (qu[..., 0::2, :] | (qu[..., 1::2, :] << 4)).to(torch.uint8)
    return QuantizedLinear(data, scales[..., 0, :], 4, group_size, k,
                           out_dtype)


def unpack_int4(data):
    """uint8 (..., kq/2, n) packed pairs -> int32 (..., kq, n) in [-8, 7]."""
    wi = data.to(torch.int32)
    lo = wi & 0xF
    hi = (wi >> 4) & 0xF
    lo = lo - 2 * (lo & 0x8)    # sign-extend the 4-bit two's complement
    hi = hi - 2 * (hi & 0x8)
    vals = torch.stack([lo, hi], dim=-2)            # (..., kq/2, 2, n)
    return vals.reshape(*data.shape[:-2], data.shape[-2] * 2, data.shape[-1])


def dequantize(q: QuantizedLinear) -> torch.Tensor:
    """Packed -> fp (..., k, n) in the original dtype: one fp32 product per
    element, the ground truth of the plain tier and of the kernels."""
    if q.bits == 8:
        w = q.data.float() * q.scales.float()
    else:
        vals = unpack_int4(q.data).float()
        lead = vals.shape[:-2]
        kq, n = vals.shape[-2:]
        ng = kq // q.group_size
        w = (vals.reshape(*lead, ng, q.group_size, n)
             * q.scales.float()[..., :, None, :]).reshape(*lead, kq, n)
        if kq != q.k:
            w = w[..., :q.k, :]
    return w.to(q.dtype)


# ----------------------------------------------------------------- tree ops

# (parent key, leaf key) pairs eligible for quantization: the frozen GEMM
# weights that route through kernels/dispatch.lora_linear
# (the JAX package's list).  The MoE block's leaves sit under "moe" and
# none is listed: over --quant the router, the expert stacks and the shared
# experts stay fp, as in JAX, and only q / k / v / o are packed.  Neither
# xLSTM block ("mlstm", "slstm") is listed either, so --quant packs no leaf
# of xlstm-1.3b (d_ff 0, no MLP), as in JAX
ELIGIBLE = {
    "attn": ("q", "k", "v", "o"),
    "cross": ("q", "k", "v", "o"),
    "mlp": ("w_up", "w_gate", "w_down"),
    "rglru": ("wx", "wy"),
}


def _eligible(path) -> bool:
    return len(path) >= 2 and path[-1] in ELIGIBLE.get(path[-2], ())


def _walk(node, fn, path=()):
    if isinstance(node, dict):
        return {key: _walk(v, fn, path + (key,)) for key, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_walk(v, fn, path + (str(i),))
                          for i, v in enumerate(node))
    return fn(path, node)


def _packed_leaves(params):
    out = []
    _walk(params, lambda path, leaf: out.append(leaf)
          if isinstance(leaf, QuantizedLinear) else None)
    return out


def quantize_tree(params, mode: str, group_size: int = DEFAULT_GROUP):
    """Replace every eligible frozen GEMM leaf with a QuantizedLinear node.
    ``mode`` is "int8" / "int4" ("none" returns the tree unchanged).
    Leading stacked dims quantize along the last two dims per layer."""
    if mode in (None, "none"):
        return params
    if mode not in ("int8", "int4"):
        raise ValueError(f"quant mode must be one of {MODES}, got '{mode}'")
    bits = 8 if mode == "int8" else 4

    def fn(path, leaf):
        if isinstance(leaf, QuantizedLinear):
            raise ValueError(
                f"leaf {'/'.join(path)} is already quantized: quantize_tree "
                "expects an fp base (dequantize first to requantize)")
        if _eligible(path) and getattr(leaf, "ndim", 0) >= 2:
            return quantize(leaf, bits, group_size)
        return leaf

    return _walk(params, fn)


def dequantize_tree(params):
    """fp view of a (possibly) quantized tree: the plain tier's up-front
    dequantization and the merge path."""
    return _walk(params, lambda path, leaf: dequantize(leaf)
                 if isinstance(leaf, QuantizedLinear) else leaf)


def requantize_merged(merged, ref):
    """Re-pack a merged (fp) tree onto ``ref``'s quantization grid.

    ``merge_lora`` dequantizes packed leaves to fold an adapter in; this
    re-quantizes exactly the leaves that were packed in ``ref``, with the
    same bits and group size, so ``--merge --quant`` keeps the packed
    footprint."""
    def walk(m, r):
        if isinstance(r, QuantizedLinear):
            if isinstance(m, QuantizedLinear):
                return m          # not dequantized by the merge (no adapter)
            return quantize(m, r.bits, r.group_size or DEFAULT_GROUP)
        if isinstance(r, dict):
            return {key: walk(m[key], v) for key, v in r.items()}
        if isinstance(r, (list, tuple)):
            return type(r)(walk(mv, rv) for mv, rv in zip(m, r))
        return m

    return walk(merged, ref)


def has_quantized(params) -> bool:
    return bool(_packed_leaves(params))


def tree_quant_mode(params):
    """"int8" / "int4" when the tree holds quantized leaves, else None.
    Mixed-bits trees are rejected: checkpoints are quantized one-shot."""
    bits = {leaf.bits for leaf in _packed_leaves(params)}
    if not bits:
        return None
    if len(bits) > 1:
        raise ValueError(f"mixed quantization bits in one tree: {bits}")
    return "int8" if bits.pop() == 8 else "int4"


def quant_footprint(params) -> dict:
    """Byte accounting over the ELIGIBLE (base GEMM) leaves: the fp bytes
    they would occupy, the bytes they actually occupy, and the whole-tree
    total."""
    acc = {"base_fp_bytes": 0, "base_bytes": 0, "total_bytes": 0}

    def fn(path, leaf):
        if isinstance(leaf, QuantizedLinear):
            acc["base_fp_bytes"] += (math.prod(leaf.shape)
                                     * leaf.dtype.itemsize)
            acc["base_bytes"] += leaf.nbytes
            acc["total_bytes"] += leaf.nbytes
        else:
            b = math.prod(leaf.shape) * leaf.dtype.itemsize
            acc["total_bytes"] += b
            if _eligible(path):
                acc["base_fp_bytes"] += b
                acc["base_bytes"] += b
        return leaf

    _walk(params, fn)
    return acc


def apply_quant_flag(base, mode, group_size: int = DEFAULT_GROUP, *,
                     source: str = "checkpoint"):
    """Reconcile a restored or built base with a ``--quant`` flag: an fp
    base and a quant mode -> one-shot quantize; an already matching tree ->
    returned as it is; a packed tree under a different flag raises (the fp
    weights are gone)."""
    have = tree_quant_mode(base)
    want = None if mode in (None, "none") else mode
    if have == want:
        return base
    if have is None:
        return quantize_tree(base, want, group_size)
    raise ValueError(
        f"{source} holds a {have}-quantized base but --quant "
        f"{mode or 'none'} was requested - restore it with --quant {have}")
