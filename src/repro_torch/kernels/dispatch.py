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
  meta   the plain versions too: a meta tensor holds shapes and no data,
         so there is nothing for a kernel to compute on (the dry-run,
         ``launch/dryrun.py``, traces this tier, as the JAX dry-run
         traces its reference tier)

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

On a mesh (``core/federated.FederatedTrainer(mesh=)``) the base weights are
DTensors on the model axis.  A projection over one runs on each device's
local shards through ``local_map`` in Megatron's column- or row-parallel
layout (:func:`_sharded_linear`): one ``x @ w`` per device without an
adapter, the single-adapter path above with one, so the kernels see plain
tensors at the local shapes and ``stats`` counts local calls.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core.quant import QuantizedLinear
from repro_torch.kernels import bgmv, lora_matmul
from repro_torch.sharding.specs import batch_kept

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
def plain_tier(plain: bool = True):
    """Within this block, CUDA tensors take the plain versions (with
    ``plain=False``, the kernels again)."""
    token = _plain.set(plain)
    try:
        yield
    finally:
        _plain.reset(token)


def tier_now():
    """A context manager that re-enters the tier in force now: a
    checkpoint's recompute runs in the backward, which autograd may run on
    another thread, so it takes the forward's tier through this and not
    through the thread's own."""
    return plain_tier(_plain.get())


def _use_kernel(x) -> bool:
    """True where a tensor on x's device takes the kernels: CUDA, outside
    :func:`plain_tier`; False on the CPU and on ``meta`` (shapes only).
    A DTensor is judged by its local tensor."""
    if isinstance(x, DTensor):
        x = x.to_local()
    if x.device.type in ("cpu", "meta") or _plain.get():
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
    if isinstance(w, DTensor):
        raise NotImplementedError(
            "per-request adapters over a sharded base (serving on a mesh) "
            "are not ported to repro_torch")
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
        if packed:
            return quant_linear(x, w)
        if isinstance(w, DTensor):
            return _sharded_linear(x, w)
        return x @ w
    a, b = lora["a"], lora["b"]
    if a.ndim == 3:
        return lora_linear_batched(x, w, lora, gamma)
    if isinstance(w, DTensor):
        return _sharded_linear(x, w, lora, gamma)
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


def _layout(w):
    """"column" where a DTensor weight is sharded on its last dim (and
    replicated elsewhere), "row" where on its first, else None."""
    rep = Replicate()
    for kind, dim in (("column", w.ndim - 1), ("row", w.ndim - 2)):
        if any(p == Shard(dim) for p in w.placements) and all(
                p in (Shard(dim), rep) for p in w.placements):
            return kind
    return None


def _as_dtensor(t, mesh):
    """A plain tensor that every device holds in full, as a replicated
    DTensor on ``mesh`` (a DTensor is returned as it is)."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class _ReduceGrad(torch.autograd.Function):
    """Identity forward; the backward all-reduces a partial-sum gradient
    to replicated (Megatron's "f").  A column-parallel projection hands x
    back a partial sum; reduced here, it meets the norms' backward (the
    layer norm's mean takes no partial-sum gradient) replicated."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and any(p.is_partial()
                                          for p in g.placements):
            g = g.redistribute(g.device_mesh,
                               batch_kept(g.placements, g.device_mesh))
        return g


def _sharded_linear(x, w, lora=None, gamma: float = 1.0):
    """:func:`lora_linear` over a DTensor base weight ``w`` (one adapter
    or none), in Megatron's layout, on each device's local shards through
    ``local_map``, so the kernels (or plain versions) see plain tensors at
    the local shapes.

    Column-parallel (``w`` sharded on its last dim; q / k / v / w_gate /
    w_up): x and A replicated, B's rows sharded with W's columns, the
    output sharded on its last dim; the gradients of x and A come back
    partial sums (``in_grad_placements`` Partial): x's is all-reduced at
    once (:class:`_ReduceGrad`), A's where the trainer redistributes it to
    A's placement.  Row-parallel without an adapter (o / w_down): x
    sharded on its last dim, the partial-sum output all-reduced to
    replicated, so the residual stream stays replicated.  An adapted
    row-parallel projection (an o / w_down target, not the default q /
    v): x, W, A and B are first redistributed to replicated, an all-gather
    of x and of W on every call, and every device computes the whole
    projection.  Any other base-only layout is left to DTensor's own
    propagation.

    On a mesh with batch axes (the dry-run's prefill and decode), x's
    batch rows split over "pod" / "data" stay split, in x, the output and
    x's gradient, and a weight's gradient is a partial sum over them."""
    from torch.distributed.tensor.experimental import local_map

    kind = _layout(w)
    if lora is None and kind is None:
        return x @ w
    if lora is not None and kind != "column":
        kind = None
    mesh = w.device_mesh
    full = tuple(Replicate() for _ in range(mesh.ndim))
    w_pl = tuple(w.placements) if kind else full
    sharded = [p != Replicate() for p in w_pl]
    x = _as_dtensor(x, mesh)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    # the batch rows x splits over a batch axis stay split (data parallel)
    rows = [not s and p == Shard(0)
            for s, p in zip(sharded, batch_kept(x2.placements, mesh))]
    keep = tuple(Shard(0) if r else Replicate() for r in rows)

    def on(p):                     # p on the mesh dims that shard W
        return tuple(p if s else k for s, k in zip(sharded, keep))

    def won(p):                    # a weight's: replicated over the rows
        return tuple(p if s else Replicate() for s in sharded)

    def wgrad(p):                  # a weight's gradient: partial over rows
        return tuple(p if s else (Partial() if r else Replicate())
                     for s, r in zip(sharded, rows))

    w_grad = tuple(p if s else g for p, s, g in zip(w_pl, sharded,
                                                   wgrad(Replicate())))

    x_pl = out_pl = grad_pl = keep
    if kind == "column":
        out_pl, grad_pl = on(Shard(1)), on(Partial())
    elif kind == "row":
        x_pl = grad_pl = on(Shard(1))
        out_pl = on(Partial())
    if kind != "row":
        x2 = _ReduceGrad.apply(x2)
    args, in_pl, in_grad = (x2, w), (x_pl, w_pl), (grad_pl, w_grad)
    fn = torch.matmul
    if lora is not None:
        b_pl = won(Shard(0))
        args += tuple(_as_dtensor(t, mesh) for t in (lora["a"], lora["b"]))
        in_pl += (full, b_pl)
        in_grad += (wgrad(Partial()) if kind == "column"
                    else wgrad(Replicate()), wgrad(Shard(0)))

        def fn(x2, w, a, b):
            return lora_linear(x2, w, {"a": a, "b": b}, gamma)
    # one output: its placements are the one element of a tuple
    y = local_map(fn, out_placements=(out_pl,), in_placements=in_pl,
                  in_grad_placements=in_grad, device_mesh=mesh,
                  redistribute_inputs=True)(*args)
    if kind == "row":
        y = y.redistribute(mesh, keep)
    return y.reshape(*lead, y.shape[-1])
