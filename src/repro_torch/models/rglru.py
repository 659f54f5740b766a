"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The port of ``repro/models/rglru.py``.  The JAX module computes the
diagonal linear recurrence h_t = a_t h_{t-1} + b_t with
``jax.lax.associative_scan`` and trains through it by autodiff; PyTorch
has no scan, and a scan on the hot path is a kernel: here every
full-sequence and prefill recurrence goes through the ``RGLRUScan``
Function (``kernels/rglru_scan.py``): kernel #15 forward and its
hand-written backward on the card, their sequential plain versions on the
CPU and under ``dispatch.plain_tier()``.  The two orders of summation
differ only in rounding.  Decode keeps O(1) state, the recurrence hidden h
plus the last ``CONV_WIDTH - 1`` inputs of the causal convolution, and its
step is the elementwise ``a * h + b``, with no kernel, as in JAX.

As with the attention caches, a prefill or decode step updates its cache
in place (and returns it).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels.rglru_scan import RGLRUScan
from repro_torch.models.layers import linear

CONV_WIDTH = 4
_C = 8.0  # RG-LRU gate sharpness constant


def rglru_params(cfg, generator, *, lead=()):
    """The block's weights drawn from ``generator`` (on its device), in the
    JAX tree (``wx``, ``wy``, ``conv``, ``w_a``, ``w_i``, ``lam``,
    ``w_out``); ``lead`` prepends stacked layer dims.  ``lam`` is drawn so
    that a = sigmoid(lam)^c lies in [0.9, 0.999]."""
    d = cfg.d_model
    dr = cfg.rglru_d_state or d
    dt = getattr(torch, cfg.param_dtype)
    lead = tuple(lead)

    def draw(shape, scale):
        w = torch.randn(lead + shape, generator=generator,
                        device=generator.device, dtype=torch.float32)
        return (w * scale).to(dt)

    u = 0.9 + 0.099 * torch.rand(lead + (dr,), generator=generator,
                                 device=generator.device)
    root = u ** (1.0 / _C)
    return {
        "wx": draw((d, dr), d ** -0.5),            # x branch
        "wy": draw((d, dr), d ** -0.5),            # gate branch
        "conv": draw((CONV_WIDTH, dr), CONV_WIDTH ** -0.5),
        "w_a": draw((dr, dr), dr ** -0.5),         # recurrence gate
        "w_i": draw((dr, dr), dr ** -0.5),         # input gate
        "lam": torch.log(root / (1 - root)).to(dt),
        "w_out": draw((dr, d), dr ** -0.5),
    }


def _causal_conv(x, w, tail=None):
    """Depthwise causal convolution of width W: x (b, s, dr), w (W, dr);
    ``tail`` (b, W - 1, dr) holds the inputs of earlier steps (zeros when
    None).  The W multiply-adds of the JAX expression in its order (no
    ``F.conv1d``, which cuDNN would run in TF32 by default).  Returns
    (out, new_tail)."""
    width = w.shape[0]
    s = x.shape[1]
    if tail is None:
        tail = x.new_zeros(x.shape[0], width - 1, x.shape[-1])
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    out = xp[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + s] * w[i]
    return out, xp[:, -(width - 1):]


def _gates(params, xb):
    """(a_t, the gated input b_t), elementwise over (..., dr) in fp32."""
    r = torch.sigmoid(xb @ params["w_a"].float())
    i = torch.sigmoid(xb @ params["w_i"].float())
    log_a = -_C * r * F.softplus(-params["lam"].float())
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6)) \
        * (i * xb)
    return a, b


def rglru_scan(a, b, h0=None):
    """h_t = a_t h_{t-1} + b_t over axis 1 of a, b (b, s, dr), from ``h0``
    (b, dr) or zeros: ``h0`` folds into a new ``b[:, 0]`` (``b[:, 0] +
    a[:, 0] * h0``, as the JAX module does, outside the Function so that
    autograd carries it), then the ``RGLRUScan`` Function runs (#15 and
    its backward; their plain versions on the CPU and on the plain
    tier).  On DTensors the Function runs on each device's local shards
    (``local_map``): the recurrence is independent per batch row and
    channel, so a split of either needs no exchange (a split of the
    sequence is gathered first)."""
    if h0 is not None:
        b = b.clone()
        b[:, 0] = b[:, 0] + a[:, 0] * h0
    if isinstance(a, DTensor):
        from torch.distributed.tensor.experimental import local_map
        pl = tuple(p if isinstance(p, Shard) and p.dim != 1 else Replicate()
                   for p in a.placements)
        return local_map(RGLRUScan.apply, out_placements=(pl,),
                         in_placements=(pl, pl), in_grad_placements=(pl, pl),
                         device_mesh=a.device_mesh,
                         redistribute_inputs=True)(a, b)
    return RGLRUScan.apply(a, b)


def _gelu(y):
    return F.gelu(y.float(), approximate="tanh")


def _branches(params, x, adapters, tail):
    adapters = adapters or {}
    xb = linear(x, params["wx"], adapters.get("wx"))
    yb = linear(x, params["wy"], adapters.get("wy"))
    xb, new_tail = _causal_conv(xb, params["conv"], tail)
    return xb.float(), yb, new_tail


def rglru_apply_fullseq(cfg, params, x, adapters=None):
    """x (b, s, d) -> (b, s, d).  LoRA (if given) adapts wx / wy."""
    xf, yb, _ = _branches(params, x, adapters, None)
    a, b = _gates(params, xf)
    h = rglru_scan(a, b)
    out = h * _gelu(yb)
    return (out @ params["w_out"].float()).to(x.dtype)


def rglru_init_cache(cfg, batch: int, dtype, *, device):
    dr = cfg.rglru_d_state or cfg.d_model
    return {"h": torch.zeros(batch, dr, dtype=torch.float32, device=device),
            "conv_tail": torch.zeros(batch, CONV_WIDTH - 1, dr, dtype=dtype,
                                     device=device)}


def rglru_apply_prefill(cfg, params, x, cache, positions=None,
                        adapters=None):
    """Whole-prompt RG-LRU that also leaves the decode cache as the
    token-by-token decode would: the scan continues from ``cache["h"]``,
    the convolution from ``cache["conv_tail"]``, and the last state and
    conv inputs are written back.  Returns (y, cache)."""
    xf, yb, new_tail = _branches(params, x, adapters, cache["conv_tail"])
    a, b = _gates(params, xf)
    h = rglru_scan(a, b, h0=cache["h"])
    out = h * _gelu(yb)
    y = (out @ params["w_out"].float()).to(x.dtype)
    cache["h"].copy_(h[:, -1])
    cache["conv_tail"].copy_(new_tail)
    return y, cache


def rglru_apply_decode(cfg, params, x, cache, pos=None, adapters=None):
    """One-token step, x (b, 1, d): h = a * h + b elementwise.  Returns
    (y (b, 1, d), cache)."""
    xf, yb, new_tail = _branches(params, x, adapters, cache["conv_tail"])
    a, b = _gates(params, xf[:, 0])
    h = a * cache["h"] + b
    out = h * _gelu(yb[:, 0])
    y = (out @ params["w_out"].float()).to(x.dtype)
    cache["h"].copy_(h)
    cache["conv_tail"].copy_(new_tail)
    return y[:, None, :], cache

