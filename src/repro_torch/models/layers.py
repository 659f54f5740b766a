"""Shared building blocks (plain functions over explicit parameter dicts).

The port of ``repro/models/layers.py``.  Numerics follow the JAX package:
norms and RoPE angles in fp32, RoPE half-split (not interleaved), and the
tanh-approximated GELU of ``jax.nn.gelu(approximate=True)``.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels.dispatch import lora_linear, tier_now


def checkpointed(fn, *args, policy=None):
    """``fn(*args)`` under a non-reentrant ``torch.utils.checkpoint``, as
    ``jax.checkpoint`` runs a function: the backward recomputes what ``fn``
    would have saved, and keeps only its inputs.  The recompute re-enters
    the forward's tier (:func:`~repro_torch.kernels.dispatch.tier_now`).
    ``policy``: a selective-checkpoint policy (ops it marks to save are
    kept, the rest recomputed)."""
    def contexts():
        fwd, rec = (create_selective_checkpoint_contexts(policy) if policy
                    else (contextlib.nullcontext(), contextlib.nullcontext()))
        return fwd, _both(rec, tier_now())
    return checkpoint(fn, *args, use_reentrant=False, context_fn=contexts)


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(cfg, x, params, prefix: str):
    if cfg.norm == "layernorm":
        return layer_norm(x, params[f"{prefix}_scale"],
                          params[f"{prefix}_bias"])
    return rms_norm(x, params[f"{prefix}_scale"])


def norm_params(cfg, d: int, prefix: str, *, device, lead=()):
    """Norm scale (and bias) of width ``d``; ``lead`` prepends stacked
    layer dims."""
    dt = getattr(torch, cfg.param_dtype)
    p = {f"{prefix}_scale": torch.ones(tuple(lead) + (d,), dtype=dt,
                                       device=device)}
    if cfg.norm == "layernorm":
        p[f"{prefix}_bias"] = torch.zeros(tuple(lead) + (d,), dtype=dt,
                                          device=device)
    return p


# --------------------------------------------------------------------- RoPE

def rope_angles(positions, head_dim: int, theta: float):
    """positions (..., s) int -> cos/sin (..., s, head_dim//2) float32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta: float):
    """x (..., s, h, hd); positions broadcastable to (..., s)."""
    cos, sin = rope_angles(positions, x.shape[-1], theta)
    cos, sin = cos[..., None, :], sin[..., None, :]   # (..., s, 1, half)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- MLP

def mlp_params(cfg, generator, d_in: int, d_ff: int, *, lead=()):
    """Gated-MLP weights drawn from ``generator`` (on its device); ``lead``
    prepends stacked layer dims."""
    dt = getattr(torch, cfg.param_dtype)

    def draw(shape, scale):
        w = torch.randn(tuple(lead) + shape, generator=generator,
                        device=generator.device, dtype=torch.float32)
        return (w * scale).to(dt)

    p = {"w_up": draw((d_in, d_ff), d_in ** -0.5),
         "w_down": draw((d_ff, d_in), d_ff ** -0.5)}
    if cfg.mlp_variant in ("swiglu", "geglu"):
        p["w_gate"] = draw((d_in, d_ff), d_in ** -0.5)
    return p


def mlp_apply(cfg, params, x):
    """Gated MLP (swiglu / geglu) or plain GELU MLP."""
    up = linear(x, params["w_up"])
    if cfg.mlp_variant == "swiglu":
        h = F.silu(linear(x, params["w_gate"])) * up
    elif cfg.mlp_variant == "geglu":
        h = F.gelu(linear(x, params["w_gate"]), approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    return linear(h, params["w_down"])


def linear(x, w, adapters=None):
    """y = x W (+ (x A^T) B^T): ``adapters`` is a prepared adapter node
    (gamma already folded into B) or None."""
    return lora_linear(x, w, adapters, 1.0)
