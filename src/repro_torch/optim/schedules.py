"""Learning-rate schedules (callable lr support for the optimizers).

The port of ``repro/optim/schedules.py``: each schedule maps the step
``t`` (an int tensor or a number) to an fp32 scalar tensor on ``t``'s
device, computed in fp32 as the JAX package computes it."""
from __future__ import annotations

import math

import torch


def _f32(t):
    dev = t.device if isinstance(t, torch.Tensor) else None
    return torch.as_tensor(t, dtype=torch.float32, device=dev)


def constant(lr: float):
    return lambda t: torch.full((), lr, dtype=torch.float32,
                                device=_f32(t).device)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def lr(t):
        t = _f32(t)
        warm = peak_lr * t / max(warmup_steps, 1)
        prog = torch.clamp((t - warmup_steps) /
                           max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(t < warmup_steps, warm, cos)
    return lr


def step_decay(lr0: float, decay: float, every: int):
    def lr(t):
        return lr0 * decay ** torch.div(_f32(t), every, rounding_mode="floor")
    return lr


def make_schedule(name: str, lr: float, **kw):
    if name == "constant":
        return constant(lr)
    if name == "warmup_cosine":
        return warmup_cosine(lr, kw.get("warmup_steps", 50),
                             kw.get("total_steps", 1000))
    if name == "step":
        return step_decay(lr, kw.get("decay", 0.5), kw.get("every", 100))
    raise ValueError(f"unknown schedule '{name}'")
