"""Minimal optax-like optimizers over nested dicts of tensors.

The port of ``repro/optim/optimizers.py``, with the same state layout
(``{"t", "mu"}`` for sgd, ``{"m", "v", "t"}`` for adamw; ``t`` an int32
scalar on the parameters' device).  An optimizer is ``(init_fn,
update_fn)``:

    state = init_fn(params)
    updates, state = update_fn(grads, state, params)
    params = apply_updates(params, updates)

Nothing is updated in place: each call returns new tensors, as in JAX.
"""
from __future__ import annotations

import torch

from repro_torch.sharding.specs import full_local
from repro_torch.tree import tree_leaves, tree_map


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in fp32, summed leaf by
    leaf in sorted-key order (the JAX package's order); a DTensor leaf's
    sum reduced over its mesh, so the norm is a plain 0-d tensor."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros(())
    total = sum(full_local(x.float().square().sum()) for x in leaves)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads)


def _lr_at(lr, t):
    return lr(t) if callable(lr) else lr


def _step0(params):
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def sgd(lr, momentum: float = 0.0):
    """``lr`` may be a float or a schedule callable t -> lr."""
    def init(params):
        state = {"t": _step0(params)}
        if momentum != 0.0:
            state["mu"] = tree_map(torch.zeros_like, params)
        return state

    def update(grads, state, params=None):
        t = state["t"] + 1
        step = _lr_at(lr, t)
        if momentum == 0.0:
            return tree_map(lambda g: -step * g, grads), {"t": t}
        mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
        return tree_map(lambda m: -step * m, mu), {"mu": mu, "t": t}

    return init, update


def adamw(lr, betas=(0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 0.0):
    b1, b2 = betas

    def init(params):
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params),
                "t": _step0(params)}

    def update(grads, state, params):
        t = state["t"] + 1
        step = _lr_at(lr, t)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g.square(),
                     state["v"], grads)
        tf = t.to(torch.float32)
        bc1 = 1 - b1 ** tf
        bc2 = 1 - b2 ** tf

        def upd(m_, v_, p):
            d = m_ / bc1 / (torch.sqrt(v_ / bc2) + eps)
            return -step * (d + weight_decay * p)

        return tree_map(upd, m, v, params), {"m": m, "v": v, "t": t}

    return init, update


def make_optimizer(cfg):
    """cfg: OptimizerConfig (lr_schedule: constant | warmup_cosine | step)."""
    lr = cfg.lr
    if getattr(cfg, "lr_schedule", "constant") != "constant":
        from repro_torch.optim.schedules import make_schedule
        lr = make_schedule(cfg.lr_schedule, cfg.lr,
                           **getattr(cfg, "lr_schedule_kwargs", {}) or {})
    if cfg.name == "sgd":
        return sgd(lr, cfg.momentum)
    if cfg.name == "adamw":
        return adamw(lr, cfg.betas, cfg.eps, cfg.weight_decay)
    raise ValueError(cfg.name)
