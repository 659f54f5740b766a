"""Federated aggregation strategies over client-stacked LoRA trees.

The port of ``repro/core/aggregation.py`` for the synchronous engine.  A
client-stacked LoRA tree has a leading client dim N on every leaf:
``a: (N, ..., r, d_in)``, ``b: (N, ..., d_out, r)``.

Each strategy is a frozen dataclass in :data:`REGISTRY` bundling:

  - ``mask_grads``   which adapter matrices train during local steps,
  - ``aggregate``    the server-side update over the client dim,
  - ``upload_bytes`` per-round client->server communication accounting.

Registered strategies:

  fedit   aggregate A and B (FedIT)
  ffa     A frozen at init (never trained), aggregate B (FFA-LoRA)
  fedsa   aggregate A only, B stays local (FedSA-LoRA, the substrate for
          SFed-LoRA)
  rolora  alternating rounds: train+aggregate A with B frozen, then B with
          A frozen (RoLoRA)

In the JAX package the flags may be traced; here round indices are python
ints and flags python bools.  ``flora`` (stacking aggregation), the
buffered wrapper of the async engine and rank-aware aggregation
(heterogeneous ranks) are not yet ported and raise.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.lora import AdapterSet
from repro_torch.core.lora import _walk_ab as _map_ab

NOT_YET_PORTED = ("flora",)


def _unwrap_adapters(tree, rank_mask):
    """Strategies take either a raw client-stacked A/B tree (+ explicit
    ``rank_mask``) or an :class:`AdapterSet`, whose own mask is used unless
    one is passed explicitly.  Returns (lora, rank_mask, set_or_None)."""
    if isinstance(tree, AdapterSet):
        return (tree.lora,
                tree.rank_mask if rank_mask is None else rank_mask, tree)
    return tree, rank_mask, None


def _rows(v, x):
    """A (N,) per-client vector as a tensor broadcast over leaf ``x``."""
    t = torch.as_tensor(v, device=x.device)
    return t.reshape((-1,) + (1,) * (x.ndim - 1))


def _map_ab2(t1, t2, fn_a, fn_b):
    """Two-tree variant of ``_map_ab`` over structurally identical trees."""
    def walk(n1, n2):
        if isinstance(n1, dict):
            if n1 and set(n1) <= {"a", "b"}:
                out = {}
                if "a" in n1:
                    out["a"] = fn_a(n1["a"], n2["a"])
                if "b" in n1:
                    out["b"] = fn_b(n1["b"], n2["b"])
                return out
            return {k: walk(v, n2[k]) for k, v in n1.items()}
        return n1
    return walk(t1, t2)


def combine_received(local, aggregated, receive, agg_a, agg_b):
    """Per-client broadcast step: clients whose ``receive`` (N,) entry is
    False keep their LOCAL state on every leaf; the others take the
    ``aggregated`` value on the leaves the strategy aggregates
    (``agg_a``/``agg_b``).  Non-aggregated leaves always stay local."""
    def comb(flag):
        def f(lo, ag):
            if not flag:
                return lo
            return torch.where(_rows(receive, lo).bool(), ag, lo)
        return f
    return _map_ab2(local, aggregated, comb(agg_a), comb(agg_b))


def mask_grads(grads, train_a, train_b):
    """Zero the gradients of frozen matrices (multiplied by 0.0, as in the
    JAX package, so a non-finite gradient stays visible)."""
    fa, fb = float(bool(train_a)), float(bool(train_b))
    return _map_ab(grads, lambda g: g * fa, lambda g: g * fb)


def aggregate_clients(lora_stacked, agg_a, agg_b, *, axis: int = 0,
                      weights=None, rank_mask=None):
    """Server step: replace selected leaves by their (optionally weighted)
    client mean, broadcast back to every client.

    ``weights`` (N,): weight-0 clients are excluded from the mean but still
    receive the aggregate; a leaf whose total weight is zero keeps its
    previous values.  ``rank_mask`` (heterogeneous per-client ranks) is not
    yet ported and raises."""
    if rank_mask is not None:
        raise NotImplementedError(
            "rank-aware aggregation (heterogeneous per-client ranks) is not "
            "yet ported to repro_torch")

    def agg(flag):
        def f(x):
            if not flag:
                return x
            if weights is None:
                return x.mean(dim=axis, keepdim=True).expand_as(x).clone()
            w = _rows(weights, x).to(x.dtype)
            den = w.sum(dim=axis, keepdim=True)
            # multiply by the reciprocal, as the JAX package does
            mean = (x * w).sum(dim=axis, keepdim=True) * (
                1.0 / torch.clamp(den, min=1e-9))
            return torch.where(den > 0, mean.expand_as(x), x)
        return f
    return _map_ab(lora_stacked, agg(agg_a), agg(agg_b))


def upload_bytes(lora_stacked, agg_a, agg_b) -> int:
    """Per-round client->server communication volume (for the comm
    table): one client's aggregated leaves, in bytes."""
    total = 0

    def count(flag):
        def f(x):
            nonlocal total
            if flag:
                total += x[0].numel() * x.element_size()
            return x
        return f
    _map_ab(lora_stacked, count(bool(agg_a)), count(bool(agg_b)))
    return total


# ----------------------------------------------------------------- registry

@dataclasses.dataclass(frozen=True)
class Strategy:
    """One server-side federated LoRA strategy.

    Subclasses override the flag accessors (flag-expressible strategies) or
    :meth:`aggregate` directly (structural aggregators)."""
    name: str

    def train_flags(self, round_idx):
        return (True, True)

    def agg_flags(self, round_idx):
        return (True, True)

    def agg_leaf_flags(self, round_idx):
        """Which (a, b) leaves the server writes when broadcasting its
        aggregate."""
        return self.agg_flags(round_idx)

    def mask_grads(self, grads, round_idx):
        ta, tb = self.train_flags(round_idx)
        return mask_grads(grads, ta, tb)

    def aggregate(self, lora_stacked, round_idx, *, weights=None,
                  rank_mask=None):
        """Server step over a client-stacked A/B tree or an AdapterSet
        (whose rank mask rides along; an AdapterSet comes back as one)."""
        lora, rank_mask, aset = _unwrap_adapters(lora_stacked, rank_mask)
        aa, ab = self.agg_flags(round_idx)
        out = aggregate_clients(lora, aa, ab, weights=weights,
                                rank_mask=rank_mask)
        return out if aset is None else dataclasses.replace(aset, lora=out)

    def upload_bytes(self, lora_stacked, round_idx: int = 0) -> int:
        """Per-round client->server bytes."""
        lora, _, _ = _unwrap_adapters(lora_stacked, None)
        aa, ab = self.agg_flags(round_idx)
        return upload_bytes(lora, aa, ab)

    def upload_bytes_per_client(self, lora_stacked, round_idx: int = 0, *,
                                ranks):
        """(N,) per-client upload bytes counting only the active rank rows
        of A / columns of B (``ranks``: one per client)."""
        lora_stacked, _, _ = _unwrap_adapters(lora_stacked, None)
        aa, ab = self.agg_flags(round_idx)
        ranks = np.asarray([int(r) for r in ranks], np.int64)
        totals = np.zeros(len(ranks), np.int64)

        def count(flag, which):
            def f(x):
                nonlocal totals
                if flag:
                    r_pad = x.shape[-2] if which == "a" else x.shape[-1]
                    if (ranks > r_pad).any():
                        raise ValueError(
                            f"rank {int(ranks.max())} exceeds the padded "
                            f"adapter rank {r_pad}")
                    per_rank_row = x[0].numel() // r_pad * x.element_size()
                    totals = totals + per_rank_row * ranks
                return x
            return f
        _map_ab(lora_stacked, count(bool(aa), "a"), count(bool(ab), "b"))
        return totals


@dataclasses.dataclass(frozen=True)
class FlagStrategy(Strategy):
    """A strategy fully described by static train/aggregate flag pairs."""
    train_a: bool = True
    train_b: bool = True
    agg_a: bool = True
    agg_b: bool = True

    def train_flags(self, round_idx):
        return (self.train_a, self.train_b)

    def agg_flags(self, round_idx):
        return (self.agg_a, self.agg_b)


@dataclasses.dataclass(frozen=True)
class AlternatingStrategy(Strategy):
    """RoLoRA: even rounds train+aggregate A (B frozen), odd rounds B."""

    def train_flags(self, round_idx):
        a_round = int(round_idx) % 2 == 0
        return (a_round, not a_round)

    def agg_flags(self, round_idx):
        return self.train_flags(round_idx)


REGISTRY = {
    "fedit": FlagStrategy("fedit", True, True, True, True),
    "ffa": FlagStrategy("ffa", False, True, False, True),
    "fedsa": FlagStrategy("fedsa", True, True, True, False),
    "rolora": AlternatingStrategy("rolora"),
}

# every strategy name the JAX package knows; NOT_YET_PORTED ones raise
STRATEGIES = tuple(REGISTRY) + NOT_YET_PORTED


def get_strategy(name) -> Strategy:
    """Look up a strategy by name (a Strategy instance passes through)."""
    if isinstance(name, Strategy):
        return name
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"strategy '{name}' is not yet ported to repro_torch; ported: "
            f"{sorted(REGISTRY)}")
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown strategy '{name}'; options {STRATEGIES}") \
            from None


def buffered(inner, **kwargs):
    """The JAX package's async buffered wrapper: not yet ported."""
    raise NotImplementedError(
        "buffered (async) aggregation is not yet ported to repro_torch")
