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
  flora   stacking aggregation (FLoRA): the server forms the weighted mean
          update sum_i w_i B_i A_i from the stacked factors and hands every
          client its top-r singular components

Every strategy takes a (N, r) rank mask for heterogeneous per-client ranks
(the padded representation, ``core/lora.rank_mask``).  In the JAX package
the flags may be traced; here round indices are python ints and flags
python bools.  :func:`buffered` wraps any of them for the async buffered
engine (``core/federated.make_buffered_round_body``).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.lora import AdapterSet
from repro_torch.core.lora import _walk_ab as _map_ab
from repro_torch.core.lora import rank_leaf_mask as _rank_weight
from repro_torch.tree import tree_leaves


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


def negate_flag(flag) -> bool:
    """NOT over a strategy flag.  The port's flags are python bools (the
    JAX package's may be traced, where ``not`` would raise)."""
    return not flag


def _map_ab_pairs(tree, fn_pair):
    """Apply ``fn_pair({"a": .., "b": ..}) -> node`` to every adapter node.
    Strategies that couple A and B (stacking) need both matrices: an a-only
    or b-only node raises rather than stay unaggregated."""
    def walk(node):
        if isinstance(node, dict):
            if set(node) <= {"a", "b"} and node:
                if set(node) != {"a", "b"}:
                    raise ValueError(
                        "pair-coupled aggregation (e.g. flora stacking) "
                        f"needs both 'a' and 'b'; got {sorted(node)}")
                return fn_pair(node)
            return {k: walk(v) for k, v in node.items()}
        return node
    return walk(tree)


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


def per_client_finite(tree):
    """(N,) bool: does client i's slice of every leaf hold only finite
    values?  The server's non-finite screen over a stacked upload."""
    leaves = tree_leaves(tree)
    n = leaves[0].shape[0]
    ok = torch.ones((n,), dtype=torch.bool, device=leaves[0].device)
    for x in leaves:
        ok = ok & torch.isfinite(x).reshape(n, -1).all(dim=1)
    return ok


def per_client_norm(tree):
    """(N,) float32 L2 norm of client i's slice across all leaves, summed
    leaf by leaf in sorted-key order."""
    leaves = tree_leaves(tree)
    n = leaves[0].shape[0]
    sq = torch.zeros((n,), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        sq = sq + x.float().square().reshape(n, -1).sum(dim=1)
    return torch.sqrt(sq)


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
    previous values.

    ``rank_mask`` (N, r), heterogeneous per-client ranks in the padded
    representation: each rank row is averaged only over the clients active
    in it, and each client receives the aggregate re-masked to its own
    rows, so inactive rows stay exactly zero.  A rank row no sampled client
    holds keeps its previous per-client values."""
    def agg(flag, which):
        def f(x):
            if not flag:
                return x
            if weights is None and rank_mask is None:
                # sum * (1/n), as JAX lowers x.mean: torch's mean rounds
                # differently, and the buffered engine's all-ones weighted
                # mean below must equal this bit for bit
                n = x.shape[axis]
                return (x.sum(dim=axis, keepdim=True) * (1.0 / n)
                        ).expand_as(x).clone()
            w = torch.ones((1,) * x.ndim, dtype=x.dtype, device=x.device)
            if weights is not None:
                w = w * _rows(weights, x).to(x.dtype)
            if rank_mask is not None:
                w = w * _rank_weight(rank_mask, x, which)
            # the weights' total in client order, as XLA sums it: torch
            # reduces a short contiguous dim in another order
            den = functools.reduce(torch.add, w.unbind(axis)).unsqueeze(axis)
            # multiply by the reciprocal, as the JAX package does: with all
            # weights 1 this is the unweighted path above, bit for bit
            mean = ((x * w).sum(dim=axis, keepdim=True) * (
                1.0 / torch.clamp(den, min=1e-9))).expand_as(x)
            if rank_mask is not None:
                mean = mean * _rank_weight(rank_mask, x, which)
            return torch.where(den > 0, mean, x)
        return f
    return _map_ab(lora_stacked, agg(agg_a, "a"), agg(agg_b, "b"))


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


@dataclasses.dataclass(frozen=True)
class StackingStrategy(Strategy):
    """FLoRA's stacking aggregation.

    Stacking the weighted B_i along columns and the A_i along rows makes
    the stacked product the exact weighted sum of the client updates, m =
    sum_i w_i B_i A_i (weights normalized to sum 1; a plain mean without
    weights).  The server redistributes m's truncated SVD, sqrt(s) split
    between the factors, so every client continues from identical adapters
    of the original shape.  Components past the smaller side of m are
    zero, as are those of zero singular value.

    The SVD is taken through the stacked factors rather than of m itself:
    QR factorizations B_s = Q_b R_b and A_s^T = Q_a R_a reduce it to the SVD
    of the (N r)-wide core R_b R_a^T, whose singular values are m's, with
    U = Q_b U_core and V^T = V_core^T Q_a^T.  At llama2-7b's q that is a
    512 x 512 SVD for N = 4 at r = 128 in place of one of 4096 x 4096.  It
    runs in float64 (a truncation between close singular values amplifies
    rounding by |m| / gap) and the result is rounded to the adapters'
    dtype.  Singular vectors are fixed only up to a sign per pair: each
    pair is flipped so that the largest entry of its left vector is
    positive, so the result does not depend on the solver's choice and
    aggregating identical clients twice leaves the factors where they are.
    Another implementation may flip a row of A with the column of B it
    multiplies, so B A is what compares across implementations.

    With a ``rank_mask`` the inactive rows of every client are zero, so
    the stacked product sums the true rank-r_i products, and each client
    keeps the top-r_i components: the best rank-r_i approximation of the
    mean update."""

    def aggregate(self, lora_stacked, round_idx, *, weights=None,
                  rank_mask=None):
        lora_stacked, rank_mask, aset = _unwrap_adapters(lora_stacked,
                                                         rank_mask)

        def redistribute(node):
            a, b = node["a"], node["b"]          # (N,...,r,di), (N,...,do,r)
            n, r = a.shape[0], a.shape[-2]
            f64 = torch.float64
            if weights is None:
                w = torch.full((n,), 1.0 / n, dtype=f64, device=a.device)
            else:
                w = torch.as_tensor(weights, device=a.device).to(f64)
                w = w / torch.clamp(w.sum(), min=1e-9)
            # the stacked factors: B_s (..., do, N r), A_s (..., N r, di)
            b_s = (b.to(f64) * _rows(w, b)).movedim(0, -2).flatten(-2)
            a_s = a.to(f64).movedim(0, -3).flatten(-3, -2)
            q_b, r_b = torch.linalg.qr(b_s)
            q_a, r_a = torch.linalg.qr(a_s.transpose(-1, -2))
            u, s, vh = torch.linalg.svd(r_b @ r_a.transpose(-1, -2),
                                        full_matrices=False)
            k = min(r, s.shape[-1])
            u = q_b @ u[..., :, :k]
            vh = vh[..., :k, :] @ q_a.transpose(-1, -2)
            # one sign per pair: the largest entry of u's column positive
            top = u.gather(-2, u.abs().argmax(dim=-2, keepdim=True))
            sign = torch.where(top < 0, -1.0, 1.0).to(f64)
            sr = torch.sqrt(s[..., :k])
            a_new = (sr * sign[..., 0, :])[..., :, None] * vh
            b_new = u * (sr[..., None, :] * sign)
            if k < r:                    # rank beyond the matrix's sides
                a_new = torch.cat([a_new, a_new.new_zeros(
                    a_new.shape[:-2] + (r - k, a_new.shape[-1]))], dim=-2)
                b_new = torch.cat([b_new, b_new.new_zeros(
                    b_new.shape[:-1] + (r - k,))], dim=-1)
            out = {"a": a_new.to(a.dtype).expand_as(a).clone(),
                   "b": b_new.to(b.dtype).expand_as(b).clone()}
            if rank_mask is not None:
                out["a"] = out["a"] * _rank_weight(rank_mask, out["a"], "a")
                out["b"] = out["b"] * _rank_weight(rank_mask, out["b"], "b")
            return out

        out = _map_ab_pairs(lora_stacked, redistribute)
        return out if aset is None else dataclasses.replace(aset, lora=out)

    def agg_leaf_flags(self, round_idx):
        # the redistribution rewrites both factors for every client
        return (True, True)


REGISTRY = {
    "fedit": FlagStrategy("fedit", True, True, True, True),
    "ffa": FlagStrategy("ffa", False, True, False, True),
    "fedsa": FlagStrategy("fedsa", True, True, True, False),
    "rolora": AlternatingStrategy("rolora"),
    "flora": StackingStrategy("flora"),
}

STRATEGIES = tuple(REGISTRY)


def get_strategy(name) -> Strategy:
    """Look up a strategy by name (a Strategy instance passes through)."""
    if isinstance(name, Strategy):
        return name
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown strategy '{name}'; options {STRATEGIES}") \
            from None


@dataclasses.dataclass(frozen=True)
class BufferedStrategy(Strategy):
    """FedBuff-style async wrapper around any registered strategy.

    The buffered engine (``core/federated.make_buffered_round_body``)
    aggregates at most ``buffer_size`` accepted uploads a round (0: no
    cap); an upload tau rounds in flight is discounted by ``(1 + tau) **
    -beta`` in the server mean.  ``screen`` rejects non-finite uploads and
    finite ones whose update norm exceeds ``screen_mult`` x the lower
    median of the round's candidates (when more than one arrived).  Every
    strategy concern (flags, the aggregate, comm accounting) is the
    ``inner`` strategy's."""
    inner: Strategy = None
    buffer_size: int = 0
    beta: float = 0.5
    screen: bool = True
    screen_mult: float = 10.0

    def __post_init__(self):
        if not isinstance(self.inner, Strategy):
            raise ValueError(
                "BufferedStrategy needs inner=<Strategy>; build one via "
                "aggregation.buffered(name, ...)")
        if self.buffer_size < 0:
            raise ValueError(
                f"buffer_size must be >= 0 (0 = no cap), got "
                f"{self.buffer_size}")

    def train_flags(self, round_idx):
        return self.inner.train_flags(round_idx)

    def agg_flags(self, round_idx):
        return self.inner.agg_flags(round_idx)

    def agg_leaf_flags(self, round_idx):
        return self.inner.agg_leaf_flags(round_idx)

    def mask_grads(self, grads, round_idx):
        return self.inner.mask_grads(grads, round_idx)

    def aggregate(self, lora_stacked, round_idx, *, weights=None,
                  rank_mask=None):
        return self.inner.aggregate(lora_stacked, round_idx,
                                    weights=weights, rank_mask=rank_mask)

    def upload_bytes(self, lora_stacked, round_idx: int = 0) -> int:
        return self.inner.upload_bytes(lora_stacked, round_idx)

    def upload_bytes_per_client(self, lora_stacked, round_idx: int = 0, *,
                                ranks):
        return self.inner.upload_bytes_per_client(lora_stacked, round_idx,
                                                  ranks=ranks)


def buffered(inner, **kwargs) -> BufferedStrategy:
    """Wrap a strategy (name or instance) for the async buffered engine."""
    inner = get_strategy(inner)
    return BufferedStrategy(name=f"buffered:{inner.name}", inner=inner,
                            **kwargs)


def strategy_flags(name: str, round_idx):
    """((train_a, train_b), (agg_a, agg_b)) of a flag-expressible
    strategy.  Raises for one whose server step is not a flag pair (flora's
    stacking): its flags fed to ``aggregate_clients`` would compute plain
    means."""
    s = get_strategy(name)
    if type(s).aggregate is not Strategy.aggregate:
        raise ValueError(
            f"strategy '{s.name}' is not flag-expressible (it overrides "
            "aggregate()); use get_strategy(name) and its "
            "mask_grads/aggregate/upload_bytes methods")
    return s.train_flags(round_idx), s.agg_flags(round_idx)
