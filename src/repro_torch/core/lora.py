"""LoRA parameter trees and the adapter API for serving and training.

The port of ``repro/core/lora.py``.  A LoRA tree has the same
``{"stack": {"repeat": {"p0": ...}, "tail": ...}}`` shape as the base
params, but each targeted projection leaf ``w (d_in, d_out)`` becomes
``{"a": (r, d_in), "b": (d_out, r)}`` (with the leading layer dim of the
repeated blocks, and a leading client or tenant dim where stacked).

:class:`AdapterSet` carries the A/B tree with its scaling factor gamma, an
optional rank mask and rank/alpha metadata; :meth:`AdapterSet.fold_gamma`
is the one place gamma meets the weights.  :class:`AdapterBank` stacks K
prepared sets for multi-tenant serving, and :class:`LiveAdapterBank` keeps a
device-resident hot set of bank slots over a host-memory tenant store.

Config values (gamma, rank masks) stay host numpy / python values, as in
the JAX package; they become tensors only where they multiply a leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.analysis.hostcheck import check_adapter_ids
from repro_torch.core.quant import QuantizedLinear, dequantize
from repro_torch.tree import tree_leaves, tree_map

# which leaves inside each block subtree are adaptable, per target name
_TARGET_LEAVES = {
    "q": ("attn/q", "cross/q", "mlstm/q"),
    "k": ("attn/k", "cross/k", "mlstm/k"),
    "v": ("attn/v", "cross/v", "mlstm/v"),
    "o": ("attn/o", "cross/o", "mlstm/o"),
    "wx": ("rglru/wx",),
    "wy": ("rglru/wy",),
}


def _targeted_paths(targets):
    out = set()
    for t in targets:
        out.update(_TARGET_LEAVES.get(t, ()))
    return out


def init_lora(params, generator: torch.Generator, lora_cfg, *, targets=None):
    """A LoRA tree for every targeted projection found in ``params``:
    A ~ N(0, init_std^2) drawn from ``generator``, B = 0.  Leading stack
    dims are kept, so repeated blocks get stacked adapters.  Leaves land on
    the device and in the dtype of the weight they adapt."""
    targets = _targeted_paths(targets or lora_cfg.targets)
    r = lora_cfg.rank
    std = lora_cfg.init_std

    def walk(node, path):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                sub = walk(v, path + (k,))
                if sub is not None:
                    out[k] = sub
            return out or None
        if "/".join(path[-2:]) not in targets:
            return None
        lead = tuple(node.shape[:-2])          # stacked layer dims
        d_in, d_out = node.shape[-2:]
        a = torch.randn(lead + (r, d_in), generator=generator,
                        device=generator.device, dtype=torch.float32) * std
        b = torch.zeros(lead + (d_out, r), dtype=node.dtype,
                        device=node.device)
        return {"a": a.to(device=node.device, dtype=node.dtype), "b": b}

    return walk(params, ()) or {}


def lora_tree_for_model(model, generator: torch.Generator, lora_cfg, *,
                        device="cuda"):
    """LoRA tree from the model config alone, without drawing base weights
    (the JAX package does this with ``eval_shape``): the targeted
    projections of every block (attention, cross-attention and mLSTM
    q/k/v/o, RG-LRU wx/wy; the sLSTM has none) and of the audio encoder's
    blocks, as zero-stride stand-ins that carry only shape, dtype and
    device."""
    from repro_torch import resolve_device
    from repro_torch.models.transformer import stack_layout
    cfg = model.cfg
    dt = getattr(torch, cfg.param_dtype)
    zero = torch.zeros((), dtype=dt, device=resolve_device(device))
    d, dr = cfg.d_model, cfg.rglru_d_state or cfg.d_model
    attn = {"q": (d, cfg.q_dim), "k": (d, cfg.kv_dim), "v": (d, cfg.kv_dim),
            "o": (cfg.q_dim, d)}
    proj = {"attn": {"attn": attn},
            "xattn": {"attn": attn, "cross": attn},
            "rglru": {"rglru": {"wx": (d, dr), "wy": (d, dr)}},
            "mlstm": {"mlstm": {"q": (d, cfg.q_dim), "k": (d, cfg.q_dim),
                                "v": (d, cfg.q_dim), "o": (cfg.q_dim, d)}},
            "slstm": {"slstm": {}}}

    def block(kind, lead):
        return {sub: {k: zero.expand(lead + s) for k, s in leaves.items()}
                for sub, leaves in proj[kind].items()}

    def stack(num_layers, pattern):
        repeats, tail = stack_layout(num_layers, pattern)
        return {"repeat": {f"p{j}": block(kind, (repeats,))
                           for j, kind in enumerate(pattern) if repeats},
                "tail": {f"t{i}": block(kind, ())
                         for i, kind in enumerate(tail)}}

    tree = {"stack": stack(cfg.num_layers, cfg.block_pattern)}
    if cfg.family == "audio":
        tree["encoder"] = {"stack": stack(cfg.encoder_layers, ("attn",))}
    return init_lora(tree, generator, lora_cfg)


def merge_lora(params, lora, gamma):
    """W0 + gamma * B A merged into the base weights (a new tree; the
    inputs are not modified)."""
    def merge_node(p_node, l_node):
        if not isinstance(l_node, dict):
            return p_node
        if set(l_node) == {"a", "b"}:
            delta = torch.einsum("...or,...ri->...io", l_node["b"],
                                 l_node["a"]) * gamma
            if isinstance(p_node, QuantizedLinear):
                # W0 + gamma B A is not on W0's quantization grid: the
                # merged weight leaves packed form (requantize_merged
                # packs it again)
                p_node = dequantize(p_node)
            return p_node + delta.to(p_node.dtype)
        if isinstance(p_node, dict):
            return {k: merge_node(v, l_node.get(k)) for k, v in p_node.items()}
        return p_node

    return merge_node(params, lora)


def num_lora_params(lora) -> int:
    return sum(x.numel() for x in tree_leaves(lora))


def split_ab(lora):
    """Split a LoRA tree into (A-only tree, B-only tree) with the same
    structure.  Nodes holding only one of the two matrices yield an empty
    dict on the missing side."""
    def pick(node, which):
        if isinstance(node, dict):
            if node and set(node) <= {"a", "b"}:
                return {which: node[which]} if which in node else {}
            return {k: pick(v, which) for k, v in node.items()}
        return node

    return pick(lora, "a"), pick(lora, "b")


# ------------------------------------------------------- heterogeneous ranks

def rank_mask(ranks, r_max: int = 0) -> np.ndarray:
    """(N, r_max) float32 mask: row i is r_i ones then r_max - r_i zeros."""
    ranks = tuple(int(r) for r in ranks)
    if not ranks or any(r < 1 for r in ranks):
        raise ValueError(f"per-client ranks must all be >= 1, got {ranks}")
    r_max = r_max or max(ranks)
    if max(ranks) > r_max:
        raise ValueError(f"rank {max(ranks)} exceeds padded r_max={r_max}")
    return (np.arange(r_max)[None, :]
            < np.asarray(ranks)[:, None]).astype(np.float32)  # lint: disable=R4 -- a tuple of python ints; the torch port holds no JAX tracers


def _walk_ab(tree, fn_a, fn_b):
    """Apply fn_a / fn_b to the a / b leaves of every adapter node; other
    entries of a node (a lazy bank's ``ids``) pass through."""
    def walk(node):
        if isinstance(node, dict):
            if node and set(node) <= {"a", "b", "ids"} and (
                    "a" in node or "b" in node):
                out = dict(node)
                if "a" in node:
                    out["a"] = fn_a(node["a"])
                if "b" in node:
                    out["b"] = fn_b(node["b"])
                return out
            return {k: walk(v) for k, v in node.items()}
        return node
    return walk(tree)


def _like(x: torch.Tensor, values) -> torch.Tensor:
    return torch.as_tensor(values, dtype=x.dtype, device=x.device)


def rank_leaf_mask(mask, x, which: str) -> torch.Tensor:
    """A (N, r) rank mask (numpy or a tensor) broadcast against a
    client-stacked adapter leaf ``x``, in its dtype and on its device: the
    rank dim is axis -2 of an "a" leaf ((N, ..., r, d_in)) and axis -1 of a
    "b" leaf ((N, ..., d_out, r))."""
    n, r = mask.shape
    if which == "a":
        shape = (n,) + (1,) * (x.ndim - 3) + (r, 1)
    else:
        shape = (n,) + (1,) * (x.ndim - 2) + (r,)
    return _like(x, mask.reshape(shape))


def apply_rank_mask(lora_stacked, mask):
    """Zero the inactive rank rows of A / columns of B per client: leaves
    carry a leading client dim (a (N, ..., r, d_in), b (N, ..., d_out, r));
    ``mask`` is (N, r), numpy or a tensor."""
    return _walk_ab(lora_stacked,
                    lambda x: x * rank_leaf_mask(mask, x, "a"),
                    lambda x: x * rank_leaf_mask(mask, x, "b"))


def mask_rank_tree(lora, mask_row):
    """Single-client :func:`apply_rank_mask`: ``mask_row`` (r,), numpy or
    a tensor."""
    return _walk_ab(lora, lambda x: x * _like(x, mask_row[:, None]),
                    lambda x: x * _like(x, mask_row))


def scale_lora_b(lora, scale: float):
    """Every B matrix times ``scale``."""
    return _walk_ab(lora, lambda a: a, lambda b: b * scale)


def adapter_rank(lora) -> int:
    """The (padded) rank of a LoRA tree, read off the first A leaf."""
    for leaf in tree_leaves(lora):
        return int(leaf.shape[-2])   # a: (..., r, d_in) comes first ("a"<"b")
    return 0


def pad_rank_tree(lora, r_max: int):
    """Zero-pad every adapter to rank ``r_max`` (rows of A, columns of B).
    Zero rank rows/columns add nothing to x A^T B^T, so padding is exact."""
    def pad(x, axis):
        extra = r_max - x.shape[axis]
        if extra < 0:
            raise ValueError(
                f"adapter rank {x.shape[axis]} exceeds r_max={r_max}")
        if extra == 0:
            return x
        shape = list(x.shape)
        shape[axis] = extra
        return torch.cat([x, x.new_zeros(shape)], dim=axis)
    return _walk_ab(lora, lambda a: pad(a, a.ndim - 2),
                    lambda b: pad(b, b.ndim - 1))


# ----------------------------------------------------------- adapter API

@dataclasses.dataclass(frozen=True)
class AdapterSet:
    """A/B tree + scaling factor + rank mask + metadata as one value.

    ``gamma`` is a python float, or a (N,) float32 numpy array of
    per-client/per-tenant factors on a stacked tree.  ``rank_mask`` is
    ``(r,)`` for one client, ``(N, r)`` for a stacked tree, or ``None``
    when every rank row is active.  ``batched`` marks a per-request set
    from an :class:`AdapterBank`: either every leaf has a leading request
    dim (``gather``) or the leaves stay bank-stacked ``(K, ...)`` and
    ``ids`` (B,) maps batch rows to tenants (``requests``, the lazy form
    whose gather happens in the BGMV kernel)."""
    lora: Any
    gamma: Any = 1.0
    rank_mask: Any = None
    rank: int = 0
    alpha: float = 0.0
    batched: bool = False
    ids: Any = None          # (B,) int32 request->tenant map (lazy bank)

    def __post_init__(self):
        g = self.gamma
        if isinstance(g, (tuple, list)):
            gs = [float(x) for x in g]
            # uniform gammas collapse to one float, as in the JAX package
            g = gs[0] if all(x == gs[0] for x in gs) \
                else np.asarray(gs, np.float32)
        elif isinstance(g, (torch.Tensor, np.ndarray)):
            g = np.asarray(g.detach().cpu() if isinstance(g, torch.Tensor)
                           else g, np.float32)
            if g.ndim == 0:
                g = float(g)
        else:
            g = float(g)
        object.__setattr__(self, "gamma", g)
        m = self.rank_mask
        if isinstance(m, torch.Tensor):
            m = m.detach().cpu().numpy()
        if m is not None:
            m = np.asarray(m, np.float32)
            # an all-ones mask masks nothing: canonicalize it to None
            m = None if m.all() else m
        object.__setattr__(self, "rank_mask", m)

    @classmethod
    def from_config(cls, lora_cfg, *, n_clients: int = 1, lora=None,
                    rank_mask=None) -> "AdapterSet":
        """AdapterSet for a :class:`LoRAConfig`; gamma =
        scaling(alpha, r, N) is derived here."""
        from repro_torch.core.scaling import scaling_factor
        gamma = scaling_factor(lora_cfg.scaling, lora_cfg.alpha,
                               lora_cfg.rank, n_clients)
        return cls(lora=lora, gamma=gamma, rank_mask=rank_mask,
                   rank=lora_cfg.rank, alpha=lora_cfg.alpha)

    @classmethod
    def stack(cls, sets) -> "AdapterSet":
        """Stack K same-rank sets along a new leading dim (clients or
        tenants).  Uniform gammas stay one float; mixed gammas become a
        (K,) array.  Mixed ranks must be padded first
        (:meth:`AdapterBank.from_sets` does that)."""
        sets = list(sets)
        if not sets:
            raise ValueError("AdapterSet.stack needs at least one set")
        ranks = {adapter_rank(s.lora) for s in sets}
        if len(ranks) > 1:
            raise ValueError(
                f"AdapterSet.stack needs uniform ranks, got {sorted(ranks)}; "
                "pad first (AdapterBank.from_sets does this)")
        r = ranks.pop()
        lora = tree_map(lambda *xs: torch.stack(xs), *[s.lora for s in sets])
        mask = None
        if any(s.rank_mask is not None for s in sets):
            mask = np.stack([np.ones((r,), np.float32) if s.rank_mask is None
                             else s.rank_mask for s in sets])
        return cls(lora=lora, gamma=tuple(float(s.gamma) for s in sets),
                   rank_mask=mask, rank=r, alpha=sets[0].alpha)

    def unstack(self):
        """The inverse of :meth:`stack`: K single-client sets."""
        n = tree_leaves(self.lora)[0].shape[0]
        return [self.client(i) for i in range(n)]

    def client(self, i: int) -> "AdapterSet":
        """Client ``i``'s slice of a client-stacked set (its own gamma_i and
        rank-mask row included)."""
        g = self.gamma
        if not isinstance(g, float):
            g = float(g[i])
        m = None if self.rank_mask is None else self.rank_mask[i]
        return dataclasses.replace(
            self, lora=tree_map(lambda x: x[i], self.lora), gamma=g,
            rank_mask=m, batched=False)

    def num_params(self) -> int:
        return num_lora_params(self.lora)

    def masked(self) -> "AdapterSet":
        """Zero the inactive rank rows of A / columns of B per the mask."""
        if self.rank_mask is None:
            return self
        m = self.rank_mask
        lora = (mask_rank_tree(self.lora, m) if m.ndim == 1
                else apply_rank_mask(self.lora, m))
        return dataclasses.replace(self, lora=lora)

    def fold_gamma(self) -> "AdapterSet":
        """Fold gamma into B: y = xW + (x A^T)(gamma B)^T.  The one place
        gamma is folded; the result carries ``gamma=1.0``."""
        g = self.gamma
        if isinstance(g, float):
            if g == 1.0:
                return self
            lora = scale_lora_b(self.lora, g)
        else:
            lora = _walk_ab(self.lora, lambda a: a, lambda x: x * _like(
                x, g.reshape(g.shape + (1,) * (x.ndim - 1))))
        return dataclasses.replace(self, lora=lora, gamma=1.0)

    def prepared(self) -> "AdapterSet":
        """Mask + fold: the form the model stack consumes."""
        return self.masked().fold_gamma()

    def merge(self, params):
        """W0 + gamma * B A merged into the base weights."""
        return merge_lora(params, self.prepared().lora, 1.0)


def init_adapter_set(params, generator: torch.Generator, lora_cfg, *,
                     n_clients: int = 1, targets=None) -> AdapterSet:
    """Fresh AdapterSet for ``params`` with the scheme's scaling factor."""
    return AdapterSet.from_config(
        lora_cfg, n_clients=n_clients,
        lora=init_lora(params, generator, lora_cfg, targets=targets))


def as_adapter_set(adapters):
    """None stays None; a raw (prepared) A/B dict is wrapped with scale 1."""
    if adapters is None or isinstance(adapters, AdapterSet):
        return adapters
    return AdapterSet(lora=adapters)


@dataclasses.dataclass(frozen=True)
class AdapterBank:
    """K prepared adapter sets stacked for multi-tenant serving.

    Registration folds each tenant's gamma into its B and zero-pads mixed
    ranks to ``r_max`` under a (K, r_max) rank mask, so the bank is one
    uniform stacked tree.  ``version`` counts :meth:`publish` calls."""
    lora: Any                                 # leaves (K,) + leaf shape
    rank_mask: Any = None                     # (K, r_max) numpy or None
    ranks: Tuple[int, ...] = ()               # per-tenant active ranks
    version: int = 0

    @property
    def size(self) -> int:
        return tree_leaves(self.lora)[0].shape[0]

    @property
    def r_max(self) -> int:
        return adapter_rank(self.lora)

    @property
    def device(self) -> torch.device:
        return tree_leaves(self.lora)[0].device

    @classmethod
    def from_sets(cls, sets) -> "AdapterBank":
        """Register K AdapterSets (possibly mixed-rank) as one bank."""
        sets = [s.prepared() for s in sets]
        ranks = tuple(adapter_rank(s.lora) for s in sets)
        r_max = max(ranks)
        padded = [pad_rank_tree(s.lora, r_max) for s in sets]
        lora = tree_map(lambda *xs: torch.stack(xs), *padded)
        return cls(lora=lora, rank_mask=rank_mask(ranks, r_max), ranks=ranks)

    @classmethod
    def from_adapter_set(cls, stacked: AdapterSet,
                         ranks=None) -> "AdapterBank":
        """Register a client-stacked AdapterSet (a restored federated
        checkpoint: every client becomes a tenant)."""
        prepared = stacked.prepared()
        n = tree_leaves(prepared.lora)[0].shape[0]
        r_pad = adapter_rank(prepared.lora)
        if ranks is None:
            if stacked.rank_mask is not None:
                ranks = tuple(int(r) for r in stacked.rank_mask.sum(axis=-1))
            else:
                ranks = (r_pad,) * n
        return cls(lora=prepared.lora, rank_mask=rank_mask(ranks, r_pad),
                   ranks=tuple(int(r) for r in ranks))

    def publish(self, slot: int, aset: AdapterSet, *,
                donate: bool = True) -> "AdapterBank":
        """Replace tenant ``slot`` with ``aset``: the versioned bank update
        that lets federated rounds re-publish adapters while serving
        continues.

        The new set is prepared (rank-masked, gamma folded into B) and
        zero-padded to the bank's ``r_max``, so the stacked leaves keep
        exactly their shapes and dtypes; a set whose rank exceeds ``r_max``
        is rejected rather than reshaping the bank.  ``aset``'s leaves may
        be tensors on any device or numpy arrays.

        With ``donate=True`` (the default) the slot is copied in place into
        this bank's leaves (the JAX package donates them): the returned
        bank shares them and replaces ``self``.  ``donate=False`` copies
        the leaves first and leaves this bank as it was."""
        if not 0 <= int(slot) < self.size:
            raise ValueError(f"slot {slot} out of range for a bank of "
                             f"{self.size} tenants")
        slot = int(slot)
        dev = self.device
        aset = dataclasses.replace(aset, lora=tree_map(
            lambda x: torch.as_tensor(x, device=dev), aset.lora))
        prepared = aset.prepared()
        r = adapter_rank(prepared.lora)
        r_max = self.r_max
        if r > r_max:
            raise ValueError(
                f"published rank {r} exceeds the bank's r_max={r_max}: slot "
                "shapes are padded-stable; rebuild the bank "
                "(AdapterBank.from_sets) to grow the rank ceiling")
        padded = pad_rank_tree(prepared.lora, r_max)
        if _paths(padded) != _paths(self.lora):
            raise ValueError(
                "published adapter tree structure does not match the "
                f"bank's: {_paths(padded)} vs {_paths(self.lora)}")
        for bl, nl in zip(tree_leaves(self.lora), tree_leaves(padded)):
            if tuple(bl.shape[1:]) != tuple(nl.shape):
                raise ValueError(
                    f"published adapter leaf shape {tuple(nl.shape)} does "
                    f"not match the bank slot shape {tuple(bl.shape[1:])}")
        lora = self.lora if donate else tree_map(torch.clone, self.lora)

        def put(bank_leaf, new):
            bank_leaf[slot].copy_(new)
            return bank_leaf
        lora = tree_map(put, lora, padded)
        ranks = list(self.ranks or (r_max,) * self.size)
        ranks[slot] = r
        return AdapterBank(lora=lora, rank_mask=rank_mask(tuple(ranks), r_max),
                           ranks=tuple(ranks), version=self.version + 1)

    def _ids(self, ids, what: str) -> torch.Tensor:
        check_adapter_ids(ids, self.size, what=what)
        return torch.as_tensor(ids, dtype=torch.int32, device=self.device)

    def gather(self, ids) -> AdapterSet:
        """Per-request adapters, materialized: every leaf gets a leading
        request dim.  Gamma is already folded, so the set has scale 1."""
        idx = self._ids(ids, "gather id").long()
        lora = tree_map(lambda x: x.index_select(0, idx), self.lora)
        return AdapterSet(lora=lora, gamma=1.0, rank=adapter_rank(lora),
                          batched=True)

    def requests(self, ids) -> AdapterSet:
        """Per-request adapters, lazy: the bank leaves stay ``(K, ...)`` and
        ``ids`` rides along, so each projection gathers its own rows (in
        the BGMV kernel on the card)."""
        return AdapterSet(lora=self.lora, gamma=1.0,
                          rank=adapter_rank(self.lora), batched=True,
                          ids=self._ids(ids, "request id"))

    def adapter(self, k: int) -> AdapterSet:
        """Tenant ``k`` as a plain single AdapterSet."""
        mask = None if self.rank_mask is None else self.rank_mask[k]
        return AdapterSet(lora=tree_map(lambda x: x[k], self.lora),
                          gamma=1.0, rank_mask=mask,
                          rank=int(self.ranks[k]) if self.ranks else 0)


def _paths(tree, prefix=()):
    """The sorted key paths of a nested dict's leaves."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


class LiveAdapterBank:
    """An adapter bank larger than the device holds: a device-resident hot
    set of ``hot_slots`` bank slots over a host-memory tenant store.

    The port of ``repro/core/lora.py:LiveAdapterBank``.  The store holds
    every tenant prepared (gamma folded, rank-masked) and zero-padded to
    ``r_max`` as CPU tensors, so a promotion is a pure copy into a slot of
    the device :class:`AdapterBank` (an in-place :meth:`AdapterBank.publish`).
    A request for a non-resident tenant promotes it into a free or the
    least-recently-used unpinned slot; the evictee's demotion is free,
    because the store is always authoritative (:meth:`publish` writes the
    store first, then swaps the device slot if the tenant is resident).

    Recency is driven by the tenant ids flowing through
    ``launch/serve.serve_scheduled`` (:meth:`acquire` at admission,
    :meth:`touch` at every decode chunk); slots gathered by running
    requests are pinned.  ``promotions``, ``demotions`` and ``swaps`` (in
    place publishes of resident tenants) count lifecycle events."""

    def __init__(self, *, bank: AdapterBank, store: dict, slot_tenant):
        self.bank = bank
        self.store = store                    # tenant -> {lora, rank, version}
        self.slot_tenant = [int(t) for t in slot_tenant]
        if len(self.slot_tenant) != bank.size:
            raise ValueError("slot_tenant must name every device slot")
        self.tenant_slot = {t: s for s, t in enumerate(self.slot_tenant)
                            if t >= 0}
        self._tick = 0
        self._last_used = [0] * len(self.slot_tenant)
        self.version = 0                      # global publish counter
        self.promotions = 0
        self.demotions = 0
        self.swaps = 0

    @property
    def hot_slots(self) -> int:
        return len(self.slot_tenant)

    @property
    def r_max(self) -> int:
        return self.bank.r_max

    @property
    def tenants(self):
        return sorted(self.store)

    def has(self, tenant) -> bool:
        return int(tenant) in self.store

    def resident(self, tenant) -> bool:
        return int(tenant) in self.tenant_slot

    def tenant_version(self, tenant) -> int:
        return self.store[int(tenant)]["version"]

    @staticmethod
    def _host(tree):
        return tree_map(lambda x: torch.as_tensor(x).detach().to(
            "cpu", copy=True), tree)

    @classmethod
    def from_sets(cls, sets, *, hot_slots: int, r_max: int = 0,
                  device="cuda") -> "LiveAdapterBank":
        """Register tenants 0..len(sets)-1; the first ``hot_slots`` start
        resident on ``device``.  ``r_max`` (default: the largest rank seen)
        is the bank's permanent rank ceiling."""
        sets = list(sets)
        if not sets:
            raise ValueError("LiveAdapterBank needs at least one tenant")
        prepared = [s.prepared() for s in sets]
        ranks = [adapter_rank(p.lora) for p in prepared]
        r_max = int(r_max) or max(ranks)
        if max(ranks) > r_max:
            raise ValueError(f"rank {max(ranks)} exceeds r_max={r_max}")
        store = {t: {"lora": cls._host(pad_rank_tree(p.lora, r_max)),
                     "rank": r, "version": 0}
                 for t, (p, r) in enumerate(zip(prepared, ranks))}
        return cls._build(store, hot_slots=hot_slots, r_max=r_max,
                          device=device)

    @classmethod
    def from_bank(cls, bank: AdapterBank, *,
                  hot_slots: int) -> "LiveAdapterBank":
        """Wrap a static AdapterBank: every bank row becomes a store tenant
        (row index = tenant id) and the first ``hot_slots`` start resident
        on the bank's device (``--hot-slots`` on the serve CLI)."""
        host = cls._host(bank.lora)
        ranks = bank.ranks or (bank.r_max,) * bank.size
        store = {t: {"lora": tree_map(lambda x, t=t: x[t], host),
                     "rank": int(ranks[t]), "version": 0}
                 for t in range(bank.size)}
        return cls._build(store, hot_slots=hot_slots, r_max=bank.r_max,
                          device=bank.device)

    @classmethod
    def _build(cls, store, *, hot_slots: int, r_max: int,
               device) -> "LiveAdapterBank":
        if hot_slots < 1:
            raise ValueError(f"need >= 1 hot slot, got {hot_slots}")
        tenants = sorted(store)
        resident = tenants[:hot_slots]
        template = store[tenants[0]]["lora"]
        rows, slot_tenant, slot_ranks = [], [], []
        for s in range(hot_slots):
            if s < len(resident):
                t = resident[s]
                rows.append(store[t]["lora"])
                slot_tenant.append(t)
                slot_ranks.append(store[t]["rank"])
            else:                      # spare slot: zeros (inert by padding)
                rows.append(tree_map(torch.zeros_like, template))
                slot_tenant.append(-1)
                slot_ranks.append(r_max)
        lora = tree_map(lambda *xs: torch.stack(xs).to(device), *rows)
        bank = AdapterBank(lora=lora,
                           rank_mask=rank_mask(tuple(slot_ranks), r_max),
                           ranks=tuple(slot_ranks))
        return cls(bank=bank, store=store, slot_tenant=slot_tenant)

    def publish(self, tenant, aset: AdapterSet) -> int:
        """Publish a new adapter version for ``tenant`` (a new tenant
        registers on its first publish).  The host store is updated first;
        a RESIDENT tenant's device slot is then swapped in place
        (:meth:`AdapterBank.publish`): decode chunks already run finished
        on the old adapters, the next chunk serves the new version.
        Returns the tenant's new version number."""
        tenant = int(tenant)
        prepared = dataclasses.replace(
            aset, lora=self._host(aset.lora)).prepared()
        r = adapter_rank(prepared.lora)
        if r > self.r_max:
            raise ValueError(
                f"tenant {tenant}: published rank {r} exceeds the bank's "
                f"r_max={self.r_max}; shapes are padded-stable, rebuild the "
                "live bank to grow the rank ceiling")
        padded = self._host(pad_rank_tree(prepared.lora, self.r_max))
        ver = (self.store[tenant]["version"] + 1 if tenant in self.store
               else 0)
        self.store[tenant] = {"lora": padded, "rank": r, "version": ver}
        self.version += 1
        s = self.tenant_slot.get(tenant)
        if s is not None:
            self.bank = self.bank.publish(s, AdapterSet(lora=padded))
            self.swaps += 1
        return ver

    def touch(self, tenants) -> None:
        """Advance the LRU clock for every resident tenant in ``tenants``
        (the ids observed at each admission and decode chunk)."""
        self._tick += 1
        for t in tenants:
            s = self.tenant_slot.get(int(t))
            if s is not None:
                self._last_used[s] = self._tick

    def acquire(self, tenants, pinned=()):
        """Device slots for ``tenants``, promoting non-resident ones from
        the store into free or least-recently-used slots; ``pinned`` slots
        (gathered by still-running requests) are never evicted.  Returns
        {tenant: slot}, or None when the distinct tenants cannot all be
        made resident without evicting a pinned slot (the caller defers
        admission to a later boundary)."""
        want = list(dict.fromkeys(int(t) for t in tenants))
        for t in want:
            if t not in self.store:
                raise KeyError(f"unknown tenant {t}: store holds "
                               f"{self.tenants}")
        keep = {int(p) for p in pinned}
        keep |= {self.tenant_slot[t] for t in want if t in self.tenant_slot}
        missing = [t for t in want if t not in self.tenant_slot]
        free = [s for s in range(self.hot_slots)
                if self.slot_tenant[s] < 0 and s not in keep]
        victims = sorted((s for s in range(self.hot_slots)
                          if self.slot_tenant[s] >= 0 and s not in keep),
                         key=lambda s: self._last_used[s])
        if len(missing) > len(free) + len(victims):
            return None
        for t in missing:
            s = free.pop(0) if free else victims.pop(0)
            self._promote(t, s)
        self.touch(want)
        return {t: self.tenant_slot[t] for t in want}

    def _promote(self, tenant: int, slot: int) -> None:
        old = self.slot_tenant[slot]
        if old >= 0:
            # demotion is free: the store already holds the evictee
            del self.tenant_slot[old]
            self.demotions += 1
        rec = self.store[tenant]
        self.bank = self.bank.publish(slot, AdapterSet(lora=rec["lora"]))
        self.slot_tenant[slot] = tenant
        self.tenant_slot[tenant] = slot
        self.promotions += 1
