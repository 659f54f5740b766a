"""Flat-npz pytree checkpoints, shared with the JAX package.

The port of ``repro/checkpoint/io.py``, with no jax: one ``.npz`` entry per
leaf, keyed by its path joined with ``::``; list entries are ``#i``; a
packed (quantized) base leaf is a ``__quant__`` subtree.  Files written by
either package load in the other.

:func:`load_pytree` returns numpy leaves; :func:`params_from_numpy` places
a numpy tree (a loaded checkpoint, or the JAX package's parameters and
adapters as numpy arrays) on a device as tensors.  A federated run's state
goes through :func:`save_federated_state` / :func:`load_federated_state`
under the JAX package's keys, plus ``generator_state`` (the port's
participation generator), which the JAX package ignores.
"""
from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.lora import AdapterSet, adapter_rank
from repro_torch.core.quant import QuantizedLinear
from repro_torch.core.scaling import per_client_gammas
from repro_torch.tree import tree_leaves, tree_map

_SEP = "::"
_QUANT = "__quant__"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}{_SEP}"))
    elif isinstance(tree, QuantizedLinear):
        # packed base leaf: a sentinel subtree holding data, scales and the
        # static fields, as the JAX package writes it
        enc = {"data": tree.data, "scales": tree.scales,
               "bits": np.asarray(tree.bits),
               "group_size": np.asarray(tree.group_size),
               "k": np.asarray(tree.k),
               "out_dtype": np.asarray(tree.out_dtype)}
        out.update(_flatten(enc, f"{prefix}{_QUANT}{_SEP}"))
    elif isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            raise TypeError("bfloat16 tensors have no numpy dtype; cast to "
                            "float32 before saving")
        out[prefix[:-len(_SEP)]] = t.numpy()
    else:
        out[prefix[:-len(_SEP)]] = np.asarray(tree)  # lint: disable=R4 -- numpy/python leaves; the torch port holds no JAX tracers
    return out


def save_pytree(path: str, tree) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **_flatten(tree))


def load_pytree(path: str):
    """The tree saved at ``path``, with numpy leaves (a packed base leaf
    comes back as a :class:`QuantizedLinear` over numpy arrays)."""
    with np.load(path) as data:
        tree = {}
        for key in data.files:
            parts = key.split(_SEP)
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return _unlistify(tree)


def _unlistify(node):
    if isinstance(node, dict):
        if set(node) == {_QUANT}:
            q = node[_QUANT]
            return QuantizedLinear(q["data"], q["scales"], int(q["bits"]),
                                   int(q["group_size"]), int(q["k"]),
                                   str(q["out_dtype"]))
        if node and all(k.startswith("#") for k in node):
            return [_unlistify(node[f"#{i}"]) for i in range(len(node))]
        return {k: _unlistify(v) for k, v in node.items()}
    return node


def params_from_numpy(tree, device="cuda", dtype=None):
    """A tree of arrays (anything ``np.asarray`` takes) as tensors on
    ``device``.  Floating leaves are cast to ``dtype`` when it is given;
    integer leaves keep their type; string leaves stay numpy.  A packed
    :class:`QuantizedLinear` keeps its packed data and fp32 scales."""
    device = resolve_device(device)

    def conv(leaf):
        arr = np.asarray(leaf)  # lint: disable=R4 -- concrete arrays (numpy, or JAX arrays handed over by tests); the torch port holds no JAX tracers
        if arr.dtype.kind in "SUO":
            return arr
        if arr.dtype.kind == "f" and arr.dtype.itemsize == 2 \
                and arr.dtype != np.float16:
            arr = arr.astype(np.float32)    # bfloat16 (ml_dtypes) has no torch twin
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:         # e.g. a view of a JAX array
            arr = arr.copy()
        t = torch.from_numpy(arr)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        if isinstance(node, QuantizedLinear):
            return tree_map(lambda t: (
                t if isinstance(t, torch.Tensor)
                else torch.from_numpy(np.array(t))).to(device), node)
        return conv(node)

    return walk(tree)


def save_federated_state(path: str, base, lora, opt_state, round_idx: int,
                         *, generator_state=None, data_state: str = None,
                         partition_state: str = None,
                         adapter_meta: dict = None):
    """Checkpoint one federated run under the JAX package's keys (``base``,
    ``lora``, ``opt``, ``round``, ``data_state``, ``partition_state``,
    ``adapter_meta``), so ``repro.checkpoint.io.load_federated_state`` reads
    the file.

    ``generator_state`` (``torch.Generator.get_state()`` of the trainer's
    participation generator) and ``data_state`` (the host dataset's
    serialized RNG streams) make a restored run continue bit for bit.  The
    JAX package keeps a ``prng_key`` in its place, whose ``jax.random``
    stream the port cannot continue (:meth:`FederatedTrainer.restore`)."""
    # leaves that are not tensors (the round, the state strings, the
    # metadata) become numpy arrays in _flatten, as the JAX package stores
    # them
    tree = {"base": base, "lora": lora, "opt": opt_state, "round": round_idx,
            "generator_state": generator_state, "data_state": data_state,
            "partition_state": partition_state, "adapter_meta": adapter_meta}
    tree = {k: v for k, v in tree.items() if v is not None}
    save_pytree(path, tree)


def load_federated_state(path: str):
    """(base, lora, opt, round, state) of a file written by either package:
    numpy trees, the round as an int, and ``state`` a dict of what a resumed
    run reads, where the file has it: "generator_state" (the port's
    participation generator), "prng_key" (the JAX trainer's key data),
    "rank_mask", and the dataset's "data_state" and "partition_state" as
    strings."""
    t = load_pytree(path)
    state = {k: np.asarray(t[k])
             for k in ("generator_state", "prng_key", "rank_mask") if k in t}
    for key in ("data_state", "partition_state"):
        if key in t:
            state[key] = str(np.asarray(t[key]))
    return t["base"], t["lora"], t.get("opt", {}), int(t["round"]), state


def load_adapter_state(path: str, *, lora_cfg=None, n_clients: int = None,
                       device="cuda", dtype=None):
    """``(base_params, stacked AdapterSet)`` from a federated checkpoint
    written by the JAX trainer (``repro/checkpoint/io.py:
    save_federated_state``): the serving entry point, with no trainer
    state.

    Checkpoints with ``adapter_meta`` rebuild the trained AdapterSet
    exactly (per-client gammas, rank mask, rank/alpha).  Older ones are
    upgraded from ``lora_cfg`` (+ ``n_clients``, default: the checkpoint's
    client dim): gamma = scaling(alpha, rank, N), as the JAX package does."""
    t = load_pytree(path)
    base = params_from_numpy(t["base"], device, dtype)
    lora = params_from_numpy(t["lora"], device, dtype)
    mask = t.get("rank_mask")
    meta = t.get("adapter_meta")
    n = tree_leaves(lora)[0].shape[0]
    r_pad = adapter_rank(lora)
    if meta is not None:
        gammas = tuple(float(g) for g in np.asarray(meta["gammas"]).reshape(-1))
        if len(gammas) == 1:
            gammas = gammas * n
        return base, AdapterSet(lora=lora, gamma=gammas, rank_mask=mask,
                                rank=int(meta["rank"]),
                                alpha=float(meta["alpha"]))
    if lora_cfg is None:
        raise ValueError(
            f"checkpoint '{path}' predates adapter_meta — pass lora_cfg "
            "(rank/alpha/scaling) to upgrade it to an AdapterSet")
    warnings.warn(
        f"legacy checkpoint '{path}': no adapter_meta; rebuilding gammas "
        f"from lora_cfg ({lora_cfg.scaling}, alpha={lora_cfg.alpha})",
        stacklevel=2)
    ranks = (tuple(int(r) for r in np.asarray(mask).sum(axis=-1))
             if mask is not None else (r_pad,) * n)
    gammas = per_client_gammas(lora_cfg.scaling, lora_cfg.alpha, ranks,
                               n_clients or n)
    return base, AdapterSet(lora=lora, gamma=gammas, rank_mask=mask,
                            rank=r_pad, alpha=lora_cfg.alpha)


def publish_adapter_state(path: str, live, *, lora_cfg=None, clients=None):
    """Stream a federated checkpoint's adapters into a live serving bank
    (:class:`~repro_torch.core.lora.LiveAdapterBank`): every client in the
    checkpoint (or just ``clients``) is published under its client index as
    the tenant id; resident tenants swap on the device, the rest update the
    host store.  Returns ``(base_params, n_published)`` so the caller can
    check the base still matches what it serves."""
    base, aset = load_adapter_state(path, lora_cfg=lora_cfg,
                                    device=live.bank.device)
    n_clients = tree_leaves(aset.lora)[0].shape[0]
    clients = range(n_clients) if clients is None else clients
    n = 0
    for c in clients:
        live.publish(int(c), aset.client(int(c)))
        n += 1
    return base, n
