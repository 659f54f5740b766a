"""Partition rules for every tree of the system: the port of
``repro/sharding/rules.py``, rule for rule.

Policy:
  - base params: tensor-parallel over "model" (out-features of
    up-projections, in-features of down-projections, vocab dim of the
    embedding, expert dim of MoE stacks); stacked layer dims replicated.
  - LoRA: A replicated (the aggregated client-shared object), B
    model-sharded on d_out; leading client dim over ("pod", "data").
  - batch dims over ("pod", "data"); decode caches: batch if divisible,
    else the cache sequence dim; kv-heads over "model" when divisible.

A spec is a tuple with one entry per tensor dim: an axis name, a tuple of
names (pod-major) or None -- what JAX's ``PartitionSpec`` holds.  The rules
read only the mesh's axis names and sizes (a DeviceMesh or a
:class:`~repro_torch.launch.mesh.MeshShape`), check divisibility and
degrade to replication, so the same code serves the 16x16 pod, the
2x16x16 multi-pod and one device.  :func:`placements` turns a spec into
DTensor placements on a mesh.
"""
from __future__ import annotations

import dataclasses
import math

from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch.mesh import axis_names, axis_sizes
from repro_torch.sharding import opts


def _names(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _div(size, mesh, axes) -> bool:
    if axes is None:
        return True
    sizes = axis_sizes(mesh)
    prod = 1
    for n in _names(axes):
        if n not in sizes:
            return False
        prod *= sizes[n]
    return size % prod == 0 and prod > 1


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def _axis(ba):
    """A tuple of client axes as a spec entry: one name alone."""
    return ba if len(ba) > 1 else ba[0]


# ------------------------------------------------------------------ params

# leaf name -> which trailing dim gets "model"
_COL = {"q": -1, "k": -1, "v": -1, "w_gate": -1, "w_up": -1,
        "shared_gate": -1, "shared_up": -1, "wx": -1, "wy": -1, "w_z": -1,
        "w_i": -1, "w_f": -1, "w_o": -1, "ogate": -1, "w_a": -1,
        "lm_head": -1, "patch_proj": -1, "w_proj": -1}
_ROW = {"o": -2, "w_down": -2, "shared_down": -2, "w_out": -2, "embed": -2}


def param_spec(path_keys, shape, mesh) -> tuple:
    """path_keys: the tree's keys from the root to the leaf."""
    leaf = path_keys[-1]
    parent = path_keys[-2] if len(path_keys) > 1 else ""
    nd = len(shape)
    spec = [None] * nd
    if leaf == "embed" and opts.enabled("embed_dshard"):
        if _div(shape[-1], mesh, "model"):
            spec[-1] = "model"
        return tuple(spec)

    def set_model(dim):
        d = dim % nd
        if _div(shape[d], mesh, "model"):
            spec[d] = "model"

    if parent == "moe" and nd >= 3 and leaf in ("w_gate", "w_up", "w_down"):
        set_model(-3)                      # expert-parallel stacks
    elif parent == "moe" and len(path_keys) > 2 and nd >= 4:
        set_model(-3)
    elif leaf in _COL and not (parent == "moe" and leaf in ("w_gate", "w_up")):
        set_model(_COL[leaf])
    elif leaf in _ROW:
        set_model(_ROW[leaf])
    elif leaf == "r_z" or leaf.startswith("r_") and nd == 3:
        set_model(-1)
    # MoE stacked under repeat: (L, E, d, ff) shards the expert dim
    if parent == "moe" and leaf in ("w_gate", "w_up", "w_down") and nd == 4:
        spec = [None] * nd
        if _div(shape[1], mesh, "model"):
            spec[1] = "model"
    return tuple(spec)


def tree_specs(tree, mesh, spec_fn):
    """Map a path-aware spec function over a tree -> a tree of specs."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (f"#{i}",))
                              for i, v in enumerate(node))
        if node is None:
            return None
        return spec_fn(path, tuple(node.shape), mesh)
    return walk(tree, ())


def placements(spec, mesh) -> tuple:
    """DTensor placements of a spec on ``mesh``: mesh dim ``a`` gets
    ``Shard(d)`` where tensor dim ``d`` names ``a``, else ``Replicate()``.
    Names the mesh lacks are ignored (a spec read on the model sub-mesh
    keeps its "model" entry only); ``("pod", "data")`` on one dim shards
    pod-major, as DTensor orders mesh dims."""
    out = []
    for name in axis_names(mesh):
        dims = [d for d, e in enumerate(spec)
                if e is not None and name in _names(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _sharding(tree, mesh, spec_fn):
    specs = tree_specs(tree, mesh, spec_fn)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if node is None:
            return None
        return placements(node, mesh)
    return walk(specs)


def params_sharding(params, mesh):
    """The base tree's placements on ``mesh``."""
    return _sharding(params, mesh, param_spec)


# ------------------------------------------------------------------- LoRA

def lora_spec(path_keys, shape, mesh, *, client_dim: bool) -> tuple:
    leaf = path_keys[-1]          # "a" or "b"
    nd = len(shape)
    spec = [None] * nd
    if client_dim:
        ca = batch_axes(mesh)
        if ca and _div(shape[0], mesh, ca):
            spec[0] = _axis(ca)
    if leaf == "b" and _div(shape[-2], mesh, "model"):
        spec[-2] = "model"        # B rows follow the base weight's out dim
    return tuple(spec)


def lora_sharding(lora, mesh, *, client_dim=True):
    """Placements for a LoRA tree (or an optimizer state over one), or an
    :class:`~repro_torch.core.lora.AdapterSet`, which comes back as an
    AdapterSet whose ``lora`` holds them."""
    from repro_torch.core.lora import AdapterSet
    if isinstance(lora, AdapterSet):
        return dataclasses.replace(
            lora, lora=lora_sharding(lora.lora, mesh, client_dim=client_dim))
    return _sharding(lora, mesh, lambda p, s, m: lora_spec(
        p, s, m, client_dim=client_dim))


# ------------------------------------------------------------------- cache

def cache_spec(path_keys, shape, mesh) -> tuple:
    leaf = path_keys[-1]
    nd = len(shape)
    stacked = any(k.startswith("p") and k[1:].isdigit() for k in path_keys)
    off = 1 if (stacked and "repeat" in path_keys) else 0
    spec = [None] * nd
    ba = batch_axes(mesh)
    bdim = off                                # batch dim position
    bsz = shape[bdim] if nd > bdim else 0
    batch_ok = ba and _div(bsz, mesh, ba)
    if leaf in ("k", "v"):                    # (b, S, kh, hd)
        if batch_ok:
            spec[bdim] = _axis(ba)
        elif _div(shape[off + 1], mesh, ba):
            spec[off + 1] = _axis(ba)         # seq-sharded cache
        if (opts.enabled("cache_seq_shard") and spec[off + 1] is None
                and _div(shape[off + 1], mesh, "model")):
            spec[off + 1] = "model"
        elif _div(shape[off + 2], mesh, "model"):
            spec[off + 2] = "model"
        elif _div(shape[off + 3], mesh, "model"):
            spec[off + 3] = "model"
    elif leaf == "pos":                       # (b, S)
        if batch_ok:
            spec[bdim] = _axis(ba)
        elif _div(shape[off + 1], mesh, ba):
            spec[off + 1] = _axis(ba)
        if (opts.enabled("cache_seq_shard") and spec[off + 1] is None
                and _div(shape[off + 1], mesh, "model")):
            spec[off + 1] = "model"
    elif leaf in ("cross_k", "cross_v"):
        if batch_ok:
            spec[bdim] = _axis(ba)
        if _div(shape[off + 2], mesh, "model"):
            spec[off + 2] = "model"
    elif leaf in ("h", "c", "n", "conv_tail", "C"):
        # recurrent states (b, ..., d); the mLSTM's C (b, h, hd, hd)
        if batch_ok:
            spec[bdim] = _axis(ba)
        if _div(shape[-1], mesh, "model"):
            spec[-1] = "model"
    elif leaf == "m":
        if batch_ok:
            spec[bdim] = _axis(ba)
    return tuple(spec)


def cache_sharding(cache, mesh):
    return _sharding(cache, mesh, cache_spec)


# ------------------------------------------------------------------- inputs

def input_spec(path_keys, shape, mesh, *, client_dim: bool) -> tuple:
    """tokens (b, s) / (N, steps, b, s); frames / patches alike: the
    leading dim (batch, or clients with ``client_dim``) over the batch
    axes where it divides."""
    spec = [None] * len(shape)
    ba = batch_axes(mesh)
    if ba and _div(shape[0], mesh, ba):
        spec[0] = _axis(ba)
    return tuple(spec)


def inputs_sharding(batch, mesh, *, client_dim=False):
    return _sharding(batch, mesh, lambda p, s, m: input_spec(
        p, s, m, client_dim=client_dim))


def chunked_input_spec(path_keys, shape, mesh) -> tuple:
    """Chunk-staged training batches (chunk_rounds, N, steps, b, s): the
    leading dim stays replicated, the client dim (dim 1) shards over the
    client axes where it divides."""
    nd = len(shape)
    spec = [None] * nd
    ba = batch_axes(mesh)
    if nd > 1 and ba and _div(shape[1], mesh, ba):
        spec[1] = _axis(ba)
    return tuple(spec)


def chunked_inputs_sharding(batch, mesh):
    return _sharding(batch, mesh, chunked_input_spec)


def block_of(size: int, spec_entry, mesh, coords: dict):
    """The [lo, hi) block of a dim of ``size`` that the device at
    ``coords`` (axis name -> index) holds under ``spec_entry``: the whole
    dim when the entry is None, else the pod-major block."""
    if spec_entry is None:
        return 0, size
    sizes = axis_sizes(mesh)
    names = _names(spec_entry)
    idx = 0
    for n in names:
        idx = idx * sizes[n] + coords[n]
    per = size // math.prod(sizes[n] for n in names)
    return idx * per, (idx + 1) * per
