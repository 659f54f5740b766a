"""The in-model sharding constraint: the port of ``use_mesh``,
``current_mesh`` and ``constrain`` of ``repro/sharding/specs.py``.

``constrain(x, spec)`` is the identity off a mesh and on a plain tensor.
On a DTensor inside :func:`use_mesh` it redistributes ``x`` to the spec's
placements over the mesh the tensor lives on (the trainer's model
sub-mesh); an axis that mesh lacks, or a dim the axis does not divide,
becomes None, as in JAX.  Where JAX's ``with_sharding_constraint`` lets
GSPMD choose the collectives, ``redistribute`` runs them here and now.

On a mesh with batch axes (the dry-run's prefill and decode: the batch
over "pod" / "data", the base over "model") the helpers that bring a
DTensor back to whole tensors keep each device's batch rows
(:func:`batch_kept`).
"""
from __future__ import annotations

import contextlib
import threading

from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.launch.mesh import axis_sizes
from repro_torch.sharding.rules import _names, placements

_state = threading.local()


@contextlib.contextmanager
def use_mesh(mesh):
    """Enables in-model :func:`constrain` calls for the duration."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


@contextlib.contextmanager
def replicating():
    """Plain tensors meeting DTensors are taken as replicated for the
    duration (DTensor's ``implicit_replication``), re-entrant: on exit
    the setting goes back to what it was (``implicit_replication`` itself
    turns it off, so a nested use would end an outer one).  For the
    nested sites only (a sharded base's forward inside the trainer's
    ``MeshRun.scope`` or the dry-run's trace): it sets DTensor's private
    flag, and raises where a torch lacks it."""
    disp = DTensor._op_dispatcher
    if not hasattr(disp, "_allow_implicit_replication"):
        raise RuntimeError(
            "this torch's DTensor dispatcher has no "
            "_allow_implicit_replication flag, which "
            "repro_torch.sharding.specs.replicating sets")
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev


def current_mesh():
    return getattr(_state, "mesh", None)


def constrain(x, spec):
    """``x`` redistributed to ``spec`` when a mesh is active, ``x`` is a
    DTensor and the dims divide evenly; ``x`` itself otherwise."""
    if current_mesh() is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    sizes = axis_sizes(mesh)
    parts = []
    for dim, name in enumerate(spec):
        if name is None or not all(n in sizes for n in _names(name)):
            parts.append(None)
            continue
        size = 1
        for n in _names(name):
            size *= sizes[n]
        parts.append(name if x.shape[dim] % size == 0 else None)
    target = placements(parts, mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(mesh, target)


BATCH_AXES = ("pod", "data")


def batch_kept(placements, mesh) -> list:
    """``placements`` with a batch row split kept and everything else
    replicated: on a mesh dim named "pod" or "data" a ``Shard(0)`` stays
    (the batch rows a device owns: data parallelism needs no exchange),
    every other placement (a model-axis shard, a partial sum) becomes
    ``Replicate()``.  On the trainer's model sub-mesh, all replicated."""
    names = mesh.mesh_dim_names or (None,) * mesh.ndim
    return [p if name in BATCH_AXES and p == Shard(0) else Replicate()
            for name, p in zip(names, placements)]


def full_local(t):
    """A DTensor as the plain tensor every device then holds in full
    (redistributed to replicated, then its local copy; both steps carry
    the gradient), but for the batch rows a device owns on the batch axes
    (:func:`batch_kept`); a plain tensor (or a float) as it is.  Where a
    model axis meets code that runs on whole tensors: the CE (its label
    gather over vocab-sharded logits fails in DTensor's masked-partial
    reduction), the MoE aux loss, the sLSTM recurrence, and the trainer's
    host reads."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    return t.redistribute(mesh, batch_kept(t.placements, mesh)).to_local()


def rejoin(t, like):
    """The way back from :func:`full_local`: a plain tensor every device
    holds in full (or in its batch rows, where ``like`` splits its batch
    over a batch axis), as a DTensor on ``like``'s mesh where ``like`` is
    a DTensor (else ``t`` as it is), so that its gradient comes back to
    the plain graph as a plain tensor."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, batch_kept(like.placements, mesh),
                              run_check=False)


def replicated(t):
    """A DTensor redistributed to replicated, but for its batch rows
    (:func:`batch_kept`; it stays a DTensor); a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh,
                          batch_kept(t.placements, t.device_mesh))


def split_heads(t, n: int, hd: int):
    """``t`` (..., n * hd) as (..., n, hd).  A DTensor split on its last
    dim over a mesh dim whose size does not divide ``n`` (8 heads over a
    16-wide model axis, or one KV head) is first gathered on that mesh
    dim: DTensor shards the heads or nothing, never part of a head."""
    if isinstance(t, DTensor):
        mesh, last = t.device_mesh, Shard(t.ndim - 1)
        pl = [Replicate() if p == last and n % mesh.size(i) else p
              for i, p in enumerate(t.placements)]
        if pl != list(t.placements):
            t = t.redistribute(mesh, pl)
    return t.reshape(*t.shape[:-1], n, hd)


def merge_heads(t):
    """``t`` (..., n, hd) as (..., n * hd), the inverse of
    :func:`split_heads`.  A DTensor split on its head dim (a cache
    sharded there hands its split to the attention output) is first
    gathered on it: only the leading dim of a merge may stay split."""
    if isinstance(t, DTensor):
        mesh, last = t.device_mesh, Shard(t.ndim - 1)
        if any(p == last for p in t.placements):
            t = t.redistribute(mesh, [Replicate() if p == last else p
                                      for p in t.placements])
    return t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1])
