"""The in-model sharding constraint: the port of ``use_mesh``,
``current_mesh`` and ``constrain`` of ``repro/sharding/specs.py``.

``constrain(x, spec)`` is the identity off a mesh and on a plain tensor.
On a DTensor inside :func:`use_mesh` it redistributes ``x`` to the spec's
placements over the mesh the tensor lives on (the trainer's model
sub-mesh); an axis that mesh lacks, or a dim the axis does not divide,
becomes None, as in JAX.  Where JAX's ``with_sharding_constraint`` lets
GSPMD choose the collectives, ``redistribute`` runs them here and now.
"""
from __future__ import annotations

import contextlib
import threading

from torch.distributed.tensor import DTensor, Replicate

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


def full_local(t):
    """A DTensor as the plain tensor every device then holds in full
    (redistributed to replicated, then its local copy; both steps carry
    the gradient); a plain tensor (or a float) as it is.  Where a model
    axis meets code that runs on whole tensors: the CE (its label gather
    over vocab-sharded logits fails in DTensor's masked-partial
    reduction), the MoE aux loss, the sLSTM recurrence, and the trainer's
    host reads."""
    if not isinstance(t, DTensor):
        return t
    rep = [Replicate()] * t.device_mesh.ndim
    return t.redistribute(t.device_mesh, rep).to_local()


def rejoin(t, like):
    """The way back from :func:`full_local`: a plain tensor every device
    holds in full, as a replicated DTensor on ``like``'s mesh where
    ``like`` is a DTensor (else ``t`` as it is), so that its gradient
    comes back to the plain graph as a plain tensor."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def replicated(t):
    """A DTensor redistributed to replicated (it stays a DTensor); a plain
    tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)
