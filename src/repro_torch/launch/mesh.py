"""Mesh construction over ``torch.distributed``: the port of
``repro/launch/mesh.py``.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
default process group, with JAX's axis names: ``("data", "model")`` for a
``"DxM"`` spec, ``("pod", "data", "model")`` for ``"PxDxM"``.  The client
dim of the federated state shards over the client axes (``"pod"`` and
``"data"``, pod-major); the base is tensor-parallel over ``"model"``
(``sharding/rules.py``).

Building a mesh never starts a process group: the caller does, with the
group's address, world size and rank (``launch/train.py`` reads them from
``torch.distributed.run``'s environment), or :func:`start_fake_group`
starts a fake one (one process standing for rank 0 of the world, no
communication: the dry-run's).  The partition rules read only axis names
and sizes, so they also take a :class:`MeshShape`, which needs no group
(the rule tests build one for the 16x16 pod).

The roofline constants are an H100 SXM's, per GPU, from NVIDIA's H100
data sheet at the 700 W limit (dense, no sparsity).  The production
meshes are TPU pod shapes: on GPUs a 16-wide model axis spans two 8-GPU
NVLink nodes, so part of its traffic crosses the slower inter-node
network, and ``collective_s`` computed from ``NVLINK_BW`` is a lower
bound there.
"""
from __future__ import annotations

import dataclasses
import math

import torch

# H100 SXM roofline constants, per GPU (NVIDIA H100 Tensor Core GPU data
# sheet, SXM5 column, dense figures at the 700 W limit)
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, bf16 tensor cores, dense
HBM_BW = 3.35e12               # B/s, HBM3
NVLINK_BW = 450e9              # B/s each way (the sheet's 900 GB/s counts
                               # both directions)

POD = (16, 16)
MULTIPOD = (2, 16, 16)
_AXES = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes of a mesh, with no devices behind them: what
    the partition rules read (``axis_names``, and ``shape`` name -> size,
    as a JAX mesh has them)."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def parse_spec(spec: str):
    """A CLI spec -> (dims, axis names), or None for no mesh.

    ``""`` / ``"none"`` -> None; ``"pod"`` / ``"multipod"`` -> the
    production shapes 16x16 and 2x16x16; ``"DxM"`` / ``"PxDxM"`` (e.g.
    ``"4x2"``) -> those dims, axes ("data", "model") / ("pod", "data",
    "model"); one dim -> ("data",)."""
    if not spec or spec == "none":
        return None
    if spec == "pod":
        dims = POD
    elif spec == "multipod":
        dims = MULTIPOD
    else:
        dims = tuple(int(d) for d in spec.split("x"))
    axes = _AXES.get(len(dims))
    if axes is None:
        raise ValueError(f"mesh spec '{spec}': expected 1-3 'x'-joined dims")
    return dims, axes


def mesh_shape(spec: str):
    """The :class:`MeshShape` of a spec (None for no mesh)."""
    parsed = parse_spec(spec)
    return None if parsed is None else MeshShape(parsed[1], parsed[0])


def mesh_from_spec(spec: str, device="cuda"):
    """A :class:`DeviceMesh` of the spec's shape over the default process
    group (None for ``""`` / ``"none"``), on ``device``'s type ("cuda" or
    "cpu").  Raises when no group is started, or when the mesh's size is
    not the group's world size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    parsed = parse_spec(spec)
    if parsed is None:
        return None
    dims, axes = parsed
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh '{spec}' needs the default process group: start it with "
            "torch.distributed.init_process_group, or launch under "
            "python -m torch.distributed.run")
    world = dist.get_world_size()
    if math.prod(dims) != world:
        raise ValueError(
            f"mesh '{spec}' has {math.prod(dims)} devices but the process "
            f"group's world size is {world}")
    return init_device_mesh(torch.device(device).type, dims,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """The 16x16 ``("data", "model")`` pod or the 2x16x16 ``("pod",
    "data", "model")`` multi-pod as a DeviceMesh over the default process
    group (256 or 512 ranks; :func:`start_fake_group` starts one without
    devices)."""
    return mesh_from_spec("multipod" if multi_pod else "pod", "cpu")


def _create_fake_pg(store, rank, world_size, timeout):
    from torch._C._distributed_c10d import FakeProcessGroup
    make = getattr(FakeProcessGroup, "_create_internal", FakeProcessGroup)
    return make(rank, world_size)


def start_fake_group(world_size: int):
    """Start a fake default process group of ``world_size`` ranks in which
    this process is rank 0: collectives are accepted and move nothing
    (torch's ``FakeProcessGroup``, registered here as the ``"fake"``
    backend).  A group the process already has is torn down first, so one
    process can switch between the 256- and the 512-rank worlds."""
    import torch.distributed as dist

    if "FAKE" not in dist.Backend._plugins:
        dist.Backend.register_backend("fake", _create_fake_pg,
                                      devices=["cpu", "cuda"])
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world_size)


def axis_sizes(mesh) -> dict:
    """Axis name -> size, for a DeviceMesh or a :class:`MeshShape`."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def axis_names(mesh) -> tuple:
    if isinstance(mesh, MeshShape):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def client_axes(mesh) -> tuple:
    """Mesh axes that carry the federated client dimension."""
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def num_clients(mesh) -> int:
    """Client slots of the mesh: the product of its client axes."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in client_axes(mesh))


def client_group(mesh):
    """The process group over the client axes that holds this device, its
    ranks in pod-major client order.  For the (pod, data) pair every
    device creates one group per model coordinate, in the same order, as
    ``torch.distributed.new_group`` asks."""
    import torch.distributed as dist

    axes = client_axes(mesh)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cols = mesh.mesh.reshape(-1, mesh.mesh.shape[-1]).T.tolist()
    mine = None
    for ranks in cols:
        group = dist.new_group(ranks)
        if dist.get_rank() in ranks:
            mine = group
    return mine
