"""Device meshes: the production layouts, shape-only, and the one-card mesh.

The counterpart of the JAX package's ``launch/mesh.py``.  The reference's
production meshes (a 16x16 TPU v5e pod, two of them for ``multi_pod``)
exist only in its dry run; here :func:`make_production_mesh` gives them as
an :class:`AbstractMesh` (axis names and sizes, no devices), which the
shard rules and the dry run read.  :func:`make_host_mesh` gives a real
1x1 ``torch.distributed`` :class:`DeviceMesh` over the one device this
process drives, with the same axis names; its world of one rank is set up
from an in-process ``HashStore`` (no address, no port, no network).

:func:`make_mesh` gives a ``(data, model)`` :class:`DeviceMesh` over a
world of ``data x model`` ranks, one process each (the counterpart of the
``jax.make_mesh(shape, axes)`` the reference's runtime takes): the world
is initialised with gloo for both device types and rendezvouses through a
``FileStore`` (a file every rank can reach; no address or port is
chosen), and the mesh carries its collectives
(:mod:`repro_torch.parallel`): gloo for CPU tensors, the IPC
all-reduce kernel for CUDA tensors (its buffers opened at construction).

Nothing here initialises a process group when the module is imported: only
:func:`make_host_mesh` and :func:`make_mesh` do, and only when no default
group is up.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.parallel import transport

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}
HOST_AXES = ("data", "model")


class AbstractMesh:
    """A mesh's axis names and sizes, with no devices (the counterpart of
    ``jax.sharding.AbstractMesh``): ``.shape`` maps each name to its
    size."""

    def __init__(self, sizes: Tuple[int, ...], names: Tuple[str, ...]):
        if len(sizes) != len(names):
            raise ValueError(f"{len(sizes)} sizes for {len(names)} axes")
        self.axis_names = tuple(names)
        self.axis_sizes = tuple(int(s) for s in sizes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """Single pod: (data=16, model=16), 256 devices.  Multi-pod: (pod=2,
    data=16, model=16), 512.  Shape-only: see :func:`production_device_mesh`
    for one over real ranks."""
    return AbstractMesh(*PRODUCTION[bool(multi_pod)])


def production_device_mesh(device, *, multi_pod: bool = False):
    """The production layout over the ranks of an initialised world of
    exactly 256 (512 with ``multi_pod``) ranks, one device each (as
    ``torchrun`` starts them).  Any other world is refused with both sizes
    named, as the reference's ``jax.make_mesh`` refuses too few devices."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    sizes, names = PRODUCTION[bool(multi_pod)]
    need = mesh_size(AbstractMesh(sizes, names))
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise RuntimeError(
            f"the production mesh {dict(zip(names, sizes))} needs a world "
            f"of {need} ranks; this process is in a world of {have} (start "
            f"{need} ranks with torchrun, or train on one card without "
            f"--multi-pod)")
    return init_device_mesh(torch.device(device).type, sizes,
                            mesh_dim_names=names)


def make_host_mesh(device="cuda"):
    """A 1x1 :class:`DeviceMesh` (``("data", "model")``) over this process's
    device: ``cuda`` (NCCL) or ``cpu`` (gloo).

    A default process group that is already up is reused when its world
    size is 1 and refused otherwise; else one is initialised here, a world
    of one rank over an in-process ``HashStore``.  Asking for ``cuda``
    without a CUDA device raises: it never builds a CPU mesh instead."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh('cuda'): no CUDA device is "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"make_host_mesh: device {device!r} (cuda or cpu)")
    if dist.is_initialized():
        world = dist.get_world_size()
        if world != 1:
            raise RuntimeError(
                f"make_host_mesh: the default process group has world size "
                f"{world}; the host mesh is a world of 1")
    else:
        backend = ("cpu:gloo,cuda:nccl" if torch.cuda.is_available()
                   else "gloo")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return DeviceMesh(dev.type, torch.zeros((1, 1), dtype=torch.int),
                      mesh_dim_names=HOST_AXES)


def make_mesh(sizes: Tuple[int, int], device="cuda", *, rank=None,
              world_size=None, init_file=None):
    """A ``("data", "model")`` :class:`DeviceMesh` of ``sizes`` over the
    ranks of a world of ``data x model`` processes, rank r at coordinate
    ``(r // model, r % model)``.

    With no default process group up, this process joins one: ``rank`` of
    ``world_size``, backend ``cpu:gloo,cuda:gloo``, rendezvous through the
    ``FileStore`` at ``init_file`` (``init_method="file://..."``); every
    rank must pass the same file.  A world whose size differs from the
    mesh's is refused with both named (a ``model`` size that does not
    divide the attention's heads is refused by the decode loop, which
    knows the config).  ``device`` is this rank's device (``"cpu"``, or a
    CUDA device; several ranks may share one card).  The mesh's
    collectives — per axis its gloo group and, on CUDA, its IPC buffers —
    are :func:`repro_torch.parallel.transport` of it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    data, model = (int(s) for s in sizes)
    need = data * model
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"make_mesh({device!r}): no CUDA device is "
                           "available")
    if not dist.is_initialized():
        if init_file is None or rank is None or world_size is None:
            raise ValueError("make_mesh: no process group is up; pass rank=, "
                             "world_size= and init_file= (a FileStore path "
                             "every rank reaches)")
        dist.init_process_group("cpu:gloo,cuda:gloo",
                                init_method=f"file://{init_file}",
                                rank=int(rank), world_size=int(world_size))
    have = dist.get_world_size()
    if have != need:
        raise RuntimeError(
            f"make_mesh: the mesh {{'data': {data}, 'model': {model}}} needs "
            f"a world of {need} ranks; this process is in a world of {have}")
    mesh = DeviceMesh(dev.type, torch.arange(need).reshape(data, model),
                      mesh_dim_names=HOST_AXES)
    transport(mesh, dev)
    return mesh


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, for an :class:`AbstractMesh` or a DeviceMesh."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_size(mesh) -> int:
    """The number of devices a mesh stands for."""
    return axis_size(mesh, tuple(mesh_shape(mesh)))


def batch_axes(mesh) -> Tuple[str, ...]:
    """Axes the batch dimension shards over."""
    names = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh, names) -> int:
    if isinstance(names, str):
        names = (names,)
    shape = mesh_shape(mesh)
    out = 1
    for n in names:
        out *= shape[n]
    return out


def divisible(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0
