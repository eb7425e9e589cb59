"""Device meshes (the port of ``repro.launch.mesh``).

The reference names its meshes' axes ``("data", "model")`` (one pod) or
``("pod", "data", "model")`` (two pods).  Here a mesh is either

  * an `AbstractMesh`: axis names and sizes only, no processes — what the
    sharding rule engine and the production-mesh tests read, as
    ``jax.sharding.AbstractMesh`` is for the reference; or
  * a ``torch.distributed`` ``DeviceMesh`` over the ranks of a process
    group, one rank per device.

The card runs the 1x1 smoke mesh (`make_smoke_mesh`) in a process group of
one rank: NCCL on the card, gloo only when the caller asks for the CPU.
Meshes of more ranks run on the CPU over gloo, one process per rank, with
the caller's own process group.  Functions, not module-level constants, so
importing this module starts no process group.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import resolve_device

POD_SHAPE, POD_AXES = (16, 16), ("data", "model")
MULTIPOD_SHAPE, MULTIPOD_AXES = (2, 16, 16), ("pod", "data", "model")


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no devices behind them."""
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``AbstractMesh.shape`` gives it."""
        return dict(zip(self.axis_names, self.axis_sizes))


def make_abstract_mesh(shape, axes) -> AbstractMesh:
    if len(shape) != len(axes):
        raise ValueError(f"{len(shape)} sizes for {len(axes)} axes {axes}")
    return AbstractMesh(tuple(axes), tuple(int(n) for n in shape))


def axis_names(mesh) -> tuple[str, ...]:
    """The axis names of an `AbstractMesh` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names or ())


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size of an `AbstractMesh` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(axis_names(mesh), mesh.shape))


def mesh_devices(mesh) -> int:
    return int(np.prod(list(mesh_shape(mesh).values()), dtype=np.int64))


def data_axes(mesh) -> tuple[str, ...]:
    """Mesh axes that carry the batch dimension."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def make_smoke_mesh(device=None):
    """The 1x1 ``("data", "model")`` mesh on ``device`` (default: the card).

    Makes a process group of one rank first if there is none: NCCL on the
    card, gloo when the caller asks for the CPU, over an in-memory
    ``HashStore`` at rank 0.  Raises if the existing group has more ranks,
    or lacks NCCL while the card is asked for."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        dist.init_process_group(
            backend, store=dist.HashStore(), rank=0, world_size=1,
            device_id=dev if dev.type == "cuda" else None)
    if dist.get_world_size() != 1:
        raise ValueError(f"the smoke mesh is one device; the process group "
                         f"has {dist.get_world_size()} ranks")
    if backend not in dist.get_backend():
        raise ValueError(f"the smoke mesh on {dev} needs {backend}; the "
                         f"process group runs {dist.get_backend()}")
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=POD_AXES)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """Single pod: 16x16 = 256 ranks over ("data", "model").
    Multi-pod: 2x16x16 = 512 ranks over ("pod", "data", "model").
    Needs the caller's process group of exactly that many ranks (the
    reference's ``jax.make_mesh`` raises too without 256/512 devices)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = MULTIPOD_SHAPE if multi_pod else POD_SHAPE
    axes = MULTIPOD_AXES if multi_pod else POD_AXES
    n = int(np.prod(shape))
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise ValueError(f"the production mesh {shape} over {axes} needs a "
                         f"process group of {n} ranks, one per device; "
                         f"this process has "
                         f"{have if have else 'no process group'}")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


def spec_placements(mesh, spec) -> tuple:
    """A ``DeviceMesh``'s placements for a partition spec: mesh axis ``a``
    becomes ``Shard(d)`` where tensor dim ``d`` names it, else
    ``Replicate()``.  A tuple of axes on one dim (``("pod", "data")``)
    becomes one ``Shard(d)`` per axis; it must list them in mesh order,
    the order in which DTensor nests shards of one dim."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"spec {spec} names axes {missing} that the "
                             f"mesh {names} lacks")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} uses mesh axis {names[i]} "
                                 "twice")
            out[i] = Shard(d)
    return tuple(out)


def local_shape(mesh, placements, shape) -> tuple[int, ...]:
    """This rank's shard of a tensor of ``shape`` laid out as
    ``placements``: each ``Shard(d)`` divides dim d by its mesh dim's size
    (the rule engine assigns only axes that divide)."""
    from torch.distributed.tensor import Shard
    out = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if out[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"divide over mesh dim {i} ({n})")
            out[p.dim] //= n
    return tuple(out)


def contiguous_stride(shape) -> tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return tuple(stride)


def sharded_zeros(mesh, placements, shape, dtype, device):
    """A ``DTensor`` of zeros laid out as ``placements``: only this rank's
    shard is made."""
    from torch.distributed.tensor import DTensor
    shape = tuple(int(n) for n in shape)
    local = torch.zeros(local_shape(mesh, placements, shape), dtype=dtype,
                        device=device)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))
