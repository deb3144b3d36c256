"""Device meshes over torch ranks; the port of ``blendjax.parallel.mesh``.

A torch mesh is one process per rank: ``torch.distributed`` must be
initialised in every process before a mesh is made, and every rank of the
world makes it (the mesh's axis groups are made collectively).  A
:class:`~torch.distributed.device_mesh.DeviceMesh` carries the axis names,
and DTensor placements stand in for the reference's
``NamedSharding``/``PartitionSpec``.  Conventions, as the reference's:

- axis ``'data'``: the batch (data-parallel) axis; each rank is fed its
  shard of the stream (``BatchLoader(shard=(rank, n))``);
- axis ``'model'``: the tensor-parallel axis of wide layers.

``make_mesh({'data': 4, 'model': 2})`` builds a 2-D mesh over the first 8
ranks.  Meshes live on the card unless the caller asks for the CPU.

On one card NCCL refuses two ranks on one device, so ranks that share a
card use the gloo backend, whose CUDA collectives stage through the host.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from blendjax_torch.utils.device import resolve_device


class PartitionSpec(tuple):
    """Per tensor dimension, the mesh axis it is sharded over (None: not
    sharded); ``jax.sharding.PartitionSpec``'s role.  ``P()`` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec


def placements(mesh, spec):
    """DTensor placements (one per mesh axis) for ``spec``: ``Shard(dim)``
    on the axis a tensor dimension names, ``Replicate()`` elsewhere."""
    names = mesh.mesh_dim_names
    for axis in spec:
        if axis is not None and axis not in names:
            raise ValueError(f"{spec} names axis {axis!r}; the mesh has {names}")
    out = []
    for name in names:
        dims = [i for i, axis in enumerate(spec) if axis == name]
        if len(dims) > 1:
            raise ValueError(f"{spec} shards two dimensions over axis {name!r}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a :class:`PartitionSpec` over it; ``placements`` are the
    DTensor placements they make."""

    mesh: DeviceMesh
    spec: PartitionSpec

    @property
    def placements(self):
        return placements(self.mesh, self.spec)


def make_mesh(axes: dict, devices=None, device="cuda") -> DeviceMesh:
    """A mesh with the ``{axis_name: size}`` layout over ``devices`` (ranks
    of the initialised process group; all of them by default).  The sizes
    must multiply to at most the rank count; extras are left out and get
    None.  Every rank of the world calls this.

    Each axis's groups are made here, with the process group's own backend
    (a CUDA mesh over a gloo world stays on gloo: NCCL cannot hold two
    ranks on one card), and the mesh is assembled from them; a CUDA rank
    is put on its card (``LOCAL_RANK``, else rank modulo the card count)."""
    names = tuple(axes)
    sizes = tuple(axes.values())
    need = math.prod(sizes)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised in every rank "
                           "(torch.distributed.init_process_group)")
    ranks = list(range(dist.get_world_size())) if devices is None else list(devices)
    if need > len(ranks):
        raise ValueError(f"mesh {axes} needs {need} devices, have {len(ranks)}")
    dev = resolve_device(device)
    layout = torch.tensor(ranks[:need]).reshape(sizes)
    me, backend = dist.get_rank(), dist.get_backend()
    groups = []
    for dim, size in enumerate(sizes):
        mine = None
        # new_group is collective: every rank makes every group, in one order
        for line in layout.movedim(dim, -1).reshape(-1, size).tolist():
            group = dist.new_group(line, backend=backend)
            if me in line:
                mine = group
        groups.append(mine)
    if me not in layout.flatten().tolist():
        return None
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                 me % torch.cuda.device_count())))
    return DeviceMesh.from_group(groups if len(groups) > 1 else groups[0], dev.type,
                                 layout, mesh_dim_names=names)


def data_mesh(num_devices=None, device="cuda") -> DeviceMesh:
    """1-D data-parallel mesh over all ranks (or the first ``num_devices``)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if num_devices is not None:
        n = min(n, num_devices)
    return make_mesh({"data": n}, list(range(n)), device=device)


def data_sharding(mesh: DeviceMesh, axis="data") -> NamedSharding:
    """Shard the leading (batch) dimension over ``axis``, replicate the rest."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: DeviceMesh) -> NamedSharding:
    return NamedSharding(mesh, P())
