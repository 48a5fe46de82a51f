"""Device meshes over the ranks of a ``torch.distributed`` world.

The reference package's mesh is one process driving D devices, with XLA's
SPMD partitioner inserting the collectives. The port runs SPMD over
processes: one process per rank, each on its own device (or ranks sharing
one card through gloo, see distributed.init_distributed), the same call on
every rank, and explicit collectives over the process group of a mesh axis.
A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named axes:

 - 'data'     : batch / cohort data parallelism (DP)
 - 'model'    : tensor parallelism over U-Net feature channels (TP)
 - 'ensemble' : the independent models of a stacked ensemble (EP)

A mesh spans the whole world, in rank order (row-major over the axes).
The reference's ``named(mesh, *spec)`` builds a ``NamedSharding``, which
has no counterpart: here :func:`named` returns the process group of one
axis, the handle the port's collectives take.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ['make_mesh', 'auto_axes', 'named', 'axis_size', 'axis_index',
           'data_axis', 'mesh_key', 'check_mesh']


def make_mesh(axes: Dict[str, int], device=None) -> DeviceMesh:
    """A mesh with named axes over every rank of the initialized world,
    e.g. ``make_mesh({'data': 2, 'model': 2})`` on 4 ranks. ``device``:
    the ranks' device, as ``distributed.rank_device`` takes it (None = the
    CUDA card, raising without one; ``'cpu'`` only when asked for).
    Axes that need more ranks than the world has raise, as the reference's
    do; so do axes that need fewer (the reference would take the first n
    devices: here every rank runs every call, so a mesh covers them all)."""
    from .distributed import rank_device
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError('make_mesh needs an initialized torch.distributed '
                           'world: call parallel.init_distributed() (or run '
                           'under torchrun) first')
    world = dist.get_world_size()
    n = int(np.prod(list(axes.values())))
    if n > world:
        raise ValueError(f'Mesh needs {n} devices, only {world} available')
    if n < world:
        raise ValueError(f'Mesh needs {n} devices but the world has {world} '
                         f'ranks: a mesh spans the whole world')
    dev = rank_device(device)
    return init_device_mesh(dev.type, tuple(int(v) for v in axes.values()),
                            mesh_dim_names=tuple(axes))


def auto_axes(n_devices: int, want_ensemble: bool = True) -> Dict[str, int]:
    """A reasonable default factorization of n devices into
    (ensemble, data, model): the reference's rule."""
    axes: Dict[str, int] = {}
    rem = n_devices
    if want_ensemble and rem % 2 == 0 and rem >= 4:
        axes['ensemble'] = 2
        rem //= 2
    if rem % 2 == 0 and rem >= 4:
        axes['data'] = rem // 2
        axes['model'] = 2
    else:
        axes['data'] = rem
    return axes


def check_mesh(mesh) -> DeviceMesh:
    """``mesh`` itself if it is a mesh of named axes; else TypeError."""
    if not isinstance(mesh, DeviceMesh) or not mesh.mesh_dim_names:
        raise TypeError(f'mesh must be a DeviceMesh with named axes '
                        f'(parallel.make_mesh), got {mesh!r}')
    return mesh


def named(mesh: DeviceMesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(axis)


def axis_size(mesh, axis: Optional[str]) -> int:
    """The size of ``axis`` of a mesh, or of a dict of axis sizes (the
    sharding rules take either), 0 when there is no such axis."""
    if mesh is None or axis is None:
        return 0
    if isinstance(mesh, Mapping):
        return int(mesh.get(axis, 0))
    if axis not in mesh.mesh_dim_names:
        return 0
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return int(mesh.get_local_rank(axis))


def data_axis(mesh: DeviceMesh) -> str:
    """'data' if the mesh has it, else its first axis (the reference's
    rule for the cohort programs)."""
    names = mesh.mesh_dim_names
    return 'data' if 'data' in names else names[0]


def mesh_key(mesh: Optional[DeviceMesh]) -> Optional[Tuple]:
    """A program cache's identity of a mesh: axis names, shape and the rank
    layout (never ``id()``)."""
    if mesh is None:
        return None
    check_mesh(mesh)
    return (tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape),
            tuple(mesh.mesh.flatten().tolist()))
