"""The multi-process runtime: process-group initialization, the host-local
<-> global tensor plumbing, and cohort inference across processes.

One process per rank (torchrun, or the ``tcp://`` arguments), each on its
own device: ``cuda:{LOCAL_RANK % device_count}``. The backend is NCCL on
CUDA and gloo for ``device='cpu'``; ranks that share one card (NCCL
refuses two ranks on one device) ask for gloo explicitly with CUDA
tensors. A backend is never switched on a failure.

The reference's global ``jax.Array`` with a sharding maps to PyTorch's
``DTensor`` (``torch.distributed.tensor``): :func:`distribute_batch`,
:func:`replicate` and :func:`local_shard`. The programs themselves work
on plain local tensors, with explicit collectives (parallel/collectives.py).

Typical flow (``torchrun --nproc-per-node=N script.py``)::

    init_distributed()                      # torchrun's env
    mine = vols[process_shard(len(vols))]   # this rank's share
    segs = predict_cohort_distributed(engine, mine, spacing, modes,
                                      gather=True)
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .collectives import gather_uneven
from .mesh import axis_size, data_axis, make_mesh, named

__all__ = ['init_distributed', 'is_distributed', 'process_shard',
           'global_mesh', 'distribute_batch', 'replicate', 'local_shard',
           'predict_cohort_distributed', 'rank_device']


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids=None, backend: Optional[str] = None,
                     device=None) -> Tuple[int, int]:
    """Join (or form) the process group and make this rank's card the
    current one.

    Without arguments it reads torchrun's env (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); a hand-rolled
    cluster passes ``coordinator_address='host:port'``, ``num_processes``
    and ``process_id``. ``device``: as :func:`rank_device` (None = this
    rank's CUDA card, raising without one; ``'cpu'`` to run on the CPU).
    ``local_device_ids``: the reference's list of this process's local
    devices; one rank drives one card here, so ``[i]`` (or ``i``) names
    ``cuda:i``. More than one id, or an id that contradicts ``device``,
    raises ``ValueError``; without a card it raises as ``device`` does.
    ``backend``: default NCCL on CUDA, gloo on the CPU; ``'gloo'`` with
    CUDA for ranks that share a card.

    :returns: ``(rank, world size)``
    """
    if local_device_ids is not None:
        device = _local_device(local_device_ids, device)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError('coordinator_address needs num_processes and '
                             'process_id')
        addr = coordinator_address
        init = addr if addr.startswith('tcp://') else f'tcp://{addr}'
        world, rank = int(num_processes), int(process_id)
    else:
        missing = [k for k in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR',
                               'MASTER_PORT') if k not in os.environ]
        if missing:
            raise RuntimeError(
                f'init_distributed: {", ".join(missing)} not set; launch '
                f'with torchrun --nproc-per-node=N, or pass '
                f'coordinator_address, num_processes and process_id')
        init, world = 'env://', int(os.environ['WORLD_SIZE'])
        rank = int(os.environ['RANK'])
    dev = rank_device(device, rank)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    if backend is None:
        backend = 'nccl' if dev.type == 'cuda' else 'gloo'
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    return dist.get_rank(), dist.get_world_size()


def _local_device(local_device_ids, device) -> torch.device:
    """The card ``local_device_ids`` names, checked against ``device``."""
    ids = ([local_device_ids] if isinstance(local_device_ids, int)
           else list(local_device_ids))
    if len(ids) != 1:
        raise ValueError(f'local_device_ids names one card per rank; got '
                         f'{local_device_ids!r}')
    card = torch.device('cuda', int(ids[0]))
    if device is not None:
        asked = torch.device(device)
        if asked.type != 'cuda' or asked.index not in (None, card.index):
            raise ValueError(f'local_device_ids {local_device_ids!r} names '
                             f'{card}, but device is {asked}')
    return card


def rank_device(device=None, rank: Optional[int] = None) -> torch.device:
    """This rank's device for the caller's ``device``: its type is the
    caller's (None = CUDA, raising without a card; the CPU only when asked
    for), and a CUDA device without an index is the rank's card,
    ``cuda:{LOCAL_RANK % device_count}`` (``LOCAL_RANK`` defaults to the
    rank). A device with an index stays as given."""
    dev = resolve_device(device)
    if dev.type != 'cuda' or dev.index is not None:
        return dev
    if rank is None:
        rank = _world()[1]
    local = int(os.environ.get('LOCAL_RANK', rank))
    return torch.device('cuda', local % torch.cuda.device_count())


def is_distributed() -> bool:
    """True when more than one process shares the world."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def process_shard(n: int, num_processes: Optional[int] = None,
                  process_id: Optional[int] = None) -> slice:
    """This process's contiguous, balanced share of ``n`` work items
    (the remainder spreads one-each over the first processes)."""
    world, rank = _world()
    nproc = world if num_processes is None else num_processes
    pid = rank if process_id is None else process_id
    base, rem = divmod(n, nproc)
    start = pid * base + min(pid, rem)
    return slice(start, start + base + (1 if pid < rem else 0))


def global_mesh(axes: Optional[Dict[str, int]] = None, device=None):
    """A mesh over every rank of the world; default one 'data' axis.
    ``device``: as :func:`make_mesh`'s."""
    if axes is None:
        axes = {'data': _world()[0]}
    return make_mesh(axes, device=device)


def _placements(mesh, axis: Optional[str]):
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0) if name == axis else Replicate()
            for name in mesh.mesh_dim_names]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _tensor(x, mesh) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    return t.to(mesh.device_type)


def distribute_batch(tree, mesh, axis: str = 'data'):
    """Per-rank host-local arrays as global ``DTensor``s whose leading
    dimension shards over ``axis`` (each rank contributes its own rows;
    every rank of one ``axis`` coordinate passes the same rows). Works on
    dicts, lists and tuples of arrays."""
    from torch.distributed.tensor import DTensor
    return _map(lambda x: DTensor.from_local(
        _tensor(x, mesh), mesh, _placements(mesh, axis)), tree)


def replicate(tree, mesh):
    """Arrays that are the same on every rank (model weights) as fully
    replicated ``DTensor``s on the mesh."""
    from torch.distributed.tensor import distribute_tensor
    return _map(lambda x: distribute_tensor(
        _tensor(x, mesh), mesh, _placements(mesh, None)), tree)


def local_shard(global_arr, mesh, axis: str = 'data') -> np.ndarray:
    """This rank's host-local block of a global ``DTensor`` (its leading
    dimension sharded on ``axis``; the tensor carries its mesh and
    placements, so ``mesh`` and ``axis`` only keep the reference's
    signature)."""
    return global_arr.to_local().cpu().numpy()


def predict_cohort_distributed(engine, vols, spacing_yx: Sequence[float],
                               modes: Sequence[str], mesh=None,
                               gather: bool = False) -> np.ndarray:
    """Cohort inference across processes: each rank passes ITS OWN shard
    of the cohort (counts may differ, an empty shard included;
    :func:`process_shard` splits one) and runs it through the engine's
    batched cohort program on its device.

    :param engine: an :class:`~..inference.EnsembleEngine` with the same
        weights on every rank
    :param vols: this rank's (n_local, Z, Y, X) same-shape RAI volumes
    :param mesh: a mesh whose 'data' (or first) axis spans every rank;
        default :func:`global_mesh` on the engine's device
    :param gather: return the FULL cohort's masks on every rank (rank
        order, matching :func:`process_shard`'s split) instead of only this
        rank's
    :returns: merged multilabel masks (n_local, Z, X, sum L) uint8, or the
        whole (sum n_i, ...) cohort with ``gather=True``
    """
    vols = np.ascontiguousarray(vols)
    if vols.ndim != 4:
        raise ValueError(f'expected (n, Z, Y, X) volumes, got {vols.shape}')
    n_local = int(vols.shape[0])
    if any(engine.spec.preprocess.use_mask_for_norm):
        # exact masked normalization projects on the host: each rank serves
        # its shard locally and only the gather is a collective, which an
        # empty shard must still reach (the others would wait for it)
        if n_local:
            local = engine.predict_cohort(vols, spacing_yx, modes)
        else:
            local = np.zeros((0, vols.shape[1], vols.shape[3],
                              engine.total_labels), np.uint8)
        return gather_uneven(local) if gather else local
    if mesh is None:
        mesh = global_mesh(device=engine.device)
    ax = data_axis(mesh)
    if axis_size(mesh, ax) != dist.get_world_size():
        raise ValueError('the data axis must divide evenly across processes')
    group = named(mesh, ax)
    # every rank runs one block of the largest shard's size: padding rows
    # repeat the last scan (zeros for an empty shard) and are dropped
    counts = gather_uneven(np.asarray([n_local]), group)
    block = max(1, int(counts.max()))
    if n_local < block:
        filler = (np.repeat(vols[-1:], block - n_local, axis=0) if n_local
                  else np.zeros((block,) + vols.shape[1:], vols.dtype))
        vols = np.concatenate([vols, filler]) if n_local else filler
    segs = engine.predict_cohort(vols, spacing_yx, modes)[:n_local]
    return gather_uneven(segs, group) if gather else segs
