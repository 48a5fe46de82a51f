"""Sharding rules for U-Net state dicts and batches.

Tensor parallelism for a conv net: every weight shards on its OUTPUT
channels (``Conv2d`` (O, I, kh, kw) on dim 0, ``ConvTranspose2d`` (I, O,
kh, kw) on dim 1), biases and norm affines on their channel. Data
parallelism takes a rank's rows of the leading batch axis. The ensemble
axis takes a rank's contiguous block of the leading stack axis of every
leaf. An axis that does not divide (a 3-label head under model=2)
replicates, the reference's rule.

A spec is a tuple with one entry per dimension: a mesh axis name or None,
as the reference's ``PartitionSpec``; :func:`shard_params` applies it and
returns this rank's local slices.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from .mesh import axis_index, axis_size


def channel_dim(name: str) -> int:
    """The output-channel dimension of a state-dict leaf: 1 for a
    transposed conv's weight (I, O, kh, kw), else 0."""
    return 1 if name.startswith('decoder.transpconvs.') and \
        name.endswith('.weight') else 0


def param_spec(shape: Sequence[int], mesh, model_axis: Optional[str],
               ensemble_axis: Optional[str] = None, stacked: bool = False,
               channel: int = 0) -> Tuple[Optional[str], ...]:
    """The spec of one leaf: its output-channel dim ``channel`` (counted
    after a stack axis) on the model axis, a leading stack axis on the
    ensemble axis; dims that do not divide replicate."""
    ndim = len(shape)
    ens = axis_size(mesh, ensemble_axis)
    mdl = axis_size(mesh, model_axis)
    spec = [None] * ndim
    i0 = 0
    if stacked and ndim >= 1:
        if ens and shape[0] % ens == 0:
            spec[0] = ensemble_axis
        i0 = 1
    c = i0 + channel
    if c < ndim and mdl and shape[c] % mdl == 0:
        spec[c] = model_axis
    return tuple(spec)


def param_shardings(params: Dict[str, torch.Tensor], mesh,
                    model_axis: Optional[str] = 'model',
                    ensemble_axis: Optional[str] = None,
                    stacked: bool = False) -> Dict[str, Tuple]:
    """The spec of every leaf of a state dict (stacked: (G, ...) leaves)."""
    return {k: param_spec(tuple(v.shape), mesh, model_axis, ensemble_axis,
                          stacked, channel_dim(k))
            for k, v in params.items()}


def local_slice(t: torch.Tensor, spec: Tuple, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = t.shape[dim] // axis_size(mesh, axis)
            t = t.narrow(dim, axis_index(mesh, axis) * n, n)
    return t.contiguous()


def shard_params(params: Dict[str, torch.Tensor], mesh,
                 model_axis: Optional[str] = 'model',
                 ensemble_axis: Optional[str] = None,
                 stacked: bool = False) -> Dict[str, torch.Tensor]:
    """This rank's local slices of a state dict under
    :func:`param_shardings`."""
    specs = param_shardings(params, mesh, model_axis, ensemble_axis, stacked)
    return {k: local_slice(v, specs[k], mesh) for k, v in params.items()}


def height_slab(h: int, stride: int, parts: int, index: int
                ) -> Tuple[int, int]:
    """(first row, rows) of slab ``index`` of ``parts`` over an image of
    ``h`` rows: whole blocks of ``stride`` rows (the U-Net's total stride,
    so every level's slab is whole), split as evenly as the blocks allow,
    the first slabs one block larger (h = 36, stride 4, 2 parts: 20 and 16
    rows). Raises ValueError when ``h`` is not a multiple of ``stride`` or
    holds fewer blocks than ``parts``."""
    if h % stride:
        raise ValueError(f'height {h} is not a multiple of the total stride '
                         f'{stride}')
    blocks = h // stride
    if blocks < parts:
        raise ValueError(f'height {h} holds {blocks} blocks of the total '
                         f'stride {stride}, fewer than the {parts} height '
                         f'shards')
    base, extra = divmod(blocks, parts)
    return ((index * base + min(index, extra)) * stride,
            (base + (index < extra)) * stride)


def batch_sharding(mesh, data_axis: str = 'data', ndim: int = 4,
                   ensemble_axis: Optional[str] = None,
                   stacked: bool = False) -> Callable:
    """This rank's rows of an (N, H, W, C) batch (``ndim`` dims; with
    ``stacked``, of a (G, N, ...) batch, the ensemble axis on G): a
    function of the global array that returns its local block. Dims that
    a present axis does not divide raise."""
    lead = (ensemble_axis if ensemble_axis and axis_size(mesh, ensemble_axis)
            else None,) if stacked else ()
    spec = lead + ((data_axis if axis_size(mesh, data_axis) else None,)
                   + (None,) * (ndim - 1))

    def take(x):
        for dim, axis in enumerate(spec):
            if axis is not None and x.shape[dim] % axis_size(mesh, axis):
                raise ValueError(f'dim {dim} of {tuple(x.shape)} does not '
                                 f'divide over {axis!r} '
                                 f'({axis_size(mesh, axis)})')
        return local_slice(x, spec, mesh) if isinstance(x, torch.Tensor) else \
            local_slice(torch.from_numpy(x), spec, mesh).numpy()

    return take
