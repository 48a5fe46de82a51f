"""Training over a mesh: how a trainer's state lies on the ranks, and the
tensor-parallel forward's gate (the reference's ``build_sharded_train_step``
shardings, with the collectives written out).

- **data**: every rank holds the global batch and takes its rows; the
  gradients, and the loss beside them, are summed over the data group in
  one ``all_reduce`` and divided by its size, so the step and its loss are
  the global batch's (the loss is a mean over samples: a per-sample Dice,
  BCE or CE, deep supervision a fixed weighting of such means).
- **model**: every conv, transposed conv and head whose output channels
  divide by the axis holds its channel shard (parallel/sharding.py rules);
  the InstanceNorm and the LeakyReLU after it are per channel and run on
  the shard; the gradient-carrying gather (parallel/collectives.py) makes
  the full activation for what follows. Leaves that do not divide (a
  3-label head under model=2) are replicated, and every rank of the axis
  computes them alike. Momentum buffers live beside their weights' shards.
- **ensemble**: each rank trains its contiguous G/E models of the stack;
  the (G,) losses are gathered.

Height sharding (the reference's ``spatial=True``) turns the 'model' axis
from channels to image rows: the weights are whole on every rank of it,
and each rank takes its height slab of its data rows
(parallel/sharding.height_slab: whole blocks of the total stride, as even
as the blocks allow). The forward runs with the axis as its height group
(``UNet.forward_train(group=)``: a halo exchange before every 3x3 conv,
InstanceNorm statistics reduced over the group), and so does the loss,
which is the whole image's on every rank. Each rank's gradients are its
rows' part: they are summed over the model axis and meaned over the data
axis in one ``all_reduce`` over the data x model ranks. The mesh must
have a 'data' and a 'model' axis, as the reference's batch sharding
``P('data', 'model', None, None)`` must.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import math

import torch
import torch.distributed as dist
import torch.nn as nn

from ..models.unet import ConvNormAct, UNet
from ..parallel.collectives import all_gather_cat, enter_shard, gather_shards
from ..parallel.mesh import axis_index, axis_size, mesh_key, named
from ..parallel.sharding import (batch_sharding, channel_dim, height_slab,
                                 local_slice, param_shardings, shard_params)


class ShardLayout:
    """Where a trainer's models, their weights and their batch rows lie on
    a mesh's 'data', 'model' and (for a stacked ensemble) 'ensemble' axes,
    and the collectives that gather and slice them. Axes the mesh lacks
    count as size 1; an 'ensemble' axis without a stacked ensemble
    replicates. ``spatial``: the 'model' axis shards image rows (in slabs
    of whole blocks of ``stride``, the U-Net's total height stride), not
    channels."""

    def __init__(self, mesh, n_models: int, ensemble: bool,
                 spatial: bool = False, stride: int = 1):
        missing = [a for a in ('data', 'model')
                   if not axis_size(mesh, a)] if spatial else []
        if missing:
            raise ValueError(f"spatial=True shards the batch over 'data' and "
                             f"'model': the mesh {tuple(mesh.mesh_dim_names)} "
                             f"has no {' or '.join(map(repr, missing))} axis")
        self.mesh = mesh
        self.spatial = spatial
        self.D = axis_size(mesh, 'data') or 1
        self.M = axis_size(mesh, 'model') or 1
        self.E = (axis_size(mesh, 'ensemble') or 1) if ensemble else 1
        if n_models % self.E:
            raise ValueError(f'{n_models} models do not divide over the '
                             f"'ensemble' axis ({self.E})")
        self.data_group = named(mesh, 'data') if self.D > 1 else None
        self.model_group = named(mesh, 'model') if self.M > 1 else None
        self.ens_group = named(mesh, 'ensemble') if self.E > 1 else None
        e = axis_index(mesh, 'ensemble') if self.E > 1 else 0
        k = n_models // self.E
        self.members = list(range(e * k, (e + 1) * k))
        self.n_models = n_models
        self.model_axis = 'model' if self.M > 1 and not spatial else None
        self.specs: Dict[str, tuple] = {}
        # this rank's block of a global batch: its members of a (G, N, ...)
        # stack, its rows of the N (and its height slab of them)
        self.take = batch_sharding(mesh, 'data', ensemble_axis='ensemble',
                                   stacked=ensemble)
        # the height group of the forward and the loss, and the ranks that
        # sum the gradients (a data x model group under height sharding)
        self.height_group = None
        self.grad_group = self.data_group
        if spatial and self.M > 1:
            self.height_group = self.model_group
            self.grad_group = _flat_group(mesh, ('data', 'model'))
            rows, m, h_dim = self.take, axis_index(mesh, 'model'), \
                2 if ensemble else 1

            def take(x: torch.Tensor) -> torch.Tensor:
                x = rows(x)
                start, size = height_slab(x.shape[h_dim], stride, self.M, m)
                return x.narrow(h_dim, start, size)

            self.take = take

    # -- weights -------------------------------------------------------------

    def shard(self, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's slices of one model's full state dict."""
        if not self.specs:
            self.specs = param_shardings(sd, self.mesh, self.model_axis)
        return shard_params(sd, self.mesh, self.model_axis)

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole leaf ``name`` (or a tensor laid
        out like it, a momentum buffer)."""
        return local_slice(t, self.specs[name], self.mesh)

    def sharded(self, name: str) -> bool:
        return any(a is not None for a in self.specs[name])

    def load_local(self, model: UNet, sd: Dict[str, torch.Tensor]) -> None:
        """Replace the module's parameters by this rank's slices of ``sd``
        (a full state dict): the sharded layers then compute their shard."""
        for name, t in self.shard(sd).items():
            mod, _, attr = name.rpartition('.')
            setattr(model.get_submodule(mod), attr,
                    nn.Parameter(t.clone().contiguous()))

    def gate(self, model: UNet):
        """The gate of :meth:`UNet.forward_train` for a model holding
        channel shards: each sharded block, transposed conv and head runs
        on the full input (``enter_shard``) and its shard of the output is
        gathered (``gather_shards``) into the full activation. None without
        a model axis, or when it shards rows."""
        if self.model_axis is None:
            return None
        sharded, group = self.sharded_modules(model), self.model_group

        def gate(module, fn, t):
            if module not in sharded:
                return fn(t)
            return gather_shards(fn(enter_shard(t, group)), 1, group)

        return gate

    def sharded_modules(self, model: UNet) -> set:
        """The blocks, transposed convs and heads whose outputs shard."""
        out = set()
        for name, mod in model.named_modules():
            if isinstance(mod, ConvNormAct):
                key = name + '.conv.weight'
            elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)) and \
                    name.startswith('decoder.'):
                key = name + '.weight'   # a transposed conv or a head
            else:
                continue
            if self.sharded(key):
                out.add(mod)
        return out

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole leaf ``name`` from this rank's slice (or a tensor laid
        out like it, a momentum buffer). Collective over the model axis."""
        if self.model_group is None or not self.sharded(name):
            return t.detach()
        return all_gather_cat(t, channel_dim(name), self.model_group)

    def gather_models(self, local: Sequence[dict]) -> List[dict]:
        """Per-member dicts of full tensors (this rank's members) -> all G
        members' in stack order. Collective over the ensemble axis."""
        if self.ens_group is None:
            return list(local)
        out: List[Optional[dict]] = [None] * self.n_models
        k = len(self.members)
        for j in range(k):
            stacked = {n: all_gather_cat(v[None], 0, self.ens_group)
                       for n, v in local[j].items()}
            for e in range(self.E):
                out[e * k + j] = {n: v[e] for n, v in stacked.items()}
        return out

    # -- the step --------------------------------------------------------------

    def sync(self, model: UNet, loss: torch.Tensor) -> torch.Tensor:
        """Mean the gradients and the loss over the data group in one
        ``all_reduce``; returns the global loss. Under height sharding the
        one ``all_reduce`` runs over the data x model ranks: each rank's
        gradients are its rows' part, and its loss is already its data
        rows' whole loss (so the sum holds M copies of it)."""
        if self.grad_group is None:
            return loss.detach()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [loss.detach().reshape(1)])
        dist.all_reduce(flat, group=self.grad_group)
        flat /= self.D
        i = 0
        for g in grads:
            g.copy_(flat[i:i + g.numel()].view_as(g))
            i += g.numel()
        return flat[-1] / self.M if self.height_group is not None \
            else flat[-1]

    def gather_losses(self, losses: torch.Tensor) -> torch.Tensor:
        """This rank's members' losses -> the (G,) losses."""
        if self.ens_group is None:
            return losses
        return all_gather_cat(losses, 0, self.ens_group)


# (world group, mesh_key, axes) -> the flat group built for them
_FLAT_GROUPS: Dict[tuple, object] = {}


def _flat_group(mesh, axes):
    """The process group of the ranks that share this rank's coordinates on
    every axis of ``mesh`` but ``axes``: the world's own group when ``axes``
    are all of them, else built once per world, mesh layout and axes
    (collective the first time: every rank builds every such group, in the
    same order)."""
    names = list(mesh.mesh_dim_names)
    keep = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in keep]
    if all(mesh.mesh.shape[i] == 1 for i in rest):
        return dist.group.WORLD
    key = (dist.group.WORLD, mesh_key(mesh), tuple(axes))
    if key not in _FLAT_GROUPS:
        size = math.prod(mesh.mesh.shape[i] for i in keep)
        ranks = mesh.mesh.permute(rest + keep).reshape(-1, size)
        _FLAT_GROUPS[key], _ = dist.new_subgroups_by_enumeration(
            ranks.tolist())
    return _FLAT_GROUPS[key]
