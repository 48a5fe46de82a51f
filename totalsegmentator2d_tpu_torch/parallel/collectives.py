"""The port's collectives, written from ``all_reduce``, ``all_gather`` and
``broadcast`` only: gloo has no reduce-scatter and, for CUDA tensors, may
lack all-to-all, whose use makes ``torch.distributed.nn.functional``'s
gather unusable on gloo ranks that share one card.

Tensor parallelism over channels (training/parallel.py) uses the pair
Megatron-LM calls f and g around every layer whose output channels shard:

- :func:`enter_shard` (f): identity forward; backward ``all_reduce(SUM)``
  of the input gradient, whose partial sums come from each rank's channel
  shard of the layer;
- :func:`gather_shards` (g): ``all_gather`` of the channel shards into the
  full activation; backward this rank's slice of the gradient, which every
  rank holds whole, because what follows the gather runs replicated.

Together they are the gradient-carrying gather: the ``all_reduce(SUM)`` of
a layer's full input gradient, then this rank's share of its output's.

Height sharding (training's ``spatial=True``) splits every activation into
row slabs, one per rank of the group, and uses three more:

- :func:`halo_rows`: a slab with its neighbours' border rows on top and
  below (zero rows at the image's top and bottom: a conv's SAME zero
  padding); backward each halo row's gradient goes back to its owner,
  which adds it to its own rows;
- :func:`sum_stats` (InstanceNorm statistics): ``all_reduce`` forward,
  ``all_reduce(SUM)`` of the gradient backward. The statistics normalise
  each rank's OWN rows, so each rank holds only its part of dL/dstat;
- :func:`sum_loss_terms` (the loss's sums): ``all_reduce`` forward,
  identity backward. Every rank computes the same loss from the same
  global sums, so dL/dsum is already whole on each rank; a summing
  backward would count the gradient once per rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def _comm(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` where the group's backend takes it: NCCL only moves CUDA
    tensors, gloo either (a CUDA tensor through the host)."""
    if dist.get_backend(group) == 'nccl' and t.device.type != 'cuda':
        return t.cuda()
    return t


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum of ``t`` over the group, on ``t``'s device; ``t``
    itself is left as it was."""
    buf = _comm(t.detach().clone(), group)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device)


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks) concatenated along
    ``dim`` in rank order, on ``t``'s device. Not differentiable."""
    device = t.device
    t = _comm(t.detach().contiguous(), group)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim).to(device)


def gather_uneven(local: np.ndarray, group=None) -> np.ndarray:
    """Every rank's host block of UNEQUAL first-dimension length,
    concatenated in rank order: the counts first, then the blocks padded
    to the largest, gathered and trimmed. Every rank of the group must
    call it, an empty block included."""
    count = torch.tensor([local.shape[0]], dtype=torch.int64)
    counts = all_gather_cat(count, 0, group).cpu().numpy()
    m = int(counts.max())
    block = np.zeros((m,) + local.shape[1:], local.dtype)
    block[:local.shape[0]] = local
    everyone = all_gather_cat(torch.from_numpy(block)[None], 0, group)
    everyone = everyone.cpu().numpy()
    return np.concatenate([everyone[p, :counts[p]]
                           for p in range(len(counts))])


class _EnterShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.rank = dim, dist.get_rank(group)
        ctx.n = x.shape[dim]
        return all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def enter_shard(x: torch.Tensor, group) -> torch.Tensor:
    """f: the input of a channel-sharded layer (identity forward; backward
    the sum of the ranks' input gradients)."""
    return _EnterShard.apply(x, group)


def gather_shards(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """g: the full activation from every rank's channel shard along
    ``dim`` (backward: this rank's slice of the gradient)."""
    return _GatherShards.apply(x, dim, group)


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, above, below, group):
        ctx.above, ctx.below, ctx.group = above, below, group
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        h = x.shape[2]
        # what the neighbours need of this slab: its top rows (the rank
        # above takes them as its lower halo), then its bottom rows
        edges = all_gather_cat(torch.cat([x[:, :, :below],
                                          x[:, :, h - above:]], 2)[None],
                               0, group)
        top = (edges[rank - 1, :, :, below:] if rank > 0 else
               x.new_zeros(x.shape[:2] + (above, x.shape[3])))
        bottom = (edges[rank + 1, :, :, :below] if rank < world - 1 else
                  x.new_zeros(x.shape[:2] + (below, x.shape[3])))
        return torch.cat([top, x, bottom], 2)

    @staticmethod
    def backward(ctx, grad):
        above, below, group = ctx.above, ctx.below, ctx.group
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        h = grad.shape[2] - above - below
        # the halos' gradients, sent back: the top halo's to the rank above
        # (its bottom rows), the lower halo's to the rank below (its top)
        back = all_gather_cat(torch.cat([grad[:, :, :above],
                                         grad[:, :, above + h:]], 2)[None],
                              0, group)
        gx = grad[:, :, above:above + h].clone()
        if rank < world - 1 and above:
            gx[:, :, h - above:] += back[rank + 1, :, :, :above]
        if rank > 0 and below:
            gx[:, :, :below] += back[rank - 1, :, :, above:]
        return gx, None, None, None


class _SumStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


class _SumLossTerms(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def halo_rows(x: torch.Tensor, above: int, below: int, group) -> torch.Tensor:
    """This rank's (N, C, h, W) slab with ``above`` rows of the previous
    rank's slab on top and ``below`` rows of the next rank's below it; the
    first rank gets zero rows on top, the last zero rows below. Every slab
    must hold at least ``max(above, below)`` rows."""
    return _HaloRows.apply(x, above, below, group)


def sum_stats(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's partial statistics ``t``, for statistics
    that normalise each rank's own rows: backward sums the ranks' parts of
    the gradient."""
    return _SumStats.apply(t, group)


def sum_loss_terms(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's partial loss sums ``t``, for a loss that
    every rank computes alike from the sums: backward passes the (already
    whole) gradient through."""
    return _SumLossTerms.apply(t, group)
