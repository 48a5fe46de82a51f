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
