"""Segmentation losses (nnU-Net recipe): soft Dice + BCE per channel for
multilabel targets, soft Dice + cross-entropy for label maps, and
deep-supervision weighting; the reference package's training/losses.py on
tensors. Logits and targets are NHWC, as there: logits (N, H, W, L); a
multilabel target one-hot (N, H, W, L), a label map int (N, H, W).

Each loss takes an optional height ``group`` (training's ``spatial=True``):
the logits and target are this rank's row slab, and the loss is the whole
image's, from sums reduced over the group before any ratio or division
(parallel/collectives.sum_loss_terms, whose backward passes the gradient
through: every rank computes the same loss). The deep-supervision targets'
block max and nearest pooling stay local: every slab's height is a
multiple of the total stride.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F


def _group_sum(t: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return t
    from ..parallel.collectives import sum_loss_terms
    return sum_loss_terms(t, group)


def _mean(t: torch.Tensor, group) -> torch.Tensor:
    """The mean of every rank's elements of ``t``."""
    if group is None:
        return torch.mean(t)
    tot = _group_sum(torch.stack([t.sum(), t.new_tensor(float(t.numel()))]),
                     group)
    return tot[0] / tot[1]


def soft_dice_loss(logits: torch.Tensor, target: torch.Tensor,
                   multilabel: bool, smooth: float = 1e-5,
                   batch_dice: bool = False, group=None) -> torch.Tensor:
    """1 - the mean soft Dice over channels (and samples unless
    ``batch_dice``), sums over the spatial dims (and the ``group``'s
    slabs, before the ratio)."""
    if multilabel:
        probs = torch.sigmoid(logits)
        tgt = target.to(probs.dtype)
    else:
        probs = torch.softmax(logits, dim=-1)
        tgt = F.one_hot(target.long(), logits.shape[-1]).to(probs.dtype)
    dims = (0, 1, 2) if batch_dice else (1, 2)
    sums = torch.stack([torch.sum(probs * tgt, dim=dims),
                        torch.sum(probs, dim=dims), torch.sum(tgt, dim=dims)])
    inter, psum, tsum = _group_sum(sums, group)
    dice = (2 * inter + smooth) / (psum + tsum + smooth)
    return 1.0 - torch.mean(dice)


def bce_loss(logits: torch.Tensor, target: torch.Tensor,
             group=None) -> torch.Tensor:
    t = target.to(logits.dtype)
    return _mean(torch.clamp(logits, min=0) - logits * t
                 + torch.log1p(torch.exp(-torch.abs(logits))), group)


def ce_loss(logits: torch.Tensor, target: torch.Tensor,
            group=None) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -_mean(torch.gather(logp, -1, target[..., None].long()), group)


def dice_and_ce(logits: torch.Tensor, target: torch.Tensor,
                multilabel: bool, group=None) -> torch.Tensor:
    """nnU-Net compound loss: Dice + (BCE if multilabel else CE), equal
    weights."""
    d = soft_dice_loss(logits, target, multilabel, group=group)
    c = (bce_loss(logits, target, group) if multilabel
         else ce_loss(logits, target, group))
    return d + c


def deep_supervision_weights(n: int, device=None) -> torch.Tensor:
    """nnU-Net deep-supervision weighting: 2^-i per scale, normalized."""
    w = torch.tensor([2.0 ** (-i) for i in range(n)], dtype=torch.float32,
                     device=device)
    return w / torch.sum(w)


def deep_supervision_loss(logits_list: List[torch.Tensor],
                          target: torch.Tensor,
                          multilabel: bool, group=None) -> torch.Tensor:
    """Weighted loss over the decoder's heads (highest resolution first);
    the target is max-pooled (multilabel) or nearest-sampled (label map) to
    each head's size."""
    weights = deep_supervision_weights(len(logits_list), logits_list[0].device)
    total = 0.0
    for i, logits in enumerate(logits_list):
        tgt = _downsample_target(target, tuple(logits.shape[1:3]), multilabel)
        total = total + weights[i] * dice_and_ce(logits, tgt, multilabel,
                                                 group)
    return total


def _downsample_target(target: torch.Tensor, hw: Sequence[int],
                       multilabel: bool) -> torch.Tensor:
    th, tw = target.shape[1:3]
    oh, ow = hw
    if (th, tw) == (oh, ow):
        return target
    fy, fx = th // oh, tw // ow
    if multilabel:
        t = target.reshape(target.shape[0], oh, fy, ow, fx, target.shape[-1])
        return torch.amax(t, dim=(2, 4))
    t = target.reshape(target.shape[0], oh, fy, ow, fx)
    return t[:, :, 0, :, 0]  # nearest-neighbour label downsampling


def dice_score(pred: torch.Tensor, target: torch.Tensor,
               smooth: float = 1e-5) -> torch.Tensor:
    """Per-channel binary Dice of hard predictions (channels last)."""
    p = pred.float()
    t = target.float()
    dims = tuple(range(p.ndim - 1))
    inter = torch.sum(p * t, dim=dims)
    denom = torch.sum(p, dim=dims) + torch.sum(t, dim=dims)
    return (2 * inter + smooth) / (denom + smooth)
