"""Segmentation losses (nnU-Net recipe): soft Dice + BCE per channel for
multilabel targets, soft Dice + cross-entropy for label maps, and
deep-supervision weighting; the reference package's training/losses.py on
tensors. Logits and targets are NHWC, as there: logits (N, H, W, L); a
multilabel target one-hot (N, H, W, L), a label map int (N, H, W).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F


def soft_dice_loss(logits: torch.Tensor, target: torch.Tensor,
                   multilabel: bool, smooth: float = 1e-5,
                   batch_dice: bool = False) -> torch.Tensor:
    """1 - the mean soft Dice over channels (and samples unless
    ``batch_dice``), sums over the spatial dims."""
    if multilabel:
        probs = torch.sigmoid(logits)
        tgt = target.to(probs.dtype)
    else:
        probs = torch.softmax(logits, dim=-1)
        tgt = F.one_hot(target.long(), logits.shape[-1]).to(probs.dtype)
    dims = (0, 1, 2) if batch_dice else (1, 2)
    inter = torch.sum(probs * tgt, dim=dims)
    denom = torch.sum(probs, dim=dims) + torch.sum(tgt, dim=dims)
    dice = (2 * inter + smooth) / (denom + smooth)
    return 1.0 - torch.mean(dice)


def bce_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    t = target.to(logits.dtype)
    return torch.mean(torch.clamp(logits, min=0) - logits * t
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def ce_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, target[..., None].long()))


def dice_and_ce(logits: torch.Tensor, target: torch.Tensor,
                multilabel: bool) -> torch.Tensor:
    """nnU-Net compound loss: Dice + (BCE if multilabel else CE), equal
    weights."""
    d = soft_dice_loss(logits, target, multilabel)
    c = bce_loss(logits, target) if multilabel else ce_loss(logits, target)
    return d + c


def deep_supervision_weights(n: int, device=None) -> torch.Tensor:
    """nnU-Net deep-supervision weighting: 2^-i per scale, normalized."""
    w = torch.tensor([2.0 ** (-i) for i in range(n)], dtype=torch.float32,
                     device=device)
    return w / torch.sum(w)


def deep_supervision_loss(logits_list: List[torch.Tensor],
                          target: torch.Tensor,
                          multilabel: bool) -> torch.Tensor:
    """Weighted loss over the decoder's heads (highest resolution first);
    the target is max-pooled (multilabel) or nearest-sampled (label map) to
    each head's size."""
    weights = deep_supervision_weights(len(logits_list), logits_list[0].device)
    total = 0.0
    for i, logits in enumerate(logits_list):
        tgt = _downsample_target(target, tuple(logits.shape[1:3]), multilabel)
        total = total + weights[i] * dice_and_ce(logits, tgt, multilabel)
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
