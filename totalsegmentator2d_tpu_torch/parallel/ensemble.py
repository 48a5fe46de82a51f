"""Stacked-weights ensemble execution.

The anatomical-group models of a set share one architecture and differ in
the segmentation head's width. Padding every head to the widest group
(the engine's :func:`~..inference.ensemble_engine.pad_head`) stacks the
set into one state dict with a leading group axis. The reference vmaps one
U-Net call over that axis; here the G models run one after another, as the
engine runs them, on one device (:func:`ensemble_forward`) or with the
group axis spread over an 'ensemble' mesh axis
(:func:`ensemble_forward_sharded`: each rank runs its contiguous G/E
models, then the logits are gathered).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from ..inference.ensemble_engine import pad_head
from .collectives import all_gather_cat
from .mesh import axis_index, axis_size, named

__all__ = ['pad_head', 'stack_groups', 'ensemble_forward',
           'ensemble_forward_sharded', 'split_group_outputs',
           'merge_multilabel']


def stack_groups(group_params: Sequence[Dict[str, torch.Tensor]],
                 label_counts: Sequence[int]
                 ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Per-group state dicts stacked into one with a leading group axis,
    the heads padded to the largest label count. Returns (stacked,
    max_labels); the architectures must match up to the head."""
    max_labels = max(label_counts)
    padded = [pad_head(p, n, max_labels)
              for p, n in zip(group_params, label_counts)]
    return ({k: torch.stack([torch.as_tensor(p[k]) for p in padded])
             for k in padded[0]}, max_labels)


def _unstack(stacked: Dict[str, torch.Tensor], g: int):
    return {k: v[g] for k, v in stacked.items()}


def ensemble_forward(forward_fn: Callable, stacked_params, x: torch.Tensor
                     ) -> torch.Tensor:
    """(G-stacked state dict, (N, H, W, C)) -> (G, N, H, W, Lmax): the G
    models one after another on the shared input; ``forward_fn(state
    dict, x)``."""
    G = len(next(iter(stacked_params.values())))
    return torch.stack([forward_fn(_unstack(stacked_params, g), x)
                        for g in range(G)])


def ensemble_forward_sharded(forward_fn: Callable, stacked_params,
                             x: torch.Tensor, mesh,
                             ensemble_axis: str = 'ensemble') -> torch.Tensor:
    """:func:`ensemble_forward` with the group axis over ``ensemble_axis``:
    ``stacked_params`` is the full (G, ...) stack on every rank; each rank
    runs its contiguous G/E models and the (G, ...) logits are gathered
    over the axis (every rank returns all of them)."""
    E = axis_size(mesh, ensemble_axis)
    G = len(next(iter(stacked_params.values())))
    if not E or G % E:
        raise ValueError(f'{G} models do not divide over the '
                         f'{ensemble_axis!r} axis ({E})')
    k, e = G // E, axis_index(mesh, ensemble_axis)
    mine = {n: v[e * k:(e + 1) * k] for n, v in stacked_params.items()}
    return all_gather_cat(ensemble_forward(forward_fn, mine, x), 0,
                          named(mesh, ensemble_axis))


def split_group_outputs(logits: torch.Tensor,
                        label_counts: Sequence[int]) -> List[torch.Tensor]:
    """The padded (G, ..., Lmax) output sliced back into per-group (...,
    L_g) tensors."""
    return [logits[g, ..., :n] for g, n in enumerate(label_counts)]


def merge_multilabel(logits: torch.Tensor, label_counts: Sequence[int],
                     threshold: bool = True) -> torch.Tensor:
    """Each group's valid channels, sigmoid-thresholded (uint8) unless
    ``threshold`` is off, concatenated along the label axis."""
    parts = []
    for g, n in enumerate(label_counts):
        part = logits[g, ..., :n]
        if threshold:
            part = (torch.sigmoid(part) > 0.5).to(torch.uint8)
        parts.append(part)
    return torch.cat(parts, dim=-1)
