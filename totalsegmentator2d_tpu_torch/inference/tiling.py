"""Sliding-window tile grids (nnU-Net semantics) and the Gaussian
overlap-add of tile predictions.

The grid is computed on the host per input shape. :func:`accumulate_tiles`
runs the tiles in the reference program's order -- chunks of tiles, mirror
TTA batched inside a chunk, tiles added one after another -- so the fp32
sums match it term for term.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch


def compute_steps_1d(image_size: int, patch_size: int, step_frac: float) -> List[int]:
    """Evenly spread tile start positions covering [0, image_size - patch]
    with stride <= patch * step_frac (nnU-Net compute_steps_for_sliding_window)."""
    if image_size < patch_size:
        raise ValueError(f'image size {image_size} < patch size {patch_size}')
    if image_size == patch_size:
        return [0]
    target = patch_size * step_frac
    num = int(math.ceil((image_size - patch_size) / target)) + 1
    actual = (image_size - patch_size) / max(num - 1, 1)
    return [int(round(actual * i)) for i in range(num)]


def tile_positions(image_shape: Sequence[int], patch_size: Sequence[int],
                   step_frac: float = 0.5) -> np.ndarray:
    """All (y, x) tile origins as an (T, 2) int array."""
    steps = [compute_steps_1d(int(n), int(p), step_frac)
             for n, p in zip(image_shape, patch_size)]
    grid = [(y, x) for y in steps[0] for x in steps[1]]
    return np.asarray(grid, dtype=np.int32)


def padded_shape(shape: Sequence[int], patch_size: Sequence[int]) -> Tuple[int, ...]:
    """Pad the resampled image up to at least the patch size (nnU-Net pads
    symmetrically with zeros before sliding-window prediction)."""
    return tuple(max(int(n), int(p)) for n, p in zip(shape, patch_size))


def pad_amounts(shape: Sequence[int], target: Sequence[int]) -> List[Tuple[int, int]]:
    """Symmetric (before, after) pad widths per axis, nnU-Net `pad_nd_image`
    convention: before = total // 2."""
    out = []
    for n, t in zip(shape, target):
        total = int(t) - int(n)
        out.append((total // 2, total - total // 2))
    return out


def accumulate_tiles(work: torch.Tensor, tiles: np.ndarray,
                     net_batch: Callable[[torch.Tensor], torch.Tensor],
                     acc: torch.Tensor, wacc: torch.Tensor,
                     patch: Sequence[int], mirrors: Sequence[Tuple[int, ...]],
                     gauss: torch.Tensor, chunk_cap: int = 64) -> None:
    """Sliding-window Gaussian accumulation with tile x TTA batched forwards,
    channels first.

    :param work: padded input image (C, H, W)
    :param tiles: (T, 2) tile origins
    :param net_batch: (B, C, ph, pw) -> (*prefix, B, L, ph, pw) logits
    :param acc: (*prefix, L, H, W) logit accumulator, added to IN PLACE
        (the reference builds new arrays; in place saves a copy of the
        accumulator per tile and gives the same sums)
    :param wacc: (1, H, W) Gaussian weight accumulator, added to in place
    :param mirrors: TTA flip combinations over spatial axes (0=h, 1=w)
    :param gauss: (ph, pw) tile weights
    :param chunk_cap: bound on the forward batch (tiles x mirrors)
    """
    ph, pw = (int(p) for p in patch)
    M = len(mirrors)
    T = len(tiles)
    Tc = max(1, min(T, chunk_cap // M))
    dims = [tuple(a - 2 for a in m) for m in mirrors]  # h -> -2, w -> -1

    def flip(t, d):
        return torch.flip(t, d) if d else t

    for start in range(0, T, Tc):
        poss = [(int(y), int(x)) for y, x in tiles[start:start + Tc]]
        gathered = [work[:, y:y + ph, x:x + pw] for y, x in poss]
        batch = torch.stack([torch.stack([flip(t, d) for d in dims])
                             for t in gathered])          # (tc, M, C, ph, pw)
        batch = batch.reshape((len(poss) * M,) + batch.shape[2:])
        logits = net_batch(batch)                         # (*prefix, tc*M, L, ph, pw)
        logits = logits.reshape(logits.shape[:-4] + (len(poss), M)
                                + logits.shape[-3:])
        merged = flip(logits[..., 0, :, :, :], dims[0])
        for i in range(1, M):
            merged = merged + flip(logits[..., i, :, :, :], dims[i])
        merged = merged / float(M) * gauss                # (*prefix, tc, L, ph, pw)
        for t, (y, x) in enumerate(poss):
            acc[..., y:y + ph, x:x + pw] += merged[..., t, :, :, :]
            wacc[..., y:y + ph, x:x + pw] += gauss
