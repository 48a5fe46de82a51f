"""Sliding-window tile grids (nnU-Net semantics) and the Gaussian
overlap-add of tile predictions.

The grid is computed on the host per input shape. :func:`accumulate_tiles`
runs the tiles in the reference program's order -- chunks of tiles, mirror
TTA batched inside a chunk, tiles added one after another -- so the fp32
sums match it term for term, for one scan or for a batch of scans.
:func:`accumulate_tiles_sharded` spreads one scan's grid over the ranks of
a mesh axis (the reference's tile-sharded program).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

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
                     gauss: torch.Tensor, chunk_cap: int = 64,
                     valid: Optional[torch.Tensor] = None) -> None:
    """Sliding-window Gaussian accumulation with tile x TTA batched forwards,
    channels first. A batch of scans (a leading axis S on ``work`` and
    ``acc``) either shares one tile grid, or has a grid per scan (``tiles``
    (S, T, 2)) and a weight map per scan (``wacc`` (S, 1, H, W)): each
    forward takes the same number of tiles from every scan, S x tc x M
    images, so a scan with fewer tiles than another pads its grid with
    tiles of validity 0, which run and add nothing.

    :param work: padded input image (C, H, W), or a batch (S, C, H, W)
    :param tiles: (T, 2) tile origins, or (S, T, 2) per scan of a batch
    :param net_batch: (B, C, ph, pw) -> (*prefix, B, L, ph, pw) logits
    :param acc: (*prefix, L, H, W) logit accumulator, or (*prefix, S, L, H,
        W) for a batch, added to IN PLACE (the reference builds new arrays;
        in place saves a copy of the accumulator per tile and gives the
        same sums)
    :param wacc: (1, H, W) Gaussian weight accumulator, added to in place
        (one for every scan of a batch that shares its grid), or (S, 1, H,
        W) with per-scan grids
    :param mirrors: TTA flip combinations over spatial axes (0=h, 1=w)
    :param gauss: (ph, pw) tile weights
    :param chunk_cap: bound on one scan's forward batch (tiles x mirrors)
    :param valid: (T,) or (S, T) tile weights on the device that scale the
        Gaussian (0 disables a padding tile); None = every tile at weight 1
    """
    ph, pw = (int(p) for p in patch)
    lead = tuple(work.shape[:-3])
    per_scan = np.ndim(tiles) == 3
    M = len(mirrors)
    T = np.shape(tiles)[-2]
    Tc = max(1, min(T, chunk_cap // M))
    dims = [tuple(a - 2 for a in m) for m in mirrors]  # h -> -2, w -> -1

    def flip(t, d):
        return torch.flip(t, d) if d else t

    def origins(sl):
        """[(scan or None, [(y, x), ...])] of one chunk."""
        if not per_scan:
            return [(None, [(int(y), int(x)) for y, x in tiles[sl]])]
        return [(s, [(int(y), int(x)) for y, x in grid[sl]])
                for s, grid in enumerate(tiles)]

    for start in range(0, T, Tc):
        sl = slice(start, start + Tc)
        chunk = origins(sl)
        if per_scan:  # (S, tc, C, ph, pw): each scan's own tiles
            gathered = torch.stack([torch.stack(
                [work[s, :, y:y + ph, x:x + pw] for y, x in poss])
                for s, poss in chunk])
        else:
            gathered = torch.stack([work[..., y:y + ph, x:x + pw]
                                    for y, x in chunk[0][1]], dim=-4)
        batch = torch.stack([flip(gathered, d) for d in dims],
                            dim=-4)                       # (*lead, tc, M, C, ph, pw)
        tc = batch.shape[-5]
        batch = batch.reshape((-1,) + batch.shape[-3:])
        logits = net_batch(batch)                         # (*prefix, n, L, ph, pw)
        logits = logits.reshape(logits.shape[:-4] + lead + (tc, M)
                                + logits.shape[-3:])
        merged = flip(logits[..., 0, :, :, :], dims[0])
        for i in range(1, M):
            merged = merged + flip(logits[..., i, :, :, :], dims[i])
        # the Gaussian, scaled per tile by its validity: (*lead, tc, 1, ph, pw)
        g = gauss if valid is None else gauss * valid[..., sl, None, None, None]
        merged = merged / float(M) * g                    # (*prefix, *lead, tc, L, ph, pw)
        for s, poss in chunk:
            for t, (y, x) in enumerate(poss):
                if s is None:
                    acc[..., y:y + ph, x:x + pw] += merged[..., t, :, :, :]
                    wacc[..., y:y + ph, x:x + pw] += (
                        gauss if valid is None else g[..., t, :, :, :])
                else:
                    acc[..., s, :, y:y + ph, x:x + pw] += merged[..., s, t, :, :, :]
                    wacc[s, :, y:y + ph, x:x + pw] += (
                        gauss if valid is None else g[s, t])


def accumulate_tiles_sharded(work: torch.Tensor, tiles: np.ndarray,
                             net_batch: Callable[[torch.Tensor], torch.Tensor],
                             acc: torch.Tensor, wacc: torch.Tensor, mesh,
                             axis: str, **kw) -> None:
    """:func:`accumulate_tiles` of one scan over the D ranks of the mesh
    axis ``axis``: the grid is padded to a multiple of D with tiles of
    validity 0, each rank accumulates its contiguous share, and the partial
    ``acc`` and ``wacc`` are summed over the axis's process group in place
    (the reference's shard_map with a psum). Every rank of the axis calls
    it with the same scan."""
    import torch.distributed as dist

    from ..parallel.mesh import axis_index, axis_size, named
    D, r = axis_size(mesh, axis), axis_index(mesh, axis)
    T = len(tiles)
    k = -(-T // D)
    padded = np.zeros((k * D, 2), np.int32)
    padded[:T] = tiles
    valid = np.zeros(k * D, np.float32)
    valid[:T] = 1.0
    mine = slice(r * k, (r + 1) * k)
    accumulate_tiles(work, padded[mine], net_batch, acc, wacc,
                     valid=torch.as_tensor(valid[mine], device=work.device),
                     **kw)
    group = named(mesh, axis)
    dist.all_reduce(acc, group=group)
    dist.all_reduce(wacc, group=group)
