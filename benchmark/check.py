"""The comparison that decides ``correct``: each sampled mask the window
produced against the plain reference's logits for the same image (a CT
volume, whose coronal projection the models read, or a native 2D
radiograph).

A voxel of a label flips where the program's mask and the reference's
decision (logit > 0, i.e. sigmoid > 0.5) differ. Two numbers are compared,
each with a limit of the cell's own (``benchmark/workloads/<cell>.json``):

- ``worst_flip_logit``: the largest |reference logit| at a flipped voxel,
  over the sample: how far from the decision boundary the program erred
  (infinite where it marked a voxel outside the crop, or the masks differ
  in shape);
- ``flip_share``: flipped voxels over all voxels of the sample.

A program that rounds as the configuration states flips only voxels whose
logit lies near 0; one that computes coarser, or drops or alters part of
the work, flips voxels far from it, or many more.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from . import reference

# what stands for an infinite gap in the result's JSON line
INFINITE = 1e300


def scan_gaps(mask: np.ndarray, logits: torch.Tensor) -> Dict[str, float]:
    """One scan's masks against the reference: the program's (H, W, L) 0/1
    mask against the reference's (H, W, L) logits. Returns worst, flips,
    voxels and the reference's foreground voxels."""
    voxels = int(np.prod(logits.shape))
    decision = logits > 0
    fg = int(decision.sum())
    if tuple(mask.shape) != tuple(logits.shape):
        return {'worst': math.inf, 'flips': voxels, 'voxels': voxels, 'fg': fg}
    flipped = torch.from_numpy(np.ascontiguousarray(mask)).to(
        logits.device).bool() != decision
    flips = int(flipped.sum())
    worst = float(logits.abs()[flipped].max()) if flips else 0.0
    return {'worst': worst, 'flips': flips, 'voxels': voxels, 'fg': fg}


def compare(sample: Dict[int, np.ndarray], images: list, spacing,
            config: dict, groups, quant: Optional[str] = None) -> dict:
    """Every sampled mask against the reference, one group's labels at a
    time; with ``quant`` the reference at that precision stands in the
    program's place (the control). ``spacing``: the mix's, in ITK order (a
    CT's x, y, z; a radiograph's x, y). Returns the numbers compared and
    the reference's foreground share."""
    worst, flips, voxels, fg = 0.0, 0, 0, []
    kw = dict(patch=tuple(config['patch_size']),
              plan_spacing=tuple(config['spacing']),
              step=config['tile_step_size'],
              mirror_axes=tuple(config['mirror_axes']))
    labels = sum(config['groups'].values())
    for v, seg in sorted(sample.items()):
        arr, spacing_yx = reference.model_input(images[v], spacing)
        if quant is not None:
            seg = np.concatenate([
                (lg > 0).to(torch.uint8).cpu().numpy() for lg in
                reference.group_logits(arr, spacing_yx, groups, quant=quant,
                                       **kw)], axis=-1)
        mask = seg[:, 0] if seg.ndim == 4 else seg
        whole = tuple(mask.shape) == arr.shape[:2] + (labels,)
        at, scan_voxels, scan_fg = 0, 0, 0
        for ref in reference.group_logits(arr, spacing_yx, groups, **kw):
            n = ref.shape[-1]
            # a mask of the wrong shape flips every voxel of every group
            g = scan_gaps(mask[..., at:at + n] if whole else mask[..., :0],
                          ref)
            worst = max(worst, g['worst'])
            flips += g['flips']
            scan_voxels += g['voxels']
            scan_fg += g['fg']
            at += n
            del ref
        voxels += scan_voxels
        fg.append(scan_fg / scan_voxels)
    return {'worst_flip_logit': worst,
            'flip_share': flips / voxels if voxels else math.inf,
            'scans_compared': len(sample),
            'reference_foreground': float(np.mean(fg)) if fg else 0.0}


def verdict(numbers: dict, limits: Dict[str, float], failed: int,
            volumes: int) -> dict:
    """{name: {value, limit}} of each number compared, last the scans that
    failed (limit 0) and the volumes without a sampled result (limit 0)."""
    out = {}
    for name, limit in limits.items():
        value = numbers[name]
        out[name] = {'value': value if math.isfinite(value) else INFINITE,
                     'limit': limit}
    out['failed_scans'] = {'value': failed, 'limit': 0}
    out['volumes_unchecked'] = {
        'value': volumes - numbers['scans_compared'], 'limit': 0}
    return out


def passes(checks: dict) -> bool:
    return all(c['value'] <= c['limit'] for c in checks.values())
