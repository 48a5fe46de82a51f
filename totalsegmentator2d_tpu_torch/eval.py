"""Segmentation evaluation: per-label Dice between two segmentations (the
reference package's eval.py), as an API and a CLI (``python -m
totalsegmentator2d_tpu_torch.eval pred.nrrd gt.nrrd [--device cpu]``).
Labels are matched by 3D-Slicer Segment names when present, else by value
/ channel index. The Dice sums of all matched labels are one reduction on
the device (the CUDA card unless the caller names the CPU).
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np
import torch

from .io import MedicalImage, read_image
from .ops.annotations import get_annotation_labels, get_label_mask
from .utils.device import resolve_device


def _label_masks(seg: MedicalImage) -> Dict[str, np.ndarray]:
    """{label name: binary mask}; names from Segment metadata when present,
    else 'labelN' / channel index."""
    out = {}
    annotated = get_annotation_labels(seg)
    if annotated:
        for name, info in annotated.items():
            out[name] = get_label_mask(seg, info['value']).array.astype(bool)
        return out
    if seg.ncomponents > 1:
        for c in range(seg.ncomponents):
            out[f'label{c + 1}'] = seg.array[..., c] > 0
    else:
        for v in np.unique(seg.array):
            if v != 0:
                out[f'label{int(v)}'] = seg.array == v
    return out


def dice_per_label(pred: MedicalImage, gt: MedicalImage,
                   smooth: float = 0.0, device=None) -> Dict[str, float]:
    """Per-label Dice, matched by name. Labels missing on either side score
    0.0 unless empty on both (1.0). All matched labels are stacked and
    reduced at once (float32 sums, as the reference)."""
    pm = _label_masks(pred)
    gm = _label_masks(gt)
    result: Dict[str, float] = {}
    both = []
    for name in sorted(set(pm) | set(gm)):
        p = pm.get(name)
        g = gm.get(name)
        if p is None or g is None:
            missing_empty = ((p is None or not p.any())
                             and (g is None or not g.any()))
            result[name] = 1.0 if missing_empty else 0.0
            continue
        if p.shape != g.shape:
            raise ValueError(f'Shape mismatch for {name}: {p.shape} vs {g.shape}')
        both.append(name)
    if not both:
        return result

    device = resolve_device(device)
    with torch.inference_mode():
        p_all = torch.from_numpy(np.stack([pm[n] for n in both]).astype(
            np.uint8)).to(device).float()
        g_all = torch.from_numpy(np.stack([gm[n] for n in both]).astype(
            np.uint8)).to(device).float()
        dims = tuple(range(1, p_all.ndim))
        sums = torch.stack([torch.sum(p_all * g_all, dim=dims),
                            torch.sum(p_all, dim=dims),
                            torch.sum(g_all, dim=dims)]).cpu().numpy()
    inter, ps, gs = sums
    for i, name in enumerate(both):
        denom = float(ps[i]) + float(gs[i])
        if denom + smooth == 0:
            result[name] = 1.0
        else:
            result[name] = (2.0 * float(inter[i]) + smooth) / (denom + smooth)
    return result


def evaluate(pred_path: str, gt_path: str, device=None) -> dict:
    pred = read_image(pred_path)
    gt = read_image(gt_path)
    scores = dice_per_label(pred, gt, device=device)
    return {
        'labels': scores,
        'mean_dice': float(np.mean(list(scores.values()))) if scores else 1.0,
        'n_labels': len(scores),
    }


def main(argv=None) -> None:
    import argparse
    parser = argparse.ArgumentParser(
        description='Per-label Dice between a predicted and a ground-truth '
                    'segmentation (labels matched by Segment metadata names).')
    parser.add_argument('pred', help='predicted segmentation image')
    parser.add_argument('gt', help='ground-truth segmentation image')
    parser.add_argument('--device', default=None,
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    print(json.dumps(evaluate(args.pred, args.gt, device=args.device),
                     indent=2))


if __name__ == '__main__':
    main()
