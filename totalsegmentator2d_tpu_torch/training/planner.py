"""Experiment planning: dataset fingerprint -> plans.json (numpy, the
reference package's training/planner.py).

The original tool consumes plans produced by nnU-Net's ExperimentPlanner;
this is the in-tree equivalent for 2D:
it fingerprints a dataset (spacings, shapes, foreground intensity
statistics), derives the target spacing / patch size / network depth with
the same heuristics family (median spacing, power-of-two patch covering the
median shape, stages until the feature map is ~4-8 px, features doubling
capped at 512), and emits a plans dict + dataset.json consumable by
parse_model_spec, the Trainer, and export_model_dir.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..io.image import MedicalImage


@dataclasses.dataclass
class Fingerprint:
    spacings: np.ndarray           # (N, 2) array-order (y, x)
    shapes: np.ndarray             # (N, 2)
    intensity_mean: Tuple[float, ...]      # per channel, foreground voxels
    intensity_std: Tuple[float, ...]
    percentile_00_5: Tuple[float, ...]
    percentile_99_5: Tuple[float, ...]
    n_channels: int

    @property
    def median_spacing(self) -> Tuple[float, float]:
        med = np.median(self.spacings, axis=0)
        return (float(med[0]), float(med[1]))

    @property
    def median_shape(self) -> Tuple[int, int]:
        med = np.median(self.shapes, axis=0)
        return (int(med[0]), int(med[1]))


def compute_fingerprint(images: Sequence[MedicalImage],
                        segs: Optional[Sequence[MedicalImage]] = None,
                        max_voxels_per_case: int = 100_000,
                        seed: int = 0) -> Fingerprint:
    """Fingerprint a 2D dataset. Foreground intensity statistics come from
    voxels under the segmentation (any label) when segs are given, else from
    all voxels; sampling keeps it O(max_voxels) per case."""
    rng = np.random.default_rng(seed)
    spacings, shapes = [], []
    n_ch = images[0].ncomponents
    samples = [[] for _ in range(n_ch)]

    for i, img in enumerate(images):
        if img.dim != 2:
            raise ValueError('compute_fingerprint expects 2D images')
        spacings.append(tuple(reversed(img.spacing)))
        arr = img.array if img.is_vector else img.array[..., None]
        shapes.append(arr.shape[:2])
        if segs is not None:
            mask = segs[i].array
            mask = mask.any(axis=-1) if segs[i].ncomponents > 1 else mask > 0
        else:
            mask = np.ones(arr.shape[:2], bool)
        idx = np.flatnonzero(mask)
        if idx.size == 0:
            continue
        take = rng.choice(idx, size=min(idx.size, max_voxels_per_case),
                          replace=False)
        flat = arr.reshape(-1, n_ch)
        for c in range(n_ch):
            samples[c].append(flat[take, c].astype(np.float64))

    means, stds, p05, p995 = [], [], [], []
    for c in range(n_ch):
        vals = np.concatenate(samples[c]) if samples[c] else np.zeros(1)
        means.append(float(vals.mean()))
        stds.append(float(vals.std()))
        lo, hi = np.percentile(vals, [0.5, 99.5])
        p05.append(float(lo))
        p995.append(float(hi))

    return Fingerprint(
        spacings=np.asarray(spacings, float), shapes=np.asarray(shapes, float),
        intensity_mean=tuple(means), intensity_std=tuple(stds),
        percentile_00_5=tuple(p05), percentile_99_5=tuple(p995),
        n_channels=n_ch)


def plan_experiment(fp: Fingerprint,
                    channel_names: Dict[int, str],
                    labels: Dict[str, int],
                    modality: str = 'CT',
                    multilabel: bool = True,
                    max_features: int = 512,
                    base_features: int = 32,
                    max_patch: int = 512) -> Tuple[dict, dict]:
    """Derive (plans_dict, dataset_json) from a fingerprint."""
    spacing = fp.median_spacing
    # shape at target spacing
    med_shape = [int(round(s * sp / t)) for s, sp, t in
                 zip(fp.median_shape, np.median(fp.spacings, axis=0), spacing)]

    def pick_patch(n):
        # smallest power of two >= min(n, max_patch), floor 64
        p = 64
        while p < min(n, max_patch):
            p *= 2
        return min(p, max_patch)

    patch = tuple(pick_patch(n) for n in med_shape)
    # stages: downsample until the smallest patch edge reaches 4-8 px
    n_stages = max(3, min(int(math.log2(min(patch))) - 2, 7))
    feats = tuple(min(base_features * 2 ** i, max_features)
                  for i in range(n_stages))

    norm = 'CTNormalization' if modality.upper() == 'CT' else 'ZScoreNormalization'
    props = {
        str(c): {
            'mean': fp.intensity_mean[c], 'std': fp.intensity_std[c],
            'percentile_00_5': fp.percentile_00_5[c],
            'percentile_99_5': fp.percentile_99_5[c],
        } for c in range(fp.n_channels)
    }

    plans = {
        'dataset_name': 'planned',
        'plans_name': 'nnUNetPlans',
        'configurations': {
            '2d': {
                'patch_size': list(patch),
                'spacing': [float(s) for s in spacing],
                'batch_size': 2,
                'median_image_size_in_voxels': med_shape,
                'normalization_schemes': [norm] * fp.n_channels,
                'use_mask_for_norm': [False] * fp.n_channels,
                'architecture': {
                    'network_class_name': ('dynamic_network_architectures.'
                                           'architectures.unet.PlainConvUNet'),
                    'arch_kwargs': {
                        'n_stages': n_stages,
                        'features_per_stage': list(feats),
                        'conv_op': 'torch.nn.modules.conv.Conv2d',
                        'kernel_sizes': [[3, 3]] * n_stages,
                        'strides': [[1, 1]] + [[2, 2]] * (n_stages - 1),
                        'n_conv_per_stage': [2] * n_stages,
                        'n_conv_per_stage_decoder': [2] * (n_stages - 1),
                        'conv_bias': True,
                        'norm_op': ('torch.nn.modules.instancenorm.'
                                    'InstanceNorm2d'),
                        'norm_op_kwargs': {'eps': 1e-5, 'affine': True},
                        'dropout_op': None,
                        'nonlin': 'torch.nn.LeakyReLU',
                        'nonlin_kwargs': {'inplace': True},
                    },
                },
            },
        },
        'foreground_intensity_properties_per_channel': props,
    }
    dataset_json = {
        'channel_names': {str(k): v for k, v in channel_names.items()},
        'labels': {'background': 0, **labels},
        'numTraining': int(len(fp.shapes)),
        'file_ending': '.nrrd',
        'multilabel': multilabel,
    }
    return plans, dataset_json
