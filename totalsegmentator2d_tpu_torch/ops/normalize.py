"""nnU-Net per-channel intensity normalization, driven by plans.json.

Statistics are two-pass fp32 (mean, then the mean of squared deviations),
as in the reference package.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch


def _mean_std(x: torch.Tensor):
    mean = x.mean()
    return mean, (x - mean).square().mean().sqrt()


def ct_normalize(x: torch.Tensor, mean: float, std: float,
                 lower: float, upper: float) -> torch.Tensor:
    """nnU-Net CTNormalization: clip to the dataset's foreground intensity
    percentile bounds, then z-score with dataset statistics."""
    x = torch.clamp(x.float(), lower, upper)
    return (x - mean) / max(std, 1e-8)


def zscore_normalize(x: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """nnU-Net ZScoreNormalization. With a mask the statistics come from
    the masked pixels and only those are normalized; the others keep their
    value (``image[mask] = (image[mask] - mean) / std``)."""
    x = x.float()
    if mask is None:
        mean, std = _mean_std(x)
        return (x - mean) / torch.clamp(std, min=1e-8)
    m = mask.float()
    denom = torch.clamp(m.sum(), min=1.0)
    mean = (x * m).sum() / denom
    std = ((x - mean).square() * m).sum().div(denom).sqrt()
    return torch.where(mask, (x - mean) / torch.clamp(std, min=1e-8), x)


def rescale_01_normalize(x: torch.Tensor) -> torch.Tensor:
    """nnU-Net Rescale01Normalization."""
    x = x.float()
    lo, hi = x.min(), x.max()
    return (x - lo) / torch.clamp(hi - lo, min=1e-8)


def apply_scheme(x: torch.Tensor, scheme: str,
                 props: Optional[dict]) -> torch.Tensor:
    """Dispatch by nnU-Net normalization scheme class name."""
    s = (scheme or '').lower()
    if 'ct' in s:
        p = props or {}
        return ct_normalize(
            x,
            mean=float(p.get('mean', 0.0)),
            std=float(p.get('std', 1.0)),
            lower=float(p.get('percentile_00_5', -1024.0)),
            upper=float(p.get('percentile_99_5', 3071.0)))
    if 'rescale' in s:
        return rescale_01_normalize(x)
    if 'nonorm' in s or 'no_norm' in s:
        return x.float()
    return zscore_normalize(x)


def normalize_channels(work: torch.Tensor, pre,
                       nz_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-channel plans-driven normalization of an (..., C) image.
    ``nz_mask`` is the nonzero-crop mask (:func:`nonzero_norm_mask`) used by
    channels whose ``use_mask_for_norm`` is set."""
    chans = []
    for c in range(work.shape[-1]):
        scheme = (pre.normalization_schemes[c]
                  if c < len(pre.normalization_schemes) else 'zscore')
        props = (pre.intensity_properties[c]
                 if c < len(pre.intensity_properties) else None)
        use_mask = (c < len(pre.use_mask_for_norm)
                    and pre.use_mask_for_norm[c])
        if use_mask and 'zscore' in scheme.lower() and nz_mask is not None:
            chans.append(zscore_normalize(work[..., c], mask=nz_mask))
        else:
            chans.append(apply_scheme(work[..., c], scheme, props))
    return torch.stack(chans, dim=-1)


def nonzero_norm_mask(arr: np.ndarray) -> np.ndarray:
    """Host-side nnU-Net create_nonzero_mask: any-channel nonzero, holes
    filled."""
    from scipy.ndimage import binary_fill_holes
    a = np.asarray(arr)
    mask = np.any(a != 0, axis=-1) if a.ndim == 3 else (a != 0)
    return binary_fill_holes(mask)


def intensity_window(x: torch.Tensor, lower: float, upper: float,
                     out_min: float = 0.0, out_max: float = 255.0) -> torch.Tensor:
    """sitk.IntensityWindowing: the linear map [lower, upper] -> [out_min,
    out_max], clipped, in float32 on the tensor's device. The scale is
    rounded to float32 as the reference computes it, and the map runs as
    separate operations (no fused multiply-add): a visual truncates the
    result to uint8, where one ulp can move a pixel by a gray level."""
    f32 = np.float32
    scale = float(f32(out_max - out_min) / f32(max(upper - lower, 1e-12)))
    x = x.to(torch.float32)
    y = torch.sub(x, float(f32(lower)))
    y = torch.mul(y, scale)
    y = torch.add(y, float(f32(out_min)))
    return torch.clamp(y, float(f32(out_min)), float(f32(out_max)))


def auto_window(arr: Union[torch.Tensor, np.ndarray],
                method: Optional[str] = None) -> Tuple[float, float]:
    """Automatic intensity window of a tensor: 'minmax' (default), on its
    device, or the percentiles 'pcN' (N, 100-N) / 'pcA-B' (reference
    image.py:458-481), which numpy computes on the host: its interpolation
    rounds in the array's dtype, and the window must match it."""
    x = torch.as_tensor(arr)
    method = (method or 'minmax').lower()
    if method == 'minmax':
        return float(torch.min(x)), float(torch.max(x))
    if method.startswith('pc'):
        spec = method[2:]
        try:
            if '-' in spec:
                pc = tuple(float(a) for a in spec.split('-'))
            else:
                v = float(spec)
                pc = (v, 100.0 - v)
        except ValueError as ex:
            raise ValueError(f'Failed to parse percentile window: {method}') from ex
        if len(pc) != 2:
            raise ValueError(f'Percentile window needs exactly two values: {method}')
        lo, hi = np.percentile(x.detach().cpu().numpy(), pc)
        return float(lo), float(hi)
    raise ValueError(f'Unknown windowing method: {method}')
