"""2D visuals (the PNG export path).

The reference's ``create_visual`` (image.py:383-453): reduce an image to
2D by projection (on the host), resample it to square pixels, then map
labels to RGB through a palette recovered from the Segment metadata, or
window intensities to uint8. The resample (its prefilter the CUDA kernel
at order 3), the palette gather and the window run as torch ops on the
device: the card unless the caller names the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..io.image import MedicalImage, is_label_image
from ..utils.colors import default_palette, to_palette
from ..utils.device import resolve_device
from ..utils.logging import warn
from .annotations import get_annotation_labels
from .geometry import axis_name_to_index, reduce_dimensions, reorient
from .normalize import auto_window, intensity_window
from .projection import flatten_vector_max, project
from .resample import resample_uniform


def label_to_rgb(arr: np.ndarray, palette: list, device=None) -> np.ndarray:
    """Map integer labels to RGB through a dense palette (index 0 =
    background), gathered on ``device``. Labels beyond the palette wrap
    around (ITK LabelToRGB recycles colors); with no palette the
    deterministic default palette is used."""
    device = resolve_device(device)
    pal = np.asarray(palette, dtype=np.uint8)
    if len(pal) <= 1:
        max_label = int(np.max(arr)) if arr.size else 0
        pal = np.asarray([[255, 255, 255]] + default_palette(max(max_label, 1)),
                         dtype=np.uint8)
    ncol = pal.shape[0] - 1
    labels = torch.from_numpy(np.ascontiguousarray(arr)).to(device).to(torch.int64)
    if ncol > 0:
        idx = torch.where(labels <= 0, 0, torch.remainder(labels - 1, ncol) + 1)
    else:
        idx = torch.zeros_like(labels)
    rgb = torch.from_numpy(pal).to(device)[idx]
    return rgb.cpu().numpy()


def create_visual(img: MedicalImage, mode: str = 'max',
                  axis: Union[int, str] = -1,
                  window=None, labels: Optional[bool] = None,
                  palette=None, device=None) -> MedicalImage:
    """Render an n-D image to a 2D visual: RGB for labels, uint8 gray for
    intensities (reference image.py:383-453). ``device``: None = the CUDA
    card, 'cpu' when asked."""
    device = resolve_device(device)
    try:
        if labels is None:
            labels = bool(palette) or is_label_image(img)
    except Exception:
        labels = False

    if labels and not palette:
        try:
            palette = {}
            for name, info in get_annotation_labels(img).items():
                if info.get('value') is not None and info.get('color') is not None:
                    palette[int(info['value'])] = info['color']
        except Exception as ex:
            warn(f'Failed to extract palette from image metadata: {ex}')
            palette = None

    img = reorient(img)
    _axis = axis_name_to_index(axis) if isinstance(axis, str) else \
        (axis if axis is not None else -1)
    while True:
        img = reduce_dimensions(img, min_dims=2)
        if img.dim <= 2:
            break
        _axis = -1 if abs(_axis) > img.dim else _axis
        img = project(img, mode=mode, axis=_axis)

    if labels:
        pal = to_palette(palette) if palette is not None else []
        if img.ncomponents > 1:
            img = flatten_vector_max(img, index=True)
            img = img.replace(array=np.clip(img.array, 0, 255).astype(np.uint8))
        img = resample_uniform(img, labels=True, device=device)
        rgb = label_to_rgb(img.array, pal, device=device)
        return img.replace(array=rgb, is_vector=True, meta={})

    img = resample_uniform(img, labels=False, device=device)
    x = torch.from_numpy(np.ascontiguousarray(img.array)).to(device)
    # the window comes from the components, as the reference's does
    win = window if (window is not None and not isinstance(window, str)) else \
        auto_window(x, window)
    lower, upper = win
    if lower is None:
        lower = float(torch.min(x))
    if upper is None:
        upper = float(torch.max(x))
    if img.ncomponents > 1:
        x = torch.linalg.vector_norm(x.to(torch.float32), dim=-1)  # VectorMagnitude
    # float -> uint8 truncates, as numpy's astype does
    out = intensity_window(x, lower, upper).to(torch.uint8).cpu().numpy()
    return img.replace(array=out, is_vector=False, meta={})
