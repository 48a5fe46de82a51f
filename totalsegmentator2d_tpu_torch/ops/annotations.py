"""Segmentation label metadata — the 3D-Slicer ``Segment*`` convention.

Functional parity with the reference's meta module (ts2d/core/util/meta.py):
segment annotations are stored as stringly-typed image metadata keys
``Segment<i>_{ID,Layer,LabelValue,Name,NameAutoGenerated,Color,
ColorAutoGenerated}``. Multilabel (vector) segmentations map channel i to
``Layer=i, LabelValue=1`` with the name looked up at label i+1; scalar
segmentations map label values directly.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Union

import numpy as np

from ..io.image import MedicalImage
from ..utils.colors import (color_str_to_rgb, named_palette,
                            to_color_str_rgb_floats)
from ..utils.logging import warn


def sanitize_meta(meta: dict) -> dict:
    """Drop tags carrying large irrelevant payloads (the DICOM overlay
    data tag the reference tool strips)."""
    meta.pop('6000|3000', None)
    return meta


def get_image_meta(img: MedicalImage, add_info: bool = False,
                   sanitize: bool = False) -> dict:
    """The image's metadata as a dict; ``add_info`` adds its size, spacing,
    direction, dimension, origin and pixel type."""
    meta = dict(img.meta)
    if add_info:
        meta.update({
            'size': img.size, 'spacing': img.spacing,
            'direction': tuple(img.direction.reshape(-1)),
            'dimension': img.dim, 'origin': img.origin,
            'pixelid': str(img.array.dtype),
        })
    return sanitize_meta(meta) if sanitize else meta


def set_image_meta(img: MedicalImage, meta: dict, limit: int = None,
                   clear: bool = False) -> MedicalImage:
    """Write ``meta`` as string metadata (each value cut to ``limit``
    characters); ``clear`` drops the old metadata first."""
    if clear:
        img.meta = {}
    for k, v in meta.items():
        v = str(v)
        if limit and len(v) > limit:
            v = v[:limit]
        img.meta[str(k)] = v
    return img


def copy_image_meta(dst: MedicalImage, src: MedicalImage) -> MedicalImage:
    return dst.copy_meta_from(src)


def copy_image_geo(dst: MedicalImage, src: MedicalImage) -> MedicalImage:
    return dst.copy_geometry_from(src)


def get_labels(seg: MedicalImage, bg: int = 0, fetch: bool = True) -> List[int]:
    """Sorted labels present in a segmentation. Multichannel: 1-based channel
    indices (optionally only those with any voxel set); scalar: unique values
    minus background (reference meta.py:15-49)."""
    if seg.ncomponents > 1:
        if fetch:
            present = np.any(seg.array, axis=tuple(range(seg.array.ndim - 1)))
            return [i + 1 for i, b in enumerate(present) if b]
        return list(range(1, seg.ncomponents + 1))
    vals = set(int(v) for v in np.unique(seg.array))
    vals.discard(int(bg))
    return sorted(vals)


def get_label_mask(seg: MedicalImage, label: int) -> MedicalImage:
    """Binary uint8 mask of one label (reference meta.py:51-63)."""
    if seg.ncomponents > 1:
        if not (1 <= label <= seg.ncomponents):
            raise ValueError(f'Invalid label number: {label} '
                             f'(multilabel segmentation has {seg.ncomponents} channels)')
        arr = (seg.array[..., label - 1] > 0).astype(np.uint8)
        return seg.replace(array=arr, is_vector=False)
    # single-channel vector images are treated as scalar; drop the channel tail
    arr = seg.array[..., 0] if seg.is_vector else seg.array
    return seg.replace(array=(arr == label).astype(np.uint8), is_vector=False)


def get_labels_voxels(seg: MedicalImage) -> Dict[int, int]:
    if seg.ncomponents > 1:
        counts = np.count_nonzero(seg.array, axis=tuple(range(seg.array.ndim - 1)))
        return {i + 1: int(c) for i, c in enumerate(counts)}
    vals, counts = np.unique(seg.array, return_counts=True)
    return {int(v): int(c) for v, c in zip(vals, counts)}


def get_voxel_mm(seg: MedicalImage) -> float:
    return float(np.prod(seg.spacing))


def set_annotation_meta(seg: MedicalImage,
                        names: Optional[Dict[int, str]] = None,
                        colors: Union[None, str, Dict[str, object]] = None,
                        combined: Optional[Dict[int, dict]] = None) -> MedicalImage:
    """Write Segment* metadata in place (reference meta.py:172-241)."""
    multilabel = seg.ncomponents > 1
    labels = list(range(seg.ncomponents)) if multilabel else get_labels(seg)

    if names is not None and (colors is None or isinstance(colors, str)):
        try:
            # names keys are 1-based for multilabel (channel + 1) and label
            # values for scalar segs; allocate palette entries accordingly
            keys = sorted(names)
            pal = named_palette(colors, len(keys) if keys else 1)
            colors = {names[k]: pal[i] for i, k in enumerate(keys)}
        except Exception:
            warn(f'Failed to load named palette: {colors}')
            colors = {}

    info = {k: v for k, v in seg.meta.items() if not k.startswith('Segment')}
    for seg_id, label in enumerate(labels):
        key = f'Segment{seg_id}_'
        if names is not None:
            info[key + 'ID'] = str(seg_id)
            info[key + 'Layer'] = str(label if multilabel else 0)
            info[key + 'LabelValue'] = str(1 if multilabel else label)
            name = names.get(label + 1 if multilabel else label)
            if name is None:
                continue
            info[key + 'Name'] = str(name)
            info[key + 'NameAutoGenerated'] = '0'
            color = (colors or {}).get(name)
            if color is None:
                warn(f'No color is defined for label {name} (value {label})')
                continue
            try:
                info[key + 'Color'] = to_color_str_rgb_floats(color, sep=' ')
                info[key + 'ColorAutoGenerated'] = '0'
            except Exception:
                warn(f'Failed to read a color value for label {name} (value {label})')
        elif combined is not None:
            linfo = combined.get(label)
            if linfo:
                for k, v in linfo.items():
                    info[key + k] = str(int(v) if isinstance(v, bool) else v)
    seg.meta = info
    return seg


def get_annotation_meta(seg: MedicalImage, fetch: bool = True) -> Dict[int, dict]:
    """Parse Segment* metadata back into {label: attributes}
    (reference meta.py:254-297)."""
    multilabel = seg.ncomponents > 1
    regions: Dict[int, dict] = {}
    for k, v in seg.meta.items():
        if not k.startswith('Segment') or '_' not in k:
            continue
        skey, attr = k.split('_', 1)
        reg = skey[len('Segment'):]
        if reg.isdigit():
            regions.setdefault(int(reg), {})[attr] = v

    meta: Dict[int, dict] = ({l: {'exists': True} for l in get_labels(seg, fetch=fetch)}
                             if fetch else defaultdict(dict))
    for region in regions.values():
        label = region.get('Layer' if multilabel else 'LabelValue')
        if label is None or not str(label).lstrip('-').isdigit():
            continue
        label = int(label) + (1 if multilabel else 0)
        meta.setdefault(label, {}).update(region)
    return dict(meta)


def get_annotation_labels(seg: MedicalImage, fetch: bool = True,
                          counts: bool = False) -> Dict[str, dict]:
    """{name: {name, value, exists, count?, mm?, color}}
    (reference meta.py:299-344)."""
    meta = get_annotation_meta(seg, fetch=fetch)
    voxel_counts = get_labels_voxels(seg) if counts else None
    mm = get_voxel_mm(seg)
    res: Dict[str, dict] = {}
    unknown = 0
    for label, m in sorted(meta.items()):
        name = m.get('Name')
        if name is None:
            unknown += 1
            name = f'unknown{unknown}'
        color = m.get('Color')
        if color:
            try:
                color = color_str_to_rgb(color)
            except Exception as ex:
                warn(f'Failed to convert {color!r} to a color: {ex}')
                color = None
        info = {'name': name, 'value': label}
        if fetch:
            info['exists'] = m.get('exists', False)
        if voxel_counts is not None:
            c = voxel_counts.get(label, 0)
            info['count'] = c
            info['mm'] = c * mm
        info['color'] = color
        if name in res:
            warn(f'Label: {name} is not unique')
        res[name] = info
    return res


def get_label_names(seg: MedicalImage,
                    fetch: bool = True) -> Dict[int, Optional[str]]:
    """Label -> its Segment name (None where it has none)."""
    meta = get_annotation_meta(seg, fetch=fetch)
    return {label: m.get('Name') for label, m in meta.items()}


def combine_segmentations(segs: List[MedicalImage]) -> MedicalImage:
    """Stack the per-label binary masks of several (multilabel) segmentations
    into one vector image with merged annotations (reference
    image.py:490-510). The 5-group ensemble merge lands here: 117 channels
    for ts2d-v2."""
    masks, names, colors = [], {}, {}
    ref = segs[0]
    for seg in segs:
        for name, info in get_annotation_labels(seg).items():
            mask = get_label_mask(seg, info['value'])
            names[len(masks) + 1] = name
            if info.get('color') is not None:
                colors[name] = info['color']
            masks.append(mask.array)
    arr = np.stack(masks, axis=-1) if masks else np.zeros(ref.array.shape + (0,), np.uint8)
    res = ref.replace(array=arr, is_vector=True, meta={})
    set_annotation_meta(res, names=names, colors=colors)
    return res
