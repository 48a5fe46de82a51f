"""Orientation and dimensionality handling.

Replaces ITK's ``DICOMOrient`` / ``Extract`` machinery (reference
image.py:32-43 and image.py:241-258). Reorientation is a pure axis
permutation + flips derived from the direction-cosine matrix — on the host it
is just a numpy view change, made contiguous once.

Orientation codes use the ITK "from" convention: ``'RAI'`` means axis 0 runs
*from* Right (toward Left = +x in LPS), axis 1 from Anterior (toward
Posterior = +y), axis 2 from Inferior (toward Superior = +z) — i.e. RAI is
the identity direction matrix in the LPS world frame.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..io.image import MedicalImage

# letter -> (world axis, sign of direction column) in LPS
_LETTER_AXIS = {
    'R': (0, +1), 'L': (0, -1),
    'A': (1, +1), 'P': (1, -1),
    'I': (2, +1), 'S': (2, -1),
}

AXIS_NAMES = {
    's': 0, 'sag': 0, 'sagittal': 0,
    'c': 1, 'cor': 1, 'coronal': 1,
    'a': 2, 'ax': 2, 'axial': 2,
}


def axis_name_to_index(name: str) -> int:
    """Anatomical axis name -> RAI axis index (reference image.py:16-30)."""
    return AXIS_NAMES[str(name).lower()]


def orientation_plan(direction: np.ndarray, orient: str = 'RAI'
                     ) -> Tuple[Tuple[int, ...], Tuple[bool, ...]]:
    """Compute the axis permutation and flips that reorient an image with the
    given direction matrix to the target orientation code.

    Returns ``(perm, flip)`` in ITK axis order: output axis j' takes input
    axis ``perm[j']``, negated when ``flip[j']``.
    """
    d = direction.shape[0]
    letters = orient.upper()
    if len(letters) != d:
        raise ValueError(f'Orientation {orient!r} does not match dimension {d}')

    # dominant world axis + sign for each input image axis
    dominants = {}
    for j in range(d):
        k = int(np.argmax(np.abs(direction[:, j])))
        if k in dominants:
            raise ValueError('Degenerate direction matrix: two axes share a '
                             'dominant world direction')
        dominants[k] = (j, 1 if direction[k, j] >= 0 else -1)

    perm, flip = [], []
    for letter in letters:
        k_t, s_t = _LETTER_AXIS[letter]
        if k_t not in dominants:
            raise ValueError(f'No image axis maps to world axis {k_t}')
        j, s = dominants[k_t]
        perm.append(j)
        flip.append(s != s_t)
    return tuple(perm), tuple(flip)


def reorient(img: MedicalImage, orient: str = 'RAI') -> MedicalImage:
    """Reorient an image to the target orientation (host-side view change).

    2D images pass through untouched, like ``reorient_image`` in the
    reference (image.py:32-43).
    """
    if img.dim <= 2:
        return img
    perm, flip = orientation_plan(img.direction, orient)
    if perm == tuple(range(img.dim)) and not any(flip):
        return img

    d = img.dim
    arr = img.array
    # numpy axes are reversed relative to ITK axes ([, c] channel tail stays)
    np_perm = [d - 1 - perm[d - 1 - i] for i in range(d)]
    if img.is_vector:
        np_perm = np_perm + [d]
    arr = np.transpose(arr, np_perm)
    for jprime in range(d):
        if flip[jprime]:
            arr = np.flip(arr, axis=d - 1 - jprime)

    signs = np.array([-1.0 if f else 1.0 for f in flip])
    direction = img.direction[:, list(perm)] * signs[None, :]
    spacing = tuple(img.spacing[p] for p in perm)

    # new origin = physical position of the voxel that becomes index 0
    idx0 = np.zeros(d)
    for j, f in zip(perm, flip):
        if f:
            idx0[j] = img.size[j] - 1
    origin = tuple(img.index_to_physical(idx0))

    return img.replace(array=np.ascontiguousarray(arr), spacing=spacing,
                       origin=origin, direction=direction)


def orientation_code(direction: np.ndarray) -> str:
    """The ITK 'from'-convention orientation code of a direction matrix."""
    inv = {v: k for k, v in _LETTER_AXIS.items()}
    code = ''
    for j in range(direction.shape[1]):
        k = int(np.argmax(np.abs(direction[:, j])))
        s = 1 if direction[k, j] >= 0 else -1
        code += inv[(k, s)]
    return code


def reduce_dimensions(img: MedicalImage, min_dims: int = 0) -> MedicalImage:
    """Collapse size-1 axes (reference image.py:241-258), optionally keeping
    at least ``min_dims`` dimensions (refilling from the end)."""
    keep = [s > 1 for s in img.size]
    if min_dims:
        deficit = min_dims - sum(keep)
        for j in range(len(keep) - 1, -1, -1):
            if deficit <= 0:
                break
            if not keep[j]:
                keep[j] = True
                deficit -= 1
    if all(keep):
        return img

    d = img.dim
    kept_axes = [j for j in range(d) if keep[j]]
    arr = img.array
    # drop collapsed numpy axes (numpy axis for ITK axis j is d-1-j)
    np_axes = tuple(d - 1 - j for j in range(d) if not keep[j])
    arr = np.squeeze(arr, axis=np_axes)

    spacing = tuple(img.spacing[j] for j in kept_axes)
    origin = tuple(np.asarray(img.origin)[kept_axes])
    # direction: keep the submatrix over retained world axes — matches ITK's
    # DirectionCollapseToGuess when the collapsed axis is (near) aligned
    sub = img.direction[np.ix_(kept_axes, kept_axes)]
    norms = np.linalg.norm(sub, axis=0)
    if np.any(norms < 0.5):
        sub = np.eye(len(kept_axes))  # guess failed -> identity, like ITK
    else:
        sub = sub / norms
    return img.replace(array=arr, spacing=spacing, origin=origin, direction=sub)


def restore_dimension(img2d: MedicalImage, ref3d: MedicalImage) -> MedicalImage:
    """Re-attach 3D geometry to a 2D result (reference tool.py:187-193):
    reshape the 2D array to the reference's 3D shape (with its size-1 axis)
    and copy the reference geometry."""
    nch = img2d.ncomponents
    shape = list(ref3d.size[::-1]) + ([nch] if img2d.is_vector else [])
    arr = np.reshape(img2d.array, shape)
    res = MedicalImage(array=arr, spacing=ref3d.spacing, origin=ref3d.origin,
                       direction=ref3d.direction.copy(),
                       is_vector=img2d.is_vector, meta=dict(img2d.meta))
    return res
