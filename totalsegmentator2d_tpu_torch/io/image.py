"""MedicalImage: the framework's geometric image container.

Replaces the reference tool's dependency on SimpleITK images (C++/ITK) with a
plain numpy-backed value type that carries ITK-compatible geometry:

 - ``array``     numpy data in index order ``(z, y, x[, c])`` — i.e. the
                 *reverse* of the ITK size tuple, channels last for vector
                 images. This is the same memory layout ITK hands numpy.
 - ``spacing``   per-axis spacing in mm, ITK axis order ``(x, y, z)``
 - ``origin``    world position (LPS) of the index-0 voxel center
 - ``direction`` row-major d×d matrix; column j is the unit world direction
                 of image axis j (ITK convention, LPS world frame)
 - ``meta``      free-form string metadata (3D-Slicer ``Segment*`` keys live
                 here, see ops/annotations.py)

The world coordinate frame is LPS throughout, matching ITK/NRRD
(`space: left-posterior-superior`).
"""

from __future__ import annotations

import copy as _copy
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class MedicalImage:
    array: np.ndarray
    spacing: Tuple[float, ...] = None
    origin: Tuple[float, ...] = None
    direction: np.ndarray = None
    is_vector: bool = False
    meta: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self):
        arr = np.asarray(self.array)
        self.array = arr
        sdim = arr.ndim - (1 if self.is_vector else 0)
        if self.spacing is None:
            self.spacing = (1.0,) * sdim
        self.spacing = tuple(float(s) for s in self.spacing)
        d = len(self.spacing)
        if self.origin is None:
            self.origin = (0.0,) * d
        self.origin = tuple(float(o) for o in self.origin)
        if self.direction is None:
            self.direction = np.eye(d)
        self.direction = np.asarray(self.direction, dtype=float).reshape(d, d)
        if sdim != d:
            raise ValueError(
                f'array has {sdim} spatial dims but geometry is {d}-dimensional '
                f'(shape={arr.shape}, is_vector={self.is_vector})')

    # -- basic queries ---------------------------------------------------

    @property
    def dim(self) -> int:
        """Geometric dimensionality (2 or 3 for this framework)."""
        return len(self.spacing)

    @property
    def size(self) -> Tuple[int, ...]:
        """ITK-order size (x, y, z): reverse of the numpy spatial shape."""
        shape = self.array.shape[:-1] if self.is_vector else self.array.shape
        return tuple(int(s) for s in shape[::-1])

    @property
    def ncomponents(self) -> int:
        return int(self.array.shape[-1]) if self.is_vector else 1

    @property
    def dtype(self) -> np.dtype:
        return self.array.dtype

    def actual_dimension(self) -> int:
        """Dimensionality ignoring size-1 axes (reference image.py:483-487)."""
        return sum(s > 1 for s in self.size)

    # -- geometry --------------------------------------------------------

    def index_to_physical(self, index: Sequence[float]) -> np.ndarray:
        """World (LPS) position of an (x, y, z)-order continuous index."""
        idx = np.asarray(index, dtype=float)
        return np.asarray(self.origin) + self.direction @ (idx * np.asarray(self.spacing))

    def physical_to_index(self, point: Sequence[float]) -> np.ndarray:
        p = np.asarray(point, dtype=float) - np.asarray(self.origin)
        return (np.linalg.inv(self.direction) @ p) / np.asarray(self.spacing)

    def copy_geometry_from(self, other: 'MedicalImage') -> 'MedicalImage':
        self.spacing = tuple(other.spacing)
        self.origin = tuple(other.origin)
        self.direction = other.direction.copy()
        return self

    def copy_meta_from(self, other: 'MedicalImage') -> 'MedicalImage':
        self.meta = dict(other.meta)
        return self

    # -- conversions -----------------------------------------------------

    def astype(self, dtype) -> 'MedicalImage':
        return self.replace(array=self.array.astype(dtype))

    def replace(self, **kwargs) -> 'MedicalImage':
        """Functional update returning a new image; geometry/meta are copied
        unless overridden."""
        data = {
            'array': self.array,
            'spacing': tuple(self.spacing),
            'origin': tuple(self.origin),
            'direction': self.direction.copy(),
            'is_vector': self.is_vector,
            'meta': dict(self.meta),
        }
        data.update(kwargs)
        return MedicalImage(**data)

    def copy(self) -> 'MedicalImage':
        return self.replace(array=self.array.copy())

    def __deepcopy__(self, memo):
        return MedicalImage(
            array=self.array.copy(), spacing=tuple(self.spacing),
            origin=tuple(self.origin), direction=self.direction.copy(),
            is_vector=self.is_vector, meta=_copy.deepcopy(self.meta, memo))

    # -- channels ----------------------------------------------------------

    def channel(self, i: int) -> 'MedicalImage':
        if not self.is_vector:
            if i != 0:
                raise IndexError(f'Scalar image has a single channel, got {i}')
            return self
        return self.replace(array=np.ascontiguousarray(self.array[..., i]),
                            is_vector=False)

    def split_channels(self) -> List['MedicalImage']:
        """Reference image.py:512-520."""
        return [self.channel(i) for i in range(self.ncomponents)]

    @staticmethod
    def compose(channels: Sequence['MedicalImage']) -> 'MedicalImage':
        """Stack single-channel images into one vector image
        (sitk.Compose equivalent)."""
        channels = list(channels)
        if len(channels) == 1 and not channels[0].is_vector:
            return channels[0]
        ref = channels[0]
        arrs = []
        for ch in channels:
            if ch.is_vector:
                raise ValueError('compose() expects single-channel images')
            if ch.array.shape != ref.array.shape:
                raise ValueError('compose() requires equal shapes, got '
                                 f'{ch.array.shape} vs {ref.array.shape}')
            arrs.append(ch.array)
        return ref.replace(array=np.stack(arrs, axis=-1), is_vector=True)

    def __repr__(self) -> str:
        return (f'MedicalImage(size={self.size}, spacing={self.spacing}, '
                f'dtype={self.array.dtype}, components={self.ncomponents})')


# -- construction helpers ----------------------------------------------------

def image_from_array(arr: np.ndarray, is_vector: bool = False,
                     ref: Optional[MedicalImage] = None, **geo) -> MedicalImage:
    """A MedicalImage of a numpy array, optionally with the geometry and
    metadata of a reference image."""
    img = MedicalImage(array=np.asarray(arr), is_vector=is_vector, **geo)
    if ref is not None:
        img.copy_geometry_from(ref)
        img.copy_meta_from(ref)
    return img


_LABEL_DTYPES = (np.uint8, np.uint16, np.uint32, np.uint64, np.int8, np.bool_)


def is_label_dtype(dtype) -> bool:
    """The reference tool's convention (sitk_util.py:17-31): unsigned
    integer (and int8, bool) pixel types are label images."""
    return any(np.issubdtype(dtype, t) for t in _LABEL_DTYPES)


def is_label_image(img: MedicalImage) -> bool:
    return is_label_dtype(img.array.dtype)


def _parser_errors():
    """The foreign exception types a malformed byte stream can raise out
    of any of this package's parsers: KeyError from header-field /
    type-code lookups, zlib/gzip errors from corrupt compressed
    payloads, struct/EOF/Index/Overflow errors from truncated or
    nonsense bytes. UnicodeDecodeError is deliberately absent: it
    subclasses ValueError, which reader_guard passes through."""
    import gzip
    import struct
    import zlib
    return (KeyError, IndexError, struct.error, EOFError, OverflowError,
            zlib.error, gzip.BadGzipFile)


PARSER_ERRORS = _parser_errors()


def reader_guard(fmt: str):
    """Wrap a format reader so malformed files surface as ValueError (the
    io error contract) instead of leaking parser internals
    (PARSER_ERRORS). Deliberate ValueErrors pass through unchanged; a
    missing INPUT file still raises FileNotFoundError (only the specific
    gzip subclass of OSError is in the list)."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(path, *args, **kwargs):
            try:
                return fn(path, *args, **kwargs)
            except ValueError:
                raise
            except PARSER_ERRORS as ex:
                raise ValueError(
                    f'Corrupt {fmt} file ({type(ex).__name__}: {ex})') from ex
        return wrapped
    return deco


def resolve_datafile(header_path: str, rel: str, fmt: str) -> str:
    """Resolve a detached-header data-file reference (NRRD ``data file``,
    MetaImage ``ElementDataFile``) against the header's directory,
    rejecting absolute paths and references that escape it — a header is
    untrusted input (uploads, archives), and following an arbitrary path
    would read unrelated host files into the image."""
    import os
    if os.path.isabs(rel):
        raise ValueError(
            f'{fmt} data file reference must be relative: {rel!r}')
    base = os.path.dirname(os.path.abspath(header_path))
    full = os.path.normpath(os.path.join(base, rel))
    if not (full == base or full.startswith(base + os.sep)):
        raise ValueError(
            f'{fmt} data file reference escapes the header directory: '
            f'{rel!r}')
    return full
