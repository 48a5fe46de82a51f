"""Host-side medical image IO: NRRD (``.nrrd``, ``.seg.nrrd``, ``.nhdr``).

NIfTI, MetaImage, PNG and DICOM are not ported yet and raise.
"""

from __future__ import annotations

import os

from .image import MedicalImage  # noqa: F401
from . import nrrd

SUPPORTED_EXTENSIONS = ('nrrd', 'nhdr')


def _ext(path: str) -> str:
    base = os.path.basename(path).lower()
    if base.endswith('.nii.gz'):
        return 'nii.gz'
    return base.rsplit('.', 1)[-1] if '.' in base else ''


def _not_ported(path: str) -> NotImplementedError:
    return NotImplementedError(
        f'Image format of {path!r} is not ported to the PyTorch package yet '
        f'(supported: {", ".join(SUPPORTED_EXTENSIONS)})')


def read_image(path: str) -> MedicalImage:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if _ext(path) in SUPPORTED_EXTENSIONS:
        return nrrd.read(path)
    raise _not_ported(path)


def write_image(img: MedicalImage, path: str, compress: bool = True) -> None:
    if _ext(path) in SUPPORTED_EXTENSIONS:
        return nrrd.write(img, path, compress=compress)
    raise _not_ported(path)
