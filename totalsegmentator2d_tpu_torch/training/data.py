"""Training data: preprocessing, foreground-oversampled patches, packed
targets (the reference package's training/data.py).

:func:`preprocess_case` normalizes and resamples a case on the device (the
B-spline prefilter kernel on the card). :class:`PatchSampler` samples
fixed-size patches on the host with numpy, a guaranteed share of them
centred on foreground (nnU-Net's oversample_foreground_percent=0.33): the
same seed gives the same batches as the reference, bit for bit. Batches
are plain dicts of numpy arrays ready for ``Trainer.step``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..io.image import MedicalImage
from ..models.plans import ModelSpec
from ..ops.normalize import apply_scheme
from ..ops.resample import resize_to_shape
from ..utils.device import resolve_device


def preprocess_case(img: MedicalImage, seg: Optional[MedicalImage],
                    spec: ModelSpec, device=None
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Normalize + resample one 2D training case to the plan spacing, on
    ``device`` (None = the CUDA card). Returns (image (H, W, C) float32,
    seg (H, W, L) uint8 or None)."""
    device = resolve_device(device)
    arr = img.array if img.is_vector else img.array[..., None]
    pre = spec.preprocess
    chans = []
    with torch.inference_mode():
        for c in range(arr.shape[-1]):
            scheme = (pre.normalization_schemes[c]
                      if c < len(pre.normalization_schemes) else 'zscore')
            props = (pre.intensity_properties[c]
                     if c < len(pre.intensity_properties) else None)
            x = torch.from_numpy(np.ascontiguousarray(arr[..., c])).to(device)
            chans.append(apply_scheme(x, scheme, props).cpu().numpy())
    data = np.stack(chans, axis=-1).astype(np.float32)

    spacing_yx = tuple(reversed(img.spacing))
    new_shape = tuple(int(round(n * o / t)) for n, o, t in
                      zip(data.shape[:2], spacing_yx, pre.spacing))
    if new_shape != data.shape[:2]:
        data = resize_to_shape(data, new_shape, order=3, axes=(0, 1),
                               device=device).astype(np.float32)

    target = None
    if seg is not None:
        s = seg.array if seg.is_vector else seg.array[..., None]
        if new_shape != s.shape[:2]:
            s = resize_to_shape(s.astype(np.float32), new_shape, order=0,
                                axes=(0, 1), device=device)
            # one-hot channels binarize; labelmaps keep their integer values
            s = (s > 0.5) if spec.multilabel else np.rint(s)
        target = s.astype(np.uint8)
    return data, target


def pack_target_np(target: np.ndarray) -> np.ndarray:
    """Pack a (..., L) binary one-hot target into (..., ceil(L/8)) uint8
    bit-plane bytes for the host-to-device copy: bit l of byte w is label
    8w + l (np.packbits bitorder='little'); ``Trainer.step`` unpacks on the
    device, bit for bit (``train.unpack_target``)."""
    return np.packbits(np.asarray(target) > 0, axis=-1, bitorder='little')


class PatchSampler:
    """Random patch batches with nnU-Net-style foreground oversampling.

    ``sample_batch(..., pack_targets=True)`` ships the one-hot target as
    packed bit-planes under the ``'target_packed'`` key (8x fewer bytes;
    ``Trainer.step`` unpacks on the device)."""

    def __init__(self, cases: Sequence[Tuple[np.ndarray, np.ndarray]],
                 patch_size: Tuple[int, int],
                 oversample_foreground: float = 0.33, seed: int = 0):
        """cases: list of (image (H,W,C) float32, target (H,W,L) uint8)."""
        if not cases:
            raise ValueError('PatchSampler needs at least one case')
        self.cases = list(cases)
        self.patch = tuple(int(p) for p in patch_size)
        self.oversample = float(oversample_foreground)
        self.rng = np.random.default_rng(seed)
        # foreground coordinates, indexed once per case
        self._fg: List[Optional[np.ndarray]] = []
        for _, tgt in self.cases:
            coords = np.argwhere(tgt.any(axis=-1))
            self._fg.append(coords if len(coords) else None)

    def _extract(self, data: np.ndarray, tgt: np.ndarray,
                 center: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
        ph, pw = self.patch
        H, W = data.shape[:2]
        y0 = int(np.clip(center[0] - ph // 2, 0, max(H - ph, 0)))
        x0 = int(np.clip(center[1] - pw // 2, 0, max(W - pw, 0)))
        di = data[y0:y0 + ph, x0:x0 + pw]
        ti = tgt[y0:y0 + ph, x0:x0 + pw]
        if di.shape[:2] != (ph, pw):  # case smaller than the patch: pad
            pads = [(0, ph - di.shape[0]), (0, pw - di.shape[1])]
            di = np.pad(di, pads + [(0, 0)])
            ti = np.pad(ti, pads + [(0, 0)])
        return di, ti

    def sample_batch(self, batch_size: int,
                     pack_targets: bool = False) -> Dict[str, np.ndarray]:
        imgs, tgts = [], []
        for b in range(batch_size):
            ci = int(self.rng.integers(len(self.cases)))
            data, tgt = self.cases[ci]
            force_fg = (b >= round(batch_size * (1 - self.oversample))
                        and self._fg[ci] is not None)
            if force_fg:
                center = tuple(self._fg[ci][
                    int(self.rng.integers(len(self._fg[ci])))])
            else:
                center = (int(self.rng.integers(data.shape[0])),
                          int(self.rng.integers(data.shape[1])))
            di, ti = self._extract(data, tgt, center)
            imgs.append(di)
            tgts.append(ti)
        target = np.stack(tgts)
        if pack_targets:
            return {'image': np.stack(imgs),
                    'target_packed': pack_target_np(target)}
        return {'image': np.stack(imgs), 'target': target}
