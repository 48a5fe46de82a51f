"""The solo scan program both engines run, and their shared host API.

    normalize -> B-spline prefilter + matmul down-resample to plan spacing
    -> symmetric pad -> tile x TTA batched U-Net forwards (the engine's
    models, fold mean) -> Gaussian overlap-add -> weight normalization
    -> un-pad -> order-1 up-resample -> the engine's decision

Everything outside the U-Net is fp32, and the program runs under
:func:`~..utils.device.exact_numerics` (no TF32 for the resample matmuls,
as the reference's ``Precision.HIGHEST``; fixed cuDNN algorithms). With
``compute_dtype=torch.bfloat16`` only the U-Net forwards run bf16 (the
reference's "fast" precision). Inputs upload as float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.convert import load_into
from ..models.plans import ArchSpec, ModelSpec
from ..models.unet import UNet
from ..ops.gaussian import gaussian_map
from ..ops.normalize import nonzero_norm_mask, normalize_channels
from ..ops.resample import apply_separable, axis_weights, bspline_prefilter
from ..utils.device import exact_numerics, resolve_device
from ..utils.logging import log
from .tiling import accumulate_tiles, pad_amounts, padded_shape, tile_positions


def _mirror_combos(axes: Sequence[int]) -> List[Tuple[int, ...]]:
    """All subsets of the allowed mirror axes (identity first).
    Axes are spatial: 0 = y, 1 = x."""
    combos: List[Tuple[int, ...]] = [()]
    for ax in axes:
        combos += [c + (ax,) for c in combos]
    return combos


def compute_new_shape(shape: Sequence[int], old_spacing: Sequence[float],
                      new_spacing: Sequence[float]) -> Tuple[int, ...]:
    """nnU-Net target shape: round(shape * old / new)."""
    return tuple(int(round(n * o / s))
                 for n, o, s in zip(shape, old_spacing, new_spacing))


def _nonzero_bbox(arr: np.ndarray) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Bounding box of non-zero pixels over all channels; the full image if
    everything is zero."""
    mask = np.any(arr != 0, axis=-1) if arr.ndim == 3 else (arr != 0)
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return (0, arr.shape[0]), (0, arr.shape[1])
    return ((int(ys.min()), int(ys.max()) + 1),
            (int(xs.min()), int(xs.max()) + 1))


class ScanEngine:
    """One model configuration's scan program, cached per input shape, and
    the host API around it. Subclasses give the U-Net batch function
    (:meth:`_net`), the accumulator's leading shape (``acc_prefix``), the
    decision on the device (:meth:`_decide`) and its host-side finish
    (:meth:`_finish`).

    :param device: ``None`` = the CUDA card (raises without one); pass
        ``'cpu'`` to run on the CPU
    :param compute_dtype: ``None`` (exact, fp32) or ``torch.bfloat16``
        (fast: bf16 U-Net forwards)
    """

    kind = 'scan'

    def __init__(self, spec: ModelSpec, tile_step_size: float,
                 use_mirroring: bool, compute_dtype: Optional[torch.dtype],
                 device):
        if compute_dtype not in (None, torch.bfloat16):
            raise ValueError(f'compute_dtype must be None or torch.bfloat16, '
                             f'got {compute_dtype}')
        self.device = resolve_device(device)
        self.spec = spec
        self.tile_step_size = float(tile_step_size)
        self.use_mirroring = bool(use_mirroring)
        self.compute_dtype = compute_dtype
        self.acc_prefix: Tuple[int, ...] = ()
        self.n_folds = 0
        self._cache: Dict[Tuple, object] = {}

    def _load_net(self, arch: ArchSpec, sd: Dict[str, torch.Tensor]) -> UNet:
        net = UNet(arch)
        load_into(net, sd)
        net = net.to(self.device).eval()
        return net.prepare_fast() if self.compute_dtype is not None else net

    # -- what a subclass gives ----------------------------------------------

    def _net(self, batch: torch.Tensor) -> torch.Tensor:
        """(B, C, ph, pw) -> (*acc_prefix[:-1], B, L, ph, pw) fold-mean
        logits."""
        raise NotImplementedError

    def _decide(self, logits: torch.Tensor) -> torch.Tensor:
        """(*acc_prefix, H, W) logits on the input grid -> the device
        result that is downloaded."""
        raise NotImplementedError

    def _finish(self, out: np.ndarray) -> np.ndarray:
        """The downloaded result -> (H, W[, L]) uint8."""
        return out

    # -- the program ------------------------------------------------------

    def _build(self, in_shape: Tuple[int, int], in_spacing: Tuple[float, float]):
        pre = self.spec.preprocess
        patch = tuple(pre.patch_size)
        dev = self.device

        rs_shape = compute_new_shape(in_shape, in_spacing, pre.spacing)
        pad_shape = padded_shape(rs_shape, patch)
        pads = pad_amounts(rs_shape, pad_shape)
        tiles = tile_positions(pad_shape, patch, self.tile_step_size)
        mirrors = _mirror_combos(self.spec.allowed_mirroring_axes
                                 if self.use_mirroring else ())
        gauss = torch.tensor(gaussian_map(patch), device=dev)

        def _w(n_in, n_out, order):
            if n_in == n_out:
                return None
            coords = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
            return torch.tensor(axis_weights(n_in, coords, order, outside='edge'),
                                dtype=torch.float32, device=dev)

        w_down = [_w(in_shape[k], rs_shape[k], 3) for k in range(2)]
        w_up = [_w(rs_shape[k], in_shape[k], 1) for k in range(2)]
        down_axes = [k for k in range(2) if w_down[k] is not None]

        def program(arr: torch.Tensor,
                    nz_mask: Optional[torch.Tensor]) -> torch.Tensor:
            # arr: (H, W, C) float32 on the device
            work = normalize_channels(arr, pre, nz_mask)
            if down_axes:
                work = bspline_prefilter(work, down_axes)
                work = apply_separable(work, w_down, axes=(0, 1))
            work = F.pad(work.permute(2, 0, 1),
                         (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
            acc = torch.zeros(self.acc_prefix + pad_shape, device=dev)
            wacc = torch.zeros((1,) + pad_shape, device=dev)
            accumulate_tiles(work, tiles, self._net, acc, wacc, patch=patch,
                             mirrors=mirrors, gauss=gauss)
            logits = acc / torch.clamp(wacc, min=1e-8)
            logits = logits[..., pads[0][0]:pads[0][0] + rs_shape[0],
                            pads[1][0]:pads[1][0] + rs_shape[1]]
            logits = apply_separable(logits, w_up, axes=(-2, -1))
            return self._decide(logits)

        return program, {'n_tiles': len(tiles), 'n_mirror': len(mirrors)}

    def _program(self, in_shape, in_spacing):
        key = (tuple(in_shape), tuple(round(float(s), 6) for s in in_spacing))
        hit = self._cache.get(key)
        if hit is None:
            hit = self._build(tuple(in_shape), tuple(in_spacing))
            self._cache[key] = hit
            log(f'prepared {self.kind} program for shape={key[0]} '
                f'({hit[1]["n_tiles"]} tiles, {hit[1]["n_mirror"]} mirrors, '
                f'{self.n_folds} folds, '
                f'{"fast" if self.compute_dtype else "exact"}, {self.device})')
        return hit[0]

    # -- host API -----------------------------------------------------------

    def predict_array(self, arr: np.ndarray, spacing_yx: Sequence[float]
                      ) -> np.ndarray:
        """(H, W, C) float array with array-order (y, x) spacing -> the
        engine's uint8 result on the full (H, W) grid. Crops to the nonzero
        bounding box first (nnU-Net crop_to_nonzero)."""
        if arr.ndim == 2:
            arr = arr[..., None]
        if arr.shape[-1] != self.spec.arch.in_channels:
            raise ValueError(
                f'Input has {arr.shape[-1]} channels; the models expect '
                f'{self.spec.arch.in_channels}')
        (y0, y1), (x0, x1) = _nonzero_bbox(arr)
        cropped = np.ascontiguousarray(arr[y0:y1, x0:x1], np.float32)
        program = self._program(cropped.shape[:2], spacing_yx)
        x = torch.from_numpy(cropped).to(self.device)
        mask = None
        if any(self.spec.preprocess.use_mask_for_norm):
            mask = torch.from_numpy(nonzero_norm_mask(cropped)).to(self.device)
        with torch.no_grad(), exact_numerics():
            seg_c = self._finish(program(x, mask).cpu().numpy())
        if seg_c.shape[:2] == arr.shape[:2]:
            return seg_c
        seg = np.zeros(arr.shape[:2] + seg_c.shape[2:], np.uint8)
        seg[y0:y1, x0:x1] = seg_c
        return seg
