"""EnsembleEngine: all anatomical-group models and folds on one scan.

The solo "exact" program of the reference package, in eager PyTorch:

    normalize -> B-spline prefilter + matmul down-resample to plan spacing
    -> symmetric pad -> tile x TTA batched forwards of the G x F U-Nets
    (one after another on the same tile batch, then the fold mean)
    -> Gaussian overlap-add -> weight normalization -> un-pad
    -> order-1 up-resample -> per-group sigmoid>0.5 (or argmax)
    -> 117-channel concat + bit-packing on the device

The program runs fp32 under :func:`~..utils.device.exact_numerics` (no
TF32, fixed cuDNN algorithms). Inputs upload as float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.convert import load_into
from ..models.plans import ModelSpec
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


def pad_head(sd: Dict[str, torch.Tensor], n_labels: int,
             max_labels: int) -> Dict[str, torch.Tensor]:
    """Pad every segmentation head of a state dict from n_labels to
    max_labels outputs with zero weights and biases: the padded logits are
    exactly 0 and are sliced away before any decision."""
    if n_labels == max_labels:
        return sd
    extra = max_labels - n_labels
    out = dict(sd)
    for k, v in sd.items():
        if k.startswith('decoder.seg_layers.'):
            out[k] = torch.cat([v, v.new_zeros((extra,) + v.shape[1:])])
    return out


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a (..., L) 0/1 uint8 tensor into (..., ceil(L/8)) uint8, little
    bit order (numpy ``np.unpackbits(..., bitorder='little')``)."""
    L = bits.shape[-1]
    Lpad = -(-L // 8) * 8
    if Lpad != L:
        bits = F.pad(bits, (0, Lpad - L))
    grouped = bits.reshape(bits.shape[:-1] + (Lpad // 8, 8))
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8,
                           device=bits.device)
    return (grouped * weights).sum(dim=-1, dtype=torch.uint8)


def unpack_bits(packed: np.ndarray, n_labels: int) -> np.ndarray:
    """Host-side inverse of :func:`_pack_bits`."""
    packed = np.ascontiguousarray(packed)
    bits = np.unpackbits(packed.reshape(-1), bitorder='little')
    bits = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,))
    return bits[..., :n_labels]


class EnsembleEngine:
    """Fused multi-group multi-fold inference.

    :param specs: per-group ModelSpecs; architectures must match except for
        the segmentation-head width, and preprocessing must be identical
    :param group_fold_params: state_dicts[group][fold] of the UNet module
    :param device: ``None`` = the CUDA card (raises without one); pass
        ``'cpu'`` to run on the CPU
    """

    def __init__(self, specs: Sequence[ModelSpec],
                 group_fold_params: Sequence[Sequence[Dict[str, torch.Tensor]]],
                 tile_step_size: float = 0.5, use_mirroring: bool = True,
                 device=None):
        if not specs:
            raise ValueError('At least one group is required')
        self.device = resolve_device(device)
        self.specs = list(specs)
        self.spec = specs[0]
        head_free = dataclasses.replace(self.spec.arch, out_channels=0)
        for s in specs[1:]:
            if s.preprocess != self.spec.preprocess:
                raise ValueError('All groups must share one preprocessing '
                                 'configuration')
            if dataclasses.replace(s.arch, out_channels=0) != head_free:
                raise ValueError('All groups must share one architecture '
                                 '(up to the segmentation-head width)')
        for s in specs:
            # the merge maps channel i <-> label value i+1 (multilabel) and
            # one_hot[..., 1:] <-> sorted values (softmax): both need
            # contiguous 1-based label values
            if s.labels and sorted(s.labels) != list(range(1, len(s.labels) + 1)):
                raise ValueError(
                    f'Label values must be contiguous starting at 1 for the '
                    f'fused ensemble; got {sorted(s.labels)}')
        self.label_counts = [s.arch.out_channels for s in specs]
        # packed output channels per group: softmax groups drop background
        self.output_label_counts = [
            s.arch.out_channels - (0 if s.multilabel else 1) for s in specs]
        self.max_labels = max(self.label_counts)
        self.n_groups = len(specs)
        self.n_folds = len(group_fold_params[0])
        if any(len(f) != self.n_folds for f in group_fold_params):
            raise ValueError('All groups must provide the same fold count')
        self.tile_step_size = float(tile_step_size)
        self.use_mirroring = bool(use_mirroring)

        arch = dataclasses.replace(self.spec.arch, out_channels=self.max_labels)
        self.models: List[List[UNet]] = []
        for g, folds in enumerate(group_fold_params):
            row = []
            for sd in folds:
                net = UNet(arch)
                load_into(net, pad_head(sd, self.label_counts[g],
                                        self.max_labels))
                row.append(net.to(self.device).eval())
            self.models.append(row)
        self._cache: Dict[Tuple, object] = {}

    @property
    def total_labels(self) -> int:
        """Total packed output channels (softmax groups contribute
        out_channels - 1: background is dropped on device)."""
        return sum(self.output_label_counts)

    def labels(self) -> Dict[int, str]:
        """Merged label map: 1-based values in group order."""
        out: Dict[int, str] = {}
        v = 0
        for s in self.specs:
            for _, name in sorted(s.labels.items()):
                v += 1
                out[v] = name
        return out

    # -- the program ------------------------------------------------------

    def _net(self, batch: torch.Tensor) -> torch.Tensor:
        """(B, C, ph, pw) -> (G, B, Lp, ph, pw): every group's fold mean."""
        outs = []
        for folds in self.models:
            logits = [m.forward_nchw(batch) for m in folds]
            outs.append(torch.stack(logits).mean(dim=0))
        return torch.stack(outs)

    def _build(self, in_shape: Tuple[int, int], in_spacing: Tuple[float, float]):
        spec = self.spec
        pre = spec.preprocess
        patch = tuple(pre.patch_size)
        dev = self.device

        rs_shape = compute_new_shape(in_shape, in_spacing, pre.spacing)
        pad_shape = padded_shape(rs_shape, patch)
        pads = pad_amounts(rs_shape, pad_shape)
        tiles = tile_positions(pad_shape, patch, self.tile_step_size)
        mirrors = _mirror_combos(spec.allowed_mirroring_axes
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
        G, Lp = self.n_groups, self.max_labels

        def program(arr: torch.Tensor,
                    nz_mask: Optional[torch.Tensor]) -> torch.Tensor:
            # arr: (H, W, C) float32 on the device -> (H, W, ceil(L/8)) uint8
            work = normalize_channels(arr, pre, nz_mask)
            if down_axes:
                work = bspline_prefilter(work, down_axes)
                work = apply_separable(work, w_down, axes=(0, 1))
            work = F.pad(work.permute(2, 0, 1),
                         (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
            acc = torch.zeros((G, Lp) + pad_shape, device=dev)
            wacc = torch.zeros((1,) + pad_shape, device=dev)
            accumulate_tiles(work, tiles, self._net, acc, wacc, patch=patch,
                             mirrors=mirrors, gauss=gauss)
            logits = acc / torch.clamp(wacc, min=1e-8)
            logits = logits[:, :, pads[0][0]:pads[0][0] + rs_shape[0],
                            pads[1][0]:pads[1][0] + rs_shape[1]]
            logits = apply_separable(logits, w_up, axes=(2, 3))
            # per-group decision + multilabel concat, channels last
            parts = []
            for g, n in enumerate(self.label_counts):
                lg = logits[g, :n].permute(1, 2, 0)
                if self.specs[g].multilabel:
                    parts.append((torch.sigmoid(lg) > 0.5).to(torch.uint8))
                else:
                    parts.append(F.one_hot(torch.argmax(lg, dim=-1), n)
                                 .to(torch.uint8)[..., 1:])
            return _pack_bits(torch.cat(parts, dim=-1))

        return program, {'n_tiles': len(tiles), 'n_mirror': len(mirrors)}

    def _program(self, in_shape, in_spacing):
        key = (tuple(in_shape), tuple(round(float(s), 6) for s in in_spacing))
        hit = self._cache.get(key)
        if hit is None:
            hit = self._build(tuple(in_shape), tuple(in_spacing))
            self._cache[key] = hit
            log(f'prepared ensemble program for shape={key[0]} '
                f'({self.n_groups} groups, {hit[1]["n_tiles"]} tiles, '
                f'{hit[1]["n_mirror"]} mirrors, {self.n_folds} folds, '
                f'{self.device})')
        return hit[0]

    # -- host API -----------------------------------------------------------

    def _place(self, seg_c: np.ndarray, bbox, full) -> np.ndarray:
        """Re-embed a cropped seg into the full input extent."""
        (y0, y1), (x0, x1) = bbox
        if seg_c.shape[:2] != tuple(full):
            seg = np.zeros(tuple(full) + (seg_c.shape[-1],), np.uint8)
            seg[y0:y1, x0:x1] = seg_c
            return seg
        return seg_c

    def predict_array(self, arr: np.ndarray, spacing_yx: Sequence[float]
                      ) -> np.ndarray:
        """(H, W, C) float array -> (H, W, sum(labels)) merged multilabel
        one-hot uint8. Crops to the nonzero bounding box first (nnU-Net
        crop_to_nonzero)."""
        if arr.ndim == 2:
            arr = arr[..., None]
        if arr.shape[-1] != self.spec.arch.in_channels:
            raise ValueError(
                f'Input has {arr.shape[-1]} channels; the models expect '
                f'{self.spec.arch.in_channels}')
        bbox = _nonzero_bbox(arr)
        (y0, y1), (x0, x1) = bbox
        cropped = np.ascontiguousarray(arr[y0:y1, x0:x1], np.float32)
        program = self._program(cropped.shape[:2], spacing_yx)
        x = torch.from_numpy(cropped).to(self.device)
        mask = None
        if any(self.spec.preprocess.use_mask_for_norm):
            mask = torch.from_numpy(nonzero_norm_mask(cropped)).to(self.device)
        with torch.no_grad(), exact_numerics():
            packed = program(x, mask).cpu().numpy()
        return self._place(unpack_bits(packed, self.total_labels), bbox,
                           arr.shape[:2])
