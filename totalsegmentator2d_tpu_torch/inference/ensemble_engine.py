"""EnsembleEngine: all anatomical-group models and folds on one scan.

The solo program of the reference package (inference/program.py) with the
G x F U-Nets of every group run one after another on the same tile batch,
the fold mean per group, then a per-group sigmoid>0.5 (or argmax), the
117-channel concat and bit-packing on the device.

``compute_dtype=None`` is the exact fp32 program; ``torch.bfloat16`` the
fast one, whose U-Nets run bf16 (models/unet.py) with every parameter
rounded to bf16 first, as the reference's fast ensemble stores them
(``ensemble_engine.py:438-443`` there).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..models.convert import round_to_bf16
from ..models.plans import ModelSpec
from ..models.unet import UNet
from .program import ScanEngine


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


class EnsembleEngine(ScanEngine):
    """Fused multi-group multi-fold inference.

    :param specs: per-group ModelSpecs; architectures must match except for
        the segmentation-head width, and preprocessing must be identical
    :param group_fold_params: state_dicts[group][fold] of the UNet module
    :param compute_dtype: ``None`` (exact) or ``torch.bfloat16`` (fast)
    :param device: ``None`` = the CUDA card (raises without one); pass
        ``'cpu'`` to run on the CPU
    """

    kind = 'ensemble'

    def __init__(self, specs: Sequence[ModelSpec],
                 group_fold_params: Sequence[Sequence[Dict[str, torch.Tensor]]],
                 tile_step_size: float = 0.5, use_mirroring: bool = True,
                 compute_dtype: Optional[torch.dtype] = None, device=None):
        if not specs:
            raise ValueError('At least one group is required')
        super().__init__(specs[0], tile_step_size, use_mirroring,
                         compute_dtype, device)
        self.specs = list(specs)
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
        self.acc_prefix = (self.n_groups, self.max_labels)

        arch = dataclasses.replace(self.spec.arch, out_channels=self.max_labels)
        self.models: List[List[UNet]] = []
        for g, folds in enumerate(group_fold_params):
            row = []
            for sd in folds:
                sd = pad_head(sd, self.label_counts[g], self.max_labels)
                if compute_dtype is not None:
                    sd = round_to_bf16(sd)
                row.append(self._load_net(arch, sd))
            self.models.append(row)

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
            logits = [m.forward_nchw(batch, self.compute_dtype) for m in folds]
            outs.append(torch.stack(logits).mean(dim=0))
        return torch.stack(outs)

    def _decide(self, logits: torch.Tensor) -> torch.Tensor:
        """(G, Lp, H, W) -> (H, W, ceil(L/8)) packed per-group decisions,
        channels last."""
        parts = []
        for g, n in enumerate(self.label_counts):
            lg = logits[g, :n].permute(1, 2, 0)
            if self.specs[g].multilabel:
                parts.append((torch.sigmoid(lg) > 0.5).to(torch.uint8))
            else:
                parts.append(F.one_hot(torch.argmax(lg, dim=-1), n)
                             .to(torch.uint8)[..., 1:])
        return _pack_bits(torch.cat(parts, dim=-1))

    def _finish(self, out: np.ndarray) -> np.ndarray:
        return unpack_bits(out, self.total_labels)
