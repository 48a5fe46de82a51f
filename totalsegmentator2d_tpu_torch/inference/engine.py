"""InferenceEngine: one model configuration (all its folds) on one scan.

The per-model program of the reference package (its
``inference/engine.py``): the solo program of inference/program.py with the
model's F fold U-Nets and their mean, then sigmoid>0.5 into an (H, W, L)
multilabel one-hot, or the argmax into an (H, W) labelmap for a softmax
model. The engines of a model set that does not fuse into one ensemble.

Parameters stay float32 at both precisions, as the reference's per-model
engine keeps them; ``compute_dtype=torch.bfloat16`` runs the U-Nets bf16.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.plans import ModelSpec
from .program import ScanEngine, compute_new_shape  # noqa: F401


class InferenceEngine(ScanEngine):
    """Runs one model configuration (all folds) on 2D inputs.

    :param spec: the model's ModelSpec
    :param fold_params: state dicts of the UNet module, one per fold
    :param tile_step_size: sliding-window step as a fraction of the patch
    :param use_mirroring: mirror test-time augmentation
    :param compute_dtype: ``None`` (exact) or ``torch.bfloat16`` (fast)
    :param device: ``None`` = the CUDA card (raises without one); pass
        ``'cpu'`` to run on the CPU
    """

    kind = 'inference'

    def __init__(self, spec: ModelSpec,
                 fold_params: List[Dict[str, torch.Tensor]],
                 tile_step_size: float = 0.5, use_mirroring: bool = True,
                 compute_dtype: Optional[torch.dtype] = None, device=None):
        if not fold_params:
            raise ValueError('At least one fold is required')
        super().__init__(spec, tile_step_size, use_mirroring, compute_dtype,
                         device)
        self.n_folds = len(fold_params)
        self.acc_prefix = (spec.arch.out_channels,)
        self.models = [self._load_net(spec.arch, sd) for sd in fold_params]

    def _net(self, batch: torch.Tensor) -> torch.Tensor:
        """(B, C, ph, pw) -> (B, L, ph, pw), the fold mean."""
        return torch.stack([m.forward_nchw(batch, self.compute_dtype)
                            for m in self.models]).mean(dim=0)

    def _decide(self, logits: torch.Tensor) -> torch.Tensor:
        """(*lead, L, H, W) -> (*lead, H, W, L) multilabel one-hot or
        (*lead, H, W) labels."""
        if self.spec.multilabel:
            return (torch.sigmoid(logits) > 0.5).to(torch.uint8).movedim(-3, -1)
        return torch.argmax(logits, dim=-3).to(torch.uint8)

    def warmup(self, in_shape: Sequence[int],
               in_spacing: Optional[Sequence[float]] = None) -> None:
        """Build and run the program of an (H, W) input once (the
        reference's startup dummy predict): zeros at ``in_spacing``, the
        plan's spacing by default."""
        if in_spacing is None:
            in_spacing = self.spec.preprocess.spacing
        dummy = np.zeros(tuple(in_shape) + (self.spec.arch.in_channels,),
                         np.float32)
        self.predict_array(dummy, in_spacing)
