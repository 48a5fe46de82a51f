"""2D U-Net (nnU-Net PlainConvUNet family) as a ``torch.nn.Module``.

The module tree and its state-dict names follow nnU-Net's
(``encoder.stages[s].convs[c].{conv,norm}``, ``decoder.transpconvs[d]``,
``decoder.stages[d].convs[c]``, ``decoder.seg_layers[d]``), so a
``checkpoint_final.pth`` loads almost directly (models/convert.py).

Each block is conv -> InstanceNorm -> LeakyReLU. InstanceNorm takes two-pass
fp32 statistics with the biased variance, as torch's InstanceNorm2d with
``track_running_stats=False``. Inference reads only the last (full
resolution) segmentation head; the deep-supervision heads are kept so that
checkpoints load strictly, but are not run.

:meth:`UNet.forward` takes and returns NHWC, the layout of the reference
package's ``forward``; the engine calls :meth:`UNet.forward_nchw` to stay in
cuDNN's layout between tiles.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from .plans import ArchSpec


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalisation over H, W: two-pass fp32
    statistics (mean, then the mean of squared deviations), biased
    variance, then the optional affine."""

    def __init__(self, channels: int, eps: float, affine: bool):
        super().__init__()
        self.eps = float(eps)
        if affine:
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        else:
            self.register_parameter('weight', None)
            self.register_parameter('bias', None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight[:, None, None]
            y = y + self.bias[:, None, None]
        return y


class ConvNormAct(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride, spec: ArchSpec):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, tuple(kernel), stride=tuple(stride),
                              padding=tuple((k - 1) // 2 for k in kernel),
                              bias=spec.conv_bias)
        self.norm = InstanceNorm(cout, spec.norm_eps, spec.norm_affine)
        self.slope = float(spec.nonlin_slope)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.norm(self.conv(x)), self.slope)


class ConvStack(nn.Module):
    def __init__(self, n: int, cin: int, cout: int, kernel, first_stride,
                 spec: ArchSpec):
        super().__init__()
        self.convs = nn.Sequential(*(
            ConvNormAct(cin if c == 0 else cout, cout, kernel,
                        first_stride if c == 0 else (1, 1), spec)
            for c in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convs(x)


class Encoder(nn.Module):
    def __init__(self, spec: ArchSpec):
        super().__init__()
        stages, cin = [], spec.in_channels
        for s in range(spec.n_stages):
            stages.append(ConvStack(spec.n_conv_per_stage[s], cin,
                                    spec.features_per_stage[s],
                                    spec.kernel_sizes[s], spec.strides[s],
                                    spec))
            cin = spec.features_per_stage[s]
        self.stages = nn.ModuleList(stages)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        skips = []
        for stage in self.stages:
            x = stage(x)
            skips.append(x)
        return skips


class Decoder(nn.Module):
    def __init__(self, spec: ArchSpec):
        super().__init__()
        n_dec = spec.n_stages - 1
        transpconvs, stages, seg_layers = [], [], []
        for d in range(n_dec):
            enc_stage = n_dec - d  # the stage whose stride this undoes
            cbelow = spec.features_per_stage[enc_stage]
            cskip = spec.features_per_stage[enc_stage - 1]
            stride = tuple(spec.strides[enc_stage])
            transpconvs.append(nn.ConvTranspose2d(cbelow, cskip, stride,
                                                  stride,
                                                  bias=spec.conv_bias))
            stages.append(ConvStack(spec.n_conv_per_stage_decoder[d],
                                    2 * cskip, cskip,
                                    spec.kernel_sizes[enc_stage - 1], (1, 1),
                                    spec))
            seg_layers.append(nn.Conv2d(cskip, spec.out_channels, 1))
        self.transpconvs = nn.ModuleList(transpconvs)
        self.stages = nn.ModuleList(stages)
        self.seg_layers = nn.ModuleList(seg_layers)

    def forward(self, skips: List[torch.Tensor]) -> torch.Tensor:
        x = skips[-1]
        n_dec = len(self.stages)
        for d in range(n_dec):
            x = self.transpconvs[d](x)
            x = torch.cat([x, skips[n_dec - d - 1]], dim=1)
            x = self.stages[d](x)
        return self.seg_layers[-1](x)


class UNet(nn.Module):
    """PlainConvUNet for one :class:`ArchSpec`. Input H, W must be
    divisible by the total stride."""

    def __init__(self, spec: ArchSpec):
        super().__init__()
        self.spec = spec
        self.encoder = Encoder(spec)
        self.decoder = Decoder(spec)

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C_in) -> (N, H, W, C_out) logits."""
        out = self.forward_nchw(x.permute(0, 3, 1, 2).contiguous())
        return out.permute(0, 2, 3, 1)
