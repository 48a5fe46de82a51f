"""2D U-Net (nnU-Net PlainConvUNet family) as a ``torch.nn.Module``.

The module tree and its state-dict names follow nnU-Net's
(``encoder.stages[s].convs[c].{conv,norm}``, ``decoder.transpconvs[d]``,
``decoder.stages[d].convs[c]``, ``decoder.seg_layers[d]``), so a
``checkpoint_final.pth`` loads almost directly (models/convert.py).

Each block is conv -> InstanceNorm -> LeakyReLU. InstanceNorm takes two-pass
fp32 statistics with the biased variance, as torch's InstanceNorm2d with
``track_running_stats=False``. As in the reference package, a block has a
norm only when the architecture has norm affines (``norm_affine``); without
them the block is conv -> LeakyReLU. Inference reads only the last (full
resolution) segmentation head; the deep-supervision heads are kept so that
checkpoints load strictly, but are not run.

Two compute classes, those of the reference ``forward``:

- exact (``compute_dtype=None``): fp32 everywhere;
- fast (``compute_dtype=torch.bfloat16``): bf16 conv operands with fp32
  accumulation, activations stored bf16, norm statistics fp32, the last
  head's output fp32. A stack of two or more 3x3 blocks with norms runs
  the fused chain (:meth:`ConvStack._forward_fused`): each block after the
  first is one launch of the fused norm-act-conv3x3 kernel
  (ops/cuda/fused_block.py) that reads the raw previous conv output once.
  Activations stay NCHW tensors in ``channels_last`` memory, so the
  kernel's NHWC view is free. Call :meth:`UNet.prepare_fast` after the
  weights are loaded and on their device: it casts the weights to bf16
  and packs the kernel's weights once.

:meth:`UNet.forward` takes and returns NHWC, the layout of the reference
package's ``forward``; the engines call :meth:`UNet.forward_nchw` to stay in
cuDNN's layout between tiles.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda.fused_block import fold_stats, fused_norm_act_conv, pack_weight
from ..utils.device import exact_numerics
from .plans import ArchSpec

BF16 = torch.bfloat16


def _conv_bf16(fn, x: torch.Tensor, w16: torch.Tensor,
               b: Optional[torch.Tensor], **kw) -> torch.Tensor:
    """A conv or transposed conv with bf16 operands, fp32 accumulation and a
    bf16 output, the bias added in bf16 (the reference's ``_conv`` /
    ``_conv_transpose`` with ``out_dtype=bf16``): cuDNN's bf16 conv on the
    card; on the CPU the fp32 conv of the bf16 values, rounded once."""
    x = x.to(BF16)
    if x.is_cuda:
        out = fn(x, w16, **kw)
    else:
        out = fn(x.float(), w16.float(), **kw).to(BF16)
    return out if b is None else out + b.to(BF16)[:, None, None]


def _leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalisation over H, W: two-pass fp32
    statistics (mean, then the mean of squared deviations), biased
    variance, then the affine."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


class ConvNormAct(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride, spec: ArchSpec):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, tuple(kernel), stride=tuple(stride),
                              padding=tuple((k - 1) // 2 for k in kernel),
                              bias=spec.conv_bias)
        self.norm = (InstanceNorm(cout, spec.norm_eps) if spec.norm_affine
                     else None)
        self.slope = float(spec.nonlin_slope)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return F.leaky_relu(x, self.slope)

    def forward_fast(self, x: torch.Tensor) -> torch.Tensor:
        """The bf16 block: bf16 conv, fp32 norm statistics, bf16 storage."""
        x = _conv_bf16(F.conv2d, x, self.conv.weight16, self.conv.bias,
                       stride=self.conv.stride, padding=self.conv.padding)
        if self.norm is not None:
            x = self.norm(x.float()).to(BF16)
        return _leaky(x, self.slope)


class ConvStack(nn.Module):
    def __init__(self, n: int, cin: int, cout: int, kernel, first_stride,
                 spec: ArchSpec):
        super().__init__()
        self.convs = nn.Sequential(*(
            ConvNormAct(cin if c == 0 else cout, cout, kernel,
                        first_stride if c == 0 else (1, 1), spec)
            for c in range(n)))
        # the reference's gate for the fused chain (models/unet.py:177-180)
        self.fused = (n > 1 and tuple(kernel) == (3, 3)
                      and spec.norm_affine)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convs(x)

    def forward_fast(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return self._forward_fused(x)
        for block in self.convs:
            x = block.forward_fast(x)
        return x

    def _forward_fused(self, x: torch.Tensor) -> torch.Tensor:
        """The reference's ``_conv_stack_fused``: the first block's conv and
        its [sum, sumsq] statistics (the kernel with ``apply_normact=False``
        when its stride is 1 and C >= 16, else a bf16 conv and one pass
        over its bf16 output), then one kernel launch per later block with
        the previous block's InstanceNorm folded into scale/shift, then a
        final fp32 normact rounded to bf16. (N, C, H, W) bf16 in and out,
        channels_last."""
        blocks = list(self.convs)
        first = blocks[0]
        if first.conv.stride == (1, 1) and x.shape[1] >= 16:
            xh = x.to(BF16).permute(0, 2, 3, 1).contiguous()
            y, stats = fused_norm_act_conv(xh, None, None, first.packed,
                                           first.bias32, apply_normact=False)
        else:
            y = _conv_bf16(F.conv2d, x, first.conv.weight16, first.conv.bias,
                           stride=first.conv.stride,
                           padding=first.conv.padding)
            y32 = y.float()
            stats = torch.stack([y32.sum(dim=(2, 3)),
                                 y32.square().sum(dim=(2, 3))], dim=1)
            y = y.permute(0, 2, 3, 1).contiguous()
        hw = y.shape[1] * y.shape[2]
        norm = first.norm
        for block in blocks[1:]:
            scale, shift = fold_stats(stats, hw, norm.weight, norm.bias,
                                      norm.eps)
            y, stats = fused_norm_act_conv(y, scale, shift, block.packed,
                                           block.bias32, slope=block.slope)
            norm = block.norm
        scale, shift = fold_stats(stats, hw, norm.weight, norm.bias, norm.eps)
        z = y.float() * scale[:, None, None, :] + shift[:, None, None, :]
        z = _leaky(z, blocks[-1].slope).to(BF16)
        return z.permute(0, 3, 1, 2)


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

    def forward_fast(self, skips: List[torch.Tensor]) -> torch.Tensor:
        x = skips[-1]
        n_dec = len(self.stages)
        for d in range(n_dec):
            tc = self.transpconvs[d]
            x = _conv_bf16(F.conv_transpose2d, x, tc.weight16, tc.bias,
                           stride=tc.stride)
            x = torch.cat([x, skips[n_dec - d - 1].to(BF16)], dim=1)
            x = self.stages[d].forward_fast(x)
        # the last head: bf16 operands, fp32 output (the reference's
        # head_dtype=None); a bf16 conv would round it, so fp32, no TF32
        head = self.seg_layers[-1]
        with exact_numerics():
            out = F.conv2d(x.float(), head.weight16.float())
        return out + head.bias[:, None, None]


class UNet(nn.Module):
    """PlainConvUNet for one :class:`ArchSpec`. Input H, W must be
    divisible by the total stride."""

    def __init__(self, spec: ArchSpec):
        super().__init__()
        self.spec = spec
        self.encoder = Encoder(spec)
        self.decoder = Decoder(spec)
        self._fast_ready = False

    @torch.no_grad()
    def prepare_fast(self) -> 'UNet':
        """Weights for the bf16 forward, made once: a bf16 copy of every
        conv and transposed-conv weight, and for every block of a fused
        stack its kernel weight (:func:`pack_weight`, HWIO bf16) and fp32
        bias. Call after loading the weights and moving to the device."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.weight16 = m.weight.detach().to(BF16)
            if isinstance(m, ConvStack) and m.fused:
                for block in m.convs:
                    conv = block.conv
                    block.packed = pack_weight(conv.weight.permute(2, 3, 1, 0))
                    block.bias32 = (conv.bias.detach().float()
                                    if conv.bias is not None else
                                    conv.weight.new_zeros(conv.out_channels))
        self._fast_ready = True
        return self

    def forward_nchw(self, x: torch.Tensor,
                     compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """(N, C_in, H, W) -> (N, C_out, H, W) fp32 logits."""
        if compute_dtype is None:
            return self.decoder(self.encoder(x))
        if compute_dtype != BF16:
            raise ValueError(f'compute_dtype must be None or torch.bfloat16, '
                             f'got {compute_dtype}')
        if not self._fast_ready:
            self.prepare_fast()
        x = x.contiguous(memory_format=torch.channels_last)
        skips = []
        for stage in self.encoder.stages:
            x = stage.forward_fast(x)
            skips.append(x)
        return self.decoder.forward_fast(skips)

    def forward(self, x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """(N, H, W, C_in) -> (N, H, W, C_out) logits."""
        out = self.forward_nchw(x.permute(0, 3, 1, 2).contiguous(),
                                compute_dtype)
        return out.permute(0, 2, 3, 1)
