"""2D U-Net (nnU-Net PlainConvUNet family) as a ``torch.nn.Module``.

The module tree and its state-dict names follow nnU-Net's
(``encoder.stages[s].convs[c].{conv,norm}``, ``decoder.transpconvs[d]``,
``decoder.stages[d].convs[c]``, ``decoder.seg_layers[d]``), so a
``checkpoint_final.pth`` loads almost directly (models/convert.py).

Each block is conv -> InstanceNorm -> LeakyReLU. InstanceNorm takes two-pass
fp32 statistics with the biased variance, as torch's InstanceNorm2d with
``track_running_stats=False`` (one-pass under :func:`stats_override`, as
the batched serving program runs). As in the reference package, a block has a
norm only when the architecture has norm affines (``norm_affine``); without
them the block is conv -> LeakyReLU. Inference reads only the last (full
resolution) segmentation head; the deep-supervision heads run when
``deep_supervision`` is asked for (training), highest resolution first.

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

Training runs :meth:`UNet.forward_train`: the exact class, or the
reference's training compute dtype (bf16 conv operands with fp32
accumulation through stock cuDNN convs, fp32 norm statistics, bf16 heads
when ``head_dtype`` says so), by explicit casts that autograd goes
through; the fused kernel has no backward, in either package. ``remat``
recomputes the forward in the backward (``torch.utils.checkpoint``).
Under a height ``group`` (training's ``spatial=True``) each rank holds a
row slab of every activation: a 3x3 conv first takes its neighbours'
border rows (:func:`halo_extent`, parallel/collectives.halo_rows) and
InstanceNorm reduces its sums over the group.

:meth:`UNet.forward` takes and returns NHWC, the layout of the reference
package's ``forward``; the engines call :meth:`UNet.forward_nchw` to stay in
cuDNN's layout between tiles. :func:`forward` is the reference's functional
form: a state dict and an NHWC batch in, NHWC logits out.

:func:`init_params_np` is the reference's host initializer, bit for bit
(numpy ``default_rng``, the reference's params pytree);
:func:`init_params` draws the same He-normal weights from a
``torch.Generator`` straight into a state dict of the module.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops.cuda.fused_block import fold_stats, fused_norm_act_conv, pack_weight
from ..utils.device import exact_numerics
from .plans import ArchSpec

BF16 = torch.bfloat16
# the training forward's per-module hook: gate(module, fn, t) -> fn(t)
Gate = Optional[Callable[[nn.Module, Callable, torch.Tensor], torch.Tensor]]


def _ungated(module: nn.Module, fn: Callable, t: torch.Tensor) -> torch.Tensor:
    return fn(t)


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


_STATS_CTX = contextvars.ContextVar('ts2d_stats_override', default=None)


@contextlib.contextmanager
def stats_override(mode: str):
    """The InstanceNorm statistics form ('1pass' / '2pass') for the code run
    inside the block, in this thread or context, consulted by
    :func:`_one_pass_stats` when ``TS2D_STATS`` is unset. The ensemble
    engine runs its batched program under ``stats_override('1pass')``: that
    program is already non-bitwise against the solo exact program (other
    conv batch sizes), so it takes the one-traversal form, while the solo
    exact program, the bitwise parity path, stays two-pass. A context
    variable does not follow work into a new thread: the thread that runs
    the program enters it."""
    if mode not in ('1pass', '2pass'):
        raise ValueError(f"stats_override must be '1pass' or '2pass', "
                         f"got {mode!r}")
    tok = _STATS_CTX.set(mode)
    try:
        yield
    finally:
        _STATS_CTX.reset(tok)


def _one_pass_stats() -> bool:
    """Whether InstanceNorm takes the one-pass variance E[x^2] - E[x]^2
    (clamped at 0) instead of the mean of squared deviations. The
    environment variable TS2D_STATS ('1pass' / '2pass'), when set, forces
    one form everywhere; otherwise :func:`stats_override` decides, and the
    default is two-pass."""
    env = os.environ.get('TS2D_STATS')
    if env is not None:
        if env not in ('1pass', '2pass'):
            raise ValueError(
                f"TS2D_STATS must be '1pass' or '2pass', got {env!r}")
        return env == '1pass'
    return _STATS_CTX.get() == '1pass'


def _group_moments(x: torch.Tensor, group, one_pass: bool):
    """The per-(n, c) mean and biased variance over the rows of every
    rank's slab of ``group``: one reduction of [sum, sum of squares, count]
    (one-pass), or of [sum, count] and then of the centred sum of squares
    (two-pass)."""
    from ..parallel.collectives import sum_stats
    cnt = x.new_tensor([x.shape[2] * x.shape[3]])
    s1 = x.sum(dim=(2, 3))
    k = s1.numel()
    if one_pass:
        tot = sum_stats(torch.cat([s1.reshape(-1),
                                   x.square().sum(dim=(2, 3)).reshape(-1),
                                   cnt]), group)
        n = tot[-1]
        mean = (tot[:k] / n).view_as(s1)
        var = torch.clamp((tot[k:2 * k] / n).view_as(s1) - mean.square(),
                          min=0.0)
    else:
        tot = sum_stats(torch.cat([s1.reshape(-1), cnt]), group)
        n = tot[-1]
        mean = (tot[:k] / n).view_as(s1)
        dev = (x - mean[:, :, None, None]).square().sum(dim=(2, 3))
        var = sum_stats(dev, group) / n
    return mean[:, :, None, None], var[:, :, None, None]


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalisation over H, W: fp32 statistics with
    the biased variance, then the affine. The variance is two-pass (mean,
    then the mean of squared deviations) unless :func:`_one_pass_stats`.
    Under a height ``group`` the statistics are those of every rank's rows
    (:func:`_group_moments`)."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        if group is not None:
            mean, var = _group_moments(x, group, _one_pass_stats())
        else:
            mean = x.mean(dim=(2, 3), keepdim=True)
            if _one_pass_stats():
                var = torch.clamp(x.square().mean(dim=(2, 3), keepdim=True)
                                  - mean.square(), min=0.0)
            else:
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

    def forward_train(self, x: torch.Tensor, cdt: Optional[torch.dtype],
                      group=None) -> torch.Tensor:
        """The differentiable block: fp32 (``cdt=None``), or bf16 conv
        operands with a bf16 output, fp32 norm statistics and bf16 storage
        (the reference's ``_block`` with a compute dtype). ``group``: x is
        this rank's row slab of a height-sharded activation."""
        conv, padding = self.conv, self.conv.padding
        if group is not None:
            from ..parallel.collectives import halo_rows
            above, below = halo_extent(conv)
            if above or below:
                x = halo_rows(x, above, below, group)
            padding = (0, padding[1])
        if cdt is None:
            x = F.conv2d(x, conv.weight, conv.bias, conv.stride, padding)
            if self.norm is not None:
                x = self.norm(x, group)
            return F.leaky_relu(x, self.slope)
        x = _conv_bf16(F.conv2d, x, conv.weight.to(BF16), conv.bias,
                       stride=conv.stride, padding=padding)
        if self.norm is not None:
            x = self.norm(x.float(), group).to(BF16)
        return _leaky(x, self.slope)

    def forward_fast(self, x: torch.Tensor) -> torch.Tensor:
        """The bf16 block: bf16 conv, fp32 norm statistics, bf16 storage."""
        x = _conv_bf16(F.conv2d, x, self.conv.weight16, self.conv.bias,
                       stride=self.conv.stride, padding=self.conv.padding)
        if self.norm is not None:
            x = self.norm(x.float()).to(BF16)
        return _leaky(x, self.slope)


def halo_extent(conv: nn.Conv2d):
    """(rows above, rows below) of its neighbours' slabs that ``conv``
    needs at a height shard's borders, for slabs that start on a multiple
    of its stride: output row j reads input rows s*j - p .. s*j - p + k - 1
    (kernel k, stride s, padding p), so p rows above and k - p - s below (1
    and 1 for a 3x3 stride-1 conv, 1 and 0 at stride 2, none for 1x1)."""
    k, s, p = conv.kernel_size[0], conv.stride[0], conv.padding[0]
    return p, max(0, k - p - s)


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

    def forward_train(self, x: torch.Tensor, cdt: Optional[torch.dtype],
                      gate: Gate = None, group=None) -> torch.Tensor:
        gate = gate or _ungated
        for block in self.convs:
            x = gate(block, lambda t, b=block: b.forward_train(t, cdt, group),
                     x)
        return x

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

    def forward_train(self, skips: List[torch.Tensor],
                      cdt: Optional[torch.dtype], deep_supervision: bool,
                      head_dtype: Optional[torch.dtype], gate: Gate = None,
                      group=None):
        """The differentiable decoder; every head, highest resolution
        first, under ``deep_supervision``, else the last one. The
        transposed convs (kernel = stride) and the 1x1 heads need no halo
        under a height ``group``."""
        gate = gate or _ungated
        x = skips[-1]
        n_dec = len(self.stages)
        heads = []
        for d in range(n_dec):
            tc = self.transpconvs[d]
            if cdt is None:
                x = gate(tc, tc, x)
            else:
                x = gate(tc, lambda t: _conv_bf16(
                    F.conv_transpose2d, t, tc.weight.to(BF16), tc.bias,
                    stride=tc.stride), x)
            x = torch.cat([x, skips[n_dec - d - 1].to(x.dtype)], dim=1)
            x = self.stages[d].forward_train(x, cdt, gate, group)
            if deep_supervision or d == n_dec - 1:
                seg = self.seg_layers[d]
                heads.append(gate(seg, lambda t: _head(seg, t, cdt,
                                                       head_dtype), x))
        return heads[::-1] if deep_supervision else heads[-1]

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


def _head(layer: nn.Conv2d, x: torch.Tensor, cdt: Optional[torch.dtype],
          head_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A 1x1 segmentation head as the reference's ``_conv(...,
    compute_dtype, out_dtype=head_dtype)``: bf16 operands under a compute
    dtype, the output (and the bias add) in ``head_dtype`` (fp32 when
    None)."""
    if cdt is None:
        out = layer(x)
        return out if head_dtype is None else out.to(head_dtype)
    if head_dtype == BF16:
        return _conv_bf16(F.conv2d, x, layer.weight.to(BF16), layer.bias)
    out = F.conv2d(x.to(BF16).float(), layer.weight.to(BF16).float())
    return out + layer.bias[:, None, None]


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

    def forward_train(self, x: torch.Tensor,
                      compute_dtype: Optional[torch.dtype] = None,
                      deep_supervision: bool = False,
                      head_dtype: Optional[torch.dtype] = None,
                      remat: bool = False, gate: Gate = None, group=None):
        """The differentiable forward, (N, C_in, H, W) in: the logits
        (N, C_out, H, W), or with ``deep_supervision`` every head, highest
        resolution first (the reference's ``forward(params, x, spec,
        deep_supervision, compute_dtype, head_dtype)``). ``compute_dtype``
        None or bf16; ``remat`` keeps only the input and recomputes the
        forward in the backward pass. ``gate(module, fn, t)`` runs each
        block, transposed conv and head as ``fn(t)`` (the default); the
        tensor-parallel trainer wraps its sharded modules in collectives
        there (training/sharded.py). ``group``: the height group of a
        height-sharded trainer; x is this rank's row slab, which starts on
        a multiple of the total stride and spans a multiple of it, and so
        is every output."""
        if compute_dtype not in (None, BF16):
            raise ValueError(f'compute_dtype must be None or torch.bfloat16, '
                             f'got {compute_dtype}')

        def run(t):
            skips = []
            for stage in self.encoder.stages:
                t = stage.forward_train(t, compute_dtype, gate, group)
                skips.append(t)
            out = self.decoder.forward_train(skips, compute_dtype,
                                             deep_supervision, head_dtype,
                                             gate, group)
            return tuple(out) if deep_supervision else out

        out = (torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)
               if remat else run(x))
        return list(out) if deep_supervision else out

    def forward_nchw(self, x: torch.Tensor,
                     compute_dtype: Optional[torch.dtype] = None,
                     deep_supervision: bool = False):
        """(N, C_in, H, W) -> (N, C_out, H, W) fp32 logits; with
        ``deep_supervision`` the list of every head (fp32), highest
        resolution first, through :meth:`forward_train`."""
        if deep_supervision:
            return self.forward_train(x, compute_dtype, deep_supervision=True)
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
                compute_dtype: Optional[torch.dtype] = None,
                deep_supervision: bool = False):
        """(N, H, W, C_in) -> (N, H, W, C_out) logits (a list of them,
        highest resolution first, with ``deep_supervision``)."""
        out = self.forward_nchw(x.permute(0, 3, 1, 2).contiguous(),
                                compute_dtype, deep_supervision)
        if deep_supervision:
            return [o.permute(0, 2, 3, 1) for o in out]
        return out.permute(0, 2, 3, 1)


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor, spec: ArchSpec,
            deep_supervision: bool = False,
            compute_dtype: Optional[torch.dtype] = None,
            head_dtype: Optional[torch.dtype] = None):
    """The reference's functional ``forward``: the U-Net of ``spec`` with
    the weights ``params`` (a state dict of :class:`UNet`, every entry) on
    x (N, H, W, C_in), H and W divisible by the total stride. Returns the
    logits (N, H, W, C_out), or with ``deep_supervision`` every head,
    highest resolution first. ``compute_dtype=torch.bfloat16`` runs bf16
    conv operands with fp32 accumulation and norms; ``head_dtype`` is the
    heads' output dtype (fp32 when None). This is :meth:`UNet.
    forward_train` on the given tensors, differentiable in x and in
    ``params``."""
    with torch.device('meta'):
        net = UNet(spec)
    net.forward = net.forward_train
    out = torch.func.functional_call(
        net, params, (x.permute(0, 3, 1, 2).contiguous(),),
        {'compute_dtype': compute_dtype, 'deep_supervision': deep_supervision,
         'head_dtype': head_dtype}, strict=True)
    if deep_supervision:
        return [o.permute(0, 2, 3, 1) for o in out]
    return out.permute(0, 2, 3, 1)


def param_count(params: Union[nn.Module, Dict[str, torch.Tensor]]) -> int:
    """The number of weights of a state dict (or a module)."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    return sum(int(v.numel()) for v in params.values())


def pad_to_stride(shape: Sequence[int], total_stride: Sequence[int],
                  patch_size: Sequence[int]) -> Tuple[int, ...]:
    """Smallest spatial shape >= max(shape, patch) divisible by the stride."""
    return tuple(int(math.ceil(max(int(n), int(p)) / s) * s)
                 for n, s, p in zip(shape, total_stride, patch_size))


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, spec: ArchSpec,
                dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """A state dict of :class:`UNet` in ``dtype``, on the CPU: He-normal
    conv, transposed-conv and head weights with std sqrt(2 / fan_in),
    fan_in = input channels x kernel area (the reference's
    ``init_params``), zero biases, unit norm scales; drawn from
    ``generator`` in module order, in float32 and then cast, so every
    dtype takes the same draws."""
    sd: Dict[str, torch.Tensor] = {}
    for name, m in UNet(spec).named_modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = m.in_channels * math.prod(m.kernel_size)
            sd[name + '.weight'] = torch.randn(
                m.weight.shape, generator=generator) * math.sqrt(2.0 / fan_in)
            if m.bias is not None:
                sd[name + '.bias'] = torch.zeros(m.bias.shape)
        elif isinstance(m, InstanceNorm):
            sd[name + '.weight'] = torch.ones(m.weight.shape)
            sd[name + '.bias'] = torch.zeros(m.bias.shape)
    return {k: v.to(dtype) for k, v in sd.items()}


def init_params_np(seed: int, spec: ArchSpec, dtype=np.float32) -> dict:
    """The reference's host-side initializer (its ``init_params_np``), bit
    for bit: the params pytree of numpy arrays (conv weights HWIO,
    transposed-conv weights HWOI) that ``convert.params_from_jax`` turns
    into a state dict."""
    a = spec
    rng = np.random.default_rng(seed)

    def he(shape, fan_in):
        return (rng.standard_normal(shape) * math.sqrt(2.0 / fan_in)).astype(dtype)

    def conv_block(cin, cout, kernel):
        kh, kw = kernel
        p = {'conv': {'w': he((kh, kw, cin, cout), cin * kh * kw)}}
        if a.conv_bias:
            p['conv']['b'] = np.zeros((cout,), dtype)
        if a.norm_affine:
            p['norm'] = {'scale': np.ones((cout,), dtype),
                         'bias': np.zeros((cout,), dtype)}
        return p

    enc_stages = []
    cin = a.in_channels
    for s in range(a.n_stages):
        enc_stages.append([conv_block(cin if c == 0 else a.features_per_stage[s],
                                      a.features_per_stage[s], a.kernel_sizes[s])
                           for c in range(a.n_conv_per_stage[s])])
        cin = a.features_per_stage[s]

    transpconvs, dec_stages, seg_layers = [], [], []
    n_dec = a.n_stages - 1
    for d in range(n_dec):
        enc_stage = n_dec - d
        cin_below = a.features_per_stage[enc_stage]
        cskip = a.features_per_stage[enc_stage - 1]
        sh, sw = a.strides[enc_stage]
        transpconvs.append({'w': he((sh, sw, cskip, cin_below),  # HWOI
                                    cin_below * sh * sw),
                            'b': np.zeros((cskip,), dtype)})
        dec_stages.append([conv_block(2 * cskip if c == 0 else cskip, cskip,
                                      a.kernel_sizes[enc_stage - 1])
                           for c in range(a.n_conv_per_stage_decoder[d])])
        seg_layers.append({'w': he((1, 1, cskip, a.out_channels), cskip),
                           'b': np.zeros((a.out_channels,), dtype)})

    return {'encoder': {'stages': enc_stages},
            'decoder': {'transpconvs': transpconvs, 'stages': dec_stages,
                        'seg_layers': seg_layers}}
