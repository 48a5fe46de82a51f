"""nnU-Net plans.json / dataset.json parsing.

The published TS2D model zips carry the standard nnU-Net v2 results tree
(`<Dataset###>/<trainer>__<plans>__<config>/` with plans.json, dataset.json
and fold_N/checkpoint_final.pth — discovered by the reference at
wrapper.py:113-162). These parsers turn that schema into typed specs that
drive the U-Net module, the preprocessor, and the inference engine.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ..utils.params import parse_int


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """2D U-Net architecture (nnU-Net PlainConvUNet family)."""
    n_stages: int
    features_per_stage: Tuple[int, ...]
    kernel_sizes: Tuple[Tuple[int, int], ...]
    strides: Tuple[Tuple[int, int], ...]
    n_conv_per_stage: Tuple[int, ...]
    n_conv_per_stage_decoder: Tuple[int, ...]
    conv_bias: bool = True
    norm_eps: float = 1e-5
    norm_affine: bool = True
    nonlin_slope: float = 0.01
    in_channels: int = 1
    out_channels: int = 1

    @property
    def total_stride(self) -> Tuple[int, ...]:
        s = [1, 1]
        for st in self.strides:
            s = [a * b for a, b in zip(s, st)]
        return tuple(s)


@dataclasses.dataclass(frozen=True)
class PreprocessSpec:
    spacing: Tuple[float, ...]                 # target spacing, (y, x) array order
    patch_size: Tuple[int, ...]                # (y, x)
    normalization_schemes: Tuple[str, ...]     # per input channel
    use_mask_for_norm: Tuple[bool, ...]
    intensity_properties: Tuple[Optional[dict], ...]  # per input channel


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    arch: ArchSpec
    preprocess: PreprocessSpec
    labels: Dict[int, str]                     # label value -> name (no background)
    channel_names: Dict[int, str]              # channel index -> projection name
    multilabel: bool
    file_ending: str = '.nrrd'
    allowed_mirroring_axes: Tuple[int, ...] = (0, 1)
    configuration: str = '2d'


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def parse_architecture(arch: dict, in_channels: int, out_channels: int) -> ArchSpec:
    """Parse the plans 'architecture' dict (nnU-Net >= 2.2 schema)."""
    kw = arch.get('arch_kwargs', arch)
    n_stages = int(kw['n_stages'])
    feats = tuple(int(f) for f in kw['features_per_stage'])
    kernels = tuple(_pair(k) for k in kw['kernel_sizes'])
    strides = tuple(_pair(s) for s in kw['strides'])
    ncs = kw.get('n_conv_per_stage', 2)
    ncs = tuple(int(v) for v in (ncs if isinstance(ncs, (list, tuple))
                                 else [ncs] * n_stages))
    ncd = kw.get('n_conv_per_stage_decoder', 2)
    ncd = tuple(int(v) for v in (ncd if isinstance(ncd, (list, tuple))
                                 else [ncd] * (n_stages - 1)))
    norm_kwargs = kw.get('norm_op_kwargs') or {}
    nonlin_kwargs = kw.get('nonlin_kwargs') or {}
    conv_op = str(kw.get('conv_op', 'Conv2d'))
    if '3d' in conv_op.lower():
        raise ValueError('Only 2D models are supported (got a 3D conv_op)')
    return ArchSpec(
        n_stages=n_stages,
        features_per_stage=feats,
        kernel_sizes=kernels,
        strides=strides,
        n_conv_per_stage=ncs,
        n_conv_per_stage_decoder=ncd,
        conv_bias=bool(kw.get('conv_bias', True)),
        norm_eps=float(norm_kwargs.get('eps', 1e-5)),
        norm_affine=bool(norm_kwargs.get('affine', True)),
        nonlin_slope=float(nonlin_kwargs.get('negative_slope', 0.01)),
        in_channels=in_channels,
        out_channels=out_channels,
    )


def _legacy_architecture(cfg: dict, in_channels: int, out_channels: int) -> ArchSpec:
    """nnU-Net 2.0/2.1 plans keep architecture fields directly in the
    configuration dict."""
    kernels = cfg['conv_kernel_sizes']
    strides = cfg['pool_op_kernel_sizes']
    n_stages = len(kernels)
    base = int(cfg.get('UNet_base_num_features', 32))
    maxf = int(cfg.get('unet_max_num_features', 512))
    feats = tuple(min(base * (2 ** i), maxf) for i in range(n_stages))
    ncs = cfg.get('n_conv_per_stage_encoder', [2] * n_stages)
    ncd = cfg.get('n_conv_per_stage_decoder', [2] * (n_stages - 1))
    return ArchSpec(
        n_stages=n_stages,
        features_per_stage=feats,
        kernel_sizes=tuple(_pair(k) for k in kernels),
        strides=tuple(_pair(s) for s in strides),
        n_conv_per_stage=tuple(int(v) for v in ncs),
        n_conv_per_stage_decoder=tuple(int(v) for v in ncd),
        in_channels=in_channels,
        out_channels=out_channels,
    )


def parse_labels(dataset_json: dict) -> Dict[int, str]:
    """dataset.json 'labels' maps name -> value (or region list); return
    value -> name without background (reference wrapper.py:267-274 keeps the
    insertion order of names)."""
    labels: Dict[int, str] = {}
    for name, value in dataset_json.get('labels', {}).items():
        if isinstance(value, (list, tuple)):
            value = value[0] if value else 0
        value = int(value)
        if name.lower() == 'background' or (value == 0 and name.lower() in ('background', 'bg')):
            continue
        labels[value] = name
    return labels


def parse_channels(dataset_json: dict) -> Dict[int, str]:
    src = dataset_json.get('channel_names', dataset_json.get('modality', {}))
    return {parse_int(k): str(v) for k, v in src.items()}


def parse_model_spec(plans: dict, dataset_json: dict,
                     configuration: str = '2d',
                     checkpoint_meta: Optional[dict] = None) -> ModelSpec:
    cfg = plans['configurations'][configuration]
    channels = parse_channels(dataset_json)
    labels = parse_labels(dataset_json)
    multilabel = bool(dataset_json.get('multilabel',
                                       dataset_json.get('multiclass', False)))
    in_channels = max(len(channels), 1)
    # multilabel fork: one sigmoid channel per structure; classic nnU-Net:
    # softmax over background + labels
    out_channels = len(labels) if multilabel else len(labels) + 1

    if 'architecture' in cfg:
        arch = parse_architecture(cfg['architecture'], in_channels, out_channels)
    else:
        arch = _legacy_architecture(cfg, in_channels, out_channels)

    norm_schemes = cfg.get('normalization_schemes',
                           ['ZScoreNormalization'] * in_channels)
    use_mask = cfg.get('use_mask_for_norm', [False] * in_channels)
    props_per_ch = plans.get('foreground_intensity_properties_per_channel', {})
    props = tuple(props_per_ch.get(str(c)) for c in range(in_channels))

    pre = PreprocessSpec(
        spacing=tuple(float(s) for s in cfg['spacing']),
        patch_size=tuple(int(p) for p in cfg['patch_size']),
        normalization_schemes=tuple(str(s) for s in norm_schemes),
        use_mask_for_norm=tuple(bool(b) for b in use_mask),
        intensity_properties=props,
    )

    mirror_axes: Tuple[int, ...] = (0, 1)
    if checkpoint_meta and checkpoint_meta.get('inference_allowed_mirroring_axes') is not None:
        mirror_axes = tuple(int(a) for a in
                            checkpoint_meta['inference_allowed_mirroring_axes'])

    return ModelSpec(
        arch=arch,
        preprocess=pre,
        labels=labels,
        channel_names=channels,
        multilabel=multilabel,
        file_ending=str(dataset_json.get('file_ending', '.nrrd')),
        allowed_mirroring_axes=mirror_axes,
        configuration=configuration,
    )
