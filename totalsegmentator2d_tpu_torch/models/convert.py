"""Weights into the :class:`~.unet.UNet` module.

 - :func:`load_checkpoint` reads an nnU-Net ``checkpoint_final.pth``
   (:func:`convert_checkpoint` also checks it against an architecture). Its
   state dict is nearly the module's own: conv weights are OIHW and
   transposed-conv weights IOHW in both. Key normalization drops the
   wrappers real checkpoints carry: ``module.`` (DDP), ``_orig_mod.``
   (torch.compile), the ``all_modules.N`` aliases, the decoder's
   back-reference to the encoder, and the extra ``.N`` level of the
   encoder's stage Sequential (:func:`normalize_state_dict`, of a loaded
   checkpoint :func:`extract_state_dict`). The reference turns that state
   dict into its params pytree (:func:`state_dict_to_params`); here the
   module's state dict is the params, and :func:`state_dict_to_params`
   checks it against the architecture.
 - :func:`params_from_jax` carries the reference package's params pytree
   (numpy arrays; conv weights HWIO, transposed-conv weights HWOI) across,
   so both implementations can run the same weights.
 - :func:`params_to_state_dict` is the export direction: the module's
   weights as the nnU-Net state dict of numpy arrays (the module's own
   names are nnU-Net's, so this is the inverse of :func:`load_into`), as
   the reference's ``params_to_state_dict`` writes them.
 - :func:`round_to_bf16` rounds every parameter to bf16 (kept as float32
   tensors): the reference's fast ``EnsembleEngine`` stores all its
   parameters in bf16, norm affines and biases included.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Tuple, Union

import numpy as np
import torch

from ..utils.logging import warn

_STRIP_PREFIXES = ('module.', '_orig_mod.')
_STAGE_LEVEL = re.compile(r'^(encoder|decoder)\.stages\.(\d+)\.\d+\.convs\.')


def load_torch_checkpoint(path: str, allow_pickle: bool = False) -> dict:
    """Load a checkpoint on the CPU with the safe ``weights_only``
    unpickler (checkpoints come from a network registry; the permissive
    loader runs arbitrary pickle code). ``allow_pickle=True`` or
    ``TS2D_TRUST_CHECKPOINTS=1`` re-enables the permissive loader for
    trusted files whose containers the safe one rejects."""
    try:
        return torch.load(path, map_location='cpu', weights_only=True)
    except Exception as ex:
        if allow_pickle or os.environ.get('TS2D_TRUST_CHECKPOINTS', '') == '1':
            return torch.load(path, map_location='cpu', weights_only=False)
        raise RuntimeError(
            f'Checkpoint {path!r} could not be loaded with the safe '
            f'weights-only unpickler ({ex}). If you trust this file, retry '
            f'with allow_pickle=True or set TS2D_TRUST_CHECKPOINTS=1.') from ex


def normalize_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """nnU-Net state-dict keys -> the UNet module's keys."""
    out = {}
    for k, v in sd.items():
        for p in _STRIP_PREFIXES:
            if k.startswith(p):
                k = k[len(p):]
        if k.startswith('decoder.encoder.') or '.all_modules.' in k:
            continue  # duplicates of parameters listed elsewhere
        out[_STAGE_LEVEL.sub(r'\1.stages.\2.convs.', k)] = torch.as_tensor(v)
    return out


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Read a checkpoint file: (module state dict, checkpoint meta)."""
    ckpt = load_torch_checkpoint(path)
    meta = {k: v for k, v in ckpt.items()
            if k in ('inference_allowed_mirroring_axes', 'trainer_name',
                     'current_epoch', 'init_args')}
    return extract_state_dict(ckpt), meta


def extract_state_dict(checkpoint: dict) -> Dict[str, torch.Tensor]:
    """The normalized module state dict of a loaded checkpoint (its
    ``network_weights``, ``state_dict`` or the dict itself)."""
    return normalize_state_dict(
        checkpoint.get('network_weights', checkpoint.get('state_dict',
                                                         checkpoint)))


def state_dict_to_params(sd: Dict[str, torch.Tensor], spec
                         ) -> Dict[str, torch.Tensor]:
    """The float32 weights of :class:`~.unet.UNet` for ``spec`` from a
    normalized state dict: entries the module does not have are reported
    and dropped; a missing or misshapen one raises ValueError."""
    from .unet import UNet
    with torch.device('meta'):
        own = UNet(spec).state_dict()
    unused = [k for k in sd if k not in own]
    if unused:
        warn(f'{len(unused)} checkpoint entries were not mapped '
             f'(first: {unused[:3]})')
    missing = [k for k in own if k not in sd]
    if missing:
        raise ValueError(f'{len(missing)} weights of the architecture are '
                         f'missing (first: {missing[:3]})')
    out = {}
    for k, v in own.items():
        t = torch.as_tensor(sd[k]).float()
        if tuple(t.shape) != tuple(v.shape):
            raise ValueError(f'{k}: weight {tuple(t.shape)} does not match '
                             f'the architecture {tuple(v.shape)}')
        out[k] = t
    return out


def convert_checkpoint(path: str, spec) -> Tuple[Dict[str, torch.Tensor],
                                                  dict]:
    """Load and check a checkpoint file: (the UNet's state dict for
    ``spec``, the checkpoint meta)."""
    sd, meta = load_checkpoint(path)
    return state_dict_to_params(sd, spec), meta


def load_into(model: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """Load a normalized state dict; entries the module does not have are
    reported and skipped, missing or misshapen ones raise."""
    own = model.state_dict()
    unused = [k for k in sd if k not in own]
    if unused:
        warn(f'{len(unused)} checkpoint entries were not mapped '
             f'(first: {unused[:3]})')
    model.load_state_dict({k: v for k, v in sd.items() if k in own},
                          strict=True)


def round_to_bf16(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every entry rounded to the nearest bf16 value, as float32: the same
    numbers as the reference's bf16-stored parameters (fp32 arithmetic on
    a bf16 operand promotes it exactly)."""
    return {k: v.to(torch.bfloat16).float() for k, v in sd.items()}


def params_from_jax(params: dict, bf16: bool = False) -> Dict[str, torch.Tensor]:
    """The reference package's params pytree (numpy leaves) -> a UNet
    state dict. ``bf16=True`` gives the parameters of the reference's fast
    ``EnsembleEngine`` (:func:`round_to_bf16`); its per-model fast engine
    keeps them float32."""
    sd: Dict[str, torch.Tensor] = {}

    def t(a, perm=None):
        a = np.asarray(a, np.float32)
        return torch.from_numpy(np.ascontiguousarray(
            a if perm is None else np.transpose(a, perm)))

    def put_block(prefix: str, block: dict):
        conv = block['conv']
        sd[prefix + '.conv.weight'] = t(conv['w'], (3, 2, 0, 1))  # HWIO->OIHW
        if 'b' in conv:
            sd[prefix + '.conv.bias'] = t(conv['b'])
        for src, dst in (('scale', 'weight'), ('bias', 'bias')):
            if src in (block.get('norm') or {}):
                sd[f'{prefix}.norm.{dst}'] = t(block['norm'][src])

    for s, stage in enumerate(params['encoder']['stages']):
        for c, block in enumerate(stage):
            put_block(f'encoder.stages.{s}.convs.{c}', block)
    dec = params['decoder']
    for d, tc in enumerate(dec['transpconvs']):
        sd[f'decoder.transpconvs.{d}.weight'] = t(tc['w'], (3, 2, 0, 1))  # HWOI->IOHW
        if 'b' in tc:
            sd[f'decoder.transpconvs.{d}.bias'] = t(tc['b'])
    for d, stage in enumerate(dec['stages']):
        for c, block in enumerate(stage):
            put_block(f'decoder.stages.{d}.convs.{c}', block)
    for d, sl in enumerate(dec['seg_layers']):
        sd[f'decoder.seg_layers.{d}.weight'] = t(sl['w'], (3, 2, 0, 1))
        if 'b' in sl:
            sd[f'decoder.seg_layers.{d}.bias'] = t(sl['b'])
    return round_to_bf16(sd) if bf16 else sd


def params_to_state_dict(params: Union[torch.nn.Module, Dict[str, torch.Tensor]]
                         ) -> Dict[str, np.ndarray]:
    """A UNet (or its state dict) -> the nnU-Net state dict of float32
    numpy arrays that ``checkpoint_final.pth`` holds: conv weights OIHW,
    transposed-conv weights IOHW, keys ``encoder.stages.{s}.convs.{c}.
    {conv,norm}.*``, ``decoder.{transpconvs,stages,seg_layers}.*``."""
    sd = params.state_dict() if isinstance(params, torch.nn.Module) else params
    return {k: v.detach().to('cpu', torch.float32).numpy().copy()
            for k, v in sd.items()}
