"""The configuration's model database: an nnU-Net results tree per group
(model.json, plans.json, dataset.json, fold_0/checkpoint_final.pth), the
weights made by the benchmark from the configuration's ``weight_seed``.

It is written once per checkout under ``benchmark/build/db/`` (a directory
git ignores), named by a hash of the configuration file, and found there by
every later run. The reference reads the same checkpoint files back.

The network is the configuration's (manifest.check_config): a plans file
of a ResidualEncoderUNet names its class and gives its blocks a stage; one
of a PlainConvUNet names none, as the port's default. An optional
``plans_name`` names the plans in model.json (``nnu.plans``) and in the
trainer directory.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Dict, List

import torch

from . import manifest, reference

DEFAULT_PLANS = 'nnUNetPlans'
RESIDUAL_CLASS = ('dynamic_network_architectures.architectures.unet.'
                  'ResidualEncoderUNet')


def arch(config: dict, group: str):
    """The reference's architecture of one group: a ``reference.Arch`` or,
    for a ResidualEncoderUNet, a ``reference.ResArch``."""
    common = dict(in_channels=len(config['channels']),
                  out_channels=config['groups'][group],
                  features=tuple(config['features_per_stage']))
    if manifest.network(config) == manifest.RESIDUAL:
        return reference.ResArch(
            **common, blocks=tuple(config['n_blocks_per_stage']),
            n_conv_decoder=config['n_conv_per_stage_decoder'])
    return reference.Arch(**common, n_conv=config['n_conv_per_stage'])


def _plans(config: dict) -> dict:
    n = len(config['features_per_stage'])
    k = config['kernel_size']
    kwargs = {'n_stages': n,
              'features_per_stage': list(config['features_per_stage']),
              'kernel_sizes': [[k, k]] * n,
              'strides': [[1, 1]] + [[2, 2]] * (n - 1)}
    architecture = {'arch_kwargs': kwargs}
    if manifest.network(config) == manifest.RESIDUAL:
        architecture = {'network_class_name': RESIDUAL_CLASS, **architecture}
        kwargs['n_blocks_per_stage'] = list(config['n_blocks_per_stage'])
        kwargs['n_conv_per_stage_decoder'] = [
            config['n_conv_per_stage_decoder']] * (n - 1)
    else:
        kwargs['n_conv_per_stage'] = [config['n_conv_per_stage']] * n
        kwargs['n_conv_per_stage_decoder'] = [
            config['n_conv_per_stage']] * (n - 1)
    kwargs.update(conv_bias=True,
                  norm_op_kwargs={'eps': 1e-05, 'affine': True},
                  nonlin_kwargs={'inplace': True})
    return {'configurations': {'2d': {
        'patch_size': list(config['patch_size']),
        'spacing': list(config['spacing']),
        'normalization_schemes': [config['normalization']] * len(
            config['channels']),
        'use_mask_for_norm': [False] * len(config['channels']),
        'architecture': architecture}}}


def checkpoints(db: str, config: dict) -> Dict[str, List[str]]:
    """{group: [checkpoint path of each fold]} in the database."""
    trainer = ('nnUNetTrainer__'
               f"{config.get('plans_name', DEFAULT_PLANS)}__2d")
    out = {}
    for i, group in enumerate(config['groups']):
        d = os.path.join(db, f"{config['model_key']}_{group}", 'r001',
                         f'Dataset{200 + i}_{group}', trainer)
        out[group] = [os.path.join(d, f'fold_{f}', 'checkpoint_final.pth')
                      for f in config['folds']]
    return out


def ensure(root: str, config_path: str, config: dict, device,
           names: List[str]) -> str:
    """The database of this configuration in this checkout, written first
    if it is not there; returns its root. ``names``: label names to give
    the groups' labels in order (the program's palette, so that every
    label has its colour)."""
    with open(config_path, 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    db = os.path.join(root, 'benchmark', 'build', 'db',
                      f"{config['name']}-{digest}")
    if os.path.isdir(db):
        return db
    tmp = f'{db}.{os.getpid()}.tmp'
    shutil.rmtree(tmp, ignore_errors=True)
    _write(tmp, config, device, names)
    try:
        os.replace(tmp, db)   # atomic: a run never sees half a database
    except OSError:           # another run wrote it first
        shutil.rmtree(tmp, ignore_errors=True)
    return db


def _write(db: str, config: dict, device, names: List[str]) -> None:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(config['weight_seed']))
    plans = _plans(config)
    names = iter(names)
    for (group, n_labels), paths in zip(config['groups'].items(),
                                        checkpoints(db, config).values()):
        dataset = {'channel_names': {str(i): c for i, c in
                                     enumerate(config['channels'])},
                   'labels': {'background': 0, **{
                       next(names): j + 1 for j in range(n_labels)}},
                   'file_ending': '.nrrd', 'multilabel': True}
        data_dir = os.path.dirname(os.path.dirname(paths[0]))
        base = os.path.dirname(os.path.dirname(data_dir))
        os.makedirs(data_dir)
        nnu = {'configuration': '2d', 'folds': list(config['folds']),
               'predict': {'precision': config['precision'],
                           'stepsize': config['tile_step_size']}}
        if 'plans_name' in config:
            nnu['plans'] = config['plans_name']
        with open(os.path.join(base, 'model.json'), 'w') as f:
            json.dump({'param': {'nnu': nnu}}, f)
        for name, obj in (('plans.json', plans), ('dataset.json', dataset)):
            with open(os.path.join(data_dir, name), 'w') as f:
                json.dump(obj, f)
        for path in paths:
            state = reference.init_state(arch(config, group), gen,
                                         config['head_bias_shift'], device)
            os.makedirs(os.path.dirname(path))
            torch.save({'network_weights': {k: v.cpu() for k, v in
                                            state.items()},
                        'inference_allowed_mirroring_axes':
                            list(config['mirror_axes']),
                        'trainer_name': 'nnUNetTrainer'}, path)


def load_nets(db: str, config: dict, device) -> List[List[torch.nn.Module]]:
    """The reference's networks from the checkpoint files: per group, per
    fold, float32 on ``device``."""
    out = []
    for group, paths in checkpoints(db, config).items():
        folds = []
        for path in paths:
            net = reference.network(arch(config, group))
            sd = torch.load(path, map_location='cpu',
                            weights_only=True)['network_weights']
            net.load_state_dict(sd)
            folds.append(net.to(device).eval())
        out.append(folds)
    return out
