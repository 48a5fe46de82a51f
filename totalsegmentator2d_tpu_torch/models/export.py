"""Export trained models to the nnU-Net results layout.

Closes the training -> zoo loop: fold weights become a model directory
(``<root>/<model>_<group>/r###/`` with model.json, Dataset###/.../plans.json,
dataset.json, fold_N/checkpoint_final.pth) that the Zoo, HostedModel and
the original tool's loaders read (the reference package's
models/export.py). Checkpoints are torch state dicts in nnU-Net's key
layout (convert.params_to_state_dict), written with ``torch.save``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch

from ..utils.files import mkdirs, write_json
from .convert import params_to_state_dict
from .plans import ModelSpec


def build_plans_dict(spec: ModelSpec, plans_name: str = 'nnUNetPlans',
                     dataset_name: str = 'exported') -> dict:
    a = spec.arch
    return {
        'dataset_name': dataset_name,
        'plans_name': plans_name,
        'configurations': {
            spec.configuration: {
                'patch_size': list(spec.preprocess.patch_size),
                'spacing': list(spec.preprocess.spacing),
                'normalization_schemes': list(spec.preprocess.normalization_schemes),
                'use_mask_for_norm': list(spec.preprocess.use_mask_for_norm),
                'architecture': {
                    'network_class_name': ('dynamic_network_architectures.'
                                           'architectures.unet.PlainConvUNet'),
                    'arch_kwargs': {
                        'n_stages': a.n_stages,
                        'features_per_stage': list(a.features_per_stage),
                        'conv_op': 'torch.nn.modules.conv.Conv2d',
                        'kernel_sizes': [list(k) for k in a.kernel_sizes],
                        'strides': [list(s) for s in a.strides],
                        'n_conv_per_stage': list(a.n_conv_per_stage),
                        'n_conv_per_stage_decoder': list(a.n_conv_per_stage_decoder),
                        'conv_bias': a.conv_bias,
                        'norm_op': ('torch.nn.modules.instancenorm.'
                                    'InstanceNorm2d'),
                        'norm_op_kwargs': {'eps': a.norm_eps,
                                           'affine': a.norm_affine},
                        'dropout_op': None,
                        'nonlin': 'torch.nn.LeakyReLU',
                        'nonlin_kwargs': {'inplace': True},
                    },
                },
            },
        },
        'foreground_intensity_properties_per_channel': {
            str(i): (p or {}) for i, p in
            enumerate(spec.preprocess.intensity_properties)},
    }


def build_dataset_json(spec: ModelSpec) -> dict:
    labels = {'background': 0}
    labels.update({name: value for value, name in sorted(spec.labels.items())})
    return {
        'channel_names': {str(i): n for i, n in sorted(spec.channel_names.items())},
        'labels': labels,
        'numTraining': 0,
        'file_ending': spec.file_ending,
        'multilabel': spec.multilabel,
    }


def export_model_dir(root: str, model: str, group: str,
                     spec: ModelSpec, fold_params: Sequence,
                     revision: int = 1, task_id: int = 500,
                     trainer: str = 'nnUNetTrainer',
                     plans_name: str = 'nnUNetPlans',
                     epoch: Optional[int] = None) -> str:
    """Write a full zoo-compatible model directory; returns the model id.
    ``fold_params``: one UNet (or its state dict) per fold."""
    mid = f'{model}_{group}'
    base = os.path.join(root, mid, f'r{revision:03d}')
    task_name = f'Dataset{task_id:03d}_{model.replace("-", "")}{group}'
    data_dir = os.path.join(base, task_name,
                            f'{trainer}__{plans_name}__{spec.configuration}')
    mkdirs(data_dir)

    write_json(os.path.join(base, 'model.json'), {
        'param': {'nnu': {'configuration': spec.configuration,
                          'folds': list(range(len(fold_params))),
                          'plans': plans_name,
                          'trainer': trainer,
                          'task': task_id}}})
    write_json(os.path.join(data_dir, 'plans.json'),
               build_plans_dict(spec, plans_name, dataset_name=task_name))
    write_json(os.path.join(data_dir, 'dataset.json'), build_dataset_json(spec))

    for fold, params in enumerate(fold_params):
        fd = mkdirs(os.path.join(data_dir, f'fold_{fold}'))
        sd = params_to_state_dict(params)
        ckpt = {
            'network_weights': {k: torch.from_numpy(v) for k, v in sd.items()},
            'trainer_name': trainer,
            'inference_allowed_mirroring_axes': list(spec.allowed_mirroring_axes),
            'current_epoch': epoch if epoch is not None else 0,
        }
        torch.save(ckpt, os.path.join(fd, 'checkpoint_final.pth'))
    return mid
