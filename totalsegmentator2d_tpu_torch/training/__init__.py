"""Training: losses, augmentation, the train step and trainer, planning,
preprocessing, the ``ts2d-torch-train`` CLI (the reference package's
training/)."""

from .augment import augment_batch, augment_pair, spatial_transform_batch
from .cli import load_raw_dataset, ts2d_train
from .data import PatchSampler, pack_target_np, preprocess_case
from .losses import (bce_loss, ce_loss, deep_supervision_loss, dice_and_ce,
                     dice_score, soft_dice_loss)
from .planner import Fingerprint, compute_fingerprint, plan_experiment
from .train import (TrainConfig, Trainer, build_sharded_train_step,
                    ensemble_train_step, make_optimizer, poly_lr, train_step,
                    unpack_target)

__all__ = ['PatchSampler', 'preprocess_case', 'Fingerprint',
           'compute_fingerprint', 'plan_experiment',
           'augment_batch', 'augment_pair', 'spatial_transform_batch',
           'pack_target_np', 'unpack_target', 'bce_loss', 'ce_loss',
           'deep_supervision_loss', 'dice_and_ce', 'dice_score',
           'soft_dice_loss', 'TrainConfig', 'Trainer',
           'build_sharded_train_step', 'ensemble_train_step',
           'make_optimizer', 'poly_lr', 'train_step', 'load_raw_dataset',
           'ts2d_train']
