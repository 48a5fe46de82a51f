"""The training step and the trainer loop (the reference package's
training/train.py).

nnU-Net's optimization recipe: weight decay 3e-5, then SGD with Nesterov
momentum 0.99 on a polynomial learning-rate decay (power 0.9), Dice + CE /
BCE with deep supervision. One card: the reference's mesh (data, model and
ensemble axes, ``build_sharded_train_step``) comes with the parallel slice
and raises ``NotImplementedError`` here. A stacked ensemble
(``ensemble_size=G``) trains G independent models on the card, each on its
own targets with its own augmentation draws.

Numerics: fp32 training holds the exact settings (cuDNN without TF32, a
fixed algorithm choice) while a CUDA trainer lives, so the card trains in
the numerics class of the reference's CPU run; ``compute_dtype='bfloat16'``
runs bf16 conv operands with fp32 accumulation, fp32 norm statistics and
bf16 heads, with fp32 parameters, gradients, momentum and loss.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.convert import load_into
from ..models.plans import ArchSpec
from ..models.unet import UNet, init_params, stats_override
from ..utils.device import hold_exact_numerics, resolve_device
from .losses import deep_supervision_loss, dice_and_ce

_PARALLEL = ('is not ported yet: training over a device mesh comes with the '
             'parallel slice (torch.distributed)')


@dataclasses.dataclass
class TrainConfig:
    lr: float = 1e-2
    momentum: float = 0.99
    weight_decay: float = 3e-5
    total_steps: int = 1000
    poly_power: float = 0.9
    deep_supervision: bool = True
    multilabel: bool = True
    # recompute the forward in the backward pass (less memory, more work)
    remat: bool = False
    # 'bfloat16': bf16 conv operands and activations (parameters,
    # gradients, momentum, logits and the loss stay fp32)
    compute_dtype: Optional[str] = None
    # run the on-device nnU-Net augmentation recipe (augment.py) on every
    # batch the Trainer steps on
    augment: bool = False
    # InstanceNorm statistics of the training step: the one-pass form by
    # default (training has no bitwise contract); '2pass' gives torch's
    # two-pass statistics. TS2D_STATS (env) overrides both.
    stats: str = '1pass'

    def __post_init__(self):
        if self.compute_dtype not in (None, 'bfloat16', 'bf16'):
            raise ValueError(
                f"compute_dtype must be None or 'bfloat16'; "
                f"got {self.compute_dtype!r} (fp16 is not offered — bf16 "
                f"is the mixed-precision dtype and needs no loss scaling)")
        if self.stats not in ('1pass', '2pass'):
            raise ValueError(
                f"stats must be '1pass' or '2pass'; got {self.stats!r}")


def poly_lr(cfg: TrainConfig, count: int) -> float:
    """The polynomial schedule at update ``count`` (0 for the first),
    in float32 as optax's ``polynomial_schedule``: lr * (1 - t/T)^power,
    t clipped to [0, T]."""
    f32 = np.float32
    t = f32(min(max(int(count), 0), cfg.total_steps))
    frac = f32(1.0) - t / f32(cfg.total_steps)
    return float(f32(cfg.lr) * frac ** f32(cfg.poly_power))


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.SGD:
    """Weight decay, then SGD with Nesterov momentum: torch's SGD computes
    g' = g + wd * p, buf = m * buf + g', p -= lr * (g' + m * buf), which is
    optax's ``add_decayed_weights`` -> ``sgd(nesterov=True)`` chain (held
    equal in tests/test_torch_train.py). The learning rate of each step is
    :func:`poly_lr`, set by :func:`train_step`."""
    return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                           nesterov=True, weight_decay=cfg.weight_decay)


def _compute_dtype(cfg: TrainConfig) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.compute_dtype in ('bfloat16', 'bf16') else None


def loss_fn(model: UNet, batch: Dict[str, torch.Tensor],
            cfg: TrainConfig) -> torch.Tensor:
    """The loss of one batch (image (N, H, W, C) float, target (N, H, W, L)
    one-hot or (N, H, W) labels), under ``stats_override(cfg.stats)``."""
    cdt = _compute_dtype(cfg)
    x = batch['image'].permute(0, 3, 1, 2).contiguous()
    with stats_override(cfg.stats):
        out = model.forward_train(x, compute_dtype=cdt,
                                  deep_supervision=cfg.deep_supervision,
                                  head_dtype=cdt, remat=cfg.remat)
        if cfg.deep_supervision:
            heads = [o.float().permute(0, 2, 3, 1) for o in out]
            return deep_supervision_loss(heads, batch['target'],
                                         cfg.multilabel)
        return dice_and_ce(out.float().permute(0, 2, 3, 1), batch['target'],
                           cfg.multilabel)


def train_step(model: UNet, optimizer: torch.optim.SGD,
               batch: Dict[str, torch.Tensor], *, cfg: TrainConfig,
               count: int) -> torch.Tensor:
    """One optimization step (update number ``count``): loss, backward
    (recomputing under the same statistics form when ``cfg.remat``), the
    scheduled SGD update. Returns the detached loss."""
    optimizer.zero_grad(set_to_none=True)
    with stats_override(cfg.stats):
        loss = loss_fn(model, batch, cfg)
        loss.backward()
    for group in optimizer.param_groups:
        group['lr'] = poly_lr(cfg, count)
    optimizer.step()
    return loss.detach()


def ensemble_train_step(models: List[UNet],
                        optimizers: List[torch.optim.SGD],
                        batch: Dict[str, torch.Tensor], *, cfg: TrainConfig,
                        count: int) -> torch.Tensor:
    """One step of a stacked ensemble: (G, N, ...) batches, each group an
    independent model on its own slice. Returns the (G,) losses."""
    return torch.stack([
        train_step(m, o, {k: v[g] for k, v in batch.items()}, cfg=cfg,
                   count=count)
        for g, (m, o) in enumerate(zip(models, optimizers))])


def build_sharded_train_step(*args, **kwargs):
    """The reference's mesh-sharded step (data / model / ensemble axes)."""
    raise NotImplementedError(f'build_sharded_train_step {_PARALLEL}')


def unpack_target(packed: torch.Tensor, n_labels: int) -> torch.Tensor:
    """Device-side inverse of ``data.pack_target_np``: (..., ceil(L/8))
    uint8 bit-plane bytes -> (..., L) uint8 one-hot (bit l of byte w is
    label 8w + l), bit for bit."""
    lanes = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., :, None] >> lanes) & 1
    flat = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,))
    return flat[..., :n_labels]


class Trainer:
    """The training loop on one device, with ``torch.save`` checkpoints.

    Batches may carry the one-hot target as ``'target'`` (N, H, W, L) uint8
    or as ``'target_packed'`` bit-plane bytes (``data.pack_target_np``),
    unpacked on the device (bit for bit, 8x fewer bytes to copy); numpy
    arrays or tensors. Weights are drawn from a ``torch.Generator`` seeded
    with ``seed`` on the CPU, so a seed gives the same model on any device;
    augmentation draws from its own generator seeded with ``seed ^
    0x5EED``."""

    def __init__(self, spec: ArchSpec, cfg: TrainConfig, mesh=None,
                 seed: int = 0, ensemble_size: Optional[int] = None,
                 spatial: bool = False, device=None):
        if mesh is not None or spatial:
            raise NotImplementedError(f'Trainer(mesh=, spatial=) {_PARALLEL}')
        self.spec = spec
        self.cfg = cfg
        self.device = resolve_device(device)
        self.step_count = 0
        self._ensemble = bool(ensemble_size)
        gen = torch.Generator().manual_seed(int(seed))
        self.models: List[UNet] = []
        for _ in range(int(ensemble_size) if ensemble_size else 1):
            model = UNet(spec)
            load_into(model, init_params(gen, spec))
            self.models.append(model.to(self.device).train())
        self.optimizers = [make_optimizer(cfg, m.parameters())
                           for m in self.models]
        self._aug_gen = torch.Generator().manual_seed(int(seed) ^ 0x5EED)
        # the exact numerics class (no TF32, fixed cuDNN algorithms) for as
        # long as this trainer lives; released by close()
        self._release = (hold_exact_numerics() if self.device.type == 'cuda'
                         else None)

    def close(self) -> None:
        if self._release is not None:
            self._release()
            self._release = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 (interpreter shutdown)
            pass

    @property
    def model(self) -> UNet:
        return self.models[0]

    @property
    def params(self):
        """The state dict (a list of them for an ensemble)."""
        sds = [m.state_dict() for m in self.models]
        return sds if self._ensemble else sds[0]

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(v))
            out[k] = t.to(self.device, non_blocking=True)
        if 'target_packed' in out:
            out['target'] = unpack_target(out.pop('target_packed'),
                                          self.spec.out_channels)
        return out

    def step(self, batch) -> torch.Tensor:
        """One training step on ``batch``; returns the detached loss (a (G,)
        tensor for an ensemble), on the device."""
        batch = self._to_device(batch)
        if self.cfg.augment:
            from .augment import augment_batch
            if self._ensemble:
                # each group draws its own augmentations
                parts = [augment_batch(self._aug_gen,
                                       {k: v[g] for k, v in batch.items()})
                         for g in range(len(self.models))]
                batch = {k: torch.stack([p[k] for p in parts])
                         for k in parts[0]}
            else:
                batch = augment_batch(self._aug_gen, batch)
        if self._ensemble:
            loss = ensemble_train_step(self.models, self.optimizers, batch,
                                       cfg=self.cfg, count=self.step_count)
        else:
            loss = train_step(self.model, self.optimizers[0], batch,
                              cfg=self.cfg, count=self.step_count)
        self.step_count += 1
        return loss

    # -- checkpointing ------------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        """Write the training state to the file ``path`` (``torch.save``):
        parameters, momentum buffers, the step count and the augmentation
        generator's state, so a restore resumes bit for bit."""
        state = {'params': [m.state_dict() for m in self.models],
                 'optimizers': [o.state_dict() for o in self.optimizers],
                 'step': self.step_count,
                 'augment_generator': self._aug_gen.get_state()}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + '.tmp'
        torch.save(state, tmp)
        os.replace(tmp, path)

    def restore_checkpoint(self, path: str) -> None:
        state = torch.load(path, map_location=self.device, weights_only=True)
        if len(state['params']) != len(self.models):
            raise ValueError(f'checkpoint {path!r} holds '
                             f'{len(state["params"])} models, this trainer '
                             f'{len(self.models)}')
        for m, sd in zip(self.models, state['params']):
            m.load_state_dict(sd)
        for o, sd in zip(self.optimizers, state['optimizers']):
            o.load_state_dict(sd)
        self.step_count = int(state['step'])
        self._aug_gen.set_state(state['augment_generator'].cpu())
