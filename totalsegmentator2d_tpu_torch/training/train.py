"""The training step and the trainer loop (the reference package's
training/train.py).

nnU-Net's optimization recipe: weight decay 3e-5, then SGD with Nesterov
momentum 0.99 on a polynomial learning-rate decay (power 0.9), Dice + CE /
BCE with deep supervision. A stacked ensemble (``ensemble_size=G``) trains G
independent models, each on its own targets with its own augmentation
draws. ``mesh=`` (a ``parallel.make_mesh`` over the ranks of a
``torch.distributed`` world) shards the step over its 'data', 'model' and
'ensemble' axes (training/sharded.py): every rank makes the same calls with
the GLOBAL batch, and gets the global loss back, as the reference's one
process does; checkpoints and ``params`` are whole, in the single-device
layout. ``spatial=True`` turns the 'model' axis from channel shards to
height slabs of the batch (training/sharded.py).

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
import torch.distributed as dist

from ..models.convert import load_into
from ..models.plans import ArchSpec
from ..models.unet import UNet, init_params, stats_override
from ..utils.device import hold_exact_numerics, resolve_device
from .losses import deep_supervision_loss, dice_and_ce


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
            cfg: TrainConfig, layout=None) -> torch.Tensor:
    """The loss of one batch (image (N, H, W, C) float, target (N, H, W, L)
    one-hot or (N, H, W) labels), under ``stats_override(cfg.stats)``.
    ``layout``: a model holding channel shards (sharded.ShardLayout) runs
    the forward through the layout's tensor-parallel gate; a batch of
    height slabs runs the forward and the loss over its height group."""
    cdt = _compute_dtype(cfg)
    x = batch['image'].permute(0, 3, 1, 2).contiguous()
    gate, group = ((None, None) if layout is None else
                   (layout.gate(model), layout.height_group))
    with stats_override(cfg.stats):
        out = model.forward_train(x, compute_dtype=cdt,
                                  deep_supervision=cfg.deep_supervision,
                                  head_dtype=cdt, remat=cfg.remat,
                                  gate=gate, group=group)
        if cfg.deep_supervision:
            heads = [o.float().permute(0, 2, 3, 1) for o in out]
            return deep_supervision_loss(heads, batch['target'],
                                         cfg.multilabel, group)
        return dice_and_ce(out.float().permute(0, 2, 3, 1), batch['target'],
                           cfg.multilabel, group)


def train_step(model: UNet, optimizer: torch.optim.SGD,
               batch: Dict[str, torch.Tensor], *, cfg: TrainConfig,
               count: int, layout=None) -> torch.Tensor:
    """One optimization step (update number ``count``): loss, backward
    (recomputing under the same statistics form when ``cfg.remat``), the
    scheduled SGD update. Returns the detached loss. ``layout``: the
    model's shards and this rank's rows of a mesh (sharded.ShardLayout):
    the gradients and the loss are meaned over the data group first."""
    optimizer.zero_grad(set_to_none=True)
    with stats_override(cfg.stats):
        loss = loss_fn(model, batch, cfg, layout)
        loss.backward()
    if layout is not None:
        loss = layout.sync(model, loss)
    for group in optimizer.param_groups:
        group['lr'] = poly_lr(cfg, count)
    optimizer.step()
    return loss.detach()


def ensemble_train_step(models: List[UNet],
                        optimizers: List[torch.optim.SGD],
                        batch: Dict[str, torch.Tensor], *, cfg: TrainConfig,
                        count: int, layout=None) -> torch.Tensor:
    """One step of a stacked ensemble: (G, N, ...) batches, each group an
    independent model on its own slice. Returns the (G,) losses."""
    return torch.stack([
        train_step(m, o, {k: v[g] for k, v in batch.items()}, cfg=cfg,
                   count=count, layout=layout)
        for g, (m, o) in enumerate(zip(models, optimizers))])


def build_sharded_train_step(mesh, spec: ArchSpec, cfg: TrainConfig, params,
                             *, ensemble: bool = False, spatial: bool = False,
                             device=None):
    """The step sharded over ``mesh`` (training/sharded.py). ``params``: a
    full state dict, or for ``ensemble`` a list of them (the stack), the
    same on every rank. Returns ``(step_fn, models, optimizers, layout)``:
    this rank's models holding their shards, their SGD optimizers (the
    momentum beside the shards), the layout that gathers and slices them;
    ``step_fn(batch, count)`` takes this rank's rows (a (G_local, ...)
    stack of them for an ensemble; with ``spatial``, its height slab of
    them, ``layout.take``) and returns the global loss, or the (G,)
    losses. The reference returns (step, params, opt_state, optax
    optimizer) of one jitted program."""
    from ..parallel.mesh import check_mesh
    from .sharded import ShardLayout
    check_mesh(mesh)
    sds = list(params) if ensemble else [params]
    layout = ShardLayout(mesh, len(sds), ensemble, spatial=spatial,
                         stride=spec.total_stride[0])
    dev = resolve_device(device)
    models = []
    for i in layout.members:
        model = UNet(spec)
        layout.load_local(model, sds[i])
        models.append(model.to(dev).train())
    optimizers = [make_optimizer(cfg, m.parameters()) for m in models]

    def step_fn(batch, count):
        if not ensemble:
            return train_step(models[0], optimizers[0], batch, cfg=cfg,
                              count=count, layout=layout)
        return layout.gather_losses(ensemble_train_step(
            models, optimizers, batch, cfg=cfg, count=count, layout=layout))

    return step_fn, models, optimizers, layout


def unpack_target(packed: torch.Tensor, n_labels: int) -> torch.Tensor:
    """Device-side inverse of ``data.pack_target_np``: (..., ceil(L/8))
    uint8 bit-plane bytes -> (..., L) uint8 one-hot (bit l of byte w is
    label 8w + l), bit for bit."""
    lanes = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., :, None] >> lanes) & 1
    flat = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,))
    return flat[..., :n_labels]


class Trainer:
    """The training loop, with ``torch.save`` checkpoints.

    Batches may carry the one-hot target as ``'target'`` (N, H, W, L) uint8
    or as ``'target_packed'`` bit-plane bytes (``data.pack_target_np``),
    unpacked on the device (bit for bit, 8x fewer bytes to copy); numpy
    arrays or tensors. Weights are drawn from a ``torch.Generator`` seeded
    with ``seed`` on the CPU, so a seed gives the same model on any device;
    augmentation draws from its own generator seeded with ``seed ^
    0x5EED``.

    With ``mesh`` every rank of the mesh constructs the trainer and steps
    with the same global batch: each augments it alike (one generator
    state), takes its rows and its models, and trains its shards
    (training/sharded.py); ``step`` returns the global loss on every rank.
    ``params``, :meth:`save_checkpoint` and :meth:`restore_checkpoint` are
    collectives: the whole weights in the single-device layout, written by
    rank 0, sliced back on restore, so a checkpoint moves between sharded
    and unsharded trainers. ``spatial=True`` shards image rows over the
    mesh's 'model' axis (training/sharded.py); without a mesh it trains
    unsharded, as the reference does."""

    def __init__(self, spec: ArchSpec, cfg: TrainConfig, mesh=None,
                 seed: int = 0, ensemble_size: Optional[int] = None,
                 spatial: bool = False, device=None):
        self.spec = spec
        self.cfg = cfg
        self.device = resolve_device(device)
        self.step_count = 0
        self._ensemble = bool(ensemble_size)
        self._n_models = int(ensemble_size) if ensemble_size else 1
        gen = torch.Generator().manual_seed(int(seed))
        sds = [init_params(gen, spec) for _ in range(self._n_models)]
        self._layout = None
        if mesh is not None:
            (self._step, self.models, self.optimizers,
             self._layout) = build_sharded_train_step(
                mesh, spec, cfg, sds if self._ensemble else sds[0],
                ensemble=self._ensemble, spatial=spatial, device=self.device)
        else:
            self.models: List[UNet] = []
            for sd in sds:
                model = UNet(spec)
                load_into(model, sd)
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
        """The (first) model this rank holds: its shards under a mesh."""
        return self.models[0]

    @property
    def params(self):
        """The whole state dict (a list of them for an ensemble); under a
        mesh a collective that gathers the shards."""
        sds = self._full_state()[0]
        return sds if self._ensemble else sds[0]

    def _full_state(self):
        """(every model's whole state dict, its optimizer's whole state
        dict), in stack order."""
        if self._layout is None:
            return ([m.state_dict() for m in self.models],
                    [o.state_dict() for o in self.optimizers])
        lay = self._layout
        sds, moms, osds = [], [], []
        for m, o in zip(self.models, self.optimizers):
            names = [n for n, _ in m.named_parameters()]
            sds.append({n: lay.full(n, p) for n, p in m.named_parameters()})
            osd = o.state_dict()
            moms.append({str(i): lay.full(names[i], st['momentum_buffer'])
                         for i, st in osd['state'].items()})
            osds.append(osd)
        sds, moms = lay.gather_models(sds), lay.gather_models(moms)
        opts = [{'state': {int(i): {'momentum_buffer': b}
                           for i, b in mom.items()},
                 'param_groups': osds[0]['param_groups']} for mom in moms]
        return sds, opts

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
                         for g in range(self._n_models)]
                batch = {k: torch.stack([p[k] for p in parts])
                         for k in parts[0]}
            else:
                batch = augment_batch(self._aug_gen, batch)
        if self._layout is not None:
            batch = {n: self._layout.take(v) for n, v in batch.items()}
            loss = self._step(batch, self.step_count)
        elif self._ensemble:
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
        generator's state, so a restore resumes bit for bit. Under a mesh
        every rank calls it: the shards are gathered and rank 0 writes the
        single-device layout."""
        params, opts = self._full_state()
        if self._layout is None or dist.get_rank() == 0:
            state = {'params': params, 'optimizers': opts,
                     'step': self.step_count,
                     'augment_generator': self._aug_gen.get_state()}
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            tmp = path + '.tmp'
            torch.save(state, tmp)
            os.replace(tmp, path)
        if self._layout is not None:
            dist.barrier()

    def restore_checkpoint(self, path: str) -> None:
        """Load a :meth:`save_checkpoint` file, sharded or not; under a mesh
        each rank takes its models and slices."""
        state = torch.load(path, map_location=self.device, weights_only=True)
        if len(state['params']) != self._n_models:
            raise ValueError(f'checkpoint {path!r} holds '
                             f'{len(state["params"])} models, this trainer '
                             f'{self._n_models}')
        lay = self._layout
        members = lay.members if lay is not None else range(self._n_models)
        for m, o, i in zip(self.models, self.optimizers, members):
            sd, osd = state['params'][i], state['optimizers'][i]
            if lay is not None:
                names = [n for n, _ in m.named_parameters()]
                sd = lay.shard(sd)
                osd = dict(osd, state={
                    j: {'momentum_buffer': lay.local(
                        names[j], st['momentum_buffer'])}
                    for j, st in osd['state'].items()})
            m.load_state_dict(sd)
            o.load_state_dict(osd)
        self.step_count = int(state['step'])
        self._aug_gen.set_state(state['augment_generator'].cpu())
