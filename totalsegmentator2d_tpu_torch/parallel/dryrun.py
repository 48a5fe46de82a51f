"""The reference's ``__graft_entry__.dryrun_multichip(n)`` on n ranks: one
sharded training step over ``auto_axes(n)`` (ensemble, data, model), the
same step height-sharded over the model axis (``spatial=True``), the
augmented step with the packed target, cohort data parallelism, the
mixed-shape padded cohort and the tile-sharded scan, each held against its
one-rank result. Rank 0 prints one ``OK`` line per mode.

    torchrun --nproc-per-node=8 -m totalsegmentator2d_tpu_torch.parallel.dryrun \\
        --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist


def flagship_spec(out_channels=26, in_channels=2, n_stages=5):
    """The ts2d-v2 group-model shape scaled to ``n_stages`` (the
    reference's ``_flagship_spec``)."""
    from ..models.plans import ArchSpec
    return ArchSpec(
        n_stages=n_stages,
        features_per_stage=tuple(min(32 * 2 ** i, 512)
                                 for i in range(n_stages)),
        kernel_sizes=((3, 3),) * n_stages,
        strides=((1, 1),) + ((2, 2),) * (n_stages - 1),
        n_conv_per_stage=(2,) * n_stages,
        n_conv_per_stage_decoder=(2,) * (n_stages - 1),
        in_channels=in_channels, out_channels=out_channels)


def _say(line: str) -> None:
    if dist.get_rank() == 0:
        print(line, flush=True)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Every mode on the ``n_devices`` ranks of the initialized world."""
    from ..training import TrainConfig, Trainer
    from ..training.data import pack_target_np
    from .mesh import auto_axes, make_mesh

    world = dist.get_world_size()
    if world != n_devices:
        raise ValueError(f'need {n_devices} ranks, have {world}')
    axes = auto_axes(n_devices)
    mesh = make_mesh(axes, device=device)
    ens = axes.get('ensemble', 0)

    spec = flagship_spec(out_channels=4, in_channels=2, n_stages=3)
    cfg = TrainConfig(lr=1e-3, total_steps=10, multilabel=True,
                      deep_supervision=True)
    trainer = Trainer(spec, cfg, mesh=mesh, seed=0,
                      ensemble_size=ens if ens else None, device=device)
    rng = np.random.default_rng(0)
    n_batch = 2 * axes.get('data', 1)
    hw = 32
    img = rng.standard_normal((n_batch, hw, hw, 2)).astype(np.float32)
    tgt = (rng.random((n_batch, hw, hw, 4)) > 0.7).astype(np.uint8)
    batch = {'image': img, 'target': tgt}
    if ens:
        batch = {k: np.stack([v] * ens) for k, v in batch.items()}
    loss = trainer.step(batch).cpu().numpy()
    assert np.all(np.isfinite(loss)), f'non-finite loss: {loss}'
    solo = Trainer(spec, cfg, seed=0, ensemble_size=ens if ens else None,
                   device=device).step(batch).cpu().numpy()
    np.testing.assert_allclose(loss, solo, rtol=1e-4)
    _say(f'dryrun_multichip OK (ep/dp/tp): mesh={dict(axes)} loss={loss}')

    if 'model' in axes:
        # the image HEIGHT shards over the model axis (a halo per 3x3 conv)
        sp_loss = Trainer(spec, cfg, mesh=mesh, seed=0,
                          ensemble_size=ens if ens else None, spatial=True,
                          device=device).step(batch).cpu().numpy()
        assert np.all(np.isfinite(sp_loss)), f'non-finite sp loss: {sp_loss}'
        assert np.allclose(sp_loss, loss, atol=1e-4), \
            f'spatial-parallel loss diverged: {sp_loss} vs {loss}'
        _say(f'dryrun_multichip OK (ep/dp/sp): loss={sp_loss}')

    aug_cfg = TrainConfig(lr=1e-3, total_steps=10, multilabel=True,
                          deep_supervision=True, augment=True)
    nb = max(8, n_batch)
    a_img = rng.standard_normal((nb, hw, hw, 2)).astype(np.float32)
    a_tgt = rng.random((nb, hw, hw, 4)) > 0.7
    a_batch = {'image': a_img, 'target_packed': pack_target_np(a_tgt)}
    if ens:
        a_batch = {k: np.stack([v] * ens) for k, v in a_batch.items()}
    a_loss = Trainer(spec, aug_cfg, mesh=mesh, seed=1,
                     ensemble_size=ens if ens else None,
                     device=device).step(a_batch).cpu().numpy()
    assert np.all(np.isfinite(a_loss)), f'non-finite augmented loss: {a_loss}'
    _say(f'dryrun_multichip OK (augmented step + packed target): '
         f'loss={a_loss}')
    _dryrun_inference(n_devices, device)


def _dryrun_inference(n_devices: int, device) -> None:
    """Cohort data parallelism, the mixed-shape padded cohort and the
    tile-sharded scan over a {'data': n} mesh, against one rank's."""
    from ..inference import EnsembleEngine
    from ..models.convert import params_from_jax
    from ..models.plans import ModelSpec, PreprocessSpec
    from ..models.unet import init_params_np
    from .mesh import make_mesh

    pre = PreprocessSpec(
        spacing=(1.5, 1.5), patch_size=(32, 32),
        normalization_schemes=('ZScoreNormalization',) * 2,
        use_mask_for_norm=(False, False), intensity_properties=(None, None))
    specs, params = [], []
    for i, n_labels in enumerate((3, 4)):
        arch = flagship_spec(out_channels=n_labels, in_channels=2, n_stages=3)
        specs.append(ModelSpec(
            arch=arch, preprocess=pre,
            labels={v + 1: f'g{i}-{v}' for v in range(n_labels)},
            channel_names={0: 'max', 1: 'mean'}, multilabel=True))
        params.append([params_from_jax(init_params_np(i, arch))])
    engine = EnsembleEngine(specs, params, device=device)
    rng = np.random.default_rng(1)
    mesh = make_mesh({'data': n_devices}, device=device)

    vols = (rng.standard_normal((n_devices, 20, 12, 16)) * 100 + 40).astype(
        np.float32)
    plain = engine.predict_cohort(vols, (1.5, 1.5), ('max', 'mean'))
    sharded = engine.predict_cohort(vols, (1.5, 1.5), ('max', 'mean'),
                                    mesh=mesh)
    assert sharded.shape == plain.shape
    assert (sharded == plain).mean() > 0.9999, 'cohort DP diverged'
    _say(f'dryrun_multichip OK (inference cohort dp): batch={len(vols)} '
         f'over {n_devices} ranks, seg={sharded.shape}')

    mixed = [(rng.standard_normal(s) * 100 + 40).astype(np.float32)
             for s in ((20, 12, 16), (18, 10, 14), (16, 12, 12),
                       (20, 12, 16), (18, 10, 14), (16, 12, 12),
                       (20, 12, 16), (18, 10, 14))]
    segs = engine.predict_cohort_mixed(mixed, (1.5, 1.5), ('max', 'mean'),
                                       mesh=mesh, bucket='pad',
                                       pad_quantum=32)
    pad_keys = [k for k in engine._cache if k[0] == 'cohortpad']
    assert len(pad_keys) == 1, 'mixed shapes did not share one padded bucket'
    assert all(s.shape == (v.shape[0], v.shape[2], 7)
               for s, v in zip(segs, mixed))
    _say(f'dryrun_multichip OK (inference mixed-shape padded cohort): '
         f'{len(mixed)} scans of 3 shapes -> 1 batched program '
         f'{pad_keys[0][1]} over {n_devices} ranks')

    tiled = EnsembleEngine(specs, params, device=device, tile_mesh=mesh)
    arr = (rng.standard_normal((70, 60, 2)) + 2).astype(np.float32)
    a = engine.predict_array(arr, (1.5, 1.5))
    b = tiled.predict_array(arr, (1.5, 1.5))
    assert (a == b).mean() > 0.9999, 'tile-sharded scan diverged'
    _say(f'dryrun_multichip OK (inference tile-sharded): seg={b.shape}')


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description='Every sharded mode of the port on the ranks of a '
                    'torchrun launch.')
    parser.add_argument('--device', default=None,
                        help="'cpu' (gloo), or the CUDA card (default, NCCL)")
    parser.add_argument('--backend', default=None,
                        help="'gloo' for ranks that share one card")
    args = parser.parse_args(argv)
    from .distributed import init_distributed
    torch.set_num_threads(1)
    _, world = init_distributed(backend=args.backend, device=args.device)
    try:
        dryrun_multichip(world, device=args.device)
    finally:
        dist.destroy_process_group()


if __name__ == '__main__':
    main()
