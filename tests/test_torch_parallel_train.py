"""Training over a mesh (training/train.py, training/sharded.py) on gloo
ranks of this file (the launcher of tests/test_torch_parallel.py), on the
small spec of tests/test_007_parallel.py (features 8, 16, 16; a 3-label
head, replicated under model=2), batch 4 of 32^2, deep supervision on.

- data=2, model=2, data=2 x model=2 and ensemble=2 x data=2 x model=2 (8
  ranks, one launch): 3 steps within rtol 1e-5 of the port's unsharded
  trainer with the same seed, the losses and each weight's update (model=2
  in bf16 with remat: rtol 1e-3); a model rank's first conv holds Cout/2
  rows;
  the checkpoint that every rank writes (rank 0, the single-device layout)
  restores bit for bit into a sharded trainer on the ranks and into an
  unsharded one here, and both step on alike.
- data=2 x model=2 from the reference Trainer's initial weights (an
  unsharded port checkpoint restored on the ranks): 3 steps within rtol
  1e-4 of the reference's trainer on a {'data': 2, 'model': 2} mesh of
  virtual devices (the step-for-step bar of tests/test_torch_train.py).
- ``ts2d-torch-train --mesh data=2 --device cpu`` on 2 ranks under
  torchrun's env: rank 0's export loads in both packages' zoos, which
  agree >= 0.999, and equals the one-rank run's >= 0.999."""

if __name__ == '__main__':   # a rank process: refuse JAX before anything
    from tests.test_torch_parallel import install_blocker
    install_blocker()

import os  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from tests.test_torch_parallel import launch, rank_main  # noqa: E402

SMALL = dict(n_stages=3, features_per_stage=(8, 16, 16),
             kernel_sizes=((3, 3),) * 3, strides=((1, 1), (2, 2), (2, 2)),
             n_conv_per_stage=(2, 2, 2), n_conv_per_stage_decoder=(2, 2),
             in_channels=2, out_channels=3)
CFG = dict(lr=1e-2, total_steps=10, multilabel=True)
STEPS = 3


def _batches(ensemble=None, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS + 1):
        b = {'image': rng.standard_normal((4, 32, 32, 2)).astype(np.float32),
             'target': (rng.random((4, 32, 32, 3)) > 0.7).astype(np.uint8)}
        if ensemble:
            b = {k: np.stack([v, v[::-1]]) for k, v in b.items()}
        out.append(b)
    return out


def _trainer(mesh=None, ensemble=None, seed=3, extra=None):
    from totalsegmentator2d_tpu_torch.models.plans import ArchSpec
    from totalsegmentator2d_tpu_torch.training import TrainConfig, Trainer
    return Trainer(ArchSpec(**SMALL), TrainConfig(**CFG, **(extra or {})),
                   mesh=mesh, seed=seed, ensemble_size=ensemble,
                   device='cpu')


def _numpy(params):
    if isinstance(params, list):
        return [_numpy(p) for p in params]
    return {k: v.detach().cpu().numpy().copy() for k, v in params.items()}


# -- rank cases ------------------------------------------------------------------

def _case_train(rank, world, inputs):
    import torch.distributed as dist

    from totalsegmentator2d_tpu_torch.parallel import make_mesh
    mesh = make_mesh(inputs['axes'], device='cpu')
    ens, extra = inputs.get('ensemble'), inputs.get('extra')
    tr = _trainer(mesh, ens, extra=extra)
    if inputs.get('start'):
        tr.restore_checkpoint(inputs['start'])
    batches = _batches(ens)
    losses = [tr.step(b).numpy().tolist() for b in batches[:STEPS]]
    ckpt = os.path.join(inputs['dir'], 'sharded.pth')
    tr.save_checkpoint(ckpt)
    full = _numpy(tr.params)
    again = _trainer(mesh, ens, seed=99, extra=extra)
    again.restore_checkpoint(ckpt)
    restored = _numpy(again.params)
    same = all(np.array_equal(a[k], b[k])
               for a, b in zip(full if ens else [full],
                               restored if ens else [restored]) for k in a)
    nxt = [t.step(batches[STEPS]).numpy().tolist() for t in (tr, again)]
    dist.barrier()
    return {'losses': losses, 'params': full, 'restored_equal': same,
            'next': nxt, 'first_conv': tuple(
                tr.model.encoder.stages[0].convs[0].conv.weight.shape),
            'models': len(tr.models)}


def _case_cli(rank, world, inputs):
    import contextlib
    import io

    from totalsegmentator2d_tpu_torch.training.cli import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(inputs['argv'])
    return buf.getvalue()


_case_cli.own_world = True   # the CLI joins the world from torchrun's env
CASES = {'train': _case_train, 'cli': _case_cli}

if __name__ == '__main__':
    rank_main(CASES)


# -- the tests ------------------------------------------------------------------

@pytest.mark.parametrize('axes,ensemble,extra', [
    ({'data': 2}, None, None), ({'model': 2}, None, None),
    ({'data': 2, 'model': 2}, None, None),
    ({'ensemble': 2, 'data': 2, 'model': 2}, 2, None),
    ({'model': 2}, None, {'compute_dtype': 'bfloat16', 'remat': True})],
    ids=['data2', 'model2', 'data2xmodel2', 'ens2xdata2xmodel2',
         'model2-bf16-remat'])
def test_sharded_training_matches_unsharded(tmp_path, axes, ensemble, extra):
    """The losses within rtol 1e-5, and every weight's 3-step update
    within 1e-4 of the unsharded one's (its norm; measured at most 2.3e-5).
    bf16 (with remat): rtol 1e-3 (measured 1.9e-5) and 0.25 (measured
    0.106, an InstanceNorm weight): the channel shards' bf16 roundings in
    another order."""
    world = int(np.prod(list(axes.values())))
    results = launch(__file__, 'train', world, tmp_path,
                     {'axes': axes, 'ensemble': ensemble, 'extra': extra,
                      'dir': str(tmp_path)})
    solo = _trainer(ensemble=ensemble, extra=extra)
    start = _numpy(solo.params)
    batches = _batches(ensemble)
    want = [solo.step(b).numpy().tolist() for b in batches[:STEPS]]
    end = _numpy(solo.params)
    rtol, utol = (1e-3, 0.25) if extra else (1e-5, 1e-4)
    for r, res in enumerate(results):
        np.testing.assert_allclose(res['losses'], want, rtol=rtol,
                                   err_msg=f'rank {r}')
        # the update itself, leaf by leaf: the sharded weights' distance
        # from the unsharded trainer's, against how far that one moved. A
        # conv bias before an InstanceNorm is left out: the norm cancels it,
        # so it moves from its zero start by rounding alone
        for a0, a1, b in zip(*([x] if not ensemble else x for x in
                               (start, end, res['params']))):
            for k in a1:
                if k.endswith('.conv.bias'):
                    continue
                moved = float(np.linalg.norm(a1[k] - a0[k]))
                off = float(np.linalg.norm(b[k] - a1[k]))
                assert off <= utol * moved, (r, k, off, moved)
        assert res['restored_equal'], r
        assert res['next'][0] == res['next'][1], r
        rows = 8 // axes.get('model', 1)
        assert res['first_conv'] == (rows, 2, 3, 3), r
        assert res['models'] == (1 if not ensemble else
                                 ensemble // axes.get('ensemble', 1))
    # the checkpoint loads into an unsharded trainer, bit for bit
    plain = _trainer(ensemble=ensemble, seed=5, extra=extra)
    plain.restore_checkpoint(str(tmp_path / 'sharded.pth'))
    got = _numpy(plain.params)
    for a, b in zip(got if ensemble else [got],
                    results[0]['params'] if ensemble
                    else [results[0]['params']]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    nxt = plain.step(batches[STEPS]).numpy().tolist()
    np.testing.assert_allclose(nxt, results[0]['next'][0], rtol=rtol)


def test_data_model_training_matches_reference(tmp_path):
    """The reference Trainer's initial weights, an unsharded port
    checkpoint of them restored on 4 ranks, 3 steps against the
    reference's sharded trainer."""
    import jax
    import jax.numpy as jnp

    from totalsegmentator2d_tpu.models.convert import params_to_state_dict
    from totalsegmentator2d_tpu.models.plans import ArchSpec as JaxArch
    from totalsegmentator2d_tpu.training import TrainConfig as JaxCfg
    from totalsegmentator2d_tpu.training import Trainer as JaxTrainer
    from tests.test_torch_parallel import jax_mesh
    import torch
    ref = JaxTrainer(JaxArch(**SMALL), JaxCfg(**CFG),
                     mesh=jax_mesh({'data': 2, 'model': 2}), seed=3)
    sd = params_to_state_dict(jax.tree_util.tree_map(np.asarray, ref.params),
                              JaxArch(**SMALL))
    start = _trainer()
    start.model.load_state_dict({k: torch.from_numpy(np.array(v))
                                 for k, v in sd.items()})
    path = str(tmp_path / 'start.pth')
    start.save_checkpoint(path)
    batches = _batches()
    want = [float(ref.step({k: jnp.asarray(v) for k, v in b.items()}))
            for b in batches[:STEPS]]
    results = launch(__file__, 'train', 4, tmp_path,
                     {'axes': {'data': 2, 'model': 2}, 'start': path,
                      'dir': str(tmp_path)})
    for res in results:
        np.testing.assert_allclose(res['losses'], want, rtol=1e-4)


def test_cli_mesh_on_2_ranks(tmp_path):
    from totalsegmentator2d_tpu.inference import Zoo as JaxZoo
    from totalsegmentator2d_tpu.io import MedicalImage as JaxImage
    from tests.test_torch_train_cli import _make_dataset
    from totalsegmentator2d_tpu_torch.inference import Zoo
    from totalsegmentator2d_tpu_torch.training import load_raw_dataset
    from totalsegmentator2d_tpu_torch.training.cli import main
    data = tmp_path / 'Dataset501_toy'
    data.mkdir()
    _make_dataset(str(data))
    args = ['-d', str(data), '--model', 'ts2d-toy', '--group', 'cardiac',
            '--steps', '3', '--batch-size', '2', '--max-patch', '64',
            '--log-every', '1', '--device', 'cpu']
    out = tmp_path / 'models'
    logs = launch(__file__, 'cli', 2, tmp_path,
                  {'argv': args + ['-o', str(out), '--mesh', 'data=2']})
    assert logs[0].strip().splitlines()[-1] == 'ts2d-toy_cardiac'
    assert 'loss' in logs[0] and 'loss' not in logs[1]
    one = tmp_path / 'one'
    main(args + ['-o', str(one)])
    case = load_raw_dataset(str(data))[0][0][0]
    masks = []
    for root in (out, one):
        hosted = Zoo(remote=False, local=str(root)).load('ts2d-toy_cardiac')
        hosted.start('cpu')
        masks.append(hosted.apply(case).array)
    ref = JaxZoo(remote=False, local=str(out)).load('ts2d-toy_cardiac')
    b = ref.apply(JaxImage(array=case.array, spacing=case.spacing,
                           is_vector=True)).array
    assert masks[0].shape == b.shape == (72, 64, 2)
    assert float((masks[0] == b).mean()) >= 0.999
    assert float((masks[0] == masks[1]).mean()) >= 0.999
