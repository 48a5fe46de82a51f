"""Height-sharded training (``Trainer(spatial=True)``, training/sharded.py)
on gloo ranks of this file (the launcher of tests/test_torch_parallel.py),
on the small spec of tests/test_torch_parallel_train.py (features 8, 16,
16, total stride 4), deep supervision on. Two launches, each running its
configurations in turn:

- 2 ranks: the halo conv (stride 1 and 2) and the group-reduced
  InstanceNorm ('1pass' and '2pass') in float64, values and input and
  weight gradients against ``F.conv2d`` and the full-tensor norm to 1e-10;
  the group-reduced losses against the full-tensor ones, the same;
  {'data': 1, 'model': 2} for 3 steps at H = 32, at H = 36 (slabs of 20
  and 16 rows), in bf16 with remat, and with augmentation at batch 8 (the
  batch-partitioned warp, drawn alike on every rank before the slab is
  taken), against the port's unsharded trainer (the bars of
  test_sharded_training_matches_unsharded); the spatial checkpoint,
  restored into an unsharded and a tensor-parallel trainer; the refusals.
- 4 ranks: {'data': 2, 'model': 2} from the reference Trainer's initial
  weights, 3 steps within rtol 1e-4 of the reference's
  ``Trainer(spatial=True)`` on as many virtual devices, and within the
  unsharded bars of the port's own trainer; the data x model gradient
  group of an ensemble x data x model mesh, built once.
"""

if __name__ == '__main__':   # a rank process: refuse JAX before anything
    from tests.test_torch_parallel import install_blocker
    install_blocker()

import os  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from tests.test_torch_parallel import launch, rank_main  # noqa: E402
from tests.test_torch_parallel_train import CFG, SMALL, STEPS  # noqa: E402
from tests.test_torch_parallel_train import _numpy  # noqa: E402
from tests.test_torch_parallel_train import _trainer as _plain  # noqa: E402

# the height-sharded configurations of the 2-rank launch:
# (name, H, batch, extra)
CONFIGS = (('h32', 32, 4, None), ('h36', 36, 4, None),
           ('h32-bf16-remat', 32, 4, {'compute_dtype': 'bfloat16',
                                      'remat': True}),
           ('h32-augment', 32, 8, {'augment': True}))


def _batches(h, seed=0, n=4):
    rng = np.random.default_rng(seed)
    return [{'image': rng.standard_normal((n, h, 32, 2)).astype(np.float32),
             'target': (rng.random((n, h, 32, 3)) > 0.7).astype(np.uint8)}
            for _ in range(STEPS + 1)]


def _pieces(seed=5):
    """float64 operands of the layer checks: x (2, 3, 8, 6), a 3x3 conv
    weight (4, 3) and bias, the upstream gradients at stride 1 and 2, norm
    affines and logits / targets for the losses (2, 8, 6, 3)."""
    rng = np.random.default_rng(seed)
    return {'x': rng.standard_normal((2, 3, 8, 6)),
            'w': rng.standard_normal((4, 3, 3, 3)),
            'b': rng.standard_normal(4),
            'g1': rng.standard_normal((2, 4, 8, 6)),
            'g2': rng.standard_normal((2, 4, 4, 3)),
            'gn': rng.standard_normal((2, 3, 8, 6)),
            'scale': rng.standard_normal(3), 'shift': rng.standard_normal(3),
            'logits': rng.standard_normal((2, 8, 6, 3)),
            'onehot': (rng.random((2, 8, 6, 3)) > 0.6).astype(np.uint8),
            'labels': rng.integers(0, 3, (2, 8, 6))}


def _layers(p, group=None, rows=None):
    """Each layer's output and gradients on the whole operands (``rows``
    None) or on one slab of them under ``group``: {name: [arrays]}."""
    import torch
    import torch.nn.functional as F

    from totalsegmentator2d_tpu_torch.models.plans import ArchSpec
    from totalsegmentator2d_tpu_torch.models.unet import (ConvNormAct,
                                                          InstanceNorm,
                                                          stats_override)
    from totalsegmentator2d_tpu_torch.training import losses as L

    def t(a, sl=True):
        a = torch.from_numpy(np.asarray(a))
        return a[:, :, rows[0]:rows[1]] if rows and sl else a

    def nhwc(a):   # a slab of an (N, H, W, ...) array
        a = torch.from_numpy(np.asarray(a))
        return a[:, rows[0]:rows[1]] if rows else a

    out = {}
    spec = ArchSpec(**dict(SMALL, in_channels=3))
    for stride in (1, 2):
        block = ConvNormAct(3, 4, (3, 3), (stride, stride), spec).double()
        with torch.no_grad():
            block.conv.weight.copy_(t(p['w'], False))
            block.conv.bias.copy_(t(p['b'], False))
        x = t(p['x']).clone().requires_grad_(True)
        g = p['g1'] if stride == 1 else p['g2']
        if rows:
            g = np.asarray(g)[:, :, rows[0] // stride:rows[1] // stride]
        conv = block.conv
        if group is None:
            y = F.conv2d(x, conv.weight, conv.bias, conv.stride, conv.padding)
        else:
            from totalsegmentator2d_tpu_torch.models.unet import halo_extent
            from totalsegmentator2d_tpu_torch.parallel.collectives import \
                halo_rows
            y = F.conv2d(halo_rows(x, *halo_extent(conv), group),
                         conv.weight, conv.bias, conv.stride, (0, 1))
        (y * torch.from_numpy(np.asarray(g))).sum().backward()
        out[f'conv{stride}'] = [a.detach().numpy().copy() for a in
                                (y, x.grad, conv.weight.grad, conv.bias.grad)]
    for mode in ('1pass', '2pass'):
        norm = InstanceNorm(3, 1e-5).double()
        with torch.no_grad():
            norm.weight.copy_(t(p['scale'], False))
            norm.bias.copy_(t(p['shift'], False))
        x = t(p['x']).clone().requires_grad_(True)
        with stats_override(mode):
            y = norm(x, group)
        (y * t(p['gn'])).sum().backward()
        out[f'norm-{mode}'] = [a.detach().numpy().copy() for a in
                               (y, x.grad, norm.weight.grad, norm.bias.grad)]
    for name, fn, tgt in (
            ('dice', lambda z, y: L.soft_dice_loss(z, y, True, group=group),
             p['onehot']),
            ('dice-softmax', lambda z, y: L.soft_dice_loss(z, y, False,
                                                           group=group),
             p['labels']),
            ('bce', lambda z, y: L.bce_loss(z, y, group), p['onehot']),
            ('ce', lambda z, y: L.ce_loss(z, y, group), p['labels']),
            ('deep', lambda z, y: L.deep_supervision_loss(
                [z, z[:, ::2, ::2]], y, True, group), p['onehot'])):
        z = nhwc(p['logits']).clone().requires_grad_(True)
        loss = fn(z, nhwc(tgt))
        loss.backward()
        out[f'loss-{name}'] = [loss.detach().numpy().copy(),
                               z.grad.numpy().copy()]
    return out


# -- rank cases ------------------------------------------------------------------

def _trainer(mesh=None, seed=3, extra=None):
    """A height-sharded trainer of the small spec (unsharded without a
    mesh)."""
    from totalsegmentator2d_tpu_torch.models.plans import ArchSpec
    from totalsegmentator2d_tpu_torch.training import TrainConfig, Trainer
    return Trainer(ArchSpec(**SMALL), TrainConfig(**CFG, **(extra or {})),
                   mesh=mesh, seed=seed, spatial=True, device='cpu')


def _case_spatial2(rank, world, inputs):
    import torch.distributed as dist

    from totalsegmentator2d_tpu_torch.parallel import make_mesh
    from totalsegmentator2d_tpu_torch.parallel.mesh import named
    mesh = make_mesh({'data': 1, 'model': 2}, device='cpu')
    res = {'layers': _layers(_pieces(), named(mesh, 'model'),
                             (4 * rank, 4 * rank + 4))}
    for name, h, n, extra in CONFIGS:
        tr = _trainer(mesh, extra=extra)
        batches = _batches(h, n=n)
        res[name] = {'losses': [float(tr.step(b)) for b in batches[:STEPS]],
                     'params': _numpy(tr.params),
                     'first_conv': tuple(
                         tr.model.encoder.stages[0].convs[0].conv.weight.shape)}
        if name == 'h32':
            ckpt = os.path.join(inputs['dir'], 'spatial.pth')
            tr.save_checkpoint(ckpt)
            res['next'] = float(tr.step(batches[STEPS]))
            tp = _plain(make_mesh({'model': 2}, device='cpu'), seed=99)
            tp.restore_checkpoint(ckpt)
            tp_params = _numpy(tp.params)
            res['tp_restored_equal'] = all(
                np.array_equal(tp_params[k], res[name]['params'][k])
                for k in tp_params)
    refusals = []
    for axes in ({'model': 2}, {'data': 2}):
        try:
            _trainer(make_mesh(axes, device='cpu'))
        except ValueError as ex:
            refusals.append(str(ex))
    tr = _trainer(mesh)
    try:   # 4 rows: one block of the total stride for 2 height shards
        tr.step(_batches(4)[0])
    except ValueError as ex:
        refusals.append(str(ex))
    res['refusals'] = refusals
    dist.barrier()
    return res


def _case_spatial4(rank, world, inputs):
    import torch.distributed as dist

    from totalsegmentator2d_tpu_torch.parallel import make_mesh
    from totalsegmentator2d_tpu_torch.training.sharded import ShardLayout
    tr = _trainer(make_mesh({'data': 2, 'model': 2}, device='cpu'))
    tr.restore_checkpoint(inputs['start'])
    losses = [float(tr.step(b)) for b in _batches(32)[:STEPS]]
    # the gradient group of a data x model mesh is the world's own; under
    # an ensemble axis it is a subgroup, built once for every layout
    emd = make_mesh({'ensemble': 2, 'data': 1, 'model': 2}, device='cpu')
    groups = [ShardLayout(emd, 2, True, spatial=True).grad_group
              for _ in range(2)]
    return {'losses': losses, 'params': _numpy(tr.params),
            'world_group': tr._layout.grad_group is dist.group.WORLD,
            'ens_groups': [groups[0] is groups[1],
                           groups[0] is not dist.group.WORLD,
                           dist.get_world_size(groups[0])]}


CASES = {'spatial2': _case_spatial2, 'spatial4': _case_spatial4}

if __name__ == '__main__':
    rank_main(CASES)


# -- the tests ------------------------------------------------------------------

def _unsharded(h, n=4, extra=None):
    """(initial weights, losses, final weights) of the port's unsharded
    trainer, seed 3, on the batches of height ``h`` and ``n`` rows."""
    solo = _plain(extra=extra)
    start = _numpy(solo.params)
    losses = [float(solo.step(b)) for b in _batches(h, n=n)[:STEPS]]
    return start, losses, _numpy(solo.params)


def _check_update(start, end, got, utol, who):
    """Every weight's distance from the unsharded trainer's, against how far
    that one moved (a conv bias before an InstanceNorm moves by rounding
    alone and is left out, as in test_torch_parallel_train.py)."""
    for k in end:
        if k.endswith('.conv.bias'):
            continue
        moved = float(np.linalg.norm(end[k] - start[k]))
        off = float(np.linalg.norm(got[k] - end[k]))
        assert off <= utol * moved, (who, k, off, moved)


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('spatial2')
    return launch(__file__, 'spatial2', 2, tmp, {'dir': str(tmp)}), tmp


def test_halo_conv_and_group_norm(two_ranks):
    """The slabs' outputs and input gradients are the whole tensors'
    rows, and the weight gradients summed over the ranks are the whole
    tensors', to 1e-10 in float64."""
    results, _ = two_ranks
    want = _layers(_pieces())
    for name in ('conv1', 'conv2', 'norm-1pass', 'norm-2pass'):
        got = [r['layers'][name] for r in results]
        for i in (0, 1):   # the output, the input gradient: slab by slab
            np.testing.assert_allclose(
                np.concatenate([g[i] for g in got], 2), want[name][i],
                rtol=0, atol=1e-10, err_msg=f'{name} [{i}]')
        for i in (2, 3):   # weight gradients: each rank's rows' part
            np.testing.assert_allclose(sum(g[i] for g in got), want[name][i],
                                       rtol=0, atol=1e-10,
                                       err_msg=f'{name} [{i}]')


def test_group_losses(two_ranks):
    """Every rank's loss is the whole image's, and its logits' gradient is
    its rows' of the whole one, to 1e-10 in float64."""
    results, _ = two_ranks
    want = _layers(_pieces())
    for name in ('dice', 'dice-softmax', 'bce', 'ce', 'deep'):
        key = f'loss-{name}'
        for r, res in enumerate(results):
            np.testing.assert_allclose(res['layers'][key][0], want[key][0],
                                       rtol=0, atol=1e-10, err_msg=name)
        np.testing.assert_allclose(
            np.concatenate([r['layers'][key][1] for r in results], 1),
            want[key][1], rtol=0, atol=1e-10, err_msg=name)


@pytest.mark.parametrize('name,h,n,extra', CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_spatial_matches_unsharded(two_ranks, name, h, n, extra):
    """{'data': 1, 'model': 2}: the losses within rtol 1e-5 and each
    weight's 3-step update within 1e-4 of the unsharded trainer's movement
    (in fp32, augmented too: every rank draws the global batch's
    augmentation alike, then takes its slab); bf16 with remat within 1e-3
    and 0.25 (the bf16 bars of test_sharded_training_matches_unsharded).
    The weights are whole on both ranks."""
    results, _ = two_ranks
    start, want, end = _unsharded(h, n, extra)
    bf16 = (extra or {}).get('compute_dtype') == 'bfloat16'
    rtol, utol = (1e-3, 0.25) if bf16 else (1e-5, 1e-4)
    for r, res in enumerate(results):
        np.testing.assert_allclose(res[name]['losses'], want, rtol=rtol,
                                   err_msg=f'rank {r}')
        _check_update(start, end, res[name]['params'], utol, r)
        assert res[name]['first_conv'] == (8, 2, 3, 3), r


def test_spatial_checkpoint_restores(two_ranks):
    """The spatial trainer's checkpoint (whole, the single-device layout)
    restores bit for bit into a tensor-parallel trainer on the ranks and
    into an unsharded one here, which steps on alike."""
    results, tmp = two_ranks
    tr = _plain(seed=5)
    tr.restore_checkpoint(str(tmp / 'spatial.pth'))
    got = _numpy(tr.params)
    for k, v in results[0]['h32']['params'].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    nxt = float(tr.step(_batches(32)[STEPS]))
    for res in results:
        assert res['tp_restored_equal']
        np.testing.assert_allclose(res['next'], nxt, rtol=1e-5)


def test_spatial_refusals(two_ranks):
    """A mesh without 'data' or without 'model' raises ValueError, as the
    reference's batch sharding does; so do 4 rows, one block of the total
    stride 4 for 2 height shards."""
    results, _ = two_ranks
    for res in results:
        assert len(res['refusals']) == 3, res['refusals']
        assert "no 'data' axis" in res['refusals'][0]
        assert "no 'model' axis" in res['refusals'][1]
        assert 'fewer than the 2 height shards' in res['refusals'][2]


def test_data_model_spatial_matches_reference(tmp_path):
    """The reference Trainer's initial weights, an unsharded port
    checkpoint of them restored on 4 ranks, 3 steps on {'data': 2,
    'model': 2} against the reference's ``Trainer(spatial=True)`` on a
    mesh of as many virtual devices: rtol 1e-4 (the bar of
    test_data_model_training_matches_reference); and against the port's
    unsharded trainer from the same weights, at its bars."""
    import jax
    import jax.numpy as jnp
    import torch

    from totalsegmentator2d_tpu.models.convert import params_to_state_dict
    from totalsegmentator2d_tpu.models.plans import ArchSpec as JaxArch
    from totalsegmentator2d_tpu.training import TrainConfig as JaxCfg
    from totalsegmentator2d_tpu.training import Trainer as JaxTrainer
    from tests.test_torch_parallel import jax_mesh
    ref = JaxTrainer(JaxArch(**SMALL), JaxCfg(**CFG),
                     mesh=jax_mesh({'data': 2, 'model': 2}), seed=3,
                     spatial=True)
    sd = params_to_state_dict(jax.tree_util.tree_map(np.asarray, ref.params),
                              JaxArch(**SMALL))
    solo = _plain()
    solo.model.load_state_dict({k: torch.from_numpy(np.array(v))
                                for k, v in sd.items()})
    path = str(tmp_path / 'start.pth')
    solo.save_checkpoint(path)
    start = _numpy(solo.params)
    batches = _batches(32)[:STEPS]
    want = [float(ref.step({k: jnp.asarray(v) for k, v in b.items()}))
            for b in batches]
    mine = [float(solo.step(b)) for b in batches]
    end = _numpy(solo.params)
    results = launch(__file__, 'spatial4', 4, tmp_path, {'start': path})
    for r, res in enumerate(results):
        assert res['world_group'] and res['ens_groups'] == [True, True, 2], r
        np.testing.assert_allclose(res['losses'], want, rtol=1e-4,
                                   err_msg=f'rank {r}')
        np.testing.assert_allclose(res['losses'], mine, rtol=1e-5,
                                   err_msg=f'rank {r}')
        _check_update(start, end, res['params'], 1e-4, r)
