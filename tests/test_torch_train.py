"""Training of the port (training/, models/unet.py) against the reference
package's on the same numpy inputs from a seed.

Bars: ``resize_to_shape`` at orders 0/1/3 rtol 1e-5 / atol 1e-6; losses
rtol 1e-5; planner plans equal; ``preprocess_case`` rtol /
atol 1e-5 (the cubic resample's fp32 sums in another order);
``PatchSampler`` batches bit for bit; the optimizer against optax's chain
over 20 steps, each leaf within 1e-6 of its largest value (a near-zero
element may differ by an ulp of the leaf's scale); three train steps from the same
weights (augment off, the reduced ``SMALL`` architecture) in '1pass' and
'2pass' at rtol 1e-4 on the losses and atol 1e-5 on the weights (fp32
conv backward sums in another order), bf16 losses at rtol 2e-2 (bf16
rounds at other places in the two frameworks); the deep-supervision heads
at the U-Net bars (rtol 1e-3 / atol 1e-4); ``init_params_np`` and
``params_to_state_dict`` bit for bit; a restored trainer resumes bit for
bit."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from totalsegmentator2d_tpu.io import MedicalImage as JaxImage
from totalsegmentator2d_tpu.models.convert import params_to_state_dict as jax_p2sd
from totalsegmentator2d_tpu.models.plans import ArchSpec as JaxArch
from totalsegmentator2d_tpu.models.plans import parse_model_spec as jax_parse
from totalsegmentator2d_tpu.models.unet import forward as jax_forward
from totalsegmentator2d_tpu.models.unet import init_params_np as jax_init_np
from totalsegmentator2d_tpu.ops.resample import resize_to_shape as jax_resize
from totalsegmentator2d_tpu.training import data as JD
from totalsegmentator2d_tpu.training import losses as JL
from totalsegmentator2d_tpu.training import planner as JP
from totalsegmentator2d_tpu.training import train as JT

from totalsegmentator2d_tpu_torch.io import MedicalImage
from totalsegmentator2d_tpu_torch.models.convert import (load_into,
                                                         params_from_jax,
                                                         params_to_state_dict)
from totalsegmentator2d_tpu_torch.models.plans import ArchSpec, parse_model_spec
from totalsegmentator2d_tpu_torch.models.unet import (UNet, init_params,
                                                      init_params_np)
from totalsegmentator2d_tpu_torch.ops.cuda import prefilter as PF
from totalsegmentator2d_tpu_torch.ops.resample import resize_to_shape
from totalsegmentator2d_tpu_torch.training import data as D
from totalsegmentator2d_tpu_torch.training import losses as L
from totalsegmentator2d_tpu_torch.training import planner as P
from totalsegmentator2d_tpu_torch.training import train as T

# the reduced architecture of chip_smoke.py's GPU-against-CPU phases
SMALL = dict(n_stages=4, features_per_stage=(8, 16, 32, 32),
             kernel_sizes=((3, 3),) * 4,
             strides=((1, 1), (2, 2), (2, 2), (2, 2)),
             n_conv_per_stage=(2, 2, 2, 2), n_conv_per_stage_decoder=(2, 2, 2),
             in_channels=2, out_channels=3)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- resize ---------------------------------------------------------------------

@pytest.mark.parametrize('order', [0, 1, 3])
@pytest.mark.parametrize('shape,new,axes', [
    ((30, 26), (15, 13), None), ((30, 26, 2), (41, 19), (0, 1)),
    ((20, 17), (20, 40), None), ((3, 24, 22), (3, 11, 30), (1, 2))])
def test_resize_to_shape_matches_reference(rng, order, shape, new, axes):
    """Down and up, one axis unchanged (order 3 prefilters only the axes
    that change), the skimage edge convention."""
    a = rng.standard_normal(shape).astype(np.float32)
    ref = jax_resize(a, new[-2:] if axes else new, order=order, axes=axes)
    ours = resize_to_shape(a, new[-2:] if axes else new, order=order,
                           axes=axes, device='cpu')
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


# -- losses ---------------------------------------------------------------------

@pytest.mark.parametrize('multilabel', [True, False])
def test_losses_match_reference(rng, multilabel):
    logits = rng.standard_normal((2, 16, 12, 4)).astype(np.float32) * 3
    if multilabel:
        target = (rng.random((2, 16, 12, 4)) > 0.7).astype(np.uint8)
    else:
        target = rng.integers(0, 4, (2, 16, 12)).astype(np.int32)
    jl, jt = jnp.asarray(logits), jnp.asarray(target)
    pl, pt = _t(logits), _t(target)
    for name in ('soft_dice_loss', 'dice_and_ce'):
        ref = float(getattr(JL, name)(jl, jt, multilabel))
        ours = float(getattr(L, name)(pl, pt, multilabel))
        np.testing.assert_allclose(ours, ref, rtol=1e-5)
    np.testing.assert_allclose(
        float(L.soft_dice_loss(pl, pt, multilabel, batch_dice=True)),
        float(JL.soft_dice_loss(jl, jt, multilabel, batch_dice=True)),
        rtol=1e-5)
    if multilabel:
        np.testing.assert_allclose(float(L.bce_loss(pl, pt)),
                                   float(JL.bce_loss(jl, jt)), rtol=1e-5)
        np.testing.assert_allclose(
            L.dice_score(pl > 0, pt).numpy(),
            np.asarray(JL.dice_score(jl > 0, jt)), rtol=1e-5)
    else:
        np.testing.assert_allclose(float(L.ce_loss(pl, pt)),
                                   float(JL.ce_loss(jl, jt)), rtol=1e-5)
    heads = [rng.standard_normal((2, 16 >> i, 12 >> i, 4)).astype(np.float32)
             for i in range(3)]
    for i, h in enumerate(heads):
        np.testing.assert_array_equal(
            L._downsample_target(pt, h.shape[1:3], multilabel).numpy(),
            np.asarray(JL._downsample_target(jt, h.shape[1:3], multilabel)))
    np.testing.assert_allclose(
        float(L.deep_supervision_loss([_t(h) for h in heads], pt, multilabel)),
        float(JL.deep_supervision_loss([jnp.asarray(h) for h in heads], jt,
                                       multilabel)), rtol=1e-5)
    np.testing.assert_array_equal(L.deep_supervision_weights(4).numpy(),
                                  np.asarray(JL.deep_supervision_weights(4)))


# -- planner, preprocessing, sampler --------------------------------------------------

def _cases(rng, n=3, spacing=(1.5, 1.2)):
    out = []
    for i in range(n):
        h, w = 60 + 6 * i, 50 + 4 * i
        arr = (rng.standard_normal((h, w, 2)) * 200 + 50).astype(np.float32)
        tgt = np.zeros((h, w, 2), np.uint8)
        tgt[h // 4:h // 2, w // 4:w // 2, 0] = 1
        tgt[h // 2:h - 10, w // 2:w - 10, 1] = 1
        out.append((arr, tgt, spacing))
    return out


def _both(cases):
    jax_cases = [(JaxImage(array=a, spacing=s, is_vector=True),
                  JaxImage(array=t, spacing=s, is_vector=True))
                 for a, t, s in cases]
    port_cases = [(MedicalImage(array=a, spacing=s, is_vector=True),
                   MedicalImage(array=t, spacing=s, is_vector=True))
                  for a, t, s in cases]
    return jax_cases, port_cases


@pytest.mark.parametrize('modality', ['CT', 'MR'])
def test_planner_matches_reference(rng, modality):
    jc, pc = _both(_cases(rng))
    jfp = JP.compute_fingerprint([c[0] for c in jc], [c[1] for c in jc])
    pfp = P.compute_fingerprint([c[0] for c in pc], [c[1] for c in pc])
    for field in ('intensity_mean', 'intensity_std', 'percentile_00_5',
                  'percentile_99_5', 'n_channels'):
        assert getattr(pfp, field) == getattr(jfp, field)
    np.testing.assert_array_equal(pfp.spacings, jfp.spacings)
    args = ({0: 'max', 1: 'mean'}, {'heart': 1, 'aorta': 2})
    assert P.plan_experiment(pfp, *args, modality=modality, max_patch=64) \
        == JP.plan_experiment(jfp, *args, modality=modality, max_patch=64)


@pytest.mark.parametrize('spacing', [(3.0, 2.5), (1.0, 1.0)])
def test_preprocess_case_matches_reference(rng, spacing):
    jc, pc = _both(_cases(rng, n=1, spacing=spacing))
    plans, ds = JP.plan_experiment(
        JP.compute_fingerprint([jc[0][0]], [jc[0][1]]), {0: 'a', 1: 'b'},
        {'x': 1, 'y': 2})
    plans['configurations']['2d']['spacing'] = [1.2, 1.6]
    ref = JD.preprocess_case(*jc[0], jax_parse(plans, ds))
    ours = D.preprocess_case(*pc[0], parse_model_spec(plans, ds), device='cpu')
    assert ours[0].dtype == ref[0].dtype and ours[0].shape == ref[0].shape
    np.testing.assert_allclose(ours[0], ref[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ours[1], ref[1])


@pytest.mark.parametrize('pack', [False, True])
def test_patch_sampler_bit_for_bit(rng, pack):
    cases = [(a, t) for a, t, _ in _cases(rng)] + [
        (rng.standard_normal((20, 30, 2)).astype(np.float32),
         np.zeros((20, 30, 2), np.uint8))]   # smaller than the patch, no fg
    ref = JD.PatchSampler(cases, (32, 32), seed=4)
    ours = D.PatchSampler(cases, (32, 32), seed=4)
    for _ in range(3):
        a = ref.sample_batch(5, pack_targets=pack)
        b = ours.sample_batch(5, pack_targets=pack)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])


@pytest.mark.parametrize('L_', [1, 7, 8, 24, 33])
def test_pack_unpack_roundtrip(rng, L_):
    tgt = (rng.random((3, 20, 18, L_)) > 0.7).astype(np.uint8)
    packed = D.pack_target_np(tgt)
    np.testing.assert_array_equal(packed, JD.pack_target_np(tgt))
    np.testing.assert_array_equal(T.unpack_target(_t(packed), L_).numpy(), tgt)


# -- the U-Net's training surfaces -------------------------------------------------

def test_init_and_state_dict_match_reference():
    ja, pa = JaxArch(**SMALL), ArchSpec(**SMALL)
    pj, pp = jax_init_np(5, ja), init_params_np(5, pa)
    for a, b in zip(jax.tree_util.tree_leaves(pj), jax.tree_util.tree_leaves(pp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    model = UNet(pa)
    load_into(model, params_from_jax(pp))
    ref, ours = jax_p2sd(pj, ja), params_to_state_dict(model)
    assert sorted(ref) == sorted(ours)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
    # the generator initializer: the reference's He std, zero biases
    sd = init_params(torch.Generator().manual_seed(0), pa)
    assert sorted(sd) == sorted(ref)
    w = sd['encoder.stages.1.convs.0.conv.weight']
    assert abs(float(w.std()) - (2.0 / (8 * 9)) ** 0.5) < 0.02
    assert not sd['decoder.seg_layers.2.bias'].any()


def test_deep_supervision_heads_match_reference(rng):
    ja, pa = JaxArch(**SMALL), ArchSpec(**SMALL)
    params = jax_init_np(2, ja)
    x = rng.standard_normal((2, 32, 32, 2)).astype(np.float32)
    ref = jax_forward(params, jnp.asarray(x), ja, True)
    model = UNet(pa)
    load_into(model, params_from_jax(params))
    with torch.no_grad():
        ours = model.forward(_t(x), deep_supervision=True)
        remat = model.forward_train(_t(x).permute(0, 3, 1, 2).contiguous(),
                                    deep_supervision=True, remat=True)
    assert len(ours) == len(ref) == 3
    for o, r, m in zip(ours, ref, remat):
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-3,
                                   atol=1e-4)
        np.testing.assert_array_equal(m.permute(0, 2, 3, 1).numpy(), o.numpy())


# -- the optimizer and the train step ------------------------------------------------

def test_optimizer_matches_optax_chain(rng):
    cfg = T.TrainConfig(lr=1e-2, total_steps=20, weight_decay=3e-5)
    shapes = [(3, 3, 2, 4), (4,), (7, 5)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(20)]
    tx = JT.make_optimizer(JT.TrainConfig(lr=1e-2, total_steps=20,
                                          weight_decay=3e-5))
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(_t(p)) for p in p0]
    opt = T.make_optimizer(cfg, tp)
    for step, g in enumerate(grads):
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = _t(x)
        for group in opt.param_groups:
            group['lr'] = T.poly_lr(cfg, step)
        opt.step()
        for a, b in zip(tp, jp):   # rtol 1e-6 of each leaf's largest value
            a, b = a.detach().numpy(), np.asarray(b)
            assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max(), step


def _jax_steps(params, batch, cfg, n):
    tx = JT.make_optimizer(cfg)
    step = jax.jit(functools.partial(JT.train_step, spec=JaxArch(**SMALL),
                                     cfg=cfg, optimizer=tx))
    state = tx.init(params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for _ in range(n):
        params, state, loss = step(params, state, jb)
        losses.append(float(loss))
    return params, losses


def _port_trainer(params, cfg, seed=0):
    tr = T.Trainer(ArchSpec(**SMALL), cfg, seed=seed, device='cpu')
    load_into(tr.model, params_from_jax(params))
    return tr


@pytest.mark.parametrize('stats', ['1pass', '2pass'])
def test_train_steps_match_reference(rng, stats):
    kw = dict(lr=1e-2, total_steps=10, multilabel=True, stats=stats)
    params = jax_init_np(3, JaxArch(**SMALL))
    batch = {'image': rng.standard_normal((2, 64, 64, 2)).astype(np.float32),
             'target': (rng.random((2, 64, 64, 3)) > 0.7).astype(np.uint8)}
    ref_params, ref_losses = _jax_steps(params, batch, JT.TrainConfig(**kw), 3)
    tr = _port_trainer(params, T.TrainConfig(**kw))
    losses = [float(tr.step(batch)) for _ in range(3)]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    ref_sd = jax_p2sd(jax.tree_util.tree_map(np.asarray, ref_params),
                      JaxArch(**SMALL))
    ours = params_to_state_dict(tr.model)
    for k in ref_sd:
        np.testing.assert_allclose(ours[k], ref_sd[k], atol=1e-5, err_msg=k)


def test_bf16_and_remat_train_steps(rng):
    kw = dict(lr=1e-2, total_steps=10, multilabel=True, compute_dtype='bf16')
    params = jax_init_np(4, JaxArch(**SMALL))
    batch = {'image': rng.standard_normal((2, 32, 32, 2)).astype(np.float32),
             'target': (rng.random((2, 32, 32, 3)) > 0.7).astype(np.uint8)}
    _, ref_losses = _jax_steps(params, batch, JT.TrainConfig(**kw), 3)
    tr = _port_trainer(params, T.TrainConfig(**kw))
    losses = [float(tr.step(batch)) for _ in range(3)]
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-2)
    assert all(v.dtype == torch.float32 for v in tr.params.values())
    remat = _port_trainer(params, T.TrainConfig(remat=True, **kw))
    assert [float(remat.step(batch)) for _ in range(3)] == losses


def test_softmax_targets_and_packed_equal(rng):
    """A label-map (softmax) step against the reference; a packed target
    steps exactly as the unpacked one."""
    kw = dict(lr=1e-2, total_steps=5, multilabel=False,
              deep_supervision=False)
    params = jax_init_np(6, JaxArch(**SMALL))
    labels = rng.integers(0, 3, (2, 32, 32)).astype(np.int32)
    image = rng.standard_normal((2, 32, 32, 2)).astype(np.float32)
    _, ref = _jax_steps(params, {'image': image, 'target': labels},
                        JT.TrainConfig(**kw), 2)
    tr = _port_trainer(params, T.TrainConfig(**kw))
    ours = [float(tr.step({'image': image, 'target': labels}))
            for _ in range(2)]
    np.testing.assert_allclose(ours, ref, rtol=1e-4)
    onehot = (rng.random((2, 32, 32, 3)) > 0.7).astype(np.uint8)
    cfg = T.TrainConfig(lr=1e-2, total_steps=4)
    a = T.Trainer(ArchSpec(**SMALL), cfg, seed=3, device='cpu')
    b = T.Trainer(ArchSpec(**SMALL), cfg, seed=3, device='cpu')
    la = float(a.step({'image': image, 'target': onehot}))
    lb = float(b.step({'image': image,
                       'target_packed': D.pack_target_np(onehot)}))
    assert la == lb


def test_config_and_parallel_refusals():
    assert T.TrainConfig().stats == '1pass'
    with pytest.raises(ValueError, match='bfloat16'):
        T.TrainConfig(compute_dtype='float16')
    with pytest.raises(ValueError, match='1pass'):
        T.TrainConfig(stats='onepass')
    for call in (lambda: T.Trainer(ArchSpec(**SMALL), T.TrainConfig(),
                                   mesh=object(), device='cpu'),
                 lambda: T.build_sharded_train_step(None, None, None, None)):
        with pytest.raises(TypeError, match='DeviceMesh'):
            call()
    # spatial=True without a mesh trains unsharded, as the reference's
    # Trainer does: step for step the spatial=False trainer's
    rng = np.random.default_rng(4)
    batches = _batches(rng, 3, size=2)
    plain, spatial = (T.Trainer(ArchSpec(**SMALL), T.TrainConfig(), seed=2,
                                spatial=sp, device='cpu')
                      for sp in (False, True))
    for b in batches:
        assert float(plain.step(b)) == float(spatial.step(b))
    for k, v in plain.params.items():
        assert torch.equal(v, spatial.params[k]), k


# -- the trainer loop ----------------------------------------------------------------

def _batches(rng, n, size=8):
    return [{'image': rng.standard_normal((size, 32, 32, 2)).astype(np.float32),
             'target': (rng.random((size, 32, 32, 3)) > 0.7).astype(np.uint8)}
            for _ in range(n)]


def test_resume_is_bit_for_bit(rng, tmp_path):
    """Steps 1-4 straight against 1-2, save, restore into a new trainer,
    3-4: the same losses and weights, augmentation on (its generator state
    is in the checkpoint)."""
    cfg = T.TrainConfig(lr=1e-2, total_steps=4, augment=True)
    batches = _batches(rng, 4)
    spec = ArchSpec(**SMALL)
    straight = T.Trainer(spec, cfg, seed=1, device='cpu')
    ref = [float(straight.step(b)) for b in batches]
    first = T.Trainer(spec, cfg, seed=1, device='cpu')
    got = [float(first.step(b)) for b in batches[:2]]
    path = str(tmp_path / 'ckpt' / 'fold_0.pth')
    first.save_checkpoint(path)
    resumed = T.Trainer(spec, cfg, seed=99, device='cpu')
    resumed.restore_checkpoint(path)
    assert resumed.step_count == 2
    got += [float(resumed.step(b)) for b in batches[2:]]
    assert got == ref
    for k, v in straight.params.items():
        assert torch.equal(resumed.params[k], v), k


def test_augmented_ensemble_trainer_runs(rng):
    """Augment on, a stacked ensemble of 2 on (G, N, ...) batches: each
    group trains on its own slice; the launches of the prefilter's plain
    version show the warp stack and the low-res levels ran."""
    cfg = T.TrainConfig(lr=1e-2, total_steps=3, augment=True)
    tr = T.Trainer(ArchSpec(**SMALL), cfg, seed=0, ensemble_size=2,
                   device='cpu')
    batch = {'image': rng.standard_normal((2, 8, 32, 32, 2)).astype(np.float32),
             'target': (rng.random((2, 8, 32, 32, 3)) > 0.7).astype(np.uint8)}
    calls = []
    real = PF.bspline_prefilter_plain

    def spy(x, axis):
        calls.append(tuple(x.shape))
        return real(x, axis)

    PF.bspline_prefilter_plain = spy
    try:
        losses = [tr.step(batch) for _ in range(2)]
    finally:
        PF.bspline_prefilter_plain = real
    assert all(tuple(x.shape) == (2,) and torch.isfinite(x).all()
               for x in losses)
    assert calls and len(tr.params) == 2
    # a partitioned warp stack of round(8 * 0.36) = 3 samples per group
    assert (3, 32, 32, 2) in calls
