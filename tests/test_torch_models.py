"""The PyTorch port's U-Net module against the reference package's
``forward``: the same random weights (init_params_np with randomized
InstanceNorm affines and biases) carried across by ``params_from_jax``, the
same numpy input, NHWC logits at rtol 1e-3 / atol 1e-4 (the
tests/test_004_models.py bar: two conv stacks with their own accumulation
orders). The nnU-Net checkpoint loader must load the same module.

The fast (bf16) forward is held against the reference's
``forward(compute_dtype=bfloat16)`` with its fused block chain forced on
inside the test (the reference gates it to TPUs; here its Pallas kernel
runs in interpret mode) at rtol 0.1 / atol 0.05 on the logits: the
tests/test_013_pallas.py bar for a fused stack against another bf16
chain, as bf16 roundings land in other places."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_mirror import make_spec
from totalsegmentator2d_tpu.models import unet as JU
from totalsegmentator2d_tpu.models.convert import params_to_state_dict
from totalsegmentator2d_tpu.models.unet import forward, init_params_np
from totalsegmentator2d_tpu_torch.models.convert import (load_checkpoint,
                                                         load_into,
                                                         params_from_jax)
from totalsegmentator2d_tpu_torch.models.unet import UNet

ARCHS = {
    'default': dict(in_channels=2, out_channels=5, n_stages=4),
    'shallow': dict(in_channels=1, out_channels=3, n_stages=3,
                    features=(4, 8, 16)),
    'wide-head': dict(in_channels=2, out_channels=26, n_stages=4,
                      features=(8, 16, 32, 64)),
}


def _params(spec, seed):
    params = init_params_np(seed, spec)
    rng = np.random.default_rng(seed + 100)

    def randomize(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if k in ('scale',):
                    node[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                elif k in ('bias', 'b'):
                    node[k] = rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
                else:
                    randomize(v)
        elif isinstance(node, list):
            for v in node:
                randomize(v)
    randomize(params)
    return params


@pytest.mark.parametrize('name', sorted(ARCHS))
def test_forward_matches_reference(rng, name):
    spec = make_spec(**ARCHS[name])
    params = _params(spec, seed=3)
    net = UNet(spec).eval()
    net.load_state_dict(params_from_jax(params), strict=True)
    x = rng.standard_normal((2, 32, 48, spec.in_channels)).astype(np.float32)
    ref = np.asarray(forward(params, jnp.asarray(x), spec))
    with torch.no_grad():
        out = net(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 32, 48, spec.out_channels)
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-4)


def test_nnunet_checkpoint_loads_the_same_module(tmp_path, rng):
    spec = make_spec(**ARCHS['default'])
    params = _params(spec, seed=5)
    # the key layout of a real nnU-Net v2 checkpoint: DDP prefix, the extra
    # Sequential level of encoder stages, the decoder's encoder alias
    sd = {}
    for k, v in params_to_state_dict(params, spec).items():
        if k.startswith('encoder.stages.'):
            s, rest = k[len('encoder.stages.'):].split('.', 1)
            sd[f'module.decoder.encoder.stages.{s}.0.{rest}'] = torch.tensor(v)
            k = f'encoder.stages.{s}.0.{rest}'
        sd['module.' + k] = torch.tensor(np.ascontiguousarray(v))
    path = tmp_path / 'checkpoint_final.pth'
    torch.save({'network_weights': sd, 'inference_allowed_mirroring_axes': [0, 1],
                'trainer_name': 'nnUNetTrainer'}, path)

    loaded, meta = load_checkpoint(str(path))
    assert meta['inference_allowed_mirroring_axes'] == [0, 1]
    a, b = UNet(spec).eval(), UNet(spec).eval()
    load_into(a, loaded)
    b.load_state_dict(params_from_jax(params), strict=True)
    x = torch.from_numpy(rng.standard_normal((1, 32, 32, 2)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(a(x), b(x), rtol=0, atol=0)


def test_missing_weights_raise():
    spec = make_spec(**ARCHS['default'])
    sd = params_from_jax(_params(spec, seed=1))
    del sd['decoder.seg_layers.2.weight']
    with pytest.raises(RuntimeError):
        load_into(UNet(spec), sd)


def test_untrusted_container_needs_opt_in(tmp_path, monkeypatch):
    spec = make_spec(**ARCHS['default'])
    sd = params_from_jax(_params(spec, seed=2))
    path = tmp_path / 'checkpoint_final.pth'
    # a numpy array in the checkpoint: the safe unpickler refuses it
    torch.save({'network_weights': sd, 'init_args': {'x': np.zeros(2)}}, path)
    monkeypatch.delenv('TS2D_TRUST_CHECKPOINTS', raising=False)
    with pytest.raises(RuntimeError, match='TS2D_TRUST_CHECKPOINTS'):
        load_checkpoint(str(path))
    monkeypatch.setenv('TS2D_TRUST_CHECKPOINTS', '1')
    loaded, meta = load_checkpoint(str(path))
    assert set(loaded) == set(sd) and 'init_args' in meta


def test_no_norm_affine_skips_the_norm(rng):
    """Without norm affines the reference's blocks are conv -> LeakyReLU
    (no normalization): the port follows it."""
    spec = dataclasses.replace(make_spec(**ARCHS['shallow']), norm_affine=False)
    params = _params(spec, seed=4)
    assert 'norm' not in params['encoder']['stages'][0][0]
    net = UNet(spec).eval()
    net.load_state_dict(params_from_jax(params), strict=True)
    assert all(b.norm is None for b in net.encoder.stages[0].convs)
    x = rng.standard_normal((2, 32, 48, spec.in_channels)).astype(np.float32)
    ref = np.asarray(forward(params, jnp.asarray(x), spec))
    with torch.no_grad():
        out = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-4)


FAST_ARCH = dict(in_channels=2, out_channels=4, n_stages=3,
                 features=(8, 16, 16))


@pytest.fixture
def reference_fused(monkeypatch):
    """The reference forward with its fused chain on (interpret mode)."""
    monkeypatch.setattr(JU, 'fused_blocks_enabled', lambda: True)
    monkeypatch.setattr(JU, '_conv_stack_fused', functools.partial(
        JU._conv_stack_fused, interpret=True))


@pytest.mark.parametrize('bf16_params', [False, True],
                         ids=['fp32-params', 'bf16-params'])
def test_fast_forward_matches_reference(rng, reference_fused, bf16_params):
    """fp32 parameters: the per-model engine's; bf16-rounded ones: the fast
    ensemble's. Measured worst |diff| on the CPU: 4.8e-7 (fp32 parameters)
    and 3.4e-3 (bf16 ones) on logits up to 4.1."""
    spec = make_spec(**FAST_ARCH)
    params = _params(spec, seed=6)
    x = rng.standard_normal((2, 16, 16, 2)).astype(np.float32)
    jparams = params
    if bf16_params:
        jparams = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.bfloat16), params)
    ref = np.asarray(forward(jparams, jnp.asarray(x), spec,
                             compute_dtype=jnp.bfloat16), np.float32)
    net = UNet(spec).eval()
    net.load_state_dict(params_from_jax(params, bf16=bf16_params), strict=True)
    net.prepare_fast()
    with torch.no_grad():
        out = net(torch.from_numpy(x), compute_dtype=torch.bfloat16)
    assert out.dtype == torch.float32
    assert out.shape == ref.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0.1, atol=0.05)


def test_fast_forward_unfused_route_matches_reference(rng):
    """Stacks of one block (no fused chain) run the bf16 block as the
    reference's unfused bf16 forward does."""
    spec = dataclasses.replace(make_spec(**FAST_ARCH),
                               n_conv_per_stage=(1, 1, 1),
                               n_conv_per_stage_decoder=(1, 1))
    params = _params(spec, seed=7)
    net = UNet(spec).eval()
    net.load_state_dict(params_from_jax(params), strict=True)
    assert not any(st.fused for st in net.encoder.stages)
    x = rng.standard_normal((2, 16, 16, 2)).astype(np.float32)
    ref = np.asarray(forward(params, jnp.asarray(x), spec,
                             compute_dtype=jnp.bfloat16), np.float32)
    with torch.no_grad():
        out = net(torch.from_numpy(x), compute_dtype=torch.bfloat16).numpy()
    np.testing.assert_allclose(out, ref, rtol=0.1, atol=0.05)
