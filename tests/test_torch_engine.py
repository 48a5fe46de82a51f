"""The PyTorch port's engines against the reference package's
``predict_array``: the same synthetic nnU-Net database (two groups, plan
spacing (1.2, 2.0), so both axes resample), the same float inputs.

- exact (fp32) programs: masks agree on >= 99.9% of pixels (the
  tests/test_019_full_chain_parity.py bar: logits from two conv stacks
  differ by ~1e-5, which flips only pixels on the decision boundary);
- fast (bf16 U-Net) programs: >= 99% (bf16 roundings land in other places:
  the port runs its fused block chain, the reference on the CPU its
  unfused bf16 blocks, so logits differ by ~1e-2 and more borderline
  pixels flip).

The ensemble is held against the reference's ``EnsembleEngine``, the
per-model engine against its ``InferenceEngine`` for a multilabel and a
softmax model. Measured agreements are written beside the assertions."""

import json
import os

import numpy as np
import pytest
import torch

from tests.model_fixtures import build_group_set
import jax.numpy as jnp

from totalsegmentator2d_tpu.inference import EnsembleEngine as JaxEngine
from totalsegmentator2d_tpu.inference import Zoo as JaxZoo
from totalsegmentator2d_tpu.inference.engine import \
    InferenceEngine as JaxInferenceEngine
from totalsegmentator2d_tpu_torch.inference import (EnsembleEngine,
                                                    InferenceEngine, Zoo)
from totalsegmentator2d_tpu_torch.ops.cuda.fused_block import \
    fused_norm_act_conv_cuda
from totalsegmentator2d_tpu_torch.ops.cuda.prefilter import bspline_prefilter_cuda

KEY = 'ts2d-v9-test'
VARIANTS = ('multilabel', 'softmax', 'masked-norm')


def _database(root, variant):
    build_group_set(root, spacing=(1.2, 2.0),
                    multilabel=(variant != 'softmax'))
    if variant == 'masked-norm':
        for dirpath, _, files in os.walk(root):
            if 'plans.json' in files:
                path = os.path.join(dirpath, 'plans.json')
                with open(path) as f:
                    plans = json.load(f)
                plans['configurations']['2d']['use_mask_for_norm'] = [True, True]
                with open(path, 'w') as f:
                    json.dump(plans, f)


@pytest.fixture(scope='module', params=VARIANTS)
def engines(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp(request.param))
    _database(root, request.param)
    jzoo = JaxZoo(remote=False, local=root)
    jmodels = [jzoo.load(i) for i in jzoo.resolve(KEY, unique_model=True)]
    jparams = [m.load_fold_params() for m in jmodels]
    ref = JaxEngine([m.spec for m in jmodels], jparams)
    zoo = Zoo(local=root)
    models = [zoo.load(i) for i in zoo.resolve(KEY, unique_model=True)]
    params = [m.load_fold_params() for m in models]
    port = EnsembleEngine([m.spec for m in models], params, device='cpu')
    return ref, port


def _input(rng, shape, border=3):
    arr = np.zeros(shape + (2,), np.float32)
    inner = (shape[0] - 2 * border, shape[1] - 2 * border, 2)
    arr[border:-border, border:-border] = rng.standard_normal(inner) * 50 + 100
    return arr


@pytest.mark.parametrize('shape,spacing', [((50, 40), (1.0, 2.5)),
                                           ((140, 60), (1.0, 2.6))])
def test_solo_program_matches_reference(engines, rng, shape, spacing):
    ref_engine, port = engines
    arr = _input(rng, shape)
    ref = ref_engine.predict_array(arr, spacing)
    before = bspline_prefilter_cuda.launches
    out = port.predict_array(arr, spacing)
    assert bspline_prefilter_cuda.launches == before  # CPU: plain version
    assert out.shape == ref.shape == shape + (port.total_labels,)
    assert out.dtype == np.uint8
    agree = float((out == ref).mean())
    assert agree >= 0.999, f'mask agreement {agree}'
    assert 0.0 < out.mean() < 1.0


def test_engine_metadata(engines):
    ref, port = engines
    assert port.labels() == ref.labels()
    assert port.total_labels == ref.total_labels


def test_device_default_needs_cuda(engines, monkeypatch):
    _, port = engines
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    params = [[m.state_dict() for m in folds] for folds in port.models]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        EnsembleEngine(port.specs, params)


def _models(root):
    """(reference HostedModels, port HostedModels) of the database."""
    jzoo = JaxZoo(remote=False, local=root)
    zoo = Zoo(local=root)
    return ([jzoo.load(i) for i in jzoo.resolve(KEY, unique_model=True)],
            [zoo.load(i) for i in zoo.resolve(KEY, unique_model=True)])


@pytest.fixture(scope='module')
def multilabel_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('fast'))
    _database(root, 'multilabel')
    return root


def test_fast_ensemble_matches_reference(multilabel_root, rng):
    """The fast ensemble (bf16 parameters, the fused chain on the plain
    kernel version) against the reference's bf16 EnsembleEngine. Measured
    agreement on the CPU: 0.99855 (input 140 x 60)."""
    jmodels, models = _models(multilabel_root)
    ref_engine = JaxEngine([m.spec for m in jmodels],
                           [m.load_fold_params() for m in jmodels],
                           compute_dtype=jnp.bfloat16)
    port = EnsembleEngine([m.spec for m in models],
                          [m.load_fold_params() for m in models],
                          compute_dtype=torch.bfloat16, device='cpu')
    arr = _input(rng, (140, 60))
    ref = ref_engine.predict_array(arr, (1.0, 2.6))
    before = fused_norm_act_conv_cuda.launches
    out = port.predict_array(arr, (1.0, 2.6))
    assert fused_norm_act_conv_cuda.launches == before  # CPU: plain version
    assert out.shape == ref.shape and out.dtype == np.uint8
    agree = float((out == ref).mean())
    assert agree >= 0.99, f'mask agreement {agree}'
    assert 0.0 < out.mean() < 1.0


@pytest.fixture(scope='module', params=['multilabel', 'softmax'])
def single_model(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp('single-' + request.param))
    _database(root, request.param)
    jmodels, models = _models(root)
    return jmodels[1], models[1]


@pytest.mark.parametrize('precision', ['exact', 'fast'])
def test_inference_engine_matches_reference(single_model, rng, precision):
    """The per-model engine: (H, W, L) one-hot (multilabel) or (H, W)
    labels (softmax), against the reference's InferenceEngine. Measured
    agreement on the CPU: 1.0 exact; fast 0.99844 (multilabel) and
    0.99822 (softmax)."""
    jmodel, model = single_model
    fast = precision == 'fast'
    ref_engine = JaxInferenceEngine(
        jmodel.spec, jmodel.load_fold_params(),
        compute_dtype=jnp.bfloat16 if fast else None)
    port = InferenceEngine(model.spec, model.load_fold_params(),
                           compute_dtype=torch.bfloat16 if fast else None,
                           device='cpu')
    arr = _input(rng, (90, 50))
    ref = ref_engine.predict_array(arr, (1.0, 2.5))
    out = port.predict_array(arr, (1.0, 2.5))
    shape = (90, 50) + ((3,) if model.multilabel else ())
    assert out.shape == ref.shape == shape and out.dtype == np.uint8
    agree = float((out == ref).mean())
    assert agree >= (0.99 if fast else 0.999), f'mask agreement {agree}'
    assert 0 < out.mean() < out.max()
