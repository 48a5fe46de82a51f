"""The port's per-model engine at the logit level, on the CPU: its
``predict_array(..., return_logits=True)`` against the reference package's
and against the independent oracle ``tests/reference_chain.predict``
(numpy, scipy and tests/torch_mirror.py's U-Net), on test_019's inputs.

- Against the reference's ``InferenceEngine`` with the same weights
  (``params_from_jax``): masks and bbox equal, logits at the U-Net bars
  (rtol 1e-3 / atol 1e-4). Measured: at most 1.23e-06 apart.
- Against the oracle, test_019's bars: logit error < 5e-3 and agreement
  >= 0.999 over its 6 configurations, a multi-tile grid and no mirroring.
  Measured: at most 7.2e-07, agreement 1.0.
- test_005's flip symmetry of the mirrored prediction.
- ``dtype``: float32 only. The reference's engines take the parameter
  but fail at the first predict with bfloat16 (a TypeError: their convs
  meet a float32 input and bf16 weights), so the port refuses any other
  value at construction."""

import functools

import numpy as np
import pytest
import torch

from tests import reference_chain as RC
from totalsegmentator2d_tpu.inference import InferenceEngine as JaxEngine
from totalsegmentator2d_tpu_torch.inference import (EnsembleEngine,
                                                    InferenceEngine)
from totalsegmentator2d_tpu_torch.models.convert import params_from_jax

CONFIGS = ('multilabel', 'softmax', 'masked-norm', 'resampling',
           'multifold', 'ct-norm')
BF16 = torch.bfloat16


@pytest.fixture(scope='module', autouse=True)
def _two_threads():
    """torch on 2 intra-op threads: the tier runs this file beside other
    test workers, and the oracle's many small batch-1 forwards on a
    full-width thread pool per worker oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _config(name):
    """(spec, oracle nets, reference fold params, port state dicts)."""
    spec, nets, fold_params = RC.build_config(name)
    return spec, nets, fold_params, [params_from_jax(p) for p in fold_params]


@functools.lru_cache(maxsize=None)
def _case(name):
    """test_019's input of a configuration and the three chains' results:
    (arr, spacing, reference, port, oracle)."""
    arr, spacing = RC.config_input(name, np.random.default_rng(21))
    spec, nets, fold_params, sds = _config(name)
    ref = JaxEngine(spec, fold_params).predict_array(arr, spacing,
                                                     return_logits=True)
    port = InferenceEngine(spec, sds, device='cpu').predict_array(
        arr, spacing, return_logits=True)
    return arr, spacing, ref, port, RC.predict(arr, spacing, spec, nets)


@pytest.mark.parametrize('name', CONFIGS)
def test_logits_match_the_reference_engine(name):
    _, _, (ref_seg, ref_logits, ref_bbox), (seg, logits, bbox), _ = _case(name)
    assert logits.dtype == np.float32 and logits.shape == ref_logits.shape
    assert seg.dtype == np.uint8 and seg.shape == ref_seg.shape
    assert bbox == ref_bbox
    np.testing.assert_array_equal(seg, ref_seg)
    np.testing.assert_allclose(logits, ref_logits, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize('name', CONFIGS)
def test_engine_matches_the_reference_chain(name):
    arr, _, _, (seg, logits, bbox), (o_seg, o_logits, o_bbox) = _case(name)
    assert bbox == o_bbox
    (y0, y1), (x0, x1) = bbox
    assert logits.shape[:2] == (y1 - y0, x1 - x0) != arr.shape[:2]
    err = float(np.abs(logits - o_logits).max())
    agree = float((seg == o_seg).mean())
    assert err < 5e-3, f'{name}: max logit err {err}'
    assert agree >= 0.999, f'{name}: mask agreement {agree}'


def test_the_mask_program_is_the_logits_variants_decision():
    """The logits ride their own program; the masks are the same."""
    arr, spacing, _, (seg, _, _), _ = _case('resampling')
    spec, _, _, sds = _config('resampling')
    eng = InferenceEngine(spec, sds, device='cpu')
    np.testing.assert_array_equal(eng.predict_array(arr, spacing), seg)
    keys = set(eng._cache)
    eng.predict_array(arr, spacing, return_logits=True)
    assert len(eng._cache) == len(keys) + 1


def test_multi_tile_grid(rng):
    arr = np.zeros((150, 140, 2), np.float32)
    arr[5:-5, 5:-5] = rng.standard_normal((140, 130, 2)) + 2
    spec, nets, _, sds = _config('multilabel')
    seg, logits, bbox = InferenceEngine(spec, sds, device='cpu').predict_array(
        arr, (1.5, 1.5), return_logits=True)
    o_seg, o_logits, o_bbox = RC.predict(arr, (1.5, 1.5), spec, nets)
    assert bbox == o_bbox
    assert float(np.abs(logits - o_logits).max()) < 5e-3
    assert float((seg == o_seg).mean()) >= 0.999


def test_no_mirroring(rng):
    spec, nets, _, sds = _config('multilabel')
    arr, spacing = RC.config_input('multilabel', rng)
    eng = InferenceEngine(spec, sds, use_mirroring=False, device='cpu')
    _, logits, _ = eng.predict_array(arr, spacing, return_logits=True)
    _, o_logits, _ = RC.predict(arr, spacing, spec, nets, use_mirroring=False)
    assert float(np.abs(logits - o_logits).max()) < 5e-3


def test_mirror_tta_consistency(rng):
    """test_005's symmetry: with mirror TTA over both axes the logits of a
    flipped input are the flipped logits."""
    from tests.model_fixtures import make_dataset_json, make_plans
    from tests.torch_mirror import TorchPlainConvUNet, make_spec
    from totalsegmentator2d_tpu_torch.models.convert import \
        normalize_state_dict
    from totalsegmentator2d_tpu_torch.models.plans import parse_model_spec

    spec = parse_model_spec(make_plans(patch=(32, 32)),
                            make_dataset_json(('a',), channels=('max',)))
    torch.manual_seed(2)
    net = TorchPlainConvUNet(make_spec(in_channels=1, out_channels=1))
    eng = InferenceEngine(spec, [normalize_state_dict(net.state_dict())],
                          device='cpu')
    arr = np.abs(rng.standard_normal((32, 32, 1))).astype(np.float32) + 1.0
    _, logits, _ = eng.predict_array(arr, (1.5, 1.5), return_logits=True)
    _, logits_f, _ = eng.predict_array(arr[::-1, ::-1], (1.5, 1.5),
                                       return_logits=True)
    np.testing.assert_allclose(logits, logits_f[::-1, ::-1], rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize('engine', ['InferenceEngine', 'EnsembleEngine'])
@pytest.mark.parametrize('kw', [{'dtype': BF16},
                                {'dtype': BF16, 'compute_dtype': BF16},
                                {'dtype': torch.float16}])
def test_work_dtype_is_checked(engine, kw):
    spec, _, _, sds = _config('multilabel')
    with pytest.raises(ValueError, match='dtype must be torch.float32'):
        if engine == 'InferenceEngine':
            InferenceEngine(spec, sds, device='cpu', **kw)
        else:
            EnsembleEngine([spec], [sds], device='cpu', **kw)


# -- tools/torch_parity.py's real mode -------------------------------------------

def _parity_tool():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'tools', 'torch_parity.py')
    spec = importlib.util.spec_from_file_location('torch_parity', path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_real_mode_against_reference_goldens(tmp_path):
    """The real mode on a synthetic database, with goldens written by the
    reference package's TS2D (as the reference's CLI would write them
    elsewhere): the port's segmentation is written, and scored per label
    and per voxel against the golden."""
    from tests.model_fixtures import build_group_set
    from totalsegmentator2d_tpu.api import TS2D as JaxTS2D
    tool = _parity_tool()
    root, golden, out = (str(tmp_path / d) for d in ('db', 'golden', 'out'))
    build_group_set(root, model='ts2d-v9-real')
    asset = 'sample_s0521'
    with JaxTS2D(key='ts2d-v9-real', use_remote=False, fetch_remote=False,
                 local=root) as ref:
        ref.predict(tool._asset_path(asset)).save(
            golden, name=asset, models='final', targets='segmentation',
            content='file')
    report = tool.run_real(root, 'ts2d-v9-real', golden, out, device='cpu',
                           assets=(asset,))
    entry = report['assets'][asset]
    assert report['ok'] and entry['predicted'], report
    assert (tmp_path / 'out' / f'{asset}.seg.nrrd').exists()
    assert entry['voxel_agreement'] >= 0.999, entry
    assert entry['mean_dice'] >= 0.99 and not entry['diverging_labels'], entry
    assert len(entry['per_label_dice']) == 5
