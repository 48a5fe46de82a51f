"""The PyTorch port's cohort programs against the reference package's, on
the CPU (the two-group synthetic database, patch 64, plan spacing 1.5 mm;
the volumes of tests/test_008_ensemble_engine.py's TestCohort).

- ``predict_cohort``: one batched program with the solo program's
  two-pass statistics, so each scan's masks are ``predict_volume``'s bit for
  bit on the CPU (test_008:191); against the reference's >= 0.999 exact,
  >= 0.99 fast;
- ``predict_cohort_mixed``: ``bucket='exact'`` and ``'pad'`` against the
  reference's (the same bars); 'pad' > 0.99 against 'exact' (test_008:238)
  in one padded program; ``pad_quantum=1`` pad equals exact bit for bit,
  also for negative volumes (test_008:240-255); unsupported modes and
  a ``mesh=`` that is not a mesh raise (the sharded cohorts:
  tests/test_torch_parallel_cohort.py).

Measured agreements are written beside the assertions."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.model_fixtures import build_group_set
from totalsegmentator2d_tpu.inference import EnsembleEngine as JaxEngine
from totalsegmentator2d_tpu.inference import Zoo as JaxZoo
from totalsegmentator2d_tpu_torch.inference import EnsembleEngine, Zoo

KEY = 'ts2d-v9-test'
SPACING = (1.5, 1.5)
MODES = ('max', 'mean')
SHAPES = [(40, 20, 30), (32, 16, 24), (36, 18, 28), (40, 20, 30),
          (32, 16, 24)]


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    """(port specs, params), (reference specs, params)."""
    root = str(tmp_path_factory.mktemp('zoo'))
    build_group_set(root, model=KEY, spacing=SPACING)
    zoo, jzoo = Zoo(local=root), JaxZoo(remote=False, local=root)
    port = [zoo.load(i) for i in zoo.resolve(KEY, unique_model=True)]
    ref = [jzoo.load(i) for i in jzoo.resolve(KEY, unique_model=True)]
    return (([m.spec for m in port], [m.load_fold_params() for m in port]),
            ([m.spec for m in ref], [m.load_fold_params() for m in ref]))


def _same_shape():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((3, 40, 20, 30)) * 100).astype(np.float32)


def _mixed():
    rng = np.random.default_rng(1)
    return [(rng.standard_normal(s) * 100 + 40).astype(np.float32)
            for s in SHAPES]


@pytest.fixture(scope='module')
def reference(models):
    """The reference's cohort masks at both precisions: predict_cohort of
    the same-shape volumes, predict_cohort_mixed exact and pad (q = 64)."""
    specs, params = models[1]
    out = {}
    for precision, dtype in (('exact', None), ('fast', jnp.bfloat16)):
        eng = JaxEngine(specs, params, compute_dtype=dtype)
        out[precision, 'cohort'] = eng.predict_cohort(_same_shape(), SPACING,
                                                      MODES)
        out[precision, 'exact'] = eng.predict_cohort_mixed(_mixed(), SPACING,
                                                           MODES)
        out[precision, 'pad'] = eng.predict_cohort_mixed(
            _mixed(), SPACING, MODES, bucket='pad', pad_quantum=64)
    return out


def _port(models, fast=False, **kw):
    specs, params = models[0]
    return EnsembleEngine(specs, params, device='cpu',
                          compute_dtype=torch.bfloat16 if fast else None, **kw)


def _bar(fast):
    return 0.99 if fast else 0.999


@pytest.mark.parametrize('precision', ['exact', 'fast'])
def test_cohort_matches_reference_and_volume(models, reference, precision):
    """Measured on the CPU: bitwise against predict_volume; against the
    reference 1.0 exact, fast 0.999-1.0."""
    fast = precision == 'fast'
    engine = _port(models, fast)
    vols = _same_shape()
    batch = engine.predict_cohort(vols, SPACING, MODES)
    assert batch.shape == (3, 40, 30, 5)
    for i in range(3):
        single, _ = engine.predict_volume(vols[i], SPACING, MODES)
        np.testing.assert_array_equal(batch[i], single)
    agree = float((batch == reference[precision, 'cohort']).mean())
    assert agree >= _bar(fast), f'mask agreement {agree}'
    assert [k[1] for k in engine._cache if k[0] == 'cohort'] == [vols.shape]


@pytest.mark.parametrize('precision', ['exact', 'fast'])
def test_cohort_mixed_exact_matches_reference(models, reference, precision):
    """Three shapes, three programs; every scan's masks are its solo
    cohort's. Measured on the CPU: 1.0 exact; fast 0.999-1.0."""
    fast = precision == 'fast'
    engine = _port(models, fast)
    vols = _mixed()
    out = engine.predict_cohort_mixed(vols, SPACING, MODES)
    assert len([k for k in engine._cache if k[0] == 'cohort']) == 3
    for v, m, r in zip(vols, out, reference[precision, 'exact']):
        assert m.shape == r.shape == (v.shape[0], v.shape[2], 5)
        np.testing.assert_array_equal(
            m, engine.predict_cohort(v[None], SPACING, MODES)[0])
        assert float((m == r).mean()) >= _bar(fast)


@pytest.mark.parametrize('precision', ['exact', 'fast'])
def test_cohort_mixed_pad_matches_reference_and_exact(models, reference,
                                                      precision):
    """bucket='pad': the five scans of three shapes ride ONE padded program
    of the (64, 64, 64) bucket. Measured on the CPU: against the
    reference's pad mode 1.0 exact, fast 0.999-1.0; against exact mode
    1.0."""
    fast = precision == 'fast'
    engine = _port(models, fast)
    vols = _mixed()
    padded = engine.predict_cohort_mixed(vols, SPACING, MODES, bucket='pad',
                                         pad_quantum=64)
    keys = [k for k in engine._cache if k[0] == 'cohortpad']
    assert len(keys) == 1 and keys[0][1] == (5, 64, 64, 64), keys
    exact = engine.predict_cohort_mixed(vols, SPACING, MODES)
    for v, p, e, r in zip(vols, padded, exact, reference[precision, 'pad']):
        assert p.shape == e.shape == r.shape == (v.shape[0], v.shape[2], 5)
        assert float((p == r).mean()) >= _bar(fast)
        assert float((p == e).mean()) > 0.99


@pytest.mark.parametrize('dtype', [np.float32, np.int16])
def test_pad_quantum_one_equals_exact(models, dtype):
    """Negative-valued volumes: zero padding must not leak into the MIP
    (zero would beat negative HU) or the AIP's denominator. With
    pad_quantum=1 the bucket is each scan's own shape, so pad mode equals
    exact mode bit for bit."""
    rng = np.random.default_rng(2)
    vols = [(rng.standard_normal(s) * 100 - 300).astype(dtype)
            for s in ((40, 20, 30), (32, 16, 24))]
    engine = _port(models)
    padded = engine.predict_cohort_mixed(vols, SPACING, MODES, bucket='pad',
                                         pad_quantum=1)
    exact = engine.predict_cohort_mixed(vols, SPACING, MODES)
    for p, e in zip(padded, exact):
        np.testing.assert_array_equal(p, e)


def test_pad_rejects_unsupported_mode(models):
    vols = [np.random.default_rng(3).standard_normal((16, 8, 8))
            .astype(np.float32)]
    with pytest.raises(ValueError, match="bucket='pad' supports"):
        _port(models).predict_cohort_mixed(vols, SPACING, ('std',),
                                           bucket='pad')
    with pytest.raises(ValueError, match='bucket must be'):
        _port(models).predict_cohort_mixed(vols, SPACING, MODES,
                                           bucket='round')


def test_mesh_raises(models):
    engine = _port(models)
    vols = _same_shape()
    with pytest.raises(TypeError, match='DeviceMesh'):
        engine.predict_cohort(vols, SPACING, MODES, mesh=object())
    with pytest.raises(TypeError, match='DeviceMesh'):
        engine.predict_cohort_mixed(list(vols), SPACING, MODES,
                                    mesh=object(), bucket='pad')


def test_masked_norm_cohort_takes_host_path(models):
    """Masked-norm cohorts run the exact hole-filled host-mask path: each
    scan equals its predict_volume; 'pad' falls back to 'exact'."""
    specs, params = models[0]
    specs = [dataclasses.replace(s, preprocess=dataclasses.replace(
        s.preprocess, use_mask_for_norm=(True, True))) for s in specs]
    engine = EnsembleEngine(specs, params, device='cpu')
    rng = np.random.default_rng(4)
    vols = np.zeros((3, 40, 20, 30), np.float32)
    vols[:, 8:36, 4:16, 6:26] = rng.standard_normal((3, 28, 12, 20)) * 100 + 60
    batch = engine.predict_cohort(vols, SPACING, MODES)
    assert batch.shape == (3, 40, 30, 5)
    for i in range(3):
        np.testing.assert_array_equal(
            batch[i], engine.predict_volume(vols[i], SPACING, MODES)[0])
    padded = engine.predict_cohort_mixed(list(vols), SPACING, MODES,
                                         bucket='pad')
    for p, b in zip(padded, batch):
        np.testing.assert_array_equal(p, b)
    assert not [k for k in engine._cache if k[0] in ('cohort', 'cohortpad')]


def test_cohort_compact_wire_is_bit_identical(models):
    vols = _same_shape()
    comp = _port(models, compact_wire=True)
    plain = _port(models, compact_wire=False)
    np.testing.assert_array_equal(comp.predict_cohort(vols, SPACING, MODES),
                                  plain.predict_cohort(vols, SPACING, MODES))
    mixed = [vols[0], vols[1][:36, :18, :28]]
    for a, b in zip(
            comp.predict_cohort_mixed(mixed, SPACING, MODES, bucket='pad'),
            plain.predict_cohort_mixed(mixed, SPACING, MODES, bucket='pad')):
        np.testing.assert_array_equal(a, b)
