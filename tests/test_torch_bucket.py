"""The PyTorch port's quantized-shape bucket program (``pad_quantum``)
against the reference package's, on the CPU: the two-group synthetic
database of tests/test_008_ensemble_engine.py's cases (patch 64, plan
spacing 1.5 mm), the same seeded inputs.

- the port's bucket program against the reference's bucket program: masks
  agree >= 0.999 exact, >= 0.99 fast (the bars of tests/test_torch_engine.py);
- the port's bucket program against the port's exact program, at the
  reference's own bars (tests/test_008_ensemble_engine.py:742,756): > 0.999
  at plan spacing, > 0.995 when both axes resample (the bucket program's
  float32 geometry and its unclipped up-resample rows at the scan's edge);
- the cases of the reference's TestPadQuantumServing; the geometry helpers
  against ``tile_positions`` / ``axis_weights`` and against a jnp
  transcription of the reference's traced helpers; the compact wire bit
  for bit; the per-scan tile grids of ``accumulate_tiles``.

The reference engines' results are computed once per module. Measured
agreements are written beside the assertions."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.model_fixtures import build_group_set
from totalsegmentator2d_tpu.inference import EnsembleEngine as JaxEngine
from totalsegmentator2d_tpu.inference import Zoo as JaxZoo
from totalsegmentator2d_tpu_torch.inference import EnsembleEngine, Zoo
from totalsegmentator2d_tpu_torch.inference import bucket as B
from totalsegmentator2d_tpu_torch.inference.tiling import (accumulate_tiles,
                                                           compute_steps_1d)
from totalsegmentator2d_tpu_torch.ops.resample import axis_weights

KEY = 'ts2d-v9-test'
PLAN = (1.5, 1.5)
RESAMPLED = (1.0, 2.0)  # y up-, x down-sampled
Q = 32


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    """(port specs, params), (reference specs, params)."""
    root = str(tmp_path_factory.mktemp('zoo'))
    build_group_set(root, model=KEY, spacing=PLAN)
    zoo, jzoo = Zoo(local=root), JaxZoo(remote=False, local=root)
    port = [zoo.load(i) for i in zoo.resolve(KEY, unique_model=True)]
    ref = [jzoo.load(i) for i in jzoo.resolve(KEY, unique_model=True)]
    return (([m.spec for m in port], [m.load_fold_params() for m in port]),
            ([m.spec for m in ref], [m.load_fold_params() for m in ref]))


def _arr(seed, shape, scale=1.0, offset=2.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape + (2,)) * scale + offset).astype(np.float32)


def _masked_input():
    a = np.zeros((80, 70, 2), np.float32)
    a[8:72, 6:64] = _arr(5, (64, 58), offset=3.0)
    return a


CT_PROPS = {'mean': 100.0, 'std': 50.0, 'percentile_00_5': -200.0,
            'percentile_99_5': 400.0}


def _variant(specs, variant):
    """The specs of a plan variant: 'plain', 'masked' (use_mask_for_norm)
    or 'ct' (CTNormalization)."""
    if variant == 'masked':
        return [dataclasses.replace(s, preprocess=dataclasses.replace(
            s.preprocess, use_mask_for_norm=(True, True))) for s in specs]
    if variant == 'ct':
        return [dataclasses.replace(s, preprocess=dataclasses.replace(
            s.preprocess, normalization_schemes=('CTNormalization',) * 2,
            intensity_properties=(CT_PROPS, CT_PROPS))) for s in specs]
    return specs


# (name, input, spacing, plan variant): the reference's TestPadQuantumServing
CASES = [
    ('70x60', lambda: _arr(0, (70, 60)), PLAN, 'plain'),
    ('90x50', lambda: _arr(1, (90, 50)), PLAN, 'plain'),
    ('resampled', lambda: _arr(2, (70, 60)), RESAMPLED, 'plain'),
    ('masked-norm', _masked_input, PLAN, 'masked'),
    ('ct-norm', lambda: _arr(3, (70, 60), 100.0, 80.0), PLAN, 'ct'),
    ('bucket-sized', lambda: _arr(4, (96, 64)), PLAN, 'plain'),
    ('below-patch', lambda: _arr(6, (40, 30)), PLAN, 'plain'),
]


@pytest.fixture(scope='module')
def reference(models):
    """The reference's bucket masks of every case at both precisions."""
    specs, params = models[1]
    out = {}
    for precision, dtype in (('exact', None), ('fast', jnp.bfloat16)):
        engines = {}
        for name, make, spacing, variant in CASES:
            if variant not in engines:
                engines[variant] = JaxEngine(_variant(specs, variant), params,
                                             pad_quantum=Q,
                                             compute_dtype=dtype)
            out[precision, name] = engines[variant].predict_array(make(),
                                                                  spacing)
    return out


def _port(models, variant='plain', fast=False, **kw):
    specs, params = models[0]
    return EnsembleEngine(_variant(specs, variant), params, device='cpu',
                          compute_dtype=torch.bfloat16 if fast else None, **kw)


@pytest.mark.parametrize('precision', ['exact', 'fast'])
@pytest.mark.parametrize('case', [c[0] for c in CASES])
def test_bucket_matches_reference_bucket(models, reference, case, precision):
    """Measured on the CPU: 1.0 at 'exact' for every case; 'fast'
    0.998-1.0."""
    name, make, spacing, variant = next(c for c in CASES if c[0] == case)
    fast = precision == 'fast'
    arr = make()
    out = _port(models, variant, fast, pad_quantum=Q).predict_array(arr,
                                                                     spacing)
    ref = reference[precision, name]
    assert out.shape == ref.shape == arr.shape[:2] + (5,)
    agree = float((out == ref).mean())
    assert agree >= (0.99 if fast else 0.999), f'mask agreement {agree}'
    assert 0.0 < out.mean() < 1.0


@pytest.mark.parametrize('case', [c[0] for c in CASES])
def test_bucket_matches_exact_program(models, case):
    """The reference's bars of its own bucket program against its exact
    one. Measured on the CPU: 1.0 at plan spacing, 0.999286 resampled."""
    name, make, spacing, variant = next(c for c in CASES if c[0] == case)
    arr = make()
    out = _port(models, variant, pad_quantum=Q).predict_array(arr, spacing)
    ref = _port(models, variant).predict_array(arr, spacing)
    assert out.shape == ref.shape
    agree = float((out == ref).mean())
    assert agree > (0.995 if spacing != PLAN else 0.999), \
        f'mask agreement {agree}'


def test_shapes_share_one_program(models):
    """70x60 and 90x50 both ride the (96, 64) bucket: one program."""
    engine = _port(models, pad_quantum=Q)
    for seed, shape in ((0, (70, 60)), (1, (90, 50))):
        out = engine.predict_array(_arr(seed, shape), PLAN)
        assert out.shape == shape + (5,)
    keys = [k for k in engine._cache if k[0] == 'bucket']
    assert len(keys) == 1 and keys[0][1] == (96, 64), keys


def test_bucket_program_is_bitwise_repeatable_and_one_pass(models,
                                                           monkeypatch):
    """Two runs give the same masks bit for bit; the program takes one-pass
    InstanceNorm statistics, as the reference's bucket program does."""
    import totalsegmentator2d_tpu_torch.models.unet as unet
    monkeypatch.delenv('TS2D_STATS', raising=False)
    calls, orig = [], unet._one_pass_stats

    def spy():
        calls.append(orig())
        return calls[-1]

    monkeypatch.setattr(unet, '_one_pass_stats', spy)
    engine = _port(models, pad_quantum=Q)
    arr = _arr(2, (70, 60))
    a = engine.predict_array(arr, RESAMPLED)
    assert calls and all(calls)
    np.testing.assert_array_equal(engine.predict_array(arr, RESAMPLED), a)


def test_warmup_warms_the_bucket(models):
    engine = _port(models, pad_quantum=Q, auto_batch=2)
    try:
        engine.warmup((70, 60), PLAN)
        keys = [k for k in engine._cache if k[0] == 'bucket']
        assert keys and keys[0][1] == (96, 64)
        bkeys = [k for k in engine._cache if k[0] == 'batch']
        assert bkeys and bkeys[0][2] == (96, 64) and bkeys[0][-1] is True
    finally:
        engine.close()


def test_invalid_quantum_rejected(models):
    with pytest.raises(ValueError, match='pad_quantum'):
        _port(models, pad_quantum=0)


@pytest.mark.parametrize('precision', ['exact', 'fast'])
def test_different_sizes_cobatch(models, precision):
    """A 70x60 and a 90x50 scan queued together ride ONE batched bucket
    program (the exact programs would need two), each with its own tile
    grid; against the reference's batched bucket program. Measured on the
    CPU: 1.0 exact; fast 0.999-1.0."""
    fast = precision == 'fast'
    specs, params = models[1]
    arrs = [_arr(0, (70, 60)), _arr(1, (90, 50))]
    outs = {}
    ref = JaxEngine(specs, params, pad_quantum=Q, auto_batch=4,
                    compute_dtype=jnp.bfloat16 if fast else None)
    port = _port(models, fast=fast, pad_quantum=Q, auto_batch=4)
    try:
        for name, eng in (('ref', ref), ('port', port)):
            eng._batcher.ramp_solos = 0
            eng._batcher.min_fill = 2
            with eng._batcher._cv:  # queue both before the dispatcher runs
                handles = [eng.predict_array_async(a, RESAMPLED)
                           for a in arrs]
            outs[name] = [eng.finish_array(h) for h in handles]
            assert eng._batcher.stats()['batch_scans_coalesced'] == 2
    finally:
        ref.close()
        port.close()
    solo = _port(models, fast=fast, pad_quantum=Q)
    for a, out, r in zip(arrs, outs['port'], outs['ref']):
        assert out.shape == r.shape == a.shape[:2] + (5,)
        bar = 0.99 if fast else 0.999
        assert float((out == r).mean()) >= bar
        assert float((out == solo.predict_array(a, RESAMPLED)).mean()) >= bar


def test_compact_wire_is_bit_identical_on_a_bucket(models):
    arr = np.zeros((70, 60, 2), np.float32)
    arr[5:62, 4:55] = _arr(7, (57, 51), offset=0.0)
    plain = _port(models, pad_quantum=Q, compact_wire=False)
    comp = _port(models, pad_quantum=Q, compact_wire=True)
    for spacing in (PLAN, RESAMPLED):
        np.testing.assert_array_equal(comp.predict_array(arr, spacing),
                                      plain.predict_array(arr, spacing))


# -- the geometry helpers --------------------------------------------------

def _ref_steps(size, n_static, p, t):
    """The reference's traced compute_steps_1d (ensemble_engine.py:785-797
    there), transcribed to run here."""
    num = jnp.where(size == p, 1, jnp.ceil(
        (size - p).astype(jnp.float32) / t).astype(jnp.int32) + 1)
    actual = ((size - p).astype(jnp.float32)
              / jnp.maximum(num - 1, 1).astype(jnp.float32))
    k = jnp.arange(n_static)
    pos = jnp.round(actual * k.astype(jnp.float32)).astype(jnp.int32)
    valid = k < num
    return jnp.where(valid, pos, 0), valid


def test_steps_match_the_reference_and_tile_positions():
    """The float32 tile origins equal the reference's traced ones at every
    size, and nnU-Net's (float64) ones up to 2000 pixels; beyond, float32
    rounding moves an origin by one at a few sizes (p = 192: 2211, ...),
    in both packages."""
    n_static = 64
    for p in (64, 192, 256):
        sizes = np.array(list(range(p, 2000)) + [2211, 2790, 2858])
        ref = jax.jit(jax.vmap(lambda s: _ref_steps(s, n_static, p, p * 0.5)))
        rpos, rvalid = (np.asarray(a) for a in ref(jnp.asarray(sizes,
                                                                jnp.int32)))
        for i, size in enumerate(sizes):
            pos, valid = B._steps(int(size), n_static, p, p * 0.5)
            np.testing.assert_array_equal(pos, rpos[i])
            np.testing.assert_array_equal(valid, rvalid[i])
            if size < 2000:
                assert list(pos[valid]) == compute_steps_1d(int(size), p, 0.5)


@pytest.mark.parametrize('h', [2, 3, 5, 9, 16, 45, 70, 299, 512])
@pytest.mark.parametrize('ratio', [0.52, 1.0 / 1.5, 1.25, 2.0])
def test_resample_matrices_match_axis_weights(h, ratio):
    """Rows [pb, pb + rs) of the down matrix are axis_weights' order-3
    'edge' rows, of the up matrix its order-1 rows at unclipped
    coordinates ('zero'); zero elsewhere. The tolerance is 1e-6 plus the
    float32 coordinates' rounding, h * 2^-23 (0.62e-6 at h = 5)."""
    rs = int(np.rint(np.float32(h) * np.float32(ratio)))
    pb, extra = 3, 4
    atol = 1e-6 + h * 2.0 ** -23
    down = B._down_matrix(h + 5, rs + pb + extra, h, rs, pb)
    coords = (np.arange(rs) + 0.5) * (h / rs) - 0.5
    np.testing.assert_allclose(down[pb:pb + rs, :h],
                               axis_weights(h, coords, 3, outside='edge'),
                               rtol=0, atol=atol)
    assert not down[:pb].any() and not down[pb + rs:].any()
    assert not down[:, h:].any()
    up = B._up_matrix(h + 5, rs + pb + extra, h, rs, pb)
    coords = (np.arange(h) + 0.5) * (rs / h) - 0.5
    np.testing.assert_allclose(up[:h, pb:pb + rs],
                               axis_weights(rs, coords, 1, outside='zero'),
                               rtol=0, atol=atol)
    assert not up[h:].any()
    assert not up[:, :pb].any() and not up[:, pb + rs:].any()


def test_scan_extent():
    m = np.zeros((96, 64), bool)
    m[:70, :60] = True
    m[69, 0] = m[0, 59] = True
    assert B.scan_extent(m) == (70, 60)
    m[:] = False
    m[:10, :5] = True
    m[4, :] = False  # a hole does not shorten the extent
    assert B.scan_extent(m) == (10, 5)
    assert B.scan_extent(np.zeros((32, 32), bool)) == (32, 32)


# -- accumulate_tiles: per-scan grids and validity --------------------------

def test_accumulate_tiles_per_scan_grids():
    """A batch whose scans have their own tile grids and weight maps, one
    padded with a tile of validity 0, gives each scan's solo sums bit for
    bit; a zero-validity tile adds nothing."""
    rng = np.random.default_rng(0)
    work = torch.from_numpy(rng.standard_normal((2, 3, 20, 24))
                            .astype(np.float32))
    patch, mirrors = (8, 8), [(), (0,), (1,), (0, 1)]
    gauss = torch.from_numpy(rng.random((8, 8)).astype(np.float32))

    def net(batch):  # (n, C, ph, pw) -> (2, n, L=2, ph, pw)
        return torch.stack([batch[:, :2] * 2.0, batch[:, 1:] - 1.0])

    grids = [np.array([[0, 0], [4, 10], [12, 16]]),
             np.array([[2, 3], [5, 7], [0, 0]])]
    valid = torch.tensor([[1.0, 1.0, 1.0], [1.0, 1.0, 0.0]])
    acc = torch.zeros((2, 2, 2, 20, 24))
    wacc = torch.zeros((2, 1, 20, 24))
    accumulate_tiles(work, np.stack(grids), net, acc, wacc, patch, mirrors,
                     gauss, chunk_cap=8, valid=valid)
    for s, n in ((0, 3), (1, 2)):
        a = torch.zeros((2, 2, 20, 24))
        w = torch.zeros((1, 20, 24))
        accumulate_tiles(work[s], grids[s][:n], net, a, w, patch, mirrors,
                         gauss, chunk_cap=8)
        assert torch.equal(acc[:, s], a) and torch.equal(wacc[s], w)
