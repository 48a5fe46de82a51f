"""Cohort data parallelism of the port against its unsharded cohort programs
and the reference package's, on gloo ranks of this file (the launcher of
tests/test_torch_parallel.py); the 2-group set at patch 32, volumes
(40, 20, 30) at spacing (1.2, 2.0), so the prefilter and resample run.

- ``predict_cohort(mesh=)`` on 4 ranks, n = 4 and n = 5 (the last scan
  repeats to 8): every rank returns the whole cohort, >= 0.9999 against
  the port's unsharded cohort and >= 0.999 against the reference's
  ``mesh=`` on 4 virtual devices; ``predict_cohort_mixed(mesh,
  bucket='pad', pad_quantum=32)`` runs three shapes through one
  ``cohortpad`` program (``__graft_entry__.py:172-189``) and equals the
  unsharded call >= 0.9999, as ``bucket='exact'`` does; a masked-norm plan
  ignores the mesh, as the reference's warns.
- ``predict_cohort_distributed`` on 2 ranks with shares 3/2 and 5/0,
  ``gather`` on and off, and a masked-norm plan, against the reference's
  one-process ``predict_cohort`` of the whole cohort >= 0.999."""

if __name__ == '__main__':   # a rank process: refuse JAX before anything
    from tests.test_torch_parallel import install_blocker
    install_blocker()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from tests.test_torch_parallel import (engine_inputs, jax_engine,  # noqa: E402
                                       jax_mesh, launch, port_engine,
                                       rank_main)

SPACING = (1.2, 2.0)
MODES = ('max', 'mean')
MIXED = ((20, 12, 16), (18, 10, 14), (16, 12, 12), (20, 12, 16),
         (18, 10, 14))


def _vols(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 40, 20, 30)) * 100 + 40).astype(
        np.float32)


def _mixed():
    rng = np.random.default_rng(1)
    return [(rng.standard_normal(s) * 100 + 40).astype(np.float32)
            for s in MIXED]


def _masked(inputs):
    import copy
    out = copy.deepcopy(inputs)
    out['plans']['configurations']['2d']['use_mask_for_norm'] = [True, True]
    return out


# -- rank cases ------------------------------------------------------------------

def _case_cohort(rank, world, inputs):
    from totalsegmentator2d_tpu_torch.parallel import make_mesh
    mesh = make_mesh({'data': world}, device='cpu')
    engine = port_engine(inputs)
    out = {n: engine.predict_cohort(_vols(n), SPACING, MODES, mesh=mesh)
           for n in (4, 5)}
    out['pad'] = engine.predict_cohort_mixed(_mixed(), (1.5, 1.5), MODES,
                                             mesh=mesh, bucket='pad',
                                             pad_quantum=32)
    out['pad_programs'] = [k[1] for k in engine._cache if k[0] == 'cohortpad']
    out['exact'] = engine.predict_cohort_mixed(_mixed(), (1.5, 1.5), MODES,
                                               mesh=mesh)
    masked = port_engine(_masked(inputs))
    out['masked'] = masked.predict_cohort(_vols(3), SPACING, MODES, mesh=mesh)
    return out


def _case_dist(rank, world, inputs):
    from totalsegmentator2d_tpu_torch.parallel import (
        make_mesh, predict_cohort_distributed)
    mesh = make_mesh({'data': world}, device='cpu')
    vols = _vols(5)
    out = {}
    for name, eng in (('plain', port_engine(inputs)),
                      ('masked', port_engine(_masked(inputs)))):
        for split in (3, 5):
            mine = vols[:split] if rank == 0 else vols[split:]
            for gather in (True, False):
                out[name, split, gather] = predict_cohort_distributed(
                    eng, mine, SPACING, MODES, mesh=mesh, gather=gather)
    return out


CASES = {'cohort': _case_cohort, 'dist': _case_dist}

if __name__ == '__main__':
    rank_main(CASES)


# -- the tests ------------------------------------------------------------------

@pytest.fixture(scope='module')
def inputs():
    return engine_inputs()


def _agree(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return float((a == b).mean())


def test_cohort_data_parallel_on_4_ranks(tmp_path, inputs):
    results = launch(__file__, 'cohort', 4, tmp_path, inputs)
    solo, ref = port_engine(inputs), jax_engine(inputs)
    mesh = jax_mesh({'data': 4})
    for n in (4, 5):
        plain = solo.predict_cohort(_vols(n), SPACING, MODES)
        jref = np.asarray(ref.predict_cohort(_vols(n), SPACING, MODES,
                                             mesh=mesh))
        for res in results:
            np.testing.assert_array_equal(res[n], results[0][n])
        assert _agree(results[0][n], plain) >= 0.9999, n
        assert _agree(results[0][n], jref) >= 0.999, n
    assert len(results[0]['pad_programs']) == 1, results[0]['pad_programs']
    for bucket in ('pad', 'exact'):
        plain = solo.predict_cohort_mixed(_mixed(), (1.5, 1.5), MODES,
                                          bucket=bucket, pad_quantum=32)
        for got, want, v in zip(results[0][bucket], plain, _mixed()):
            assert got.shape == (v.shape[0], v.shape[2], 7)
            assert _agree(got, want) >= 0.9999, bucket
    masked = port_engine(_masked(inputs)).predict_cohort(_vols(3), SPACING,
                                                         MODES)
    np.testing.assert_array_equal(results[0]['masked'], masked)


def test_predict_cohort_distributed_on_2_ranks(tmp_path, inputs):
    results = launch(__file__, 'dist', 2, tmp_path, inputs)
    vols = _vols(5)
    for name, inp in (('plain', inputs), ('masked', _masked(inputs))):
        whole = np.asarray(jax_engine(inp).predict_cohort(vols, SPACING,
                                                          MODES))
        for split in (3, 5):
            for r, res in enumerate(results):
                assert _agree(res[name, split, True], whole) >= 0.999
                mine = whole[:split] if r == 0 else whole[split:]
                local = res[name, split, False]
                assert local.shape == mine.shape, (name, split, r)
                if len(mine):
                    assert _agree(local, mine) >= 0.999, (name, split, r)
