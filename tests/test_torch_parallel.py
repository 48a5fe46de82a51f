"""The port's parallel/ layer against the reference package's.

Pure helpers in this process: the exported names, ``auto_axes`` (n =
1..16), ``process_shard`` (test_022's cases), ``param_spec``'s
shard-or-replicate decision per leaf of the flagship spec at model = 2 and
4, ``stack_groups``, ``pad_head``, ``split_group_outputs`` and
``merge_multilabel``: equal to the reference's; the refusals.

Multi-rank cases run as processes of this file on the CPU with gloo
(:func:`launch`; the ranks refuse jax and the reference package, as
tests/test_torch_isolation.py's child does): the DTensor plumbing, the
sharded ensemble forward (against the reference's ``ensemble_forward``,
test_007's bar), ``shard_params`` and ``batch_sharding`` on 4 ranks; the
tile-sharded scan at test_023's shape (70, 60), patch 32, 2 groups, on 2
and 4 ranks, >= 0.9999 against the port's solo program (the reference's
bar, test_023:132-139) and >= 0.999 against the reference's ``tile_mesh``
engine on as many virtual devices, every rank the same masks, ceil(T/D)
tiles per rank; the errors of a mesh that does not span the world or lacks
the tile axis; the ``dryrun_multichip`` analogue on 8 ranks (its six OK
lines).

Files test_torch_parallel_cohort.py, test_torch_parallel_train.py and
test_torch_parallel_spatial.py use :func:`launch` and :func:`rank_main` of
this one; the reference package is
imported inside fixtures only, since every file here is also a rank's
script."""

import sys

# what a rank refuses to import: tests/test_torch_isolation.py's list
_REFUSED = ('jax', 'jaxlib', 'totalsegmentator2d_tpu', 'requests', 'PIL',
            'optax', 'orbax')


class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in _REFUSED:
            raise ImportError(f'blocked import: {name}')
        return None


def install_blocker() -> None:
    sys.meta_path.insert(0, _Blocker())


if __name__ == '__main__':   # a rank process (see launch)
    install_blocker()

import os  # noqa: E402
import pickle  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 120   # seconds a rank may run before it is killed


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def launch(script: str, case: str, world: int, tmp, inputs=None,
           timeout: int = RANK_TIMEOUT) -> list:
    """Run ``case`` of ``script`` on ``world`` gloo ranks (processes of the
    script, one thread each) and return every rank's result. A rank that
    fails, or any rank still running after ``timeout`` s, fails the test
    (all of them are killed)."""
    out = os.path.join(str(tmp), f'{case}-{world}')
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, 'inputs.pkl'), 'wb') as f:
        pickle.dump(inputs, f)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, script, case, str(r), str(world), str(port), out],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(
                errors='replace'))
    except subprocess.TimeoutExpired:
        pytest.fail(f'{case} on {world} ranks: a rank ran over {timeout} s')
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f'rank {r} of {case} failed:\n{log[-4000:]}'
    results = []
    for r in range(world):
        with open(os.path.join(out, f'rank{r}.pkl'), 'rb') as f:
            results.append(pickle.load(f))
    return results


def rank_main(cases: dict) -> None:
    """A rank's side of :func:`launch`: join the gloo world on the CPU (or,
    for a case marked ``own_world``, set torchrun's env for the case to
    join it), run the case, write its result, leave the world."""
    import faulthandler

    import torch
    faulthandler.dump_traceback_later(RANK_TIMEOUT, exit=True)
    torch.set_num_threads(1)
    case, rank, world, port, out = sys.argv[1:6]
    import torch.distributed as dist

    from totalsegmentator2d_tpu_torch.parallel import init_distributed
    fn = cases[case]
    if getattr(fn, 'own_world', False):
        os.environ.update(RANK=rank, LOCAL_RANK=rank, WORLD_SIZE=world,
                          MASTER_ADDR='localhost', MASTER_PORT=port)
    else:
        init_distributed(f'localhost:{port}', int(world), int(rank),
                         device='cpu')
    with open(os.path.join(out, 'inputs.pkl'), 'rb') as f:
        inputs = pickle.load(f)
    result = fn(int(rank), int(world), inputs)
    with open(os.path.join(out, f'rank{rank}.pkl'), 'wb') as f:
        pickle.dump(result, f)
    if dist.is_initialized():   # an own_world case may have left it
        dist.barrier()
        dist.destroy_process_group()
    leaked = [m for m in sys.modules if m.split('.')[0] in _REFUSED]
    assert not leaked, leaked


# -- the engines both sides build ---------------------------------------------

LABELS = (('heart', 'aorta', 'vein'), ('r1', 'r2', 'r3', 'r4'))
SHAPE = (70, 60)   # 12 tiles at patch 32, step 0.5


def engine_inputs(patch=(32, 32), spacing=(1.5, 1.5)):
    """Plans and dataset.json of the 2-group set, plain dicts (a rank builds
    the port's specs from them; the weights come from init_params_np)."""
    from tests.model_fixtures import make_dataset_json, make_plans
    return {'plans': make_plans(patch=patch, spacing=spacing),
            'ds': [make_dataset_json(labels) for labels in LABELS]}


def port_engine(inputs, **kw):
    from totalsegmentator2d_tpu_torch.inference import EnsembleEngine
    from totalsegmentator2d_tpu_torch.models.convert import params_from_jax
    from totalsegmentator2d_tpu_torch.models.plans import parse_model_spec
    from totalsegmentator2d_tpu_torch.models.unet import init_params_np
    specs = [parse_model_spec(inputs['plans'], ds) for ds in inputs['ds']]
    params = [[params_from_jax(init_params_np(i, s.arch))]
              for i, s in enumerate(specs)]
    return EnsembleEngine(specs, params, device='cpu', **kw)


def jax_engine(inputs, **kw):
    from totalsegmentator2d_tpu.inference import EnsembleEngine
    from totalsegmentator2d_tpu.models.plans import parse_model_spec
    from totalsegmentator2d_tpu.models.unet import init_params_np
    specs = [parse_model_spec(inputs['plans'], ds) for ds in inputs['ds']]
    params = [[init_params_np(i, s.arch)] for i, s in enumerate(specs)]
    return EnsembleEngine(specs, params, **kw)


def jax_mesh(axes):
    import jax

    from totalsegmentator2d_tpu.parallel import make_mesh
    n = int(np.prod(list(axes.values())))
    return make_mesh(axes, devices=jax.devices()[:n])


def scan_array(seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(SHAPE + (2,)) + 2).astype(np.float32)


# -- rank cases ------------------------------------------------------------------

def _case_tile(rank, world, inputs):
    from totalsegmentator2d_tpu_torch.inference.program import _mirror_combos
    from totalsegmentator2d_tpu_torch.parallel import make_mesh
    for bad in ({'data': world * 2}, {'data': 1}):
        try:
            make_mesh(bad, device='cpu')
        except ValueError as e:
            assert 'Mesh needs' in str(e), e
        else:
            raise AssertionError(f'make_mesh({bad}) on {world} ranks')
    mesh = make_mesh({'data': world}, device='cpu')
    try:
        port_engine(inputs, tile_mesh=mesh, tile_axis='model')
    except ValueError as e:
        assert "no axis 'model'" in str(e), e
    else:
        raise AssertionError('a tile_axis the mesh lacks')
    engine = port_engine(inputs, tile_mesh=mesh, tile_axis='data')
    sizes = []
    net = engine._net
    engine._net = lambda b: (sizes.append(b.shape[0]), net(b))[1]
    out = {}
    for spacing in ((1.5, 1.5), (1.2, 2.0)):
        sizes.clear()
        out[spacing] = engine.predict_array(scan_array(), spacing)
        out[spacing, 'tiles'] = sum(sizes) // len(
            _mirror_combos(engine.spec.allowed_mirroring_axes))
    return out


def _small_forward():
    """(arch kwargs, forward_fn(state dict, NHWC x)) of test_007's small
    spec with 4 labels."""
    import torch

    from totalsegmentator2d_tpu_torch.models.plans import ArchSpec
    from totalsegmentator2d_tpu_torch.models.unet import UNet
    arch = dict(n_stages=3, features_per_stage=(8, 16, 16),
                kernel_sizes=((3, 3),) * 3, strides=((1, 1), (2, 2), (2, 2)),
                n_conv_per_stage=(2, 2, 2), n_conv_per_stage_decoder=(2, 2),
                in_channels=2, out_channels=4)
    model = UNet(ArchSpec(**arch))

    def forward(sd, x):
        with torch.no_grad():
            return torch.func.functional_call(model, sd, (x,))

    return arch, forward


def _case_helpers(rank, world, inputs):
    """On {'ensemble': 2, 'data': 2}: the DTensor plumbing, the sharded
    ensemble forward, shard_params and batch_sharding."""
    import torch

    from totalsegmentator2d_tpu_torch.models.convert import params_from_jax
    from totalsegmentator2d_tpu_torch.models.plans import ArchSpec
    from totalsegmentator2d_tpu_torch.models.unet import init_params_np
    from totalsegmentator2d_tpu_torch.parallel import (
        batch_sharding, distribute_batch, ensemble_forward_sharded,
        local_shard, make_mesh, replicate, shard_params, stack_groups)
    mesh = make_mesh({'ensemble': 2, 'data': 2}, device='cpu')
    e, d = mesh.get_coordinate()
    mine = np.full((2, 3), rank, np.float32)
    glob = distribute_batch({'x': mine}, mesh)['x']
    rep = replicate(np.arange(6, dtype=np.float32).reshape(2, 3), mesh)
    arch, forward = _small_forward()
    stacked, _ = stack_groups(
        [params_from_jax(init_params_np(g, ArchSpec(**arch))) for g in (0, 1)],
        [4, 4])
    x = torch.from_numpy(inputs['x'])
    local = shard_params(stacked, mesh, model_axis=None,
                         ensemble_axis='ensemble', stacked=True)
    take = batch_sharding(mesh, 'data', ensemble_axis='ensemble',
                          stacked=True)
    return {'global_shape': tuple(glob.shape),
            'full': glob.full_tensor().numpy(),
            'local': local_shard(glob, mesh),
            'replicated': rep.full_tensor().numpy(),
            'logits': ensemble_forward_sharded(forward, stacked, x, mesh)
            .numpy(),
            'local_stack': {k: tuple(v.shape) for k, v in local.items()},
            'rows': take(np.arange(2 * 4).reshape(2, 4, 1)),
            'coord': (e, d)}


def _case_dryrun(rank, world, inputs):
    import contextlib
    import io

    from totalsegmentator2d_tpu_torch.parallel.dryrun import dryrun_multichip
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip(world, device='cpu')
    return buf.getvalue()


CASES = {'tile': _case_tile, 'helpers': _case_helpers,
         'dryrun': _case_dryrun}

if __name__ == '__main__':
    rank_main(CASES)


# -- the tests ------------------------------------------------------------------

def test_auto_axes_and_process_shard_match_reference():
    from totalsegmentator2d_tpu.parallel import auto_axes as jax_auto
    from totalsegmentator2d_tpu.parallel.distributed import \
        process_shard as jax_shard
    from totalsegmentator2d_tpu_torch.parallel import auto_axes, process_shard
    for n in range(1, 17):
        for ens in (True, False):
            assert auto_axes(n, ens) == jax_auto(n, ens)
    for n, nproc in [(7, 2), (8, 2), (3, 4), (0, 2), (10, 3)]:
        for p in range(nproc):
            assert process_shard(n, nproc, p) == jax_shard(n, nproc, p)
    assert process_shard(5) == slice(0, 5)   # no world: one process


def test_exports_match_reference():
    import totalsegmentator2d_tpu.parallel as J
    import totalsegmentator2d_tpu_torch.parallel as P
    assert P.__all__ == J.__all__
    assert all(callable(getattr(P, name)) for name in P.__all__)
    assert not P.is_distributed()   # no world in this process


@pytest.mark.parametrize('model', [2, 4])
def test_param_spec_decisions_match_reference(model):
    """Per leaf of the flagship spec (features 32..512, a 3-label head that
    does not divide), whether it shards over the model axis."""
    from totalsegmentator2d_tpu.models.convert import params_to_state_dict
    from totalsegmentator2d_tpu.models.plans import ArchSpec as JaxArch
    from totalsegmentator2d_tpu.models.unet import init_params_np as jax_init
    from totalsegmentator2d_tpu.parallel.sharding import param_spec as jax_spec
    from totalsegmentator2d_tpu_torch.models.plans import ArchSpec
    from totalsegmentator2d_tpu_torch.models.unet import UNet
    from totalsegmentator2d_tpu_torch.parallel import param_shardings
    arch = dict(n_stages=6, features_per_stage=(32, 64, 128, 256, 512, 512),
                kernel_sizes=((3, 3),) * 6,
                strides=((1, 1),) + ((2, 2),) * 5,
                n_conv_per_stage=(2,) * 6, n_conv_per_stage_decoder=(2,) * 5,
                in_channels=2, out_channels=3)
    jp = jax_init(0, JaxArch(**arch))
    mesh = jax_mesh({'model': model})
    flat, _ = __import__('jax').tree_util.tree_flatten_with_path(jp)
    jax_dec = {}
    for path, leaf in flat:
        spec = jax_spec(leaf.shape, mesh, 'model')
        jax_dec[tuple(str(getattr(k, 'key', getattr(k, 'idx', k)))
                      for k in path)] = 'model' in tuple(spec)
    sd = UNet(ArchSpec(**arch)).state_dict()
    ours = param_shardings(sd, {'model': model})
    # the converter's names: the reference's leaf path -> the state dict key
    ref_sd = params_to_state_dict(jp, JaxArch(**arch))
    assert sorted(ref_sd) == sorted(sd)
    got = {k: 'model' in v for k, v in ours.items()}
    assert sum(got.values()) == sum(jax_dec.values()) > 0
    assert not got['decoder.seg_layers.4.weight']
    assert got['decoder.transpconvs.0.weight'] and \
        ours['decoder.transpconvs.0.weight'][1] == 'model'
    for k, v in sd.items():   # the channel counts decide, as there
        ch = v.shape[1] if k.startswith('decoder.transpconvs.') and \
            k.endswith('weight') else v.shape[0]
        assert got[k] == (ch % model == 0), k


def test_ensemble_helpers_match_reference():
    import jax.numpy as jnp
    import torch

    from totalsegmentator2d_tpu.models.convert import params_to_state_dict
    from totalsegmentator2d_tpu.models.plans import ArchSpec as JaxArch
    from totalsegmentator2d_tpu.models.unet import init_params_np as jax_init
    from totalsegmentator2d_tpu.parallel import ensemble as JE
    from totalsegmentator2d_tpu_torch.models.convert import params_from_jax
    from totalsegmentator2d_tpu_torch.parallel import (merge_multilabel,
                                                       pad_head,
                                                       split_group_outputs,
                                                       stack_groups)
    counts = [2, 3, 5]
    base = dict(n_stages=3, features_per_stage=(8, 16, 16),
                kernel_sizes=((3, 3),) * 3, strides=((1, 1), (2, 2), (2, 2)),
                n_conv_per_stage=(2, 2, 2), n_conv_per_stage_decoder=(2, 2),
                in_channels=2)
    jps = [jax_init(i, JaxArch(out_channels=c, **base))
           for i, c in enumerate(counts)]
    stacked, max_l = stack_groups([params_from_jax(p) for p in jps], counts)
    jstacked, jmax = JE.stack_groups(jps, counts)
    assert max_l == jmax == 5
    ref = params_to_state_dict(__import__('jax').tree_util.tree_map(
        lambda a: np.asarray(a[2]), jstacked), JaxArch(out_channels=5, **base))
    for k, v in ref.items():
        np.testing.assert_array_equal(stacked[k][2].numpy(), v)
    padded = pad_head(params_from_jax(jps[0]), 2, 5)
    jpad = params_to_state_dict(JE.pad_head(jps[0], 2, 5),
                                JaxArch(out_channels=5, **base))
    for k, v in jpad.items():
        np.testing.assert_array_equal(padded[k].numpy(), v)
    logits = np.random.default_rng(0).standard_normal(
        (3, 2, 4, 4, 5)).astype(np.float32)
    for a, b in zip(split_group_outputs(torch.from_numpy(logits), counts),
                    JE.split_group_outputs(jnp.asarray(logits), counts)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for thr in (True, False):
        np.testing.assert_array_equal(
            merge_multilabel(torch.from_numpy(logits), counts, thr).numpy(),
            np.asarray(JE.merge_multilabel(jnp.asarray(logits), counts, thr)))


def test_refusals():
    """spatial=True over a mesh with a 'model' axis and no 'data' axis
    raises ValueError, as the reference's batch sharding does (a world-1
    gloo group in this process); tile_mesh with auto_batch raises as the
    reference's does; a mesh needs an initialized world."""
    import torch.distributed as dist

    from totalsegmentator2d_tpu_torch.models.plans import ArchSpec
    from totalsegmentator2d_tpu_torch.parallel import (init_distributed,
                                                       make_mesh)
    from totalsegmentator2d_tpu_torch.training import TrainConfig, Trainer
    spec = ArchSpec(n_stages=2, features_per_stage=(4, 8),
                    kernel_sizes=((3, 3),) * 2, strides=((1, 1), (2, 2)),
                    n_conv_per_stage=(1, 1), n_conv_per_stage_decoder=(1,),
                    in_channels=1, out_channels=2)
    with pytest.raises(ValueError, match='auto_batch cannot be combined'):
        port_engine(engine_inputs(), auto_batch=4, tile_mesh=object())
    with pytest.raises(RuntimeError, match='initialized torch.distributed'):
        make_mesh({'data': 1}, device='cpu')
    init_distributed(f'localhost:{_free_port()}', 1, 0, device='cpu')
    try:
        with pytest.raises(ValueError, match="no 'data' axis"):
            Trainer(spec, TrainConfig(), mesh=make_mesh({'model': 1},
                                                        device='cpu'),
                    spatial=True, device='cpu')
    finally:
        dist.destroy_process_group()


def test_rank_device_keeps_the_callers_device(monkeypatch):
    """A rank's device follows the caller's: the CPU only when asked for,
    a bare 'cuda' the rank's card (LOCAL_RANK, else the rank, modulo the
    cards), an explicit card as given; without a card None raises."""
    import torch

    from totalsegmentator2d_tpu_torch.parallel.distributed import rank_device
    monkeypatch.delenv('LOCAL_RANK', raising=False)
    assert rank_device('cpu', 3) == torch.device('cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='No CUDA device'):
            rank_device(None, 0)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    assert rank_device(None, 5) == torch.device('cuda', 1)
    assert rank_device('cuda', 6) == torch.device('cuda', 2)
    assert rank_device('cuda:3', 5) == torch.device('cuda', 3)
    monkeypatch.setenv('LOCAL_RANK', '7')
    assert rank_device(None, 0) == torch.device('cuda', 3)


def test_helpers_on_4_ranks(tmp_path):
    """``distribute_batch`` / ``replicate`` / ``local_shard`` as DTensors,
    ``ensemble_forward_sharded`` against ``ensemble_forward`` and the
    reference's (test_007's bar: rtol 2e-4 / atol 2e-5), ``shard_params``
    and ``batch_sharding`` on {'ensemble': 2, 'data': 2}."""
    import jax.numpy as jnp
    import torch

    from totalsegmentator2d_tpu.models.plans import ArchSpec as JaxArch
    from totalsegmentator2d_tpu.models.unet import forward as jax_forward
    from totalsegmentator2d_tpu.models.unet import init_params_np as jax_init
    from totalsegmentator2d_tpu.parallel import ensemble as JE
    from totalsegmentator2d_tpu_torch.models.convert import params_from_jax
    from totalsegmentator2d_tpu_torch.parallel import (ensemble_forward,
                                                       stack_groups)
    x = np.random.default_rng(3).standard_normal((2, 32, 32, 2)).astype(
        np.float32)
    results = launch(__file__, 'helpers', 4, tmp_path, {'x': x})
    arch, forward = _small_forward()
    jps = [jax_init(g, JaxArch(**arch)) for g in (0, 1)]
    stacked, _ = stack_groups([params_from_jax(p) for p in jps], [4, 4])
    want = ensemble_forward(forward, stacked, torch.from_numpy(x)).numpy()
    jstacked, _ = JE.stack_groups(jps, [4, 4])
    ref = np.asarray(JE.ensemble_forward(
        lambda p, v: jax_forward(p, v, JaxArch(**arch)), jstacked,
        jnp.asarray(x)))
    np.testing.assert_allclose(want, ref, rtol=2e-4, atol=2e-5)
    # rank (e, d) = 2e + d holds 2 rows; the data axis gathers them
    for r, res in enumerate(results):
        e, d = res['coord']
        assert res['global_shape'] == (4, 3), r
        np.testing.assert_array_equal(res['local'], np.full((2, 3), r))
        np.testing.assert_array_equal(
            res['full'], np.repeat([2 * e, 2 * e + 1], 6).reshape(4, 3))
        np.testing.assert_array_equal(res['replicated'],
                                      np.arange(6).reshape(2, 3))
        np.testing.assert_array_equal(res['logits'], want)
        for k, shape in res['local_stack'].items():
            assert shape == (1,) + tuple(stacked[k].shape[1:]), k
        np.testing.assert_array_equal(res['rows'],
                                      np.arange(8).reshape(2, 4, 1)[e:e + 1,
                                                                    2 * d:2 * d + 2])


@pytest.fixture(scope='module')
def tile_inputs():
    return engine_inputs()


@pytest.mark.parametrize('world', [2, 4])
def test_tile_sharded_scan(tmp_path, tile_inputs, world):
    results = launch(__file__, 'tile', world, tmp_path, tile_inputs)
    solo = port_engine(tile_inputs)
    ref = jax_engine(tile_inputs, tile_mesh=jax_mesh({'data': world}),
                     tile_axis='data')
    arr = scan_array()
    for spacing in ((1.5, 1.5), (1.2, 2.0)):
        a = solo.predict_array(arr, spacing)
        n_tiles = solo._program(arr.shape[:2], spacing)[1]['n_tiles']
        for r, res in enumerate(results):
            np.testing.assert_array_equal(res[spacing], results[0][spacing])
            assert res[spacing, 'tiles'] == -(-n_tiles // world), r
        agree = float((results[0][spacing] == a).mean())
        assert agree >= 0.9999, (spacing, agree)
    b = np.asarray(ref.predict_array(arr, (1.5, 1.5)))
    agree = float((results[0][1.5, 1.5] == b).mean())
    assert agree >= 0.999, agree


def test_dryrun_analogue_on_8_ranks(tmp_path):
    out = launch(__file__, 'dryrun', 8, tmp_path)[0]
    oks = [ln for ln in out.splitlines() if ln.startswith('dryrun_multichip OK')]
    assert len(oks) == 6, out
    for mode in ('ep/dp/tp', 'ep/dp/sp', 'augmented', 'cohort dp',
                 'mixed-shape', 'tile-sharded'):
        assert any(mode in ln for ln in oks), (mode, oks)
