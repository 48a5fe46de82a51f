"""The public names of the port's packages against the reference package's:
each package's ``__all__`` (the same set but for the divergences that
ROADMAP.md records), and each name held against the reference's function
on the same inputs, the way the reference's own tests use it
(tests/test_000_utils.py, test_004_models.py, test_005_inference.py,
test_999_env.py, test_023_train_cli.py)."""

import dataclasses
import importlib
import os
import threading

import numpy as np
import pytest
import torch

from tests.model_fixtures import build_group_set, build_model_dir

# names only the port exports: the U-Net as a module (the reference's is
# functional), the micro-batcher (the reference's lives inside its engine)
# and the schedule (optax's in the reference)
PORT_ONLY = {'models': {'UNet'}, 'inference': {'DynamicBatcher'},
             'training': {'poly_lr'}}
PACKAGES = ('ops', 'models', 'inference', 'training', 'parallel')


def _both(sub):
    return (importlib.import_module(f'totalsegmentator2d_tpu.{sub}'),
            importlib.import_module(f'totalsegmentator2d_tpu_torch.{sub}'))


@pytest.mark.parametrize('sub', PACKAGES)
def test_all_names_match_the_reference(sub):
    ref, port = _both(sub)
    assert set(port.__all__) - PORT_ONLY.get(sub, set()) == set(ref.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None, name


def test_ops_exports_come_from_the_same_modules():
    """Each of the 25 names is its module's function, the module the
    reference's comes from."""
    ref, port = _both('ops')
    for name in ref.__all__:
        a, b = getattr(ref, name), getattr(port, name)
        assert a.__module__.rsplit('.', 1)[1] == b.__module__.rsplit('.', 1)[1]
        mod = importlib.import_module(b.__module__)
        assert getattr(mod, name) is b, name


def test_utils_imports_its_submodules():
    import totalsegmentator2d_tpu.utils as J
    import totalsegmentator2d_tpu_torch.utils as U
    for name in ('colors', 'config', 'files', 'logging', 'params', 'temp'):
        assert getattr(J, name).__name__.endswith(name)
        assert getattr(U, name).__name__ == \
            f'totalsegmentator2d_tpu_torch.utils.{name}'


# -- ops ---------------------------------------------------------------------------

@pytest.mark.parametrize('n', [1, 2, 5, 17, 40])
@pytest.mark.parametrize('tol', [1e-10, 1e-4])
def test_bspline_prefilter_1d(n, tol):
    """The last axis of a (3, 4, n) float32 array: within rtol 1e-5 /
    atol 1e-6 of the reference's (float32, another summation order), and
    of scipy's where the series reaches it (n >= 10 at tol 1e-10)."""
    import jax.numpy as jnp
    import scipy.ndimage as ndi

    from totalsegmentator2d_tpu.ops.resample import \
        bspline_prefilter_1d as ref
    from totalsegmentator2d_tpu_torch.ops.resample import bspline_prefilter_1d
    x = np.random.default_rng(n).standard_normal((3, 4, n)).astype(np.float32)
    got = bspline_prefilter_1d(torch.from_numpy(x), tol).numpy()
    np.testing.assert_allclose(got, np.asarray(ref(jnp.asarray(x), tol)),
                               rtol=1e-5, atol=1e-6)
    if n >= 10 and tol == 1e-10:
        want = ndi.spline_filter1d(x.astype(np.float64), order=3, axis=-1,
                                   mode='mirror')
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _image(mod, arr, **kw):
    return importlib.import_module(f'{mod}.io.image').MedicalImage(
        array=arr, **kw)


def test_annotation_meta_helpers():
    """test_000_utils' meta helpers, and the label names of a Segment-
    annotated image, equal to the reference's."""
    out = []
    for mod in ('totalsegmentator2d_tpu', 'totalsegmentator2d_tpu_torch'):
        A = importlib.import_module(f'{mod}.ops.annotations')
        img = _image(mod, np.zeros((2, 3), np.uint8), spacing=(0.5, 2.0),
                     origin=(1.0, -2.0))
        A.set_image_meta(img, {'a': 1, 'long': 'x' * 100, '6000|3000': 'big'},
                         limit=10)
        meta = A.get_image_meta(img, add_info=True)
        clean = A.get_image_meta(img, sanitize=True)
        assert A.sanitize_meta({'6000|3000': 'big', 'k': 'v'}) == {'k': 'v'}
        dst = _image(mod, np.ones((2, 3), np.uint8))
        A.copy_image_meta(dst, img)
        A.copy_image_geo(dst, img)
        seg = _image(mod, np.zeros((4, 5, 3), np.uint8), is_vector=True)
        A.set_annotation_meta(seg, names={1: 'heart', 2: 'aorta', 3: 'vein'},
                              colors={'heart': '#ff0000'})
        out.append((meta, clean, dict(dst.meta), dst.spacing, dst.origin,
                    A.get_label_names(seg), A.get_label_names(seg, False)))
    ref, port = out
    assert port == ref
    assert port[0]['size'] == (3, 2) and port[0]['long'] == 'x' * 10
    assert port[5] == {1: 'heart', 2: 'aorta', 3: 'vein'}


# -- utils -------------------------------------------------------------------------

PARAM_CASES = [
    ('as_tuple', ([1, 2],)), ('as_tuple', (None,)), ('as_tuple', (5,)),
    ('default', (None, 3)), ('default', (0, 3)),
    ('dict_has', ({'a': {'b': 1}}, 'a.b')), ('dict_has', ({'a.b': 1}, 'a.b')),
    ('dict_has', ({'a': {'b': 1}}, 'a.c')),
    ('flatten_dict', ({'a': {'b': 1, 'c': {'d': 2}}, 'e': {}},)),
    ('format_array', ([1.5, 2.0, 3.25], 2)), ('format_array', ([1, 2],)),
    ('format_array', ([0.0001],)),
    ('native', ({'a': np.float32(1.5), 'b': np.arange(3), 'c': (np.int64(2),)},)),
    ('short_message', ('abc', 10)), ('short_message', ('x' * 200, 20)),
    ('unwrap_singular', ([7],)), ('unwrap_singular', ({'k': 3},)),
    ('unwrap_singular', ('abc',)), ('unwrap_singular', ([1, 2], False)),
]


@pytest.mark.parametrize('name,args', PARAM_CASES,
                         ids=[f'{c[0]}-{i}' for i, c in enumerate(PARAM_CASES)])
def test_params_helpers(name, args):
    ref, port = (getattr(importlib.import_module(f'{m}.utils.params'), name)
                 for m in ('totalsegmentator2d_tpu',
                           'totalsegmentator2d_tpu_torch'))
    assert port(*args) == ref(*args)


def test_params_dict_set_unit_vector_and_refusal():
    from totalsegmentator2d_tpu.utils import params as J
    from totalsegmentator2d_tpu_torch.utils import params as P
    for mod in (J, P):
        d = mod.dict_set({'a': 1}, 'a.b.c', 2)
        assert d == {'a': {'b': {'c': 2}}}
        assert mod.dict_get(d, 'a.b.c') == 2
        with pytest.raises(ValueError, match='exactly one'):
            mod.unwrap_singular([1, 2])
    np.testing.assert_array_equal(P.unit_vector([3, 4]),
                                  J.unit_vector([3, 4]))
    np.testing.assert_allclose(P.unit_vector([3, 4]), [0.6, 0.8])
    assert P.unit_vector([0, 0]).tolist() == [0.0, 0.0]


def test_files_config_colors(tmp_path):
    from totalsegmentator2d_tpu.utils import colors as JC
    from totalsegmentator2d_tpu.utils import config as JG
    from totalsegmentator2d_tpu.utils import files as JF
    from totalsegmentator2d_tpu_torch.utils import colors, config, files
    for rel in ('a.nrrd', 'sub/b.nii.gz', '_private/c.png', 'sub/_x/d.mha'):
        os.makedirs(os.path.dirname(tmp_path / rel), exist_ok=True)
        (tmp_path / rel).write_bytes(b'')
    for skip in (True, False):
        got = list(files.enumerate_files(str(tmp_path), skip))
        assert got == list(JF.enumerate_files(str(tmp_path), skip))
        assert len(got) == (2 if skip else 4)
    for name in ('a/b.nii.gz', 'scan.nrrd', 'noext', '/x/y.seg.nrrd'):
        assert files.split_image_name(name) == JF.split_image_name(name)
    for kind in ('single', 'single-xr', 'multi'):
        assert config.get_test_model(kind) == JG.get_test_model(kind)
    for rgb in ((255, 0, 16), (1, 2, 3), (0, 0, 0)):
        assert colors.rgb_to_hex(rgb) == JC.rgb_to_hex(rgb)
        assert colors.hex_to_rgb(colors.rgb_to_hex(rgb)) == rgb


def test_log_sink_sees_the_train_cli(tmp_path):
    """test_023_train_cli's sink: ``ts2d-torch-train`` logs its losses and
    the holdout Dice through every added sink, and a removed sink hears
    nothing more."""
    from tests.test_torch_train_cli import _make_dataset
    from totalsegmentator2d_tpu_torch.training.cli import main
    from totalsegmentator2d_tpu_torch.utils import logging as tlog
    data = tmp_path / 'Dataset501_toy'
    data.mkdir()
    _make_dataset(str(data))
    lines = []

    def sink(*a, **k):
        lines.append(' '.join(str(x) for x in a))

    tlog.add_log_sink(sink)
    try:
        main(['-d', str(data), '-o', str(tmp_path / 'models'),
              '--model', 'ts2d-toy', '--group', 'cardiac', '--steps', '4',
              '--batch-size', '2', '--max-patch', '64', '--val-fraction',
              '0.25', '--log-every', '2', '--seed', '1', '--device', 'cpu'])
    finally:
        tlog.remove_log_sink(sink)
    text = '\n'.join(lines)
    assert 'loss' in text and 'holdout Dice' in text
    n = len(lines)
    tlog.log('after removal')
    assert len(lines) == n


# -- models ------------------------------------------------------------------------

def test_pad_to_stride():
    from tests.test_004_models import DATASET, PLANS
    from totalsegmentator2d_tpu.models import pad_to_stride as ref
    from totalsegmentator2d_tpu_torch.models import (pad_to_stride,
                                                     parse_model_spec)
    spec = parse_model_spec(PLANS, DATASET)
    assert pad_to_stride((100, 300), spec.arch.total_stride,
                         spec.preprocess.patch_size) == (256, 304)
    for shape in ((1, 1), (256, 257), (511, 40), (1000, 1000)):
        for stride, patch in (((32, 32), (256, 256)), ((8, 4), (20, 30))):
            assert pad_to_stride(shape, stride, patch) == \
                ref(shape, stride, patch)


def _arch(port=True, **kw):
    from tests.torch_mirror import make_spec
    spec = make_spec(**kw)
    if not port:
        return spec
    from totalsegmentator2d_tpu_torch.models import ArchSpec
    return ArchSpec(**dataclasses.asdict(spec))


@pytest.mark.parametrize('deep_supervision', [False, True])
def test_functional_forward_and_param_count(deep_supervision):
    """``forward(params, x, spec)`` on the reference's initial weights
    against the reference's ``forward``: the U-Net bar (rtol 1e-3 /
    atol 1e-4, test_004); ``param_count`` equal; gradients reach the
    given weights."""
    import jax.numpy as jnp

    from totalsegmentator2d_tpu.models import forward as ref_forward
    from totalsegmentator2d_tpu.models import param_count as ref_count
    from totalsegmentator2d_tpu.models.unet import init_params_np
    from totalsegmentator2d_tpu_torch.models import forward, param_count
    from totalsegmentator2d_tpu_torch.models.convert import params_from_jax
    jspec, spec = _arch(False, n_stages=3), _arch(n_stages=3)
    jp = init_params_np(4, jspec)
    sd = params_from_jax(jp)
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 2)).astype(
        np.float32)
    got = forward(sd, torch.from_numpy(x), spec, deep_supervision)
    want = ref_forward(jp, jnp.asarray(x), jspec, deep_supervision)
    if not deep_supervision:
        got, want = [got], [want]
    assert len(got) == len(want) == (2 if deep_supervision else 1)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-3, atol=1e-4)
    assert param_count(sd) == ref_count(jp)
    w = sd['decoder.seg_layers.1.weight'].clone().requires_grad_(True)
    out = forward(dict(sd, **{'decoder.seg_layers.1.weight': w}),
                  torch.from_numpy(x), spec)
    out.sum().backward()
    assert w.grad is not None and float(w.grad.abs().sum()) > 0


def test_functional_forward_bf16():
    """``compute_dtype=torch.bfloat16``: fp32 heads by default, bf16 with
    ``head_dtype``, against the reference's bf16 forward (rtol 0.05 /
    atol 0.05: bf16 activations rounded in another order)."""
    import jax.numpy as jnp

    from totalsegmentator2d_tpu.models import forward as ref_forward
    from totalsegmentator2d_tpu.models.unet import init_params_np
    from totalsegmentator2d_tpu_torch.models import forward
    from totalsegmentator2d_tpu_torch.models.convert import params_from_jax
    jspec, spec = _arch(False, n_stages=3), _arch(n_stages=3)
    jp = init_params_np(4, jspec)
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 2)).astype(
        np.float32)
    got = forward(params_from_jax(jp), torch.from_numpy(x), spec,
                  compute_dtype=torch.bfloat16)
    want = ref_forward(jp, jnp.asarray(x), jspec, compute_dtype=jnp.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want, np.float32),
                               rtol=0.05, atol=0.05)
    heads = forward(params_from_jax(jp), torch.from_numpy(x), spec,
                    deep_supervision=True, compute_dtype=torch.bfloat16,
                    head_dtype=torch.bfloat16)
    assert [h.dtype for h in heads] == [torch.bfloat16] * 2


def test_convert_checkpoint(tmp_path):
    """test_004's checkpoint (DDP prefixes, an alias key, meta) through
    both packages' ``convert_checkpoint``: the port's weights are the
    reference's params carried across (``params_from_jax``), bit for bit;
    ``extract_state_dict`` and ``state_dict_to_params`` likewise; a head of
    the wrong width raises ValueError in both."""
    from tests.torch_mirror import TorchPlainConvUNet
    from totalsegmentator2d_tpu.models import convert as J
    from totalsegmentator2d_tpu_torch.models import convert as P
    from totalsegmentator2d_tpu_torch.models import param_count
    jspec, spec = _arch(False), _arch()
    torch.manual_seed(0)
    model = TorchPlainConvUNet(jspec).eval()
    sd = {f'module.{k}': v for k, v in model.state_dict().items()}
    sd['encoder.stages.0.convs.0.all_modules.0.weight'] = \
        sd['module.encoder.stages.0.convs.0.conv.weight']
    ckpt = {'network_weights': sd, 'trainer_name': 'nnUNetTrainer',
            'inference_allowed_mirroring_axes': [0, 1], 'current_epoch': 4000}
    path = str(tmp_path / 'checkpoint_final.pth')
    torch.save(ckpt, path)
    params, meta = P.convert_checkpoint(path, spec)
    jparams, jmeta = J.convert_checkpoint(path, jspec)
    assert meta == jmeta
    want = P.params_from_jax(jparams)
    assert set(params) == set(want)
    for k in want:
        assert torch.equal(params[k], want[k]), k
    assert param_count(params) == sum(v.numel() for v in
                                      model.state_dict().values())
    loaded = torch.load(path, weights_only=True)
    extracted = P.state_dict_to_params(P.extract_state_dict(loaded), spec)
    jextracted = J.state_dict_to_params(J.extract_state_dict(loaded), jspec)
    for k, v in P.params_from_jax(jextracted).items():
        assert torch.equal(extracted[k], v), k
    bad_j = _arch(False, out_channels=4)
    with pytest.raises(ValueError):
        J.state_dict_to_params(J.extract_state_dict(loaded), bad_j)
    with pytest.raises(ValueError, match='does not match'):
        P.state_dict_to_params(P.extract_state_dict(loaded),
                               _arch(out_channels=4))
    with pytest.raises(ValueError, match='missing'):
        P.state_dict_to_params({}, spec)


# -- inference ---------------------------------------------------------------------

@pytest.fixture(scope='module')
def hosted(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('hosted'))
    build_model_dir(root, patch=(64, 64))
    return root


def _load(root, mod='totalsegmentator2d_tpu_torch', key='ts2d-v9-test_cardiac'):
    zoo = importlib.import_module(f'{mod}.inference').Zoo
    return zoo(remote=False, local=root).load(key)


def test_hosted_identity(hosted):
    ref, port = _load(hosted, 'totalsegmentator2d_tpu'), _load(hosted)
    for m in (ref, port):
        assert m.uid == m.id == 'ts2d-v9-test_cardiac'
    assert (port.name, port.group, port.get_exts()) == \
        (ref.name, ref.group, ref.get_exts())


def test_async_start_warms_up_and_applies(hosted):
    """start(wait=False) returns at once; await_startup() finds the engine
    built and its patch-size program run (the warm-up); apply then equals
    the reference's HostedModel >= 0.999."""
    from totalsegmentator2d_tpu_torch.io import MedicalImage
    m = _load(hosted)
    m.start('cpu', wait=False)
    m.await_startup()
    assert m.started
    assert any(k[0] == (64, 64) for k in m._engine._cache), m._engine._cache
    arr = (np.random.default_rng(2).standard_normal((72, 60, 2)) + 3.0
           ).astype(np.float32)
    seg = m.apply(MedicalImage(array=arr, spacing=(1.5, 1.5),
                               is_vector=True))
    ref = _load(hosted, 'totalsegmentator2d_tpu').apply(
        _image('totalsegmentator2d_tpu', arr, spacing=(1.5, 1.5),
               is_vector=True))
    assert seg.array.shape == ref.array.shape == (72, 60, 3)
    assert float((seg.array == ref.array).mean()) >= 0.999
    assert seg.meta == ref.meta
    m.stop()
    assert not m.started


def test_single_startup_under_races(tmp_path, monkeypatch):
    """test_005's race: a start(wait=True) and an apply() while an async
    start is pending join it (one load); stop() during a pending startup
    leaves the model stopped."""
    root = str(tmp_path)
    build_model_dir(root, patch=(64, 64), model='ts2d-v9-race')
    m = _load(root, key='ts2d-v9-race_cardiac')
    boots, gate = [], threading.Event()
    real = type(m)._load_engine

    def slow_boot(self, device=None):
        boots.append(1)
        gate.wait(10.0)
        return real(self, device)

    monkeypatch.setattr(type(m), '_load_engine', slow_boot)
    m.start('cpu', wait=False)
    t = threading.Thread(target=lambda: m.start('cpu', wait=True))
    t.start()
    gate.set()
    t.join(30.0)
    m.await_startup()
    assert m.started and len(boots) == 1
    m.stop()
    gate.clear()
    m.start('cpu', wait=False)
    gate.set()
    m.stop()
    assert not m.started and len(boots) == 2


def test_failed_startup_raises_on_await(hosted, monkeypatch):
    m = _load(hosted)

    def broken(self, device=None):
        raise OSError('no weights')

    monkeypatch.setattr(type(m), '_load_engine', broken)
    m.start('cpu', wait=False)
    with pytest.raises(RuntimeError, match='failed to start') as err:
        m.await_startup()
    assert isinstance(err.value.__cause__, OSError)
    m.await_startup()   # the error is reported once
    assert not m.started


def test_verify_setup():
    """The reference checks its devices (test_999_env); the port checks
    that a kernel runs on a CUDA card, and raises without one."""
    from totalsegmentator2d_tpu_torch.inference import HostedModel
    if torch.cuda.is_available():
        HostedModel.verify_setup()
    else:
        with pytest.raises(RuntimeError, match='No CUDA device'):
            HostedModel.verify_setup()


def test_engine_warmup_and_new_shape(hosted):
    """``InferenceEngine.warmup`` builds and runs the program of a shape
    (at the plan's spacing unless given); ``compute_new_shape`` equals the
    reference's."""
    from totalsegmentator2d_tpu.inference.engine import \
        compute_new_shape as ref_shape
    from totalsegmentator2d_tpu_torch.inference.engine import \
        compute_new_shape
    engine = _load(hosted)._load_engine('cpu')
    engine.warmup((48, 40))
    engine.warmup((48, 40), (1.2, 2.0))
    keys = [k for k in engine._cache if k[0] == (48, 40)]
    assert len(keys) == 2, engine._cache
    for args in (((48, 40), (1.2, 2.0), (1.5, 1.5)),
                 ((400, 512), (0.78, 1.25), (1.5, 1.5)), ((7,), (1,), (3,))):
        assert compute_new_shape(*args) == ref_shape(*args)


def test_per_model_fallback_starts_all_then_awaits(tmp_path, monkeypatch):
    """A set that does not fuse (groups that disagree on precision) starts
    every model without waiting, then awaits each (the reference's
    ``TS2D``)."""
    from totalsegmentator2d_tpu_torch.api import TS2D
    from totalsegmentator2d_tpu_torch.inference import HostedModel
    from tests.test_torch_api import _set_precision
    root = str(tmp_path)
    build_group_set(root, model='ts2d-v9-mix')
    _set_precision(root, 'ribs', 'fast')
    calls = []
    start, wait = HostedModel.start, HostedModel.await_startup

    def spy_start(self, device=None, wait=True):
        calls.append(('start', self.id, wait))
        return start(self, device, wait)

    def spy_await(self):
        calls.append(('await', self.id))
        return wait(self)

    monkeypatch.setattr(HostedModel, 'start', spy_start)
    monkeypatch.setattr(HostedModel, 'await_startup', spy_await)
    with TS2D(key='ts2d-v9-mix', use_remote=False, local=root,
              device='cpu') as tool:
        assert tool._fused is None
        assert all(m.started for m in tool.models.values())
        n = len(tool.models)
    assert n >= 2
    assert [c[0] for c in calls] == ['start'] * n + ['await'] * n
    assert all(c[2] is False for c in calls[:n])


# -- signatures ----------------------------------------------------------------------

_DEVICE = ('device: the port runs on the CUDA card unless the caller names '
           'the CPU')
_GENERATOR = ('a torch.Generator (gen / generator) in place of a jax.random '
              'key: the draws cannot be equal, the tests hold the transforms '
              'at fixed parameters')
_READY = ('ready: the CUDA event recorded after the program; the copy waits '
          'for it and not for later work on the stream')
_GROUP = ('group: the height group of a height-sharded trainer '
          '(spatial=True), over which the loss sums reduce')
_MODULE_STEP = ('a training step on torch modules and optimizers, which hold '
                'the parameters and the optimizer state (count and layout for '
                'the sharded trainers)')
_ARGV = 'main(argv): the command line as a list, for tests and callers'
_SWAPPED = ('the batch form names the recipe\'s probabilities (it draws every '
            'sample\'s transforms at once, the warped samples as one stack) '
            'and the pair form passes them on as **kw, where the reference '
            'does the reverse')

#: every public function, class and method whose parameter names differ
#: from the reference package's, and why (ROADMAP.md Queue 3 lists them)
SIGNATURE_DIVERGENCES = {
    'api.TS2D.Result': _DEVICE,
    'api.TS2D.__init__': _DEVICE,
    'cli.ts2d_run': _DEVICE,
    'eval.dice_per_label': _DEVICE,
    'eval.evaluate': _DEVICE,
    'eval.main': _ARGV,
    'inference.engine.InferenceEngine.__init__': _DEVICE,
    'inference.ensemble_engine.EnsembleEngine.__init__': _DEVICE,
    'inference.ensemble_engine.fetch_compact': _READY,
    'inference.ensemble_engine.fetch_compact_batch': _READY,
    'inference.ensemble_engine.fetch_split': _READY,
    'inference.model.HostedModel.start': _DEVICE,
    'inference.tiling.accumulate_tiles': (
        'adds to acc and wacc in place (no acc0 / wacc0 to return), the '
        'tile validity last and optional'),
    'io.native.gzip_decompress': (
        'size: the inflated size a header declares, which bounds the native '
        'buffer'),
    'models.unet.init_params': _GENERATOR,
    'ops.projection.project': _DEVICE,
    'ops.resample.resample': _DEVICE,
    'ops.resample.resize_to_shape': _DEVICE,
    'ops.visual.create_visual': _DEVICE,
    'ops.visual.label_to_rgb': _DEVICE,
    'parallel.distributed.global_mesh': _DEVICE,
    'parallel.distributed.init_distributed': (
        'backend and device in place of jax.distributed.initialize\'s '
        '**kwargs: ranks sharing a card ask for gloo'),
    'parallel.mesh.make_mesh': (
        'device in place of devices: a mesh spans the whole world, one card '
        'per rank'),
    'parallel.mesh.named': (
        'axis in place of a PartitionSpec: it returns the axis\'s process '
        'group, there is no NamedSharding'),
    'parallel.sharding.param_spec': (
        'channel: the axis of a torch weight that holds its output channels'),
    'serve.main': _ARGV,
    'training.augment.add_gaussian_noise': _GENERATOR,
    'training.augment.augment_batch': _SWAPPED,
    'training.augment.augment_pair': _SWAPPED,
    'training.augment.blur_transform': _GENERATOR,
    'training.augment.brightness_transform': _GENERATOR,
    'training.augment.contrast_transform': _GENERATOR,
    'training.augment.elastic_offsets': _GENERATOR,
    'training.augment.gamma_transform': _GENERATOR,
    'training.augment.lowres_transform': _GENERATOR,
    'training.augment.mirror_transform': _GENERATOR,
    'training.augment.spatial_transform': _GENERATOR,
    'training.augment.spatial_transform_batch': _GENERATOR,
    'training.cli.ts2d_train': _DEVICE,
    'training.data.preprocess_case': _DEVICE,
    'training.losses.bce_loss': _GROUP,
    'training.losses.ce_loss': _GROUP,
    'training.losses.deep_supervision_loss': _GROUP,
    'training.losses.deep_supervision_weights': _DEVICE,
    'training.losses.dice_and_ce': _GROUP,
    'training.losses.soft_dice_loss': _GROUP,
    'training.train.Trainer.__init__': _DEVICE,
    'training.train.build_sharded_train_step': _DEVICE,
    'training.train.ensemble_train_step': _MODULE_STEP,
    'training.train.loss_fn': _MODULE_STEP,
    'training.train.make_optimizer': (
        'params: a torch optimizer is bound to its parameters'),
    'training.train.train_step': _MODULE_STEP,
}
#: the reference's public names the port does not have
MISSING = {'models.unet.fused_blocks_enabled': (
    'the TPU build\'s TS2D_FUSED gate: the fast path always runs the fused '
    'block kernel on the card')}
#: how a rule's divergence maps the port's names back onto the reference's
_RULES = {_DEVICE: lambda n: [p for p in n if p != 'device'],
          _READY: lambda n: [p for p in n if p != 'ready'],
          _GROUP: lambda n: [p for p in n if p != 'group'],
          _GENERATOR: lambda n: ['key' if p in ('gen', 'generator') else p
                                 for p in n if p != 'device']}


def _modules(pkg):
    import pkgutil
    root = importlib.import_module(pkg)
    out = {'': root}
    for info in pkgutil.walk_packages(root.__path__, pkg + '.'):
        out[info.name[len(pkg) + 1:]] = importlib.import_module(info.name)
    return out


def _names(obj):
    import inspect
    return [p.name for p in inspect.signature(obj).parameters.values()]


def _public(mod):
    import inspect
    return {n: o for n, o in vars(mod).items() if not n.startswith('_')
            and (inspect.isfunction(o) or inspect.isclass(o))
            and o.__module__ == mod.__name__}


def _callables(ref_cls, port_cls):
    """(name, reference function, port function) of the reference class's
    __init__ and public methods that the port's class has (properties
    aside)."""
    for name, fn in vars(ref_cls).items():
        if name.startswith('_') and name != '__init__':
            continue
        mine = next((vars(k)[name] for k in port_cls.__mro__
                     if name in vars(k)), None)
        if mine is None or isinstance(fn, property):
            continue
        fn, mine = (getattr(f, '__func__', f) for f in (fn, mine))
        if callable(fn) and callable(mine):
            yield name, fn, mine


@pytest.fixture(scope='module')
def signature_diffs():
    """{qualified name: (reference's names, port's names)} of every public
    function, class and method of a module both packages have, and the
    reference's public names the port's module lacks."""
    import inspect
    ref, port = (_modules('totalsegmentator2d_tpu'),
                 _modules('totalsegmentator2d_tpu_torch'))
    diffs, missing = {}, set()
    for rel in sorted(set(ref) & set(port)):
        for name, obj in _public(ref[rel]).items():
            mine = getattr(port[rel], name, None)
            qual = f'{rel}.{name}'
            if mine is None:
                missing.add(qual)
            elif inspect.isclass(obj):
                for meth, a, b in _callables(obj, mine):
                    if _names(a) != _names(b):
                        diffs[f'{qual}.{meth}'] = (_names(a), _names(b))
            elif _names(obj) != _names(mine):
                diffs[qual] = (_names(obj), _names(mine))
    return diffs, missing


def test_parameter_names_match_the_reference(signature_diffs):
    """The port's parameter names are the reference's, in its order, but
    for the recorded divergences; a divergence of a rule is exactly that
    rule (the extra device, ready or group, a generator for the key)."""
    diffs, missing = signature_diffs
    assert set(diffs) == set(SIGNATURE_DIVERGENCES), (
        sorted(set(diffs) ^ set(SIGNATURE_DIVERGENCES)))
    assert missing == set(MISSING)
    for name, (ref, port) in diffs.items():
        rule = _RULES.get(SIGNATURE_DIVERGENCES[name])
        if rule is not None:
            assert rule(port) == ref, (name, ref, port)


def test_signature_walk_covers_the_packages(signature_diffs):
    """The walk reaches every layer (a comparison that finds nothing
    because it looked at nothing would pass)."""
    ref = _modules('totalsegmentator2d_tpu')
    assert {'api', 'inference.engine', 'inference.ensemble_engine',
            'models.convert', 'ops.resample', 'parallel.distributed',
            'training.train', 'io.native'} <= set(ref)
    assert _names(importlib.import_module(
        'totalsegmentator2d_tpu_torch.inference.engine').InferenceEngine
        .predict_array) == ['self', 'arr', 'spacing_yx', 'return_logits']


# -- the reference's parameters the port lacked ----------------------------------

def test_zoo_load_interface(hosted):
    """``interface``: the reference's accepted names load the in-process
    model; anything else raises the reference's message."""
    from totalsegmentator2d_tpu.inference import Zoo as JaxZoo
    from totalsegmentator2d_tpu_torch.inference import Zoo
    zoo = Zoo(remote=False, local=hosted)
    for interface in ('hosted', 'PROCESS', 'prc', 'svc', 'server'):
        m = zoo.load('ts2d-v9-test_cardiac', interface=interface)
        assert m.id == 'ts2d-v9-test_cardiac'
    messages = []
    for z in (zoo, JaxZoo(remote=False, local=hosted)):
        with pytest.raises(ValueError) as ex:
            z.load('ts2d-v9-test_cardiac', interface='subprocess')
        messages.append(str(ex.value))
    assert messages[0] == messages[1] == 'Invalid model interface: subprocess'


def test_resample_default_value_is_accepted_and_unread():
    from totalsegmentator2d_tpu.ops.resample import resample as ref_resample
    from totalsegmentator2d_tpu_torch.ops.resample import resample
    arr = np.random.default_rng(0).standard_normal((6, 7)).astype(np.float32)
    img, jimg = (_image(m, arr, spacing=(1.0, 1.5)) for m in (
        'totalsegmentator2d_tpu_torch', 'totalsegmentator2d_tpu'))
    plain = resample(img, 0.7, device='cpu').array
    got = resample(img, 0.7, default_value=-1000.0, device='cpu').array
    np.testing.assert_array_equal(got, plain)
    want = ref_resample(jimg, 0.7, default_value=-1000.0).array
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('ids,device,error', [
    ([0, 1], None, ValueError), ([0], 'cpu', ValueError),
    ([0], 'cuda:1', ValueError), (2, torch.device('cuda', 0), ValueError),
    ([0], None, RuntimeError), ((1,), 'cuda', RuntimeError)])
def test_init_distributed_local_device_ids(monkeypatch, ids, device, error):
    """``[i]`` names cuda:i; more than one id or a contradicting device
    raises ValueError; without a card it raises as the device does, and
    it never forms a group on the CPU."""
    import torch.distributed as dist

    from totalsegmentator2d_tpu_torch.parallel import distributed as D
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)

    def refuse(*a, **kw):
        raise AssertionError('init_process_group reached')
    monkeypatch.setattr(dist, 'init_process_group', refuse)
    with pytest.raises(error):
        D.init_distributed('localhost:1', 1, 0, local_device_ids=ids,
                           device=device)


def test_local_device_ids_name_the_card():
    from totalsegmentator2d_tpu_torch.parallel.distributed import _local_device
    assert _local_device([3], None) == torch.device('cuda', 3)
    assert _local_device(1, 'cuda') == torch.device('cuda', 1)
    assert _local_device((2,), 'cuda:2') == torch.device('cuda', 2)


def test_init_params_dtype():
    """Every dtype takes the same draws: bf16 weights are the float32
    weights rounded."""
    from totalsegmentator2d_tpu_torch.models.unet import init_params
    spec = _arch()
    fp32 = init_params(torch.Generator().manual_seed(3), spec)
    bf16 = init_params(torch.Generator().manual_seed(3), spec, torch.bfloat16)
    assert set(fp32) == set(bf16)
    for k, v in fp32.items():
        assert bf16[k].dtype == torch.bfloat16
        assert torch.equal(bf16[k], v.to(torch.bfloat16)), k


def test_params_to_state_dict_checks_the_spec():
    """With ``spec`` the weights are checked as ``state_dict_to_params``
    checks them; the result equals the reference's export of the same
    params."""
    from totalsegmentator2d_tpu.models.convert import \
        params_to_state_dict as ref_export
    from totalsegmentator2d_tpu.models.unet import init_params_np as ref_init
    from totalsegmentator2d_tpu_torch.models.convert import (
        params_from_jax, params_to_state_dict)
    spec, jspec = _arch(), _arch(False)
    jparams = ref_init(5, jspec)
    sd = params_from_jax(jparams)
    plain = params_to_state_dict(sd)
    checked = params_to_state_dict(sd, spec)
    want = ref_export(jparams, jspec)
    assert set(plain) == set(checked) == set(want)
    for k in want:
        np.testing.assert_array_equal(checked[k], plain[k])
        np.testing.assert_array_equal(checked[k], np.asarray(want[k]))
    with pytest.raises(ValueError, match='does not match'):
        params_to_state_dict(sd, _arch(out_channels=sd[
            'decoder.seg_layers.0.weight'].shape[0] + 1))
    with pytest.raises(ValueError, match='missing'):
        params_to_state_dict({k: v for k, v in sd.items()
                              if 'seg_layers' not in k}, spec)


def test_ts2d_no_native(monkeypatch):
    """``TS2D_NO_NATIVE``, read at the library's first load, takes the
    Python paths: the same bytes through Python's zlib."""
    import gzip

    from totalsegmentator2d_tpu_torch.io import native
    monkeypatch.setattr(native, '_checked', False)
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setenv('TS2D_NO_NATIVE', '1')
    assert not native.native_available()
    monkeypatch.delenv('TS2D_NO_NATIVE')
    assert not native.native_available()  # read once, at the first load
    data = np.arange(5000, dtype=np.int16).tobytes()
    packed = native.gzip_compress(data)
    assert gzip.decompress(packed) == data
    assert native.gzip_decompress(packed) == data
    monkeypatch.setattr(native, '_checked', False)
    assert native.native_available()
