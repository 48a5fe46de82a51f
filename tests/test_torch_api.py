"""End to end: the PyTorch port's ``TS2D.predict`` and CLI against the
reference package's on the same synthetic database (plan spacing
(1.2, 2.0), so the projection resamples on both axes) and the synthetic
3D CT asset. Masks agree on >= 99.9% of pixels at exact precision (the
tests/test_019_full_chain_parity.py bar) and >= 99% at fast precision
(bf16 U-Nets; tests/test_torch_engine.py says why); the saved files carry
the same names, geometry and Segment metadata, and the PNG visuals of one
result, rendered by both packages, agree (label visuals bit for bit,
intensity visuals within one gray level on every pixel and equal on
>= 99.9% of them). Sets that do not fuse (a
softmax group, groups that disagree on precision) run on per-model engines
in both packages."""

import gc
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from tests.conftest import asset_path
from tests.model_fixtures import build_group_set, build_model_dir
from tests.result_chain import check_result_against_chain
from totalsegmentator2d_tpu.api import TS2D as JaxTS2D
from totalsegmentator2d_tpu.io import read_image as jax_read_image
from totalsegmentator2d_tpu_torch.api import TS2D
from totalsegmentator2d_tpu_torch.cli import ts2d_entry_point
from totalsegmentator2d_tpu_torch.inference import ensemble_engine
from totalsegmentator2d_tpu_torch.io import native, read_image
from totalsegmentator2d_tpu_torch.ops.cuda.fused_block import \
    fused_norm_act_conv_cuda
from totalsegmentator2d_tpu_torch.ops.cuda.prefilter import bspline_prefilter_cuda
from totalsegmentator2d_tpu_torch.utils import trace

KEY = 'ts2d-v9-test'


@pytest.fixture(scope='module')
def model_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('zoo'))
    build_group_set(root, model=KEY, spacing=(1.2, 2.0))
    return root


@pytest.fixture(scope='module')
def results(model_root):
    path = asset_path('sample_s0521.nrrd')
    with JaxTS2D(key=KEY, use_remote=False, local=model_root,
                 batching=False) as tool:
        ref = tool.predict(path)
    with TS2D(key=KEY, use_remote=False, local=model_root,
              device='cpu') as tool:
        out = tool.predict(path)
    return ref, out


def test_predict_matches_reference(results):
    ref, out = results
    seg, ref_seg = out.get_segmentation(), ref.get_segmentation()
    assert seg.array.shape == ref_seg.array.shape == (133, 1, 53, 5)
    agree = float((seg.array == ref_seg.array).mean())
    assert agree >= 0.999, f'mask agreement {agree}'
    assert 0.0 < seg.array.mean() < 1.0
    assert seg.meta == ref_seg.meta
    assert seg.spacing == ref_seg.spacing and seg.origin == ref_seg.origin
    np.testing.assert_array_equal(seg.direction, ref_seg.direction)
    assert out.models == ref.models
    for m in ref.models:
        a, b = out.get_segmentation(m), ref.get_segmentation(m)
        assert a.array.shape == b.array.shape and a.meta == b.meta
    for ch in ('max', 'mean'):
        np.testing.assert_allclose(out.get_projection(ch).array,
                                   ref.get_projection(ch).array,
                                   rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize('variant', ['solo', 'batched', 'bucket',
                                     'no-merge', 'collapse'])
def test_result_arrays_are_the_numpy_chain(model_root, monkeypatch, variant):
    """The sample CT's Result through the fused set: every mask array the
    numpy unpack, place, per-model copies and restore_dimension gave, bit
    for bit, C-contiguous and its own memory, and the same Result as the
    numpy fallback's; through the solo, batched and bucket programs."""
    image = read_image(asset_path('sample_s0521.nrrd'))
    kw = {'no-merge': {'merge': False},
          'collapse': {'collapse': True}}.get(variant, {})
    with TS2D(key=KEY, use_remote=False, local=model_root, device='cpu',
              batching=variant == 'batched',
              pad_quantum=32 if variant == 'bucket' else None) as tool:
        res = check_result_against_chain(tool, image, monkeypatch, **kw)
    seg = res.get_segmentation(res.models[0])
    assert seg.array.shape[:-1] == ((133, 53) if variant == 'collapse'
                                    else (133, 1, 53))


@pytest.fixture(scope='module')
def wide_root(tmp_path_factory):
    """The set with 11 labels: its masks pack into two bytes a pixel, a
    layout the native pass takes (one byte a pixel comes back from the
    fetch with a stride the pass does not read, and numpy assembles it)."""
    root = str(tmp_path_factory.mktemp('wide'))
    build_group_set(root, model=KEY, spacing=(1.2, 2.0), labels_per_group={
        'cardiac': tuple(f'heart-{i}' for i in range(5)),
        'ribs': tuple(f'rib-{i}' for i in range(6))})
    return root


def _mapping(a):
    """The mapping under an array's chain of views, or None."""
    while isinstance(a, np.ndarray):
        a = a.base
    return a if isinstance(a, native._Mapping) else None


@pytest.mark.parametrize('batching', [False, True])
def test_result_arrays_are_the_mapped_pages(wide_root, monkeypatch,
                                            batching):
    """The sample CT's Result masks, the numpy chain's, live in the pages
    the engine's pages thread mapped while the scan ran, one mapping an
    array, and the pass that wrote them is counted as prefaulted."""
    image = read_image(asset_path('sample_s0521.nrrd'))
    monkeypatch.setattr(native, 'PAGES_MIN_BYTES', 0)   # small arrays too
    with TS2D(key=KEY, use_remote=False, local=wide_root, device='cpu',
              batching=batching) as tool:
        before = native.assembly_counts()['prefaulted']
        res = check_result_against_chain(tool, image, monkeypatch)
        assert native.assembly_counts()['prefaulted'] - before == 1
    maps = [_mapping(res.get_segmentation(m).array)
            for m in [None] + res.models]
    assert None not in maps and len(set(map(id, maps))) == len(maps)


def test_small_result_arrays_are_left_to_the_pass(wide_root, monkeypatch):
    """A Result whose every array is under PAGES_MIN_BYTES (a CT's): the
    dispatch gives the pages thread no job and the finish waits for none,
    the pass allocates the arrays, the numpy chain's masks, and nothing is
    counted as prefaulted."""
    image = read_image(asset_path('sample_s0521.nrrd'))
    released = _recording_mappings(monkeypatch)
    with TS2D(key=KEY, use_remote=False, local=wide_root,
              device='cpu') as tool:
        before = native.assembly_counts()['prefaulted']
        trace.enable()
        try:
            res = check_result_against_chain(tool, image, monkeypatch)
        finally:
            spans = trace.collect()
            trace.disable()
        assert native.assembly_counts()['prefaulted'] == before
    assert released == []
    assert not {'engine.pages', 'engine.pages_wait'} & {s.name
                                                        for s in spans}
    assert all(_mapping(res.get_segmentation(m).array) is None
               for m in [None] + res.models)


def _recording_mappings(monkeypatch):
    """The finalizers of every mapping the pages jobs make from now on."""
    released = []
    make = ensemble_engine.map_mask_arrays

    def spy(full, counts, merge):
        got = make(full, counts, merge)
        released.extend(a.base.released for a in [got[0], *got[1]]
                        if a is not None)
        return got
    monkeypatch.setattr(ensemble_engine, 'map_mask_arrays', spy)
    return released


@pytest.mark.parametrize('job', ['ran', 'queued'])
def test_a_failed_dispatch_releases_its_pages(wide_root, monkeypatch, job):
    """A dispatch that raises after its pages job was submitted, whether
    the job had mapped its arrays (they are dropped as soon as it ends,
    even while the error's traceback lives) or was still queued (it never
    runs): no mapping of it stays alive."""
    image = read_image(asset_path('sample_s0521.nrrd'))
    released = _recording_mappings(monkeypatch)
    monkeypatch.setattr(native, 'PAGES_MIN_BYTES', 0)
    with TS2D(key=KEY, use_remote=False, local=wide_root, device='cpu',
              batching=False) as tool:
        engine = tool._fused
        gate = threading.Event()
        if job == 'queued':   # the pages thread is busy until the failure
            engine._pager.submit(gate.wait, 30)

        def fail(arr):
            if job == 'ran':
                engine._pager.submit(lambda: None).result(30)
            raise RuntimeError('crop failed')
        monkeypatch.setattr(engine, '_crop', fail)
        with pytest.raises(RuntimeError, match='crop failed') as err:
            tool.predict(image)
        gate.set()
        engine._pager.submit(lambda: None).result(30)
        gc.collect()
        assert err.value is not None    # the traceback is still held
        assert len(released) == (1 + len(engine.output_label_counts)
                                 if job == 'ran' else 0)
        assert not any(f.alive for f in released)
        # and its slot is free again
        assert all(engine._pages_slots.acquire(blocking=False)
                   for _ in range(ensemble_engine.PAGES_AHEAD))


@pytest.mark.parametrize('freed', ['finished', 'dropped'])
def test_pages_ahead_of_their_finish_are_capped(wide_root, monkeypatch,
                                                freed):
    """Scans dispatched past ``PAGES_AHEAD`` unfinished ones get no pages
    job, and their pass allocates; a finish, or a handle dropped
    unfinished, frees its slot for the next dispatch. Every Result's
    masks are the same, mapped ahead or not."""
    monkeypatch.setattr(native, 'PAGES_MIN_BYTES', 0)
    ahead = ensemble_engine.PAGES_AHEAD
    rng = np.random.default_rng(4)
    arr = np.zeros((133, 53, 2), np.float32)
    arr[8:120, 5:50] = rng.normal(0, 300, (112, 45, 2))
    with TS2D(key=KEY, use_remote=False, local=wide_root,
              device='cpu') as tool:
        engine = tool._fused
        want = engine.finish_array(engine.predict_array_async(
            arr, (1.2, 2.0)))
        handles = [engine.predict_groups_async(arr, (1.2, 2.0))
                   for _ in range(ahead + 1)]
        assert [h.pages is not None for h in handles] == (
            [True] * ahead + [False])
        results = []
        if freed == 'finished':
            results.append(engine.finish_groups(handles.pop(0)))
        else:
            del handles[0]
            gc.collect()
        handles.append(engine.predict_groups_async(arr, (1.2, 2.0)))
        assert handles[-1].pages is not None
        assert engine.predict_groups_async(arr, (1.2, 2.0)).pages is None
        results += [engine.finish_groups(h) for h in handles]
        again = engine.predict_groups_async(arr, (1.2, 2.0))
        assert again.pages is not None
        results.append(engine.finish_groups(again))
    assert want.any()
    for merged, _ in results:
        np.testing.assert_array_equal(merged, want)
    mapped = [_mapping(merged) is not None for merged, _ in results]
    assert mapped == [True] * (freed == 'finished') + [True] * (ahead - 1) \
        + [False, True, True]


def test_a_closed_engine_refuses_a_dispatch(wide_root):
    with TS2D(key=KEY, use_remote=False, local=wide_root,
              device='cpu') as tool:
        engine = tool._fused
    with pytest.raises(RuntimeError, match='closed'):
        engine.predict_groups_async(np.zeros((8, 8, 2), np.float32),
                                    (1.2, 2.0))


def test_combine_segmentations_matches_reference_and_merge(results):
    from totalsegmentator2d_tpu.ops.annotations import \
        combine_segmentations as jax_combine
    from totalsegmentator2d_tpu_torch.ops.annotations import \
        combine_segmentations
    ref, out = results
    merged = combine_segmentations([out.get_segmentation(m) for m in out.models])
    ref_merged = jax_combine([ref.get_segmentation(m) for m in ref.models])
    assert merged.meta == ref_merged.meta
    assert float((merged.array == ref_merged.array).mean()) >= 0.999
    # the fused merge equals the reference tool's per-model combine
    np.testing.assert_array_equal(merged.array, out.get_segmentation().array)


def test_saved_files_match_reference(results, tmp_path):
    ref, out = results
    ref.save(str(tmp_path / 'ref'), name='case', models='all', content='file')
    out.save(str(tmp_path / 'port'), name='case', models='all', content='file')
    names = sorted(os.listdir(tmp_path / 'ref'))
    assert sorted(os.listdir(tmp_path / 'port')) == names
    assert 'case.seg.nrrd' in names and 'case_max.nrrd' in names
    for name in names:
        a = read_image(str(tmp_path / 'port' / name))
        b = jax_read_image(str(tmp_path / 'ref' / name))
        assert a.array.shape == b.array.shape and a.array.dtype == b.array.dtype
        assert a.spacing == b.spacing and a.meta == b.meta


def test_save_refuses_visuals(results, tmp_path):
    """Visuals are ported; save refuses what the reference refuses: PNG
    as the file format, an unknown content or naming."""
    out = results[1]
    with pytest.raises(ValueError, match='PNG'):
        out.save(str(tmp_path), ext='png')
    with pytest.raises(ValueError, match='export type'):
        out.save(str(tmp_path), content='png')
    with pytest.raises(ValueError, match='naming'):
        out.save(str(tmp_path), naming='case')
    assert out.device == torch.device('cpu')


def _jax_image(img):
    from totalsegmentator2d_tpu.io import MedicalImage as JaxImage
    return JaxImage(array=img.array, spacing=img.spacing, origin=img.origin,
                    direction=img.direction, is_vector=img.is_vector,
                    meta=dict(img.meta))


def _jax_result(out):
    """The reference package's Result holding the port result's images."""
    data = {'models': {
        k: {**v, 'input': _jax_image(v['input']),
            'segmentation': _jax_image(v['segmentation'])}
        for k, v in out.data['models'].items()}}
    data['input'] = _jax_image(out.data['input'])
    data['segmentation'] = _jax_image(out.data['segmentation'])
    data['projections'] = {k: _jax_image(v)
                           for k, v in out.data['projections'].items()}
    return JaxTS2D.Result(data)


def assert_visuals_match(port_dir, ref_dir, names):
    """Label visuals (RGB) bit for bit; intensity visuals (gray) within
    one gray level and equal on >= 99.9% of the pixels."""
    Image = pytest.importorskip('PIL.Image')
    for name in (n for n in names if n.endswith('.png')):
        a = np.asarray(Image.open(os.path.join(port_dir, name)))
        b = np.asarray(Image.open(os.path.join(ref_dir, name)))
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8, name
        if a.ndim == 3:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            diff = np.abs(a.astype(int) - b.astype(int))
            assert diff.max() <= 1, name
            assert (diff == 0).mean() >= 0.999, name


@pytest.mark.parametrize('content,models', [
    ('file', 'final'), ('visual', 'final'), ('all', 'final'), ('all', 'all'),
    ('visual', 'all')])
def test_save_contents_match_reference(results, tmp_path, content, models):
    """One result saved by both packages: the same file names for each
    content, and the same visuals."""
    _, out = results
    ref = _jax_result(out)
    ref.save(str(tmp_path / 'ref'), name='case', models=models,
             content=content)
    out.save(str(tmp_path / 'port'), name='case', models=models,
             content=content)
    names = sorted(os.listdir(tmp_path / 'ref'))
    assert sorted(os.listdir(tmp_path / 'port')) == names
    pngs = [n for n in names if n.endswith('.png')]
    assert bool(pngs) == (content != 'file')
    if content != 'file':
        assert 'case.seg.png' in pngs and 'case_max.png' in pngs
    if models == 'all' and content != 'file':
        # the per-model inputs are the 2-channel projections: one PNG each
        assert any(n.endswith('-ch1.png') for n in pngs)
    assert_visuals_match(str(tmp_path / 'port'), str(tmp_path / 'ref'), names)


def test_save_defaults_to_all(results, tmp_path):
    """save() writes files and visuals unless asked otherwise, as the
    reference's does."""
    _, out = results
    out.save(str(tmp_path), name='case')
    names = sorted(os.listdir(tmp_path))
    assert 'case.seg.nrrd' in names and 'case.seg.png' in names
    assert 'case.png' in names and 'case_mean.png' in names


def test_cli_on_cpu(model_root, tmp_path, monkeypatch):
    before = bspline_prefilter_cuda.launches
    monkeypatch.setattr(sys, 'argv', [
        'ts2d-torch', '-i', asset_path('sample_s0521.nrrd'), '-o',
        str(tmp_path), '--model', KEY, '--local', model_root,
        '--device', 'cpu', '--silent', '--no-fetch'])
    ts2d_entry_point()
    assert bspline_prefilter_cuda.launches == before
    assert sorted(os.listdir(tmp_path)) == [
        'sample_s0521.seg.nrrd', 'sample_s0521_max.nrrd',
        'sample_s0521_mean.nrrd']


def test_cli_visualize_on_cpu(model_root, tmp_path, monkeypatch):
    """--visualize adds the PNG visuals beside the files, with the
    reference CLI's names; the visuals run the prefilter's plain version
    here (no kernel launch on the CPU)."""
    before = bspline_prefilter_cuda.launches
    monkeypatch.setattr(sys, 'argv', [
        'ts2d-torch', '-i', asset_path('sample_s0521.nrrd'), '-o',
        str(tmp_path), '--model', KEY, '--local', model_root,
        '--device', 'cpu', '--silent', '--visualize', '--no-fetch'])
    ts2d_entry_point()
    assert bspline_prefilter_cuda.launches == before
    assert sorted(os.listdir(tmp_path)) == [
        'sample_s0521.seg.nrrd', 'sample_s0521.seg.png',
        'sample_s0521_max.nrrd', 'sample_s0521_max.png',
        'sample_s0521_mean.nrrd', 'sample_s0521_mean.png']


def test_device_default_needs_cuda(model_root, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TS2D(key=KEY, use_remote=False, local=model_root)


def test_not_ported_options_raise(model_root, tmp_path):
    """The remote registry and raster inputs are ported (the default
    use_remote=True loads a local model through it); a raster input that
    is not an image raises the reference's ValueError in both packages."""
    png = tmp_path / 'x.png'
    png.write_bytes(b'\0' * 16)
    with TS2D(key=KEY, local=model_root, device='cpu',
              fetch_remote=False) as tool:
        with pytest.raises(ValueError, match='Corrupt raster image file'):
            tool.predict(str(png))
    with JaxTS2D(key=KEY, use_remote=False, local=model_root,
                 batching=False) as tool:
        with pytest.raises(ValueError, match='Corrupt raster image file'):
            tool.predict(str(png))


def _predict_both(root, param=None):
    path = asset_path('sample_s0521.nrrd')
    with JaxTS2D(key=KEY, use_remote=False, local=root, batching=False,
                 param=param) as tool:
        ref = tool.predict(path)
        ref_fused = tool._fused is not None
    with TS2D(key=KEY, use_remote=False, local=root, device='cpu',
              param=param) as tool:
        before = fused_norm_act_conv_cuda.launches
        out = tool.predict(path)
        assert fused_norm_act_conv_cuda.launches == before
        assert (tool._fused is not None) == ref_fused
    return ref, out, ref_fused


def test_fast_predict_matches_reference(model_root):
    """precision 'fast' on every model: one fused bf16 ensemble in both
    packages. Measured agreement on the CPU: 0.99858."""
    ref, out, fused = _predict_both(model_root,
                                    {'nnu.predict.precision': 'fast'})
    assert fused
    seg, ref_seg = out.get_segmentation(), ref.get_segmentation()
    assert seg.array.shape == ref_seg.array.shape == (133, 1, 53, 5)
    agree = float((seg.array == ref_seg.array).mean())
    assert agree >= 0.99, f'mask agreement {agree}'
    assert 0.0 < seg.array.mean() < 1.0
    assert seg.meta == ref_seg.meta


def _set_precision(root, group, precision):
    for dirpath, _, files in os.walk(root):
        if 'model.json' in files and f'_{group}' in dirpath:
            path = os.path.join(dirpath, 'model.json')
            with open(path) as f:
                cfg = json.load(f)
            cfg['param']['nnu']['predict'] = {'precision': precision}
            with open(path, 'w') as f:
                json.dump(cfg, f)


@pytest.mark.parametrize('variant',
                         ['mixed-precision', 'softmax', 'fold-count'])
def test_per_model_path_matches_reference(tmp_path, variant):
    """Sets that do not fuse: one group 'fast' and one 'exact', softmax
    groups, or groups with different fold counts (which the ensemble
    engine refuses). Each model runs on its own engine; the merged result
    is the combined segmentations. Measured agreement on the CPU: 0.99904
    (mixed precision), 1.0 (softmax, fold count)."""
    root = str(tmp_path)
    if variant == 'fold-count':
        build_model_dir(root, model=KEY, group='cardiac', spacing=(1.2, 2.0),
                        labels=('heart', 'aorta'), task_id=101)
        build_model_dir(root, model=KEY, group='ribs', spacing=(1.2, 2.0),
                        labels=('rib-left-1', 'rib-right-1'), folds=(0, 1),
                        seed=1, task_id=102)
    else:
        build_group_set(root, model=KEY, spacing=(1.2, 2.0),
                        multilabel=(variant != 'softmax'))
    if variant == 'mixed-precision':
        _set_precision(root, 'ribs', 'fast')
    ref, out, fused = _predict_both(root)
    assert not fused
    seg, ref_seg = out.get_segmentation(), ref.get_segmentation()
    assert seg.array.shape == ref_seg.array.shape
    assert seg.meta == ref_seg.meta
    agree = float((seg.array == ref_seg.array).mean())
    assert agree >= (0.99 if variant == 'mixed-precision' else 0.999), \
        f'mask agreement {agree}'
    assert out.models == ref.models
    for m in ref.models:
        a, b = out.get_segmentation(m), ref.get_segmentation(m)
        assert a.array.shape == b.array.shape and a.meta == b.meta
        assert a.is_vector == b.is_vector
    assert sorted(out.get_projection()) == sorted(ref.get_projection())


def test_pad_quantum_predict_matches_reference(model_root):
    """TS2D(pad_quantum=32) on the sample CT: the bucket program in both
    packages. Measured agreement on the CPU: 1.0."""
    path = asset_path('sample_s0521.nrrd')
    with JaxTS2D(key=KEY, use_remote=False, local=model_root, batching=False,
                 pad_quantum=32) as tool:
        ref = tool.predict(path)
    with TS2D(key=KEY, use_remote=False, local=model_root, device='cpu',
              pad_quantum=32) as tool:
        out = tool.predict(path)
        assert [k for k in tool._fused._cache if k[0] == 'bucket']
    seg, ref_seg = out.get_segmentation(), ref.get_segmentation()
    assert seg.array.shape == ref_seg.array.shape == (133, 1, 53, 5)
    agree = float((seg.array == ref_seg.array).mean())
    assert agree >= 0.999, f'mask agreement {agree}'
    assert seg.meta == ref_seg.meta and seg.spacing == ref_seg.spacing
    with pytest.raises(ValueError, match='pad_quantum'):
        TS2D(key=KEY, use_remote=False, local=model_root, device='cpu',
             pad_quantum=0)


def test_pad_quantum_per_model_fallback_warns(tmp_path, capsys):
    """A set that does not fuse runs per-model engines, which keep the
    exact per-shape programs: pad_quantum warns, as in the reference."""
    build_group_set(str(tmp_path), model=KEY, spacing=(1.2, 2.0),
                    multilabel=False)
    with TS2D(key=KEY, use_remote=False, local=str(tmp_path), device='cpu',
              pad_quantum=32) as tool:
        assert tool._fused is None
        out = tool.predict(asset_path('sample_s0521.nrrd'))
    assert 'pad_quantum requires the fused ensemble engine' in \
        capsys.readouterr().err
    assert out.get_segmentation().array.shape[:3] == (133, 1, 53)
