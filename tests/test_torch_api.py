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

import json
import os
import sys

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
from totalsegmentator2d_tpu_torch.io import read_image
from totalsegmentator2d_tpu_torch.ops.cuda.fused_block import \
    fused_norm_act_conv_cuda
from totalsegmentator2d_tpu_torch.ops.cuda.prefilter import bspline_prefilter_cuda

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
