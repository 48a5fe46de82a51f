"""End to end: the PyTorch port's ``TS2D.predict`` and CLI against the
reference package's on the same synthetic database (plan spacing
(1.2, 2.0), so the projection resamples on both axes) and the synthetic
3D CT asset. Masks agree on >= 99.9% of pixels (the
tests/test_019_full_chain_parity.py bar); the saved files carry the same
names, geometry and Segment metadata."""

import os
import sys

import numpy as np
import pytest
import torch

from tests.conftest import asset_path
from tests.model_fixtures import build_group_set
from totalsegmentator2d_tpu.api import TS2D as JaxTS2D
from totalsegmentator2d_tpu.io import read_image as jax_read_image
from totalsegmentator2d_tpu_torch.api import TS2D
from totalsegmentator2d_tpu_torch.cli import ts2d_entry_point
from totalsegmentator2d_tpu_torch.io import read_image
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
    out.save(str(tmp_path / 'port'), name='case', models='all')
    names = sorted(os.listdir(tmp_path / 'ref'))
    assert sorted(os.listdir(tmp_path / 'port')) == names
    assert 'case.seg.nrrd' in names and 'case_max.nrrd' in names
    for name in names:
        a = read_image(str(tmp_path / 'port' / name))
        b = jax_read_image(str(tmp_path / 'ref' / name))
        assert a.array.shape == b.array.shape and a.array.dtype == b.array.dtype
        assert a.spacing == b.spacing and a.meta == b.meta


def test_save_refuses_visuals(results, tmp_path):
    with pytest.raises(NotImplementedError):
        results[1].save(str(tmp_path), content='all')


def test_cli_on_cpu(model_root, tmp_path, monkeypatch):
    before = bspline_prefilter_cuda.launches
    monkeypatch.setattr(sys, 'argv', [
        'ts2d-torch', '-i', asset_path('sample_s0521.nrrd'), '-o',
        str(tmp_path), '--model', KEY, '--local', model_root,
        '--device', 'cpu', '--silent'])
    ts2d_entry_point()
    assert bspline_prefilter_cuda.launches == before
    assert sorted(os.listdir(tmp_path)) == [
        'sample_s0521.seg.nrrd', 'sample_s0521_max.nrrd',
        'sample_s0521_mean.nrrd']


def test_device_default_needs_cuda(model_root, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TS2D(key=KEY, use_remote=False, local=model_root)


def test_not_ported_options_raise(model_root):
    with pytest.raises(NotImplementedError, match='remote'):
        TS2D(key=KEY, local=model_root, device='cpu')
    with pytest.raises(RuntimeError, match='Failed to load'):
        TS2D(key=KEY, use_remote=False, local=model_root, device='cpu',
             param={'nnu.predict.precision': 'fast'})
