"""The phantom, the plain reference and its pieces, and the reference
against the port at a small size."""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from benchmark import check, phantom, reference


def test_phantom_is_the_same_for_the_same_seed():
    shapes = [[12, 20, 24], [9, 20, 24]]
    a = phantom.volumes(shapes, 2 ** 31 + 5, 'cpu')
    b = phantom.volumes(shapes, 2 ** 31 + 5, 'cpu')
    c = phantom.volumes(shapes, 2 ** 31 + 6, 'cpu')
    assert [v.shape for v in a] == [(12, 20, 24), (9, 20, 24)]
    assert all(v.dtype == np.int16 for v in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert a[0].min() == -1024 and 300 < a[0].max() <= 3071   # air, bone


def test_phantom_chunks_make_the_same_volume(monkeypatch):
    gen = torch.Generator().manual_seed(3)
    whole = phantom.torso_ct((10, 16, 16), gen, 'cpu')
    monkeypatch.setattr(phantom, 'CHUNK', 4)
    gen = torch.Generator().manual_seed(3)
    chunked = phantom.torso_ct((10, 16, 16), gen, 'cpu')
    assert whole.shape == chunked.shape
    # the noise is drawn chunk by chunk, the geometry is the same
    assert np.array_equal(whole == -1024, chunked == -1024)


def test_linear_resize_is_the_oracles():
    x = np.random.default_rng(0).standard_normal((3, 17, 23)).astype(np.float32)
    for shape in ((30, 40), (9, 11), (17, 23)):
        ny, nx = shape
        cy = np.clip((np.arange(ny) + 0.5) * (17 / ny) - 0.5, 0, 16)
        cx = np.clip((np.arange(nx) + 0.5) * (23 / nx) - 0.5, 0, 22)
        grid = np.meshgrid(cy, cx, indexing='ij')
        want = np.stack([ndi.map_coordinates(c.astype(np.float64), grid,
                                             order=1, mode='mirror')
                         for c in x])
        got = reference.resize_linear(torch.from_numpy(x), shape).numpy()
        assert np.abs(got - want).max() < 1e-5


def test_tf32_and_fp8_rounding():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -12, -3.0,
                      1e-30, 0.0])
    t = reference.round_tf32(x)
    assert t[0] == 1.0 and t[1] == 1.0 and t[3] == -3.0
    assert t[2] == 1 + 2 ** -10
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    assert (reference.round_tf32(y) - y).abs().max() <= y.abs().max() * 2 ** -11
    f = reference.round_fp8(y)
    rel = ((f - y).abs() / y.abs().clamp_min(1e-3)).median()
    assert 1e-3 < rel < 0.1


def test_tiles_of_the_solo_mix():
    counts = [reference.tile_count((z, 512), (1.25, 0.78),
                                   (256, 256), (1.5, 1.5), 0.5)
              for z in (300, 340, 380, 420, 460, 500)]
    assert counts == [2, 4, 4, 4, 4, 6]


def test_flip_numbers():
    logits = torch.tensor([[[-3.0, 0.1], [2.0, -0.05]]])
    mask = np.array([[[0, 0], [1, 1]]], np.uint8)
    g = check.scan_gaps(mask, logits)
    assert g['flips'] == 2 and g['worst'] == pytest.approx(0.1)
    assert check.scan_gaps(mask[:, :1], logits)['worst'] == float('inf')
    checks = check.verdict({'worst_flip_logit': float('inf'),
                            'flip_share': 0.5, 'scans_compared': 1},
                           {'worst_flip_logit': 1.0, 'flip_share': 0.1}, 0, 1)
    assert checks['worst_flip_logit']['value'] == check.INFINITE
    assert not check.passes(checks)


@pytest.mark.parametrize('cell', ['ct-exact.solo', 'ct-fast.solo'])
def test_reference_against_the_port(run_small, cell):
    """The port's masks from a run of the cell at a small size against the
    reference: exact agrees voxel for voxel, fast within its bf16 flips."""
    code, line, err = run_small(cell, seed=2 ** 31 + 11)
    assert code == 0, err
    assert line['correct'], line['check']
    c = line['check']
    assert c['volumes_unchecked']['value'] == 0
    assert 0.005 < line['reference_foreground'] < 0.05
    if cell.startswith('ct-exact'):
        assert c['flip_share']['value'] < 1e-5
    else:
        assert c['worst_flip_logit']['value'] < 0.2
