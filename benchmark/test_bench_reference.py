"""The phantoms, the plain reference and its pieces, the reference's 2D
chain against the CPU tests' oracle, and the reference against the port at
a small size."""

import hashlib
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from benchmark import check, database, phantom, reference


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


# phantom.volumes of a small CT mix (two chunks in the last volume), as the
# benchmark drew it before radiographs joined the mixes: sha256 of the
# volumes' bytes in order, by seed
CT_DIGESTS = {
    2 ** 31 + 5:
        'dd1eca61eef73f276eb855811fa264abadf856edde81241112edf8db27149a02',
    7: 'af2335b31f62088ac7df541ca6731155ddfe739e6504e5cdfe74f808b0d7ce23',
}


@pytest.mark.parametrize('seed', sorted(CT_DIGESTS))
def test_ct_phantoms_are_the_same_bytes_as_before(seed):
    vols = phantom.volumes([[12, 20, 24], [9, 20, 24], [70, 16, 18]], seed,
                           'cpu')
    h = hashlib.sha256()
    for v in vols:
        h.update(v.tobytes())
    assert h.hexdigest() == CT_DIGESTS[seed]


def _border(image):
    """(top, bottom, left, right) widths of the zero border."""
    (y0, y1), (x0, x1) = reference.nonzero_bbox(image[..., None])
    return y0, image.shape[0] - y1, x0, image.shape[1] - x1


def test_radiograph_phantom():
    shapes = [[240, 200], [130, 170]]
    a = phantom.volumes(shapes, 2 ** 31 + 5, 'cpu')
    b = phantom.volumes(shapes, 2 ** 31 + 5, 'cpu')
    c = phantom.volumes(shapes, 2 ** 31 + 6, 'cpu')
    assert [v.shape for v in a] == [(240, 200), (130, 170)]
    assert all(v.dtype == np.int16 for v in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert _border(a[0]) != _border(c[0])      # the border is seeded too
    for img in a:
        assert img.min() == 0 and img.max() <= 4095
        t, bt, l, r = _border(img)
        h, w = img.shape
        assert min(t, bt, l, r) >= 1
        # exactly 0 outside, never 0 inside the collimation
        assert (img[t:h - bt, l:w - r] > 0).all()
        assert (img == 0).sum() == h * w - (h - t - bt) * (w - l - r)
    # MONOCHROME2: the spine bright, the lungs dark, the exposure darkest
    img = a[0]
    spine = np.median(img[100:140, 98:102])
    lung = np.median(img[95:110, 60:70])
    exposure = np.median(img[20:40, 10:20])
    assert spine > 2000 > 1000 > lung > 400 > exposure > 0


def test_radiograph_phantom_chunks_make_the_same_geometry(monkeypatch):
    gen = torch.Generator().manual_seed(3)
    whole = phantom.chest_xr((70, 60), gen, 'cpu')
    monkeypatch.setattr(phantom, 'ROWS', 16)
    gen = torch.Generator().manual_seed(3)
    chunked = phantom.chest_xr((70, 60), gen, 'cpu')
    assert whole.shape == chunked.shape
    # the noise is drawn chunk by chunk, the geometry is the same
    assert np.array_equal(whole == 0, chunked == 0)
    assert np.array_equal(whole > 2300, chunked > 2300)


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


@pytest.mark.parametrize('cell', ['ct-exact.solo', 'ct-fast.cohort8-mixed'])
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


def _oracle_spec(config, labels):
    pre = SimpleNamespace(
        patch_size=tuple(config['patch_size']),
        spacing=tuple(config['spacing']),
        normalization_schemes=[config['normalization']],
        intensity_properties=[None], use_mask_for_norm=[False])
    return SimpleNamespace(preprocess=pre, multilabel=True,
                           arch=SimpleNamespace(out_channels=labels),
                           allowed_mirroring_axes=tuple(config['mirror_axes']))


@pytest.mark.parametrize('mm', [0.4, 0.6])
def test_2d_reference_is_the_oracles(small_root, mm):
    """The reference's native 2D chain against the CPU tests' independent
    oracle (tests/reference_chain.py), same weights, on a chest radiograph
    at an X-ray's reduction to the 1.5 mm plan (3.75x, 2.5x): the crop to
    its collimation, logits and decisions."""
    from tests import reference_chain
    with open(os.path.join(small_root, 'benchmark', 'configs',
                           'ts2d-v2-exact.json')) as f:
        config = json.load(f)
    config.update(channels=['xray'], head_bias_shift=-1.0)
    gen = torch.Generator().manual_seed(config['weight_seed'])
    groups = []
    for group in config['groups']:
        net = reference.RefUNet(database.arch(config, group))
        net.load_state_dict(reference.init_state(
            database.arch(config, group), gen, config['head_bias_shift'],
            'cpu'))
        groups.append([net.eval()])
    image = phantom.volumes([[480, 560]], 2 ** 31 + 17, 'cpu')[0]
    arr, spacing_yx = reference.model_input(image, [mm, mm])
    got = list(reference.group_logits(
        arr, spacing_yx, groups, patch=tuple(config['patch_size']),
        plan_spacing=tuple(config['spacing']), step=config['tile_step_size'],
        mirror_axes=tuple(config['mirror_axes'])))
    decided = 0
    for (net,), labels, ref in zip(groups, config['groups'].values(), got):
        with torch.no_grad():
            seg, lg, ((y0, y1), (x0, x1)) = reference_chain.predict(
                arr, spacing_yx, _oracle_spec(config, labels),
                [lambda x, n=net: n(x)])
        assert (y0, x0) != (0, 0) and (y1, x1) != image.shape
        inside = ref[y0:y1, x0:x1]
        assert torch.isinf(ref).sum() == (image.size - lg.shape[0]
                                          * lg.shape[1]) * labels
        assert float((inside - torch.from_numpy(lg)).abs().max()) < 1e-4
        assert np.array_equal((ref > 0).numpy(), seg.astype(bool))
        decided += int(seg.sum())
    assert decided > 0
