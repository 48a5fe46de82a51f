"""Native 2D chest radiographs through the port's normal path on the CPU: a
local five-group, one-channel multilabel set (the tsxr set's structure at a
small architecture) read by ``TS2D(key=...)``, whose ``TS2D.predict`` on
seeded 12-bit radiographs with a zero collimation border is held against
the independent oracle ``tests/reference_chain.predict`` (numpy, scipy and
plain torch in float32), the ``Result``'s layout, and the spans and byte
count the radiograph path records."""

import os
import threading

import numpy as np
import pytest
import torch

from tests import reference_chain as RC
from tests.result_chain import check_result_against_chain
from tests.model_fixtures import build_group_set
from tests.torch_mirror import TorchPlainConvUNet, make_spec
from totalsegmentator2d_tpu_torch.api import TS2D
from totalsegmentator2d_tpu_torch.inference import wire
from totalsegmentator2d_tpu_torch.io import MedicalImage, native
from totalsegmentator2d_tpu_torch.ops.annotations import get_annotation_meta
from totalsegmentator2d_tpu_torch.utils import trace

KEY = 'tsxr-v9-test'
GROUPS = ('cardiac', 'muscles', 'organs', 'ribs', 'vertebrae')
LABELS = {g: tuple(f'{g}-{i}' for i in range(n))
          for g, n in zip(GROUPS, (3, 2, 2, 3, 4))}
# (rows, cols) and spacing (x, y) in mm: a crop of one 64^2 tile at the
# 1.5 mm plan, and two of several tiles
IMAGES = [((150, 170), (0.5, 0.5)), ((420, 500), (0.4, 0.4)),
          ((300, 260), (0.55, 0.6))]
# the exact program flipped no voxel of these images (nor did it in the
# benchmark's 2D comparisons); the bar leaves room for a flip where the two
# float32 chains round a logit to either side of 0, and none farther out.
# The fast program's bf16 U-Nets flip 0.15-0.17% of the voxels here.
EXACT_FLIP_LOGIT = 1e-3


@pytest.fixture(scope='module', autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _recorder_off():
    trace.disable()
    yield
    trace.disable()


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('zoo'))
    build_group_set(root, model=KEY, groups=GROUPS, labels_per_group=LABELS,
                    channels=('xray',))
    return root


def radiograph(shape, seed):
    """A 12-bit MONOCHROME2 chest radiograph (int16): a body, two darker
    lungs, a brighter spine and noise inside a zero collimation border of
    seeded width."""
    rng = np.random.default_rng(seed)
    h, w = shape
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    y, x = y / h - 0.5, x / w - 0.5
    img = 600.0 + 1800.0 * (x ** 2 / 0.2 + y ** 2 / 0.3 < 1)
    for side in (-0.2, 0.2):
        img -= 1100.0 * ((x - side) ** 2 / 0.015 + y ** 2 / 0.08 < 1)
    img += 900.0 * (np.abs(x) < 0.03)
    img += rng.normal(0.0, 120.0, shape)
    out = np.zeros(shape, np.int16)
    t, b = rng.integers(3, h // 10, 2)
    lft, r = rng.integers(3, w // 10, 2)
    out[t:h - b, lft:w - r] = np.clip(img[t:h - b, lft:w - r], 1, 4095)
    return out


def oracle_nets(tool, id_):
    """The oracle's torch networks of one model, from its checkpoints."""
    model = tool.models[id_]
    nets = []
    for _, fold_dir in model.fold_dirs:
        path = os.path.join(fold_dir,
                            f'checkpoint_{model.checkpoint_name}.pth')
        net = TorchPlainConvUNet(make_spec(
            in_channels=1, out_channels=model.spec.arch.out_channels,
            n_stages=4))
        net.load_state_dict(torch.load(path, map_location='cpu',
                                       weights_only=False)['network_weights'])
        nets.append(net.eval())
    return nets


@pytest.fixture(scope='module', params=['exact', 'fast'])
def predicted(request, root):
    """{(image index): (input array, spacing, Result)} and the oracle's
    per-group (masks, logits, bbox) of each image."""
    param = {'nnu.predict.precision': request.param}
    out = {}
    with TS2D(key=KEY, use_remote=False, fetch_remote=False, local=root,
              device='cpu', param=param) as tool:
        assert tool._fused is not None
        for i, (shape, spacing) in enumerate(IMAGES):
            arr = radiograph(shape, 2 ** 31 + i)
            res = tool.predict(MedicalImage(array=arr, spacing=spacing))
            ref = [RC.predict(arr[..., None].astype(np.float32),
                              spacing[::-1], tool.models[id_].spec,
                              oracle_nets(tool, id_))
                   for id_ in tool.models]
            out[i] = (arr, spacing, res, ref)
        ids = list(tool.models)
    return request.param, ids, out


def test_predict_matches_the_oracle(predicted):
    precision, _, out = predicted
    for i, (arr, _, res, ref) in out.items():
        seg = res.get_segmentation().array
        want = np.concatenate([r[0] for r in ref], axis=-1)
        assert seg.shape == want.shape == arr.shape + (14,)
        agree = float((seg == want).mean())
        assert agree >= (0.999 if precision == 'exact' else 0.99), agree
        assert 0.0 < want.mean() < 1.0
        if precision != 'exact':
            continue
        at = 0
        for full, logits, ((y0, y1), (x0, x1)) in ref:
            n = full.shape[-1]
            got = seg[..., at:at + n]
            flipped = got != full
            assert not flipped[:y0].any() and not flipped[y1:].any()
            assert not flipped[:, :x0].any() and not flipped[:, x1:].any()
            worst = np.abs(logits)[flipped[y0:y1, x0:x1]]
            assert worst.size == 0 or worst.max() < EXACT_FLIP_LOGIT, i
            at += n


def test_a_multi_tile_crop_and_a_one_tile_crop(predicted):
    _, ids, out = predicted
    tiles = []
    for arr, spacing, _, ref in out.values():
        (y0, y1), (x0, x1) = ref[0][2]
        rs = [round(n * s / 1.5) for n, s in zip((y1 - y0, x1 - x0),
                                                  spacing[::-1])]
        tiles.append(np.prod([len(RC.sliding_steps(max(n, 64), 64, 0.5))
                              for n in rs]))
    assert min(tiles) == 1 and max(tiles) > 1, tiles


def test_result_layout(predicted):
    _, ids, out = predicted
    assert [i.rsplit('_', 1)[1] for i in ids] == list(GROUPS)
    for arr, spacing, res, _ in out.values():
        assert res.models == ids
        merged = res.get_segmentation()
        assert merged.spacing == spacing
        names = [m['Name'] for _, m in
                 sorted(get_annotation_meta(merged, fetch=False).items())]
        assert names == [n for g in GROUPS for n in LABELS[g]]
        at = 0
        for id_, group in zip(ids, GROUPS):
            seg = res.get_segmentation(id_)
            n = len(LABELS[group])
            np.testing.assert_array_equal(seg.array,
                                          merged.array[..., at:at + n])
            assert seg.spacing == spacing
            at += n
        assert list(res.data['projections']) == ['ch0']
        np.testing.assert_array_equal(res.get_projection('ch0').array, arr)
        assert res.get_input().array is arr


@pytest.mark.parametrize('batching,merge', [(False, True), (True, True),
                                            (False, False)])
def test_result_arrays_are_the_numpy_chain(root, monkeypatch, batching,
                                           merge):
    """A seeded radiograph's Result: every mask array the numpy unpack,
    place and per-model copies gave, bit for bit, C-contiguous and its own
    memory, and the same Result as the numpy fallback's."""
    img = MedicalImage(array=radiograph(IMAGES[0][0], 2 ** 31 + 5),
                       spacing=IMAGES[0][1])
    with TS2D(key=KEY, use_remote=False, fetch_remote=False, local=root,
              device='cpu', batching=batching) as tool:
        res = check_result_against_chain(tool, img, monkeypatch, merge=merge)
        assert res.models == list(tool.models)
    assert all(res.get_segmentation(i).array.shape
               == IMAGES[0][0] + (len(LABELS[g]),)
               for i, g in zip(res.models, GROUPS))


@pytest.mark.parametrize('merge', [True, False])
def test_result_arrays_are_the_mapped_pages(root, monkeypatch, merge):
    """A radiograph's Result masks, the numpy chain's, are the arrays the
    pages thread mapped for them while the scan ran (a mapping each), and
    the pass that wrote them is counted as prefaulted."""
    img = MedicalImage(array=radiograph(IMAGES[2][0], 2 ** 31 + 6),
                       spacing=IMAGES[2][1])
    # these small arrays as a detector-size radiograph's, all mapped ahead
    monkeypatch.setattr(native, 'PAGES_MIN_BYTES', 0)
    with TS2D(key=KEY, use_remote=False, fetch_remote=False, local=root,
              device='cpu', batching=False) as tool:
        before = native.assembly_counts()['prefaulted']
        res = check_result_against_chain(tool, img, monkeypatch, merge=merge)
        assert native.assembly_counts()['prefaulted'] - before == 1
    arrays = [res.get_segmentation(i).array for i in res.models]
    if merge:
        arrays.append(res.get_segmentation().array)
    assert all(isinstance(a.base, native._Mapping) for a in arrays)
    assert len({id(a.base) for a in arrays}) == len(arrays)


@pytest.fixture
def fetched(monkeypatch):
    """Bytes copied to the host by the engine's fetches (every fetch of
    a result goes through ``wire.to_host``)."""
    got, lock = [], threading.Lock()
    to_host = wire.to_host

    def spy(dev, *args, **kw):
        host = to_host(dev, *args, **kw)
        with lock:
            got.append(host.nbytes)
        return host
    monkeypatch.setattr(wire, 'to_host', spy)
    return got


@pytest.mark.parametrize('batching,compact', [(True, True), (False, True),
                                              (True, False), (False, False)])
def test_spans_and_the_fetch_byte_count(root, fetched, monkeypatch,
                                        batching, compact):
    """A recorded radiograph predict has ``api.input2d`` under
    ``api.project`` and ``api.split`` under ``api.assemble``, and its
    ``engine.fetch`` spans carry the bytes fetched (the speculative prefix
    of a second scan of one shape included)."""
    monkeypatch.setenv('TS2D_COMPACT', '1' if compact else '0')
    monkeypatch.setattr(native, 'PAGES_MIN_BYTES', 0)
    img = MedicalImage(array=radiograph(IMAGES[1][0], 2 ** 31 + 9),
                       spacing=IMAGES[1][1])
    with TS2D(key=KEY, use_remote=False, fetch_remote=False, local=root,
              device='cpu', batching=batching) as tool:
        assert tool._fused.compact_wire == compact
        tool.predict(img)
        fetched.clear()
        trace.enable()
        for _ in range(2):
            tool.predict(img)
        spans = trace.collect()
    by_id = {s.id: s for s in spans}
    for name, parent in (('api.input2d', 'api.project'),
                         ('api.split', 'api.assemble')):
        mine = [s for s in spans if s.name == name]
        assert len(mine) == 2, name
        assert all(by_id[s.parent].name == parent for s in mine), name
    assert 'api.reorient' not in {s.name for s in spans}
    fetch = [s for s in spans if s.name == 'engine.fetch']
    assert len(fetch) == 2 and all(s.nbytes > 0 for s in fetch)
    assert sum(s.nbytes for s in fetch) == sum(fetched)
    # each scan's Result pages, merged and per model, mapped on the pages
    # thread and waited for in its finish
    scans = {s.scans for s in spans if s.name == 'api.predict'}
    frame = IMAGES[1][0][0] * IMAGES[1][0][1] * sum(map(len, LABELS.values()))
    for name in ('engine.pages', 'engine.pages_wait'):
        mine = [s for s in spans if s.name == name]
        assert {s.scans for s in mine} == scans and len(mine) == 2, name
    assert all(s.nbytes == 2 * frame for s in spans
               if s.name == 'engine.pages')
    assert all(s.nbytes == 0 for s in spans
               if s.name not in ('engine.fetch', 'engine.pages'))
