"""The PyTorch port's native host library (csrc/ts2dio.cc through
totalsegmentator2d_tpu_torch/io/native.py), built with g++ and zlib at first
use, on the CPU: gzip and zlib round trips and interop with Python's zlib,
corrupt input, concatenated gzip members, the Python fallback, streams
driven through many zlib windows (a build with a 4 KiB window stands in for
payloads of 4 GiB and more), the fused MAX + MEAN projection: its mean
bit for bit the port's float64 numpy mean and its device projection, within
one float32 ulp of the reference package's, on any number of threads, and
the threads each call takes; and the one-pass assembly of a scan's masks
into its Result's arrays, bit for bit numpy's unpack, place and per-group
copies on any number of threads, the cores it shares with the
projection, and the populated mappings it can write into."""

import ctypes
import gc
import gzip
import os
import sys
import threading
import zlib
from concurrent.futures import Future
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from totalsegmentator2d_tpu_torch.io import native
from totalsegmentator2d_tpu_torch.ops import projection
from totalsegmentator2d_tpu_torch.ops.cuda import build

PORT = os.path.dirname(os.path.abspath(native.__file__ + '/..'))


@pytest.fixture(scope='module')
def lib():
    if not native.native_available():
        pytest.fail('the native host library did not build (g++ and zlib '
                    'are needed)')
    return native._load()


@pytest.fixture(scope='module')
def small_window_lib():
    """The library built with 4 KiB zlib windows."""
    return native.load_library(['TS2DIO_CHUNK=4096'])


def _data(n, seed=0, hi=255):
    rng = np.random.default_rng(seed)
    return rng.integers(0, hi, size=n).astype(np.uint8).tobytes()


def test_library_is_built_in_the_package(lib):
    path = lib._name
    assert os.path.dirname(path) == build.BUILD_DIR
    assert build.BUILD_DIR.startswith(PORT + os.sep)
    assert os.path.basename(path).startswith('libts2dio-')
    assert '_native' not in path
    assert int(lib.ts2dio_abi_version()) == native.ABI_VERSION == 5
    assert lib.ts2dio_project_max_mean_i16_mt.argtypes[-1] is ctypes.c_longlong
    assert lib.ts2dio_assemble_masks_mt.argtypes[-1] is ctypes.c_longlong
    assert len(lib.ts2dio_assemble_masks_mt.argtypes) == 14
    # sources() still lists the CUDA kernels only
    assert build.sources() == ['fused_block', 'prefilter']


def test_roundtrip_gzip(lib):
    data = _data(300_000) + b'\0' * 100_000
    assert native.gzip_decompress(native.gzip_compress(data, level=1)) == data


def test_interop_with_python_zlib(lib):
    data = _data(100_000, hi=64)
    assert zlib.decompress(native.gzip_compress(data), wbits=47) == data
    c = zlib.compressobj(6, zlib.DEFLATED, 31)
    assert native.gzip_decompress(c.compress(data) + c.flush()) == data
    assert native.gzip_decompress(zlib.compress(data)) == data
    assert zlib.decompress(native.zlib_compress(data)) == data


def test_corrupt_input_raises(lib):
    with pytest.raises(Exception):
        native.gzip_decompress(b'\x1f\x8b' + b'garbage-not-a-stream')
    truncated = native.gzip_compress(_data(50_000))[:-100]
    with pytest.raises(Exception):
        native.gzip_decompress(truncated)


def test_two_member_gzip(lib):
    """Concatenated members: the bound from the last member's ISIZE is too
    small, the native inflate fails rather than truncate, and the Python
    fallback reads both members."""
    a, b = _data(50_000, 1), _data(30_000, 2)
    multi = gzip.compress(a) + gzip.compress(b)
    bound = lib.ts2dio_inflate_bound(multi, len(multi))
    assert bound == len(b)
    buf = np.empty(bound, np.uint8)
    assert lib.ts2dio_inflate(multi, len(multi), buf.ctypes.data, bound) == -1
    assert native.gzip_decompress(multi) == a + b
    # with room for both, the native inflate reads both members itself
    big = np.empty(len(a) + len(b), np.uint8)
    got = lib.ts2dio_inflate(multi, len(multi), big.ctypes.data, big.size)
    assert got == len(a) + len(b) and big.tobytes() == a + b


def test_declared_size(lib):
    """A size a header declares sizes the buffer (no counting pass for a
    zlib stream); a claim too small falls back to Python, one no stream
    could reach is ignored: the bytes are the stream's either way."""
    data = _data(200_000, 7, hi=40)
    packed = zlib.compress(data)
    for size in (len(data), len(data) - 1, 10**15):
        assert native.gzip_decompress(packed, size=size) == data


def test_fallback_equivalence(lib, monkeypatch):
    data = _data(50_000, hi=16)
    gz, zl = native.gzip_compress(data), native.zlib_compress(data)
    vol = np.random.default_rng(3).integers(-1024, 3000, (7, 9, 11)).astype(np.int16)
    native_out = projection.project_arrays_np(vol, ('max', 'mean'), 1)
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_checked', True)
    assert not native.native_available()
    assert native.gzip_decompress(gz) == data
    assert native.gzip_decompress(zl) == data
    assert gzip.decompress(native.gzip_compress(data)) == data
    assert zlib.decompress(native.zlib_compress(data)) == data
    assert native.project_max_mean(vol) is None
    fallback = projection.project_arrays_np(vol, ('max', 'mean'), 1)
    np.testing.assert_array_equal(native_out[0], fallback[0].astype(np.float32))
    np.testing.assert_array_equal(native_out[1], fallback[1])


def test_unavailable_library_warns_once(monkeypatch, capsys):
    def refuse(defines=()):
        raise RuntimeError('no compiler here')
    monkeypatch.setattr(native, 'load_library', refuse)
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_checked', False)
    assert not native.native_available()
    assert not native.native_available()
    err = capsys.readouterr().err
    assert err.count('native host library is not available') == 1
    assert 'no compiler here' in err


@pytest.mark.parametrize('kind', ['gzip', 'zlib', 'two-member', 'counted'])
def test_streams_through_many_windows(small_window_lib, monkeypatch, kind):
    """Streams longer than the zlib window go through in windows, in and
    out (the 4 GiB case at a 4 KiB window): the bytes equal Python's."""
    monkeypatch.setattr(native, '_lib', small_window_lib)
    monkeypatch.setattr(native, '_checked', True)
    data = _data(300_000, 5, hi=32) + _data(100_000, 6)
    if kind == 'gzip':
        packed = native.gzip_compress(data, level=6)
        assert gzip.decompress(packed) == data
    elif kind == 'zlib':
        packed = native.zlib_compress(data, level=6)
        assert zlib.decompress(packed) == data
    elif kind == 'two-member':
        packed = gzip.compress(data[:123_457]) + gzip.compress(data[123_457:])
    else:  # a zlib stream has no ISIZE: the bound is a counting pass
        packed = zlib.compress(data, 9)
        assert small_window_lib.ts2dio_inflate_bound(packed, len(packed)) == len(data)
    bound = len(data)
    buf = np.empty(bound, np.uint8)
    got = small_window_lib.ts2dio_inflate(packed, len(packed), buf.ctypes.data, bound)
    assert got == len(data) and buf.tobytes() == data
    assert native.gzip_decompress(packed) == data
    # a destination one byte short fails, never truncates
    assert small_window_lib.ts2dio_inflate(packed, len(packed), buf.ctypes.data,
                                           bound - 1) == -1


def _columns(ny, sums):
    """A (1, ny, len(sums)) int16 volume whose columns sum to ``sums``."""
    sums = np.asarray(sums, np.int64)
    base, rem = np.divmod(sums, ny)
    vol = np.repeat(base[None, :], ny, axis=0)
    vol += (np.arange(ny)[:, None] < rem[None, :])
    return vol.astype(np.int16)[None]


@pytest.mark.parametrize('ny', [3, 7, 49, 300, 400])
def test_mean_divides(lib, ny):
    """sum / ny in double, rounded once: bit for bit numpy's float64 mean
    and the device projection's, at sums where the reference's multiply
    by 1/ny rounds the double differently."""
    s = np.arange(-ny * 3000, ny * 3000, dtype=np.int64)
    differ = s[(s / ny) != (s * (1.0 / ny))]
    assert differ.size > 0
    sums = differ[np.linspace(0, differ.size - 1, 256).astype(int)]
    vol = _columns(ny, sums)
    mx, mn = native.project_max_mean(vol)
    expect = (sums / ny).astype(np.float32)
    np.testing.assert_array_equal(mn[0], expect)
    np.testing.assert_array_equal(
        mn, vol.mean(axis=1, dtype=np.float64).astype(np.float32))
    dev = projection.project_array(torch.from_numpy(vol), 'mean', 1)
    np.testing.assert_array_equal(mn, dev.squeeze(1).numpy())
    np.testing.assert_array_equal(mx, vol.max(axis=1).astype(np.float32))


def _serial(lib, vol):
    """The one-thread entry point (ABI 2's)."""
    nz, ny, nx = vol.shape
    mx, mn = np.empty((nz, nx), np.float32), np.empty((nz, nx), np.float32)
    assert lib.ts2dio_project_max_mean_i16(vol.ctypes.data, nz, ny, nx,
                                           mx.ctypes.data,
                                           mn.ctypes.data) == nz * nx
    return mx, mn


@pytest.mark.parametrize('threads', [1, 2, 3, 7, 64])
@pytest.mark.parametrize('shape', [(40, 30, 50), (5, 1, 7), (3, 64, 1)])
def test_project_max_mean_matches_numpy_and_device(lib, shape, threads):
    """On any number of z slabs (40 slices into 3 and 7, more threads than
    slices): bit for bit the one-thread call, numpy and the device."""
    rng = np.random.default_rng(sum(shape))
    vol = np.clip(rng.normal(40, 900, shape), -32768, 32767).astype(np.int16)
    mx, mn = native._project_native(lib, vol, threads)
    for a, b in zip((mx, mn), _serial(lib, vol)):
        assert a.tobytes() == b.tobytes()
    for a, b in zip((mx, mn), native.project_max_mean(vol)):
        assert a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(mx, vol.max(axis=1).astype(np.float32))
    np.testing.assert_array_equal(
        mn, vol.mean(axis=1, dtype=np.float64).astype(np.float32))
    t = torch.from_numpy(vol)
    np.testing.assert_array_equal(mn, projection.project_array(t, 'mean', 1)
                                  .squeeze(1).numpy())
    np.testing.assert_array_equal(mx, projection.project_array(t, 'max', 1)
                                  .squeeze(1).float().numpy())


@pytest.mark.parametrize('ny', [65535, 65537])
def test_project_tall_full_scale_columns(lib, ny):
    """Columns of 32767 and -32768 at the int32 sums' limit (ny 65535) and
    past it (65537: -32768 x 65537 < -2^31, the int64 sums): exact, numpy's
    mean and max on one thread and on two."""
    cols = np.array([32767, -32768, -32768, 32767], np.int16)
    vol = np.empty((2, ny, 3), np.int16)
    vol[0] = cols[:3]
    vol[1] = cols[1:]
    vol[1, ny // 2, 0] = 0
    sums = vol.astype(np.int64).sum(axis=1)
    assert (sums.min() < -2 ** 31) == (ny > 65535)
    want_mx = vol.max(axis=1).astype(np.float32)
    want_mn = vol.mean(axis=1, dtype=np.float64).astype(np.float32)
    for threads in (1, 2):
        mx, mn = native._project_native(lib, vol, threads)
        np.testing.assert_array_equal(mx, want_mx)
        np.testing.assert_array_equal(mn, want_mn)
    np.testing.assert_array_equal(mn[0], np.float32([32767, -32768, -32768]))


def test_projection_threads(monkeypatch):
    """The threads a projection takes: one for a small volume and inside a
    file-level decode worker, never more than the usable cores (nor
    PROJECT_MAX_THREADS, nor its slices), and the cores shared between
    projections that run at once."""
    slab = native.PROJECT_SLAB_VOXELS
    big = 400 * 512 * 512
    pool = native._HostPasses()
    monkeypatch.setattr(native, 'usable_cores', lambda: 8)
    with pool.share(slab - 1, 400) as n:
        assert n == 1
    with pool.share(3 * slab, 400) as n:
        assert n == 3
    with pool.share(big, 5) as n:
        assert n == 5
    got = []

    def in_worker():
        native.decode_worker_local.in_file_worker = True
        try:
            with pool.share(big, 400) as n:
                got.append(n)
        finally:
            native.decode_worker_local.in_file_worker = False
    t = threading.Thread(target=in_worker)
    t.start()
    t.join(10)
    assert not t.is_alive() and got == [1]
    for cores in (1, 2, 3, 64):
        monkeypatch.setattr(native, 'usable_cores', lambda: cores)
        with pool.share(big, 400) as n:
            assert n == min(cores, native.PROJECT_MAX_THREADS)
    monkeypatch.setattr(native, 'usable_cores', lambda: 8)
    with pool.share(4 * slab, 400) as a:
        with pool.share(big, 400) as b:
            with pool.share(big, 400) as c:
                assert (a, b, c) == (4, 4, 1)
        with pool.share(big, 400) as d:
            assert d == 4
    with pool.share(big, 400) as n:
        assert n == 8


def test_projection_counts_a_threaded_call(lib, monkeypatch):
    monkeypatch.setattr(native, 'usable_cores', lambda: 4)
    vol = np.random.default_rng(8).integers(
        -1024, 3000, (64, 128, 256)).astype(np.int16)
    before = native.projection_counts()
    mx, mn = native.project_max_mean(vol)
    after = native.projection_counts()
    assert after['threaded'] - before['threaded'] == 1
    assert after['threads'] - before['threads'] == 4
    assert after['serial'] == before['serial']
    assert after['numpy'] == before['numpy']
    for a, b in zip((mx, mn), _serial(lib, vol)):
        assert a.tobytes() == b.tobytes()
    native.project_max_mean(vol.astype(np.float32))
    assert native.projection_counts()['numpy'] - after['numpy'] == 1


def test_concurrent_projections(lib):
    """More callers than cores, switching often: every result exact, every
    call counted, and no thread left held."""
    vol = np.random.default_rng(10).integers(
        -1024, 3000, (32, 128, 256)).astype(np.int16)
    want = _serial(lib, vol)
    callers, calls = 2 * native.usable_cores() + 2, 6
    before = native.projection_counts()
    bad = []

    def run():
        for _ in range(calls):
            got = native.project_max_mean(vol)
            if any(a.tobytes() != b.tobytes() for a, b in zip(got, want)):
                bad.append(1)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run) for _ in range(callers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not bad
    after = native.projection_counts()
    assert sum(after[k] - before[k] for k in ('threaded', 'serial')) == \
        callers * calls
    assert native._host_passes._running == native._host_passes._held == 0


def test_project_against_reference(lib):
    """Against the reference package's project_arrays_np: max equal, mean
    within one float32 ulp (its library multiplies by 1/ny; without it,
    numpy's float32 mean)."""
    from totalsegmentator2d_tpu.ops.projection import \
        project_arrays_np as jax_project
    rng = np.random.default_rng(9)
    vol = np.clip(rng.normal(40, 300, (30, 47, 25)), -1024, 3071).astype(np.int16)
    mx, mn = projection.project_arrays_np(vol, ('max', 'mean'), 1)
    rmx, rmn = jax_project(vol, ('max', 'mean'), 1)
    np.testing.assert_array_equal(mx, np.asarray(rmx, np.float32))
    ulp = np.spacing(np.abs(np.asarray(rmn, np.float32)))
    assert np.all(np.abs(mn - rmn) <= ulp)


def test_non_applicable_inputs_fall_back(lib):
    rng = np.random.default_rng(4)
    assert native.project_max_mean(rng.standard_normal((8, 6, 5)).astype(np.float32)) is None
    assert native.project_max_mean(rng.integers(-50, 50, (8, 6)).astype(np.int16)) is None
    assert native.project_max_mean(np.asfortranarray(
        rng.integers(-50, 50, (8, 6, 5)).astype(np.int16))) is None
    assert native.project_max_mean(np.zeros((0, 3, 4), np.int16)) is None


def test_fused_equals_per_mode_and_project_multi_uses_it(lib, monkeypatch):
    from totalsegmentator2d_tpu_torch.io import MedicalImage
    rng = np.random.default_rng(5)
    vol = np.clip(rng.normal(40, 300, (30, 20, 25)), -1024, 3071).astype(np.int16)
    mx, mn = projection.project_arrays_np(vol, ('max', 'mean'), 1)
    np.testing.assert_array_equal(mx, projection.project_array_np(vol, 'max', 1)
                                  .astype(np.float32))
    np.testing.assert_array_equal(mn, projection.project_array_np(vol, 'mean', 1))
    outs = projection.project_arrays_np(vol, ('max', 'std'), 1)  # per mode
    np.testing.assert_array_equal(outs[0], projection.project_array_np(vol, 'max', 1))

    calls = []

    def spy(v):
        calls.append(v.shape)
        return native.project_max_mean(v)
    monkeypatch.setattr(projection, 'project_max_mean', spy)
    img = MedicalImage(array=vol, spacing=(0.8, 0.9, 2.0))
    chans = projection.project_multi(img, ['max', 'mean'], axis='coronal')
    assert calls == [vol.shape]
    np.testing.assert_array_equal(chans[0].array[:, 0], mx[:, 0])
    np.testing.assert_array_equal(chans[1].array[:, 0], mn[:, 0])
    assert chans[1].spacing == (0.8, 0.9 * 20, 2.0)
    # modes outside the fused set go through project() one by one
    med = projection.project_multi(img, ['median'], axis='coronal')[0]
    np.testing.assert_array_equal(
        med.array, projection.project(img, 'median', 'coronal').array)


def test_flatten_vector_max_matches_reference():
    from totalsegmentator2d_tpu.io import MedicalImage as JaxImage
    from totalsegmentator2d_tpu.ops.projection import \
        flatten_vector_max as jax_flatten
    from totalsegmentator2d_tpu_torch.io import MedicalImage
    arr = (np.random.default_rng(6).random((5, 6, 4)) > 0.6).astype(np.uint8)
    for index in (False, True):
        a = projection.flatten_vector_max(
            MedicalImage(array=arr, is_vector=True), index=index)
        b = jax_flatten(JaxImage(array=arr, is_vector=True), index=index)
        assert a.array.dtype == b.array.dtype and not a.is_vector
        np.testing.assert_array_equal(a.array, b.array)


# -- the Result's masks: unpack, place and split in one pass -----------------

# label counts by group: the 117 of ts2d-v2 / tsxr-v2, v1's 104, one label,
# one whole byte, one bit past it
ASSEMBLY_COUNTS = {117: (24, 21, 22, 24, 26), 104: (18, 23, 20, 25, 18),
                   1: (1,), 8: (3, 5), 9: (2, 7)}
# (full (H, W), the crop's ((y0, y1), (x0, x1)), a bucket canvas (qh, qw)
# and the window's corner in it, or None; a batch index, or None)
ASSEMBLY_LAYOUTS = {
    'inside': ((30, 40), ((5, 25), (7, 33)), None, None),
    'top': ((30, 40), ((0, 20), (7, 33)), None, None),
    'bottom': ((30, 40), ((10, 30), (7, 33)), None, None),
    'left': ((30, 40), ((5, 25), (0, 26)), None, None),
    'right': ((30, 40), ((5, 25), (14, 40)), None, None),
    'full': ((30, 40), ((0, 30), (0, 40)), None, None),
    'bucket': ((30, 40), ((5, 25), (7, 33)), ((32, 32), (0, 0)), None),
    'bucket-offset': ((30, 40), ((3, 23), (0, 26)), ((24, 32), (2, 5)),
                      None),
    'batch-row': ((30, 40), ((5, 25), (7, 33)), None, 1),
    'bucket-batch-row': ((30, 40), ((0, 20), (14, 40)), ((32, 32), (0, 0)),
                         2),
}


def _handle(packed, idx, bbox, full):
    """A batcher's handle whose future is resolved: the fetched (batch of)
    packed masks, the scan's row, its bbox and frame."""
    from concurrent.futures import Future
    from types import SimpleNamespace
    fut = Future()
    fut.set_result((SimpleNamespace(get=lambda: packed), idx, bbox, full))
    return fut


def _groups_handle(packed, idx, bbox, full, merge=True, pages=None,
                   slots=None):
    """A finish_groups handle of ``_handle``'s scan with ``merge``; with
    ``pages``, its pages job gave those arrays (an exception: it raised),
    holding a slot of ``slots``."""
    from totalsegmentator2d_tpu_torch.inference.ensemble_engine import _Paged
    job = None
    if pages is not None:
        job = Future()
        if isinstance(pages, BaseException):
            job.set_exception(pages)
        else:
            job.set_result([pages])
    return _Paged(_handle(packed, idx, bbox, full), merge, job,
                  slots if slots is not None else threading.Semaphore(0))


def _layout(name, n_labels, seed):
    """(packed masks as the fetch gives them, batch index, bbox, full)."""
    full, ((y0, y1), (x0, x1)), bucket, idx = ASSEMBLY_LAYOUTS[name]
    h, w = y1 - y0, x1 - x0
    bbox = ((y0, y1), (x0, x1))
    canvas = (h, w)
    if bucket is not None:
        canvas, (sy, sx) = bucket
        bbox += ((sy, sx, h, w),)
    rng = np.random.default_rng(seed)
    shape = ((3,) if idx is not None else ()) + canvas + (-(-n_labels // 8),)
    return rng.integers(0, 256, shape, dtype=np.uint8), idx, bbox, full


def _engine(counts):
    """An EnsembleEngine's host half alone: what its finish reads."""
    from totalsegmentator2d_tpu_torch.inference import EnsembleEngine
    engine = object.__new__(EnsembleEngine)
    engine.output_label_counts = list(counts)
    return engine


def _numpy_chain(engine, handle, counts):
    """unpack_bits -> _place -> each group's np.ascontiguousarray."""
    merged = engine.finish_array(handle)
    ends = np.cumsum((0,) + tuple(counts))
    return merged, [np.ascontiguousarray(merged[..., a:b])
                    for a, b in zip(ends[:-1], ends[1:])]


def _assert_same_arrays(got, want, merge):
    merged, parts = got
    if merge:
        assert merged.dtype == np.uint8 and merged.flags.c_contiguous
        assert merged.tobytes() == np.ascontiguousarray(want[0]).tobytes()
        assert merged.shape == want[0].shape
    else:
        assert merged is None
    assert len(parts) == len(want[1])
    for a, b in zip(parts, want[1]):
        assert a.dtype == np.uint8 and a.flags.c_contiguous
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    arrays = parts + ([merged] if merge else [])
    for i, a in enumerate(arrays):
        assert not any(np.shares_memory(a, b) for b in arrays[i + 1:])


@pytest.mark.parametrize('layout', list(ASSEMBLY_LAYOUTS))
@pytest.mark.parametrize('n_labels', list(ASSEMBLY_COUNTS))
def test_finish_groups_is_the_numpy_chain(lib, monkeypatch, n_labels, layout):
    """The engine's one-pass finish, bit for bit unpack_bits -> _place ->
    each group's copy, for crops at each edge of the frame and the whole
    frame, bucket windows and batch rows, on 1, 2, 3, 7 and 64 threads
    (more than the frame has rows), merged and not."""
    counts = ASSEMBLY_COUNTS[n_labels]
    engine = _engine(counts)
    packed, idx, bbox, full = _layout(layout, n_labels, n_labels)
    want = _numpy_chain(engine, _handle(packed, idx, bbox, full), counts)
    monkeypatch.setattr(native, 'ASSEMBLY_BAND_BYTES', 1)
    for threads in (1, 2, 3, 7, 64):
        monkeypatch.setattr(native, 'usable_cores', lambda: threads)
        monkeypatch.setattr(native, 'PROJECT_MAX_THREADS', threads)
        for merge in (True, False):
            before = native.assembly_counts()
            got = engine.finish_groups(_groups_handle(packed, idx, bbox,
                                                      full, merge))
            _assert_same_arrays(got, want, merge)
            after = native.assembly_counts()
            assert after['threads'] - before['threads'] == min(threads,
                                                                full[0])
            assert after['numpy'] == before['numpy']


@pytest.mark.parametrize('merge', [True, False])
@pytest.mark.parametrize('threads', [1, 2, 3, 7, 64])
def test_assemble_masks_on_any_thread_count(lib, threads, merge):
    """The library's pass itself on ``threads`` bands, more than the
    frame's 40 rows included, for a 117-label crop inside a bucket canvas:
    the numpy chain's arrays."""
    counts = ASSEMBLY_COUNTS[117]
    engine = _engine(counts)
    packed, idx, bbox, full = _layout('bucket-offset', 117, threads)
    want = _numpy_chain(engine, _handle(packed, idx, bbox, full), counts)
    sy, sx, h, w = bbox[2]
    (y0, _), (x0, _) = bbox[:2]
    got = native._assemble_native(lib, packed, (sy, sx, h, w), (y0, x0),
                                  full, counts, merge, threads)
    _assert_same_arrays(got, want, merge)


def test_assembly_falls_back_without_the_library(lib, monkeypatch):
    """No library, or packed masks the pass does not take (a pixel's bytes
    not contiguous): numpy's chain, counted as such, the same arrays."""
    counts = ASSEMBLY_COUNTS[117]
    engine = _engine(counts)
    packed, idx, bbox, full = _layout('left', 117, 3)
    want = _numpy_chain(engine, _handle(packed, idx, bbox, full), counts)
    before = native.assembly_counts()
    monkeypatch.setattr(native, '_load', lambda: None)
    for merge in (True, False):
        got = engine.finish_groups(_groups_handle(packed, idx, bbox, full,
                                                  merge))
        _assert_same_arrays(got, want, merge)
    monkeypatch.undo()
    strided = np.asfortranarray(packed)
    assert native.assemble_masks(strided, (0, 0) + packed.shape[:2],
                                 (5, 0), full, counts) is None
    _assert_same_arrays(engine.finish_groups(
        _groups_handle(strided, idx, bbox, full)), want, True)
    after = native.assembly_counts()
    assert after['numpy'] - before['numpy'] == 4
    assert after['threaded'] == before['threaded']


def test_assembly_counts_a_threaded_call(lib, monkeypatch):
    """A radiograph-like frame's assembly takes the threads its bytes pay
    for, and counts them apart from the projections."""
    monkeypatch.setattr(native, 'usable_cores', lambda: 4)
    counts = ASSEMBLY_COUNTS[117]
    packed = np.random.default_rng(11).integers(0, 256, (200, 300, 15),
                                                dtype=np.uint8)
    before = native.assembly_counts()
    projections = native.projection_counts()
    merged, parts = native.assemble_masks(packed, (0, 0, 200, 300), (10, 20),
                                          (240, 320), counts)
    after = native.assembly_counts()
    assert after['threaded'] - before['threaded'] == 1
    assert after['threads'] - before['threads'] == 4
    assert after['serial'] == before['serial']
    assert after['numpy'] == before['numpy']
    assert native.projection_counts() == projections
    want = np.zeros((240, 320, 117), np.uint8)
    want[10:210, 20:320] = np.unpackbits(
        packed, axis=-1, bitorder='little')[..., :117]
    assert merged.tobytes() == want.tobytes()
    assert np.concatenate(parts, axis=-1).tobytes() == want.tobytes()
    # a tiny frame stays on the calling thread
    native.assemble_masks(packed[:4, :4], (0, 0, 4, 4), (0, 0), (4, 4),
                          counts)
    assert native.assembly_counts()['serial'] - after['serial'] == 1


def test_projection_and_assembly_share_the_cores(monkeypatch):
    """An assembly that starts while a projection runs takes what the
    projection leaves of the cores, and by its bytes."""
    monkeypatch.setattr(native, 'usable_cores', lambda: 8)
    pool = native._HostPasses()
    band = native.ASSEMBLY_BAND_BYTES
    big = 400 * 512 * 512
    with pool.share(band * 3 - 1, 400, band) as n:
        assert n == 2
    with pool.share(big, 400) as a:
        with pool.share(band * 64, 3000, band) as b:
            assert (a, b) == (8, 1)
    with pool.share(band * 64, 3000, band) as b:
        with pool.share(big, 400) as a:
            assert (b, a) == (8, 1)
    with pool.share(6 * native.PROJECT_SLAB_VOXELS, 400) as a:
        with pool.share(band * 64, 3000, band) as b:
            assert (a, b) == (6, 2)
    assert pool._running == pool._held == 0


def test_concurrent_projections_and_assemblies(lib):
    """More callers than cores, projections and assemblies interleaved and
    switching often: every result exact, every call counted by its kind,
    and no thread left held."""
    vol = np.random.default_rng(12).integers(
        -1024, 3000, (32, 128, 256)).astype(np.int16)
    counts = ASSEMBLY_COUNTS[117]
    packed = np.random.default_rng(13).integers(0, 256, (120, 160, 15),
                                                dtype=np.uint8)
    want_projection = _serial(lib, vol)
    want_assembly = native._assemble_native(lib, packed, (0, 0, 120, 160),
                                            (4, 6), (128, 170), counts, True,
                                            1)
    callers, calls = 2 * native.usable_cores() + 2, 4
    before = native.projection_counts(), native.assembly_counts()
    bad = []

    def run(i):
        for _ in range(calls):
            if i % 2:
                got = native.project_max_mean(vol)
                want = want_projection
            else:
                merged, parts = native.assemble_masks(
                    packed, (0, 0, 120, 160), (4, 6), (128, 170), counts)
                got = [merged] + parts
                want = [want_assembly[0]] + want_assembly[1]
            if any(a.tobytes() != b.tobytes() for a, b in zip(got, want)):
                bad.append(i)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(callers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not bad
    after = native.projection_counts(), native.assembly_counts()
    for b, a in zip(before, after):
        assert sum(a[k] - b[k] for k in ('threaded', 'serial')) == \
            callers // 2 * calls
    assert native._host_passes._running == native._host_passes._held == 0


# -- the Result's arrays mapped ahead of the pass ------------------------------

# the tsxr-v2 / ts2d-v2 groups' label counts, v1's, and one bit past a byte
MAPPED_COUNTS = {name: ASSEMBLY_COUNTS[n] for name, n in
                 (('v2', 117), ('v1', 104), ('odd', 9))}


@pytest.fixture
def every_array(monkeypatch):
    """map_mask_arrays maps every array ahead, however small."""
    monkeypatch.setattr(native, 'PAGES_MIN_BYTES', 0)


def _each(arrays):
    """[the merged array or None, each group's array or None]."""
    return [arrays[0], *arrays[1]]


def _mapped(full, counts, merge):
    """map_mask_arrays' arrays and each mapping's finalizer."""
    got = native.map_mask_arrays(full, counts, merge)
    return got, [a.base.released for a in _each(got) if a is not None]


@pytest.mark.parametrize('merge', [True, False])
@pytest.mark.parametrize('counts', list(MAPPED_COUNTS))
@pytest.mark.parametrize('layout', ['top', 'bottom', 'left', 'right', 'full',
                                    'bucket-offset', 'batch-row'])
def test_assembly_into_mapped_arrays(lib, every_array, layout, counts,
                                     merge):
    """The pass into map_mask_arrays' arrays, for crops at each edge of the
    frame, the whole frame, a bucket window and a batch row: bit for bit
    the pass into fresh arrays and numpy's chain, into the mapped arrays
    themselves, each its own memory apart from ``packed``, and counted as
    prefaulted."""
    counts = MAPPED_COUNTS[counts]
    engine = _engine(counts)
    packed, idx, bbox, full = _layout(layout, sum(counts), len(layout))
    want = _numpy_chain(engine, _handle(packed, idx, bbox, full), counts)
    scan = packed if idx is None else packed[idx]
    window = bbox[2] if len(bbox) == 3 else (0, 0) + scan.shape[:2]
    origin = (bbox[0][0], bbox[1][0])
    fresh = native.assemble_masks(scan, window, origin, full, counts, merge)
    out, _ = _mapped(full, counts, merge)
    before = native.assembly_counts()
    got = native.assemble_masks(scan, window, origin, full, counts, merge,
                                out)
    after = native.assembly_counts()
    assert after['prefaulted'] - before['prefaulted'] == 1
    _assert_same_arrays(got, want, merge)
    _assert_same_arrays(got, fresh, merge)
    arrays = [a for a in _each(got) if a is not None]
    assert all(a is b for a, b in zip(arrays, [
        a for a in _each(out) if a is not None]))
    for a in arrays:
        assert a.flags.c_contiguous and a.flags.writeable
        assert isinstance(a.base, native._Mapping)
        assert not np.shares_memory(a, packed)


@pytest.mark.parametrize('chunk', [4096, 3 * 4096 + 1, 1 << 40])
def test_mapped_arrays_are_released_with_their_last_view(
        lib, every_array, monkeypatch, chunk):
    """Each array is a mapping of its own, populated in chunks of any size
    (a page, a size that is no whole number of pages, the whole at once),
    writable end to end, and unmapped when the last array or view over it
    is gone."""
    monkeypatch.setattr(native, 'PAGES_CHUNK_BYTES', chunk)
    counts = MAPPED_COUNTS['v2']
    (merged, parts), released = _mapped((61, 53), counts, True)
    assert len(released) == 1 + len(counts)
    for i, a in enumerate([merged] + parts):
        a[...] = i + 1
        assert a.shape[:2] == (61, 53)
        assert a.sum(dtype=np.int64) == (i + 1) * a.size
    assert [a.shape[2] for a in parts] == list(counts)
    assert merged.shape[2] == sum(counts)
    view = parts[2][10:20, ::2]
    del merged, parts, a
    gc.collect()
    assert [f.alive for f in released] == [False, False, False, True, False,
                                           False]
    del view
    assert not any(f.alive for f in released)


def test_a_refused_mapping_raises():
    refusing = SimpleNamespace(ts2dio_map_pages=lambda size, chunk: None)
    with pytest.raises(MemoryError):
        native._Mapping(refusing, (4, 4, 3))


def test_a_mapping_is_left_to_the_system_at_exit(lib, every_array):
    """A mapping's finalizer does not run at the interpreter's exit, when
    a daemon thread (a server's handler) may still read a Result over it:
    the system frees it with the process."""
    _, released = _mapped((9, 7), MAPPED_COUNTS['odd'], True)
    assert released and all(f.alive and not f.atexit for f in released)


def test_finish_falls_back_when_the_pages_job_failed(lib):
    """A pages job that raised (the system refused a mapping): the finish
    writes into fresh arrays, the same masks, and counts no prefaulted
    pass."""
    counts = MAPPED_COUNTS['v2']
    engine = _engine(counts)
    packed, idx, bbox, full = _layout('right', 117, 5)
    want = _numpy_chain(engine, _handle(packed, idx, bbox, full), counts)
    before = native.assembly_counts()
    for merge in (True, False):
        got = engine.finish_groups(_groups_handle(
            packed, idx, bbox, full, merge, MemoryError('refused')))
        _assert_same_arrays(got, want, merge)
        assert not any(isinstance(a.base, native._Mapping)
                       for a in got[1])
    after = native.assembly_counts()
    assert after['prefaulted'] == before['prefaulted']
    assert after['threaded'] + after['serial'] - before['threaded'] \
        - before['serial'] == 2


@pytest.mark.parametrize('end', ['taken', 'failed', 'cancelled', 'dropped',
                                 'collected'])
def test_a_pages_job_frees_its_slot_once(lib, every_array, end):
    """A job's slot is freed once, when its scan's finish takes the arrays
    (or finds the job failed), when the job is dropped (at once if it had
    not started, else as it ends, its arrays unmapped then), or when the
    handle is gone unfinished; the finish writes the masks into the
    arrays it took."""
    counts = MAPPED_COUNTS['v1']
    engine = _engine(counts)
    packed, idx, bbox, full = _layout('inside', 104, 6)
    slots = threading.BoundedSemaphore(1)    # a second release raises
    assert slots.acquire(blocking=False)
    pages, released = _mapped(full, counts, True)
    handle = _groups_handle(packed, idx, bbox, full, True,
                            MemoryError('refused') if end == 'failed'
                            else pages, slots)
    if end in ('cancelled', 'dropped'):    # a job not yet run
        handle.pages = Future()
    if end in ('taken', 'failed'):
        got = engine.finish_groups(handle)
        _assert_same_arrays(got, _numpy_chain(
            engine, _handle(packed, idx, bbox, full), counts), True)
        assert (got[0] is pages[0]) == (end == 'taken')
    elif end == 'cancelled':
        handle.drop()
    elif end == 'dropped':
        assert handle.pages.set_running_or_notify_cancel()
        handle.drop()
        assert not slots.acquire(blocking=False)    # not before it ends
        handle.pages.set_result([pages])
    else:
        del handle
        gc.collect()
    assert slots.acquire(blocking=False)
    if end == 'dropped':
        del pages
        gc.collect()
        assert not any(f.alive for f in released)


def test_arrays_under_the_threshold_are_left_to_the_pass(lib, monkeypatch):
    """Only arrays of PAGES_MIN_BYTES or more are mapped ahead; the pass
    allocates the rest, and a pass given some mapped arrays counts as
    prefaulted."""
    counts = MAPPED_COUNTS['v2']
    engine = _engine(counts)
    packed, idx, bbox, full = _layout('full', 117, 8)
    # 30 x 40 pixels: the merged array 140,400 bytes, the groups' 25,200 to
    # 31,200
    monkeypatch.setattr(native, 'PAGES_MIN_BYTES', 30 * 40 * 25)
    pages = native.map_mask_arrays(full, counts, True)
    assert [a is not None for a in _each(pages)] == [
        True, False, False, False, False, True]
    assert native.maps_ahead(full, counts, True)
    assert native.maps_ahead(full, counts, False)
    assert not native.maps_ahead((30, 38), counts, False)
    before = native.assembly_counts()['prefaulted']
    got = engine.finish_groups(_groups_handle(packed, idx, bbox, full, True,
                                              pages))
    _assert_same_arrays(got, _numpy_chain(
        engine, _handle(packed, idx, bbox, full), counts), True)
    assert got[0] is pages[0] and got[1][4] is pages[1][4]
    assert native.assembly_counts()['prefaulted'] - before == 1
    monkeypatch.undo()
    # a CT's Result at the default: nothing mapped, and no job asked for;
    # a detector-size radiograph's is
    assert native.map_mask_arrays((500, 512), counts, True) == (
        None, [None] * 5)
    assert not native.maps_ahead((500, 512), counts, True)
    assert native.maps_ahead((3056, 2544), counts, False)
