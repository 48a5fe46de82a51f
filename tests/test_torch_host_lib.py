"""The PyTorch port's native host library (csrc/ts2dio.cc through
totalsegmentator2d_tpu_torch/io/native.py), built with g++ and zlib at first
use, on the CPU: gzip and zlib round trips and interop with Python's zlib,
corrupt input, concatenated gzip members, the Python fallback, streams
driven through many zlib windows (a build with a 4 KiB window stands in for
payloads of 4 GiB and more), and the fused MAX + MEAN projection: its mean
bit for bit the port's float64 numpy mean and its device projection, within
one float32 ulp of the reference package's."""

import gzip
import os
import zlib

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
    assert int(lib.ts2dio_abi_version()) == native.ABI_VERSION
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


@pytest.mark.parametrize('shape', [(40, 30, 50), (5, 1, 7), (3, 64, 1)])
def test_project_max_mean_matches_numpy_and_device(lib, shape):
    rng = np.random.default_rng(sum(shape))
    vol = np.clip(rng.normal(40, 900, shape), -32768, 32767).astype(np.int16)
    mx, mn = native.project_max_mean(vol)
    np.testing.assert_array_equal(mx, vol.max(axis=1).astype(np.float32))
    np.testing.assert_array_equal(
        mn, vol.mean(axis=1, dtype=np.float64).astype(np.float32))
    t = torch.from_numpy(vol)
    np.testing.assert_array_equal(mn, projection.project_array(t, 'mean', 1)
                                  .squeeze(1).numpy())
    np.testing.assert_array_equal(mx, projection.project_array(t, 'max', 1)
                                  .squeeze(1).float().numpy())


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
