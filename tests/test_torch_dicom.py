"""The PyTorch port's DICOM reading (totalsegmentator2d_tpu_torch.io.dicom
and its codecs) against the reference package's, on the same bytes.

The streams come from tests/test_017_dicom.py's encoders (slices, RLE,
JPEG Lossless, sequential DCT, Enhanced and legacy multi-frame files),
tests/charls_oracle.py (JPEG-LS) and Pillow's openjpeg (JPEG 2000). Each
case holds three things: the port's array, spacing, origin and direction
equal the reference package's bit for bit; the port's native codec path
equals its Python path bit for bit; and where the reference raises on a
mutated or truncated stream, the port raises the same error class. Then
end to end on the CPU: ``TS2D.predict`` of a DICOM series against the same
volume as NRRD, the port against the reference package on the series at
both precisions, and the CLI's case enumeration."""

import os
import shutil
import sys
import zipfile

import numpy as np
import pytest

from tests import charls_oracle
from tests.model_fixtures import build_group_set
from tests.synth_assets import asset_path
from tests.test_017_dicom import (_DEFL, _EXPLICIT, _IMPLICIT, _J2K, _J2KLL,
                                  _JLSLL, _JPB, _JPE, _JPLL, _JPLL_SV1, _RLE,
                                  _j2k_encode, _jpegdct_frame, _jpegll_frame,
                                  write_enhanced, write_legacy_multiframe,
                                  write_slice)
from totalsegmentator2d_tpu import io as jax_io
from totalsegmentator2d_tpu.api import TS2D as JaxTS2D
from totalsegmentator2d_tpu.cli import _enumerate_cases as jax_cases
from totalsegmentator2d_tpu.io import dicom as jax_dicom
from totalsegmentator2d_tpu.io import jpeg2k as jax_jpeg2k
from totalsegmentator2d_tpu.io import jpegdct as jax_jpegdct
from totalsegmentator2d_tpu.io import jpegll as jax_jpegll
from totalsegmentator2d_tpu.io import jpegls as jax_jpegls
from totalsegmentator2d_tpu_torch import io as port_io
from totalsegmentator2d_tpu_torch.api import TS2D
from totalsegmentator2d_tpu_torch.cli import _enumerate_cases, ts2d_entry_point
from totalsegmentator2d_tpu_torch.io import (MedicalImage, dicom, jpeg2k,
                                             jpegdct, jpegll, jpegls, native)

_JLS_NEAR = '1.2.840.10008.1.2.4.81'
KEY = 'ts2d-v9-test'
FAST = {'nnu.predict.precision': 'fast'}


def _need_charls():
    if not charls_oracle.available():
        pytest.skip('system CharLS library not available')


def _vol(shape=(3, 10, 12), lo=-900, hi=1500, dtype=np.int16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=shape).astype(dtype)


def _smooth(shape, hi, dtype, seed):
    """CT-like slices: smooth structure plus noise (the lossy codecs and
    JPEG-LS's run mode see real content, not white noise)."""
    rng = np.random.default_rng(seed)
    z, y, x = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]]
    img = (hi * 0.5 + hi * 0.2 * np.sin(x / 5.0 + z) + hi * 0.15
           * np.cos(y / 4.0) + rng.normal(0, hi * 0.02, shape))
    return img.clip(0, hi - 1).astype(dtype)


def _slices(d, vol, dz=2.5, reverse=False, orientation=(1, 0, 0, 0, 1, 0),
            codestreams=None, ts_patch=None, **kw):
    """One slice file per plane of ``vol``, positions along the normal of
    ``orientation`` (written in reverse order when asked)."""
    normal = np.cross(np.asarray(orientation[:3], float),
                      np.asarray(orientation[3:], float))
    order = range(len(vol) - 1, -1, -1) if reverse else range(len(vol))
    for i, z in enumerate(order):
        pos = np.array([5.0, -7.0, 10.0]) + dz * z * normal
        path = str(d / f's{i:03d}.dcm')
        write_slice(path, vol[z], position=tuple(pos),
                    orientation=orientation, instance=i + 1,
                    codestream=None if codestreams is None else codestreams[z],
                    **kw)
        if ts_patch is not None:  # another transfer syntax of one length
            with open(path, 'rb') as f:
                data = f.read()
            old, new = ts_patch
            assert len(old) == len(new) and data.count(old.encode()) == 1
            with open(path, 'wb') as f:
                f.write(data.replace(old.encode(), new.encode()))
    return str(d)


def _case_explicit(d):
    return _slices(d, _vol())


def _case_implicit(d):
    return _slices(d, _vol(), transfer_syntax=_IMPLICIT)


def _case_deflated(d):
    return _slices(d, _vol(), transfer_syntax=_DEFL)


def _case_rle(d):
    return _slices(d, _vol(lo=0, hi=4096, dtype=np.uint16), slope=1,
                   intercept=-1024, transfer_syntax=_RLE)


def _case_jpegll_sv1(d):
    return _slices(d, _vol(), transfer_syntax=_JPLL_SV1)


def _jpegll_case(predictor):
    def build(d):
        # a restart every two rows: the predictor resets at each interval
        return _slices(d, _vol(), transfer_syntax=_JPLL,
                       jll_predictor=predictor, jll_dri=24)
    return build


def _case_jpegll_split(d):
    return _slices(d, _vol(), transfer_syntax=_JPLL_SV1, jll_split=40)


def _case_jpeg_baseline8(d):
    vol = _smooth((3, 19, 21), 256, np.uint8, seed=1)
    return _slices(d, vol, transfer_syntax=_JPB, codestreams=[
        _jpegdct_frame(v, precision=8, q=6) for v in vol])


def _case_jpeg_extended12(d):
    vol = _smooth((3, 19, 21), 4096, np.uint16, seed=2)
    return _slices(d, vol, transfer_syntax=_JPE, slope=1, intercept=-1024,
                   codestreams=[_jpegdct_frame(v, precision=12, q=8, dri=2)
                                for v in vol])


def _case_jpegls_lossless(d):
    _need_charls()
    vol = _smooth((3, 17, 23), 4096, np.uint16, seed=3)
    return _slices(d, vol, transfer_syntax=_JLSLL, slope=1, intercept=-1024,
                   codestreams=[charls_oracle.encode(v, 12) for v in vol])


def _case_jpegls_near(d):
    _need_charls()
    vol = _smooth((3, 17, 23), 4096, np.uint16, seed=4)
    return _slices(d, vol, transfer_syntax=_JLSLL, ts_patch=(_JLSLL, _JLS_NEAR),
                   codestreams=[charls_oracle.encode(v, 12, near=2)
                                for v in vol])


def _case_j2k_53(d):
    vol = _vol(shape=(3, 20, 24), seed=5)  # signed: the Ssiz patch
    return _slices(d, vol, transfer_syntax=_J2KLL,
                   codestreams=[_j2k_encode(v) for v in vol])


def _case_j2k_97(d):
    vol = _smooth((3, 20, 24), 4096, np.uint16, seed=6)
    return _slices(d, vol, transfer_syntax=_J2K, slope=1, intercept=-1024,
                   codestreams=[_j2k_encode(v, irreversible=True)
                                for v in vol])


def _case_j2k_53_blocks(d):
    """Enough code blocks for the code-block pool, several resolutions."""
    vol = _smooth((2, 64, 72), 4096, np.uint16, seed=7)
    return _slices(d, vol, transfer_syntax=_J2KLL, codestreams=[
        _j2k_encode(v, codeblock_size=(16, 16), num_resolutions=4)
        for v in vol])


def _positions(n, dz=2.5):
    return [(5.0, -7.0, 10.0 + dz * i) for i in range(n)]


def _case_enhanced(d):
    vol = _vol(shape=(5, 10, 12), seed=8)
    write_enhanced(str(d / 'mf.dcm'), vol, positions=_positions(5))
    return str(d / 'mf.dcm')


def _case_enhanced_implicit_rescale(d):
    vol = _vol(shape=(4, 10, 12), seed=9)
    write_enhanced(str(d / 'mf.dcm'), vol, positions=_positions(4),
                   transfer_syntax=_IMPLICIT, slope=2, intercept=-100,
                   defined_seq=True, undef_items=True)
    return str(d)


def _case_enhanced_rle(d):
    vol = _vol(shape=(4, 10, 12), seed=10)
    write_enhanced(str(d / 'mf.dcm'), vol, positions=_positions(4),
                   transfer_syntax=_RLE)
    return str(d / 'mf.dcm')


def _case_enhanced_jpegll_bot(d):
    vol = _vol(shape=(4, 10, 12), seed=11)
    write_enhanced(str(d / 'mf.dcm'), vol, positions=_positions(4),
                   transfer_syntax=_JPLL_SV1, jll_split=40)
    return str(d / 'mf.dcm')


def _case_legacy_multiframe(d):
    vol = _vol(shape=(4, 10, 12), seed=12)
    write_legacy_multiframe(str(d / 'mf.dcm'), vol, position0=(1.0, 2.0, 3.0),
                            dz=1.25)
    return str(d / 'mf.dcm')


def _case_reversed(d):
    return _slices(d, _vol(shape=(5, 10, 12), seed=13), reverse=True)


def _case_oblique(d):
    c, s = 0.866025, 0.5
    return _slices(d, _vol(shape=(4, 10, 12), seed=14), dz=1.75,
                   orientation=(c, s, 0, -s * 0.6, c * 0.6, 0.8))


def _case_rescale_float(d):
    return _slices(d, _vol(seed=15), slope=0.5, intercept=-1024.25)


def _case_zip(d):
    series = d / 'wrap' / 'series'
    series.mkdir(parents=True)
    _slices(series, _vol(seed=16), transfer_syntax=_JPLL_SV1)
    zp = d / 'case.zip'
    with zipfile.ZipFile(zp, 'w') as zf:
        zf.writestr('__MACOSX/._junk', b'x')
        for f in sorted(series.iterdir()):
            zf.write(f, f'wrap/series/{f.name}')
    return str(zp)


CASES = {
    'explicit': _case_explicit, 'implicit': _case_implicit,
    'deflated': _case_deflated, 'rle': _case_rle,
    'jpegll-sv1': _case_jpegll_sv1,
    **{f'jpegll-p{p}-rst': _jpegll_case(p) for p in range(1, 8)},
    'jpegll-split': _case_jpegll_split,
    'jpeg-baseline8': _case_jpeg_baseline8,
    'jpeg-extended12': _case_jpeg_extended12,
    'jpegls-lossless': _case_jpegls_lossless,
    'jpegls-near': _case_jpegls_near,
    'j2k-53': _case_j2k_53, 'j2k-97': _case_j2k_97,
    'j2k-53-blocks': _case_j2k_53_blocks,
    'enhanced': _case_enhanced,
    'enhanced-implicit-rescale': _case_enhanced_implicit_rescale,
    'enhanced-rle': _case_enhanced_rle,
    'enhanced-jpegll-bot': _case_enhanced_jpegll_bot,
    'legacy-multiframe': _case_legacy_multiframe,
    'reversed': _case_reversed, 'oblique': _case_oblique,
    'rescale-float': _case_rescale_float, 'zip': _case_zip,
}


def _assert_same_image(ours, ref):
    assert type(ours) is MedicalImage
    assert ours.array.dtype == ref.array.dtype
    assert ours.array.shape == ref.array.shape
    assert np.array_equal(ours.array, ref.array)
    assert tuple(ours.spacing) == tuple(ref.spacing)
    assert tuple(ours.origin) == tuple(ref.origin)
    assert np.array_equal(np.asarray(ours.direction),
                          np.asarray(ref.direction))


@pytest.mark.parametrize('case', sorted(CASES))
def test_series_equals_reference(case, tmp_path, monkeypatch):
    """One syntax or layout: the port's read equals the reference
    package's bit for bit, and the port's native and Python codec paths
    give the same image."""
    path = CASES[case](tmp_path)
    ref = jax_io.read_image(path)
    assert native.native_available()
    ours = port_io.read_image(path)
    _assert_same_image(ours, ref)
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_checked', True)
    _assert_same_image(port_io.read_image(path), ours)


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'fixtures', 'dicom')
FIXTURE_NAMES = ('rle', 'deflate', 'jpeg-baseline8', 'jpeg-extended12',
                 'jpegls-lossless', 'jpegls-near', 'j2k-53', 'j2k-97')


@pytest.mark.parametrize('name', FIXTURE_NAMES)
def test_fixture_equals_reference(name, monkeypatch):
    """The committed fixtures (tools/make_torch_dicom_fixtures.py, read on
    the card by chip_smoke.py): the port's read equals the reference
    package's and the stored decode, on both codec paths."""
    path = os.path.join(FIXTURES, f'{name}.dcm')
    with np.load(os.path.join(FIXTURES, 'decoded.npz')) as z:
        stored = z[name]
    ref = jax_io.read_image(path)
    ours = port_io.read_image(path)
    _assert_same_image(ours, ref)
    assert ours.array.dtype == stored.dtype
    assert np.array_equal(ours.array, stored)
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_checked', True)
    _assert_same_image(port_io.read_image(path), ours)


def test_fixtures_are_small():
    names = sorted(os.listdir(FIXTURES))
    assert names == sorted([f'{n}.dcm' for n in FIXTURE_NAMES]
                           + ['decoded.npz'])
    assert sum(os.path.getsize(os.path.join(FIXTURES, n))
               for n in names) < 1 << 20


# -- errors -------------------------------------------------------------------

def _outcome(fn, *args):
    try:
        out = fn(*args)
    except Exception as ex:  # noqa: BLE001 — the class is what is compared
        return type(ex).__name__, None
    return 'ok', out


def _assert_same_outcome(ours, ref):
    assert ours[0] == ref[0]
    if ref[0] == 'ok':
        a, b = ours[1], ref[1]
        if isinstance(b, dict):  # a read_dicom_file result
            a = np.stack([f['array'] for f in a['frames']])
            b = np.stack([f['array'] for f in b['frames']])
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _mutations(base, rng, n_mut, n_cut):
    for _ in range(n_mut):
        data = bytearray(base)
        for _ in range(int(rng.integers(1, 6))):
            data[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
        yield bytes(data)
    for _ in range(n_cut):
        yield bytes(base[:int(rng.integers(2, len(base)))])


@pytest.mark.parametrize('codec', ['j2k', 'jls', 'jll', 'jdct'])
def test_mutations_raise_the_reference_class(codec):
    """A sample of the reference's mutation fuzz (its seed, its corruption
    scheme): each stream decodes to the same array in both packages, or
    both raise an error of the same class."""
    rng = np.random.default_rng(123)
    arr = rng.integers(0, 4096, (32, 36)).astype(np.uint16)
    if codec == 'jll':
        base = _jpegll_frame(arr)
        decs = jpegll.decode, jax_jpegll.decode
    elif codec == 'jdct':
        base = _jpegdct_frame(arr.astype(np.uint8), precision=8)
        decs = jpegdct.decode, jax_jpegdct.decode
    elif codec == 'j2k':
        base = _j2k_encode(arr)
        decs = jpeg2k.decode, jax_jpeg2k.decode
    else:
        _need_charls()
        base = charls_oracle.encode(arr, 12)
        decs = jpegls.decode, jax_jpegls.decode
    classes = set()
    for data in _mutations(base, rng, 40, 15):
        ours, ref = _outcome(decs[0], data), _outcome(decs[1], data)
        _assert_same_outcome(ours, ref)
        classes.add(ours[0])
    assert classes - {'ok'}  # the sample does reach the error paths


@pytest.mark.parametrize('codec', ['jll', 'jdct'])
def test_truncated_markers_raise_the_reference_class(codec):
    """Every cut of a small stream, as the reference's truncation sweep."""
    rng = np.random.default_rng(0 if codec == 'jll' else 1)
    if codec == 'jll':
        base = _jpegll_frame(rng.integers(0, 4096, (8, 9)).astype(np.uint16))
        decs = jpegll.decode, jax_jpegll.decode
    else:
        base = _jpegdct_frame(rng.integers(0, 256, (8, 9)).astype(np.uint8),
                              precision=8)
        decs = jpegdct.decode, jax_jpegdct.decode
    for cut in range(2, len(base)):
        _assert_same_outcome(_outcome(decs[0], base[:cut]),
                             _outcome(decs[1], base[:cut]))


@pytest.mark.parametrize('ts', [_EXPLICIT, _IMPLICIT, _RLE])
def test_dicom_layer_mutations_raise_the_reference_class(ts, tmp_path):
    """The element parser's containment (the reference's DICOM-layer fuzz):
    mutated and truncated files give DicomError in both packages, or the
    same frames."""
    rng = np.random.default_rng(len(ts))
    arr = rng.integers(-500, 1500, (10, 12)).astype(np.int16)
    p = tmp_path / 'a.dcm'
    write_slice(str(p), arr, position=(0, 0, 0), transfer_syntax=ts)
    pm = tmp_path / 'm.dcm'
    for data in _mutations(p.read_bytes(), rng, 30, 10):
        pm.write_bytes(data)
        _assert_same_outcome(_outcome(dicom.read_dicom_file, str(pm)),
                             _outcome(jax_dicom.read_dicom_file, str(pm)))


def test_error_classes_and_helpers_match():
    assert issubclass(dicom.DicomError, ValueError)
    for ours, ref in ((dicom.DicomError, jax_dicom.DicomError),
                      (jpegll.JpegError, jax_jpegll.JpegError),
                      (jpegls.JpegLsError, jax_jpegls.JpegLsError),
                      (jpeg2k.Jpeg2kError, jax_jpeg2k.Jpeg2kError)):
        assert ours.__name__ == ref.__name__
        assert [c.__name__ for c in ours.__mro__] == \
            [c.__name__ for c in ref.__mro__]
    assert jpegdct.JpegError is jpegll.JpegError
    from totalsegmentator2d_tpu.io.image import PARSER_ERRORS as JAX_ERRORS
    from totalsegmentator2d_tpu_torch.io.image import PARSER_ERRORS
    assert PARSER_ERRORS == JAX_ERRORS
    assert native.ABI_VERSION == 5
    assert native._load().ts2dio_abi_version() == native.ABI_VERSION


def test_j2k_block_pool_stays_serial_in_a_series_worker(monkeypatch):
    """The code-block pool fans out outside a series worker and stays
    serial inside one (the in_file_worker rule); both decode alike."""
    arr = _smooth((1, 64, 72), 4096, np.uint16, seed=7)[0]
    cs = _j2k_encode(arr, codeblock_size=(16, 16))
    submitted = []
    pool = jpeg2k._t1_pool()
    real_submit = pool.submit
    monkeypatch.setattr(pool, 'submit', lambda *a, **kw: (
        submitted.append(1), real_submit(*a, **kw))[1])
    threaded = jpeg2k.decode(cs)
    assert submitted
    submitted.clear()
    native.decode_worker_local.in_file_worker = True
    try:
        serial = jpeg2k.decode(cs)
    finally:
        native.decode_worker_local.in_file_worker = False
    assert not submitted
    assert np.array_equal(threaded, arr) and np.array_equal(serial, arr)


def test_series_helpers_match(tmp_path):
    """resolve_series_root and is_dicom_dir agree with the reference."""
    wrap = tmp_path / 'a' / 'b'
    wrap.mkdir(parents=True)
    _slices(wrap, _vol())
    (tmp_path / 'a' / '.hidden').write_bytes(b'')
    assert dicom.resolve_series_root(str(tmp_path)) == \
        jax_dicom.resolve_series_root(str(tmp_path)) == str(wrap)
    mixed = tmp_path / 'mixed'
    mixed.mkdir()
    _slices(mixed, _vol())
    (mixed / 'x.nrrd').write_bytes(b'')
    for d in (wrap, mixed, tmp_path):
        assert dicom.is_dicom_dir(str(d)) == jax_dicom.is_dicom_dir(str(d))
    assert dicom.is_dicom_dir(str(wrap)) and not dicom.is_dicom_dir(str(mixed))
    cycle = tmp_path / 'cycle'
    cycle.mkdir()
    os.symlink(str(cycle), str(cycle / 'self'))
    with pytest.raises(dicom.DicomError, match='No DICOM series'):
        dicom.resolve_series_root(str(cycle))


# -- end to end ------------------------------------------------------------------

@pytest.fixture(scope='module')
def model_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('zoo'))
    build_group_set(root, model=KEY, spacing=(1.2, 2.0))
    return root


@pytest.fixture(scope='module')
def ct_case(tmp_path_factory):
    """A CT as a JPEG Lossless DICOM series and as NRRD, with geometry the
    DICOM strings carry exactly: the sample CT's voxels at 0.8 x 0.7 x 2.5
    mm."""
    d = tmp_path_factory.mktemp('ct')
    arr = port_io.read_image(asset_path('sample_s0521.nrrd')).array
    img = MedicalImage(array=arr, spacing=(0.8, 0.7, 2.5),
                       origin=(5.0, -7.0, 10.0))
    series = d / 'series'
    series.mkdir()
    _slices(series, arr, pixel_spacing=(0.7, 0.8), transfer_syntax=_JPLL_SV1)
    nrrd = str(d / 'ct.nrrd')
    port_io.write_image(img, nrrd)
    return str(series), nrrd, img


def test_series_reads_as_the_nrrd(ct_case):
    series, nrrd, img = ct_case
    _assert_same_image(port_io.read_image(series), port_io.read_image(nrrd))
    assert np.array_equal(port_io.read_image(series).array, img.array)


@pytest.fixture(scope='module')
def predictions(model_root, ct_case):
    series, nrrd, _ = ct_case
    out = {}
    for precision, param in (('exact', None), ('fast', FAST)):
        with TS2D(key=KEY, use_remote=False, local=model_root, device='cpu',
                  batching=False, param=param) as tool:
            out['port', precision] = tool.predict(series)
            out['port-nrrd', precision] = tool.predict(nrrd)
        with JaxTS2D(key=KEY, use_remote=False, local=model_root,
                     batching=False, param=param) as tool:
            out['jax', precision] = tool.predict(series)
    return out


@pytest.mark.parametrize('precision', ['exact', 'fast'])
def test_predict_series_equals_nrrd(predictions, precision):
    seg = predictions['port', precision].get_segmentation()
    ref = predictions['port-nrrd', precision].get_segmentation()
    assert seg.array.shape == ref.array.shape
    assert np.array_equal(seg.array, ref.array)
    assert 0 < seg.array.mean() < 1


@pytest.mark.parametrize('precision,bar', [('exact', 0.999), ('fast', 0.99)])
def test_predict_series_matches_reference(predictions, precision, bar):
    seg = predictions['port', precision].get_segmentation().array
    ref = predictions['jax', precision].get_segmentation().array
    assert seg.shape == ref.shape
    agree = float((seg == ref).mean())
    assert agree >= bar, f'mask agreement {agree}'


def _study(root):
    """A study folder: a series subdirectory, an NRRD of the same stem, a
    loose slice, an unsupported file and a zipped series."""
    root.mkdir()
    case = root / 'case1'
    case.mkdir()
    _slices(case, _vol())
    shutil.copy(asset_path('sample_s0521.nrrd'), root / 'case1.nrrd')
    _slices(root, _vol()[:1])  # a loose s000.dcm
    (root / 'notes.txt').write_text('not an image')
    with zipfile.ZipFile(root / 'z.zip', 'w') as zf:
        for f in sorted(case.iterdir()):
            zf.write(f, f'z/{f.name}')
    return root


def test_cli_enumerates_like_the_reference(tmp_path, capsys):
    root = _study(tmp_path / 'study')
    ours = list(_enumerate_cases(str(root)))
    assert ours == list(jax_cases(str(root)))
    assert [n for n, _ in ours] == ['case1', 'case1-2', 'z']
    err = capsys.readouterr().err
    assert 'skipping loose DICOM file s000.dcm' in err
    assert "writing this one as 'case1-2'" in err
    # a series directory given as the source is one case; so is one file
    assert list(_enumerate_cases(str(root / 'case1'))) == \
        [('case1', str(root / 'case1'))]
    single = str(root / 's000.dcm')
    assert list(_enumerate_cases(single)) == list(jax_cases(single))


def test_cli_runs_a_study_folder(model_root, tmp_path, monkeypatch):
    """The CLI on a folder with one series subdirectory and one NRRD: two
    cases, each with its outputs."""
    root = tmp_path / 'study'
    root.mkdir()
    series = root / 'series'
    series.mkdir()
    arr = port_io.read_image(asset_path('sample_s0521.nrrd')).array
    _slices(series, arr[:, :, :40], pixel_spacing=(0.7, 0.8))
    shutil.copy(asset_path('sample_s0521.nrrd'), root / 'ct.nrrd')
    out = tmp_path / 'out'
    monkeypatch.setattr(sys, 'argv', [
        'ts2d-torch', '-i', str(root), '-o', str(out), '--model', KEY,
        '--local', model_root, '--device', 'cpu', '--silent', '--no-fetch'])
    ts2d_entry_point()
    assert sorted(os.listdir(out)) == sorted(
        f'{n}{s}.nrrd' for n in ('ct', 'series')
        for s in ('.seg', '_max', '_mean'))


@pytest.mark.parametrize('entry', ['api', 'cli', 'serve'])
def test_entry_points_default_to_the_card(entry, ct_case, model_root,
                                          tmp_path, monkeypatch):
    """TS2D, the CLI and the server take their device from
    utils/device.resolve_device: without --device / device= they ask for
    the CUDA card, and without one they raise rather than run on the CPU
    (a DICOM series as the input)."""
    import torch

    from totalsegmentator2d_tpu_torch import serve
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    series = ct_case[0]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        if entry == 'api':
            TS2D(key=KEY, local=model_root, fetch_remote=False)
        elif entry == 'cli':
            monkeypatch.setattr(sys, 'argv', [
                'ts2d-torch', '-i', series, '-o', str(tmp_path), '--model',
                KEY, '--local', model_root, '--silent', '--no-fetch'])
            ts2d_entry_point()
        else:
            serve.main(['--model', KEY, '--local', model_root, '--port', '0',
                        '--no-fetch'])
    assert not os.listdir(tmp_path)
