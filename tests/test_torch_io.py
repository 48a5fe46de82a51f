"""The PyTorch port's image IO (totalsegmentator2d_tpu_torch.io) against the
reference package's: NRRD, NIfTI (.nii, .nii.gz) and MetaImage (.mha,
.mhd, compressed or not) written by one package and read by the other,
both ways, with arrays, spacing, origin and direction equal (scalar and
vector images); the reference's own IO edge cases (tests/test_001_io.py)
run on the port's readers; PNG export by the port's own encoder decodes to
the pixels of the reference's PIL-written PNG."""

import struct
import zlib

import numpy as np
import pytest

from totalsegmentator2d_tpu import io as jax_io
from totalsegmentator2d_tpu.io import MedicalImage as JaxImage
from totalsegmentator2d_tpu_torch import io as port_io
from totalsegmentator2d_tpu_torch.io import MedicalImage, metaimage, nifti, nrrd

FORMATS = [('nrrd', True), ('nrrd', False), ('nii', None), ('nii.gz', None),
           ('mha', True), ('mha', False), ('mhd', True), ('mhd', False)]


def _direction(d, rng):
    """A rotation with a reflection-free, non-axis-aligned direction."""
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    return q * np.sign(np.linalg.det(q))


def _image(kind, rng, cls):
    if kind == 'scalar3d':
        arr = rng.integers(-1024, 3000, (6, 7, 9)).astype(np.int16)
        return cls(array=arr, spacing=(0.7, 0.8, 2.5), origin=(-12.5, 3.0, 40.25),
                   direction=_direction(3, rng))
    if kind == 'float3d':
        arr = rng.normal(size=(5, 1, 8)).astype(np.float32)
        return cls(array=arr, spacing=(0.9, 400.0, 1.5), origin=(1.0, 2.0, 3.0))
    if kind == 'vector3d':
        arr = (rng.random((5, 1, 6, 4)) > 0.5).astype(np.uint8)
        return cls(array=arr, spacing=(0.8, 300.0, 1.25), origin=(5.0, -6.0, 7.0),
                   is_vector=True)
    arr = rng.normal(size=(7, 9, 2)).astype(np.float32)  # vector2d
    return cls(array=arr, spacing=(1.5, 0.5), origin=(-3.0, 4.0),
               direction=_direction(2, rng), is_vector=True)


def _same(a, b):
    assert a.is_vector == b.is_vector
    assert a.array.dtype == b.array.dtype
    np.testing.assert_array_equal(a.array, b.array)
    np.testing.assert_allclose(a.spacing, b.spacing, rtol=1e-6)
    np.testing.assert_allclose(a.origin, b.origin, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(a.direction, b.direction, atol=1e-6)


def _write(io, img, path, compress):
    if compress is None:
        io.write_image(img, path)
    else:
        io.write_image(img, path, compress=compress)


@pytest.mark.parametrize('kind', ['scalar3d', 'float3d', 'vector3d', 'vector2d'])
@pytest.mark.parametrize('ext,compress', FORMATS)
def test_port_writes_reference_reads(tmp_path, kind, ext, compress):
    rng = np.random.default_rng(1)
    img = _image(kind, rng, MedicalImage)
    path = str(tmp_path / f'x.{ext}')
    _write(port_io, img, path, compress)
    _same(jax_io.read_image(path), img)
    _same(port_io.read_image(path), jax_io.read_image(path))


@pytest.mark.parametrize('kind', ['scalar3d', 'float3d', 'vector3d', 'vector2d'])
@pytest.mark.parametrize('ext,compress', FORMATS)
def test_reference_writes_port_reads(tmp_path, kind, ext, compress):
    rng = np.random.default_rng(2)
    img = _image(kind, rng, JaxImage)
    path = str(tmp_path / f'x.{ext}')
    _write(jax_io, img, path, compress)
    _same(port_io.read_image(path), img)


def test_nrrd_meta_roundtrip(tmp_path, rng):
    img = MedicalImage(array=rng.integers(0, 3, (4, 5, 6)).astype(np.uint8),
                       meta={'Segment0_Name': 'heart', 'Segment0_Color': '1 0 0'})
    path = str(tmp_path / 'm.seg.nrrd')
    port_io.write_image(img, path)
    assert jax_io.read_image(path).meta == img.meta
    assert port_io.read_image(path).meta == img.meta


def _nifti_bytes(path, arr, **fields):
    """A NIfTI-1 file of the port writer with the given header fields set
    (offsets of the NIfTI-1 standard)."""
    nifti.write(MedicalImage(array=arr, spacing=(0.7, 0.9, 2.0)), path)
    with open(path, 'rb') as f:
        raw = bytearray(f.read())
    offsets = {'pixdim': (76, '<8f'), 'qform_code': (252, '<h'),
               'sform_code': (254, '<h'), 'quatern': (256, '<6f'),
               'srow': (280, '<12f'), 'scl': (112, '<2f')}
    for k, v in fields.items():
        off, fmt = offsets[k]
        struct.pack_into(fmt, raw, off, *v)
    return bytes(raw)


@pytest.mark.parametrize('case', ['qform', 'pixdim', 'sform', 'scaled',
                                  'qfac'])
def test_nifti_geometry_sources_match_reference(tmp_path, rng, case):
    """The sform, then the qform quaternion, then pixdim; scl_slope and
    scl_inter applied; RAS -> LPS: the port reads what the reference
    reads."""
    arr = rng.integers(-100, 100, (4, 5, 6)).astype(np.int16)
    fields = {
        'qform': dict(sform_code=(0,), qform_code=(1,),
                      quatern=(0.1, -0.2, 0.3, 5.0, -6.0, 7.0)),
        'qfac': dict(sform_code=(0,), qform_code=(1,),
                     pixdim=(-1.0, 0.7, 0.9, 2.0, 1, 1, 1, 1),
                     quatern=(0.0, 0.0, 0.7071, 1.0, 2.0, 3.0)),
        'pixdim': dict(sform_code=(0,), qform_code=(0,)),
        'sform': dict(srow=(0.0, 0.9, 0.1, 4.0, -0.7, 0.0, 0.0, -2.0,
                            0.0, 0.1, 2.0, 8.0)),
        'scaled': dict(scl=(0.5, -3.0)),
    }[case]
    p = tmp_path / 'g.nii'
    p.write_bytes(_nifti_bytes(str(p), arr, **fields))
    a, b = port_io.read_image(str(p)), jax_io.read_image(str(p))
    _same(a, b)
    if case == 'scaled':
        np.testing.assert_array_equal(a.array, arr.astype(np.float32) * 0.5 - 3.0)


def test_nifti_gz_is_gzip_through_native(tmp_path, rng):
    img = MedicalImage(array=rng.integers(-5, 5, (3, 4, 5)).astype(np.int16))
    p = str(tmp_path / 'z.nii.gz')
    port_io.write_image(img, p)
    import gzip
    with open(p, 'rb') as f:
        raw = gzip.decompress(f.read())
    assert struct.unpack('<i', raw[:4])[0] == 348
    _same(port_io.read_image(p), img)


def test_metaimage_compressed_data_size(tmp_path, rng):
    """CompressedDataSize bounds the stream: bytes after it are not the
    image's, and a size past the data is refused."""
    img = MedicalImage(array=rng.integers(0, 9, (3, 4, 5)).astype(np.int16))
    p = tmp_path / 'c.mha'
    metaimage.write(img, str(p))
    data = p.read_bytes()
    assert b'CompressedDataSize = ' in data
    p.write_bytes(data + b'trailing bytes')
    _same(port_io.read_image(str(p)), img)
    size = int(data.split(b'CompressedDataSize = ')[1].split(b'\n')[0])
    p.write_bytes(data.replace(f'CompressedDataSize = {size}'.encode(),
                               f'CompressedDataSize = {size + 10**6}'.encode()))
    with pytest.raises(ValueError, match='CompressedDataSize'):
        port_io.read_image(str(p))


def test_metaimage_msb_and_detached(tmp_path, rng):
    """BinaryDataByteOrderMSB and a detached .mhd with its .raw file."""
    arr = rng.integers(-300, 300, (3, 4)).astype(np.int16)
    (tmp_path / 'b.raw').write_bytes(arr.astype('>i2').tobytes())
    hdr = ('ObjectType = Image\nNDims = 2\nBinaryData = True\n'
           'BinaryDataByteOrderMSB = True\nDimSize = 4 3\n'
           'ElementSpacing = 0.5 2\nElementType = MET_SHORT\n'
           'ElementDataFile = b.raw\n')
    (tmp_path / 'b.mhd').write_text(hdr)
    a = port_io.read_image(str(tmp_path / 'b.mhd'))
    np.testing.assert_array_equal(a.array, arr)
    _same(a, jax_io.read_image(str(tmp_path / 'b.mhd')))


# -- the reference's IO edge cases (tests/test_001_io.py) on the port ----------

def _nrrd_header(**over):
    base = {
        'type': 'short', 'dimension': '2', 'space dimension': '2',
        'sizes': '4 3', 'space directions': '(1,0) (0,1)',
        'kinds': 'domain domain', 'encoding': 'raw', 'space origin': '(0,0)',
    }
    base.update(over)
    return 'NRRD0004\n' + ''.join(f'{k}: {v}\n' for k, v in base.items()) + '\n'


def test_nrrd_big_endian(tmp_path):
    arr = np.arange(12, dtype=np.int16).reshape(3, 4)
    p = tmp_path / 'b.nrrd'
    p.write_bytes(_nrrd_header(endian='big').encode() + arr.astype('>i2').tobytes())
    np.testing.assert_array_equal(port_io.read_image(str(p)).array, arr)


def test_nrrd_detached_header(tmp_path):
    arr = np.arange(12, dtype=np.int16).reshape(3, 4)
    (tmp_path / 'c.raw').write_bytes(arr.astype('<i2').tobytes())
    p = tmp_path / 'c.nhdr'
    p.write_text(_nrrd_header(**{'endian': 'little', 'data file': 'c.raw'}))
    np.testing.assert_array_equal(port_io.read_image(str(p)).array, arr)


def test_nifti_nan_slope_ignored(tmp_path, rng):
    """scl_slope = NaN means 'unset': the volume comes back intact."""
    img = MedicalImage(array=rng.integers(-100, 100, (4, 5, 6)).astype(np.int16),
                       spacing=(1.0, 1.0, 1.0))
    p = str(tmp_path / 'x.nii')
    port_io.write_image(img, p)
    raw = bytearray(open(p, 'rb').read())
    struct.pack_into('<f', raw, 112, float('nan'))
    struct.pack_into('<f', raw, 116, float('nan'))
    open(p, 'wb').write(bytes(raw))
    back = port_io.read_image(p)
    np.testing.assert_array_equal(back.array, img.array)
    assert back.array.dtype == np.int16


def test_nrrd_multimember_gzip(tmp_path, rng):
    """A NRRD whose gzip payload is two concatenated members (pigz/bgzip)
    decodes in full."""
    import gzip
    arr = rng.integers(-500, 500, (6, 5, 4)).astype(np.int16)
    raw = arr.tobytes()
    hdr = ('NRRD0004\ntype: short\ndimension: 3\nspace: left-posterior-superior\n'
           'sizes: 4 5 6\nspace directions: (1,0,0) (0,1,0) (0,0,1)\n'
           'kinds: domain domain domain\nendian: little\nencoding: gzip\n'
           'space origin: (0,0,0)\n\n')
    p = tmp_path / 'm.nrrd'
    p.write_bytes(hdr.encode() + gzip.compress(raw[:100]) + gzip.compress(raw[100:]))
    np.testing.assert_array_equal(port_io.read_image(str(p)).array, arr)


@pytest.mark.parametrize('name,compress', [
    ('a.nrrd', True), ('b.nrrd', False), ('c.nii', False),
    ('d.nii.gz', True), ('e.mha', True), ('f.mha', False)])
def test_mutations_contained(tmp_path, name, compress):
    """Malformed files surface as ValueError, never a foreign exception
    (the reference's seeded fuzz slice, on the port's readers)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    arr = rng.integers(-500, 1500, (4, 8, 9)).astype(np.int16)
    img = MedicalImage(array=arr, spacing=(0.7, 0.8, 2.5))
    p = tmp_path / name
    port_io.write_image(img, str(p), compress=compress)
    base = bytearray(p.read_bytes())
    pm = tmp_path / ('mut_' + name)
    for _ in range(120):
        data = bytearray(base)
        for _ in range(int(rng.integers(1, 6))):
            data[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
        pm.write_bytes(bytes(data))
        try:
            out = port_io.read_image(str(pm))
            assert out.array.size <= 1 << 28
        except ValueError:
            pass
    for _ in range(40):
        pm.write_bytes(bytes(base[:int(rng.integers(1, len(base)))]))
        try:
            port_io.read_image(str(pm))
        except ValueError:
            pass


def test_datafile_traversal_rejected(tmp_path):
    """A detached header is untrusted input: absolute or escaping data-file
    references are refused, not followed."""
    victim = tmp_path / 'victim.bin'
    victim.write_bytes(b'\x01\x02' * 40)
    sub = tmp_path / 'sub'
    sub.mkdir()
    for ref in ['../victim.bin', str(victim)]:
        mhd = sub / 'x.mhd'
        mhd.write_text('NDims = 2\nDimSize = 4 5\nElementType = MET_SHORT\n'
                       f'ElementDataFile = {ref}\n')
        with pytest.raises(ValueError, match='data file reference'):
            metaimage.read(str(mhd))
        nhdr = sub / 'x.nhdr'
        nhdr.write_text('NRRD0004\ntype: short\ndimension: 2\n'
                        f'sizes: 4 5\ndata file: {ref}\n\n')
        with pytest.raises(ValueError, match='data file reference'):
            nrrd.read(str(nhdr))


def test_sibling_datafile_still_reads(tmp_path):
    arr = (np.arange(20) % 7).astype(np.int16).reshape(4, 5)
    (tmp_path / 'x.raw').write_bytes(arr.tobytes())
    (tmp_path / 'x.mhd').write_text('NDims = 2\nDimSize = 5 4\n'
                                    'ElementType = MET_SHORT\n'
                                    'ElementDataFile = x.raw\n')
    np.testing.assert_array_equal(metaimage.read(str(tmp_path / 'x.mhd')).array, arr)


@pytest.mark.parametrize('name,slice_', [
    ('x.dcm', 'DICOM'), ('x.zip', 'zip'), ('x.png', 'raster input'),
    ('x.tif', 'raster input')])
def test_later_slices_raise(tmp_path, name, slice_):
    """DICOM files, series directories, zipped series and raster inputs
    (the raster input slice) are read now: on garbage bytes the port raises
    what the reference package raises (tests/test_torch_dicom.py and
    tests/test_torch_raster.py hold the reads themselves); a raster names
    the same corruption, in its decoder's words."""
    p = tmp_path / name
    p.write_bytes(b'\0' * 16)
    if slice_ == 'raster input':
        for io_ in (jax_io, port_io):
            with pytest.raises(ValueError, match='Corrupt raster image file'):
                io_.read_image(str(p))
    paths = [str(tmp_path)] + ([str(p)] if slice_ != 'raster input' else [])
    for path in paths:  # a directory is a DICOM series
        with pytest.raises(Exception) as ref:
            jax_io.read_image(path)
        with pytest.raises(Exception) as ours:
            port_io.read_image(path)
        assert type(ours.value).__name__ == type(ref.value).__name__
        assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match='Unsupported'):
        port_io.write_image(MedicalImage(array=np.zeros((2, 2), np.uint8)),
                            str(tmp_path / 'x.jpg'))


# -- PNG ------------------------------------------------------------------------

def _png_chunks(data):
    assert data[:8] == b'\x89PNG\r\n\x1a\n'
    pos, chunks = 8, []
    while pos < len(data):
        n = struct.unpack('>I', data[pos:pos + 4])[0]
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = struct.unpack('>I', data[pos + 8 + n:pos + 12 + n])[0]
        assert crc == zlib.crc32(kind + body)
        chunks.append((kind, body))
        pos += 12 + n
    return chunks


@pytest.mark.parametrize('kind', ['gray', 'rgb', 'gray3d', 'float', 'rgb3d'])
def test_png_matches_reference(tmp_path, rng, kind):
    """The port's encoder: signature, IHDR, one IDAT of filter-0 rows, IEND;
    PIL decodes it to the pixels of the reference's PIL-written PNG."""
    Image = pytest.importorskip('PIL.Image')
    arr, vec, sp = {
        'gray': (rng.integers(0, 256, (13, 17)).astype(np.uint8), False, (1.0, 1.0)),
        'rgb': (rng.integers(0, 256, (9, 11, 3)).astype(np.uint8), True, (1.0, 1.0)),
        'gray3d': (rng.integers(0, 256, (6, 1, 8)).astype(np.uint8), False,
                   (1.0, 1.0, 1.0)),
        'float': (rng.normal(100, 120, (7, 5)).astype(np.float32), False, (1.0, 1.0)),
        'rgb3d': (rng.integers(0, 256, (5, 1, 4, 3)).astype(np.uint8), True,
                  (1.0, 1.0, 1.0)),
    }[kind]
    port_io.write_image(MedicalImage(array=arr, spacing=sp, is_vector=vec),
                        str(tmp_path / 'p.png'))
    jax_io.write_image(JaxImage(array=arr, spacing=sp, is_vector=vec),
                       str(tmp_path / 'j.png'))
    a = np.asarray(Image.open(tmp_path / 'p.png'))
    b = np.asarray(Image.open(tmp_path / 'j.png'))
    assert a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    chunks = _png_chunks((tmp_path / 'p.png').read_bytes())
    assert [k for k, _ in chunks] == [b'IHDR', b'IDAT', b'IEND']
    w, h, depth, color = struct.unpack('>IIBB', chunks[0][1][:10])
    assert (h, w, depth, color) == (b.shape[0], b.shape[1], 8, 2 if vec else 0)
    rows = np.frombuffer(zlib.decompress(chunks[1][1]), np.uint8).reshape(h, -1)
    assert not rows[:, 0].any()  # filter 0 on every row
    np.testing.assert_array_equal(rows[:, 1:].reshape(b.shape), b)


def test_png_rejects(tmp_path):
    with pytest.raises(ValueError, match='2D'):
        port_io.write_image(MedicalImage(array=np.zeros((3, 4, 5), np.uint8)),
                            str(tmp_path / 'x.png'))
    with pytest.raises(ValueError, match='gray or RGB'):
        port_io.write_image(MedicalImage(array=np.zeros((3, 4, 2), np.uint8),
                                         is_vector=True), str(tmp_path / 'y.png'))


def test_image_helpers_match_reference(rng):
    from totalsegmentator2d_tpu.io import image as jax_image
    from totalsegmentator2d_tpu_torch.io import image
    for dt in (np.uint8, np.uint16, np.int8, np.bool_, np.int16, np.float32,
               np.int32, np.uint64):
        assert image.is_label_dtype(dt) == jax_image.is_label_dtype(dt)
    ref = MedicalImage(array=np.zeros((2, 3)), spacing=(0.5, 2.0),
                       origin=(1.0, 2.0), meta={'k': 'v'})
    img = image.image_from_array(rng.normal(size=(2, 3)), ref=ref)
    assert img.spacing == ref.spacing and img.origin == ref.origin
    assert img.meta == ref.meta and not image.is_label_image(img)
