"""Bindings of the package's native host library (``csrc/ts2dio.cc``).

The gzip/zlib payloads of NRRD, NIfTI and MetaImage and the fused MAX +
MEAN host projection of an int16 CT run in C through ctypes. The library
is built with the host C++ compiler and zlib at first use
(:func:`~..ops.cuda.build.host_library`, into the package's ``build/``).
Where it cannot be built (no C++ compiler or zlib headers), Python's
``gzip``/``zlib`` and numpy give the same bytes and values, slower; a
warning says so once.

``ctypes.CDLL`` releases the GIL for every call, so a projection on the
caller's thread runs beside the micro-batcher's dispatcher thread.
"""

from __future__ import annotations

import ctypes
import threading
import zlib
from typing import Optional, Tuple

import numpy as np

from ..utils.logging import warn

#: the library version these bindings were written for (ts2dio_abi_version)
ABI_VERSION = 1

_lock = threading.Lock()
_lib = None
_checked = False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ts2dio_abi_version.restype = ctypes.c_longlong
    lib.ts2dio_abi_version.argtypes = []
    abi = int(lib.ts2dio_abi_version())
    if abi != ABI_VERSION:
        raise OSError(f'library version {abi}, expected {ABI_VERSION}')
    lib.ts2dio_inflate_bound.restype = ctypes.c_longlong
    lib.ts2dio_inflate_bound.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.ts2dio_inflate.restype = ctypes.c_longlong
    lib.ts2dio_inflate.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.c_void_p, ctypes.c_size_t]
    for fn in (lib.ts2dio_deflate_gzip, lib.ts2dio_deflate_zlib):
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                       ctypes.c_size_t, ctypes.c_int]
    fn = lib.ts2dio_project_max_mean_i16
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def load_library(defines=()) -> ctypes.CDLL:
    """Build (once) and bind the library; raises when it cannot be had.
    ``defines`` build a variant (the tests use a small stream window)."""
    from ..ops.cuda.build import host_library
    return _bind(host_library('ts2dio', defines))


def _load():
    global _lib, _checked
    if _checked:
        return _lib
    with _lock:
        if not _checked:
            try:
                _lib = load_library()
            except (OSError, RuntimeError) as ex:
                warn(f'the native host library is not available ({ex}); '
                     f'Python zlib and numpy take its place')
            _checked = True
    return _lib


def native_available() -> bool:
    return _load() is not None


def _buffer(size: int) -> Tuple[np.ndarray, int]:
    """An uninitialised output buffer (a numpy array: ctypes' string
    buffers zero-fill) and its address."""
    buf = np.empty(max(int(size), 1), np.uint8)
    return buf, buf.ctypes.data


def gzip_decompress(data: bytes, size: Optional[int] = None) -> bytes:
    """Inflate a gzip- or zlib-wrapped payload (NRRD 'gzip', NIfTI .gz,
    MetaImage CompressedData). ``size``, the inflated size a header
    declares, spares the native path the counting pass a zlib stream (no
    ISIZE trailer) needs for its bound; a stream longer than that falls
    back to Python's."""
    lib = _load()
    if lib is not None:
        # a header is untrusted: deflate expands at most ~1032:1, so a
        # larger claim cannot hold and must not size the buffer
        if size is None or size > 1032 * len(data) + 64:
            size = lib.ts2dio_inflate_bound(data, len(data))
        if size >= 0:
            buf, ptr = _buffer(size)
            got = lib.ts2dio_inflate(data, len(data), ptr, buf.size)
            if got >= 0:
                return buf[:got].tobytes()
    if data[:2] == b'\x1f\x8b':
        # gzip framing: gzip.decompress reads concatenated members
        # (pigz/bgzip), which zlib would truncate to the first; the native
        # inflate fails rather than truncate when its bound, the last
        # member's ISIZE, is too small, and lands here
        import gzip
        return gzip.decompress(data)
    return zlib.decompress(data)


def _deflate(fn_name: str, data: bytes, level: int) -> Optional[bytes]:
    lib = _load()
    if lib is None:
        return None
    bound = len(data) + (len(data) >> 9) + 128
    buf, ptr = _buffer(bound)
    got = getattr(lib, fn_name)(data, len(data), ptr, bound, int(level))
    return buf[:got].tobytes() if got >= 0 else None


def gzip_compress(data: bytes, level: int = 1) -> bytes:
    """Deflate to gzip format (NRRD 'gzip' encoding, .nii.gz)."""
    out = _deflate('ts2dio_deflate_gzip', data, level)
    if out is not None:
        return out
    c = zlib.compressobj(level, zlib.DEFLATED, 31)
    return c.compress(data) + c.flush()


def zlib_compress(data: bytes, level: int = 1) -> bytes:
    """Deflate to zlib format (MetaImage CompressedData)."""
    out = _deflate('ts2dio_deflate_zlib', data, level)
    return out if out is not None else zlib.compress(data, level)


def project_max_mean(vol: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The coronal MAX and MEAN of a C-contiguous (Z, Y, X) int16 volume
    along Y in one pass: (max, mean) float32 (Z, X) arrays, or None where
    the library (or the dtype or layout) does not apply. The mean is the
    exact int64 sum divided by Y in double, so it equals numpy's
    ``mean(dtype=float64)`` rounded to float32 bit for bit."""
    lib = _load()
    if (lib is None or vol.ndim != 3 or vol.dtype != np.int16
            or not vol.flags.c_contiguous or 0 in vol.shape):
        return None
    nz, ny, nx = (int(n) for n in vol.shape)
    out_max = np.empty((nz, nx), np.float32)
    out_mean = np.empty((nz, nx), np.float32)
    got = lib.ts2dio_project_max_mean_i16(
        vol.ctypes.data, nz, ny, nx, out_max.ctypes.data, out_mean.ctypes.data)
    if got != nz * nx:
        return None
    return out_max, out_mean
