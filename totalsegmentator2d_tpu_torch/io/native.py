"""Bindings of the package's native host library (``csrc/ts2dio.cc``).

The gzip/zlib payloads of NRRD, NIfTI and MetaImage, the fused MAX + MEAN
host projection of an int16 CT, the unpack of a scan's packed masks into
its Result's arrays, the populated mappings those arrays can live in, and
the serial hot loops of the DICOM codecs (JPEG
Lossless, sequential DCT, JPEG-LS, JPEG 2000) run in C through ctypes.
The library is built with the host C++ compiler and zlib at first use
(:func:`~..ops.cuda.build.host_library`, into the package's ``build/``).
Where it cannot be built (no C++ compiler or zlib headers), Python's
``gzip``/``zlib``, numpy and each codec's Python path give the
same bytes and values, slower; a warning says so once. Each codec wrapper
then returns None (``j2k_t1_block`` False), which sends its caller down
the Python path. ``TS2D_NO_NATIVE`` set (to anything but the empty
string) at the first load takes those paths without the library, as in
the reference package.

``ctypes.CDLL`` releases the GIL for every call, so a projection on the
caller's thread runs beside the micro-batcher's dispatcher thread, and the
slices of a DICOM series decode in parallel on the series pool's threads.
The projection itself runs on several threads over z slabs, and the
masks' assembly over bands of the frame's rows, each on as many as its size
pays for and the process's free cores allow, the two sharing the cores
(:func:`project_max_mean`, :func:`assemble_masks`);
:func:`projection_counts` and :func:`assembly_counts` count their paths.
:func:`map_mask_arrays` maps and populates the arrays of a Result ahead of
its pass, on another thread, so that the pass's writes find their pages
present.
"""

from __future__ import annotations

import ctypes
import os
import threading
import weakref
import zlib
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.logging import warn

#: the library version these bindings were written for (ts2dio_abi_version)
ABI_VERSION = 5

# Threads of a file-level decode pool (io/dicom.py's series pool) set
# ``in_file_worker`` here; nested decode stages (io/jpeg2k.py's code-block
# pool) read it and stay serial inside such workers, so the two levels of
# parallelism never oversubscribe the cores.
decode_worker_local = threading.local()

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
    fn = lib.ts2dio_project_max_mean_i16_mt
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong]
    fn = lib.ts2dio_assemble_masks_mt
    fn.restype = ctypes.c_longlong
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_longlong] * 8
                   + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_longlong])
    lib.ts2dio_map_pages.restype = ctypes.c_void_p
    lib.ts2dio_map_pages.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
    lib.ts2dio_unmap_pages.restype = ctypes.c_longlong
    lib.ts2dio_unmap_pages.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    ll, p, i, d = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_char_p, \
        ctypes.c_double
    signatures = {
        'ts2dio_jpegll_decode_diffs': [i, ctypes.c_size_t, p, p, ll],
        'ts2dio_jpegdct_decode_blocks': [i, ctypes.c_size_t, p, p, p, ll],
        'ts2dio_jpegdct_reconstruct': [p, p, p, p, ll, ll, ll, ll, ll, p],
        'ts2dio_j2k_t1_decode': [i, p, p, ll, ll, ll, ll, ll, i, i, p, p, p],
        'ts2dio_j2k_t1_block': [i, p, p, ll, ll, ll, ll, ll, i, i, ll, d, p,
                                ll],
        'ts2dio_j2k_idwt53': [p, p, p, p, ll, ll, ll, ll, p],
        'ts2dio_j2k_idwt97': [p, p, p, p, ll, ll, ll, ll, p],
        'ts2dio_jpegls_decode': [i, ctypes.c_size_t] + [ll] * 8 + [p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.restype = ll
        fn.argtypes = argtypes
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
            # read once, at the first load, as the reference package does
            if os.environ.get('TS2D_NO_NATIVE'):
                _checked = True
                return None
            try:
                _lib = load_library()
            except (OSError, RuntimeError) as ex:
                warn(f'the native host library is not available ({ex}); '
                     f'Python zlib, numpy and the codecs\' Python paths '
                     f'take its place')
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


#: the most threads one host pass (a projection, a Result's masks) takes
PROJECT_MAX_THREADS = 8
#: the fewest voxels a projection thread is given: below it, starting the
#: thread costs more than its slab saves (an 8-core x86 host projects 2^19
#: voxels in ~0.1 ms on one thread, 2^22 in ~0.3 ms on eight, ~0.7 on one)
PROJECT_SLAB_VOXELS = 1 << 19
#: the fewest output bytes a thread of the masks' assembly is given: an
#: 8-core x86 host writes 1.9 MB in ~0.5 ms on one thread and no faster on
#: more, 7.7 MB in ~9.5 ms on one, ~4.5 on eight
ASSEMBLY_BAND_BYTES = 1 << 20


def usable_cores() -> int:
    """The cores this process may run on."""
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


class _HostPasses:
    """The threaded native host passes running in the process (the MAX +
    MEAN projection and the Result's masks share the cores), and the paths
    each kind of pass took."""

    KINDS = ('projection', 'assembly')

    def __init__(self):
        self._lock = threading.Lock()
        self._running = 0
        self._held = 0      # threads of the passes running
        self._counts = {kind: dict.fromkeys(('threaded', 'serial', 'numpy',
                                             'threads'), 0)
                        for kind in self.KINDS}
        self._counts['assembly']['prefaulted'] = 0

    @contextmanager
    def share(self, units: int, parts: int,
              per_thread: int = PROJECT_SLAB_VOXELS) -> Iterator[int]:
        """The threads one pass of ``units`` of work over ``parts``
        independent parts (a projection's voxels and z slices, an
        assembly's output bytes and rows) takes while the context is open:
        as many as its size pays for (``per_thread`` units each), at most
        its share of the usable cores among the passes running (this one
        included) and none that another holds; one inside a file-level
        decode worker, as the codecs stay serial there."""
        cores = min(usable_cores(), PROJECT_MAX_THREADS)
        serial = getattr(decode_worker_local, 'in_file_worker', False)
        with self._lock:
            self._running += 1
            threads = 1 if serial else max(1, min(
                cores // self._running, cores - self._held,
                units // per_thread, parts))
            self._held += threads
        try:
            yield threads
        finally:
            with self._lock:
                self._running -= 1
                self._held -= threads

    def count(self, kind: str, threads: int, prefaulted: bool = False
              ) -> None:
        """One pass of ``kind`` on ``threads`` native threads (0: numpy's);
        ``prefaulted``: an assembly that wrote into arrays it was given."""
        with self._lock:
            path = ('numpy' if threads == 0 else
                    'serial' if threads == 1 else 'threaded')
            counts = self._counts[kind]
            counts[path] += 1
            counts['threads'] += threads
            if prefaulted:
                counts['prefaulted'] += 1

    def counts(self, kind: str) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts[kind])


_host_passes = _HostPasses()


def projection_counts() -> Dict[str, int]:
    """The process's MAX + MEAN projections by path: ``threaded`` and
    ``serial`` native calls, ``numpy`` (no library, or an input the native
    pass does not take: the caller projects in numpy), and ``threads``,
    the native threads they ran on in all."""
    return _host_passes.counts('projection')


def assembly_counts() -> Dict[str, int]:
    """The process's assemblies of a Result's masks
    (:func:`assemble_masks`) by path, as :func:`projection_counts` counts
    the projections: ``threaded``, ``serial``, ``numpy`` (the caller
    unpacks, places and splits in numpy) and ``threads``; and
    ``prefaulted``, the native passes that wrote into arrays they were
    given (``out``, from :func:`map_mask_arrays`)."""
    return _host_passes.counts('assembly')


def _project_native(lib: ctypes.CDLL, vol: np.ndarray,
                    threads: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The native pass on ``threads`` threads over z slabs."""
    nz, ny, nx = (int(n) for n in vol.shape)
    out_max = np.empty((nz, nx), np.float32)
    out_mean = np.empty((nz, nx), np.float32)
    got = lib.ts2dio_project_max_mean_i16_mt(
        vol.ctypes.data, nz, ny, nx, out_max.ctypes.data, out_mean.ctypes.data,
        threads)
    return (out_max, out_mean) if got == nz * nx else None


def project_max_mean(vol: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The coronal MAX and MEAN of a C-contiguous (Z, Y, X) int16 volume
    along Y in one pass: (max, mean) float32 (Z, X) arrays, or None where
    the library (or the dtype or layout) does not apply. The mean is the
    exact integer sum divided by Y in double, so it equals numpy's
    ``mean(dtype=float64)`` rounded to float32 bit for bit. The pass runs
    on the threads :meth:`_HostPasses.share` gives it, with the same
    result on any number."""
    lib = _load()
    if (lib is None or vol.ndim != 3 or vol.dtype != np.int16
            or not vol.flags.c_contiguous or 0 in vol.shape):
        _host_passes.count('projection', 0)
        return None
    with _host_passes.share(vol.size, vol.shape[0]) as threads:
        res = _project_native(lib, vol, threads)
    _host_passes.count('projection', threads if res is not None else 0)
    return res


# -- the Result's masks --------------------------------------------------------

MaskArrays = Tuple[Optional[np.ndarray], List[Optional[np.ndarray]]]

#: the bytes of a Result's mapping populated at a time
#: (:func:`map_mask_arrays`): a populate holds the process's memory map, so
#: the caller's own allocations and first writes wait for one chunk at most.
#: On an H100's 8-core host, whose kernel serves page faults one at a time,
#: a caller writing 520 MB of fresh memory beside a 1.8 GB populate took
#: 126 ms alone, 239 beside chunks of 2 MiB (the populate 378 ms), 384
#: beside chunks of 32 MiB and 344 beside one populate of the whole (185
#: ms); chunks of 512 KiB took 2.3 s to populate
PAGES_CHUNK_BYTES = 2 << 20
#: the smallest array :func:`map_mask_arrays` maps ahead. glibc's malloc
#: gives an allocation of 32 MiB or more a fresh mapping of its own (its
#: mmap threshold rises to 32 MiB at most), whose pages the pass faults in;
#: a smaller one comes from the heap, whose pages a process that assembled
#: a Result before already holds. On that host, mapping a CT's 36-60 MB
#: Result ahead (every array under 32 MiB) cost a fast solo scan 6-27% of
#: the scans a second and left its pass as it was (~5 ms)
PAGES_MIN_BYTES = 32 << 20


class _Mapping:
    """One private anonymous mapping of the library's, seen by numpy
    through its array interface: the base of the arrays over it, unmapped
    when the last of them is gone (``released``, its finalizer, is then
    dead). At the interpreter's exit a live mapping stays mapped (a
    daemon thread may still read a Result), and the system frees it with
    the process."""

    def __init__(self, lib: ctypes.CDLL, shape: Tuple[int, ...]):
        size = int(np.prod(shape))
        addr = lib.ts2dio_map_pages(size, PAGES_CHUNK_BYTES)
        if not addr:
            raise MemoryError(f'cannot map {size} bytes for a Result\'s '
                              f'masks')
        self.__array_interface__ = {'shape': shape, 'typestr': '|u1',
                                    'data': (addr, False), 'version': 3}
        self.released = weakref.finalize(self, lib.ts2dio_unmap_pages,
                                         addr, size)
        self.released.atexit = False


def maps_ahead(full, counts: Sequence[int], merge: bool) -> bool:
    """Whether :func:`map_mask_arrays` maps any of the Result's arrays
    ahead: one of them, the merged one or a group's, holds
    ``PAGES_MIN_BYTES`` or more."""
    H, W = (int(v) for v in full)
    largest = int(sum(counts)) if merge else max(map(int, counts))
    return H * W * largest >= PAGES_MIN_BYTES


def map_mask_arrays(full, counts: Sequence[int],
                    merge: bool) -> Optional[MaskArrays]:
    """The arrays :func:`assemble_masks` writes a scan's masks into, made
    before it runs: (the merged (H, W, L) array, or None without
    ``merge``; [each group's (H, W, counts[g]) array]), uint8,
    C-contiguous, writable, each a private anonymous mapping of its own
    whose pages are already populated (``PAGES_CHUNK_BYTES`` at a time) and
    unmapped when the last view of it is gone; None in place of each array
    under ``PAGES_MIN_BYTES``, which the pass allocates. The pages are the
    work: a host that serves each first write of a fresh page as a fault
    spends most of a radiograph's pass on them, so a thread maps them while
    the scan is cropped, run and fetched. Their content is not defined: the
    pass writes every byte. None without the library; raises MemoryError
    where the system refuses a mapping."""
    lib = _load()
    if lib is None:
        return None
    H, W = (int(v) for v in full)

    def ahead(n: int) -> Optional[np.ndarray]:
        if H * W * n < PAGES_MIN_BYTES:
            return None
        return np.asarray(_Mapping(lib, (H, W, n)))
    return (ahead(int(sum(counts))) if merge else None,
            [ahead(int(n)) for n in counts])


def _assemble_native(lib: ctypes.CDLL, packed: np.ndarray, window, origin,
                     full, counts: Sequence[int], merge: bool,
                     threads: int, out: Optional[MaskArrays] = None
                     ) -> Optional[MaskArrays]:
    """The native pass on ``threads`` threads over bands of the frame's
    rows, into the arrays of ``out`` and fresh ones in place of its Nones;
    None where the library refuses the layout."""
    sy, sx, h, w = (int(v) for v in window)
    H, W = (int(v) for v in full)
    nb = int(packed.shape[-1])
    merged, parts = out or (None, [None] * len(counts))
    if merge and merged is None:
        merged = np.empty((H, W, int(sum(counts))), np.uint8)
    parts = [np.empty((H, W, int(n)), np.uint8) if p is None else p
             for p, n in zip(parts, counts)]
    ptrs = (ctypes.c_void_p * len(parts))(*(p.ctypes.data for p in parts))
    n_labels = np.asarray(counts, np.int64)
    src = packed.ctypes.data + sy * packed.strides[0] + sx * nb
    got = lib.ts2dio_assemble_masks_mt(
        src, packed.strides[0], nb, h, w, int(origin[0]), int(origin[1]), H,
        W, n_labels.ctypes.data, len(parts),
        merged.ctypes.data if merge else None, ptrs, threads)
    return (merged, parts) if got == H * W else None


def assemble_masks(packed: np.ndarray, window, origin, full,
                   counts: Sequence[int], merge: bool = True,
                   out: Optional[MaskArrays] = None) -> Optional[MaskArrays]:
    """A scan's packed masks as its Result's arrays in one pass: the
    ``window`` (y, x, h, w) of the packed (rows, cols, ceil(L / 8)) uint8
    masks (little bit order, ``np.unpackbits(..., bitorder='little')``)
    unpacked to one byte a label, placed at ``origin`` (y0, x0) of the full
    (H, W) frame with zeros around it, and split by ``counts``, the label
    channels of each group in order. Returns (the merged (H, W, L) array,
    or None without ``merge``; [each group's (H, W, counts[g]) array]),
    every array C-contiguous and its own memory, equal to unpack, place and
    ``np.ascontiguousarray`` of each group's channels; or None without the
    library, or for a layout it does not take (a pixel's bytes not
    contiguous, too few bits, a window off the canvas or the frame), which
    the caller then assembles in numpy. ``out``, arrays of that form for
    the same ``merge`` made ahead (:func:`map_mask_arrays`, at least one of
    them), takes the masks; the pass allocates those it has None for.
    Threads as :meth:`_HostPasses.share` gives them, by the bytes written;
    the same arrays on any number."""
    lib = _load()
    H, W = (int(v) for v in full)
    _, _, h, w = (int(v) for v in window)
    L = int(sum(counts))
    if (lib is None or packed.dtype != np.uint8 or packed.ndim != 3
            or packed.strides[2] != 1
            or packed.strides[1] != packed.shape[2]
            or packed.strides[0] < packed.shape[1] * packed.shape[2]
            or L > 8 * packed.shape[2] or min(counts, default=0) < 1
            or min(h, w, H, W) < 1 or min(window[:2]) < 0
            or window[0] + h > packed.shape[0]
            or window[1] + w > packed.shape[1] or min(origin) < 0
            or origin[0] + h > H or origin[1] + w > W):
        _host_passes.count('assembly', 0)
        return None
    nbytes = H * W * L * (2 if merge else 1)
    with _host_passes.share(nbytes, H, ASSEMBLY_BAND_BYTES) as threads:
        res = _assemble_native(lib, packed, window, origin, full, counts,
                               merge, threads, out)
    _host_passes.count('assembly', threads if res is not None else 0,
                       res is not None and out is not None)
    return res


# -- the DICOM codecs' hot loops ---------------------------------------------

def jpegll_decode_diffs(seg: bytes, lut, count: int) -> Optional[np.ndarray]:
    """Huffman-decode ``count`` JPEG Lossless differences from one
    unstuffed entropy segment. ``lut`` is the 64k-entry uint32 peek table
    of io/jpegll.py. Returns an int32 array, or None without the library
    (jpegll.py's Python loop applies)."""
    lib = _load()
    if lib is None:
        return None
    lut = np.ascontiguousarray(lut, np.uint32)
    out = np.empty(count, np.int32)
    got = lib.ts2dio_jpegll_decode_diffs(seg, len(seg), lut.ctypes.data,
                                         out.ctypes.data, count)
    if got != count:
        from .jpegll import JpegError
        raise JpegError('Truncated entropy segment (stream ended '
                        'mid-sample)' if got == -4 else
                        'Invalid Huffman code in entropy data')
    return out


def jpegdct_decode_blocks(seg: bytes, dc_lut, ac_lut,
                          nblocks: int) -> Optional[np.ndarray]:
    """Huffman-decode ``nblocks`` 8x8 coefficient blocks (zigzag order, DC
    prediction applied) from one unstuffed sequential-DCT entropy segment.
    ``dc_lut``/``ac_lut`` are io/jpegdct.py's 64k-entry uint32 peek
    tables. Returns an (nblocks, 64) int32 array, or None without the
    library."""
    lib = _load()
    if lib is None:
        return None
    dc_lut = np.ascontiguousarray(dc_lut, np.uint32)
    ac_lut = np.ascontiguousarray(ac_lut, np.uint32)
    out = np.zeros((nblocks, 64), np.int32)
    got = lib.ts2dio_jpegdct_decode_blocks(
        seg, len(seg), dc_lut.ctypes.data, ac_lut.ctypes.data,
        out.ctypes.data, nblocks)
    if got != nblocks:
        from .jpegll import JpegError
        raise JpegError('Invalid Huffman code in entropy data'
                        if got == -2 else
                        'AC run past end of block' if got == -3 else
                        'Truncated entropy segment (stream ended '
                        'mid-block)' if got == -4 else
                        f'native JPEG decode failed (code {got})')
    return out


def jpegdct_reconstruct(coefs, q, zigzag, m, bw: int, bh: int, rows: int,
                        cols: int, precision: int) -> Optional[np.ndarray]:
    """Dequantize, de-zigzag, 2-D IDCT, level-shift and reassemble all of
    a sequential-DCT image's blocks. ``coefs`` is the (nblocks, 64) int32
    output of the entropy decoder; ``q``/``zigzag``/``m`` are the caller's
    quantizer row, zigzag map and orthonormal IDCT matrix (the numpy path's
    constants). Returns the (rows, cols) uint8/uint16 image, or None
    without the library (or when ``coefs`` has the wrong shape, which the
    numpy path then reports)."""
    lib = _load()
    if lib is None:
        return None
    coefs = np.ascontiguousarray(coefs, np.int32)
    if coefs.shape != (bw * bh, 64):
        return None
    q = np.ascontiguousarray(q, np.uint16)
    zigzag = np.ascontiguousarray(zigzag, np.int32)
    m = np.ascontiguousarray(m, np.float64)
    out = np.empty((rows, cols), np.uint8 if precision == 8 else np.uint16)
    got = lib.ts2dio_jpegdct_reconstruct(
        coefs.ctypes.data, q.ctypes.data, zigzag.ctypes.data, m.ctypes.data,
        bw, bh, rows, cols, precision, out.ctypes.data)
    return out if got == rows * cols else None


def _j2k_segments(segments):
    data = b''.join(d for d, _ in segments)
    seg_lens = np.array([len(d) for d, _ in segments], np.int64)
    seg_passes = np.array([n for _, n in segments], np.int64)
    return data, seg_lens, seg_passes


def _j2k_error(got: int):
    from .jpeg2k import Jpeg2kError
    return Jpeg2kError(
        'More coding passes than bit planes' if got == -2 else
        'Segmentation symbol mismatch (corrupt entropy data)'
        if got == -3 else f'native Tier-1 decode failed (code {got})')


def j2k_t1_decode(segments, w: int, h: int, style: int, start_plane: int,
                  sig_tab, sign_lut):
    """Run a JPEG 2000 code block's Tier-1 coding passes. ``segments`` is
    the [(bytes, n_passes), ...] list of io/jpeg2k.py's _BlockDecoder.run;
    ``sig_tab`` the 75-entry uint8 significance-context row of the block's
    orientation; ``sign_lut`` the (9, 2) uint8 sign table. Returns (mag,
    lastp, signs) arrays, or None without the library. Raises Jpeg2kError
    on corrupt streams, as the Python loop does."""
    lib = _load()
    if lib is None:
        return None
    data, seg_lens, seg_passes = _j2k_segments(segments)
    sig_tab = np.ascontiguousarray(sig_tab, np.uint8)
    sign_lut = np.ascontiguousarray(sign_lut, np.uint8)
    mag = np.zeros((h, w), np.int32)
    lastp = np.zeros((h, w), np.int32)
    signs = np.zeros((h, w), np.uint8)
    got = lib.ts2dio_j2k_t1_decode(
        data, seg_lens.ctypes.data, seg_passes.ctypes.data, len(segments),
        w, h, style, start_plane, sig_tab.tobytes(), sign_lut.tobytes(),
        mag.ctypes.data, lastp.ctypes.data, signs.ctypes.data)
    if got < 0:
        raise _j2k_error(got)
    return mag, lastp, signs


def j2k_t1_block(segments, w: int, h: int, style: int, start_plane: int,
                 sig_tab, sign_lut, reversible: bool, delta: float,
                 dst: np.ndarray) -> bool:
    """One-call code-block decode: the Tier-1 passes and the midpoint
    reconstruction (and, irreversible, the dequantization by ``delta``),
    written into ``dst``, a 2-D view into the band's coefficients (int64
    reversible, float64 otherwise; rows contiguous). Returns True, or False
    without the library or for a view it cannot take (the caller falls
    back to j2k_t1_decode or the Python loop). Raises Jpeg2kError on
    corrupt streams."""
    lib = _load()
    if lib is None:
        return False
    want = np.int64 if reversible else np.float64
    if (dst.dtype != want or dst.ndim != 2
            or dst.strides[1] != dst.itemsize
            or dst.strides[0] % dst.itemsize):
        return False
    data, seg_lens, seg_passes = _j2k_segments(segments)
    sig_tab = np.ascontiguousarray(sig_tab, np.uint8)
    sign_lut = np.ascontiguousarray(sign_lut, np.uint8)
    got = lib.ts2dio_j2k_t1_block(
        data, seg_lens.ctypes.data, seg_passes.ctypes.data, len(segments),
        w, h, style, start_plane, sig_tab.tobytes(), sign_lut.tobytes(),
        1 if reversible else 0, float(delta), dst.ctypes.data,
        dst.strides[0] // dst.itemsize)
    if got < 0:
        raise _j2k_error(got)
    return True


def j2k_idwt_level(ll, hl, lh, hh, x0: int, y0: int, x1: int, y1: int,
                   reversible: bool) -> Optional[np.ndarray]:
    """One 2-D inverse-DWT synthesis level (T.800 Annex F): interleave the
    four subbands of the region [x0, x1) x [y0, y1) and run the 5/3 (int64)
    or 9/7 (float64) lifting, bit for bit as io/jpeg2k.py's _idwt_level
    (the library builds with -ffp-contract=off). Returns the (h, w) array,
    or None without the library."""
    lib = _load()
    if lib is None:
        return None
    dt = np.int64 if reversible else np.float64
    ll, hl, lh, hh = (np.ascontiguousarray(a, dt) for a in (ll, hl, lh, hh))
    out = np.empty((y1 - y0, x1 - x0), dt)
    fn = lib.ts2dio_j2k_idwt53 if reversible else lib.ts2dio_j2k_idwt97
    got = fn(ll.ctypes.data, hl.ctypes.data, lh.ctypes.data, hh.ctypes.data,
             x0, y0, x1, y1, out.ctypes.data)
    return out if got == (y1 - y0) * (x1 - x0) else None


def jpegls_decode(data: bytes, w: int, h: int, maxval: int, near: int,
                  t1: int, t2: int, t3: int,
                  reset: int) -> Optional[np.ndarray]:
    """Decode one JPEG-LS scan's entropy data (everything after SOS) with
    io/jpegls.py's resolved coding parameters. Returns an (h, w) int32
    array, or None without the library (the Python scan loop applies).
    Raises JpegLsError on corrupt streams, as the Python loop does."""
    lib = _load()
    if lib is None:
        return None
    out = np.zeros((h, w), np.int32)
    got = lib.ts2dio_jpegls_decode(data, len(data), w, h, maxval, near, t1,
                                   t2, t3, reset, out.ctypes.data)
    if got != h * w:
        from .jpegls import JpegLsError
        raise JpegLsError(
            'Truncated entropy segment' if got == -4 else
            'Run length exceeds the line' if got == -5 else
            'Corrupt entropy data (runaway Golomb code)' if got == -6 else
            f'native JPEG-LS decode failed (code {got})')
    return out
