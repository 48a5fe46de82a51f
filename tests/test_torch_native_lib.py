"""The reference package's native IO library, built before any test runs.

``totalsegmentator2d_tpu/_native/libts2dio.so`` is not in git, and only
tests/test_003_native.py's fixture used to build it, on whichever test
worker ran that file; tests that need it elsewhere (the native/Python
differential cases of tests/test_017_dicom.py) skipped on the other workers,
so one tree counted two totals. Every worker imports this module while it
collects, before any test runs: the import runs the same ``make -C csrc``
when the library is absent or lacks a symbol the tests need, one worker at a
time under a file lock, and the others find it built.
"""

import fcntl
import os
import subprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIBRARY = os.path.join(REPO, 'totalsegmentator2d_tpu', '_native',
                       'libts2dio.so')
SYMBOLS = (b'ts2dio_project_max_mean_i16', b'ts2dio_jpegll_decode_diffs')


def _current() -> bool:
    """The library exists and exports the symbols the tests call (read
    from the file, not loaded: a library mapped into this process must not
    be rebuilt under it)."""
    try:
        with open(LIBRARY, 'rb') as f:
            data = f.read()
    except OSError:
        return False
    return all(s in data for s in SYMBOLS)


def _build() -> str:
    """Build the library unless it is current; '' or make's error output."""
    if _current():
        return ''
    os.makedirs(os.path.join(REPO, 'build'), exist_ok=True)
    with open(os.path.join(REPO, 'build', 'libts2dio.lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if _current():  # another worker built it while this one waited
                return ''
            run = subprocess.run(['make', '-C', os.path.join(REPO, 'csrc')],
                                 capture_output=True, text=True)
            return '' if run.returncode == 0 else run.stdout + run.stderr
        except OSError as ex:  # no make on this host
            return str(ex)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


BUILD_ERROR = _build()


def test_library_is_built_and_exports_the_projection():
    import ctypes
    assert not BUILD_ERROR, BUILD_ERROR
    lib = ctypes.CDLL(LIBRARY)
    for symbol in SYMBOLS:
        assert getattr(lib, symbol.decode(), None) is not None
