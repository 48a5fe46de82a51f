"""Crash-safe temporary directories and atomic output destinations.

Same guarantees as the reference tool (ts2d/core/util/temp.py:14-182): temp
dirs carry an owner-info sidecar (pid + create time) so orphans left by
crashed processes are reaped on the next run, and final outputs are written
to a scratch location then atomically moved into place. The owner checks
use ``psutil`` where it is installed; without it no directory counts as an
orphan, so nothing is reaped. The root is ``$TS2D_TEMP``, else ``ts2d``
under the system's temporary directory (``$TMPDIR``).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

from .logging import warn

_INFO_NAME = '~INFO.json'


def _temp_root() -> str:
    root = os.environ.get('TS2D_TEMP')
    if not root:
        root = os.path.join(tempfile.gettempdir(), 'ts2d')
    os.makedirs(root, exist_ok=True)
    return root


def _proc_identity(pid: int | None = None):
    try:
        import psutil
        p = psutil.Process(pid)
        return {'pid': p.pid, 'create_time': p.create_time(), 'name': p.name()}
    except Exception:
        return {'pid': pid if pid is not None else os.getpid(), 'create_time': None, 'name': None}


def _is_alive(info: dict) -> bool:
    try:
        import psutil
        pid = info.get('pid')
        if pid is None or not psutil.pid_exists(pid):
            return False
        p = psutil.Process(pid)
        ct = info.get('create_time')
        if ct is not None and abs(p.create_time() - ct) > 1.0:
            return False  # pid recycled by another process
        return True
    except Exception:
        return True  # be conservative: never reap when unsure


def reap_orphans(root: str | None = None) -> int:
    """Delete temp dirs whose owning process is gone. Returns count removed."""
    root = root or _temp_root()
    removed = 0
    try:
        entries = os.listdir(root)
    except OSError:
        return 0
    for name in entries:
        path = os.path.join(root, name)
        info_path = os.path.join(path, _INFO_NAME)
        if not os.path.isdir(path) or not os.path.exists(info_path):
            continue
        try:
            with open(info_path) as f:
                info = json.load(f)
        except Exception:
            continue
        if not _is_alive(info):
            shutil.rmtree(path, ignore_errors=True)
            removed += 1
    return removed


class SafeTemporaryDirectory:
    """Temporary directory that records its owner and reaps orphans.

    Usable as a context manager; cleanup retries briefly to tolerate
    slow file-handle release.
    """

    def __init__(self, prefix: str = 'ts2d-', reap: bool = True):
        root = _temp_root()
        if reap:
            reap_orphans(root)
        self.path = tempfile.mkdtemp(prefix=prefix, dir=root)
        with open(os.path.join(self.path, _INFO_NAME), 'w') as f:
            json.dump(_proc_identity(), f)

    def __enter__(self) -> str:
        return self.path

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self.cleanup()

    def cleanup(self, retries: int = 3, delay: float = 0.1) -> None:
        for attempt in range(retries):
            try:
                shutil.rmtree(self.path)
                return
            except OSError:
                if attempt == retries - 1:
                    warn(f'Failed to remove temp dir: {self.path}')
                    return
                time.sleep(delay)


class TemporaryDestination:
    """Write-then-atomic-move output path: the caller writes to ``temp_path``
    inside the context, and on clean exit the file is moved to the final
    destination, so readers never observe partial outputs."""

    def __init__(self, dest: str):
        self.dest = dest
        self._tmp = SafeTemporaryDirectory(prefix='ts2d-out-')
        self.temp_path = os.path.join(self._tmp.path, os.path.basename(dest))

    def __enter__(self) -> str:
        return self.temp_path

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        try:
            if exc_type is None and os.path.exists(self.temp_path):
                os.makedirs(os.path.dirname(os.path.abspath(self.dest)), exist_ok=True)
                shutil.move(self.temp_path, self.dest)
        finally:
            self._tmp.cleanup()
