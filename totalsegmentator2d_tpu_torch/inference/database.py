"""Model key grammar and the model databases.

Key grammar: ``<model>-<dataset>-<config>_<group>``. The group is split on
the last underscore; model names match component-wise by prefix on
'-'-separated parts, so 'ts2d-v2' matches 'ts2d-v2-ep4000b2'. Revisions are
directories named ``r%03d``.

 - :class:`FileDataBase`: the local store ``<root>/<model>_<group>/r###/``,
   writable for the zoo's download-on-miss;
 - :class:`URLDataBase`: the registry of ``shared.json``; ``copy``
   downloads a model zip and extracts it into a local root.

Downloads use the standard library (``urllib.request`` with an
``http.cookiejar`` for Google Drive's confirm step), where the reference
package uses ``requests``: the same timeouts, chunking, retries and error
messages, with one package less to install.
"""

from __future__ import annotations

import os
import shutil
import zipfile
from glob import glob
from typing import Dict, Iterator, Optional, Tuple

from ..utils.files import isemptydir, mkdirs, removeall, rmdirs
from ..utils.logging import log, warn
from ..utils.params import parse_int
from ..utils.temp import SafeTemporaryDirectory


def decompose_model_key(key: str) -> Tuple[str, Optional[str]]:
    """'ts2d-v2-ep4000b2_cardiac' -> ('ts2d-v2-ep4000b2', 'cardiac')."""
    if '_' in key:
        model, group = key.rsplit('_', 1)
        return model, group
    return key, None


def revision_str(revision) -> str:
    return f'r{revision:03d}' if isinstance(revision, int) else str(revision)


def parse_revision(rn) -> Optional[int]:
    if isinstance(rn, int):
        return rn
    s = str(rn)
    return parse_int(s[1:] if s.startswith('r') else s)


def match_model_name(pattern: Optional[str], model: str) -> bool:
    """Component-wise prefix match: each '-'-part of the pattern must equal
    the corresponding part of the model name (empty parts match anything).
    A pattern with more non-empty components than the model does not
    match."""
    if pattern is None:
        return True
    if '-' in model:
        pat = pattern.split('-')
        parts = model.split('-')
        if len(pat) > len(parts) and any(pat[len(parts):]):
            return False
        for i in range(len(parts)):
            if i < len(pat) and pat[i] and pat[i] != parts[i]:
                return False
        return True
    return model == pattern


class DataBase:
    """Query interface over (model, group, revision) -> location entries."""

    def _enumerate(self) -> Iterator[Tuple[str, str, int, str]]:
        raise NotImplementedError

    def list(self, model: Optional[str] = None, group: Optional[str] = None,
             key: Optional[str] = None, revision=None) -> Dict[tuple, str]:
        if key is not None:
            model, group = decompose_model_key(key)
        if isinstance(revision, str):
            revision = parse_revision(revision)
        res = {}
        for m, g, r, path in self._enumerate():
            if (match_model_name(model, m)
                    and (revision is None or revision == r)
                    and (group is None or group == g)):
                res[(m, g, r)] = path
        return res

    def has(self, **kw) -> bool:
        return bool(self.list(**kw))

    def ids(self, **kw) -> list:
        return sorted({f'{m}_{g}' for (m, g, r) in self.list(**kw)})

    def models(self, **kw) -> list:
        return sorted({m for (m, g, r) in self.list(**kw)})

    def groups(self, **kw) -> list:
        return sorted({g for (m, g, r) in self.list(**kw)})

    def revisions(self, **kw) -> list:
        return sorted({r for (m, g, r) in self.list(**kw)})

    def latest(self, **kw) -> Optional[int]:
        revs = self.revisions(**kw)
        return revs[-1] if revs else None

    def get(self, **kw) -> dict:
        """Details of the first (lexicographically by id) matching model."""
        entries = sorted((f'{m}_{g}', (m, g, r, p))
                         for (m, g, r), p in self.list(**kw).items())
        if not entries:
            raise LookupError(f'No model matches {kw}')
        id_, (m, g, r, p) = entries[0]
        return {'id': id_, 'model': m, 'group': g, 'revision': r, 'path': p}

    def copy(self, dest_root: str, key: str, revision: Optional[int] = None):
        raise NotImplementedError


class FileDataBase(DataBase):
    """Local on-disk store: ``<root>/<model>_<group>/r###/``."""

    def __init__(self, root: str, readonly: bool = True):
        self._root = root
        self._readonly = readonly

    @property
    def root(self) -> str:
        return self._root

    @property
    def readonly(self) -> bool:
        return self._readonly

    def _enumerate(self):
        for dn in glob(os.path.join(self._root, '*', 'r*')):
            rel = os.path.relpath(dn, self._root)
            modeldir, rn = os.path.split(rel)
            rev = parse_revision(rn)
            model, group = decompose_model_key(modeldir)
            if rev is None or group is None:
                warn(f'Skipping malformed database entry {rel!r}')
                continue
            yield model, group, rev, dn

    def resource_path(self, key: str, revision: Optional[int] = None,
                      must_exist: bool = True) -> Optional[str]:
        path = os.path.join(self._root, str(key).lower().strip())
        if revision is not None:
            path = os.path.join(path, revision_str(revision))
        if must_exist and not os.path.exists(path):
            return None
        return path

    def copy(self, dest_root: str, key: str, revision: Optional[int] = None):
        src = self.resource_path(key, revision)
        if src is None:
            raise LookupError(f'Model {key!r} (rev {revision}) not in database')
        dst = os.path.join(dest_root, os.path.relpath(src, self._root))
        mkdirs(os.path.dirname(dst))
        shutil.copytree(src, dst, dirs_exist_ok=True)

    def pack_zip(self, key: str, zip_path: str,
                 revision: Optional[int] = None) -> str:
        """Package one model into a registry-shape zip (the inverse of
        :func:`extract_zip`): members are ``<model>_<group>/r###/...``
        paths, so extracting at any database root reproduces the entry, as
        the published models ship and :class:`URLDataBase` serves them
        (``ts2d-torch-train --pack``). Default revision: the latest.
        Returns ``zip_path``."""
        if revision is None:
            revision = self.latest(key=key)
            if revision is None:
                raise LookupError(f'Model {key!r} not in database')
        src = self.resource_path(key, revision)
        if src is None:
            raise LookupError(f'Model {key!r} (rev {revision}) not in '
                              f'database')
        mkdirs(os.path.dirname(os.path.abspath(zip_path)) or '.')
        with zipfile.ZipFile(zip_path, 'w', zipfile.ZIP_DEFLATED) as zf:
            for root, _, files in sorted(os.walk(src)):
                for fn in sorted(files):
                    fp = os.path.join(root, fn)
                    zf.write(fp, os.path.relpath(fp, self._root))
        return zip_path

    def clear(self, key: Optional[str] = None, revision: Optional[int] = None):
        """Remove one model (one revision of it), or every model."""
        if self.readonly:
            raise PermissionError('Database is read-only')
        if key is None:
            for path in self.list().values():
                rmdirs(path)
        else:
            removeall(self.resource_path(key, revision, must_exist=False))
        for dn in glob(os.path.join(self._root, '*')):  # empty model dirs
            if isemptydir(dn):
                rmdirs(dn)


class URLDataBase(DataBase):
    """Remote registry backed by the shared.json dict
    {model: {revision: {group: url}}}."""

    def __init__(self, urls: dict):
        self._urls = urls or {}

    def _enumerate(self):
        for model, revs in self._urls.items():
            for rev, groups in revs.items():
                for group, url in groups.items():
                    yield model, group, parse_revision(rev), url

    def copy(self, dest_root: str, key: str, revision: Optional[int] = None):
        entries = self.list(key=key, revision=revision)
        if not entries:
            raise LookupError(f'Model {key!r} not in the remote registry')
        for (m, g, rn), url in entries.items():
            name = f'{m}_{g}-{revision_str(rn)}'
            with SafeTemporaryDirectory(prefix='ts2d-dl-') as temp:
                zip_path = os.path.join(temp, f'{name}.zip')
                _download(url, zip_path)
                extract_zip(zip_path, dest_root)


def extract_zip(zip_path: str, dest_root: str,
                max_total_bytes: Optional[int] = None,
                max_member_bytes: Optional[int] = None) -> None:
    """Verify and extract an untrusted zip (registry downloads, and the
    server's uploaded DICOM series): the CRC of every member is checked
    first; member paths must stay inside the destination (no absolute
    paths or '..' traversal); with ``max_total_bytes`` the declared
    decompressed total is capped before anything is written, so a zip bomb
    fails fast instead of filling the disk; ``max_member_bytes`` caps each
    member's declared size (a series zip is many small slices; one member
    claiming gigabytes is an attack, not a scan)."""
    with zipfile.ZipFile(zip_path) as zf:
        bad = zf.testzip()
        if bad is not None:
            raise RuntimeError(f'Corrupt download (bad CRC): {bad}')
        dest = os.path.realpath(dest_root)
        total = 0
        for info in zf.infolist():
            target = os.path.realpath(os.path.join(dest, info.filename))
            if not (target + os.sep).startswith(dest + os.sep):
                raise RuntimeError(
                    f'Zip member escapes the destination: {info.filename}')
            if (max_member_bytes is not None
                    and info.file_size > max_member_bytes):
                raise RuntimeError(
                    f'Zip member {info.filename} declares {info.file_size} '
                    f'decompressed bytes (per-member limit '
                    f'{max_member_bytes})')
            total += info.file_size
        if max_total_bytes is not None and total > max_total_bytes:
            raise RuntimeError(
                f'Zip declares {total} decompressed bytes '
                f'(limit {max_total_bytes})')
        zf.extractall(dest_root)


#: Google-Drive URL shapes the registry may carry (the reference tool's
#: gdown with fuzzy=True tolerates the same set): share links
#: /file/d/<id>/view, open?id=, uc?id=, usercontent downloads
_DRIVE_ID_PATTERNS = (
    r'drive\.google\.com/file/d/([\w-]+)',
    r'drive\.google\.com/(?:uc|open|download)\?[^#]*?\bid=([\w-]+)',
    r'drive\.usercontent\.google\.com/download\?[^#]*?\bid=([\w-]+)',
)

#: the first request of a Drive download; its answer is the file, or the
#: large-file interstitial whose form carries the confirm token
DRIVE_DOWNLOAD_URL = 'https://drive.google.com/uc?export=download&id={}'

#: seconds a connection or a read may stall before the attempt fails
TIMEOUT = 60


def drive_file_id(url: str) -> Optional[str]:
    """Extract the file id from any Google-Drive-style URL, else None."""
    import re
    for pat in _DRIVE_ID_PATTERNS:
        m = re.search(pat, url)
        if m:
            return m.group(1)
    return None


def _content_type(resp) -> str:
    return resp.headers.get('Content-Type') or ''


def _stream_to_file(resp, dest: str, chunk: int) -> None:
    """Stream an open response body to ``dest`` with progress logging and a
    size check against Content-Length."""
    expected = int(resp.headers.get('Content-Length') or 0)
    got = 0
    next_mark = 0.25
    with open(dest, 'wb') as f:
        while True:
            block = resp.read(chunk)
            if not block:
                break
            f.write(block)
            got += len(block)
            if expected and got / expected >= next_mark:
                log(f'  ... {got / expected:4.0%} of '
                    f'{expected / 1e6:.1f} MB')
                next_mark += 0.25
    if expected and got != expected:
        raise IOError(f'Truncated download: {got} of {expected} bytes')


def _fetch_drive(file_id: str, dest: str, chunk: int) -> None:
    """Download a Drive file, following the large-file confirm interstitial
    (Drive answers big downloads with an HTML virus-scan page whose hidden
    form carries the confirm token; cookies must persist across the hop)."""
    import http.cookiejar
    import re
    import urllib.parse
    import urllib.request

    opener = urllib.request.build_opener(
        urllib.request.HTTPCookieProcessor(http.cookiejar.CookieJar()))
    with opener.open(DRIVE_DOWNLOAD_URL.format(file_id),
                     timeout=TIMEOUT) as r:
        if 'text/html' not in _content_type(r):
            _stream_to_file(r, dest, chunk)
            return
        html = r.read().decode(r.headers.get_content_charset() or 'utf-8',
                               'replace')
    m = re.search(r'<form[^>]*\baction="([^"]+)"', html)
    if m is None:
        raise IOError(
            f'Drive returned an HTML page with no download form for '
            f'file id {file_id} (permission denied or quota exceeded?)')
    action = m.group(1).replace('&amp;', '&')
    params = dict(re.findall(
        r'<input[^>]*\bname="([^"]+)"[^>]*\bvalue="([^"]*)"', html))
    url = action + ('&' if '?' in action else '?') + \
        urllib.parse.urlencode(params)
    with opener.open(url, timeout=TIMEOUT) as r:
        if 'text/html' in _content_type(r):
            raise IOError(
                f'Drive confirm hop still returned HTML for file id '
                f'{file_id} (permission denied or quota exceeded?)')
        _stream_to_file(r, dest, chunk)


def _download(url: str, dest: str, chunk: int = 1 << 20,
              attempts: int = 3) -> None:
    """HTTP(S) download with retries and backoff, progress logging, and a
    size check against Content-Length. Google-Drive-style URLs (share
    links, open?id=, uc?id=) go through the Drive confirm flow (the
    reference tool gets both from gdown with fuzzy=True). Redirects are
    followed; an HTTP error status fails the attempt."""
    import time
    import urllib.request

    file_id = drive_file_id(url)
    last_err: Optional[Exception] = None
    for attempt in range(attempts):
        if attempt:
            delay = 2.0 ** attempt
            log(f'Retrying download in {delay:.0f}s '
                f'(attempt {attempt + 1}/{attempts}): {url}')
            time.sleep(delay)
        try:
            log(f'Downloading {url}')
            if file_id is not None:
                _fetch_drive(file_id, dest, chunk)
                return
            with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
                _stream_to_file(r, dest, chunk)
            return
        except Exception as ex:  # noqa: BLE001 — retry any transport error
            last_err = ex
    raise RuntimeError(
        f'Download failed after {attempts} attempts: {url}') from last_err
