"""The PyTorch port's model registry on the CPU, against a localhost HTTP
server (as tests/test_015_remote_download.py does for the reference
package): ``extract_zip``'s guards, ``URLDataBase.copy``, the zoo's
download-on-miss and a predict with the downloaded model, the Google Drive
confirm-token flow, retries, ``get_shared_urls(fetch_remote=True)`` falling
back offline, ``TS2D`` with its default ``use_remote`` / ``fetch_remote``,
the temporary directories, and a zipped series through ``read_image``.

Every test here runs with ``requests`` refused at import (the port
downloads with urllib) and with name resolution limited to this host, so
no test reaches the network."""

import http.server
import json
import os
import socket
import threading
import urllib.parse
import zipfile

import numpy as np
import pytest

from tests.model_fixtures import build_model_dir
from tests.synth_assets import asset_path
from tests.test_017_dicom import write_slice
from totalsegmentator2d_tpu.inference import database as jax_database
from totalsegmentator2d_tpu_torch.api import TS2D
from totalsegmentator2d_tpu_torch.inference import Zoo, database
from totalsegmentator2d_tpu_torch.inference.database import (
    FileDataBase, URLDataBase, drive_file_id, extract_zip)
from totalsegmentator2d_tpu_torch.io import MedicalImage, read_image
from totalsegmentator2d_tpu_torch.utils import config, temp

_LOCAL_HOSTS = ('127.0.0.1', 'localhost', '::1', None)


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    """``requests`` cannot be imported, and only this host resolves."""
    monkeypatch.setitem(__import__('sys').modules, 'requests', None)
    real = socket.getaddrinfo

    def local_only(host, *args, **kwargs):
        if host not in _LOCAL_HOSTS:
            raise OSError(f'test refuses to resolve {host!r}')
        return real(host, *args, **kwargs)

    monkeypatch.setattr(socket, 'getaddrinfo', local_only)


@pytest.fixture
def no_backoff(monkeypatch):
    """Download retries without their 2 s and 4 s waits."""
    monkeypatch.setattr('time.sleep', lambda s: None)


def _closed_port() -> int:
    """A localhost port nothing listens on."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


class _Registry:
    """A localhost server: model zips under /files/, a registry under
    /shared.json, a Drive look-alike (/uc answers with the confirm page and
    sets a cookie; /download wants the cookie and the form's fields), and
    /flaky/<name>, which fails twice before it answers."""

    def __init__(self, webroot):
        self.webroot = webroot
        self.shared = {}
        self.flaky = {}
        self.log = []
        registry = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send(self, status, body, ctype='application/octet-stream',
                      headers=()):
                self.send_response(status)
                self.send_header('Content-Type', ctype)
                self.send_header('Content-Length', str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urllib.parse.urlparse(self.path)
                query = dict(urllib.parse.parse_qsl(url.query))
                registry.log.append((url.path, query,
                                     self.headers.get('Cookie')))
                if url.path == '/shared.json':
                    self._send(200, json.dumps(registry.shared).encode(),
                               'application/json')
                elif url.path.startswith('/files/'):
                    path = os.path.join(registry.webroot, url.path[7:])
                    if not os.path.isfile(path):
                        return self._send(404, b'missing', 'text/plain')
                    with open(path, 'rb') as f:
                        self._send(200, f.read())
                elif url.path.startswith('/flaky/'):
                    name = url.path[7:]
                    registry.flaky[name] = registry.flaky.get(name, 0) + 1
                    if registry.flaky[name] < 3:
                        return self._send(500, b'busy', 'text/plain')
                    with open(os.path.join(registry.webroot, name), 'rb') as f:
                        self._send(200, f.read())
                elif url.path == '/uc':
                    action = f'http://127.0.0.1:{registry.port}/download'
                    page = (f'<html><form id="download-form" action="{action}"'
                            f' method="get">'
                            f'<input type="hidden" name="id" '
                            f'value="{query["id"]}">'
                            f'<input type="hidden" name="export" '
                            f'value="download">'
                            f'<input type="hidden" name="confirm" value="t">'
                            f'<input type="hidden" name="uuid" value="u-1">'
                            f'</form></html>').encode()
                    self._send(200, page, 'text/html; charset=utf-8',
                               [('Set-Cookie', 'download_warning=ok; Path=/')])
                elif url.path == '/download':
                    if (self.headers.get('Cookie') != 'download_warning=ok'
                            or query.get('confirm') != 't'
                            or query.get('uuid') != 'u-1'):
                        return self._send(200, b'<html>again</html>',
                                          'text/html')
                    path = os.path.join(registry.webroot,
                                        query['id'] + '.zip')
                    with open(path, 'rb') as f:
                        self._send(200, f.read(), 'application/zip')
                else:
                    self._send(404, b'not found', 'text/plain')

        self.httpd = http.server.ThreadingHTTPServer(('127.0.0.1', 0),
                                                     Handler)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def url(self, path):
        return f'http://127.0.0.1:{self.port}{path}'

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(10)


@pytest.fixture(scope='module')
def registry(tmp_path_factory):
    """A packed model, served: {model: {r001: {group: url}}}."""
    src = str(tmp_path_factory.mktemp('src'))
    webroot = str(tmp_path_factory.mktemp('web'))
    mid = build_model_dir(src, model='ts2d-v9-dl', group='cardiac',
                          labels=('heart',), patch=(64, 64))
    # the registry's shape: members <model>_<group>/r###/...
    with zipfile.ZipFile(os.path.join(webroot, f'{mid}.zip'), 'w',
                         zipfile.ZIP_DEFLATED) as zf:
        for root, _, files in os.walk(src):
            for fn in files:
                zf.write(os.path.join(root, fn),
                         os.path.relpath(os.path.join(root, fn), src))
    reg = _Registry(webroot)
    reg.shared = {'ts2d-v9-dl': {'r001': {
        'cardiac': reg.url(f'/files/{mid}.zip')}}}
    yield reg, mid
    reg.close()


def _image():
    rng = np.random.default_rng(0)
    return MedicalImage(
        array=(rng.standard_normal((70, 60, 2)) + 2).astype(np.float32),
        spacing=(1.5, 1.5), is_vector=True)


# -- extract_zip ------------------------------------------------------------------

def _zip(path, members, compression=zipfile.ZIP_STORED):
    with zipfile.ZipFile(path, 'w', compression) as zf:
        for name, data in members.items():
            zf.writestr(name, data)
    return str(path)


@pytest.mark.parametrize('case', ['crc', 'traversal', 'absolute', 'member',
                                  'total'])
def test_extract_zip_guards(tmp_path, case):
    """Each guard refuses before anything is written, with the reference
    package's error and message."""
    kw = {}
    if case == 'crc':
        zp = _zip(tmp_path / 'x.zip', {'model.json': '{"a": 1}' * 100},
                  zipfile.ZIP_DEFLATED)
        raw = bytearray(open(zp, 'rb').read())
        raw[40] ^= 0xFF  # a payload byte; the directory stays intact
        open(zp, 'wb').write(bytes(raw))
    elif case == 'traversal':
        zp = _zip(tmp_path / 'x.zip', {'ok.txt': 'a', '../pwned.txt': 'b'})
    elif case == 'absolute':
        zp = _zip(tmp_path / 'x.zip', {'/tmp/pwned.txt': 'b'})
    elif case == 'member':
        zp = _zip(tmp_path / 'x.zip', {'small.dcm': b'x' * 8,
                                       'big.dcm': b'y' * 32})
        kw = dict(max_member_bytes=16)
    else:
        zp = _zip(tmp_path / 'x.zip', {'a.dcm': b'x' * 40, 'b.dcm': b'y' * 40})
        kw = dict(max_total_bytes=64)
    outcomes = []
    for i, fn in enumerate((extract_zip, jax_database.extract_zip)):
        dest = tmp_path / f'dest{i}'
        dest.mkdir()
        with pytest.raises(Exception) as ex:
            fn(zp, str(dest), **kw)
        outcomes.append((type(ex.value), str(ex.value)))
        assert not os.listdir(dest)
    assert outcomes[0] == outcomes[1]
    assert not (tmp_path / 'pwned.txt').exists()


def test_extract_zip_within_caps(tmp_path):
    zp = _zip(tmp_path / 'x.zip', {'s/a.dcm': b'x' * 40, 's/b.dcm': b'y' * 40})
    extract_zip(zp, str(tmp_path / 'out'), max_total_bytes=80,
                max_member_bytes=40)
    assert (tmp_path / 'out' / 's' / 'b.dcm').read_bytes() == b'y' * 40


# -- downloads ----------------------------------------------------------------------

def test_urldatabase_copy_downloads_and_extracts(registry, tmp_path):
    reg, mid = registry
    remote = URLDataBase(reg.shared)
    assert remote.has(key=mid) and remote.latest(key=mid) == 1
    assert remote.ids() == [mid] and remote.groups() == ['cardiac']
    remote.copy(str(tmp_path), key=mid)
    assert (tmp_path / mid / 'r001' / 'model.json').exists()
    with pytest.raises(LookupError, match='not in the remote registry'):
        remote.copy(str(tmp_path), key='ts2d-v9-none_cardiac')


def test_zoo_download_on_miss_and_predict(registry, tmp_path):
    reg, mid = registry
    zoo = Zoo(remote=URLDataBase(reg.shared), local=str(tmp_path / 'local'))
    assert not zoo.local.has(key=mid) and not zoo.local.readonly
    model = zoo.load(mid)  # download on miss
    assert zoo.local.has(key=mid)
    model.start(device='cpu')
    seg = model.apply(_image())
    assert seg.meta['Segment0_Name'] == 'heart'
    # the second load comes from the local copy, with no remote at all
    assert Zoo(remote=False, local=str(tmp_path / 'local')).load(
        mid).labels == {1: 'heart'}
    zoo.clear(key=mid)
    assert not zoo.local.has(key=mid) and not os.listdir(tmp_path / 'local')


def test_readonly_database_refuses_clear(tmp_path):
    with pytest.raises(PermissionError):
        FileDataBase(str(tmp_path)).clear()


def test_drive_confirm_flow(registry, tmp_path, monkeypatch):
    """A Drive share link: the first answer is the confirm page (and a
    cookie); the second request carries the cookie and the form's fields
    and streams the file."""
    reg, mid = registry
    monkeypatch.setattr(database, 'DRIVE_DOWNLOAD_URL',
                        reg.url('/uc?export=download&id={}'))
    dest = tmp_path / 'drive.zip'
    database._download(f'https://drive.google.com/file/d/{mid}/view', str(dest))
    assert dest.read_bytes() == open(
        os.path.join(reg.webroot, f'{mid}.zip'), 'rb').read()
    (_, q1, c1), (path2, q2, c2) = reg.log[-2:]
    assert q1 == {'export': 'download', 'id': mid} and c1 is None
    assert path2 == '/download' and c2 == 'download_warning=ok'
    assert q2 == {'id': mid, 'export': 'download', 'confirm': 't',
                  'uuid': 'u-1'}


def test_drive_url_recognition():
    fid = '1A2b-C3d_E4f'
    for url in (f'https://drive.google.com/file/d/{fid}/view?usp=sharing',
                f'https://drive.google.com/open?id={fid}',
                f'https://drive.google.com/uc?export=download&id={fid}',
                f'https://drive.usercontent.google.com/download?id={fid}'
                f'&export=download'):
        assert drive_file_id(url) == fid == jax_database.drive_file_id(url)
    assert drive_file_id('https://zenodo.org/record/1/files/m.zip') is None


def test_download_retries_then_succeeds(registry, tmp_path, no_backoff):
    reg, mid = registry
    dest = tmp_path / 'm.zip'
    database._download(reg.url(f'/flaky/{mid}.zip'), str(dest))
    assert reg.flaky[f'{mid}.zip'] == 3
    assert zipfile.ZipFile(dest).testzip() is None


def test_download_gives_up(tmp_path, no_backoff):
    url = f'http://127.0.0.1:{_closed_port()}/nope.zip'
    with pytest.raises(RuntimeError, match='after 3 attempts') as ex:
        database._download(url, str(tmp_path / 'x.zip'))
    assert url in str(ex.value)


# -- the registry file and TS2D -------------------------------------------------------

def test_shared_urls_fall_back_offline(monkeypatch, capsys):
    monkeypatch.setattr(config, 'SHARED_URL',
                        f'http://127.0.0.1:{_closed_port()}/shared.json')
    packaged = config.get_shared_urls(fetch_remote=False)
    assert 'ts2d-v2-ep4000b2' in packaged
    assert config.get_shared_urls(fetch_remote=True) == packaged


def test_shared_urls_fetch(registry, monkeypatch):
    reg, _ = registry
    monkeypatch.setattr(config, 'SHARED_URL', reg.url('/shared.json'))
    assert config.get_shared_urls(fetch_remote=True) == reg.shared


@pytest.fixture(scope='module')
def local_db(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('local'))
    build_model_dir(root, model='ts2d-v9-loc', group='cardiac',
                    labels=('heart', 'aorta'), spacing=(1.2, 2.0))
    return root


def test_ts2d_defaults_load_a_local_model_offline(local_db, monkeypatch):
    """TS2D(local=db) with use_remote=True, fetch_remote=True: the fetch
    fails (nothing listens), the packaged registry stands in, the key is
    not in it, and the local model loads without a download."""
    monkeypatch.setattr(config, 'SHARED_URL',
                        f'http://127.0.0.1:{_closed_port()}/shared.json')
    with TS2D(key='ts2d-v9-loc', local=local_db, device='cpu') as tool:
        assert isinstance(tool.zoo.remote, URLDataBase)
        assert list(tool.models) == ['ts2d-v9-loc_cardiac']
        seg = tool.predict(asset_path('sample_s0521.nrrd')).get_segmentation()
    assert seg.ncomponents == 2


def test_ts2d_downloads_a_miss(registry, tmp_path, monkeypatch):
    """The fetched registry names a model the local database lacks: TS2D
    downloads it and predicts."""
    reg, mid = registry
    monkeypatch.setattr(config, 'SHARED_URL', reg.url('/shared.json'))
    local = str(tmp_path / 'local')
    with TS2D(key='ts2d-v9-dl', local=local, device='cpu') as tool:
        assert list(tool.models) == [mid]
    assert FileDataBase(local).has(key=mid)


def test_ts2d_miss_offline_names_the_url(tmp_path, monkeypatch, no_backoff):
    """Offline, a model in the registry but not in the local database
    fails with an error that names the URL it tried."""
    url = f'http://127.0.0.1:{_closed_port()}/ts2d-v9-off_cardiac.zip'
    shared = tmp_path / 'shared.json'
    shared.write_text(json.dumps({'ts2d-v9-off': {'r001': {'cardiac': url}}}))
    monkeypatch.setattr(config, 'SHARED_URL', shared.as_uri())
    with pytest.raises(RuntimeError, match='Failed to load model') as ex:
        TS2D(key='ts2d-v9-off', local=str(tmp_path / 'local'), device='cpu')
    assert url in str(ex.value)


def test_no_port_module_imports_requests():
    """Every module of the port imports with ``requests`` refused (the
    autouse fixture), and none names it."""
    import importlib
    import pkgutil

    import totalsegmentator2d_tpu_torch as port
    for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.'):
        importlib.import_module(m.name)
        path = importlib.util.find_spec(m.name).origin
        with open(path) as f:
            assert 'import requests' not in f.read(), path


# -- temporary directories ---------------------------------------------------------

def test_safe_temporary_directory(tmp_path, monkeypatch):
    monkeypatch.setenv('TS2D_TEMP', str(tmp_path))
    with temp.SafeTemporaryDirectory(prefix='ts2d-x-') as d:
        assert os.path.dirname(d) == str(tmp_path)
        info = json.load(open(os.path.join(d, '~INFO.json')))
        assert info['pid'] == os.getpid()
    assert not os.path.exists(d)
    # an orphan of a process that is gone is reaped; a live one is not
    orphan = tmp_path / 'ts2d-orphan'
    orphan.mkdir()
    (orphan / '~INFO.json').write_text(json.dumps(
        {'pid': 2 ** 22 + 12345, 'create_time': 1.0, 'name': 'gone'}))
    live = temp.SafeTemporaryDirectory(prefix='ts2d-live-', reap=False)
    try:
        psutil = pytest.importorskip('psutil')
        assert psutil.pid_exists(os.getpid())
        assert temp.reap_orphans(str(tmp_path)) == 1
        assert not orphan.exists() and os.path.isdir(live.path)
    finally:
        live.cleanup()


def test_temporary_destination(tmp_path, monkeypatch):
    monkeypatch.setenv('TS2D_TEMP', str(tmp_path / 'tmp'))
    dest = tmp_path / 'out' / 'a.txt'
    with temp.TemporaryDestination(str(dest)) as p:
        with open(p, 'w') as f:
            f.write('done')
        assert not dest.exists()
    assert dest.read_text() == 'done'
    with pytest.raises(RuntimeError):
        with temp.TemporaryDestination(str(tmp_path / 'b.txt')) as p:
            open(p, 'w').write('partial')
            raise RuntimeError('failed midway')
    assert not (tmp_path / 'b.txt').exists()


# -- a zipped series ------------------------------------------------------------------

def test_zipped_series_through_read_image(tmp_path):
    """A zipped series (wrapped in a directory chain, with Finder junk)
    reads as the unzipped series; the extraction is gone afterwards."""
    rng = np.random.default_rng(11)
    vol = rng.integers(-500, 1500, (4, 8, 10)).astype(np.int16)
    series = tmp_path / 'wrap' / 'series'
    series.mkdir(parents=True)
    for i in range(4):
        write_slice(str(series / f's{i}.dcm'), vol[i],
                    position=(0.0, 0.0, 2.0 * i), instance=i + 1)
    zp = tmp_path / 'case.zip'
    with zipfile.ZipFile(zp, 'w') as zf:
        zf.writestr('__MACOSX/._junk', b'x')
        for f in sorted(series.iterdir()):
            zf.write(f, f'wrap/series/{f.name}')
    img = read_image(str(zp))
    np.testing.assert_array_equal(img.array, vol)
    assert img.spacing == read_image(str(series)).spacing
    empty = _zip(tmp_path / 'empty.zip', {'readme.txt': 'nothing'})
    with pytest.raises(ValueError, match='No DICOM series'):
        read_image(empty)
