"""The PyTorch port's HTTP server (totalsegmentator2d_tpu_torch.serve) on
the CPU: the cases of tests/test_016_serve.py that NRRD inputs allow
(round trip, concurrent batched requests, metrics, auth, the body cap,
shutdown drain, timeouts), and the formats that are not ported yet."""

import concurrent.futures as cf
import http.client
import json
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from tests.conftest import asset_path
from tests.model_fixtures import build_group_set
from totalsegmentator2d_tpu_torch.api import TS2D
from totalsegmentator2d_tpu_torch.io import read_image
from totalsegmentator2d_tpu_torch.serve import TS2DServer, main, production_wire

KEY = 'ts2d-v9-test'


@pytest.fixture(scope='module', autouse=True)
def _two_threads():
    """Two intra-op threads for this module: its tests run torch on several
    threads at once (request threads, the dispatcher) beside the other
    test workers, and a full-width thread pool per thread oversubscribes
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('zoo'))
    build_group_set(root, model=KEY, spacing=(1.2, 2.0))
    return root


@pytest.fixture(scope='module')
def server(root):
    # batching=False: byte-identical responses across concurrent requests
    # are the solo program's contract; the batched path is held with a
    # tolerance in test_concurrent_predicts_batched
    with TS2D(key=KEY, use_remote=False, local=root, device='cpu',
              batching=False) as tool:
        with TS2DServer(tool, port=0) as srv:
            yield srv


def _get(srv, path, headers=None):
    req = urllib.request.Request(f'http://127.0.0.1:{srv.port}{path}',
                                 headers=headers or {})
    with urllib.request.urlopen(req) as r:
        return r.status, r.read(), dict(r.headers)


def _post(srv, payload, query='', headers=None):
    req = urllib.request.Request(
        f'http://127.0.0.1:{srv.port}/predict{query}', data=payload,
        method='POST', headers=headers or {})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as ex:
        return ex.code, ex.read(), dict(ex.headers)


def _payload(name='sample_s0332.nrrd'):
    with open(asset_path(name), 'rb') as f:
        return f.read()


def _seg(body, tmp_path, name='seg.nrrd'):
    path = tmp_path / name
    path.write_bytes(body)
    return read_image(str(path))


class TestEndpoints:
    def test_health(self, server):
        status, body, _ = _get(server, '/health')
        assert status == 200
        data = json.loads(body)
        assert data['status'] == 'ok' and len(data['models']) == 2

    def test_labels(self, server):
        data = json.loads(_get(server, '/labels')[1])
        assert data[f'{KEY}_cardiac']['1'] == 'heart'

    def test_predict_roundtrip(self, server, tmp_path):
        status, body, headers = _post(server, _payload(), '?format=nrrd')
        assert status == 200
        labels = json.loads(headers['X-TS2D-Labels'])
        assert 'heart' in labels and 'rib-left-1' in labels
        seg = _seg(body, tmp_path)
        assert seg.ncomponents == 5
        # the response is the in-process result
        ref = server.tool.predict(asset_path('sample_s0332.nrrd'))
        np.testing.assert_array_equal(seg.array,
                                      ref.get_segmentation().array)

    def test_predict_collapse(self, server, tmp_path):
        status, body, _ = _post(server, _payload(), '?collapse=1')
        assert status == 200
        assert _seg(body, tmp_path).dim == 2

    @pytest.mark.parametrize('query,code,message', [
        ('?input_format=nii.gz', 400, 'not ported yet'),
        ('?input_format=zip', 400, 'not ported yet'),
        ('?input_format=dcm', 400, 'not ported yet'),
        ('?input_format=exe', 400, 'unsupported input format'),
        ('?format=nii', 400, 'not ported yet'),
        ('?format=exe', 400, 'unsupported output format')])
    def test_formats_rejected(self, server, query, code, message):
        status, body, _ = _post(server, _payload(), query)
        assert status == code
        assert message in json.loads(body)['error']

    def test_bad_payload(self, server):
        status, body, _ = _post(server, b'not an image')
        assert status == 400 and 'error' in json.loads(body)

    def test_unknown_routes(self, server):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(server, '/nope')
        assert ei.value.code == 404
        req = urllib.request.Request(
            f'http://127.0.0.1:{server.port}/other', data=b'x', method='POST')
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req)
        assert ei.value.code == 404

    def test_input_format_traversal_rejected(self, server, tmp_path):
        target = tmp_path / 'pwned.txt'
        evil = urllib.parse.quote(f'/../../../..{target}', safe='')
        status, _, _ = _post(server, b'owned', f'?input_format={evil}')
        assert status == 400 and not target.exists()

    def test_concurrent_predicts_are_identical(self, server):
        solo = _post(server, _payload())[1]
        with cf.ThreadPoolExecutor(max_workers=4) as pool:
            results = list(pool.map(lambda _: _post(server, _payload()),
                                    range(4)))
        assert all(status == 200 for status, _, _ in results)
        assert all(body == solo for _, body, _ in results)


class TestMetrics:
    def test_counts_and_latency(self, server):
        before = json.loads(_get(server, '/metrics')[1])
        assert _post(server, _payload())[0] == 200
        after = json.loads(_get(server, '/metrics')[1])
        assert after['predict_requests'] == before['predict_requests'] + 1
        assert after['predict_errors'] == before['predict_errors']
        assert after['predict_seconds_total'] > before['predict_seconds_total']
        assert after['predict_seconds_mean'] > 0
        assert after['predict_seconds_max'] > 0
        assert 'batch_programs' not in after  # batching is off here

    def test_counts_errors(self, server):
        before = json.loads(_get(server, '/metrics')[1])
        _post(server, b'not an image')
        after = json.loads(_get(server, '/metrics')[1])
        assert after['predict_errors'] == before['predict_errors'] + 1


def test_concurrent_predicts_batched(root, tmp_path):
    """With micro-batching on (the default) concurrent requests coalesce:
    /metrics shows the occupancy, and every response agrees with the solo
    response on >= 99.9% of pixels. Measured: 1.0."""
    with TS2D(key=KEY, use_remote=False, local=root, device='cpu') as tool:
        with TS2DServer(tool, port=0) as srv:
            solo_status, solo_body, _ = _post(srv, _payload())
            assert solo_status == 200
            # the 8 requests fill one program (max_batch 8)
            tool._fused.set_batch_linger(60_000.0)
            with cf.ThreadPoolExecutor(max_workers=8) as pool:
                results = list(pool.map(lambda _: _post(srv, _payload()),
                                        range(8)))
            metrics = json.loads(_get(srv, '/metrics')[1])
    assert all(status == 200 for status, _, _ in results)
    assert metrics['predict_requests'] == 9 and metrics['predict_errors'] == 0
    assert metrics['batch_scans'] == 9
    assert metrics['batch_scans_coalesced'] == 8
    assert sum(metrics['batch_occupancy']) == metrics['batch_programs'] == 2
    solo = _seg(solo_body, tmp_path, 'solo.nrrd').array
    for i, (_, body, _) in enumerate(results):
        seg = _seg(body, tmp_path, f'b{i}.nrrd').array
        assert seg.shape == solo.shape
        assert float((seg == solo).mean()) >= 0.999


class TestProductionKnobs:
    def test_auth_token_required(self, server):
        srv = TS2DServer(server.tool, port=0, auth_token='sekret').start()
        try:
            assert _get(srv, '/health')[0] == 200  # probes stay open
            for hdrs in ({}, {'Authorization': 'Bearer wrong'}):
                with pytest.raises(urllib.error.HTTPError) as ei:
                    _get(srv, '/labels', hdrs)
                assert ei.value.code == 401
                assert ei.value.headers['WWW-Authenticate'] == 'Bearer'
            ok = {'Authorization': 'Bearer sekret'}
            assert _get(srv, '/labels', ok)[0] == 200
            assert _post(srv, b'junk', headers=ok)[0] == 400
            assert _post(srv, b'junk')[0] == 401
        finally:
            srv.stop()

    def test_auth_non_ascii(self, server):
        srv = TS2DServer(server.tool, port=0, auth_token='tökn').start()
        try:
            for value, code in ((b'Bearer caf\xe9', 401),
                                ('Bearer tökn'.encode('utf-8'), 200)):
                conn = http.client.HTTPConnection('127.0.0.1', srv.port,
                                                  timeout=5)
                conn.request('GET', '/labels',
                             headers={'Authorization': value})
                resp = conn.getresponse()
                assert resp.status == code
                resp.read()
                conn.close()
        finally:
            srv.stop()

    def test_oversized_body_rejected_before_reading(self, server):
        srv = TS2DServer(server.tool, port=0, max_body_bytes=1024).start()
        try:
            conn = http.client.HTTPConnection('127.0.0.1', srv.port)
            try:
                # announce 10 MB and send nothing: the 413 comes at once
                conn.putrequest('POST', '/predict')
                conn.putheader('Content-Length', str(10 * 1024 * 1024))
                conn.endheaders()
                resp = conn.getresponse()
                assert resp.status == 413
                assert 'exceeds limit' in json.loads(resp.read())['error']
            finally:
                conn.close()
            assert _get(srv, '/health')[0] == 200
        finally:
            srv.stop()

    def test_stop_closes_listening_socket(self, server):
        srv = TS2DServer(server.tool, port=0).start()
        port = srv.port
        assert srv.stop()
        with pytest.raises(OSError):
            socket.create_connection(('127.0.0.1', port), timeout=2)

    def test_nonlocal_bind_without_token_warns(self, server, capsys):
        TS2DServer(server.tool, host='0.0.0.0', port=0).start().stop()
        err = capsys.readouterr().err
        assert 'no auth token' in err and 'non-loopback' in err
        TS2DServer(server.tool, host='0.0.0.0', port=0,
                   auth_token='x').start().stop()
        assert 'no auth token' not in capsys.readouterr().err

    def test_request_timeout_times_out(self, server):
        srv = TS2DServer(server.tool, port=0, request_timeout=0.2)
        srv._handle_predict = lambda body, query: (
            time.sleep(1.0), (200, 'application/json', b'{}'))[1]
        srv.start()
        try:
            t0 = time.perf_counter()
            assert _post(srv, b'x')[0] == 504
            assert time.perf_counter() - t0 < 0.9
            assert json.loads(_get(srv, '/metrics')[1])['predict_timeouts'] == 1
        finally:
            assert srv.stop()  # the drain waits for the orphaned predict

    def test_request_timeout_budget_starts_at_execution(self, server):
        from concurrent.futures import ThreadPoolExecutor
        srv = TS2DServer(server.tool, port=0, request_timeout=1.0)
        srv._handle_predict = lambda body, query: (
            time.sleep(0.4), (200, 'application/json', b'{}'))[1]
        srv.start()
        try:
            with srv._active_cv:  # a 1-wide pool: 2 queued behind 1
                srv._pool = ThreadPoolExecutor(1)
            statuses = []

            def post():
                statuses.append(_post(srv, b'x')[0])

            threads = [threading.Thread(target=post) for _ in range(3)]
            for t in threads:
                t.start()
                time.sleep(0.05)
            for t in threads:
                t.join(10.0)
            assert statuses == [200, 200, 200], statuses
            srv._handle_predict = lambda body, query: (
                time.sleep(3.0), (200, 'application/json', b'{}'))[1]
            threads = [threading.Thread(target=post) for _ in range(2)]
            for t in threads:
                t.start()
                time.sleep(0.05)
            for t in threads:
                t.join(10.0)
            assert statuses[3:] == [504, 504], statuses
        finally:
            srv.stop(drain_timeout=5.0)

    def test_shutdown_drains_inflight_predicts(self, server):
        srv = TS2DServer(server.tool, port=0)
        release = threading.Event()
        done = []

        def slow(body, query):
            release.wait(5.0)
            done.append(True)
            return 200, 'application/json', b'{}'

        srv._handle_predict = slow
        srv.start()
        resp = {}
        t = threading.Thread(target=lambda: resp.update(
            status=_post(srv, b'x')[0]))
        t.start()
        deadline = time.monotonic() + 5.0
        while not srv._active and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv._active == 1
        stopper = {}
        ts = threading.Thread(target=lambda: stopper.update(
            drained=srv.stop()))
        ts.start()
        time.sleep(0.1)
        assert ts.is_alive()  # stop() waits for the predict in flight
        release.set()
        ts.join(5.0)
        t.join(5.0)
        assert stopper['drained'] is True and done == [True]
        assert resp['status'] == 200

    def test_draining_rejects_new_predicts(self, server):
        srv = TS2DServer(server.tool, port=0).start()
        try:
            with srv._active_cv:
                srv._draining = True
            assert _post(srv, b'x')[0] == 503
        finally:
            srv.stop()


def test_production_wire_from_channel_names():
    assert production_wire({0: 'max', 1: 'mean'}) == (True, False)
    assert production_wire({0: 'xray'}) == (False,)
    assert production_wire({1: 'mean', 0: 'MIP'}) == (True, False)


@pytest.mark.parametrize('argv,message', [
    # the id is the one this case had while --pad-quantum was refused
    pytest.param(['--pad-quantum', '0'], '--pad-quantum must be >= 1',
                 id='argv0-not ported'),
    (['--warmup', '350by280'], 'HxW')])
def test_main_rejects_options(argv, message, capsys):
    with pytest.raises(SystemExit):
        main(argv)
    assert message in capsys.readouterr().err


def test_main_serves_with_pad_quantum(root, monkeypatch, tmp_path):
    """``--pad-quantum 32 --warmup 60x50`` builds TS2D(pad_quantum=32),
    warms the (64, 64) bucket's programs, and answers a POST with the masks
    of the tool's own bucket program. The wait at the end of main is
    released through the module's threading namespace."""
    import types

    import totalsegmentator2d_tpu_torch.serve as serve
    events, servers = [], []

    def event():
        events.append(threading.Event())
        return events[-1]

    monkeypatch.setattr(serve, 'threading', types.SimpleNamespace(
        Thread=threading.Thread, Condition=threading.Condition,
        Lock=threading.Lock, Event=event))
    start = serve.TS2DServer.start

    def recording_start(self):
        servers.append(self)
        return start(self)

    monkeypatch.setattr(serve.TS2DServer, 'start', recording_start)
    runner = threading.Thread(target=main, args=([
        '--model', KEY, '--local', root, '--device', 'cpu', '--port', '0',
        '--pad-quantum', '32', '--warmup', '60x50'],), daemon=True)
    runner.start()
    deadline = time.monotonic() + 120
    while not (servers and events) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert servers and events, 'the server did not start'
    srv = servers[0]
    try:
        engine = srv.tool._fused
        assert engine.pad_quantum == 32
        keys = [k for k in engine._cache if k[0] in ('bucket', 'batch')]
        assert any(k[0] == 'bucket' and k[1] == (64, 64) for k in keys)
        assert any(k[0] == 'batch' and k[2] == (64, 64) for k in keys)
        status, body, _ = _post(srv, _payload())
        assert status == 200
        seg = _seg(body, tmp_path).array
        solo = srv.tool.predict(read_image(asset_path('sample_s0332.nrrd')))
        np.testing.assert_array_equal(seg, solo.get_segmentation().array)
    finally:
        for e in events:
            e.set()
        runner.join(60)
    assert not runner.is_alive()
