"""HTTP serving endpoint around a resident TS2D tool.

The reference tool names a server interface but never implements one; the
reference package provides it, and this is its port. Requests run on
threads; with the fused engine's micro-batcher (``TS2D(batching=True)``,
the default) concurrent requests of one shape coalesce into batched
programs on the card.

Endpoints
---------
GET  /health            -> {"status": "ok", "models": [...]}
GET  /labels            -> {"<model id>": {"1": "heart", ...}, ...}
GET  /metrics           -> request/latency counters and the micro-batcher's
                           occupancy (JSON)
POST /predict           body: a NRRD image (the format the package reads;
                        input_format=nii/nii.gz/mha/mhd/dcm/zip answer 400
                        "not ported yet")
     query params:      input_format=nrrd, collapse=0|1, format=nrrd
     response:          merged multilabel segmentation (NRRD); label
                        metadata rides in X-TS2D-Labels (JSON)

Start:  python -m totalsegmentator2d_tpu_torch.serve --local DB
        [--model KEY] [--port 8008] [--device cuda|cpu]
        [--warmup HxW ...]   run the programs of these projection shapes
                             once before serving
        [--pad-quantum N]    serve every crop through the bucket program
                             of its shape bucket (multiples of N)

Production knobs: ``--auth-token`` (or $TS2D_AUTH_TOKEN) requires a Bearer
token on everything but /health and is strongly recommended for
non-loopback ``--host`` binds (the server warns otherwise; there is no TLS
here, front it with a reverse proxy); ``--request-timeout`` answers 504
past a per-predict wall-clock budget; ``--max-body-mb`` caps request
bodies (413); shutdown (SIGINT / ``stop()``) drains in-flight predicts,
new ones answer 503, before returning.
"""

from __future__ import annotations

import hmac
import json
import os
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutTimeout
from contextlib import contextmanager
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from .utils.logging import log, warn


#: default request-body ceiling (512 MiB covers any realistic CT upload)
DEFAULT_MAX_BODY = 512 * 1024 * 1024

#: formats of the reference server the IO slice of the port brings
_NOT_PORTED_INPUTS = ('nii', 'nii.gz', 'mha', 'mhd', 'dcm', 'zip')
_NOT_PORTED_OUTPUTS = ('nii', 'nii.gz', 'mha')


def _error(status: int, message: str):
    return status, 'application/json', json.dumps({'error': message}).encode()


class TS2DServer:
    def __init__(self, tool, host: str = '127.0.0.1', port: int = 8008,
                 max_body_bytes: int = DEFAULT_MAX_BODY,
                 request_timeout: Optional[float] = None,
                 auth_token: Optional[str] = None):
        self.tool = tool
        self.host = host
        self.port = port
        # bodies are buffered in memory: an unbounded Content-Length is an
        # out-of-memory; over-limit posts get 413
        self.max_body_bytes = int(max_body_bytes)
        # per-request wall-clock budget: past it a predict answers 504. The
        # work is not killed (a device program cannot be interrupted): it
        # finishes in its worker and the shutdown drain waits for it; the
        # worker pool bounds how many such orphans pile up
        self.request_timeout = (float(request_timeout)
                                if request_timeout else None)
        # shared-secret auth: every request but /health must carry
        # 'Authorization: Bearer <token>' (constant-time compare)
        self.auth_token = auth_token or None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # in-flight predict accounting for the shutdown drain
        self._active_cv = threading.Condition()
        self._active = 0
        self._draining = False
        self._pool = None  # made when request_timeout is set
        self._metrics_lock = threading.Lock()
        self._metrics = {'predict_requests': 0, 'predict_errors': 0,
                         'predict_timeouts': 0,
                         'predict_seconds_total': 0.0,
                         'predict_seconds_max': 0.0}

    def _check_auth(self, headers) -> bool:
        if self.auth_token is None:
            return True
        # compare bytes: http.server decodes header bytes as latin-1, so
        # encoding the value back as latin-1 recovers the wire bytes, and a
        # client sends the UTF-8 bytes of the token (compare_digest raises
        # on non-ASCII str)
        supplied = headers.get('Authorization', '')
        return hmac.compare_digest(
            supplied.encode('latin-1', 'surrogateescape'),
            f'Bearer {self.auth_token}'.encode('utf-8'))

    @contextmanager
    def _track(self):
        """Count one request span (predict and response write) in the
        shutdown drain; yields False, and the caller answers 503, once
        draining."""
        with self._active_cv:
            draining = self._draining
            if not draining:
                self._active += 1
        if draining:
            # outside the lock: a stalled client socket must not hold it
            yield False
            return
        try:
            yield True
        finally:
            with self._active_cv:
                self._active -= 1
                self._active_cv.notify_all()

    def _predict_guarded(self, body: bytes, query: dict):
        """Run a predict; with ``request_timeout``, under a wall-clock
        budget that starts when the predict starts executing (a request
        still queued behind a full pool after one budget answers 504
        too). Timed-out work finishes in its pool worker and holds its own
        drain count."""
        if self.request_timeout is None:
            return self._handle_predict(body, query)
        with self._active_cv:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    8, thread_name_prefix='ts2d-serve-predict')
            # the task's own drain count: it may outlive this handler
            self._active += 1
        started = threading.Event()

        def task():
            started.set()
            try:
                return self._handle_predict(body, query)
            finally:
                with self._active_cv:
                    self._active -= 1
                    self._active_cv.notify_all()

        def timed_out(kind: str):
            with self._metrics_lock:
                self._metrics['predict_timeouts'] += 1
            return _error(504, f'predict {kind} the {self.request_timeout}s '
                               f'request timeout')

        fut = self._pool.submit(task)
        if not started.wait(self.request_timeout) and fut.cancel():
            # never started: the cancelled task never runs, release its count
            with self._active_cv:
                self._active -= 1
                self._active_cv.notify_all()
            return timed_out('queued past')
        try:
            return fut.result(timeout=self.request_timeout)
        except FutTimeout:
            return timed_out('exceeded')

    def _record(self, seconds: float, error: bool) -> None:
        with self._metrics_lock:
            m = self._metrics
            m['predict_requests'] += 1
            if error:
                m['predict_errors'] += 1
            else:
                m['predict_seconds_total'] += seconds
                m['predict_seconds_max'] = max(m['predict_seconds_max'],
                                               seconds)

    def _handle_metrics(self):
        with self._metrics_lock:
            m = dict(self._metrics)
        ok = m['predict_requests'] - m['predict_errors']
        m['predict_seconds_mean'] = (m['predict_seconds_total'] / ok
                                     if ok else 0.0)
        # whether concurrent requests coalesce is invisible from latency
        # alone, and coalesced programs have load-dependent borderline
        # pixels: operators see the batcher's occupancy here
        fused = getattr(self.tool, '_fused', None)
        batcher = getattr(fused, '_batcher', None) if fused else None
        if batcher is not None:
            m.update(batcher.stats())
        return 200, 'application/json', json.dumps(m).encode()

    # -- request handling --------------------------------------------------

    def _handle_health(self):
        return 200, 'application/json', json.dumps({
            'status': 'ok', 'models': sorted(self.tool.models)}).encode()

    def _handle_labels(self):
        return 200, 'application/json', json.dumps({
            mid: {str(v): n for v, n in model.labels.items()}
            for mid, model in self.tool.models.items()}).encode()

    def _handle_predict(self, body: bytes, query: dict):
        from .io import read_image, write_image
        from .ops.annotations import get_annotation_labels

        ext = query.get('input_format', ['nrrd'])[0]
        out_fmt = query.get('format', ['nrrd'])[0]
        collapse = query.get('collapse', ['0'])[0] in ('1', 'true')
        # both are interpolated into paths below: a strict whitelist
        if ext in _NOT_PORTED_INPUTS:
            return _error(400, f'input format {ext} is not ported yet (this '
                               f'server reads nrrd)')
        if ext != 'nrrd':
            return _error(400, f'unsupported input format {ext}')
        if out_fmt in _NOT_PORTED_OUTPUTS:
            return _error(400, f'output format {out_fmt} is not ported yet '
                               f'(this server writes nrrd)')
        if out_fmt != 'nrrd':
            return _error(400, f'unsupported output format {out_fmt}')

        with tempfile.TemporaryDirectory(prefix='ts2d-serve-') as tmp:
            in_path = os.path.join(tmp, f'input.{ext}')
            with open(in_path, 'wb') as f:
                f.write(body)
            try:
                img = read_image(in_path)
            except Exception as ex:
                return _error(400, f'failed to parse input image: {ex}')
            # no host-side serialization: predict is thread-safe and the
            # stream orders device work, so requests overlap their parsing
            # and export with each other's device time
            res = self.tool.predict(img, collapse=collapse)
            seg = res.get_segmentation()
            out_path = os.path.join(tmp, f'seg.{out_fmt}')
            write_image(seg, out_path)
            with open(out_path, 'rb') as f:
                payload = f.read()
            labels = {name: info['value'] for name, info in
                      get_annotation_labels(seg).items()}
        return 200, 'application/octet-stream', payload, {
            'X-TS2D-Labels': json.dumps(labels),
            'Content-Disposition': f'attachment; filename="seg.{out_fmt}"',
        }

    # -- http plumbing ------------------------------------------------------

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            # socket idle timeout: a stalled client holds a handler thread
            # at most this long
            timeout = 60

            def log_message(self, fmt, *args):
                log(f'[serve] {fmt % args}')

            def _unauthorized(self, path) -> bool:
                if path == '/health' or server._check_auth(self.headers):
                    return False
                self._send(*_error(401, 'missing or invalid Authorization: '
                                        'Bearer token'),
                           {'WWW-Authenticate': 'Bearer'})
                return True

            def _send(self, status, ctype, payload, headers=None):
                self.send_response(status)
                self.send_header('Content-Type', ctype)
                self.send_header('Content-Length', str(len(payload)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                path = self.path.split('?')[0]
                if self._unauthorized(path):
                    return
                if path == '/health':
                    self._send(*server._handle_health())
                elif path == '/labels':
                    self._send(*server._handle_labels())
                elif path == '/metrics':
                    self._send(*server._handle_metrics())
                else:
                    self._send(*_error(404, 'not found'))

            def do_POST(self):
                parsed = urlparse(self.path)
                if self._unauthorized(parsed.path):
                    return
                if parsed.path != '/predict':
                    self._send(*_error(404, 'not found'))
                    return
                try:
                    length = int(self.headers.get('Content-Length', 0))
                except (TypeError, ValueError):
                    length = -1
                if length < 0:
                    self._send(*_error(411, 'Content-Length required'))
                    return
                if length > server.max_body_bytes:
                    # reject before buffering; a bounded drain lets a plain
                    # client finish writing and read the 413 instead of a
                    # broken pipe
                    self._send(*_error(
                        413, f'request body {length} bytes exceeds limit '
                             f'{server.max_body_bytes}'))
                    try:
                        self.wfile.flush()
                        deadline = time.monotonic() + 5.0
                        left = length
                        while left > 0 and time.monotonic() < deadline:
                            chunk = self.rfile.read(min(left, 1 << 20))
                            if not chunk:
                                break
                            left -= len(chunk)
                    except OSError:
                        pass  # the client already went away
                    self.close_connection = True
                    return
                body = self.rfile.read(length)
                t0 = time.perf_counter()
                with server._track() as accepted:
                    if not accepted:
                        self._send(*_error(503, 'server is shutting down'))
                        return
                    try:
                        result = server._predict_guarded(
                            body, parse_qs(parsed.query))
                    except Exception as ex:
                        warn(f'[serve] predict failed: {ex}')
                        result = _error(500, str(ex))
                    server._record(time.perf_counter() - t0,
                                   error=result[0] != 200)
                    self._send(*result)

        return Handler

    def start(self) -> 'TS2DServer':
        with self._active_cv:
            self._draining = False
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          self._make_handler())
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name='ts2d-server')
        self._thread.start()
        log(f'TS2D serving on http://{self.host}:{self.port}')
        if (self.host not in ('127.0.0.1', 'localhost', '::1')
                and self.auth_token is None):
            warn(f'serving on non-loopback address {self.host!r} with no '
                 f'auth token: the endpoint has no authentication or TLS. '
                 f'Set auth_token / --auth-token / TS2D_AUTH_TOKEN, or put '
                 f'it behind an authenticated reverse proxy.')
        return self

    def stop(self, drain_timeout: float = 30.0) -> bool:
        """Stop accepting work and drain the predicts in flight: new ones
        answer 503; returns once the running ones finish (False when
        ``drain_timeout`` passes first)."""
        with self._active_cv:
            self._draining = True
        if self._httpd is not None:
            self._httpd.shutdown()
            # shutdown() only leaves serve_forever; the listening socket
            # stays open without server_close()
            self._httpd.server_close()
            self._httpd = None
        drained = True
        deadline = time.monotonic() + drain_timeout
        with self._active_cv:
            while self._active > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    warn(f'{self._active} predict(s) still in flight after '
                         f'the {drain_timeout:.0f}s shutdown drain; '
                         f'abandoning them')
                    drained = False
                    break
                self._active_cv.wait(remaining)
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        return drained

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()


def production_wire(channel_names) -> tuple:
    """The int16 wire a CT stream hits (ensemble_engine.wire_detect):
    projection modes that pick a voxel of an integer volume (max / mip /
    min / first) stay exactly integral; averaging modes are fractional and
    ride float32. --warmup warms this variant beside the float32 one."""
    names = [str(n).lower() for _, n in sorted(channel_names.items())]
    return tuple(n in ('max', 'mip', 'min', 'first') for n in names)


def main(argv=None) -> None:
    import argparse
    from .api import TS2D
    from .utils.config import get_default_model

    parser = argparse.ArgumentParser(
        description='Serve TS2D (PyTorch/CUDA build) over HTTP.')
    parser.add_argument('--model', type=str, default=None)
    parser.add_argument('--host', type=str, default='127.0.0.1')
    parser.add_argument('--port', type=int, default=8008)
    parser.add_argument('--local', type=str, default=None,
                        help='the local model database root (defaults to '
                             '~/.ts2d/models)')
    parser.add_argument('--device', type=str, default=None,
                        help="where the models run: 'cuda' (the default; an "
                             "error without a CUDA device) or 'cpu'")
    parser.add_argument('--batch-linger-ms', type=float, default=0.0,
                        help='hold a partial micro-batch up to this long '
                             'waiting for it to fill (throughput mode; '
                             '0 = dispatch at once, latency mode)')
    parser.add_argument('--max-body-mb', type=int,
                        default=DEFAULT_MAX_BODY // (1024 * 1024),
                        help='reject request bodies larger than this '
                             '(HTTP 413)')
    parser.add_argument('--request-timeout', type=float, default=0.0,
                        metavar='SECONDS',
                        help='answer 504 when a predict exceeds this '
                             'wall-clock budget (0 = no timeout)')
    parser.add_argument('--auth-token', type=str,
                        default=os.environ.get('TS2D_AUTH_TOKEN'),
                        help='require "Authorization: Bearer <token>" on '
                             'every endpoint except /health (default: '
                             '$TS2D_AUTH_TOKEN)')
    parser.add_argument('--pad-quantum', type=int, default=None,
                        metavar='N',
                        help='quantized-shape serving: scans ride shape '
                             'buckets (next multiple of N per axis, one '
                             'bucket program each), so scans of different '
                             'sizes share programs and micro-batches; masks '
                             'match the exact programs up to borderline '
                             'pixels (omit for the exact per-shape programs)')
    parser.add_argument('--warmup', type=str, nargs='*', default=(),
                        metavar='HxW',
                        help='run the fused programs of these projection '
                             'shapes (e.g. 350x280; with --pad-quantum their '
                             'buckets) once before serving')
    args = parser.parse_args(argv)
    if args.pad_quantum is not None and args.pad_quantum < 1:
        parser.error('--pad-quantum must be >= 1')
    # every --warmup shape is checked before any program runs
    warmup_shapes = []
    for shape in args.warmup:
        try:
            h, w = (int(v) for v in shape.lower().split('x'))
        except ValueError:
            parser.error(f"--warmup expects HxW (e.g. 350x280); got '{shape}'")
        warmup_shapes.append((h, w))

    key = args.model or get_default_model()
    with TS2D(key=key, use_remote=False, local=args.local,
              device=args.device, pad_quantum=args.pad_quantum) as tool:
        fused = tool._fused
        if args.batch_linger_ms:
            if fused is not None:
                fused.set_batch_linger(args.batch_linger_ms)
            else:
                warn('--batch-linger-ms needs a fused model set; requests '
                     'will run unbatched')
        if warmup_shapes and fused is None:
            warn('--warmup needs a fused model set; skipping')
            warmup_shapes = []
        prod_wire = (production_wire(fused.spec.channel_names)
                     if fused is not None else ())
        for h, w in warmup_shapes:
            log(f'warming up {h}x{w} ...')
            fused.warmup((h, w))
            if any(prod_wire):
                log(f'warming up {h}x{w} int16 wire {prod_wire} ...')
                fused.warmup((h, w), wire=prod_wire)
        server = TS2DServer(
            tool, host=args.host, port=args.port,
            max_body_bytes=args.max_body_mb * 1024 * 1024,
            request_timeout=args.request_timeout or None,
            auth_token=args.auth_token).start()
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            pass
        finally:
            server.stop()


if __name__ == '__main__':
    main()
