"""Dependency-free HTTP front end + the ``serve <cfg>`` entry point — the
port's counterpart of ``fast_tffm_tpu/serve/frontend.py``.

    POST /score      body: libsvm lines (one score owed per line; labels
                     accepted and ignored, blank lines score as the
                     model bias). Response: one ``%.6f`` score per line
                     — byte-identical to a ``.score`` file of the same
                     lines scored by batch predict against the same
                     checkpoint step — with that step in ``X-FM-Step``.
                     Malformed lines are 400 with the parse error; a
                     chunked body is 411; a closed or wedged server is
                     503.
    POST /reload     the fleet supervisor's reload token. Body: a step
                     number, or empty for the server's pointer.
                     Synchronous: 200 with {"ok": true, "step": N} once
                     step N serves (the step already served is a
                     no-op), 503 with {"ok": false, ...} when the step
                     is missing or torn (the old step keeps serving),
                     400 for a body that is not an integer.
    GET  /healthz    JSON: alive/ready/warmed, the served and published
                     steps, reloads and reload failures, queue depth,
                     request counters, latency p50/p99, uptime, the
                     device and the kernel that scores.
    GET  /metrics    the server's registry as Prometheus text
                     (version 0.0.4; obs/prom.py).

The served step follows the ``published`` pointer (``fmckpt publish``):
the ScorerServer's reload thread hot-swaps each newly published step,
or, under ``serve_reload_mode = external`` (a fleet replica), the
supervisor hands it each step through ``POST /reload``.

Each connection gets a thread (ThreadingHTTPServer); all of them funnel
into the ScorerServer's admission queue, which is the batching point.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from fast_tffm_tpu_torch.data.parser import ParseError
from fast_tffm_tpu_torch.obs.prom import PROM_CONTENT_TYPE
from fast_tffm_tpu_torch.scoring import format_scores

# Per-request scoring budget: far above any healthy flush, but bounded,
# so a wedged dispatcher degrades to 503s instead of an unbounded pile
# of blocked connection threads.
_SCORE_TIMEOUT_SECONDS = 60.0


class _Handler(BaseHTTPRequestHandler):
    server_version = "fmserve-torch/1.0"
    protocol_version = "HTTP/1.1"

    def _reply(self, code: int, body: bytes, ctype: str,
               extra=None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self) -> None:  # noqa: N802 - http.server contract
        if self.headers.get("Transfer-Encoding"):
            # No chunked-body support: without a Content-Length the body
            # can't be drained, and an undrained body desyncs the
            # keep-alive stream — refuse AND drop the connection.
            self.close_connection = True
            self._reply(411, b"chunked bodies unsupported; send "
                             b"Content-Length\n", "text/plain")
            return
        # Drain the body BEFORE any routing reply, so a 404'd POST does
        # not leave its body in the keep-alive stream.
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length)
        if self.path == "/reload":
            try:
                body = raw.decode("utf-8", errors="strict").strip()
                step = int(body) if body else None
            except ValueError as e:
                self._reply(400, f"{e}\n".encode("utf-8"), "text/plain")
                return
            ok, now = self.server.fm_server.external_reload(step)
            payload = json.dumps({"ok": ok, "step": now}) + "\n"
            self._reply(200 if ok else 503, payload.encode("utf-8"),
                        "application/json")
            return
        if self.path != "/score":
            self._reply(404, b"unknown path; POST /score or /reload\n",
                        "text/plain")
            return
        try:
            # decode inside the try: a non-UTF-8 body is the caller's
            # 400 (UnicodeDecodeError is a ValueError).
            body = raw.decode("utf-8", errors="strict")
            res = self.server.fm_server.score_lines(
                body.splitlines(), timeout=_SCORE_TIMEOUT_SECONDS)
        except (ParseError, ValueError) as e:
            self._reply(400, f"{e}\n".encode("utf-8"), "text/plain")
            return
        except (RuntimeError, TimeoutError) as e:
            # A closed server mid-shutdown, or a wedged flush: this
            # request gets a 503, never a pinned connection thread.
            self._reply(503, f"{e}\n".encode("utf-8"), "text/plain")
            return
        self._reply(200, format_scores(res.scores).encode("utf-8"),
                    "text/plain", extra={"X-FM-Step": str(res.step)})

    def do_GET(self) -> None:  # noqa: N802 - http.server contract
        if self.path == "/metrics":
            body = self.server.fm_server.metrics_text()
            self._reply(200, body.encode("utf-8"), PROM_CONTENT_TYPE)
            return
        if self.path != "/healthz":
            self._reply(404, b"unknown path; GET /healthz or /metrics\n",
                        "text/plain")
            return
        stats = self.server.fm_server.stats()
        self._reply(200, (json.dumps(stats) + "\n").encode("utf-8"),
                    "application/json")

    def log_message(self, fmt, *args):  # noqa: A003 - http.server API
        self.server.fm_server._logger.debug("http: " + fmt, *args)


class ScoreHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # The listen backlog: socketserver's default of 5 resets the
    # connections of a burst of concurrent clients on a loaded host.
    request_queue_size = 128

    def __init__(self, fm_server, host: str, port: int):
        self.fm_server = fm_server
        super().__init__((host, port), _Handler)


def make_http_server(fm_server, port: int,
                     host: str = "127.0.0.1") -> ScoreHTTPServer:
    """Bind the front end (port 0 = ephemeral; read the real one from
    ``.server_address``). The caller owns serve_forever/shutdown."""
    return ScoreHTTPServer(fm_server, host, port)


def run_serve(cfg, device=None) -> int:
    """The ``serve <cfg>`` entry point (and each fleet replica's): load
    the published checkpoint step, bind the HTTP front end while the
    shape ladder warms in the background (``/healthz`` answers alive,
    not ready, until it is warm), serve (and hot-reload newly published
    steps) until SIGTERM/SIGINT, then drain and close. Returns a process
    exit code."""
    import signal
    import threading
    from fast_tffm_tpu_torch.serve.server import ScorerServer
    from fast_tffm_tpu_torch.utils.logging import get_logger
    logger = get_logger(log_file=cfg.log_file or None)
    stop = threading.Event()

    def _on_signal(signum, _frame):
        logger.info("serve: received signal %d; shutting down", signum)
        stop.set()

    # Handlers go in BEFORE the (load + warmup) startup window, so a
    # stop landing mid-startup still reaches the drain path below.
    prev = {s: signal.signal(s, _on_signal)
            for s in (signal.SIGTERM, signal.SIGINT)}
    server = None
    httpd = None
    t = None
    try:
        server = ScorerServer(cfg, logger=logger, device=device,
                              warmup="background")
        if not stop.is_set():
            httpd = make_http_server(server, cfg.serve_port,
                                     host=cfg.serve_host)
            t = threading.Thread(target=httpd.serve_forever,
                                 name="fmt-serve-http", daemon=True)
            t.start()
            host, port = httpd.server_address[:2]
            logger.info("serving on http://%s:%d (POST /score, GET "
                        "/healthz, GET /metrics)", host, port)
            stop.wait()
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
        if httpd is not None:
            httpd.shutdown()
            t.join()
            httpd.server_close()
        if server is not None:
            server.close()
    return 0
