"""Failover reverse proxy for the serving fleet — the port's counterpart
of ``fast_tffm_tpu/serve/proxy.py``, stdlib HTTP only.

``python -m fast_tffm_tpu_torch serve <cfg> --replicas N`` binds this on
``serve_proxy_port`` in the supervisor process (serve/fleet.py), in
front of N ScorerServer replica processes on ``serve_port + i``.

    POST /score      forwarded to one ready replica. A refused
                     connection, a reset, a timeout or an upstream 5xx
                     on this idempotent request retries, after a short
                     backoff, on a different ready replica, up to
                     ``serve_retry_budget`` times; the failed replica is
                     marked not ready at once (the supervisor's next
                     health poll re-admits it). A 4xx passes through
                     unretried. With the budget spent the answer is 503
                     with ``Retry-After``. The body is the replica's,
                     untouched; ``X-FM-Replica`` names the replica,
                     ``X-FM-Step`` the step that scored.
    GET  /healthz    the fleet's aggregate: replica count, alive and
                     ready counts, a row per replica. 200 while at least
                     one replica is ready, 503 otherwise.

Routing, in order of precedence:

- **Affinity**: a request carrying the ``serve_affinity_header`` header
  goes to the ready replica its key rendezvous-hashes to
  (highest random weight), so a user's burst shares one admission
  window; when the replica set changes, only the keys of the replica
  that left or came move.
- **Canary**: with a ready canary and ``serve_canary_fraction`` > 0, a
  deterministic splitter sends exactly that fraction of unkeyed traffic
  to it. Under ``serve_canary_shadow`` the canary gets copies instead,
  scored and compared (``proxy/canary_score_delta``), never returned.
- **Round-robin** over the ready non-canary replicas otherwise; with
  none ready, a ready canary still scores.

Load shedding: beyond ``serve_proxy_max_inflight`` proxied requests in
flight the proxy answers 503 with ``Retry-After`` at once. ``GET
/metrics`` answers the proxy's registry (its routed, retried and shed
counters, and the supervisor's ``fleet/*`` gauges when the supervisor
hands it its own) in Prometheus text (obs/prom.py), as the JAX
package's proxy does.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence

from fast_tffm_tpu_torch.obs.registry import MetricsRegistry
from fast_tffm_tpu_torch.utils.logging import get_logger

# Per-attempt forwarding budget: far above any healthy flush, but
# bounded, so a wedged replica costs one attempt's timeout, not a pinned
# connection thread.
_FORWARD_TIMEOUT_SECONDS = 60.0
# Base pause before a failover retry: lets a blipping replica's accept
# queue clear, short beside a micro-batch flush.
_RETRY_BACKOFF_SECONDS = 0.05


class Replica:
    """One backend's routing state as the proxy sees it: written by the
    supervisor's health poll (``set_health``) and by the proxy on a
    failed forward (``mark_failed``), read by the router."""

    def __init__(self, index: int, host: str, port: int,
                 canary: bool = False):
        self.index = int(index)
        self.host = host
        self.port = int(port)
        self.canary = bool(canary)
        self.name = f"{host}:{port}"
        self._lock = threading.Lock()
        self.alive = False
        self.ready = False
        self.served_step = -1
        self.queue_depth = 0

    def set_health(self, alive: bool, ready: bool,
                   served_step: int = -1,
                   queue_depth: int = 0) -> None:
        with self._lock:
            self.alive = bool(alive)
            self.ready = bool(ready)
            self.served_step = int(served_step)
            self.queue_depth = int(queue_depth)

    def mark_failed(self) -> None:
        """Stop routing here now; the next health poll re-admits a
        replica that only blipped."""
        with self._lock:
            self.ready = False

    def is_ready(self) -> bool:
        with self._lock:
            return self.ready

    def row(self) -> dict:
        with self._lock:
            return {"index": self.index, "port": self.port,
                    "alive": self.alive, "ready": self.ready,
                    "served_step": self.served_step,
                    "queue_depth": self.queue_depth,
                    "canary": self.canary}


class FleetView:
    """The shared replica registry: the supervisor writes, the proxy
    reads."""

    def __init__(self, replicas: Sequence[Replica]):
        self.replicas: List[Replica] = list(replicas)

    def ready(self, include_canary: bool = False) -> List[Replica]:
        return [r for r in self.replicas
                if r.is_ready() and (include_canary or not r.canary)]

    def canary(self) -> Optional[Replica]:
        return next((r for r in self.replicas if r.canary), None)

    def counts(self):
        """(alive, ready, total, rows)."""
        rows = [r.row() for r in self.replicas]
        return (sum(1 for r in rows if r["alive"]),
                sum(1 for r in rows if r["ready"]),
                len(rows), rows)


def rendezvous_choose(key: str, replicas: Sequence[Replica]) -> Replica:
    """Highest-random-weight hashing: each (key, replica) pair has an
    independent weight and the key goes to its largest, so removing a
    replica remaps only the keys that were on it."""
    def weight(r: Replica) -> bytes:
        return hashlib.blake2b(f"{key}|{r.name}".encode("utf-8"),
                               digest_size=8).digest()
    return max(replicas, key=weight)


class FractionSplitter:
    """Deterministic fraction router: over any first n calls, ``take()``
    returns True floor(n * fraction) times."""

    def __init__(self, fraction: float):
        self.fraction = max(0.0, min(1.0, float(fraction)))
        self._lock = threading.Lock()
        self._seen = 0
        self._taken = 0

    def take(self) -> bool:
        if self.fraction <= 0.0:
            return False
        with self._lock:
            self._seen += 1
            if self._taken < int(self._seen * self.fraction):
                self._taken += 1
                return True
            return False


class _ProxyHandler(BaseHTTPRequestHandler):
    server_version = "fmproxy-torch/1.0"
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

    def do_GET(self) -> None:  # noqa: N802 - http.server contract
        proxy = self.server.proxy
        if self.path == "/metrics":
            from fast_tffm_tpu_torch.obs.prom import (PROM_CONTENT_TYPE,
                                                      prometheus_text)
            body = prometheus_text(proxy.registry.snapshot())
            self._reply(200, body.encode("utf-8"), PROM_CONTENT_TYPE)
            return
        if self.path != "/healthz":
            self._reply(404, b"unknown path; GET /healthz or /metrics\n",
                        "text/plain")
            return
        alive, ready, total, rows = proxy.view.counts()
        payload = {"status": "ok" if ready else "degraded",
                   "replicas": total, "alive": alive, "ready": ready,
                   "per_replica": rows}
        self._reply(200 if ready else 503,
                    (json.dumps(payload) + "\n").encode("utf-8"),
                    "application/json")

    def do_POST(self) -> None:  # noqa: N802 - http.server contract
        if self.headers.get("Transfer-Encoding"):
            # An undrainable body desyncs the keep-alive stream: refuse
            # and drop the connection, as the replica's front end does.
            self.close_connection = True
            self._reply(411, b"chunked bodies unsupported; send "
                             b"Content-Length\n", "text/plain")
            return
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length)
        if self.path != "/score":
            self._reply(404, b"unknown path; POST /score\n", "text/plain")
            return
        proxy = self.server.proxy
        if not proxy.inflight.acquire(blocking=False):
            proxy.registry.count("proxy/shed_503")
            self._reply(503, b"proxy at max in-flight; retry\n",
                        "text/plain", extra={"Retry-After": "1"})
            return
        try:
            affinity = None
            if proxy.affinity_header:
                affinity = self.headers.get(proxy.affinity_header)
            code, body, extra = proxy.forward_score(raw, affinity)
            self._reply(code, body, "text/plain", extra=extra)
        finally:
            proxy.inflight.release()

    def log_message(self, fmt, *args):  # noqa: A003 - http.server API
        self.server.proxy._logger.debug("proxy: " + fmt, *args)


class _ProxyHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, proxy, host: str, port: int):
        self.proxy = proxy
        super().__init__((host, port), _ProxyHandler)


class ScoreProxy:
    """Routing and retry policy over a FleetView. ``forward_score`` is
    the whole per-request protocol, public so tests drive it without a
    socket on the client side (the replica side is real HTTP)."""

    def __init__(self, view: FleetView, retry_budget: int = 1,
                 affinity_header: str = "X-FM-Affinity",
                 canary_fraction: float = 0.0,
                 canary_shadow: bool = False,
                 max_inflight: int = 64,
                 registry: Optional[MetricsRegistry] = None,
                 logger=None,
                 forward_timeout: float = _FORWARD_TIMEOUT_SECONDS,
                 backoff_seconds: float = _RETRY_BACKOFF_SECONDS):
        self.view = view
        self.retry_budget = max(0, int(retry_budget))
        self.affinity_header = affinity_header
        self.canary_shadow = bool(canary_shadow)
        # Shadowing with no fraction set copies every request: the
        # comparison is the point and no client waits on it.
        frac = canary_fraction if (canary_fraction or not canary_shadow) \
            else 1.0
        self.splitter = FractionSplitter(frac)
        self.inflight = threading.Semaphore(max(1, int(max_inflight)))
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._logger = logger or get_logger()
        self._forward_timeout = float(forward_timeout)
        self._backoff = float(backoff_seconds)
        self._rr_lock = threading.Lock()
        self._rr = 0
        self._httpd = None
        self._http_thread = None
        self._shadows: List[threading.Thread] = []
        self._shadows_lock = threading.Lock()

    # -- routing ---------------------------------------------------------

    def _next_rr(self, candidates: List[Replica]) -> Replica:
        with self._rr_lock:
            self._rr += 1
            return candidates[self._rr % len(candidates)]

    def pick(self, affinity: Optional[str],
             exclude=()) -> Optional[Replica]:
        """One routing decision over the ready set now, less
        ``exclude`` (the replicas a retry already tried)."""
        ready = [r for r in self.view.ready() if r not in exclude]
        canary = self.view.canary()
        if affinity and ready:
            return rendezvous_choose(affinity, ready)
        if (canary is not None and not self.canary_shadow
                and canary.is_ready() and canary not in exclude
                and self.splitter.take()):
            self.registry.count("proxy/canary_requests")
            return canary
        if not ready:
            # Every primary is down: a ready canary still scores.
            if (canary is not None and canary.is_ready()
                    and canary not in exclude):
                return canary
            return None
        return self._next_rr(ready)

    # -- request path ----------------------------------------------------

    def forward_score(self, body: bytes, affinity: Optional[str]):
        """Route and forward one POST /score with failover; returns
        (status, body, extra headers). A 4xx passes through unretried;
        a transport error or a 5xx spends one attempt and retries on
        another ready replica."""
        self.registry.count("proxy/requests")
        tried: List[Replica] = []
        last_err = "no ready replica"
        for attempt in range(1 + self.retry_budget):
            replica = self.pick(affinity, exclude=tried)
            if replica is None:
                break
            if attempt:
                self.registry.count("proxy/retries")
                time.sleep(self._backoff * attempt)
            tried.append(replica)
            try:
                status, out, step = self._send(replica, body)
            except (OSError, http.client.HTTPException) as e:
                # Refused, reset or timed out: the replica is gone or
                # wedged; route around it now.
                replica.mark_failed()
                self.registry.count("proxy/transport_errors")
                last_err = f"{replica.name}: {type(e).__name__}: {e}"
                self._logger.warning(
                    "proxy: forward to %s failed (%s); failing over",
                    replica.name, last_err)
                continue
            if status >= 500:
                replica.mark_failed()
                self.registry.count("proxy/upstream_5xx")
                last_err = (f"{replica.name}: HTTP {status}: "
                            f"{out[:200].decode('utf-8', 'replace')}")
                continue
            if status == 200 and self.canary_shadow:
                self._maybe_shadow(body, out)
            extra = {"X-FM-Replica": str(replica.index)}
            if step is not None:
                extra["X-FM-Step"] = step
            return status, out, extra
        self.registry.count("proxy/unrouted_503")
        return (503,
                f"no replica could score the request ({last_err})\n"
                .encode("utf-8"),
                {"Retry-After": "1"})

    def _send(self, replica: Replica, body: bytes):
        conn = http.client.HTTPConnection(
            replica.host, replica.port, timeout=self._forward_timeout)
        try:
            conn.request("POST", "/score", body=body,
                         headers={"Content-Type": "text/plain"})
            resp = conn.getresponse()
            out = resp.read()
            return resp.status, out, resp.getheader("X-FM-Step")
        finally:
            conn.close()

    # -- canary shadow ---------------------------------------------------

    def _maybe_shadow(self, body: bytes, primary_out: bytes) -> None:
        canary = self.view.canary()
        if canary is None or not canary.is_ready() \
                or not self.splitter.take():
            return
        th = threading.Thread(
            target=self._shadow_compare, args=(canary, body, primary_out),
            name="fmt-proxy-shadow", daemon=True)
        with self._shadows_lock:
            self._shadows = [t for t in self._shadows if t.is_alive()]
            self._shadows.append(th)
        th.start()

    def _shadow_compare(self, canary: Replica, body: bytes,
                        primary_out: bytes) -> None:
        """Score the copy on the canary and gauge the largest |score
        difference| against the primary's answer. Never reaches the
        client; never retried."""
        try:
            status, out, _step = self._send(canary, body)
        except (OSError, http.client.HTTPException):
            self.registry.count("proxy/shadow_errors")
            return
        if status != 200:
            self.registry.count("proxy/shadow_errors")
            return
        try:
            a = [float(x) for x in primary_out.split()]
            b = [float(x) for x in out.split()]
        except ValueError:
            self.registry.count("proxy/shadow_errors")
            return
        if len(a) != len(b):
            self.registry.count("proxy/shadow_errors")
            return
        delta = max((abs(x - y) for x, y in zip(a, b)), default=0.0)
        self.registry.count("proxy/shadow_compares")
        self.registry.set("proxy/canary_score_delta", delta)

    # -- front-end lifecycle ---------------------------------------------

    def start(self, port: int, host: str = "127.0.0.1") -> int:
        """Bind and serve on a daemon thread (``fmt-proxy-http``);
        returns the bound port (0 = ephemeral)."""
        self._httpd = _ProxyHTTPServer(self, host, port)
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="fmt-proxy-http",
            daemon=True)
        self._http_thread.start()
        return self._httpd.server_address[1]

    def shutdown(self) -> None:
        """Stop the front end and wait for shadow comparisons in flight
        (each bounded by the forward timeout). Idempotent."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._http_thread.join()
            self._httpd.server_close()
            self._httpd = None
        with self._shadows_lock:
            shadows, self._shadows = self._shadows, []
        for th in shadows:
            th.join()
