"""HTTP plane for a serving replica: POST /predict, GET /healthz, /status.

Port of the serving subset of ``mgwfbp_tpu/telemetry/serve.py``:

  * ``MetricsAggregator`` — a minimal in-memory view fed by the serving
    plane's ``reload`` and ``serve_stats`` events, read by ``/status``'s
    ``serving`` section;
  * ``TelemetryServer`` — a background ``ThreadingHTTPServer`` (loopback by
    default) whose POST ``/predict`` route is opened by
    ``attach_predict(service)``;
  * ``resolve_metrics_port`` / ``serve_port_offset`` / ``write_port_file`` /
    ``start_metrics_server`` — the role-aware port convention (serving
    replicas listen on ``base + offset + replica``; base 0 is ephemeral).

``/metrics``, ``/profile`` and ``/postmortems`` come with the telemetry
slice of the port (ROADMAP.md).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from mgwfbp_tpu_torch.utils.logging import get_logger

METRICS_PORT_ENV = "MGWFBP_METRICS_PORT"
METRICS_HOST_ENV = "MGWFBP_METRICS_HOST"
# where to persist this process's ACTUAL bound port (JSON sidecar)
METRICS_PORT_FILE_ENV = "MGWFBP_METRICS_PORT_FILE"
# serving replicas ride the training base-port convention, displaced by
# this offset (train: base + index; serve: base + offset + index)
SERVE_PORT_OFFSET_ENV = "MGWFBP_SERVE_PORT_OFFSET"
DEFAULT_SERVE_PORT_OFFSET = 100


def serve_port_offset() -> int:
    """The serving role's displacement above the training port band."""
    raw = (os.environ.get(SERVE_PORT_OFFSET_ENV) or "").strip()
    if not raw:
        return DEFAULT_SERVE_PORT_OFFSET
    try:
        off = int(raw)
    except ValueError:
        return DEFAULT_SERVE_PORT_OFFSET
    return off if off > 0 else DEFAULT_SERVE_PORT_OFFSET


def resolve_metrics_port(
    base_port: Optional[int], process_index: int = 0, role: str = "train",
) -> Optional[int]:
    """Concrete listen port for one process: ``base + index``, displaced
    by ``serve_port_offset()`` for ``role='serve'``. ``base == 0`` asks the
    OS for an ephemeral port; None disables the plane."""
    if base_port is None:
        return None
    base = int(base_port)
    if base < 0:
        raise ValueError(f"metrics port must be >= 0, got {base}")
    if role not in ("train", "serve"):
        raise ValueError(f"unknown metrics role {role!r}")
    offset = serve_port_offset() if role == "serve" else 0
    port = 0 if base == 0 else base + offset + int(process_index)
    if port > 65535:
        raise ValueError(
            f"metrics port {base} + role offset {offset} + "
            f"process_index {process_index} exceeds 65535"
        )
    return port


class MetricsAggregator:
    """In-memory serving state for one replica (thread-safe): run
    metadata, the served step and its reload lag, the dispatcher's latest
    stats snapshot."""

    def __init__(self, run: Optional[dict] = None):
        self._lock = threading.Lock()
        self._run = dict(run or {})
        self._t0 = time.time()
        self._counts: collections.Counter = collections.Counter()
        self._serving_step: Optional[int] = None
        self._reload_lag_s: Optional[float] = None
        self._serve_stats: Optional[dict] = None

    def observe(self, event: str, fields: dict) -> None:
        """One telemetry record (the serving plane's ``emit``)."""
        with self._lock:
            self._counts[event] += 1
            if event == "reload":
                self._serving_step = int(fields.get("step", 0))
                self._reload_lag_s = float(fields.get("lag_s", 0.0))
            elif event == "serve_stats":
                self._serve_stats = dict(fields)

    def health(self) -> tuple[bool, str]:
        """(healthy?, reason) for /healthz."""
        return True, "ok"

    def status(self) -> dict:
        """The /status JSON document."""
        with self._lock:
            serving = None
            if self._serving_step is not None or self._serve_stats is not None:
                serving = {
                    "step": self._serving_step,
                    "reload_lag_s": self._reload_lag_s,
                    "reloads": int(self._counts.get("reload", 0)),
                    "stats": (
                        dict(self._serve_stats)
                        if self._serve_stats is not None else None
                    ),
                }
            return {
                "run": dict(self._run),
                "healthy": True,
                "health_reason": "ok",
                "uptime_s": round(time.time() - self._t0, 3),
                "serving": serving,
            }


class _Handler(BaseHTTPRequestHandler):
    # the aggregator is attached to the server instance by TelemetryServer
    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        from urllib.parse import urlsplit

        agg: MetricsAggregator = self.server.aggregator  # type: ignore
        path = urlsplit(self.path).path.rstrip("/") or "/"
        if path == "/healthz":
            healthy, reason = agg.health()
            body = (reason + "\n").encode()
            ctype = "text/plain; charset=utf-8"
            code = 200 if healthy else 503
        elif path in ("/status", "/"):
            body = (json.dumps(agg.status(), indent=1) + "\n").encode()
            ctype = "application/json"
            code = 200
        else:
            body = b"not found: serve /healthz, /status (POST /predict)\n"
            ctype = "text/plain; charset=utf-8"
            code = 404
        self._respond(code, ctype, body)

    def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        from urllib.parse import urlsplit

        path = urlsplit(self.path).path.rstrip("/") or "/"
        if path != "/predict":
            self._respond(
                404, "text/plain; charset=utf-8",
                b"not found: POST serves /predict only\n",
            )
            return
        # without an attached service the route exists but answers 503 —
        # a prober can tell "no serving on this process" from "route
        # missing"
        service = getattr(self.server, "predict_service", None)
        if service is None:
            self._respond_json(
                503, {"error": "no serving model attached to this process"}
            )
            return
        try:
            n = int(self.headers.get("Content-Length") or 0)
            doc = json.loads(self.rfile.read(n) if n else b"")
            if not isinstance(doc, dict) or "inputs" not in doc:
                raise ValueError(
                    'body must be a JSON object with an "inputs" list'
                )
            inputs = doc["inputs"]
        except (ValueError, KeyError) as e:
            self._respond_json(400, {"error": f"bad request: {e}"})
            return
        # handle() blocks THIS handler thread until the dispatcher
        # flushes the batch; ThreadingHTTPServer keeps other requests
        # flowing meanwhile
        code, out = service.handle(inputs)
        self._respond_json(code, out)

    def _respond_json(self, code: int, doc: dict) -> None:
        self._respond(
            code, "application/json", (json.dumps(doc) + "\n").encode()
        )

    def _respond(self, code: int, ctype: str, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass


class TelemetryServer:
    """Background HTTP server over one MetricsAggregator.

    ``port == 0`` binds an ephemeral port (read it back from ``.port``).
    Construction failures (port in use) raise — callers that must not die
    wrap it (`start_metrics_server`). ``close()`` is idempotent."""

    def __init__(
        self,
        aggregator: MetricsAggregator,
        port: int,
        host: Optional[str] = None,
    ):
        # loopback by default: the endpoints are unauthenticated
        if host is None:
            host = os.environ.get(METRICS_HOST_ENV) or "127.0.0.1"
        self.aggregator = aggregator
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.aggregator = aggregator  # type: ignore[attr-defined]
        self._httpd.predict_service = None  # type: ignore[attr-defined]
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"mgwfbp-metrics:{self.port}",
            daemon=True,
        )
        self._thread.start()

    def attach_predict(self, service) -> None:
        """Open the POST /predict route over a serving plane's
        PredictService (None detaches — the route answers 503 again).
        Handler threads read the attribute per request; attach/detach is
        a single reference store, safe against in-flight requests."""
        httpd = self._httpd
        if httpd is not None:
            httpd.predict_service = service  # type: ignore[attr-defined]

    def close(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        try:
            httpd.shutdown()
            httpd.server_close()
        except Exception:  # noqa: BLE001 — teardown must never raise
            pass
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


def write_port_file(
    path: str, server: TelemetryServer, process_index: int,
    role: str = "train",
) -> None:
    """Persist the ACTUAL bound endpoint (atomic JSON sidecar), so a
    caller that asked for an ephemeral port can find it. A wildcard bind
    is advertised as loopback here (cross-host advertising comes with the
    fleet slice of the port)."""
    host = server.host
    doc = {
        "process": int(process_index),
        "role": str(role),
        "host": "127.0.0.1" if host in ("", "0.0.0.0", "::") else host,
        "bound_host": host,
        "port": int(server.port),
        "pid": os.getpid(),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def start_metrics_server(
    aggregator: MetricsAggregator,
    base_port: Optional[int],
    process_index: int = 0,
    role: str = "train",
) -> Optional[TelemetryServer]:
    """Start the per-process server, or None when disabled or the bind
    fails (logged — the plane is observability, not a dependency)."""
    log = get_logger("mgwfbp.telemetry.serve")
    try:
        port = resolve_metrics_port(base_port, process_index, role)
    except ValueError as e:
        log.warning("metrics server disabled: %s", e)
        return None
    if port is None:
        return None
    try:
        server = TelemetryServer(aggregator, port)
    except (OSError, OverflowError) as e:
        log.warning(
            "metrics server failed to bind port %d (%s); the HTTP plane "
            "is disabled for this process", port, e,
        )
        return None
    port_file = (os.environ.get(METRICS_PORT_FILE_ENV) or "").strip()
    if port_file:
        try:
            write_port_file(port_file, server, process_index, role)
        except OSError as e:  # the sidecar is a convenience, not a gate
            log.warning("could not write metrics port file %s: %s",
                        port_file, e)
    log.info(
        "metrics server: http://%s:%d (/healthz /status POST /predict)",
        server.host, server.port,
    )
    return server
