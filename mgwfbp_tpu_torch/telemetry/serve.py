"""The live HTTP plane of a training process or a serving replica: GET
/healthz and /status, POST /predict.

Port of the training and serving subset of ``mgwfbp_tpu/telemetry/serve.py``:

  * ``MetricsAggregator`` — in-memory state fed by the event stream: the
    training step, epoch and last checkpoint, the bad-step and rollback
    counts, the watchdog's health verdict (/healthz answers 503 while a
    stall lasts, for good once it aborts), and the serving plane's
    ``reload`` and ``serve_stats`` events;
  * ``TelemetryServer`` — a background ``ThreadingHTTPServer`` (loopback by
    default) whose POST ``/predict`` route is opened by
    ``attach_predict(service)``;
  * ``resolve_metrics_port`` / ``serve_port_offset`` / ``write_port_file`` /
    ``start_metrics_server`` — the role-aware port convention (serving
    replicas listen on ``base + offset + replica``; base 0 is ephemeral).

The training role listens on ``base + process_index`` and writes the port
it bound to ``MGWFBP_METRICS_PORT_FILE`` when that is set (the supervisor
reads it). ``/metrics``, ``/profile`` and ``/postmortems`` answer 404 with a
body naming ROADMAP Queue 1 item 5, which ports them.
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
    """In-memory live state of one process (thread-safe: the step loop, the
    watchdog thread and the HTTP handler threads all touch it), fed by the
    event stream's observer (``EventWriter.observer``) or by a serving
    plane's ``emit``.

    Training: ``step`` (current step and epoch), ``epoch``, ``checkpoint``
    (the last commit), ``bad_step`` and ``rollback`` (counted),
    ``watchdog_stall`` (unhealthy until the next ``step``; sticky once the
    stall aborts with rc 86, as the process is about to exit). Serving:
    ``reload`` (the served step and its lag) and ``serve_stats``.
    ``extra_status`` is a callable whose dict ``status()`` merges in (a
    replica's kernel launch counts)."""

    def __init__(self, run: Optional[dict] = None, extra_status=None):
        self._lock = threading.Lock()
        self._run = dict(run or {})
        self._t0 = time.time()
        self._counts: collections.Counter = collections.Counter()
        self._current_step: Optional[int] = None
        self._current_epoch: Optional[int] = None
        self._last_checkpoint: Optional[dict] = None
        self._schedule: Optional[dict] = None
        self._serving_step: Optional[int] = None
        self._reload_lag_s: Optional[float] = None
        self._serve_stats: Optional[dict] = None
        # None = healthy, else the reason; sticky once an abort-bound stall
        # landed
        self._unhealthy: Optional[str] = None
        self._unhealthy_sticky = False
        self._extra_status = extra_status

    def observe(self, event: str, fields: dict) -> None:
        """One validated telemetry record."""
        with self._lock:
            self._counts[event] += 1
            if event == "header":
                run = fields.get("run")
                if isinstance(run, dict):
                    self._run.update(run)
            elif event == "step":
                self._current_step = int(fields.get("step", 0))
                self._current_epoch = int(fields.get("epoch", 0))
                if not self._unhealthy_sticky:
                    # the loop moved again after a non-abort stall
                    self._unhealthy = None
            elif event == "epoch":
                self._current_epoch = int(fields.get("epoch", 0))
            elif event == "checkpoint":
                self._last_checkpoint = dict(fields)
            elif event == "watchdog_stall":
                abort = bool(fields.get("abort"))
                self._unhealthy = (
                    f"watchdog stall in {fields.get('phase')!r} after "
                    f"{float(fields.get('idle_s', 0.0)):.0f}s"
                    + (" — aborting (rc 86)" if abort else "")
                )
                if abort:
                    self._unhealthy_sticky = True
            elif event == "reload":
                self._serving_step = int(fields.get("step", 0))
                self._reload_lag_s = float(fields.get("lag_s", 0.0))
            elif event == "serve_stats":
                self._serve_stats = dict(fields)

    def set_schedule(self, comm_op: str, num_groups: int,
                     policy_detail: str = "") -> None:
        """The committed merge schedule (state, not an event): the trainer
        pushes it at build and at a cross-world resume."""
        with self._lock:
            self._schedule = {"comm_op": str(comm_op),
                              "num_groups": int(num_groups),
                              "policy_detail": str(policy_detail)}

    def health(self) -> tuple[bool, str]:
        """(healthy?, reason) for /healthz."""
        with self._lock:
            if self._unhealthy is None:
                return True, "ok"
            return False, self._unhealthy

    def status(self) -> dict:
        """The /status JSON document."""
        with self._lock:
            healthy = self._unhealthy is None
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
            doc = {
                "run": dict(self._run),
                "healthy": healthy,
                "health_reason": "ok" if healthy else self._unhealthy,
                "uptime_s": round(time.time() - self._t0, 3),
                "step": self._current_step,
                "epoch": self._current_epoch,
                "schedule": dict(self._schedule) if self._schedule else None,
                "last_checkpoint": (
                    dict(self._last_checkpoint)
                    if self._last_checkpoint is not None else None
                ),
                "bad_steps": int(self._counts.get("bad_step", 0)),
                "rollbacks": int(self._counts.get("rollback", 0)),
                "serving": serving,
            }
        if self._extra_status is not None:
            doc.update(self._extra_status())
        return doc


# routes of the JAX plane that come with the rest of the telemetry plane
UNPORTED_ROUTES = ("/metrics", "/profile", "/postmortems")
UNPORTED_BODY = (
    "{path} is not ported to the PyTorch plane yet (ROADMAP Queue 1 item 5: "
    "the rest of the telemetry plane); this process serves /healthz, "
    "/status and POST /predict\n"
)


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
        elif path in UNPORTED_ROUTES:
            body = UNPORTED_BODY.format(path=path).encode()
            ctype = "text/plain; charset=utf-8"
            code = 404
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
