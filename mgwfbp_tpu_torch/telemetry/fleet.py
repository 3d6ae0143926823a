"""Fleet fan-in: one group-level view over the per-process live planes (a
copy of ``mgwfbp_tpu/telemetry/fleet.py``), served by the supervisor
(``supervise --fleet-port``).

The supervisor knows every child's endpoint (the port-file sidecars cover
ephemeral ``MGWFBP_METRICS_PORT=0`` binds), so it serves:

  /fleet/metrics   every child's /metrics scraped, parsed back through the
                   shared registry (``export.parse_metrics_text``) and
                   re-rendered under a ``process`` label
                   (``export.render_labeled_metrics``) plus fleet-level
                   gauges: one registry end to end;
  /fleet/status    JSON: every child's /status, a live straggler table
                   (per-process mean step seconds and excess over the
                   fastest), the slowest process, the union of active
                   alarms (each tagged with its processes), the
                   per-process /profile windows, the postmortem index,
                   and the unreachable list;
  /fleet/profile   ``?steps=N`` arms /profile?steps=N on every child in
                   one call (per-child timeouts and outcomes); without a
                   query, the per-process window table.

Every child scrape has a hard timeout and the children are scraped
concurrently, so a wedged child is reported unreachable and never hangs
the fan-in. ``write_fleet_sd`` writes the targets in Prometheus HTTP
service-discovery format (``fleet.json``).
"""

from __future__ import annotations

import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from mgwfbp_tpu_torch.utils.logging import get_logger

# per-child scrape budget; the fan-in request as a whole is bounded by
# this (children are scraped concurrently), so a dead or wedged child
# costs one timeout, not a hang
SCRAPE_TIMEOUT_S = 2.0

# targets map: process key -> (host, port). Training children are keyed
# by int process index; serving replicas ride under str keys
# ("serve0", "serve1", ...) so the same map carries both roles.
TargetMap = Dict[object, Tuple[str, int]]


@dataclass
class ChildScrape:
    """One child's scraped live state (best-effort: `error` records a
    failed/timed-out scrape; a child with `status` answered)."""

    process: object  # int training index or "serve<i>" replica key
    host: str
    port: int
    status: Optional[dict] = None
    values: dict = field(default_factory=dict)
    error: Optional[str] = None

    @property
    def reachable(self) -> bool:
        return self.status is not None


def _http_get(url: str, timeout_s: float) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return resp.read().decode()


def scrape_child(
    process: int, host: str, port: int,
    timeout_s: float = SCRAPE_TIMEOUT_S,
) -> ChildScrape:
    """Fetch one child's /status + /metrics; failures land in `.error`,
    never raise — a dead child is a REPORT, not a fan-in failure."""
    from mgwfbp_tpu_torch.telemetry.export import parse_metrics_text

    out = ChildScrape(process=process, host=host, port=port)
    base = f"http://{host}:{port}"
    try:
        out.status = json.loads(_http_get(f"{base}/status", timeout_s))
    except Exception as e:  # noqa: BLE001 — refused/timeout are expected
        out.error = f"/status: {e}"
        return out
    try:
        out.values = parse_metrics_text(
            _http_get(f"{base}/metrics", timeout_s)
        )
    except Exception as e:  # noqa: BLE001 — half-scraped beats hung
        out.error = f"/metrics: {e}"
    return out


def scrape_fleet(
    targets: TargetMap, timeout_s: float = SCRAPE_TIMEOUT_S,
) -> list[ChildScrape]:
    """Scrape every target concurrently (process order in the result).
    Total wall time is bounded by ~one scrape budget, not targets * budget."""
    if not targets:
        return []
    # mixed int/str keys (training children + serve replicas) sort by
    # their string form — a plain sorted() would TypeError on int vs str
    items = sorted(targets.items(), key=lambda kv: str(kv[0]))
    with ThreadPoolExecutor(max_workers=min(len(items), 16)) as pool:
        futs = [
            pool.submit(scrape_child, idx, host, port, timeout_s)
            for idx, (host, port) in items
        ]
        return [f.result() for f in futs]


def straggler_table(children: list[ChildScrape]) -> list[dict]:
    """LIVE analog of `mgwfbp_tpu_torch.tools.telemetry_merge`'s
    `straggler_table`: one row per reachable child with a step-seconds
    window gauge, its excess over the fastest process (the
    group-synchronous cost it adds — the merge tool's
    mean-excess-vs-fastest semantics applied to the live rolling
    `mgwfbp_step_seconds` window instead of merged post-hoc spans)."""
    rows = []
    for c in children:
        if not c.reachable:
            continue
        step_s = c.values.get("mgwfbp_step_seconds")
        if step_s is None:
            continue
        rows.append({
            "process": c.process,
            "step": c.values.get("mgwfbp_current_step"),
            "steps_total": c.values.get("mgwfbp_steps_total", 0),
            "mean_step_s": float(step_s),
            "overlap_efficiency": c.values.get(
                "mgwfbp_overlap_efficiency"
            ),
        })
    if not rows:
        return rows
    fastest = min(r["mean_step_s"] for r in rows)
    for r in rows:
        r["excess_s"] = r["mean_step_s"] - fastest
        r["excess_pct"] = (
            (r["mean_step_s"] / fastest - 1.0) * 100.0
            if fastest > 0 else 0.0
        )
    return rows


def active_alarms(children: list[ChildScrape]) -> list[dict]:
    """Union of the group's active drift/straggler alarms, each tagged
    with the process whose stream raised it (a straggler alarm is
    group-agreed so every child reports it; dedup keeps one copy, listing
    the reporting processes)."""
    merged: dict = {}
    for c in children:
        if not c.reachable:
            continue
        for a in (c.status or {}).get("active_alarms", []):
            key = json.dumps(
                {k: a.get(k) for k in ("alarm", "kind", "group",
                                       "slow_process")},
                sort_keys=True,
            )
            row = merged.setdefault(key, dict(a, processes=[]))
            row["processes"].append(c.process)
    return sorted(
        merged.values(),
        key=lambda r: (str(r.get("alarm")), str(r.get("kind", ""))),
    )


def fleet_postmortems(children: list[ChildScrape]) -> list[dict]:
    """One row per reachable child that has written flight-recorder
    postmortem bundles (telemetry/recorder.py): bundle count + the recent
    manifests its /status reports — the fleet-wide postmortem index. An
    operator chasing a group-wide anomaly reads ONE endpoint and gets
    every process's evidence paths."""
    rows = []
    for c in children:
        if not c.reachable:
            continue
        pm = (c.status or {}).get("postmortems") or {}
        total = int(pm.get("total") or 0)
        if total <= 0:
            continue
        rows.append({
            "process": c.process,
            "total": total,
            "recent": pm.get("recent") or [],
        })
    return rows


def profile_windows(children: list[ChildScrape]) -> list[dict]:
    """One row per reachable child: its /profile window state machine
    (idle/armed/running/done/failed) and, when a window completed, the
    attribution + per-group table the child posted."""
    rows = []
    for c in children:
        if not c.reachable:
            continue
        prof = (c.status or {}).get("profile") or {}
        row = {
            "process": c.process,
            "supported": prof.get("supported", False),
            "state": prof.get("state", "idle"),
        }
        for k in ("steps", "error"):
            if prof.get(k) is not None:
                row[k] = prof[k]
        result = prof.get("result")
        if result is not None:
            row["result"] = result
        rows.append(row)
    return rows


def arm_fleet_profile(
    targets: TargetMap, steps, timeout_s: float = SCRAPE_TIMEOUT_S,
) -> dict:
    """Fan /profile?steps=N out to every child concurrently: a multi-process
    window is armed per process, and the step loops enter it in lockstep
    at the next agree-interval boundary. Per-child hard timeouts; a dead
    child is an entry in the response, never a hang."""
    steps = int(steps)  # the value is re-spliced into child URLs

    def arm_one(idx: int, host: str, port: int) -> tuple[int, dict]:
        try:
            doc = json.loads(_http_get(
                f"http://{host}:{port}/profile?steps={steps}", timeout_s
            ))
            return idx, {"armed": True, **doc}
        except Exception as e:  # noqa: BLE001 — refused/timeout expected
            return idx, {"armed": False, "error": str(e)}

    out: dict = {"steps": steps, "processes": {}}
    # serve replicas carry str keys; they answer the arm with their own
    # /profile document ("supported": false) like any other child
    items = sorted(targets.items(), key=lambda kv: str(kv[0]))
    if not items:
        return out
    with ThreadPoolExecutor(max_workers=min(len(items), 16)) as pool:
        futs = [
            pool.submit(arm_one, idx, host, port)
            for idx, (host, port) in items
        ]
        for f in futs:
            idx, doc = f.result()
            out["processes"][str(idx)] = doc
    out["armed"] = sum(
        1 for d in out["processes"].values() if d.get("armed")
    )
    return out


def fleet_status(
    children: list[ChildScrape], meta: Optional[dict] = None,
) -> dict:
    """The /fleet/status document."""
    table = straggler_table(children)
    slowest = None
    if table:
        worst = max(table, key=lambda r: r["excess_s"])
        if worst["excess_s"] > 0.0:
            slowest = {
                "process": worst["process"],
                "excess_s": worst["excess_s"],
                "excess_pct": worst["excess_pct"],
            }
    unreachable = [
        {"process": c.process, "target": f"{c.host}:{c.port}",
         "error": c.error}
        for c in children if not c.reachable
    ]
    doc = {
        "processes": {
            str(c.process): c.status for c in children if c.reachable
        },
        "reachable": sum(1 for c in children if c.reachable),
        "unreachable": unreachable,
        "healthy": bool(children) and not unreachable and all(
            (c.status or {}).get("healthy") for c in children if c.reachable
        ),
        "straggler_table": table,
        "slowest_process": slowest,
        "active_alarms": active_alarms(children),
        "profile_windows": profile_windows(children),
        "postmortems": fleet_postmortems(children),
    }
    if meta:
        doc.update(meta)
    return doc


def fleet_metric_values(
    children: list[ChildScrape],
) -> tuple[dict, dict]:
    """(per-process series, fleet-level extras) for
    `export.render_labeled_metrics`."""
    series = {
        str(c.process): c.values for c in children
        if c.reachable and c.values
    }
    table = straggler_table(children)
    extra = {
        "mgwfbp_fleet_processes": sum(1 for c in children if c.reachable),
        "mgwfbp_fleet_unreachable": sum(
            1 for c in children if not c.reachable
        ),
    }
    if table:
        extra["mgwfbp_fleet_straggler_excess_seconds"] = max(
            r["excess_s"] for r in table
        )
    return series, extra


def render_fleet_metrics(children: list[ChildScrape]) -> str:
    from mgwfbp_tpu_torch.telemetry.export import render_labeled_metrics

    series, extra = fleet_metric_values(children)
    return render_labeled_metrics(series, label="process", extra=extra)


def write_fleet_sd(
    path: str, targets: TargetMap, labels: Optional[dict] = None,
    roles: Optional[dict] = None,
) -> list[dict]:
    """Persist the scrape targets in Prometheus HTTP-SD / file-SD format
    (one target group per process, ``process`` + ``role`` labels each),
    atomically. A Prometheus `http_sd_configs`/`file_sd_configs` entry
    pointed at this file scrapes every child without guessing ports
    (README). ``roles`` maps a target key to its role label; targets not
    listed default to ``train``."""
    doc = [
        {
            "targets": [f"{host}:{port}"],
            "labels": {
                "job": "mgwfbp",
                "process": str(idx),
                "role": str((roles or {}).get(idx, "train")),
                **(labels or {}),
            },
        }
        for idx, (host, port) in sorted(
            targets.items(), key=lambda kv: str(kv[0])
        )
    ]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)
    return doc


class _FleetHandler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        from urllib.parse import parse_qs, urlsplit

        srv: FleetServer = self.server.fleet  # type: ignore[attr-defined]
        split = urlsplit(self.path)
        path = split.path.rstrip("/") or "/"
        try:
            if path == "/fleet/metrics":
                body = srv.render_metrics().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
                code = 200
            elif path == "/fleet/profile":
                query = parse_qs(split.query)
                code = 200
                if "steps" in query:
                    # validate HERE: the raw decoded value is re-spliced
                    # into every child URL, so garbage (or smuggled query
                    # params) must die at the fan-in, not fan out
                    try:
                        steps = int(query["steps"][-1])
                    except ValueError:
                        doc = {"error": "steps must be an integer"}
                        code = 400
                    else:
                        doc = srv.arm_profile(steps)
                else:
                    doc = {"profile_windows": srv.render_profile_windows()}
                body = (json.dumps(doc, indent=1) + "\n").encode()
                ctype = "application/json"
            elif path in ("/fleet/status", "/"):
                body = (
                    json.dumps(srv.render_status(), indent=1) + "\n"
                ).encode()
                ctype = "application/json"
                code = 200
            else:
                body = (
                    b"not found: serve /fleet/metrics, /fleet/status, "
                    b"/fleet/profile\n"
                )
                ctype = "text/plain; charset=utf-8"
                code = 404
        except Exception as e:  # noqa: BLE001 — a scrape bug must answer
            # 500, not kill the handler thread silently
            body = (f"fleet fan-in error: {e}\n").encode()
            ctype = "text/plain; charset=utf-8"
            code = 500
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass


class FleetServer:
    """Background HTTP fan-in over a live target map.

    ``targets_provider`` returns the CURRENT process->endpoint map on
    every request (the supervisor's port files resolve lazily as children
    bind), ``meta_provider`` optional supervisor-level fields for the
    status document. Scrapes run per request with hard per-child
    timeouts; no state is cached — the answer is always the live one."""

    def __init__(
        self,
        targets_provider: Callable[[], TargetMap],
        port: int = 0,
        host: Optional[str] = None,
        scrape_timeout_s: float = SCRAPE_TIMEOUT_S,
        meta_provider: Optional[Callable[[], dict]] = None,
    ):
        # loopback by default, same posture (and env override) as the
        # per-process TelemetryServer
        if host is None:
            from mgwfbp_tpu_torch.telemetry.serve import METRICS_HOST_ENV

            host = os.environ.get(METRICS_HOST_ENV) or "127.0.0.1"
        self._targets_provider = targets_provider
        self._meta_provider = meta_provider
        self.scrape_timeout_s = float(scrape_timeout_s)
        self._httpd = ThreadingHTTPServer((host, int(port)), _FleetHandler)
        self._httpd.daemon_threads = True
        self._httpd.fleet = self  # type: ignore[attr-defined]
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"mgwfbp-fleet:{self.port}",
            daemon=True,
        )
        self._thread.start()

    def _scrape(self) -> list[ChildScrape]:
        return scrape_fleet(
            self._targets_provider(), timeout_s=self.scrape_timeout_s
        )

    def render_metrics(self) -> str:
        return render_fleet_metrics(self._scrape())

    def render_status(self) -> dict:
        meta = self._meta_provider() if self._meta_provider else None
        return fleet_status(self._scrape(), meta=meta)

    def arm_profile(self, steps) -> dict:
        """Fan /profile?steps=N out to every currently-resolvable child
        (one call arms the whole group's lockstep window)."""
        return arm_fleet_profile(
            self._targets_provider(), steps, timeout_s=self.scrape_timeout_s
        )

    def render_profile_windows(self) -> list[dict]:
        return profile_windows(self._scrape())

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


def start_fleet_server(
    targets_provider: Callable[[], TargetMap],
    port: Optional[int],
    meta_provider: Optional[Callable[[], dict]] = None,
) -> Optional[FleetServer]:
    """FleetServer with the per-process server's degrade-don't-die
    contract: None when disabled (port None) or the bind fails."""
    if port is None:
        return None
    log = get_logger("mgwfbp.telemetry.fleet")
    try:
        server = FleetServer(
            targets_provider, int(port), meta_provider=meta_provider,
        )
    except OSError as e:
        log.warning(
            "fleet fan-in failed to bind port %s (%s); fleet "
            "observability disabled", port, e,
        )
        return None
    log.info(
        "fleet fan-in: http://%s:%d (/fleet/metrics /fleet/status)",
        server.host, server.port,
    )
    return server
