"""Structured run-observability event stream (a copy of
``mgwfbp_tpu/telemetry/events.py``).

An append-only, schema-versioned JSONL stream of typed records: line 1 is
a ``header`` carrying ``schema_version``, every following line one event::

    {"event": "step", "wall": 1722760000.1, "step": 12, "epoch": 0,
     "start_s": 3.41, "dur_s": 0.021}

The schema, the file names and the reader are the JAX package's, so the
port's ``python -m mgwfbp_tpu_torch.tools.telemetry_report`` and
``python -m mgwfbp_tpu_torch.tools.telemetry_merge`` (and the JAX
package's ``tools/`` scripts of the same names) read the port's streams. The port's trainer writes ``header``,
``step``, ``epoch``, ``overlap``, ``comm_group``, the resilience records
(``checkpoint``, ``preempt``, ``resume``, ``bad_step``, ``rollback``),
``resize``, ``watchdog_stall``, ``failure``, the live plane's
``drift_alarm``, ``straggler`` and ``profile``, the health records
(``health``, ``health_alarm``), the flight recorder's ``postmortem`` and
the ``scalar`` view, and the autotuner's ``autotune_race`` (one per raced
candidate) and ``autotune_commit``; the supervisor writes ``failure`` and
``heal`` to its own stream; the serving plane writes ``reload``,
``serve_stats`` and ``shadow_eval``; the bench writes ``bench_skip``. Every
JAX kind has a writer.

The writer never touches the device: ``emit`` rejects any field that is not
plain JSON data, a ``torch.Tensor`` included (serialising one would force a
device synchronisation), with ``TypeError``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from mgwfbp_tpu_torch.parallel.costmodel import check_schema_version

# 1 = the legacy headerless scalar JSONL (``read_events`` migrates it to
# ``scalar`` records); 2 = the typed stream
EVENT_SCHEMA_VERSION = 2
_LEGACY_SCALAR_VERSION = 1

# event name -> required fields (beyond "event"/"wall"); extra fields are
# allowed. The JAX package's full table: a reader may meet any of them.
EVENT_TYPES: dict[str, tuple[str, ...]] = {
    "header": ("schema_version",),
    # one optimizer step: host wall-clock span, start_s relative to the
    # stream's header
    "step": ("step", "epoch", "start_s", "dur_s"),
    # one merge group's comm span in the replayed step timeline
    # (telemetry.overlap)
    "comm_group": ("step", "group", "nbytes", "comm_s", "start_s",
                   "hidden_s", "exposed_s", "attribution"),
    # the aggregate overlap-efficiency snapshot of an epoch
    "overlap": ("step", "epoch", "step_s", "tb_total_s", "comm_s",
                "hidden_s", "exposed_s", "efficiency", "attribution"),
    "scalar": ("tag", "value", "step"),
    "epoch": ("epoch", "steps", "dur_s"),
    "autotune_race": ("label", "comm_op", "num_groups", "verified",
                      "measured_step_s"),
    "autotune_commit": ("winner", "comm_op", "num_groups", "source"),
    "resize": ("old_world", "new_world", "schedule_source", "num_groups"),
    "checkpoint": ("epoch", "iteration", "mid_epoch"),
    "watchdog_stall": ("phase", "idle_s", "timeout_s", "abort"),
    "bench_skip": ("detail",),
    "preempt": ("signal", "epoch", "iteration"),
    "bad_step": ("step", "epoch", "nonfinite"),
    "rollback": ("bad_steps", "restored_iteration", "restored_epoch"),
    "resume": ("epoch", "iteration", "mid_epoch"),
    "drift_alarm": ("kind", "step", "residual", "band", "active"),
    "straggler": ("step", "slow_process", "excess_s", "step_s_max",
                  "step_s_min", "active"),
    "profile": ("step", "steps", "attribution"),
    "health": ("step", "epoch", "loss", "grad_norm", "update_ratio"),
    "health_alarm": ("kind", "step", "value", "band", "active"),
    "postmortem": ("trigger", "step", "path"),
    "reload": ("step", "lag_s", "duration_s"),
    "shadow_eval": ("step", "loss"),
    "serve_stats": ("requests", "queue_depth", "batch_fill"),
    "failure": ("class", "target"),
    "heal": ("action",),
}

_JSON_SCALARS = (str, int, float, bool, type(None))


def stream_filename(process_index: int = 0, process_count: int = 1) -> str:
    """``telemetry.jsonl`` for one process, ``telemetry.pN.jsonl`` for
    process N of a group (``mgwfbp_tpu_torch.tools.telemetry_merge`` joins
    them)."""
    if process_count <= 1:
        return "telemetry.jsonl"
    return f"telemetry.p{int(process_index)}.jsonl"


def find_stream_paths(directory: str) -> list[str]:
    """Active stream files under ``directory``, in process order. A
    ``telemetry.jsonl`` beside ``pN`` streams is a stale single-process run
    of the same tag and is left out."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for name in names:
        if name == "telemetry.jsonl":
            out.append((-1, name))
        elif name.startswith("telemetry.p") and name.endswith(".jsonl"):
            idx = name[len("telemetry.p"):-len(".jsonl")]
            if idx.isdigit():
                out.append((int(idx), name))
    multi = [e for e in out if e[0] >= 0]
    if multi:
        out = multi
    return [os.path.join(directory, n) for _, n in sorted(out)]


def _check_jsonable(value, key: str) -> None:
    """Reject anything that is not already host-side JSON data (a tensor
    would force a device synchronisation while serialising)."""
    if isinstance(value, _JSON_SCALARS):
        return
    if isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            _check_jsonable(v, f"{key}[{i}]")
        return
    if isinstance(value, dict):
        for k, v in value.items():
            _check_jsonable(v, f"{key}.{k}")
        return
    raise TypeError(
        f"telemetry field {key!r} is {type(value).__name__}, not plain JSON "
        "data; convert device values on a cold path first (telemetry must "
        "add no device synchronisation to the step loop)"
    )


def _rotated_segments(path: str) -> list[str]:
    """Rotated sibling files of an active stream, oldest first. Rotation
    renames the active file to ``<path>.NNNN``; they sort by that integer,
    not lexically."""
    d = os.path.dirname(path) or "."
    base = os.path.basename(path)
    out = []
    try:
        names = os.listdir(d)
    except OSError:
        return []
    for name in names:
        if not name.startswith(base + "."):
            continue
        suffix = name[len(base) + 1:]
        if suffix.isdigit():
            out.append((int(suffix), os.path.join(d, name)))
    return [p for _, p in sorted(out)]


def _next_segment_index(path: str) -> int:
    """The index the active stream at ``path`` rotates into next: one past
    the highest existing segment (not the count, which would clobber the
    newest surviving segment after older ones were deleted)."""
    segs = _rotated_segments(path)
    if not segs:
        return 0
    last = os.path.basename(segs[-1])
    return int(last.rsplit(".", 1)[1]) + 1


class EventWriter:
    """Append-only JSONL event stream of one process.

    Writes the versioned header when it creates (or first appends to an
    empty) file; re-opening an existing stream appends without a second
    header, its spans still relative to the original header's wall clock.
    Thread-safe; each record is one line-buffered write. ``observer``
    (``observer(event, fields)``, e.g. a live ``MetricsAggregator``'s
    ``observe``, or ``recorder.tee_observers`` of several) sees every
    record ``emit`` validates, before it is written; an observer that
    raises is logged and detached, never fatal.

    Size rotation: once the active file exceeds ``max_bytes`` (default
    from ``MGWFBP_TELEMETRY_MAX_MB``; unset or 0 never rotates) it is
    renamed to ``<path>.NNNN`` and a fresh segment opens. Every segment
    starts with its own header carrying the set's original wall anchor and
    a ``segment`` index, so ``read_event_set`` reassembles one timeline.
    """

    def __init__(self, path: str, run: Optional[dict] = None,
                 max_bytes: Optional[int] = None, observer=None):
        self.observer = observer
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if max_bytes is None:
            mb = os.environ.get("MGWFBP_TELEMETRY_MAX_MB", "").strip()
            max_bytes = int(float(mb) * 1024 * 1024) if mb else 0
        self.max_bytes = max(int(max_bytes), 0)
        self._run = dict(run or {})
        self._segment = _next_segment_index(path)
        fresh = not (os.path.exists(path) and os.path.getsize(path) > 0)
        header_wall = None
        if not fresh:
            try:
                with open(path) as f:
                    first = json.loads(f.readline())
                if first.get("event") == "header":
                    header_wall = float(first.get("wall", 0.0)) or None
                    self._run = dict(first.get("run", self._run) or {})
            except (OSError, ValueError):
                header_wall = None
        self._f = open(path, "a", buffering=1)
        self._bytes = 0 if fresh else os.path.getsize(path)
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._anchor_wall = header_wall if header_wall else time.time()
        if header_wall is not None:
            self._t0 -= max(time.time() - header_wall, 0.0)
        if fresh:
            self._emit_record(
                "header",
                wall=self._anchor_wall,
                schema_version=EVENT_SCHEMA_VERSION,
                run=self._run,
                segment=self._segment,
            )

    def now(self) -> float:
        """Seconds since the stream's header (span-timestamp base)."""
        return time.perf_counter() - self._t0

    def emit(self, event: str, **fields) -> None:
        """Append one typed record; an unknown event, a missing required
        field or a field that is not plain JSON data raises."""
        required = EVENT_TYPES.get(event)
        if required is None:
            raise ValueError(
                f"unknown telemetry event {event!r}; known: "
                f"{sorted(EVENT_TYPES)}"
            )
        missing = [k for k in required if k not in fields]
        if missing:
            raise ValueError(
                f"telemetry event {event!r} missing required field(s) "
                f"{missing}"
            )
        for k, v in fields.items():
            _check_jsonable(v, k)
        observer = self.observer
        if observer is not None:
            try:
                observer(event, fields)
            except Exception:  # noqa: BLE001 — observability must never
                # fail the run it observes; from here on the live surfaces
                # freeze while the file keeps advancing, so say so
                import logging

                logging.getLogger("mgwfbp.telemetry").exception(
                    "telemetry observer failed on %r; detaching it", event)
                self.observer = None
        self._emit_record(event, wall=time.time(), **fields)

    def _emit_record(self, event: str, wall: float, **fields) -> None:
        line = json.dumps({"event": event, "wall": round(wall, 3), **fields})
        line += "\n"
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line)
            self._bytes += len(line)
            if (self.max_bytes and self._bytes > self.max_bytes
                    and event != "header"):
                self._rotate_locked()

    def _rotate_locked(self) -> None:
        """Roll the active file to the next ``<path>.NNNN`` segment and
        start a fresh one (the caller holds the lock). A failed rename
        disables rotation rather than failing the run."""
        self._f.close()
        target = f"{self.path}.{self._segment:04d}"
        try:
            os.replace(self.path, target)
        except OSError:
            self.max_bytes = 0
            self._f = open(self.path, "a", buffering=1)
            return
        self._segment += 1
        self._f = open(self.path, "a", buffering=1)
        self._bytes = 0
        line = json.dumps({
            "event": "header",
            "wall": round(self._anchor_wall, 3),
            "schema_version": EVENT_SCHEMA_VERSION,
            "run": self._run,
            "segment": self._segment,
        }) + "\n"
        self._f.write(line)
        self._bytes += len(line)

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


def read_events(path: str) -> list[dict]:
    """Load a stream, header included, checking its schema version; a
    legacy headerless scalar stream is migrated to ``scalar`` records
    under a synthesized header."""
    rows: list[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    if not rows:
        return []
    first = rows[0]
    if first.get("event") == "header" or "schema_version" in first:
        check_schema_version(
            first, path=path, supported=(EVENT_SCHEMA_VERSION,),
            what="telemetry event stream",
        )
        return rows
    migrated = [{
        "event": "scalar",
        "wall": r.get("wall", 0.0),
        "tag": r.get("tag", ""),
        "value": r.get("value"),
        "step": r.get("step", 0),
    } for r in rows]
    header = {
        "event": "header",
        "wall": migrated[0].get("wall", 0.0),
        "schema_version": EVENT_SCHEMA_VERSION,
        "run": {"migrated_from": _LEGACY_SCALAR_VERSION},
    }
    return [header] + migrated


def read_event_set(path: str) -> list[dict]:
    """Load a possibly rotated stream: every ``<path>.NNNN`` segment in
    order, then the active file, each checked by ``read_events``; the first
    header is kept and the segments' continuation headers dropped, so the
    result reads as if rotation had never happened."""
    parts = _rotated_segments(path)
    if os.path.exists(path):
        parts = parts + [path]
    if not parts:
        raise FileNotFoundError(path)
    out: list[dict] = []
    for p in parts:
        for r in read_events(p):
            if r.get("event") == "header" and out:
                continue
            out.append(r)
    return out


def events_of(records: list[dict], *names: str) -> list[dict]:
    """The records of the given event types."""
    want = set(names)
    return [r for r in records if r.get("event") in want]
