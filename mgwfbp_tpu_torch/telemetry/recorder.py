"""Anomaly-triggered flight recorder: a bounded in-memory event ring that
dumps an atomic postmortem bundle when any alarm fires.

When a drift alarm, straggler, health alarm, bad step, or watchdog stall
fires, the evidence that explains it — the last N steps' full-cadence
events, the live /status snapshot, the committed schedule and cost-model
state — is gone unless someone was already tracing. This module keeps
that evidence on a leash:

  * ``FlightRecorder.observe`` tees off the validated EventWriter stream
    (the same observer hook the MetricsAggregator uses — one validated
    stream feeds the JSONL file, the live endpoints, AND the ring), so
    the ring always holds the last ``ring_size`` records at full cadence,
    whatever the operator's scrape interval was.
  * ANY trigger event (``drift_alarm``/``straggler``/``health_alarm``
    raise edges, ``bad_step``, ``watchdog_stall``) writes one atomic
    postmortem bundle under ``<dir>/postmortems/NNNN/``:

      events.jsonl    the ring-buffer dump (ring order, oldest first)
      status.json     the /status snapshot (when an aggregator is wired)
      schedule.json   the committed merge schedule + cost-model state
      manifest.json   trigger event/step/wall, ring stats, bundle index
      profile.json    (later) the auto-armed /profile window's per-group
                      attribution, appended when the window completes

    The bundle is staged in ``NNNN.tmp.<pid>`` and os.replace'd into
    place, so a reader never sees a half-written bundle.
  * A **debounce window** (``debounce_s``) plus a hard bundle cap
    (``max_bundles``) keeps an alarm storm from writing unbounded
    bundles: within the window, follow-up triggers are counted in the
    open bundle's manifest-side statistics, not dumped again.
  * With ``MGWFBP_POSTMORTEM_PROFILE=1`` a trigger also arms a bounded
    ``/profile`` trace window through the aggregator's existing state
    machine (the step loop consumes it at the next boundary); the
    resulting ``profile`` event is appended to the open bundle as
    ``profile.json`` — the deep-trace slice lands next to the events
    that explain why it was taken.

Env knobs: ``MGWFBP_POSTMORTEM`` (0 disables), ``MGWFBP_POSTMORTEM_RING``
(ring size, default 512 records), ``MGWFBP_POSTMORTEM_DEBOUNCE_S``
(default 30), ``MGWFBP_POSTMORTEM_MAX`` (default 16 bundles/run),
``MGWFBP_POSTMORTEM_PROFILE`` (1 arms the deep-trace window),
``MGWFBP_POSTMORTEM_PROFILE_STEPS`` (window length, default 3).

Everything here is host-side file I/O on already-host JSON data — the
observer runs inside `EventWriter.emit`, whose contract already rejects
device values, so the recorder can never add a device sync; and a
recorder failure detaches that observer, never the run (the EventWriter's
observer contract).
"""

from __future__ import annotations

import collections
import json
import os
import re
import threading
import time
from typing import Callable, Optional

from mgwfbp_tpu_torch.utils.logging import get_logger

_ENV_ENABLE = "MGWFBP_POSTMORTEM"
_ENV_RING = "MGWFBP_POSTMORTEM_RING"
_ENV_DEBOUNCE = "MGWFBP_POSTMORTEM_DEBOUNCE_S"
_ENV_MAX = "MGWFBP_POSTMORTEM_MAX"
_ENV_PROFILE = "MGWFBP_POSTMORTEM_PROFILE"
_ENV_PROFILE_STEPS = "MGWFBP_POSTMORTEM_PROFILE_STEPS"

DEFAULT_RING = 512
DEFAULT_DEBOUNCE_S = 30.0
DEFAULT_MAX_BUNDLES = 16
DEFAULT_PROFILE_STEPS = 3

# events that trip a postmortem dump; alarm-edge events trigger on their
# RAISE edge only (a clear edge is the system healing, not an anomaly)
TRIGGER_EVENTS = frozenset({
    "drift_alarm", "straggler", "health_alarm", "bad_step",
    "watchdog_stall",
})
_EDGE_EVENTS = frozenset({"drift_alarm", "straggler", "health_alarm"})


def recorder_enabled(environ=None) -> bool:
    return (environ or os.environ).get(_ENV_ENABLE, "1") != "0"


def _env_int(name: str, default: int) -> int:
    raw = (os.environ.get(name) or "").strip()
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer") from None


def tee_observers(*observers) -> Callable[[str, dict], None]:
    """Compose EventWriter observers (the writer holds ONE slot; the
    aggregator and the recorder both tee off it). A failing member is
    dropped — same detach-don't-die contract as the writer's own observer
    handling, applied per member so a broken recorder cannot freeze the
    live /metrics surface (or vice versa)."""
    live = [o for o in observers if o is not None]

    def observe(event: str, fields: dict) -> None:
        for o in tuple(live):
            try:
                o(event, fields)
            except Exception:  # noqa: BLE001 — observability must never
                # kill (or blind) the run it observes
                get_logger("mgwfbp.telemetry").exception(
                    "telemetry observer %r failed on %r; detaching it",
                    o, event,
                )
                try:
                    live.remove(o)
                except ValueError:
                    pass

    return observe


class FlightRecorder:
    """Bounded event ring + atomic postmortem bundles for one process.

    ``directory`` is the run's tag dir (bundles land under
    ``<directory>/postmortems/``). ``status_provider`` /
    ``schedule_provider`` return the live /status document and the
    committed schedule + cost-model state (wired by the trainer);
    ``profile_armer`` arms a bounded deep-trace window (the aggregator's
    `arm_profile`); ``event_sink`` emits the ``postmortem`` record back
    into the stream (the writer's own `emit` — safe: the recorder never
    re-triggers on it). Thread-safe: step loop and watchdog threads both
    emit."""

    def __init__(
        self,
        directory: str,
        ring_size: Optional[int] = None,
        debounce_s: Optional[float] = None,
        max_bundles: Optional[int] = None,
        status_provider: Optional[Callable[[], dict]] = None,
        schedule_provider: Optional[Callable[[], dict]] = None,
        profile_armer: Optional[Callable[[int], None]] = None,
        event_sink: Optional[Callable[..., None]] = None,
        suffix: str = "",
    ):
        # `suffix` disambiguates bundle names when several processes
        # share one tag dir (a multi-host group: each process records its
        # own ring) — ``NNNN.pK`` instead of two processes racing the
        # same ``NNNN`` rename
        if ring_size is None:
            ring_size = _env_int(_ENV_RING, DEFAULT_RING)
        if debounce_s is None:
            raw = (os.environ.get(_ENV_DEBOUNCE) or "").strip()
            debounce_s = float(raw) if raw else DEFAULT_DEBOUNCE_S
        if max_bundles is None:
            max_bundles = _env_int(_ENV_MAX, DEFAULT_MAX_BUNDLES)
        self.directory = os.path.join(directory, "postmortems")
        self.suffix = str(suffix)
        self.ring_size = max(int(ring_size), 1)
        self.debounce_s = max(float(debounce_s), 0.0)
        self.max_bundles = max(int(max_bundles), 0)
        self.status_provider = status_provider
        self.schedule_provider = schedule_provider
        self.profile_armer = profile_armer
        self.event_sink = event_sink
        self.profile_enabled = (
            os.environ.get(_ENV_PROFILE) == "1"
        )
        self.profile_steps = max(
            _env_int(_ENV_PROFILE_STEPS, DEFAULT_PROFILE_STEPS), 1
        )
        self.log = get_logger("mgwfbp.telemetry.recorder")
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=self.ring_size
        )
        # `postmortem` records waiting to be emitted into the stream:
        # emitting from inside the TRIGGER event's own observe would
        # write the postmortem row (and stamp its wall) BEFORE the
        # trigger record itself lands in the JSONL — the merged timeline
        # would show the bundle existing before its cause. Deferred
        # emissions flush at the next observe (any event), which on a
        # live run is at most one step away; `flush_events` covers
        # shutdown.
        self._pending_emits: list[dict] = []
        self._flushing = False
        self._seen = 0  # total records observed (ring stats)
        self._bundles: list[dict] = []  # written manifests, oldest first
        self._last_bundle_wall: Optional[float] = None
        self._suppressed = 0  # triggers swallowed by debounce/cap
        # when a trigger armed a profile window, the bundle dir its
        # `profile` event should be appended to (one outstanding at most)
        self._awaiting_profile: Optional[str] = None
        # resuming under the same tag continues the bundle sequence
        self._next_index = self._scan_existing()

    # -- the observer hook -------------------------------------------------
    def observe(self, event: str, fields: dict) -> None:
        """One validated telemetry record (the EventWriter tee)."""
        self.flush_events()
        rec = {"event": event, "wall": round(time.time(), 3), **fields}
        with self._lock:
            self._ring.append(rec)
            self._seen += 1
        if event == "profile":
            self._attach_profile(rec)
            return
        if event not in TRIGGER_EVENTS:
            return
        if event in _EDGE_EVENTS and not fields.get("active"):
            return  # clear edges heal, they don't trigger
        self._trigger(rec)

    def flush_events(self) -> None:
        """Emit any deferred `postmortem` records into the stream (called
        on every observe — so the record lands right after its trigger's
        row — and by the trainer at shutdown). Re-entrancy-guarded: the
        emit re-enters observe through the tee."""
        if self.event_sink is None:
            return
        with self._lock:
            if self._flushing or not self._pending_emits:
                return
            self._flushing = True
            pending, self._pending_emits = self._pending_emits, []
        try:
            for fields in pending:
                try:
                    self.event_sink("postmortem", **fields)
                except Exception as e:  # noqa: BLE001 — stream trouble
                    # must not take the recorder down
                    self.log.info("postmortem event emit failed (%s)", e)
        finally:
            with self._lock:
                self._flushing = False

    # -- bundles -----------------------------------------------------------
    def bundles(self) -> list[dict]:
        """Written bundle manifests, oldest first (the /postmortems
        document's source)."""
        with self._lock:
            return [dict(b) for b in self._bundles]

    @property
    def suppressed(self) -> int:
        with self._lock:
            return self._suppressed

    def _scan_existing(self) -> int:
        """Next bundle index: one past the highest NNNN already on disk
        FOR THIS RECORDER'S SUFFIX (a resume under the same tag must
        extend the sequence, not clobber the previous incarnation's
        bundles; another process's differently-suffixed bundles are not
        this sequence)."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return 0
        indices = []
        for n in names:
            if self.suffix:
                if not n.endswith(self.suffix):
                    continue
                n = n[: -len(self.suffix)]
            if n.isdigit():
                indices.append(int(n))
        return max(indices) + 1 if indices else 0

    def _trigger(self, rec: dict) -> None:
        now = time.time()
        with self._lock:
            if (
                self._last_bundle_wall is not None
                and now - self._last_bundle_wall < self.debounce_s
            ):
                self._suppressed += 1
                return
            if len(self._bundles) >= self.max_bundles:
                self._suppressed += 1  # hard cap per incarnation: an
                # alarm storm must never fill the disk with bundles
                return
            index = self._next_index
            self._next_index += 1
            self._last_bundle_wall = now
            ring = list(self._ring)
            seen = self._seen
            suppressed = self._suppressed
        manifest = self._write_bundle(
            index, rec, ring, seen, suppressed, now
        )
        if manifest is None:
            return
        with self._lock:
            self._bundles.append(manifest)
        if self.profile_enabled and self.profile_armer is not None:
            try:
                result = self.profile_armer(self.profile_steps)
                # the aggregator's arm_profile returns (http status, doc)
                # — a refused arm (409: a window is already armed/running
                # for someone else) must NOT claim that window's result
                # for this bundle
                armed = True
                if (
                    isinstance(result, tuple) and result
                    and isinstance(result[0], int)
                ):
                    armed = result[0] == 200
                if armed:
                    self._awaiting_profile = manifest["path"]
            except Exception as e:  # noqa: BLE001 — the window is an
                # attribution upgrade, never a gate
                self.log.info("postmortem profile arm failed (%s)", e)
        if self.event_sink is not None:
            # deferred: emitting here would land the record BEFORE the
            # trigger's own row (we are inside its observe); the next
            # observed event flushes it
            with self._lock:
                self._pending_emits.append({
                    "trigger": str(rec.get("event")),
                    "step": manifest["step"],
                    "path": manifest["path"],
                })
            if rec.get("event") == "watchdog_stall" and rec.get("abort"):
                # abort-bound stall: os._exit(86) follows this emit —
                # there will BE no next observe and trainer.close() never
                # runs. Flush NOW (accepting the one-row ordering
                # inversion) so the stream, /status, and the
                # supervisor's rc-86 stop message all name the stall's
                # own bundle, which is exactly the case the recorder
                # exists for.
                self.flush_events()

    def _write_bundle(
        self, index: int, trigger: dict, ring: list, seen: int,
        suppressed: int, wall: float,
    ) -> Optional[dict]:
        final = os.path.join(
            self.directory, f"{index:04d}{self.suffix}"
        )
        tmp = f"{final}.tmp.{os.getpid()}"
        # explicit missing-check: step 0 is a legitimate trigger step (a
        # NaN on the very first step), not the "no step" sentinel
        step = trigger.get("step")
        manifest = {
            "index": index,
            "wall": round(wall, 3),
            "trigger": str(trigger.get("event")),
            "step": int(step) if isinstance(step, (int, float)) else -1,
            "trigger_record": trigger,
            "ring_records": len(ring),
            "records_seen": seen,
            "ring_size": self.ring_size,
            "suppressed_before": suppressed,
            "path": final,
        }
        try:
            os.makedirs(tmp, exist_ok=True)
            with open(os.path.join(tmp, "events.jsonl"), "w") as f:
                for r in ring:
                    f.write(json.dumps(r) + "\n")
            status = None
            if self.status_provider is not None:
                try:
                    status = self.status_provider()
                except Exception as e:  # noqa: BLE001 — best-effort part
                    status = {"error": str(e)}
            with open(os.path.join(tmp, "status.json"), "w") as f:
                json.dump(status, f, indent=1)
            schedule = None
            if self.schedule_provider is not None:
                try:
                    schedule = self.schedule_provider()
                except Exception as e:  # noqa: BLE001
                    schedule = {"error": str(e)}
            with open(os.path.join(tmp, "schedule.json"), "w") as f:
                json.dump(schedule, f, indent=1)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)
            os.replace(tmp, final)
        except OSError as e:
            self.log.warning(
                "postmortem bundle %04d not written (%s)", index, e,
            )
            try:
                import shutil

                shutil.rmtree(tmp, ignore_errors=True)
            except Exception:  # noqa: BLE001 — cleanup is best-effort
                pass
            return None
        self.log.warning(
            "postmortem bundle written: %s (trigger %s at step %s, %d "
            "ring record(s))",
            final, manifest["trigger"], manifest["step"], len(ring),
        )
        return manifest

    def _attach_profile(self, rec: dict) -> None:
        """A /profile window completed; if a postmortem armed it, land
        the per-group attribution inside that bundle."""
        with self._lock:
            target = self._awaiting_profile
            self._awaiting_profile = None
        if target is None:
            return
        try:
            with open(os.path.join(target, "profile.json"), "w") as f:
                json.dump(rec, f, indent=1)
        except OSError as e:
            self.log.info(
                "postmortem profile attach failed (%s)", e,
            )
            return
        with self._lock:
            for b in self._bundles:
                if b.get("path") == target:
                    b["profile"] = True
        self.log.info(
            "postmortem profile attribution attached: %s/profile.json",
            target,
        )


def read_bundle(path: str) -> dict:
    """Load one postmortem bundle directory back into a dict (the report
    tooling's reader): manifest + status + schedule + the ring events
    (+ profile when the auto-armed window landed)."""
    out: dict = {"path": path}
    for name in ("manifest", "status", "schedule", "profile"):
        p = os.path.join(path, f"{name}.json")
        if os.path.exists(p):
            with open(p) as f:
                out[name] = json.load(f)
    events_path = os.path.join(path, "events.jsonl")
    if os.path.exists(events_path):
        with open(events_path) as f:
            out["events"] = [
                json.loads(line) for line in f if line.strip()
            ]
    return out


_BUNDLE_NAME = re.compile(r"^\d{4,}(\.p\d+)?$")


def list_bundles(directory: str) -> list[str]:
    """Bundle directories under ``<directory>/postmortems``, index order
    — single-process ``NNNN`` names and a multi-host group's ``NNNN.pK``
    names both list (half-written ``.tmp.`` stages never do: os.replace
    makes a listed bundle complete by construction)."""
    root = os.path.join(directory, "postmortems")
    try:
        names = os.listdir(root)
    except OSError:
        return []
    return [
        os.path.join(root, n)
        for n in sorted(names) if _BUNDLE_NAME.match(n)
    ]
