"""Process-group supervisor: launch, watch, resubmit, heal (counterpart of
``mgwfbp_tpu/runtime/supervisor.py``).

A preempted training process drains to a step-indexed checkpoint and exits
rc 75; this module relaunches it, for a local group of N coordinated
processes (one host; on a cluster each host runs its own ``train_cli``
under the scheduler and only the rc contract applies):

  rc 0   (all)   the run finished; exit 0.
  rc 75  (any)   a preemption drain: progress is checkpointed and the group
                 agreed to exit. Resubmit the whole group after a bounded
                 exponential backoff, until the restart budget is spent
                 (then exit 75).
  rc 86  (any)   a watchdog abort: a process found its step loop stalled,
                 dumped every thread's stack and exited. A wedged card does
                 not heal on restart: stop, and name the dumps.
  other  (any)   a hard failure. With healing on (the default), classify it
                 (``classify_rc``: crash, oom_kill, term), SIGTERM the
                 survivors so they drain (or end on their collective
                 timeout), and relaunch: at the same world when the slot
                 looks recoverable, shrunk to the survivors after a SIGKILL
                 (OOM-style; the elastic resume reads the last committed
                 step at the new world), under per-class budgets and a
                 same-step crash-loop detector. ``heal=False`` tears the
                 stragglers down (SIGTERM, grace, SIGKILL) and exits with
                 the failing rc.

Failures with no exit code: with ``MGWFBP_METRICS_PORT`` set, a liveness
monitor in the watch loop scrapes each child's /status (bounded timeout)
and calls a child wedged when its step stays frozen past
``MGWFBP_LIVENESS_GRACE_S`` (or it answers unhealthy that long), and
unreachable when a seen endpoint stops answering; either verdict SIGTERMs
the group and heals it. Every failure and heal decision is appended to the
supervisor's own stream ``<log_dir>/telemetry.supervisor.jsonl``
(process_index -1).

Each child gets MGWFBP_COORDINATOR, MGWFBP_NUM_PROCESSES,
MGWFBP_PROCESS_ID (read by ``parallel/mesh.resolve_launch_env``),
MGWFBP_INCARNATION (the fault plan's kill and wedge key on it),
MGWFBP_ELASTIC_RESUME=1 (unless set) and, with the live plane on, its own
MGWFBP_METRICS_PORT_FILE, where it writes the port it bound; the resolved
endpoints go to ``<log_dir>/fleet.json`` in Prometheus http_sd format.
Everything else (fault plans, device choices) is inherited.

``resize_to`` relaunches the next incarnation at another size; with the
live plane on, the supervisor drains the group itself (SIGTERM once a
child reports a step). Serving replicas (``serve_replicas``) live for the
supervisor's whole run, hot-reload the training group's checkpoints and
respawn under their own budget. ``fleet_port`` serves the live fan-in
(``telemetry/fleet.py``): /fleet/metrics, /fleet/status and /fleet/profile
over every child's live plane, for the supervisor's whole run (the targets
re-resolve per request, so a relaunched incarnation's new ports stay
reachable through the same URL).

``python -m mgwfbp_tpu_torch.runtime.supervise --processes 2 -- <train
args>`` is the CLI (``runtime/supervise.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request
from typing import Callable, Optional, Sequence

from mgwfbp_tpu_torch.utils.faults import PREEMPT_RC
from mgwfbp_tpu_torch.utils.logging import get_logger
from mgwfbp_tpu_torch.utils.platform import env_float
from mgwfbp_tpu_torch.utils.watchdog import WATCHDOG_RC

# how long a child's /status step may stay frozen (or its endpoint stay
# unreachable after it was seen) before the group is healed
LIVENESS_GRACE_ENV = "MGWFBP_LIVENESS_GRACE_S"
DEFAULT_LIVENESS_GRACE_S = 120.0

def classify_rc(rc: int) -> str:
    """One child returncode in the policy's words. Popen gives -N for a
    death by signal N; a shell's 128+N decodes the same way. SIGKILL is
    'oom_kill' (the kernel's OOM killer sends exactly that; an operator's
    SIGKILL heals the same way: the slot's memory is suspect, so the group
    shrinks); SIGTERM and SIGINT that never drained are 'term'."""
    if rc == 0:
        return "ok"
    if rc == PREEMPT_RC:
        return "preempt"
    if rc == WATCHDOG_RC:
        return "watchdog"
    sig = -rc if rc < 0 else (rc - 128 if 128 < rc < 160 else None)
    if sig == int(signal.SIGKILL):
        return "oom_kill"
    if sig in (int(signal.SIGTERM), int(signal.SIGINT)):
        return "term"
    return "crash"


class _LivenessTracker:
    """Per-child liveness state, fed one /status scrape (or None) per child
    per poll with an injected clock: 'running'; 'wedged' (its step froze
    past the grace after it had stepped, or it answered unhealthy that
    long); 'unreachable' (a seen endpoint stopped answering that long);
    'unknown' (never seen: still starting, which is the in-process
    watchdog's to judge)."""

    def __init__(self) -> None:
        self._step: dict[int, int] = {}
        self._step_t: dict[int, float] = {}
        self._seen: set[int] = set()
        self._unhealthy_t: dict[int, float] = {}
        self._unreachable_t: dict[int, float] = {}

    def observe(self, idx: int, status, now: float) -> None:
        if status is None:
            # only a child that has answered can become unreachable
            if idx in self._seen:
                self._unreachable_t.setdefault(idx, now)
            return
        self._seen.add(idx)
        self._unreachable_t.pop(idx, None)
        step = int(status.get("step") or 0)
        if step != self._step.get(idx):
            self._step[idx] = step
            self._step_t[idx] = now
        elif idx not in self._step_t:
            self._step_t[idx] = now
        if status.get("healthy") is False:
            self._unhealthy_t.setdefault(idx, now)
        else:
            self._unhealthy_t.pop(idx, None)

    def classify(self, idx: int, now: float, grace_s: float) -> str:
        if idx not in self._seen:
            return "unknown"
        t = self._unreachable_t.get(idx)
        if t is not None and now - t > grace_s:
            return "unreachable"
        t = self._unhealthy_t.get(idx)
        if t is not None and now - t > grace_s:
            return "wedged"
        # a frozen step counts only once the child has stepped: start-up
        # sits at step 0 for as long as it takes
        if (self._step.get(idx, 0) >= 1
                and now - self._step_t.get(idx, now) > grace_s):
            return "wedged"
        return "running"

    def max_step(self) -> int:
        """The highest step any child reported (the crash-loop detector's
        key: lives that keep dying at one step)."""
        return max(self._step.values(), default=0)


def free_port() -> int:
    """A port nothing listens on now (one per incarnation, so a new
    rendezvous never meets the last one's connections)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@dataclasses.dataclass
class GroupResult:
    """Outcome of one incarnation of the process group."""

    incarnation: int
    returncodes: list[int]

    @property
    def ok(self) -> bool:
        return all(rc == 0 for rc in self.returncodes)

    @property
    def preempted(self) -> bool:
        """Restart-friendly: at least one drain, nothing worse."""
        return (any(rc == PREEMPT_RC for rc in self.returncodes)
                and all(rc in (0, PREEMPT_RC) for rc in self.returncodes))

    @property
    def watchdog_abort(self) -> bool:
        return any(rc == WATCHDOG_RC for rc in self.returncodes)


class Supervisor:
    """Launch a coordinated N-process group and apply the rc policy.

    ``base_cmd`` is every child's command (default: this interpreter's
    ``train_cli``); the index, count and coordinator go into the child's
    environment, so one command line serves every slot and incarnation.
    ``sleep`` is injectable so the backoff is testable."""

    def __init__(
        self,
        base_cmd: Sequence[str],
        processes: int,
        *,
        max_restarts: int = 3,
        backoff_base_s: float = 1.0,
        backoff_max_s: float = 60.0,
        grace_s: float = 10.0,
        drain_grace_s: float = 120.0,
        log_dir: Optional[str] = None,
        env: Optional[dict] = None,
        port: Optional[int] = None,
        fleet_port: Optional[int] = None,
        fleet_file: Optional[str] = None,
        resize_to: Optional[int] = None,
        serve_replicas: int = 0,
        serve_cmd: Optional[Sequence[str]] = None,
        heal: bool = True,
        heal_max_restarts: int = 2,
        heal_same_step_limit: int = 3,
        liveness_grace_s: Optional[float] = None,
        serve_max_restarts: int = 3,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if processes < 1:
            raise ValueError(f"processes must be >= 1, got {processes}")
        if resize_to is not None and resize_to < 1:
            raise ValueError(f"resize_to must be >= 1, got {resize_to}")
        if serve_replicas < 0:
            raise ValueError(
                f"serve_replicas must be >= 0, got {serve_replicas}")
        if serve_replicas and not serve_cmd:
            raise ValueError("serve_replicas > 0 needs a serve_cmd")
        self.base_cmd = list(base_cmd)
        self.processes = int(processes)
        self.max_restarts = int(max_restarts)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.grace_s = float(grace_s)
        self.drain_grace_s = float(drain_grace_s)
        self.log_dir = log_dir
        self.env = dict(env if env is not None else os.environ)
        self.port = port
        self.sleep = sleep
        self.log = get_logger("mgwfbp.supervisor")
        self.results: list[GroupResult] = []
        # the last /status of each peer still alive when an rc-86 exit was
        # first seen (None: no abort seen this incarnation)
        self._status_snapshots: Optional[dict] = None
        # the live fan-in server's port (None: off, 0: ephemeral)
        self.fleet_port = fleet_port
        self.fleet_server = None
        self._fleet_file_explicit = fleet_file is not None
        self.fleet_file = fleet_file or (
            os.path.join(log_dir, "fleet.json") if log_dir else None)
        self._ports_dir: Optional[str] = None
        self._last_fleet_targets: Optional[dict] = None
        # resize by relaunch: the next incarnation runs at resize_to; with
        # the live plane on, the supervisor drains the group itself once a
        # child has stepped, else the resize waits for a preemption
        self.resize_to = resize_to
        self._initial_processes = int(processes)
        self._resize_signaled = False
        self._resize_poll_t = 0.0
        self._resize_no_metrics_warned = False
        # serving replicas: spawned once for the supervisor's run (they
        # hot-reload across incarnations), outside the rc policy (a dead
        # replica degrades serving, never the training job)
        self.serve_replicas = int(serve_replicas)
        self.serve_cmd = list(serve_cmd) if serve_cmd else None
        self._serve_procs: list = []
        self._serve_logs: list = []
        self._serve_exit_warned: set = set()
        self.serve_max_restarts = int(serve_max_restarts)
        self._serve_restarts: list[int] = []
        self._serve_respawn_at: dict[int, float] = {}
        # healing: hard failures relaunch (or shrink) the group under
        # per-class budgets; heal=False tears down and propagates
        self.heal = bool(heal)
        self.heal_max_restarts = int(heal_max_restarts)
        self.heal_same_step_limit = int(heal_same_step_limit)
        # garbage in the knob fails now, naming it, not mid-heal
        self.liveness_grace_s = (
            float(liveness_grace_s) if liveness_grace_s is not None
            else env_float(LIVENESS_GRACE_ENV, DEFAULT_LIVENESS_GRACE_S,
                           environ=self.env)
        )
        self._liveness = _LivenessTracker()
        self._liveness_poll_t = 0.0
        # the failure this incarnation dies of, set by the liveness monitor
        # (its SIGTERM makes every child exit 75, so the rc vector alone
        # would read as a plain preemption) or by a hard exit
        self._pending_failure: Optional[dict] = None
        # slot -> rc of the children that exited hard this incarnation,
        # captured before the teardown adds its own -15/-9
        self._failed_slots: dict[int, int] = {}
        self._heal_restarts: dict[str, int] = {}
        self._crash_steps: list[int] = []  # max step per healed life
        self._events = None  # the supervisor's stream, opened lazily

    # -- the live plane ------------------------------------------------------
    def _metrics_base_port(self) -> Optional[int]:
        """The group's metrics base port (child i serves base + i), or None
        when the plane is off or ephemeral (0)."""
        raw = (self.env.get("MGWFBP_METRICS_PORT") or "").strip()
        try:
            base = int(raw) if raw else None
        except ValueError:
            return None
        return base if base is not None and base > 0 else None

    def _metrics_enabled(self) -> bool:
        """True when the children's live plane is configured at all (an
        ephemeral 0 included)."""
        raw = (self.env.get("MGWFBP_METRICS_PORT") or "").strip()
        try:
            return bool(raw) and int(raw) >= 0
        except ValueError:
            return False

    def _port_file(self, idx: int, role: str = "train") -> str:
        """Child ``idx``'s port-file path (it writes its bound port there);
        serving replicas get ``metrics_port.serve<i>.json``."""
        if self._ports_dir is None:
            if self.log_dir:
                self._ports_dir = self.log_dir
                os.makedirs(self._ports_dir, exist_ok=True)
            else:
                self._ports_dir = tempfile.mkdtemp(prefix="mgwfbp_ports_")
        stem = f"serve{idx}" if role == "serve" else f"p{idx}"
        return os.path.join(self._ports_dir, f"metrics_port.{stem}.json")

    @staticmethod
    def _read_port_file(path: str) -> Optional[tuple[str, int]]:
        try:
            with open(path) as f:
                doc = json.load(f)
            return str(doc.get("host") or "127.0.0.1"), int(doc["port"])
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def _child_targets(self) -> dict:
        """Key -> (host, port) of every child endpoint that resolves now:
        the port file (the bound port; the only source for an ephemeral
        base), else base + index. Training children are keyed by index,
        replicas by ``serve<i>``."""
        if not self._metrics_enabled():
            return {}
        from mgwfbp_tpu_torch.telemetry.serve import resolve_metrics_port

        base = self._metrics_base_port()
        targets: dict = {}
        for i in range(self.processes):
            t = self._read_port_file(self._port_file(i))
            if t is None and base is not None:
                t = ("127.0.0.1", base + i)
            if t is not None:
                targets[i] = t
        for i in range(self.serve_replicas):
            t = self._read_port_file(self._port_file(i, role="serve"))
            if t is None and base is not None:
                t = ("127.0.0.1", resolve_metrics_port(base, i, role="serve"))
            if t is not None:
                targets[f"serve{i}"] = t
        return targets

    def _refresh_fleet(self) -> None:
        """Re-resolve the targets and rewrite ``fleet.json`` when they
        changed (children bind their ports as they start)."""
        if not self._metrics_enabled():
            return
        targets = self._child_targets()
        if targets == self._last_fleet_targets:
            return
        if self.fleet_file and targets:
            from mgwfbp_tpu_torch.telemetry.fleet import write_fleet_sd

            try:
                write_fleet_sd(self.fleet_file, targets, roles={
                    k: "serve" if isinstance(k, str) else "train"
                    for k in targets})
            except OSError as e:
                # leave the targets unrecorded so the write is retried
                self.log.warning("could not write fleet sidecar %s: %s",
                                 self.fleet_file, e)
                return
            self.log.info("fleet targets -> %s (%s)", self.fleet_file, ", ".join(
                f"{'' if isinstance(k, str) else 'p'}{k}={h}:{p}"
                for k, (h, p) in sorted(targets.items(),
                                        key=lambda kv: str(kv[0]))))
        self._last_fleet_targets = dict(targets)

    def _fleet_meta(self) -> dict:
        """Supervisor-level fields of /fleet/status."""
        meta = {
            "incarnation": len(self.results),
            "processes_configured": self.processes,
            "heal": {
                "enabled": self.heal,
                "restarts": dict(self._heal_restarts),
                "budget": self.heal_max_restarts,
                "liveness_grace_s": self.liveness_grace_s,
            },
        }
        if self._pending_failure is not None:
            meta["heal"]["pending_failure"] = dict(self._pending_failure)
        if self.serve_replicas:
            meta["serving"] = {
                "replicas": self.serve_replicas,
                "alive": sum(1 for p in self._serve_procs
                             if p is not None and p.poll() is None),
                "restarts": list(self._serve_restarts),
                "restart_budget": self.serve_max_restarts,
            }
        if self.resize_to is not None:
            meta["resize"] = {
                "from": self._initial_processes,
                "to": self.resize_to,
                "state": ("done" if self.processes == self.resize_to
                          else "pending"),
                "triggered": bool(self._resize_signaled),
            }
        return meta

    def _start_fleet_server(self) -> None:
        """One fan-in server for the supervisor's lifetime; it needs the
        children's live plane (``MGWFBP_METRICS_PORT``)."""
        if self.fleet_port is None or self.fleet_server is not None:
            return
        if not self._metrics_enabled():
            self.log.warning(
                "fleet fan-in requested but MGWFBP_METRICS_PORT is not set "
                "for the children; /fleet endpoints disabled")
            return
        from mgwfbp_tpu_torch.telemetry.fleet import start_fleet_server

        self.fleet_server = start_fleet_server(
            self._child_targets, self.fleet_port,
            meta_provider=self._fleet_meta,
        )

    def _emit(self, event: str, **fields) -> None:
        """Append one record to ``<log_dir>/telemetry.supervisor.jsonl``
        (process_index -1: nobody's training rank; outside
        ``find_stream_paths``' pattern, so a run's merge reads it only when
        asked). Best effort: telemetry never kills the healer."""
        if not self.log_dir:
            return
        try:
            if self._events is None:
                from mgwfbp_tpu_torch.telemetry.events import EventWriter

                os.makedirs(self.log_dir, exist_ok=True)
                self._events = EventWriter(
                    os.path.join(self.log_dir, "telemetry.supervisor.jsonl"),
                    run={"process_index": -1, "role": "supervisor"},
                )
            self._events.emit(event, **fields)
        except Exception as e:  # noqa: BLE001 — observability best effort
            self.log.warning("could not emit %s telemetry event: %s",
                             event, e)

    def _resize_pending(self) -> bool:
        return self.resize_to is not None and self.resize_to != self.processes

    @staticmethod
    def _signal_all(procs, sig=signal.SIGTERM) -> None:
        for p in procs:
            if p.poll() is None:
                try:
                    p.send_signal(sig)
                except OSError:
                    pass

    def _maybe_trigger_resize(self, procs) -> None:
        """``resize_to`` with a healthy group: SIGTERM the group once a
        child reports a completed step over /status (its signal handlers
        are armed by then; an earlier signal would kill it mid-start-up
        instead of draining it). Without the live plane the resize waits
        for the next preemption."""
        if not self._resize_pending() or self._resize_signaled:
            return
        if not self._metrics_enabled():
            if not self._resize_no_metrics_warned:
                self._resize_no_metrics_warned = True
                self.log.warning(
                    "--resize-to %d: MGWFBP_METRICS_PORT is not set, so the "
                    "supervisor cannot see training progress to time the "
                    "drain; the resize applies at the next preemption "
                    "(rc 75)", self.resize_to)
            return
        now = time.monotonic()
        if now - self._resize_poll_t < 0.5:  # throttle the scrapes
            return
        self._resize_poll_t = now
        for i in range(self.processes):
            st = self._child_status(i)
            if st and int(st.get("step") or 0) >= 1:
                self.log.warning(
                    "resize %d -> %d: draining the group (SIGTERM; the "
                    "agreed-preempt path checkpoints and exits rc 75)",
                    self.processes, self.resize_to)
                self._resize_signaled = True
                self._signal_all(procs)
                return

    def _child_status(self, idx, timeout_s: float = 2.0):
        """Child ``idx``'s /status, or None (plane off, child gone, or no
        answer within ``timeout_s``: a hung child never hangs the
        supervisor)."""
        target = self._child_targets().get(idx)
        if target is None:
            return None
        host, port = target
        try:
            with urllib.request.urlopen(f"http://{host}:{port}/status",
                                        timeout=timeout_s) as resp:
                return json.loads(resp.read().decode())
        except Exception:  # noqa: BLE001 — a dead child's port refusing
            # is the expected case
            return None

    def _child_env(self, idx: int, port: int, incarnation: int = 0) -> dict:
        env = dict(self.env)
        env["MGWFBP_COORDINATOR"] = f"127.0.0.1:{port}"
        env["MGWFBP_NUM_PROCESSES"] = str(self.processes)
        env["MGWFBP_PROCESS_ID"] = str(idx)
        # which life this is: kill and wedge faults fire in one incarnation
        # only (a healed relaunch resumes below their step)
        env["MGWFBP_INCARNATION"] = str(incarnation)
        # a relaunch at another size finds the old world's checkpoints
        # under its sibling tag; an operator's value wins
        env.setdefault("MGWFBP_ELASTIC_RESUME", "1")
        if self._metrics_enabled():
            env["MGWFBP_METRICS_PORT_FILE"] = self._port_file(idx)
            if self._fleet_armed():
                env.setdefault("MGWFBP_METRICS_HOST", "0.0.0.0")
        return env

    def _spawn(self, idx: int, incarnation: int, port: int):
        stdout = stderr = None
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            stdout = open(os.path.join(self.log_dir,
                                       f"p{idx}.i{incarnation}.log"),
                          "w", buffering=1)
            stderr = subprocess.STDOUT
        return subprocess.Popen(
            self.base_cmd, env=self._child_env(idx, port, incarnation),
            stdout=stdout, stderr=stderr,
        ), stdout

    # -- serving replicas ----------------------------------------------------
    def _serve_env(self, idx: int) -> dict:
        """A replica is not a member of the training group: no
        coordinator contract (an inherited one is dropped), its replica
        index and its own port file."""
        env = dict(self.env)
        for k in ("MGWFBP_COORDINATOR", "MGWFBP_NUM_PROCESSES",
                  "MGWFBP_PROCESS_ID"):
            env.pop(k, None)
        env["MGWFBP_SERVE_REPLICA"] = str(idx)
        if self._metrics_enabled():
            env["MGWFBP_METRICS_PORT_FILE"] = self._port_file(idx,
                                                              role="serve")
            if self._fleet_armed():
                env.setdefault("MGWFBP_METRICS_HOST", "0.0.0.0")
        return env

    def _fleet_armed(self) -> bool:
        """True with the fleet plane armed (a fan-in server, or a fleet.json
        named by the caller for an external Prometheus): the children then
        default to a routable bind (``MGWFBP_METRICS_HOST=0.0.0.0``), which
        off-host consumers can reach, and their port files advertise the
        routable address. A plain supervised run keeps the loopback default,
        since the endpoints are unauthenticated; an operator's value wins."""
        return self.fleet_port is not None or self._fleet_file_explicit

    def _spawn_serve(self, i: int) -> None:
        """(Re)spawn replica ``i`` into slot ``i``; its log is appended to,
        so a respawn's output follows its previous life's."""
        if self._metrics_enabled():
            try:
                os.unlink(self._port_file(i, role="serve"))
            except OSError:
                pass
        stdout = stderr = None
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            stdout = open(os.path.join(self.log_dir, f"serve{i}.log"), "a",
                          buffering=1)
            stderr = subprocess.STDOUT
        proc = subprocess.Popen(self.serve_cmd, env=self._serve_env(i),
                                stdout=stdout, stderr=stderr)
        if i < len(self._serve_procs):
            old = self._serve_logs[i]
            if old is not None:
                old.close()
            self._serve_procs[i] = proc
            self._serve_logs[i] = stdout
        else:
            self._serve_procs.append(proc)
            self._serve_logs.append(stdout)

    def _start_serve_replicas(self) -> None:
        if not self.serve_replicas or self._serve_procs:
            return
        self._serve_restarts = [0] * self.serve_replicas
        for i in range(self.serve_replicas):
            self._spawn_serve(i)

    def _reap_serve_replicas(self, now: Optional[float] = None) -> None:
        """A dead replica respawns after a bounded exponential backoff,
        under the replicas' own budget; once it is spent the slot stays
        down (warned once)."""
        if now is None:
            now = time.monotonic()
        for i, p in enumerate(self._serve_procs):
            if p.poll() is None:
                self._serve_respawn_at.pop(i, None)
                continue
            used = self._serve_restarts[i]
            if used >= self.serve_max_restarts:
                if i not in self._serve_exit_warned:
                    self._serve_exit_warned.add(i)
                    self.log.warning(
                        "serve replica %d exited rc %d and its restart "
                        "budget (%d) is spent; the replica stays down "
                        "(training continues%s)", i, p.returncode,
                        self.serve_max_restarts,
                        f" — see {self.log_dir}/serve{i}.log"
                        if self.log_dir else "")
                continue
            due = self._serve_respawn_at.get(i)
            if due is None:
                self._emit("failure", **{"class": classify_rc(p.returncode)},
                           target=f"serve{i}", rc=int(p.returncode))
                delay = self.backoff_s(used + 1)
                self._serve_respawn_at[i] = now + delay
                self.log.warning(
                    "serve replica %d exited rc %d; respawning in %.1fs "
                    "(restart %d/%d)", i, p.returncode, delay, used + 1,
                    self.serve_max_restarts)
                continue
            if now >= due:
                self._serve_respawn_at.pop(i, None)
                self._serve_restarts[i] += 1
                self._spawn_serve(i)
                self._emit("heal", action="respawn_serve", target=f"serve{i}",
                           restarts=self._serve_restarts[i])
                self.log.info("serve replica %d respawned (restart %d/%d)",
                              i, self._serve_restarts[i],
                              self.serve_max_restarts)

    def _stop_serve_replicas(self) -> None:
        if self._serve_procs:
            self._teardown(self._serve_procs)
        for f in self._serve_logs:
            if f is not None:
                f.close()
        self._serve_procs = []
        self._serve_logs = []

    # -- one incarnation -----------------------------------------------------
    def _run_group(self, incarnation: int) -> GroupResult:
        # fresh failure and liveness state per incarnation (the last one's
        # verdicts were consumed by the policy)
        self._status_snapshots = None
        self._failed_slots = {}
        self._pending_failure = None
        self._liveness = _LivenessTracker()
        self._liveness_poll_t = 0.0
        port = self.port if self.port is not None else free_port()
        self.log.info("incarnation %d: launching %d process(es) "
                      "(coordinator 127.0.0.1:%d)", incarnation,
                      self.processes, port)
        if self._metrics_enabled():
            # the last incarnation's port files name dead (possibly
            # ephemeral) ports
            for i in range(self.processes):
                try:
                    os.unlink(self._port_file(i))
                except OSError:
                    pass
            self._last_fleet_targets = None
            self._start_fleet_server()
        base = self._metrics_base_port()
        if base is not None:
            for i in range(self.processes):
                self.log.info("incarnation %d: process %d at "
                              "http://127.0.0.1:%d (/healthz /status)",
                              incarnation, i, base + i)
        procs, logs = [], []
        for i in range(self.processes):
            p, f = self._spawn(i, incarnation, port)
            procs.append(p)
            logs.append(f)
        try:
            rcs = self._watch(procs)
        finally:
            for f in logs:
                if f is not None:
                    f.close()
        result = GroupResult(incarnation, rcs)
        self.results.append(result)
        self.log.info("incarnation %d: exit codes %s", incarnation, rcs)
        return result

    def _capture_snapshots(self, procs) -> None:
        """The last /status of every peer still alive, taken when a hard or
        watchdog exit is first seen (by the time the policy runs, every
        child is gone and its port refuses)."""
        if self._status_snapshots is not None:
            return
        self._status_snapshots = {
            i: s for i, p in enumerate(procs)
            if p.poll() is None and (s := self._child_status(i)) is not None
        }

    def _poll_liveness(self, procs) -> None:
        """The wedge and unreachable detector: feed every alive child's
        /status into the tracker; a wedged or unreachable verdict marks the
        incarnation's failure and SIGTERMs the group (the survivors drain,
        and the policy heals). The verdict names every frozen child: a
        wedged peer freezes the others at the next collective within the
        same grace, so the step signal cannot tell which one froze
        first."""
        if (not self.heal or self._pending_failure is not None
                or self._failed_slots or not self._metrics_enabled()):
            return
        now = time.monotonic()
        if now - self._liveness_poll_t < 1.0:  # throttle the scrapes
            return
        self._liveness_poll_t = now
        culprits: list[tuple[int, str, int]] = []
        for i, p in enumerate(procs):
            if p.poll() is not None:
                continue
            self._liveness.observe(i, self._child_status(i), now)
            verdict = self._liveness.classify(i, now, self.liveness_grace_s)
            if verdict in ("wedged", "unreachable"):
                culprits.append((i, verdict, self._liveness._step.get(i, 0)))
        if not culprits:
            return
        cls = culprits[0][1]
        target = ",".join(f"p{i}" for i, _, _ in culprits)
        step = max(s for _, _, s in culprits)
        self._pending_failure = {"class": cls, "target": target,
                                 "step": step}
        self.log.warning(
            "%s is %s (step frozen at %d past %.0fs liveness grace); "
            "SIGTERMing the group to drain and heal", target, cls, step,
            self.liveness_grace_s)
        self._emit("failure", **{"class": cls}, target=target, step=step)
        self._capture_snapshots(procs)
        self._signal_all(procs)

    def _watch(self, procs) -> list[int]:
        """Poll until every child exits. Once any child exits, the others
        get a bounded window before teardown: a member that outlives its
        peers is blocked in a collective that can never complete, and
        waiting for it would hang the supervisor as the job hangs."""
        deadline = None  # armed on the first exit of any kind
        grace = None
        while True:
            self._refresh_fleet()
            self._reap_serve_replicas()
            self._maybe_trigger_resize(procs)
            self._poll_liveness(procs)
            pending = [p for p in procs if p.poll() is None]
            done = [p.returncode for p in procs if p.returncode is not None]
            if WATCHDOG_RC in done and self._status_snapshots is None:
                self._capture_snapshots(procs)
            hard = {i: int(p.returncode) for i, p in enumerate(procs)
                    if p.returncode is not None
                    and p.returncode not in (0, PREEMPT_RC, WATCHDOG_RC)}
            if (self.heal and hard and not self._failed_slots
                    and WATCHDOG_RC not in done):
                # record the failed slots now, and SIGTERM the survivors:
                # blocked in a collective their dead peer never joins, they
                # drain or end on their collective timeout
                self._failed_slots = dict(hard)
                self._capture_snapshots(procs)
                for i, rc in sorted(hard.items()):
                    cls = classify_rc(rc)
                    self.log.warning(
                        "process %d exited HARD (rc %d, class %s); "
                        "SIGTERMing survivors to drain for healing", i, rc,
                        cls)
                    self._emit("failure", **{"class": cls}, target=f"p{i}",
                               rc=rc, step=self._liveness.max_step())
                self._signal_all(procs)
            if not pending:
                return [int(p.returncode) for p in procs]
            if done and deadline is None:
                # after a drain or a clean exit, or a hard exit while
                # healing (survivors ride out their timeout), the peers get
                # the drain window; anything else the short fuse
                clean = all(rc in (0, PREEMPT_RC) for rc in done)
                grace = (self.drain_grace_s
                         if clean or (self.heal and self._failed_slots)
                         else self.grace_s)
                deadline = time.monotonic() + grace
            if deadline is not None and time.monotonic() > deadline:
                self.log.warning("tearing down %d straggler(s) %.0fs after "
                                 "the first exit", len(pending), grace)
                self._teardown(pending)
                return [int(p.returncode) if p.returncode is not None else -9
                        for p in procs]
            time.sleep(0.05)

    def _teardown(self, procs) -> None:
        self._signal_all(procs)
        t0 = time.monotonic()
        while any(p.poll() is None for p in procs):
            if time.monotonic() - t0 > self.grace_s:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                for p in procs:
                    p.wait()
                return
            time.sleep(0.05)

    # -- policy --------------------------------------------------------------
    def backoff_s(self, restart: int) -> float:
        """Bounded exponential: base * 2^(restart-1), capped."""
        return min(self.backoff_base_s * (2.0 ** max(restart - 1, 0)),
                   self.backoff_max_s)

    def run(self) -> int:
        try:
            self._start_serve_replicas()
            return self._run_policy()
        finally:
            self._stop_serve_replicas()
            if self.fleet_server is not None:
                self.fleet_server.close()
                self.fleet_server = None
            if self._events is not None:
                self._events.close()
                self._events = None

    def _heal_exit_rc(self) -> int:
        """The rc a stopped heal propagates: the failed child's positive
        rc, 128+signal for a death by signal, 1 for a wedge (the monitor's
        SIGTERM left no child rc of its own)."""
        rcs = sorted(self._failed_slots.values())
        pos = [rc for rc in rcs if rc > 0]
        if pos:
            return pos[0]
        neg = [rc for rc in rcs if rc < 0]
        if neg:
            return 128 + abs(neg[0])
        return 1

    def _heal_or_stop(self, result: GroupResult) -> Optional[int]:
        """The healing policy for one hard-failed incarnation: None when
        the group is to be relaunched, else the rc to exit with.

          oom_kill       -> shrink to the survivor count
          crash / term   -> relaunch at the same world
          wedged /
          unreachable    -> relaunch at the same world
          any class      -> bounded by its own budget (heal_max_restarts)
                            and by the crash-loop detector (the same max
                            step in heal_same_step_limit lives in a row)
        """
        if self._pending_failure is not None:
            cls = str(self._pending_failure["class"])
            target = str(self._pending_failure["target"])
        else:
            idx = min(self._failed_slots)
            cls = classify_rc(self._failed_slots[idx])
            target = f"p{idx}"
        step = self._liveness.max_step()
        self._crash_steps.append(step)
        tail = self._crash_steps[-self.heal_same_step_limit:]
        if len(tail) >= self.heal_same_step_limit and len(set(tail)) == 1:
            self.log.error(
                "crash loop: %d consecutive incarnation(s) died at step %d "
                "(last failure: %s on %s): the fault is deterministic and "
                "healing cannot fix it; stopping (child logs under %s)",
                len(tail), step, cls, target, self.log_dir or "stderr")
            self._emit("heal", action="stop", reason="crash_loop",
                       **{"class": cls}, target=target, step=step)
            return self._heal_exit_rc()
        used = self._heal_restarts.get(cls, 0)
        if used >= self.heal_max_restarts:
            self.log.error("%s on %s but the %r heal budget (%d) is spent; "
                           "stopping", cls, target, cls,
                           self.heal_max_restarts)
            self._emit("heal", action="stop", reason="budget",
                       **{"class": cls}, target=target, restarts=used)
            return self._heal_exit_rc()
        self._heal_restarts[cls] = used + 1
        survivors = self.processes - len(self._failed_slots)
        shrink = cls == "oom_kill" and 1 <= survivors < self.processes
        delay = self.backoff_s(self._heal_restarts[cls])
        if shrink:
            self.log.warning(
                "healing %s on %s: SHRINKING %d -> %d process(es) (elastic "
                "resume from the last committed step) in %.1fs (%s heal "
                "%d/%d)", cls, target, self.processes, survivors, delay, cls,
                self._heal_restarts[cls], self.heal_max_restarts)
            self._emit("heal", action="shrink", **{"class": cls},
                       target=target, old_world=self.processes,
                       world=survivors, restarts=self._heal_restarts[cls])
            self.processes = survivors
        else:
            self.log.warning(
                "healing %s on %s: relaunching at the same world (%d) in "
                "%.1fs (%s heal %d/%d)", cls, target, self.processes, delay,
                cls, self._heal_restarts[cls], self.heal_max_restarts)
            self._emit("heal", action="relaunch", **{"class": cls},
                       target=target, world=self.processes,
                       restarts=self._heal_restarts[cls])
        self.sleep(delay)
        return None

    def _run_policy(self) -> int:
        restarts = 0
        incarnation = 0
        while True:
            result = self._run_group(incarnation)
            if result.ok:
                if restarts or incarnation:
                    self.log.info("group completed after %d "
                                  "relaunch(es)", incarnation)
                return 0
            if result.watchdog_abort:
                where = (f" (per-process logs under {self.log_dir})"
                         if self.log_dir else " (see the group's stderr)")
                snapshots = self._status_snapshots or {}
                detail = ""
                if snapshots:
                    detail = " Last /status snapshot(s): " + "; ".join(
                        f"p{i}: {json.dumps(s)}"
                        for i, s in sorted(snapshots.items()))
                self.log.error(
                    "watchdog abort (rc %d): a process dumped all thread "
                    "stacks before exiting%s. A wedged card does not heal "
                    "on restart: NOT resubmitting.%s", WATCHDOG_RC, where,
                    detail)
                return WATCHDOG_RC
            # a hard failure this incarnation (a hard exit, or a liveness
            # verdict whose SIGTERM made the rcs read as a preemption)
            # takes the healing policy, not the free resubmit below
            if self.heal and (self._pending_failure is not None
                              or self._failed_slots):
                rc = self._heal_or_stop(result)
                if rc is not None:
                    return rc
                incarnation += 1
                continue
            if not result.preempted:
                bad = [rc for rc in result.returncodes
                       if rc not in (0, PREEMPT_RC)]
                self.log.error("group failed (exit codes %s); stragglers "
                               "torn down, not resubmitting",
                               result.returncodes)
                # a child's own rc over a torn-down straggler's signal; a
                # group dead by signals only gives 128+signal
                pos = [rc for rc in bad if rc > 0]
                if pos:
                    return pos[0]
                return 128 + abs(bad[0]) if bad else 1
            if self._resize_pending():
                # a resize is not a failure: it neither spends nor is
                # blocked by the restart budget
                self.log.warning(
                    "elastic resize: relaunching the group at %d process(es) "
                    "(was %d); the run continues from the drained step",
                    self.resize_to, self.processes)
                self.processes = int(self.resize_to)
                delay = self.backoff_base_s
            else:
                if restarts >= self.max_restarts:
                    self.log.error(
                        "preempted again but the restart budget (%d) is "
                        "spent; progress is checkpointed: resubmit by hand "
                        "or raise --max-restarts", self.max_restarts)
                    return PREEMPT_RC
                restarts += 1
                delay = self.backoff_s(restarts)
            self.log.warning(
                "group preempted (rc %d): resubmitting in %.1fs (restart "
                "%d/%d); the relaunch resumes from the drained checkpoint",
                PREEMPT_RC, delay, restarts, self.max_restarts)
            self.sleep(delay)
            incarnation += 1


def default_train_cmd(train_args: Sequence[str]) -> list[str]:
    """A training child: this interpreter, the port's launcher, the user's
    arguments verbatim."""
    return [sys.executable, "-m", "mgwfbp_tpu_torch.train_cli", *train_args]


def default_serve_cmd(serve_args: Sequence[str]) -> list[str]:
    """A serving replica: the standalone serving CLI; its index rides in
    MGWFBP_SERVE_REPLICA."""
    return [sys.executable, "-m", "mgwfbp_tpu_torch.serving", *serve_args]
