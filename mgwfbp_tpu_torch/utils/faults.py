"""Deterministic fault injection (counterpart of ``mgwfbp_tpu/utils/faults.py``).

A fault plan names which fault fires at which optimizer step, so every
handling path of the resilience layer (the skip-step guard and rollback,
the graceful preemption drain) runs in the CPU tests and on the card
instead of waiting for a real outage. The grammar, the parser, its errors
and the query semantics are the JAX package's, copied (this package does
not import that one)::

    plan  := spec (';' spec)*
    spec  := kind ('@' kv (',' kv)*)?
    kind  := 'nan' | 'stall' | 'preempt' | 'chip_unavailable' | 'kill' | 'wedge'
    kv    := key '=' value

    nan@step=N[,count=C]        NaN-fill the float inputs of optimizer steps
                                N..N+C-1 (1-indexed host iteration counter);
                                each step fires once, so a replay after a
                                rollback sees clean data
    stall@secs=S[,phase=P][,step=N]
                                sleep S seconds in phase P; ONCE
    preempt@step=N[,signal=SIGTERM|SIGINT]
                                deliver the signal after step N completes
                                (the graceful-drain path); ONCE, and only on
                                a live crossing of step N
    chip_unavailable            the bench reports the card as unavailable
    kill@step=N / wedge@step=N,secs=S
                                the supervisor's chaos faults

Every kind takes ``proc=I`` (fire on that process only); kill and wedge
take ``inc=K`` (supervisor incarnation).

The port's trainer consumes ``nan``, ``preempt``, ``stall`` (a sleep in
the train or eval phase, which the progress watchdog sees), ``kill`` (SIGKILL
of the process after the step: no drain, no flush) and ``wedge`` (the step
loop stops while the HTTP plane keeps serving, which the supervisor's
liveness monitor sees); ``chip_unavailable`` is the bench's, as in the JAX
package. The trainer keeps the specs of its process and, for ``kill`` and
``wedge``, of its supervisor incarnation (``MGWFBP_INCARNATION``).
"""

from __future__ import annotations

import dataclasses
import os
import signal
from typing import Optional

ENV_VAR = "MGWFBP_FAULT_PLAN"

# Exit code after a graceful preemption drain: EX_TEMPFAIL, the
# conventional "transient — try again" status, so a supervisor can tell
# "restart me, progress is checkpointed" from a real failure.
PREEMPT_RC = 75


class Preempted(RuntimeError):
    """A preemption signal (SIGTERM/SIGINT) was drained gracefully: the
    in-flight step finished, a step-indexed checkpoint was written, the
    `preempt` telemetry event is in the stream. The launcher converts
    this into exit code PREEMPT_RC."""

    def __init__(self, signal_name: str, epoch: int, iteration: int):
        super().__init__(
            f"preempted by {signal_name} at epoch {epoch} iteration "
            f"{iteration}; progress checkpointed — restart to resume"
        )
        self.signal_name = signal_name
        self.epoch = epoch
        self.iteration = iteration

KINDS = ("nan", "stall", "preempt", "chip_unavailable", "kill", "wedge")
_ALLOWED_KEYS = {
    "nan": {"step", "count", "proc"},
    "stall": {"secs", "phase", "step", "proc"},
    "preempt": {"step", "signal", "proc"},
    "chip_unavailable": {"proc"},
    "kill": {"step", "proc", "inc"},
    "wedge": {"step", "secs", "proc", "inc"},
}
_REQUIRED_KEYS = {
    "nan": {"step"},
    "stall": {"secs"},
    "preempt": {"step"},
    "chip_unavailable": set(),
    "kill": {"step"},
    "wedge": {"step", "secs"},
}
_SIGNALS = {"SIGTERM": signal.SIGTERM, "SIGINT": signal.SIGINT}
# the phases the trainer actually queries; an unknown phase would parse
# and then silently never fire — the no-op the grammar check exists to stop
_PHASES = ("train", "eval")

GRAMMAR = (
    "expected 'kind@key=val,...' specs joined by ';' with kind in "
    f"{KINDS} — e.g. 'nan@step=3;preempt@step=6' (see utils/faults.py)"
)


@dataclasses.dataclass
class FaultSpec:
    kind: str
    step: Optional[int] = None
    count: int = 1
    secs: float = 0.0
    phase: str = "train"
    signal: str = "SIGTERM"
    proc: Optional[int] = None  # None = fire on every process
    inc: int = 0  # kill/wedge: supervisor incarnation the spec fires in
    fired: bool = False  # one-shot kinds (stall/preempt) consume themselves
    fired_steps: set = dataclasses.field(default_factory=set)  # nan kind
    observed_below: bool = False  # preempt: a step < `step` was seen, so
    # reaching `step` is a live crossing, not a resumed counter landing
    # past a fault that already fired in the previous process

    def describe(self) -> str:
        kv = []
        if self.step is not None:
            kv.append(f"step={self.step}")
        if self.kind == "nan" and self.count != 1:
            kv.append(f"count={self.count}")
        if self.kind == "stall":
            kv.append(f"secs={self.secs:g}")
            kv.append(f"phase={self.phase}")
        if self.kind == "preempt":
            kv.append(f"signal={self.signal}")
        if self.kind == "wedge":
            kv.append(f"secs={self.secs:g}")
        if self.proc is not None:
            kv.append(f"proc={self.proc}")
        if self.kind in ("kill", "wedge") and self.inc:
            kv.append(f"inc={self.inc}")
        return self.kind + ("@" + ",".join(kv) if kv else "")


def parse_plan(text: str) -> "FaultPlan":
    """Parse a plan string; malformed input raises ValueError naming the
    offending spec and the grammar (a typo'd fault plan silently injecting
    nothing would defeat the whole point of deterministic injection)."""
    specs: list[FaultSpec] = []
    for raw in text.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        kind, _, argstr = raw.partition("@")
        kind = kind.strip()
        if kind not in KINDS:
            raise ValueError(
                f"fault plan: unknown kind {kind!r} in {raw!r}; {GRAMMAR}"
            )
        kv: dict[str, str] = {}
        if argstr:
            for item in argstr.split(","):
                key, sep, val = item.partition("=")
                key, val = key.strip(), val.strip()
                if not sep or not key or not val:
                    raise ValueError(
                        f"fault plan: malformed arg {item!r} in {raw!r}; "
                        f"{GRAMMAR}"
                    )
                if key not in _ALLOWED_KEYS[kind]:
                    raise ValueError(
                        f"fault plan: {kind!r} takes keys "
                        f"{sorted(_ALLOWED_KEYS[kind])}, got {key!r}"
                    )
                kv[key] = val
        missing = _REQUIRED_KEYS[kind] - kv.keys()
        if missing:
            raise ValueError(
                f"fault plan: {raw!r} missing required key(s) "
                f"{sorted(missing)}; {GRAMMAR}"
            )
        spec = FaultSpec(kind=kind)
        try:
            if "step" in kv:
                spec.step = int(kv["step"])
            if "count" in kv:
                spec.count = int(kv["count"])
            if "secs" in kv:
                spec.secs = float(kv["secs"])
            if "proc" in kv:
                spec.proc = int(kv["proc"])
            if "inc" in kv:
                spec.inc = int(kv["inc"])
        except ValueError:
            raise ValueError(
                f"fault plan: non-numeric value in {raw!r}; {GRAMMAR}"
            ) from None
        if spec.proc is not None and spec.proc < 0:
            raise ValueError("fault plan: proc must be >= 0")
        if spec.inc < 0:
            raise ValueError("fault plan: inc must be >= 0")
        if "phase" in kv:
            if kv["phase"] not in _PHASES:
                raise ValueError(
                    f"fault plan: phase must be one of {list(_PHASES)}, "
                    f"got {kv['phase']!r}"
                )
            spec.phase = kv["phase"]
        if "signal" in kv:
            sig = kv["signal"].upper()
            if sig not in _SIGNALS:
                raise ValueError(
                    f"fault plan: signal must be one of "
                    f"{sorted(_SIGNALS)}, got {kv['signal']!r}"
                )
            spec.signal = sig
        if spec.kind == "nan" and spec.count < 1:
            raise ValueError("fault plan: nan count must be >= 1")
        if spec.kind == "stall" and spec.secs < 0:
            raise ValueError("fault plan: stall secs must be >= 0")
        if spec.kind == "wedge" and spec.secs < 0:
            raise ValueError("fault plan: wedge secs must be >= 0")
        specs.append(spec)
    return FaultPlan(specs)


class FaultPlan:
    """Parsed fault plan; the trainer/bench query it at phase boundaries."""

    def __init__(self, specs: Optional[list[FaultSpec]] = None):
        self.specs = list(specs or [])

    @classmethod
    def from_env(cls, environ=None) -> "FaultPlan":
        text = (environ or os.environ).get(ENV_VAR, "")
        if not text.strip():
            return cls([])
        return parse_plan(text)

    def __bool__(self) -> bool:
        return bool(self.specs)

    def describe(self) -> str:
        return "; ".join(s.describe() for s in self.specs)

    def for_process(self, process_index: int) -> "FaultPlan":
        """The subset of this plan addressed to `process_index`: specs
        with a matching ``proc=`` plus the unaddressed ones. Multi-host
        groups share one MGWFBP_FAULT_PLAN env; this is how each process
        keeps only its own faults."""
        return FaultPlan([
            s for s in self.specs
            if s.proc is None or s.proc == int(process_index)
        ])

    def for_incarnation(self, incarnation: int) -> "FaultPlan":
        """Drop HARD specs (kill/wedge) addressed to a different
        supervisor incarnation. Kill/wedge are drain-less: the healed
        relaunch resumes BELOW the fault step, so without this filter
        the crossing semantics would re-fire the fault in every life
        and the chaos run could never complete. Soft kinds pass through
        unfiltered — their one-shot/crossing semantics already handle
        resumption."""
        return FaultPlan([
            s for s in self.specs
            if s.kind not in ("kill", "wedge")
            or s.inc == int(incarnation)
        ])

    # -- queries (all deterministic in the host counters) -----------------
    def nan_at(self, step: int) -> bool:
        """True when optimizer step `step` (1-indexed) must see NaN grads.

        Each planned step fires ONCE — the fault models a transient flip
        (bad DMA, cosmic ray), so a rollback-and-replay of the same step
        sees clean data; otherwise a deterministic plan would re-poison
        every replay and rollback could never converge."""
        for s in self.specs:
            if (
                s.kind == "nan"
                and s.step <= step < s.step + s.count
                and step not in s.fired_steps
            ):
                s.fired_steps.add(step)
                return True
        return False

    def stall_secs(self, phase: str, step: Optional[int] = None) -> float:
        """Seconds to stall in `phase` at `step` (0.0 = no stall). One-shot:
        a matching spec is consumed so the stall fires exactly once. A
        spec with a step= constraint fires ONLY when the caller reports
        exactly that step — never "on the first call", which would move
        the injected wedge to a different point than the plan names."""
        for s in self.specs:
            if s.kind != "stall" or s.fired or s.phase != phase:
                continue
            if s.step is not None and s.step != step:
                continue
            s.fired = True
            return s.secs
        return 0.0

    def preempt_signal_after(self, step: int) -> Optional[int]:
        """Signal number to deliver after step `step` completed, or None.
        One-shot, and fires only on a live CROSSING of the planned step:
        landing exactly on `step`, or reaching it after a smaller step was
        observed in THIS process. A resumed run whose counter is already
        past `step` consumes the spec silently — the fault fired in the
        previous life, and re-delivering it would preempt every restart
        forever when a supervisor re-runs the same command (same env, same
        plan) on rc PREEMPT_RC."""
        for s in self.specs:
            if s.kind != "preempt" or s.fired:
                continue
            if step < s.step:
                s.observed_below = True
                continue
            s.fired = True
            if s.observed_below or step == s.step:
                return _SIGNALS[s.signal]
        return None

    def chip_unavailable(self) -> bool:
        return any(s.kind == "chip_unavailable" for s in self.specs)

    def kill_after(self, step: int) -> bool:
        """True when the process must SIGKILL ITSELF after step `step`
        completed (drain-less hard crash). Same live-crossing semantics
        as preempt_signal_after — a resumed counter already past the
        planned step consumes the spec silently (belt-and-braces under
        the ``inc=`` filter)."""
        for s in self.specs:
            if s.kind != "kill" or s.fired:
                continue
            if step < s.step:
                s.observed_below = True
                continue
            s.fired = True
            if s.observed_below or step == s.step:
                return True
        return False

    def wedge_secs(self, step: int) -> float:
        """Seconds to stop stepping at exactly step `step` (0.0 = none).
        One-shot, exact-step only — a wedge is a liveness-signature
        fault and must freeze the step counter at precisely the planned
        point, never "on the first call after resume"."""
        for s in self.specs:
            if s.kind != "wedge" or s.fired:
                continue
            if s.step != step:
                continue
            s.fired = True
            return s.secs
        return 0.0
