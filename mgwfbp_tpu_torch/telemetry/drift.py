"""Online cost-model drift detection and the live straggler monitor (a copy
of ``mgwfbp_tpu/telemetry/drift.py``).

Two live signals, pure host arithmetic, no device synchronisation:

  * **comm residual** (``kind='comm_residual'``): the cost model's
    predicted merge-group communication against a measured attribution.
    With per-group device seconds from a trace (a ``/profile`` window on
    the card) the residual is per group and ABSOLUTE. Without one, the
    aggregate estimator is the measured non-backward share of the step
    (step - tb), which also holds forward and dispatch overhead the model
    never priced, so that channel is BASELINE-RELATIVE: the first
    ``baseline_window`` observations learn the healthy ratio and the alarm
    fires when the ratio drifts from it by more than ``band``.
  * **step trend** (``kind='step_trend'``): an EWMA of the window step
    time against a baseline window frozen at detector start (or reset).

Alarms carry hysteresis on both edges: ``hysteresis`` consecutive
out-of-band observations raise, the same count in-band clears.

The trainer turns each ``DriftAlarm`` into a ``drift_alarm`` event. With
``MGWFBP_DRIFT_REAUTOTUNE=1`` (``reautotune_enabled``) a raised alarm also
arms a forced re-race of the schedule at the next agreed step boundary
(``Trainer.autotune(force=True)``), after which the detector resets.

``StragglerDetector`` is the multi-process sibling: at every agree
interval the group gathers each process's local busy seconds per step
(``coordination.gather_values``), and a process consistently slower than
the fastest by more than ``MGWFBP_STRAGGLER_BAND`` (and
``MGWFBP_STRAGGLER_MIN_EXCESS_S``) raises a ``straggler`` alarm naming it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

_ENV_BAND = "MGWFBP_DRIFT_BAND"
_ENV_TREND_BAND = "MGWFBP_DRIFT_TREND_BAND"
_ENV_WINDOW = "MGWFBP_DRIFT_WINDOW"
_ENV_HYSTERESIS = "MGWFBP_DRIFT_HYSTERESIS"
_ENV_EWMA = "MGWFBP_DRIFT_EWMA_ALPHA"
_ENV_REAUTOTUNE = "MGWFBP_DRIFT_REAUTOTUNE"
_ENV_STRAGGLER_BAND = "MGWFBP_STRAGGLER_BAND"
_ENV_STRAGGLER_MIN = "MGWFBP_STRAGGLER_MIN_EXCESS_S"


def _env_float(name: str, default: float) -> float:
    raw = (os.environ.get(name) or "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not a number") from None


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Detector thresholds. ``band`` is the comm-residual ratio band
    (alarm when predicted/measured leaves [1/band, band]; <= 0 disables
    the comm detector), ``trend_band`` the step-trend excess fraction
    (alarm when ewma > baseline * (1 + trend_band); <= 0 disables),
    ``baseline_window`` how many observations freeze the trend baseline,
    ``hysteresis`` the consecutive out-of-band (and, symmetrically,
    in-band) observations required to raise (clear) an alarm."""

    band: float = 3.0
    trend_band: float = 0.5
    baseline_window: int = 5
    ewma_alpha: float = 0.3
    hysteresis: int = 2
    straggler_band: float = 0.25
    # absolute floor on the straggler excess: the probed local busy time
    # (host prep) is small, so a purely relative band would alarm on
    # millisecond noise between healthy hosts
    straggler_min_excess_s: float = 0.02

    @classmethod
    def from_env(cls) -> "DriftConfig":
        base = cls()
        return cls(
            band=_env_float(_ENV_BAND, base.band),
            trend_band=_env_float(_ENV_TREND_BAND, base.trend_band),
            baseline_window=max(
                int(_env_float(_ENV_WINDOW, base.baseline_window)), 1
            ),
            ewma_alpha=min(
                max(_env_float(_ENV_EWMA, base.ewma_alpha), 0.01), 1.0
            ),
            hysteresis=max(
                int(_env_float(_ENV_HYSTERESIS, base.hysteresis)), 1
            ),
            straggler_band=_env_float(
                _ENV_STRAGGLER_BAND, base.straggler_band
            ),
            straggler_min_excess_s=_env_float(
                _ENV_STRAGGLER_MIN, base.straggler_min_excess_s
            ),
        )


def reautotune_enabled(environ=None) -> bool:
    return (environ or os.environ).get(_ENV_REAUTOTUNE) == "1"


@dataclasses.dataclass(frozen=True)
class DriftAlarm:
    """One alarm edge: ``active=True`` raises, ``False`` clears. Maps 1:1
    onto the ``drift_alarm`` telemetry event."""

    kind: str  # 'comm_residual' | 'step_trend'
    residual: float  # ratio (comm) or excess fraction (trend) at the edge
    band: float
    active: bool
    group: int = -1  # arrival-order merge group, -1 = aggregate


class Hysteresis:
    """Two-edge debounce: `k` consecutive True updates raise, `k`
    consecutive False updates clear; anything else holds the current
    state. Returns the edge ('raise' / 'clear') or None."""

    def __init__(self, k: int):
        self.k = max(int(k), 1)
        self.active = False
        self._over = 0
        self._under = 0

    def update(self, exceeded: bool) -> Optional[str]:
        if exceeded:
            self._over += 1
            self._under = 0
        else:
            self._under += 1
            self._over = 0
        if not self.active and self._over >= self.k:
            self.active = True
            return "raise"
        if self.active and self._under >= self.k:
            self.active = False
            return "clear"
        return None


class DriftDetector:
    """Rolling predicted-vs-measured residuals + EWMA step-time trend.

    Feed one call per observation window (the trainer uses its log
    window). All inputs are plain host floats; every method is cheap
    enough for the step loop's logging cadence."""

    def __init__(self, config: Optional[DriftConfig] = None):
        self.config = config or DriftConfig.from_env()
        self.reset()

    def reset(self) -> None:
        """Forget baselines and alarm state — called after a re-autotune
        installs a corrected model (the old residuals described the old
        model) and at construction."""
        c = self.config
        self._trend_hyst = Hysteresis(c.hysteresis)
        self._comm_hyst: dict[int, Hysteresis] = {}
        self._baseline: list[float] = []
        self._baseline_mean: Optional[float] = None
        self._ewma: Optional[float] = None
        self._ratio_baseline: list[float] = []
        self._ratio_baseline_mean: Optional[float] = None

    @property
    def active(self) -> bool:
        return self._trend_hyst.active or any(
            h.active for h in self._comm_hyst.values()
        )

    def clear_alarms(self) -> list[DriftAlarm]:
        """Clear-edges for every currently-active alarm (residual at the
        neutral value). Emit these BEFORE `reset()` when the alarm state
        is being resolved out-of-band (a re-autotune installed a
        corrected model) — a bare reset would leave the raised alarms
        active forever in every consumer of the event stream."""
        out = []
        if self._trend_hyst.active:
            out.append(DriftAlarm(
                kind="step_trend", residual=0.0,
                band=float(self.config.trend_band), active=False,
            ))
        for gi, h in self._comm_hyst.items():
            if h.active:
                out.append(DriftAlarm(
                    kind="comm_residual", residual=1.0,
                    band=float(self.config.band), active=False, group=gi,
                ))
        return out

    # -- step-time trend ---------------------------------------------------
    def observe_step_window(self, step_s: float) -> list[DriftAlarm]:
        """One measured window-mean step time. The first
        ``baseline_window`` observations freeze the baseline; after that
        the EWMA is compared against baseline * (1 + trend_band)."""
        c = self.config
        if c.trend_band <= 0 or step_s <= 0.0:
            return []
        if self._baseline_mean is None:
            self._baseline.append(float(step_s))
            if len(self._baseline) >= c.baseline_window:
                self._baseline_mean = sum(self._baseline) / len(
                    self._baseline
                )
            return []
        self._ewma = (
            float(step_s)
            if self._ewma is None
            else c.ewma_alpha * float(step_s)
            + (1.0 - c.ewma_alpha) * self._ewma
        )
        excess = self._ewma / self._baseline_mean - 1.0
        edge = self._trend_hyst.update(excess > c.trend_band)
        if edge is None:
            return []
        return [DriftAlarm(
            kind="step_trend", residual=float(excess),
            band=float(c.trend_band), active=(edge == "raise"),
        )]

    # -- comm residuals ----------------------------------------------------
    def observe_comm(
        self,
        predicted_s: Sequence[float],
        measured_s: Optional[Sequence[float]] = None,
        measured_total_s: Optional[float] = None,
    ) -> list[DriftAlarm]:
        """Predicted per-group comm seconds vs a measured attribution.

        ``measured_s`` (trace-attributed, per group) checks each group's
        ratio ABSOLUTELY, both sides of the band — a direct measurement
        refutes the prediction outright. Without it, ``measured_total_s``
        must be the measured non-backward step share (step - tb); that
        estimator carries unmodeled forward/dispatch overhead, so the
        aggregate (group=-1) channel learns the healthy
        predicted/measured ratio over the first ``baseline_window``
        observations and alarms when the CURRENT ratio drifts from the
        baseline by more than ``band`` either way — the residual reported
        is the drift FACTOR (current ratio / baseline ratio).
        """
        c = self.config
        if c.band <= 0 or not len(predicted_s):
            return []
        alarms: list[DriftAlarm] = []
        if measured_s is not None and len(measured_s) == len(predicted_s):
            for gi, (p, m) in enumerate(zip(predicted_s, measured_s)):
                m = float(m)
                if m <= 0.0:
                    continue
                ratio = float(p) / m
                hyst = self._comm_hyst.setdefault(
                    gi, Hysteresis(c.hysteresis)
                )
                edge = hyst.update(ratio > c.band or ratio < 1.0 / c.band)
                if edge is not None:
                    alarms.append(DriftAlarm(
                        kind="comm_residual", residual=float(ratio),
                        band=float(c.band), active=(edge == "raise"),
                        group=gi,
                    ))
            return alarms
        if measured_total_s is None or measured_total_s <= 0.0:
            return []
        ratio = float(sum(float(p) for p in predicted_s)) / float(
            measured_total_s
        )
        if self._ratio_baseline_mean is None:
            self._ratio_baseline.append(ratio)
            if len(self._ratio_baseline) >= c.baseline_window:
                self._ratio_baseline_mean = sum(self._ratio_baseline) / len(
                    self._ratio_baseline
                )
            return []
        if self._ratio_baseline_mean <= 0.0:
            return []
        rel = ratio / self._ratio_baseline_mean
        hyst = self._comm_hyst.setdefault(-1, Hysteresis(c.hysteresis))
        edge = hyst.update(rel > c.band or rel < 1.0 / c.band)
        if edge is not None:
            alarms.append(DriftAlarm(
                kind="comm_residual", residual=float(rel),
                band=float(c.band), active=(edge == "raise"), group=-1,
            ))
        return alarms


@dataclasses.dataclass(frozen=True)
class StragglerAlarm:
    """One straggler edge; maps onto the ``straggler`` event (the slow
    process is named `slow_process` — the merge tool owns the `process`
    key for the emitting stream)."""

    slow_process: int
    excess_s: float
    step_s_max: float
    step_s_min: float
    active: bool


class StragglerDetector:
    """Excess monitor over the group's gathered per-process local busy
    times: alarm when the slowest exceeds the fastest BOTH relatively
    (by more than ``band``) and absolutely (by more than
    ``min_excess_s`` — the probed signal is host-side prep time, small
    enough that a purely relative band would alarm on ms noise) for
    ``hysteresis`` consecutive probes; clears symmetrically."""

    def __init__(
        self, band: float, hysteresis: int = 2,
        min_excess_s: float = 0.02,
    ):
        self.band = float(band)
        self.min_excess_s = float(min_excess_s)
        self._hyst = Hysteresis(hysteresis)
        self._raised_proc: Optional[int] = None

    @property
    def active(self) -> bool:
        return self._hyst.active

    def observe(self, step_times: Sequence[float]) -> Optional[
        StragglerAlarm
    ]:
        times = [float(t) for t in step_times]
        if self.band <= 0 or len(times) < 2 or min(times) <= 0.0:
            return None
        fastest = min(times)
        slowest = max(times)
        slow_idx = max(range(len(times)), key=lambda i: times[i])
        edge = self._hyst.update(
            (slowest - fastest) / fastest > self.band
            and slowest - fastest > self.min_excess_s
        )
        if edge is None:
            return None
        if edge == "raise":
            self._raised_proc = int(slow_idx)
        # a clear edge resolves the RAISED alarm: name the process that
        # alarm named, not whichever healthy process happens to argmax
        # the now-near-equal probe — raise and clear rows must pair up
        # for anyone reading the stream
        named = (
            int(slow_idx) if edge == "raise"
            else int(self._raised_proc if self._raised_proc is not None
                     else slow_idx)
        )
        if edge == "clear":
            self._raised_proc = None
        return StragglerAlarm(
            slow_process=named,
            excess_s=float(slowest - fastest),
            step_s_max=float(slowest),
            step_s_min=float(fastest),
            active=(edge == "raise"),
        )
