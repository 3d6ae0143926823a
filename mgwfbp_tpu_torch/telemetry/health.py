"""Online training-health detection (a copy of
``mgwfbp_tpu/telemetry/health.py``, the model-watching sibling of
``telemetry/drift.py``).

It consumes the per-step ``health`` statistics that ``TrainStep`` computes
(``train/step.py``: the post-reduction gradient norm, one norm per merge
group, the update/param norm ratio and, with a top-k compressor, each
group's compression error), which the trainer reads one step late, and
raises ``health_alarm`` edges:

  * **loss spike** (``kind='loss_spike'``): the step loss versus its own
    EWMA; a non-finite loss always counts as exceeded;
  * **gradient explosion** (``kind='grad_explosion'``): the global
    gradient L2 norm versus a baseline frozen over the first
    ``baseline_window`` observations (non-finite norms count as exceeded);
  * **plateau** (``kind='plateau'``): no relative loss improvement better
    than ``plateau_delta`` for ``plateau_window`` observations;
  * **compression error** (``kind='compression_error'``): the worst
    per-group relative top-k error versus its frozen baseline, fed by the
    step's ``comp_err_gNNNN`` values when a sparsifying compressor runs
    (silent otherwise: ``observe`` is then given no
    ``compression_errors``).

Every channel sits behind the two-edge ``Hysteresis`` of the drift
detector. All inputs are plain host floats; nothing here touches a
device value. The trainer turns each ``HealthAlarm`` into a
``health_alarm`` event (an active alarm on /status, a counter on
/metrics, and a postmortem trigger through the flight recorder's tee).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence

from mgwfbp_tpu_torch.telemetry.drift import Hysteresis, _env_float

_ENV_ENABLE = "MGWFBP_HEALTH"
_ENV_SPIKE_BAND = "MGWFBP_HEALTH_SPIKE_BAND"
_ENV_EXPLOSION_BAND = "MGWFBP_HEALTH_EXPLOSION_BAND"
_ENV_PLATEAU_WINDOW = "MGWFBP_HEALTH_PLATEAU_WINDOW"
_ENV_PLATEAU_DELTA = "MGWFBP_HEALTH_PLATEAU_DELTA"
_ENV_WINDOW = "MGWFBP_HEALTH_WINDOW"
_ENV_EWMA = "MGWFBP_HEALTH_EWMA_ALPHA"
_ENV_HYSTERESIS = "MGWFBP_HEALTH_HYSTERESIS"
_ENV_COMPRESSION_BAND = "MGWFBP_HEALTH_COMPRESSION_BAND"


def health_enabled(environ=None) -> bool:
    """The detector master switch (MGWFBP_HEALTH; default on — the
    statistics stream regardless, this gates only the alarm logic)."""
    return (environ or os.environ).get(_ENV_ENABLE, "1") != "0"


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Detector thresholds. ``spike_band`` is the loss/EWMA ratio that
    raises a loss-spike alarm (<= 0 disables the channel);
    ``explosion_band`` the grad-norm/baseline ratio (<= 0 disables);
    ``plateau_window`` how many consecutive no-improvement observations
    raise a plateau (0 disables), ``plateau_delta`` the relative loss
    improvement that resets the window; ``baseline_window`` how many
    observations freeze the grad-norm/compression baselines;
    ``hysteresis`` the consecutive out-of-band (and symmetrically
    in-band) observations required to raise (clear) any alarm;
    ``compression_band`` the compression-error/baseline ratio (<= 0
    disables)."""

    spike_band: float = 2.0
    explosion_band: float = 10.0
    plateau_window: int = 200
    plateau_delta: float = 1e-3
    baseline_window: int = 10
    ewma_alpha: float = 0.1
    hysteresis: int = 2
    compression_band: float = 1.5

    @classmethod
    def from_env(cls) -> "HealthConfig":
        base = cls()
        return cls(
            spike_band=_env_float(_ENV_SPIKE_BAND, base.spike_band),
            explosion_band=_env_float(
                _ENV_EXPLOSION_BAND, base.explosion_band
            ),
            plateau_window=max(
                int(_env_float(_ENV_PLATEAU_WINDOW, base.plateau_window)), 0
            ),
            plateau_delta=_env_float(_ENV_PLATEAU_DELTA, base.plateau_delta),
            baseline_window=max(
                int(_env_float(_ENV_WINDOW, base.baseline_window)), 1
            ),
            ewma_alpha=min(
                max(_env_float(_ENV_EWMA, base.ewma_alpha), 0.01), 1.0
            ),
            hysteresis=max(
                int(_env_float(_ENV_HYSTERESIS, base.hysteresis)), 1
            ),
            compression_band=_env_float(
                _ENV_COMPRESSION_BAND, base.compression_band
            ),
        )


@dataclasses.dataclass(frozen=True)
class HealthAlarm:
    """One alarm edge: ``active=True`` raises, ``False`` clears. Maps 1:1
    onto the ``health_alarm`` telemetry event."""

    kind: str  # 'loss_spike' | 'grad_explosion' | 'plateau' |
    # 'compression_error'
    value: float  # the residual ratio (or plateau observation count)
    band: float
    active: bool
    group: int = -1  # reserved for per-group channels; -1 = aggregate


def _finite(v: float) -> bool:
    return isinstance(v, (int, float)) and math.isfinite(v)


class HealthDetector:
    """Loss-spike EWMA, grad-norm explosion band, plateau window, and the
    compression-error trend — one `observe` call per drained step.

    The statistics arrive one step late and describe the post-reduction
    gradients and the replicated parameters, so every process of a group
    observes the same values and raises the same edges; no agreement
    collective is needed."""

    def __init__(self, config: Optional[HealthConfig] = None):
        self.config = config or HealthConfig.from_env()
        self.reset()

    def reset(self) -> None:
        """Forget baselines and alarm state (construction, and after a
        rollback restores an older model whose statistics the learned
        baselines no longer describe)."""
        c = self.config
        self._spike_hyst = Hysteresis(c.hysteresis)
        self._explosion_hyst = Hysteresis(c.hysteresis)
        self._plateau_hyst = Hysteresis(c.hysteresis)
        self._compression_hyst = Hysteresis(c.hysteresis)
        self._loss_ewma: Optional[float] = None
        self._norm_baseline: list[float] = []
        self._norm_baseline_mean: Optional[float] = None
        self._best_loss: Optional[float] = None
        self._since_improvement = 0
        self._comp_baseline: list[float] = []
        self._comp_baseline_mean: Optional[float] = None
        self._comp_ewma: Optional[float] = None

    @property
    def active(self) -> bool:
        return any(
            h.active
            for h in (
                self._spike_hyst, self._explosion_hyst,
                self._plateau_hyst, self._compression_hyst,
            )
        )

    def clear_alarms(self) -> list[HealthAlarm]:
        """Clear-edges for every currently-active alarm (neutral values).
        Emit these BEFORE `reset()` when the state is resolved
        out-of-band (a rollback restored a healthy model) — a bare reset
        would leave raised alarms active forever in every stream
        consumer."""
        c = self.config
        out = []
        for hyst, kind, band in (
            (self._spike_hyst, "loss_spike", c.spike_band),
            (self._explosion_hyst, "grad_explosion", c.explosion_band),
            (self._plateau_hyst, "plateau", float(c.plateau_window)),
            (self._compression_hyst, "compression_error",
             c.compression_band),
        ):
            if hyst.active:
                out.append(HealthAlarm(
                    kind=kind, value=0.0, band=float(band), active=False,
                ))
        return out

    def observe(
        self,
        loss: float,
        grad_norm: float,
        compression_errors: Optional[Sequence[float]] = None,
    ) -> list[HealthAlarm]:
        """One drained step's health statistics -> alarm edges (possibly
        several channels at once — a NaN loss usually trips loss_spike
        and grad_explosion together)."""
        out: list[HealthAlarm] = []
        out.extend(self._observe_loss(float(loss)))
        out.extend(self._observe_norm(float(grad_norm)))
        out.extend(self._observe_plateau(float(loss)))
        if compression_errors:
            out.extend(self._observe_compression(
                max(float(e) for e in compression_errors)
            ))
        return out

    # -- loss spike --------------------------------------------------------
    def _observe_loss(self, loss: float) -> list[HealthAlarm]:
        c = self.config
        if c.spike_band <= 0:
            return []
        if self._loss_ewma is None:
            if _finite(loss):
                self._loss_ewma = loss
            return []
        denom = max(abs(self._loss_ewma), 1e-12)
        if _finite(loss):
            ratio = loss / denom
            exceeded = ratio > c.spike_band
        else:
            # NaN/inf loss: comparisons are False, which would make the
            # WORST spike invisible — force the exceeded edge
            ratio = float("inf")
            exceeded = True
        edge = self._spike_hyst.update(exceeded)
        if _finite(loss):
            # the EWMA tracks the healthy trend only: folding a spike in
            # would teach the baseline that spikes are normal
            if not exceeded:
                self._loss_ewma = (
                    c.ewma_alpha * loss
                    + (1.0 - c.ewma_alpha) * self._loss_ewma
                )
        if edge is None:
            return []
        return [HealthAlarm(
            kind="loss_spike", value=float(ratio),
            band=float(c.spike_band), active=(edge == "raise"),
        )]

    # -- gradient explosion ------------------------------------------------
    def _observe_norm(self, norm: float) -> list[HealthAlarm]:
        c = self.config
        if c.explosion_band <= 0:
            return []
        if self._norm_baseline_mean is None:
            if _finite(norm):
                if norm > 0.0:
                    self._norm_baseline.append(norm)
                    if len(self._norm_baseline) >= c.baseline_window:
                        self._norm_baseline_mean = sum(
                            self._norm_baseline
                        ) / len(self._norm_baseline)
                # a finite pre-baseline norm is an in-band observation:
                # it must be able to CLEAR a pre-baseline non-finite
                # raise, not leave it stuck until the baseline freezes
                edge = self._explosion_hyst.update(False)
                value = 1.0
            else:
                # a non-finite norm before the baseline froze is still an
                # explosion — alarm on it rather than waiting for a
                # baseline that a NaN-wedged run will never produce
                edge = self._explosion_hyst.update(True)
                value = float("inf")
            if edge is not None:
                return [HealthAlarm(
                    kind="grad_explosion", value=value,
                    band=float(c.explosion_band),
                    active=(edge == "raise"),
                )]
            return []
        if _finite(norm):
            ratio = norm / max(self._norm_baseline_mean, 1e-30)
            exceeded = ratio > c.explosion_band
        else:
            ratio = float("inf")
            exceeded = True
        edge = self._explosion_hyst.update(exceeded)
        if edge is None:
            return []
        return [HealthAlarm(
            kind="grad_explosion", value=float(ratio),
            band=float(c.explosion_band), active=(edge == "raise"),
        )]

    # -- plateau -----------------------------------------------------------
    def _observe_plateau(self, loss: float) -> list[HealthAlarm]:
        c = self.config
        if c.plateau_window <= 0:
            return []
        if not _finite(loss):
            return []  # a NaN loss is loss_spike's problem, not stagnation
        if self._best_loss is None:
            self._best_loss = loss
            self._since_improvement = 0
            return []
        improved = loss < self._best_loss - c.plateau_delta * max(
            abs(self._best_loss), 1e-12
        )
        if improved:
            self._best_loss = loss
            self._since_improvement = 0
        else:
            self._since_improvement += 1
        edge = self._plateau_hyst.update(
            self._since_improvement >= c.plateau_window
        )
        if edge is None:
            return []
        return [HealthAlarm(
            kind="plateau", value=float(self._since_improvement),
            band=float(c.plateau_window), active=(edge == "raise"),
        )]

    # -- compression-error trend ---------------------------------------------
    def _observe_compression(self, err: float) -> list[HealthAlarm]:
        """Worst per-group relative top-k error vs its frozen baseline —
        a drifting error means the sparsifier is discarding a growing
        gradient share and convergence is at risk. Fed by the trainer
        from the step's ``comp_err_gNNNN`` values."""
        c = self.config
        if c.compression_band <= 0 or not _finite(err):
            return []
        self._comp_ewma = (
            err if self._comp_ewma is None
            else c.ewma_alpha * err + (1.0 - c.ewma_alpha) * self._comp_ewma
        )
        if self._comp_baseline_mean is None:
            self._comp_baseline.append(err)
            if len(self._comp_baseline) >= c.baseline_window:
                self._comp_baseline_mean = sum(self._comp_baseline) / len(
                    self._comp_baseline
                )
            return []
        ratio = self._comp_ewma / max(self._comp_baseline_mean, 1e-30)
        edge = self._compression_hyst.update(ratio > c.compression_band)
        if edge is None:
            return []
        return [HealthAlarm(
            kind="compression_error", value=float(ratio),
            band=float(c.compression_band), active=(edge == "raise"),
        )]
