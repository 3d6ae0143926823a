"""The port's drift and straggler detectors (``telemetry/drift.py``) against
the JAX package's, and their wiring in the port's trainer.

  * ``Hysteresis``, ``DriftDetector`` (step trend; comm residual, absolute
    per group and baseline-relative aggregate) and ``StragglerDetector``
    give the same alarm edges as the JAX classes on seeded series
    (alarms compared as dataclass fields: kind, residual, band, active,
    group; exact, the same host arithmetic);
  * ``DriftConfig.from_env`` reads the same ``MGWFBP_DRIFT_*`` /
    ``MGWFBP_STRAGGLER_*`` variables to the same values;
  * ``MGWFBP_DRIFT_REAUTOTUNE=1`` reads as in JAX and, at two gloo ranks,
    arms a forced re-race on a raised alarm, which installs its winner,
    resets the detector and emits ``autotune_race`` and
    ``autotune_commit``;
  * a CPU lenet ``Trainer`` whose steps slow down mid-run (a ``stall``
    fault per step) writes a ``step_trend`` ``drift_alarm`` that the JAX
    package's reader and schema accept.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from mgwfbp_tpu.telemetry import drift as jax_drift
from mgwfbp_tpu.telemetry import events as jax_events
from mgwfbp_tpu_torch.config import make_config
from mgwfbp_tpu_torch.telemetry import drift, events
from mgwfbp_tpu_torch.train import Trainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_autotune_worker as autotune_worker  # noqa: E402


def autotune_worker_cfg(tmp: str) -> dict:
    """A 2-rank LeNet run with telemetry and 20 steps in its epoch."""
    return dict(batch_size=4, num_batches_per_epoch=20, max_epochs=1, seed=5,
                augment=False, lr=0.01, logdir=os.path.join(tmp, "logs"),
                checkpoint_dir=None, telemetry=True, autotune_steps=2,
                schedule_cache=os.path.join(tmp, "cache"))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _edges(alarms) -> list:
    return [dataclasses.asdict(a) for a in alarms]


@pytest.mark.parametrize("k", [1, 2, 3])
def test_hysteresis_edges_match(k):
    rng = np.random.default_rng(k)
    ours, theirs = drift.Hysteresis(k), jax_drift.Hysteresis(k)
    flips = [bool(b) for b in rng.random(200) < 0.55]
    got = [ours.update(b) for b in flips]
    assert got == [theirs.update(b) for b in flips]
    assert "raise" in got and "clear" in got


def _config(mod, **kw):
    return mod.DriftConfig(**kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drift_detector_edges_match(seed):
    rng = np.random.default_rng(seed)
    kw = dict(band=2.0, trend_band=0.3, baseline_window=4, ewma_alpha=0.4,
              hysteresis=2)
    ours = drift.DriftDetector(_config(drift, **kw))
    theirs = jax_drift.DriftDetector(_config(jax_drift, **kw))
    predicted = list(rng.uniform(1e-4, 1e-3, 5))
    got, want = [], []
    for i in range(120):
        # regimes: healthy, slow, healthy again, a 5x comm error
        slow = 1.0 + (1.5 if 30 <= i < 60 else 0.0)
        comm = 5.0 if 80 <= i < 100 else 1.0
        step_s = float(0.02 * slow * rng.uniform(0.9, 1.1))
        measured = [float(p * comm * rng.uniform(0.8, 1.2))
                    for p in predicted]
        total = float(sum(measured) * rng.uniform(1.5, 2.5))
        got += _edges(ours.observe_step_window(step_s))
        want += _edges(theirs.observe_step_window(step_s))
        got += _edges(ours.observe_comm(predicted, measured_s=measured))
        want += _edges(theirs.observe_comm(predicted, measured_s=measured))
        got += _edges(ours.observe_comm(predicted, measured_total_s=total))
        want += _edges(theirs.observe_comm(predicted,
                                           measured_total_s=total))
        if i == 105:
            got += _edges(ours.clear_alarms())
            want += _edges(theirs.clear_alarms())
            ours.reset()
            theirs.reset()
    assert got == want
    kinds = {(e["kind"], e["active"]) for e in got}
    assert ("step_trend", True) in kinds and ("step_trend", False) in kinds
    assert ("comm_residual", True) in kinds
    assert ours.active == theirs.active


@pytest.mark.parametrize("seed", [0, 1])
def test_straggler_detector_edges_match(seed):
    rng = np.random.default_rng(seed)
    ours = drift.StragglerDetector(0.25, 2, 0.02)
    theirs = jax_drift.StragglerDetector(0.25, 2, 0.02)
    got, want = [], []
    for i in range(80):
        times = list(rng.uniform(0.05, 0.06, 4))
        if 20 <= i < 40:
            times[int(seed) + 1] += 0.1  # one slow process
        a, b = ours.observe(times), theirs.observe(times)
        got.append(None if a is None else dataclasses.asdict(a))
        want.append(None if b is None else dataclasses.asdict(b))
    assert got == want
    assert [g["active"] for g in got if g] == [True, False]
    assert ours.active == theirs.active


def test_config_from_env_matches(monkeypatch):
    for name, value in (
        ("MGWFBP_DRIFT_BAND", "4.5"), ("MGWFBP_DRIFT_TREND_BAND", "0.7"),
        ("MGWFBP_DRIFT_WINDOW", "9"), ("MGWFBP_DRIFT_HYSTERESIS", "3"),
        ("MGWFBP_DRIFT_EWMA_ALPHA", "0.2"),
        ("MGWFBP_STRAGGLER_BAND", "0.4"),
        ("MGWFBP_STRAGGLER_MIN_EXCESS_S", "0.01"),
    ):
        monkeypatch.setenv(name, value)
    assert dataclasses.asdict(drift.DriftConfig.from_env()) == (
        dataclasses.asdict(jax_drift.DriftConfig.from_env()))
    monkeypatch.setenv("MGWFBP_DRIFT_BAND", "wide")
    for mod in (drift, jax_drift):
        with pytest.raises(ValueError, match="MGWFBP_DRIFT_BAND"):
            mod.DriftConfig.from_env()


def _lenet_cfg(tmp_path, **kw):
    base = dict(batch_size=4, num_batches_per_epoch=12, max_epochs=1,
                logdir=str(tmp_path), checkpoint_dir=None, seed=5,
                augment=False, telemetry=True)
    base.update(kw)
    return make_config("lenet", **base)


def test_reautotune_arms_a_forced_rerace(tmp_path, monkeypatch):
    """``MGWFBP_DRIFT_REAUTOTUNE=1`` reads as the JAX package reads it, and
    at two gloo ranks (``tests/torch_autotune_worker.py``) a raised
    ``step_trend`` alarm (a 2 s stall on both ranks at steps 6 and 7)
    arms a forced re-race at the next agreed step: it races, installs its
    winner, emits ``autotune_race`` and ``autotune_commit`` (source race)
    and resolves the raised alarm (the detector reset)."""
    for value, on in (("1", True), ("0", False), ("", False)):
        monkeypatch.setenv("MGWFBP_DRIFT_REAUTOTUNE", value)
        assert drift.reautotune_enabled() is on
        assert jax_drift.reautotune_enabled() is on
    env = {
        "MGWFBP_DRIFT_REAUTOTUNE": "1", "MGWFBP_LOG_INTERVAL": "1",
        "MGWFBP_DRIFT_WINDOW": "3", "MGWFBP_DRIFT_HYSTERESIS": "1",
        # a host may run the first steps 60x slower than the rest (0.24
        # against 0.004 s seen here), and they set the baseline: a 2 s stall
        # still reads over 6x it
        "MGWFBP_DRIFT_TREND_BAND": "5", "MGWFBP_DRIFT_EWMA_ALPHA": "0.9",
        "MGWFBP_AGREE_INTERVAL": "1",
        "MGWFBP_FAULT_PLAN": "stall@secs=2,step=6;stall@secs=2,step=7",
    }
    tmp = str(tmp_path)
    run = {"name": "drift", "action": "fit", "env": env,
           "cfg": autotune_worker_cfg(tmp)}
    outs = autotune_worker.run_ranks(2, tmp, {"tasks": ["race"],
                                              "race": {"runs": [run]}})
    for out in outs:
        rows = events.read_event_set(str(out["drift/events"]))
        raised = [a for a in events.events_of(rows, "drift_alarm")
                  if a["active"]]
        assert raised and raised[0]["kind"] == "step_trend"
        # every re-race was armed by a raised alarm (a loaded host can
        # raise another after the first re-race's reset)
        commits = events.events_of(rows, "autotune_commit")
        assert commits and len(commits) <= len(raised)
        assert all(c["source"] == "race" for c in commits)
        races = events.events_of(rows, "autotune_race")
        assert races and all(r["verified"] for r in races)
        order = [(r["event"], r.get("active")) for r in rows
                 if r["event"] in ("drift_alarm", "autotune_commit")]
        first = order.index(("drift_alarm", True))
        assert order.index(("autotune_commit", None)) > first
        assert ("drift_alarm", False) in order[first:]
        report = json.loads(str(out["drift/report"]))
        assert report["source"] == "race"
        assert report["winner"] == commits[-1]["winner"]
        assert json.loads(str(out["drift/groups_after"])) == \
            report["groups"]
        for r in rows:  # the JAX schema accepts every record
            assert all(k in r for k in jax_events.EVENT_TYPES[r["event"]])


def test_trainer_writes_a_step_trend_drift_alarm(tmp_path, monkeypatch):
    """Each step is a log window (MGWFBP_LOG_INTERVAL=1); the first window
    is skipped, three healthy ones freeze the baseline, then steps 6 and 7
    each sleep 1 s, 20-250x a CPU lenet step at batch 4 (4-50 ms on a
    loaded host), against an alarm at 11x the baseline; the EWMA (alpha
    0.9) falls back inside the band within a few healthy windows."""
    monkeypatch.setenv("MGWFBP_LOG_INTERVAL", "1")
    monkeypatch.setenv("MGWFBP_DRIFT_WINDOW", "3")
    monkeypatch.setenv("MGWFBP_DRIFT_HYSTERESIS", "1")
    monkeypatch.setenv("MGWFBP_DRIFT_TREND_BAND", "10")
    monkeypatch.setenv("MGWFBP_DRIFT_EWMA_ALPHA", "0.9")
    monkeypatch.setenv("MGWFBP_FAULT_PLAN",
                       "stall@secs=1,step=6;stall@secs=1,step=7")
    t = Trainer(_lenet_cfg(tmp_path, num_batches_per_epoch=20), device="cpu",
                synthetic_data=True, profile_backward=False)
    try:
        t.fit(1)
        path = t.telemetry.path
    finally:
        t.close()
    rows = events.read_event_set(path)
    alarms = events.events_of(rows, "drift_alarm")
    raised = [a for a in alarms if a["active"]]
    assert raised and raised[0]["kind"] == "step_trend"
    assert raised[0]["step"] in (6, 7)
    assert any(not a["active"] for a in alarms)  # cleared once steps heal
    # JAX reads the stream and its schema accepts every record
    assert jax_events.read_event_set(path) == rows
    for r in rows:
        need = jax_events.EVENT_TYPES[r["event"]]
        assert all(k in r for k in need), r
    # a raised alarm tripped the flight recorder
    assert any(r["trigger"] == "drift_alarm"
               for r in events.events_of(rows, "postmortem"))
