"""The port's metric registry, /metrics and the event stream's size rotation,
held against the JAX package on the same inputs.

  * ``telemetry.export``: both aggregators fed one seeded event sequence
    (every counted kind, the alarm edges, health, postmortems, the serving
    events) render the same Prometheus text, parse to equal dicts and give
    equal /status documents (but ``uptime_s``);
  * ``prometheus_text`` and ``chrome_trace`` of one port-written stream
    equal the JAX functions' on the same records;
  * ``MGWFBP_TELEMETRY_MAX_MB`` rotation: a port-rotated stream reads back
    identically through both ``read_event_set``s, and so does a
    JAX-rotated one;
  * ``/metrics`` of a CPU lenet ``Trainer`` parses with the port's
    ``parse_metrics_text``, and equals the JAX file dump of the same
    stream (its counters match the stream's events).

Every comparison is exact: the same host arithmetic on the same floats.
"""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from mgwfbp_tpu.telemetry import events as jax_events
from mgwfbp_tpu.telemetry import export as jax_export
from mgwfbp_tpu.telemetry.serve import MetricsAggregator as JaxAggregator
from mgwfbp_tpu_torch.config import make_config
from mgwfbp_tpu_torch.telemetry import events, export
from mgwfbp_tpu_torch.telemetry.serve import MetricsAggregator
from mgwfbp_tpu_torch.train import Trainer


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def seeded_events(seed: int, n: int = 60) -> list[tuple[str, dict]]:
    """A random but valid event sequence: every kind the aggregator reads,
    with alarm edges that raise and clear."""
    rng = np.random.default_rng(seed)
    out: list[tuple[str, dict]] = [("header", {
        "schema_version": 2, "run": {"model": "lenet", "seed": seed}})]
    step = 0
    for _ in range(n):
        kind = rng.choice([
            "step", "step", "step", "epoch", "overlap", "checkpoint",
            "watchdog_stall", "bad_step", "rollback", "preempt", "resume",
            "resize", "failure", "heal", "drift_alarm", "straggler",
            "health", "health_alarm", "postmortem", "profile", "reload",
            "serve_stats", "shadow_eval", "bench_skip",
        ])
        v = float(rng.uniform(0.001, 2.0))
        if kind == "step":
            step += 1
            f = {"step": step, "epoch": step // 10, "start_s": 0.1 * step,
                 "dur_s": v}
        elif kind == "epoch":
            f = {"epoch": step // 10, "steps": 10, "dur_s": v}
        elif kind == "overlap":
            f = {"step": step, "epoch": 0, "step_s": v, "tb_total_s": v / 2,
                 "comm_s": v / 3, "hidden_s": v / 4, "exposed_s": v / 12,
                 "efficiency": 0.75, "attribution": "cost-model"}
        elif kind == "checkpoint":
            f = {"epoch": 0, "iteration": step, "mid_epoch": bool(step % 2)}
        elif kind == "watchdog_stall":
            f = {"phase": "train", "idle_s": v, "timeout_s": 1.0,
                 "abort": False}
        elif kind == "bad_step":
            f = {"step": step, "epoch": 0, "nonfinite": 3.0}
        elif kind == "rollback":
            f = {"bad_steps": 3, "restored_iteration": 1,
                 "restored_epoch": 0}
        elif kind == "preempt":
            f = {"signal": "SIGTERM", "epoch": 0, "iteration": step}
        elif kind == "resume":
            f = {"epoch": 0, "iteration": step, "mid_epoch": True}
        elif kind == "resize":
            f = {"old_world": 2, "new_world": 1,
                 "schedule_source": "relaunch-reshard", "num_groups": 3}
        elif kind == "failure":
            f = {"class": "crash", "target": "p1"}
        elif kind == "heal":
            f = {"action": "relaunch"}
        elif kind == "drift_alarm":
            f = {"kind": str(rng.choice(["comm_residual", "step_trend"])),
                 "step": step, "residual": v, "band": 3.0,
                 "active": bool(rng.integers(2)),
                 "group": int(rng.integers(-1, 3))}
        elif kind == "straggler":
            f = {"step": step, "slow_process": int(rng.integers(2)),
                 "excess_s": v, "step_s_max": v + 1, "step_s_min": 1.0,
                 "active": bool(rng.integers(2))}
        elif kind == "health":
            f = {"step": step, "epoch": 0, "loss": v, "grad_norm": v * 3,
                 "update_ratio": v / 100, "group_norms": [v, v / 2]}
        elif kind == "health_alarm":
            f = {"kind": str(rng.choice(["loss_spike", "grad_explosion"])),
                 "step": step, "value": v, "band": 2.0,
                 "active": bool(rng.integers(2)), "group": -1}
        elif kind == "postmortem":
            f = {"trigger": "bad_step", "step": step,
                 "path": f"/tmp/pm/{step:04d}"}
        elif kind == "profile":
            f = {"step": step, "steps": 2, "attribution": "none",
                 "device_s": [], "trace_dir": ""}
        elif kind == "reload":
            f = {"step": step, "lag_s": v, "duration_s": v / 10}
        elif kind == "serve_stats":
            f = {"requests": step * 3, "queue_depth": 1, "batch_fill": 0.5,
                 "latency_p50_s": v, "latency_p95_s": 2 * v,
                 "latency_p99_s": 3 * v}
        elif kind == "shadow_eval":
            f = {"step": step, "loss": v}
        else:
            f = {"detail": "chip unavailable"}
        out.append((str(kind), f))
    return out


def _status_view(agg) -> dict:
    st = agg.status()
    st.pop("uptime_s")
    return st


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aggregators_render_the_same_metrics(seed):
    ours, theirs = MetricsAggregator(), JaxAggregator()
    for ev, fields in seeded_events(seed):
        ours.observe(ev, dict(fields))
        theirs.observe(ev, dict(fields))
    assert ours.values() == theirs.values()
    text = export.render_metrics(ours.values())
    assert text == jax_export.render_metrics(theirs.values())
    assert export.parse_metrics_text(text) == jax_export.parse_metrics_text(
        text)
    assert _status_view(ours) == _status_view(theirs)
    assert ours.postmortems() == theirs.postmortems()
    # the registry itself is the JAX one, name, kind and help text
    assert export.METRICS == jax_export.METRICS
    assert export.EVENT_COUNTERS == jax_export.EVENT_COUNTERS
    labeled = {"0": ours.values(), "1": theirs.values()}
    assert export.render_labeled_metrics(labeled) == (
        jax_export.render_labeled_metrics(labeled))


def test_unregistered_metric_is_refused_as_in_jax():
    for mod in (export, jax_export):
        with pytest.raises(ValueError, match="not in telemetry.export"):
            mod.render_metrics({"mgwfbp_no_such_metric": 1})
        with pytest.raises(ValueError, match="not in telemetry.export"):
            mod.parse_metrics_text("mgwfbp_no_such_metric 1\n")


def _write_port_stream(path, seed: int, max_bytes=None) -> None:
    w = events.EventWriter(str(path), run={"model": "lenet"},
                           max_bytes=max_bytes)
    for ev, fields in seeded_events(seed)[1:]:
        w.emit(ev, **fields)
    # one schedule regime for the Chrome trace's intra-step spans
    w.emit("overlap", step=99, epoch=0, step_s=0.02, tb_total_s=0.01,
           comm_s=0.006, hidden_s=0.004, exposed_s=0.002, efficiency=0.66,
           attribution="cost-model", timeline_end_s=0.013)
    for g in range(3):
        w.emit("comm_group", step=99, group=g, nbytes=4096 * (g + 1),
               comm_s=0.002, start_s=0.003 * g, hidden_s=0.001,
               exposed_s=0.001, attribution="cost-model")
    w.emit("step", step=100, epoch=9, start_s=20.0, dur_s=0.021)
    w.close()


def test_prometheus_and_chrome_trace_of_a_port_stream_equal_jax(tmp_path):
    path = tmp_path / "telemetry.jsonl"
    _write_port_stream(path, seed=3)
    ours = events.read_events(str(path))
    theirs = jax_events.read_events(str(path))
    assert ours == theirs
    assert export.prometheus_text(ours) == jax_export.prometheus_text(theirs)
    assert export.chrome_trace(ours) == jax_export.chrome_trace(theirs)
    assert export.latest_snapshot(ours) == jax_export.latest_snapshot(theirs)
    doc = export.write_chrome_trace(str(tmp_path / "t.json"), ours)
    assert json.loads((tmp_path / "t.json").read_text()) == doc
    text = export.write_prometheus(str(tmp_path / "m.prom"), ours)
    assert (tmp_path / "m.prom").read_text() == text


def test_rotation_round_trips_through_both_readers(tmp_path, monkeypatch):
    # the port's writer, rotated by the environment variable
    monkeypatch.setenv("MGWFBP_TELEMETRY_MAX_MB", str(2048 / 2**20))
    port_path = tmp_path / "port" / "telemetry.jsonl"
    _write_port_stream(port_path, seed=4)
    segments = events._rotated_segments(str(port_path))
    assert len(segments) >= 3
    assert [os.path.basename(s) for s in segments] == [
        f"telemetry.jsonl.{i:04d}" for i in range(len(segments))]
    ours = events.read_event_set(str(port_path))
    assert ours == jax_events.read_event_set(str(port_path))
    assert [r["event"] for r in ours].count("header") == 1
    # unrotated, the same records (but the walls, which the writer takes)
    monkeypatch.delenv("MGWFBP_TELEMETRY_MAX_MB")
    flat_path = tmp_path / "flat" / "telemetry.jsonl"
    _write_port_stream(flat_path, seed=4)
    flat = events.read_event_set(str(flat_path))
    strip = [{k: v for k, v in r.items() if k != "wall"} for r in flat]
    assert [{k: v for k, v in r.items() if k != "wall"} for r in ours] == (
        strip)
    # the JAX writer's rotated stream through the port's reader
    jax_path = tmp_path / "jax" / "telemetry.jsonl"
    jw = jax_events.EventWriter(str(jax_path), run={"model": "lenet"},
                                max_bytes=2048)
    for ev, fields in seeded_events(5)[1:]:
        jw.emit(ev, **fields)
    jw.close()
    assert len(jax_events._rotated_segments(str(jax_path))) >= 2
    assert events.read_event_set(str(jax_path)) == (
        jax_events.read_event_set(str(jax_path)))
    # a writer reopened on a rotated set continues the segment sequence
    w = events.EventWriter(str(port_path), max_bytes=2048)
    assert w._segment == len(segments)
    w.close()


def _get(port: int, path: str) -> tuple[int, str]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_trainer_metrics_parse_and_match_the_stream(tmp_path, monkeypatch):
    monkeypatch.setenv("MGWFBP_FAULT_PLAN", "nan@step=3")
    cfg = make_config("lenet", batch_size=4, num_batches_per_epoch=6,
                      max_epochs=1, logdir=str(tmp_path), checkpoint_dir=None,
                      seed=5, augment=False, metrics_port=0)
    t = Trainer(cfg, device="cpu", synthetic_data=True,
                profile_backward=False)
    try:
        port = t._metrics_server.port
        t.fit(1)
        code, text = _get(port, "/metrics")
        assert code == 200
        got = export.parse_metrics_text(text)
        rows = events.read_event_set(t.telemetry.path)
        assert got["mgwfbp_steps_total"] == len(
            events.events_of(rows, "step")) == 6
        assert got["mgwfbp_bad_steps_total"] == 1
        assert got["mgwfbp_postmortems_total"] == 1
        assert got["mgwfbp_current_step"] == 6
        # the JAX file dump of the same stream: the same registry values
        assert got == jax_export.parse_metrics_text(
            jax_export.prometheus_text(jax_events.read_event_set(
                t.telemetry.path)))
        code, body = _get(port, "/nope")
        assert code == 404 and "/metrics" in body and "item" not in body
    finally:
        t.close()
