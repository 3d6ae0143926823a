"""The port's span primitive and its recorder (``telemetry.spans``), the
train step's phase spans, the reducer's group marks and the trainer's
set-up spans, on the CPU.

  * off (no profiler, no ``recording()``): a step opens no profiler range,
    creates no CUDA event and leaves the recorder empty; a span is the
    shared no-op context;
  * under torch.profiler (which arms the recorder): each step's phase
    ranges come in the order forward, backward (per micro-step), reduce,
    update; the step's calls land in the phase they belong to; the
    phases together cover the call; the recorder keeps marks, no host
    spans; armed by ``recording()`` alone a step makes no span at all;
  * under torch.profiler: the ``train_step.*`` ranges are
    ``user_annotation`` events on the stepping thread, and the
    benchmark's ``TraceView.idle_gaps`` names no gap inside a step
    ``host idle``;
  * two gloo ranks, every lowering (tests/torch_spans_worker.py): each
    armed step holds exactly one ready and one done mark per merge group,
    in launch order, done >= ready, and a tail >= 0; each profiled step's
    phases come in order; the schedule verifier and SCH005 find nothing
    with the recorder armed;
  * the ring keeps the last ``RING`` steps; readings and medians of
    known marks; ``Trainer.__init__``'s set-up spans reach ``train.log``
    and ``setup_seconds``.
"""

import os
import statistics
import sys
import time

import pytest
import torch

from mgwfbp_tpu_torch import models as zoo
from mgwfbp_tpu_torch.analysis import step_pass
from mgwfbp_tpu_torch.analysis.schedule_check import verify_observed_step
from mgwfbp_tpu_torch.config import make_config
from mgwfbp_tpu_torch.optim import make_optimizer
from mgwfbp_tpu_torch.parallel import allreduce
from mgwfbp_tpu_torch.telemetry import spans
from mgwfbp_tpu_torch.train import Trainer
from mgwfbp_tpu_torch.train import step as step_mod

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_spans_worker as worker  # noqa: E402

PHASES = (step_mod.FORWARD_SPAN, step_mod.BACKWARD_SPAN,
          step_mod.REDUCE_SPAN, step_mod.UPDATE_SPAN)


@pytest.fixture(autouse=True)
def _fresh_recorder():
    spans.clear()
    yield
    spans.clear()


def _lenet_step(nsteps_update: int = 1):
    model, meta = zoo.create_model("lenet")
    opt, lr_fn = make_optimizer(model.parameters(), 0.1, momentum=0.9,
                                weight_decay=0.0)[:2]
    step = step_mod.TrainStep(model, opt, lr_fn, norm_clip=1.0,
                              nsteps_update=nsteps_update)
    data = step_pass.batches(meta, "cpu", 0)

    def batch():
        xs, ys = zip(*(next(data) for _ in range(nsteps_update)))
        return torch.cat(xs), torch.cat(ys)

    return step, batch


def test_collective_scope_is_the_span():
    assert allreduce.collective_scope is spans.span
    assert allreduce.watch_scopes is spans.watch_scopes
    assert allreduce.open_scopes is spans.open_scopes


def test_off_step_opens_no_range_and_makes_no_event(monkeypatch):
    step, batch = _lenet_step()
    step(*batch())
    calls = {"range": 0, "event": 0}
    real_range = torch.profiler.record_function

    def counting_range(*a, **k):
        calls["range"] += 1
        return real_range(*a, **k)

    def counting_event(*a, **k):
        calls["event"] += 1
        raise AssertionError("a CUDA event on an unarmed step")

    monkeypatch.setattr(torch.profiler, "record_function", counting_range)
    monkeypatch.setattr(torch.cuda, "Event", counting_event)
    assert not torch.autograd._profiler_enabled()
    assert spans.span("mgwfbp_group0000") is spans._NULL
    assert spans.begin_step(True) is None
    step(*batch())
    assert calls == {"range": 0, "event": 0}
    assert spans.recent_steps() == []
    assert spans.armed_step() is None


STEP_RANGE = "test.step"


def _profiled_ranges(tmp_path, run) -> list[list[tuple]]:
    """``run()`` under torch.profiler (CPU), each of its steps inside a
    ``STEP_RANGE`` range: per step, the ``user_annotation`` ranges inside
    it on its thread as (name, start, end) in µs, in order of start, the
    step's own range first."""
    import json

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    path = str(tmp_path / "phases.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"], e["tid"]) for e in events
                    if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation")
    out = []
    for a, b, name, tid in ranges:
        if name == STEP_RANGE:
            out.append([(n, s, e) for s, e, n, t in ranges
                        if t == tid and a <= s and e <= b])
    return out


@pytest.mark.parametrize("nsteps_update", [1, 2])
def test_armed_phases_come_in_order_and_cover_the_step(monkeypatch,
                                                       tmp_path,
                                                       nsteps_update):
    step, batch = _lenet_step(nsteps_update)
    step(*batch())
    seen = []

    def in_phase(name, fn):
        def wrapped(*a, **k):
            open_ = step._phases._open
            seen.append((name, open_.name if open_ is not None
                         and open_ is not spans._NULL else None))
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(step_mod, "forward_loss",
                        in_phase("forward_loss", step_mod.forward_loss))
    monkeypatch.setattr(step_mod, "nonfinite_count",
                        in_phase("nonfinite_count", step_mod.nonfinite_count))
    monkeypatch.setattr(step_mod, "sgd_update_",
                        in_phase("sgd_update_", step_mod.sgd_update_))

    def run():
        for _ in range(3):
            x, y = batch()
            with torch.profiler.record_function(STEP_RANGE):
                step(x, y)

    steps = _profiled_ranges(tmp_path, run)
    assert len(steps) == 3
    # the profiler armed the recorder: its three steps, with no host spans
    readings = spans.recent_steps()
    assert len(readings) == 3
    assert all(set(r) == {"cuda", "groups", "tail_ms"} for r in readings)
    assert all(r["groups"] == [] and r["tail_ms"] is None for r in readings)
    want = ([step_mod.FORWARD_SPAN, step_mod.BACKWARD_SPAN] * nsteps_update
            + [step_mod.REDUCE_SPAN, step_mod.UPDATE_SPAN])
    for ranges in steps:
        (_, t0, t1) = ranges[0]
        phases = [r for r in ranges if r[0] in PHASES]
        assert [n for n, _, _ in phases] == want
        # each opens before the one before it ends (no instant between
        # them outside a phase), within the call, and nearly all of it
        assert t0 <= phases[0][1] and phases[-1][2] <= t1
        assert all(a[1] <= b[1] <= a[2] <= b[2]
                   for a, b in zip(phases, phases[1:]))
        covered = phases[-1][2] - phases[0][1]
        assert covered >= 0.5 * (t1 - t0)
        # the step's own ranges nest in a phase: the guard's count
        (_, s, e), = [r for r in ranges if r[0] == "finite_check"]
        upd = [p for p in phases if p[0] == step_mod.UPDATE_SPAN][0]
        assert upd[1] <= s and e <= upd[2]
    assert seen == ([("forward_loss", step_mod.FORWARD_SPAN)] * nsteps_update
                    + [("nonfinite_count", step_mod.UPDATE_SPAN),
                       ("sgd_update_", step_mod.UPDATE_SPAN)]) * 3
    assert spans.armed_step() is None


def test_armed_without_the_profiler_spans_cost_nothing(monkeypatch):
    """``recording()`` alone arms the step's marks: the phases and the
    collective scopes stay the shared no-op context."""
    step, batch = _lenet_step()
    step(*batch())
    made = []
    real_span = spans._Span

    def counting(*a, **k):
        made.append(a[0])
        return real_span(*a, **k)

    monkeypatch.setattr(spans, "_Span", counting)
    with spans.recording():
        step(*batch())
    assert made == []
    assert len(spans.recent_steps()) == 1


def test_phases_are_profiler_ranges_that_name_the_idle_gaps(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace as trace_lib

    step, batch = _lenet_step()
    step(*batch())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(*batch())  # before the steps the view reads, as the benchmark
        for _ in range(3):
            with torch.profiler.record_function(trace_lib.STEP):
                step(*batch())
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    view = trace_lib.TraceView.from_file(path)
    assert view.steps == 3
    phases = [e for e in view.host_ops if e["name"] in PHASES]
    assert [e["name"] for e in sorted(phases, key=lambda e: e["ts"])] == \
        list(PHASES) * 3
    assert {e["cat"] for e in phases} == {"user_annotation"}
    # the profiler armed the recorder: the four steps it saw
    assert len(spans.recent_steps()) == 4
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in phases)
    # from the first phase's start to the last's end, every instant of a
    # step lies in a phase
    for i in range(3):
        a, b = ranges[4 * i][0], ranges[4 * i + 3][1]
        assert all(any(s <= t <= e for s, e in ranges)
                   for t in (a + (b - a) * k / 200 for k in range(201)))
    # on the CPU no device operation runs: the one gap is the whole span,
    # whose middle lies in the second step, under a phase
    (name, _), = view.idle_gaps(n=10)
    assert name != "host idle"
    mid = (view.start + view.end) / 2
    assert any(s <= mid <= e for s, e in ranges)


def test_one_process_armed_step_has_no_host_sync():
    step, batch = _lenet_step()
    step(*batch())
    with spans.recording():
        obs = verify_observed_step(lambda: step(*batch()), step)
    assert obs.findings == [] and obs.syncs == []
    assert obs.guard_calls == [("finite_check",)]
    assert len(spans.recent_steps()) == 1


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return worker.run_ranks(2, str(tmp_path_factory.mktemp("spans")))


@pytest.mark.parametrize("name", worker.OPS)
def test_each_armed_step_marks_every_group_once(two_ranks, name):
    for out in two_ranks:
        rec = out[name]
        g = rec["groups"]
        assert g == 2
        assert len(rec["steps"]) == worker.ARMED_STEPS
        for st in rec["steps"]:
            assert [m["group"] for m in st["groups"]] == \
                rec["launch_sequence"]
            for m in st["groups"]:
                assert m["done_ms"] is not None
                assert m["done_ms"] >= m["ready_ms"]
            assert st["tail_ms"] == max(0.0, max(m["done_ms"]
                                                 for m in st["groups"]))
            assert st["tail_ms"] >= 0
        # the profiled steps' phase ranges
        assert len(rec["phases"]) == worker.ARMED_STEPS - 1
        for phases in rec["phases"]:
            if name in ("rs_opt_ag", "rs_fwd_ag"):
                assert phases == [
                    step_mod.FORWARD_SPAN, step_mod.BACKWARD_SPAN,
                    step_mod.UPDATE_SPAN, step_mod.REDUCE_SPAN,
                    step_mod.UPDATE_SPAN]
            else:
                assert phases == list(PHASES)


@pytest.mark.parametrize("name", worker.OPS)
def test_verifier_and_zero_sync_hold_with_the_recorder_armed(two_ranks,
                                                             name):
    for out in two_ranks:
        assert out[name]["findings"] == [], out[name]["findings"]
        assert out[name]["syncs"] == []


def test_ring_keeps_the_last_steps():
    with spans.recording():
        for i in range(spans.RING + 6):
            rec = spans.begin_step(False)
            rec.start = rec.backward_end = 0.0
            rec.ready[0] = rec.done[0] = i / 1e3
            spans.end_step(rec)
    readings = spans.recent_steps()
    assert len(readings) == spans.RING
    assert [r["groups"][0]["ready_ms"] for r in readings] == [
        pytest.approx(float(i)) for i in range(6, spans.RING + 6)]
    assert len(spans.recent_steps(3)) == 3
    assert spans.recent_steps(0) == []
    assert len(spans.recent_steps(10 * spans.RING)) == spans.RING


def test_reading_and_group_medians_of_known_marks():
    recs = []
    with spans.recording():
        for tail in (0.004, 0.001, -0.002):
            rec = spans.begin_step(False)
            rec.start = 10.0
            rec.backward_end = 10.010
            rec.ready[1] = 10.002
            rec.done[1] = 10.005
            rec.ready[0] = 10.008
            rec.done[0] = 10.010 + tail
            spans.end_step(rec)
            recs.append(rec)
    readings = spans.recent_steps()
    assert [g["group"] for g in readings[0]["groups"]] == [1, 0]
    assert readings[0]["groups"][0]["ready_ms"] == pytest.approx(-8.0)
    assert readings[0]["groups"][0]["done_ms"] == pytest.approx(-5.0)
    assert [r["tail_ms"] for r in readings] == [
        pytest.approx(4.0), pytest.approx(1.0), 0.0]
    rows, tail = spans.group_medians(readings)
    assert tail == pytest.approx(1.0)
    assert rows[1] == {"ready_to_done_ms": pytest.approx(3.0),
                       "after_backward_ms": 0.0}
    assert rows[0]["ready_to_done_ms"] == pytest.approx(
        statistics.median([6.0, 3.0, 0.0]))
    assert rows[0]["after_backward_ms"] == pytest.approx(1.0)


def test_setup_spans_add_up():
    setup = spans.SetupSpans()
    for _ in range(2):
        with setup.span("setup.model"):
            time.sleep(0.002)
    with setup.span("setup.data"):
        pass
    secs = setup.seconds()
    assert list(secs) == ["setup.model", "setup.data"]
    assert secs["setup.model"] >= 0.004
    assert spans.setup_seconds() == {}
    setup.publish()
    assert spans.setup_seconds() == secs


def test_trainer_logs_its_setup_spans(tmp_path):
    cfg = make_config("lenet", batch_size=4, num_batches_per_epoch=2,
                      max_epochs=1, logdir=str(tmp_path), checkpoint_dir=None,
                      seed=5, augment=False)
    t = Trainer(cfg, device="cpu", synthetic_data=True,
                profile_backward=False)
    try:
        secs = spans.setup_seconds()
        log = os.path.join(str(tmp_path), cfg.tag(), "train.log")
    finally:
        t.close()
    # one worker: no broadcast
    assert list(secs) == ["setup.model", "setup.data", "setup.optimizer",
                          "setup.reducer", "setup.train_step"]
    assert all(v >= 0 for v in secs.values())
    with open(log) as f:
        lines = [ln for ln in f if "set-up: setup.model" in ln]
    assert len(lines) == 1 and "Trainer.__init__" in lines[0]


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 2])
def test_armed_steps_equal_unarmed_bit_for_bit_over_nccl(tmp_path, world):
    """``world`` ranks, each on its own card, over NCCL
    (tests/torch_spans_worker.py, ``_card_cases``; one rank still runs
    every collective on NCCL's stream), every lowering: an armed copy of
    the step, whose observer stream waits for each group's collectives
    while NaN-filled tensors are allocated before the step's own waits,
    gives the same
    metrics at every step and the same parameters as a copy never armed,
    bit for bit; and each armed step marks every merge group once, with
    CUDA events, done >= ready."""
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA card(s): the observer stream's "
                    "waits exist only over NCCL")
    for out in worker.run_ranks(world, str(tmp_path), backend="nccl"):
        for name in worker.OPS:
            rec = out[name]
            assert all(rec["metrics_equal"]) and rec["params_equal"], name
            assert len(rec["steps"]) == worker.ARMED_STEPS + 1
            for st in rec["steps"]:
                assert st["cuda"]
                # the first step after attach() launches in index order,
                # the later ones along the measured sequence
                assert sorted(m["group"] for m in st["groups"]) == \
                    list(range(rec["groups"]))
                assert all(m["done_ms"] >= m["ready_ms"]
                           for m in st["groups"]), name
                assert st["tail_ms"] >= 0
            assert [m["group"] for m in rec["steps"][-1]["groups"]] == \
                rec["launch_sequence"]
