"""The readers of the program's spans: the phase idle times on a small
synthetic Chrome trace, the communication tail and the reducer's set-up
seconds on a synthetic span recorder, None where the program has no
recorder or the trace no phase range, and a traced run on the CPU that
reports the phase idle times once a cell lists them."""

import json
import os
import subprocess
import sys
import types

import pytest

from benchmark import spec, trace
from conftest import SMALL, copy_benchmark, add_small_cells
from test_benchmark_readers import ev


def read(name, ctx):
    return spec.metric_reader(name)(ctx)


def phase_events():
    """Two profiled steps (host ranges at 100 and 1,100 us): per step a
    forward range of 290 us holding a 100 us kernel, a backward range of
    400 us holding a 300 us kernel, then reduce and update ranges with no
    kernel; a forward range of the step before the first is left out, as
    is one on another thread."""
    out = [ev("user_annotation", "train_step.forward", 0, 50),
           ev("user_annotation", "train_step.forward", 150, 100, tid=2)]
    for t0 in (100, 1100):
        out += [
            ev("user_annotation", trace.STEP, t0, 900),
            ev("user_annotation", "train_step.forward", t0 + 10, 290),
            ev("kernel", "sm90_xmma_fprop", t0 + 100, 100, tid=7),
            ev("user_annotation", "train_step.backward", t0 + 300, 400),
            ev("kernel", "sm90_xmma_dgrad", t0 + 350, 300, tid=7),
            ev("user_annotation", "train_step.reduce", t0 + 700, 50),
            ev("user_annotation", "train_step.update", t0 + 750, 140),
        ]
    return out


@pytest.fixture
def ctx():
    return types.SimpleNamespace(trace=trace.TraceView(phase_events()))


def test_phase_idle_under_the_forward_and_backward_ranges(ctx):
    assert ctx.trace.steps == 2
    assert read("forward_idle_ms.host_paced", ctx) == pytest.approx(0.190)
    assert read("backward_idle_ms.host_paced", ctx) == pytest.approx(0.100)


def test_phase_idle_without_phase_ranges_is_none(ctx):
    ctx.trace = trace.TraceView([e for e in phase_events()
                                 if not e["name"].startswith("train_step")])
    assert read("forward_idle_ms.host_paced", ctx) is None
    assert read("backward_idle_ms.host_paced", ctx) is None
    ctx.trace = None
    assert read("forward_idle_ms.host_paced", ctx) is None


@pytest.fixture
def recorder():
    from mgwfbp_tpu_torch.telemetry import spans

    spans.clear()
    yield spans
    spans.clear()


def mark_steps(spans, tails_ms):
    """One armed step per tail: B at 10 ms, two groups, the later done
    ``tail`` ms after B (host-clock marks, as over gloo)."""
    with spans.recording():
        for tail in tails_ms:
            rec = spans.begin_step(False)
            rec.start, rec.backward_end = 0.0, 0.010
            rec.ready[1], rec.done[1] = 0.004, 0.006
            rec.ready[0], rec.done[0] = 0.009, 0.010 + tail / 1e3
            spans.end_step(rec)


def test_comm_tail_is_the_median_of_the_last_profiled_steps(ctx, recorder):
    mark_steps(recorder, [50.0, 3.0, -1.0])
    # the last two of three armed steps: tails 3 and 0
    assert read("comm_tail_ms", ctx) == pytest.approx(1.5)
    ctx.trace = None
    assert read("comm_tail_ms", ctx) is None


def test_comm_tail_without_groups_is_none(ctx, recorder):
    assert read("comm_tail_ms", ctx) is None
    with recorder.recording():
        rec = recorder.begin_step(False)
        rec.backward_end = rec.mark()
        recorder.end_step(rec)
    assert read("comm_tail_ms", ctx) is None


def test_setup_reducer_reads_the_published_setup(ctx, recorder):
    assert read("setup_reducer_s", ctx) is None
    setup = recorder.SetupSpans()
    setup.records.append(("setup.reducer", 1.0, 3.5))
    setup.publish()
    assert read("setup_reducer_s", ctx) == pytest.approx(2.5)


def test_readers_of_a_program_without_spans(ctx, recorder, monkeypatch):
    """The parent's program: no span module to import."""
    import mgwfbp_tpu_torch.telemetry as telemetry

    mark_steps(recorder, [3.0, 3.0])
    monkeypatch.delattr(telemetry, "spans")
    monkeypatch.setitem(sys.modules, "mgwfbp_tpu_torch.telemetry.spans",
                        None)
    assert read("comm_tail_ms", ctx) is None
    assert read("setup_reducer_s", ctx) is None


def test_traced_cpu_run_reports_the_phase_idle(tmp_path):
    """A traced run of the small one-rank cell, listed under both phase
    metrics in a copy: each reads a number (on the CPU no device operation
    runs, so all of a range is idle)."""
    root = copy_benchmark(str(tmp_path / "checkout"))
    add_small_cells(root)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        doc = json.load(f)
    for m in doc["per_layer"]:
        if m["name"].endswith("_idle_ms.host_paced"):
            m["workloads"].append(f"{SMALL}.b8.1rank")
    with open(path, "w") as f:
        json.dump(doc, f)
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", f"{SMALL}.b8.1rank",
         "--seed", "3000000023", "--seconds", "1", "--trace", "1",
         "--device", "cpu"], cwd=root, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    for name in ("forward_idle_ms.host_paced", "backward_idle_ms.host_paced"):
        assert r["metrics"][name]["value"] > 0
    assert all(name != "host idle" for name, _ in r["breakdown"]["idle_gaps"])
