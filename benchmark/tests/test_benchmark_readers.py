"""Each metric reader on a small synthetic Chrome trace and window."""

import json
import types

import pytest

from benchmark import spec, trace
from benchmark.work import resnet as work

PEAK = {"bf16_flops_per_s": 1e12, "hbm_bytes_per_s": 1e9}


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1}


def fixture_events():
    """Two profiled steps of 1,000 us each (host ranges at 100 and 1,100;
    the last kernel ends at 2,100): per step a batch-norm kernel of 200 us,
    a convolution of 300 us (overlapping the NCCL kernel of 100 us on
    another stream), a copy of 50 us, and three launches; a warm-up kernel
    before the first step is left out."""
    out = [ev("kernel", "warmup_kernel", 0, 50)]
    for s, t0 in enumerate((100, 1100)):
        out += [
            ev("user_annotation", trace.STEP, t0, 900),
            ev("cpu_op", "aten::conv2d", t0 + 10, 500),
            ev("cuda_runtime", "cudaLaunchKernel", t0 + 20, 5),
            ev("cuda_runtime", "cudaLaunchKernelExC", t0 + 30, 5),
            ev("cuda_driver", "cuLaunchKernel", t0 + 40, 5),
            ev("cuda_runtime", "cudaMemcpyAsync", t0 + 50, 5),
            ev("kernel", "batch_norm_collect_statistics_kernel", t0 + 100,
               200, tid=7),
            ev("kernel", "sm90_xmma_fprop_implicit_gemm_bf16", t0 + 400,
               300, tid=7),
            ev("kernel", "ncclDevKernel_AllReduce_Sum_f32", t0 + 500, 100,
               tid=9),
            ev("gpu_memcpy", "Memcpy HtoD", t0 + 800, 50, tid=7),
        ]
    out.append(ev("kernel", "late_kernel", 2050, 50, tid=7))
    return out


@pytest.fixture
def ctx(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": fixture_events()}))
    view = trace.TraceView.from_file(str(path))
    config = json.load(open(spec.HERE + "/configs/resnet50.json"))
    return types.SimpleNamespace(
        config=config, traffic={}, work=work, chips=4, world=4, batch=2,
        peak=PEAK, trace=view, family=spec.kernel_family,
        probe={"trainer_s": 0.080, "local_s": 0.070},
        window={"steps": 10, "seconds": 2.0, "images": 80,
                "step_s": [0.1] * 19 + [0.3], "setup_s": 12.5})


def read(name, ctx):
    return spec.metric_reader(name)(ctx)


def test_trace_view(ctx):
    t = ctx.trace
    assert t.steps == 2
    assert t.window_s == pytest.approx(2000e-6)  # 100 .. 2,100
    # per step 200 + 300 (the NCCL kernel inside it) + 50, and the late 50
    assert t.busy_s == pytest.approx((2 * 550 + 50) * 1e-6)
    assert t.launches == 6
    assert t.top_ops(2)[0] == ["sm90_xmma_fprop_implicit_gemm_bf16", 600e-6]
    # the longest: from the first step's copy (ends at 950) to the second
    # step's first kernel (1,200), with no host operation running
    assert t.idle_gaps(1) == [["host idle", pytest.approx(250e-6)]]
    assert t.unclassified(spec.kernel_families())[0][0] == "late_kernel"


def test_device_idle_and_launches(ctx):
    # 575 us busy a profiled step against the window's median step of 1 ms
    ctx.window["step_s"] = [0.001] * 20
    assert read("device_idle_pct", ctx) == pytest.approx(100 * (1 - 0.575))
    assert read("launches_per_step", ctx) == 3


def test_rooflines(ctx):
    bytes_ = work.bn_train_bytes(ctx.config, 2 * 2, 2)
    assert read("norm_roofline", ctx) == pytest.approx(
        100 * bytes_ / 1e9 / 400e-6)
    flops = work.conv_train_flops(ctx.config, 2 * 2)
    assert read("conv_roofline", ctx) == pytest.approx(
        100 * flops / 1e12 / 600e-6)


def test_collectives_and_exposed(ctx):
    assert read("collectives_per_step", ctx) == 1
    assert read("comm_exposed_ms", ctx) == pytest.approx(10.0)


def test_window_metrics(ctx):
    assert read("images_per_s", ctx) == 40
    assert read("step_ms_p95", ctx) == pytest.approx(100.0)  # 19th of 20
    ctx.window["step_s"] = [0.1] * 18 + [0.3] * 2
    assert read("step_ms_p95", ctx) == pytest.approx(300.0)
    assert read("setup_s", ctx) == 12.5
    assert read("mfu_pct", ctx) == pytest.approx(
        100 * work.train_flops(ctx.config, 80) / 2.0 / (1e12 * 4))


def test_readers_find_nothing_to_read(ctx):
    """No trace, no peak or no probe: the reader returns None, never 0."""
    ctx.trace, ctx.peak, ctx.probe = None, None, None
    for name in ("device_idle_pct", "launches_per_step", "norm_roofline",
                 "conv_roofline", "collectives_per_step",
                 "comm_exposed_ms", "mfu_pct"):
        assert read(name, ctx) is None
