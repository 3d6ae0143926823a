"""The port's measuring tools (``mgwfbp_tpu_torch/tools/{overlap_report,
gamma_sensitivity,policy_grid,scaling_efficiency,two_level_validation,
input_bench,mfu_ablation,chip_sequence}.py``) against the JAX package's
``tools/`` scripts of the same names, run in-process on the conftest's
8-device CPU mesh with the timings fed in, so that what is compared is
deterministic:

  * ``summarize_overlap`` on one synthetic event list, written once as the
    JAX profiler's trace directory and once as torch.profiler's Chrome
    trace: the same rows and summary (exact); the port's own reading of a
    torch trace (NCCL kernels, copies, record_function spans on a stream,
    the launch order) on its own;
  * ``gamma_sensitivity``: one tb fed to both packages' ``measure_tb`` and
    ``profiles/cpu_family.json`` (read only) at 8 workers: every scale's
    choice, group hash, time and regret, the flips (exact);
  * ``policy_grid``: each policy's solved groups and predicted non-overlap
    from one tb (groups exact, times within 1e-12 relative), and the sign
    test's p over a grid of (k, n) (exact);
  * ``scaling_efficiency``: the ``predicted_targets`` section from one tb
    and t1 at the JAX tool's targets, v5e-4 among them (exact);
  * ``two_level_validation``: the composition's fits, rows and gaps from
    one set of timings (within 1e-12 relative), and
    ``auto_groups_two_level``'s nested partitions of the tool's synthetic
    layers (exact);
  * ``input_bench``: ``make_data``'s files byte-equal to the JAX tool's at
    ``imagenet_n`` 16 (both packages' ``synthetic_images_hard`` replaced
    by one cheap generator, since the generators' own bytes are held
    separately, at full CIFAR size in blocks), and ``create_hdf5``
    byte-equal;
  * ``mfu_ablation``: the uint8 wrapper's logits equal (exactly) the
    model's on the same images normalised by hand in bfloat16;
  * ``chip_sequence``: with its commands replaced, the order, the
    timeouts, and a failed or timed-out leg not stopping the next.

And: every port tool exits 0 with JAX refused (``tools.nojax``) at tiny
arguments (LeNet, batch 4, 1-3 iterations), ``two_level_validation`` at
two gloo processes; every JAX tool under the same refusal fails; asked
for the card where there is none, a port tool fails. No test takes a JAX
behaviour that fails today as its oracle (ROADMAP Queue 3, "Baseline").
"""

import filecmp
import gzip
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import gamma_sensitivity as jax_gamma
import input_bench as jax_input_bench
import overlap_report as jax_overlap
import policy_grid as jax_policy_grid
import scaling_efficiency as jax_scaling
import two_level_validation as jax_two_level
from mgwfbp_tpu_torch.data.loader import ArrayDataset
from mgwfbp_tpu_torch.tools import (
    chip_sequence,
    gamma_sensitivity,
    input_bench,
    mfu_ablation,
    nojax,
    overlap_report,
    policy_grid,
    scaling_efficiency,
    two_level_validation,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_FAMILY = os.path.join(ROOT, "profiles", "cpu_family.json")
REL = 1e-12  # where the port sums in another order


def _close(a, b) -> bool:
    return math.isclose(a, b, rel_tol=REL, abs_tol=0.0) or a == b


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group: the port's reducers run over a group."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


# --------------------------------------------------------------------------
# overlap_report
# --------------------------------------------------------------------------

def _meta(pid, name):
    return {"ph": "M", "name": "process_name", "pid": pid,
            "args": {"name": name}}


def _x(name, ts, dur, pid=7, cat="kernel", **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": 3,
            "ts": ts, "dur": dur, "args": args}


NCCL_AR = "ncclDevKernel_AllReduce_Sum_f32_RING_LL"
EVENTS = [
    _meta(7, "/device:GPU:0 stream"), _meta(1234, "python3 host"),
    _x("sm90_xmma_gemm_bf16bf16", 0, 50), _x("cudnn::conv_fwd", 40, 30),
    _x(NCCL_AR, 45, 60), _x("copy_kernel", 60, 20),
    _x("elementwise_kernel", 120, 10), _x("bn_bw_kernel", 200, 40),
    _x(NCCL_AR, 190, 20), _x(NCCL_AR, 300, 5),
    _x("aten::conv2d", 0, 500, pid=1234, cat="cpu_op"),
]


def test_summarize_overlap_reads_both_profilers_traces_alike(tmp_path):
    run = tmp_path / "jax" / "plugins" / "profile" / "run1"
    run.mkdir(parents=True)
    with gzip.open(run / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": EVENTS}, f)
    torch_trace = tmp_path / "trace.json"
    torch_trace.write_text(json.dumps({"traceEvents": EVENTS}))
    want = jax_overlap.summarize_overlap(str(tmp_path / "jax"))
    got = overlap_report.summarize_overlap(str(torch_trace))
    assert want["n_collective_events"] == 3
    assert {k: got[k] for k in want} == want
    assert got["n_compute_events"] == 4 and got["compute_us"] == 130
    # a directory of either layout reads the same
    assert overlap_report.summarize_overlap(str(tmp_path / "jax")) == got


def test_a_torch_trace_is_read_by_its_own_lanes(tmp_path):
    """NCCL kernels without a JAX marker are collectives; a copy's category,
    a record_function span drawn on the stream and host operators are not
    compute; the launch order follows the correlation ids."""
    events = [
        _x("mgwfbp_group0000", 0, 1000, cat="gpu_user_annotation"),
        _x("ncclDevKernel_ReduceScatter_Sum_f32_RING_LL", 10, 40,
           correlation=5),
        _x("Memcpy DtoD (Device -> Device)", 10, 40, cat="gpu_memcpy",
           correlation=2),
        _x("conv_kernel", 30, 40, correlation=1),
        _x("gemm_kernel", 100, 10, correlation=7),
        _x(NCCL_AR, 200, 10, correlation=9),
        _x("aten::addmm", 0, 900, pid=1234, cat="cpu_op"),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = overlap_report.summarize_overlap(str(path))
    assert [r["name"] for r in got["collectives"]] == [
        "ncclDevKernel_ReduceScatter_Sum_f32_RING_LL", NCCL_AR]
    assert got["collectives"][0]["concurrent_compute_us"] == 20
    assert got["n_compute_events"] == 2
    order = overlap_report.launch_order_report(str(path))
    assert [r["compute_ops_since_prev"] for r in order["collectives"]] == [
        1, 1]
    assert order["collectives_with_compute_interleaved_before"] == 1
    assert order["compute_ops_scheduled_after_first_collective"] == 1


# --------------------------------------------------------------------------
# gamma_sensitivity
# --------------------------------------------------------------------------

def _tb(n, seed=0, lo=1e-5, hi=4e-4):
    return list(np.random.RandomState(seed).uniform(lo, hi, n))


def _jax_shapes(name):
    """The JAX model's parameter tree as shapes (no initialisation run)."""
    import jax
    import jax.numpy as jnp

    from mgwfbp_tpu import models as jax_models

    model, meta = jax_models.create_model(name)
    return jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *meta.input_shape)),
        train=False))["params"]


def test_gamma_sensitivity_matches_the_jax_tool(monkeypatch):
    from types import SimpleNamespace

    tb = _tb(65)  # ResNet-20's leaves
    params = _jax_shapes("resnet20")
    # the JAX tool's state only feeds its measure_tb (replaced) and its
    # leaves' sizes: shapes stand in for the initialised parameters
    monkeypatch.setattr(
        "mgwfbp_tpu.train.create_train_state",
        lambda *a, **k: SimpleNamespace(params=params, batch_stats=None))
    monkeypatch.setattr(jax_overlap, "measure_tb", lambda *a, **k: list(tb))
    monkeypatch.setattr(overlap_report, "measure_tb",
                        lambda *a, **k: list(tb))
    # the JAX tool resolves the profile at its 8 devices
    monkeypatch.setattr("mgwfbp_tpu_torch.parallel.mesh.world_size",
                        lambda: 8)
    want = jax_gamma.analyze_model("resnet20", 8, CPU_FAMILY)
    got = gamma_sensitivity.analyze_model("resnet20", 8, CPU_FAMILY,
                                          device="cpu")
    for key in ("n_devices", "gamma_nominal", "overlap", "pack_beta",
                "tb_total_s", "by_scale", "schedule_flips_at",
                "max_regret_frac"):
        assert got[key] == want[key], key
    assert len(got["groups_at_1.0"]) == want["by_scale"]["1.0"]["num_groups"]


# --------------------------------------------------------------------------
# policy_grid
# --------------------------------------------------------------------------

def test_policy_grid_solves_each_policy_as_the_jax_tool(one_rank):
    """The JAX tool's ``_build_setup`` solves with ``make_merged_allreduce``
    on its parameters (shapes here) at its device count's ``ici`` prior;
    the port's grid with ``_Grid.build_step`` on one tb for every policy."""
    from mgwfbp_tpu.parallel import costmodel as jcm
    from mgwfbp_tpu.parallel.allreduce import (
        make_merged_allreduce as jax_merged,
    )
    from mgwfbp_tpu_torch.bench import _Grid
    from mgwfbp_tpu_torch.parallel.costmodel import lookup_alpha_beta

    tb = _tb(10, seed=1, lo=1e-6, hi=3e-5)  # LeNet's leaves
    params = _jax_shapes("lenet")
    grid = _Grid("lenet", 4, 1, torch.device("cpu"), None,
                 lookup_alpha_beta("ici", 8))  # the JAX tool's at 8
    for policy in jax_policy_grid.POLICIES + ("threshold:2000",):
        _, red = grid.build_step(policy, tb)
        if policy == "none":
            assert red is None
            continue
        base, _, th = policy.partition(":")
        jred = jax_merged(params, axis_name="data", policy=base, tb=tb,
                          cost_model=jcm.lookup_alpha_beta("ici", 8),
                          threshold=int(th or 0))
        got = policy_grid.schedule_fields(red)
        assert [list(g) for g in red.schedule.groups] == [
            list(g) for g in jred.schedule.groups], policy
        assert got["merge_groups"] == jred.schedule.num_groups
        assert _close(got["predicted_nonoverlap_s"],
                      jred.schedule.predicted_nonoverlap_time), policy
        assert _close(got["predicted_total_s"],
                      jred.schedule.predicted_total_time), policy
        red.detach()


@pytest.mark.parametrize("n", [1, 3, 5, 8])
def test_sign_test_p_is_the_jax_tools(n):
    for k in range(n + 1):
        want = jax_policy_grid._binom_tail_p(k, n)
        assert policy_grid._binom_tail_p(k, n) == want


def test_verdicts_name_the_fastest_and_the_noise(one_rank):
    windows = {"mgwfbp": [0.010, 0.011, 0.010], "wfbp": [0.020, 0.021, 0.02],
               "single": [0.012, 0.012, 0.013],
               "single#control": [0.0121, 0.0112, 0.0129]}
    results = {p: {"sec_per_iter": min(w), "predicted_total_s": None}
               for p, w in windows.items()}
    out = policy_grid.verdicts(windows, results, tuple(windows))
    c = out["conclusion"]
    assert c["fastest_by_median"] == "mgwfbp"
    assert c["consistent_losers_sign_test"] == ["wfbp", "single"]
    assert "wfbp" in c["beats_outside_noise"]
    assert out["paired_deltas_vs_fastest"]["wfbp-vs-mgwfbp"][
        "sign_test_p"] == 0.125


# --------------------------------------------------------------------------
# scaling_efficiency
# --------------------------------------------------------------------------

def test_scaling_predictions_match_the_jax_tool(monkeypatch):
    from types import SimpleNamespace

    from mgwfbp_tpu_torch.bench import make_model

    tb, t1 = _tb(10, seed=2, lo=1e-6, hi=3e-5), 0.0125
    params = _jax_shapes("lenet")
    monkeypatch.setattr(
        "mgwfbp_tpu.train.create_train_state",
        lambda *a, **k: SimpleNamespace(params=params, batch_stats=None))
    monkeypatch.setattr("mgwfbp_tpu.profiling.benchmark_trainer_backward",
                        lambda *a, **k: list(tb))
    monkeypatch.setattr(jax_scaling, "_measure_step", lambda *a, **k: t1)
    targets = list(scaling_efficiency.TPU_TARGETS)
    want = jax_scaling.run("lenet", 4, "mgwfbp", None, targets, 3, 1,
                           "float32")
    model, _ = make_model("lenet", "cpu")
    got = scaling_efficiency.predicted_targets(
        overlap_report.arrival_layers(model, 4), tb, t1,
        scaling_efficiency.target_costs(targets, None))
    assert "v5e-4" in got
    assert got == want["predicted_targets"]


def test_scaling_targets_default_to_the_profiles_extents():
    from mgwfbp_tpu_torch.parallel.costmodel import load_profile

    family = load_profile(CPU_FAMILY)
    with open(CPU_FAMILY) as f:
        kind = json.load(f)["meta"].get("device_kind", "profile")
    costs = scaling_efficiency.target_costs([], CPU_FAMILY)
    assert sorted(costs) == sorted(f"{kind} x{n}" for n in family.entries)
    assert sorted(n for _, n in costs.values()) == sorted(family.entries)
    with pytest.raises(ValueError):
        scaling_efficiency.target_costs(["tpu-v9"], CPU_FAMILY)


# --------------------------------------------------------------------------
# two_level_validation
# --------------------------------------------------------------------------

def _two_level_timings():
    nbytes = [2 ** k * 4 for k in range(8, 12)]
    t = {name: {b: scale * (1 + b / 4096) for b in nbytes}
         for name, scale in (("ici", 2e-5), ("dcn", 7e-5), ("noop", 4e-6),
                             ("hier", 1.1e-4), ("flat", 8e-5))}
    return nbytes, t


def test_two_level_composition_matches_the_jax_tool(monkeypatch):
    import jax
    from jax.sharding import Mesh

    from mgwfbp_tpu.parallel import costmodel as jcm
    from mgwfbp_tpu_torch.parallel import costmodel as pcm

    nbytes, t = _two_level_timings()
    ici, dcn = 2, 2

    def sampled(cm, name):
        times = [t[name][b] for b in nbytes]
        return cm.SampledCost(tuple(nbytes), tuple(times),
                              ab=cm.fit_alpha_beta(nbytes, times))

    def model(cm):
        return cm.TwoLevelAlphaBeta(ici=sampled(cm, "ici"),
                                    dcn=sampled(cm, "dcn"), ici_size=ici,
                                    dcn_size=dcn)

    jmodel = model(jcm)
    fit = {k: {"alpha": getattr(jmodel, k).ab.alpha,
               "beta": getattr(jmodel, k).ab.beta} for k in ("ici", "dcn")}
    mesh = Mesh(np.array(jax.devices()[:ici * dcn]).reshape(ici, dcn),
                ("ici", "dcn"))
    raw = {"mesh": mesh, "inner_axis": "ici", "outer_axis": "dcn",
           "ici_s": t["ici"], "dcn_s": t["dcn"], "noop_s": t["noop"],
           "sizes_bytes": nbytes, "fit": fit}
    monkeypatch.setattr("mgwfbp_tpu.profiling.profile_two_level",
                        lambda *a, **k: (jmodel, raw))
    calls = []

    def fake_time(fn, x, warmup, iters):  # flat at every payload, then hier
        calls.append(x.size * 4)
        return t["flat" if len(calls) <= len(nbytes) else "hier"][
            x.size * 4]

    monkeypatch.setattr(jax_two_level, "_time_fn", fake_time)
    monkeypatch.setattr(jax_two_level, "_solved_schedule_check",
                        lambda *a, **k: {})
    _, want = jax_two_level.run(ici, dcn, 8, 11, 1, 1)
    pmodel = model(pcm)
    assert {k: {"alpha": getattr(pmodel, k).ab.alpha,
                "beta": getattr(pmodel, k).ab.beta}
            for k in ("ici", "dcn")} == want["fit"]
    got = two_level_validation.composition(
        nbytes, t["ici"], t["dcn"], t["noop"], t["hier"], t["flat"], pmodel,
        ici, dcn)
    for gr, wr in zip(got["rows"], want["rows"], strict=True):
        assert gr.keys() == wr.keys()
        assert all(_close(gr[k], wr[k]) for k in gr), (gr, wr)
    for key in got:
        if key != "rows":
            assert _close(got[key], want[key]), key


def test_the_nested_partitions_match_the_jax_solver():
    from mgwfbp_tpu.parallel import costmodel as jcm
    from mgwfbp_tpu.parallel.solver import (
        auto_groups_two_level as jax_auto2,
    )
    from mgwfbp_tpu_torch.parallel import costmodel as pcm
    from mgwfbp_tpu_torch.parallel.solver import auto_groups_two_level

    sizes, names = two_level_validation.solved_layers()
    assert sizes == [int(s) for s in np.random.RandomState(0).choice(
        [1 << 14, 1 << 16, 1 << 18], size=12)]
    for dcn_alpha in (5e-5, 5e-3):
        models = [cm.TwoLevelAlphaBeta(
            ici=cm.AlphaBeta(alpha=2e-5, beta=1e-10, gamma=1e-5),
            dcn=cm.AlphaBeta(alpha=dcn_alpha, beta=2e-9), ici_size=4,
            dcn_size=2) for cm in (jcm, pcm)]
        tb_total = models[0].predict(float(sum(sizes)) * 4)
        tb = [tb_total * s / sum(sizes) for s in sizes]
        want = jax_auto2(sizes, tb, models[0])
        got = auto_groups_two_level(sizes, tb, models[1])
        assert [list(map(list, x)) if isinstance(x, (list, tuple)) else x
                for x in got] == [list(map(list, x))
                                  if isinstance(x, (list, tuple)) else x
                                  for x in want]


# --------------------------------------------------------------------------
# input_bench and the generator
# --------------------------------------------------------------------------

def _cheap_images(n, hwc, num_classes, seed=0):
    rng = np.random.RandomState(seed)
    return ArrayDataset(
        data=rng.randint(0, 256, size=(n,) + tuple(hwc), dtype=np.uint8),
        labels=rng.randint(0, num_classes, size=n).astype(np.int32),
        num_classes=num_classes)


def test_make_data_writes_the_jax_tools_bytes(tmp_path, monkeypatch):
    monkeypatch.setattr("mgwfbp_tpu.data.datasets.synthetic_images_hard",
                        _cheap_images)
    monkeypatch.setattr(
        "mgwfbp_tpu_torch.data.datasets.synthetic_images_hard", _cheap_images)
    want = jax_input_bench.make_data(str(tmp_path / "jax"), imagenet_n=16)
    got = input_bench.make_data(str(tmp_path / "port"), imagenet_n=16)
    assert got["legs"] == {"cifar10": "ok", "imagenet_hdf5": "ok"}
    names = [os.path.join("cifar-10-batches-py", f"data_batch_{i}")
             for i in range(1, 6)] + [
        os.path.join("cifar-10-batches-py", "test_batch"), "imagenet.hdf5"]
    for name in names:
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "port" / name,
                           shallow=False), name
    assert os.path.basename(want["imagenet_hdf5"]) == os.path.basename(
        got["imagenet_hdf5"])


def test_create_hdf5_writes_the_jax_functions_bytes(tmp_path):
    from mgwfbp_tpu.data.datasets import create_hdf5 as jax_create_hdf5
    from mgwfbp_tpu_torch.data.datasets import create_hdf5

    tr, va = _cheap_images(12, (16, 16, 3), 7, 1), _cheap_images(
        5, (16, 16, 3), 7, 2)
    args = (tr.data, tr.labels, va.data, va.labels)
    jax_create_hdf5(*args, str(tmp_path / "a.hdf5"))
    create_hdf5(*args, str(tmp_path / "b.hdf5"))
    assert filecmp.cmp(tmp_path / "a.hdf5", tmp_path / "b.hdf5",
                       shallow=False)


def test_the_hdf5_leg_names_h5py_where_it_is_missing(tmp_path, monkeypatch):
    monkeypatch.setattr(
        "mgwfbp_tpu_torch.data.datasets.synthetic_images_hard", _cheap_images)
    monkeypatch.setitem(sys.modules, "h5py", None)
    got = input_bench.make_data(str(tmp_path), imagenet_n=16)
    assert got["legs"]["cifar10"] == "ok"
    assert "h5py" in got["legs"]["imagenet_hdf5"]
    assert not os.path.exists(tmp_path / "imagenet.hdf5")


@pytest.mark.parametrize("args", [
    (1500, (32, 32, 3), 10, 0),  # three blocks of samples
    (4, (64, 64, 3), 1000, 2),  # 1000 classes, few of them upsampled
])
def test_the_generator_keeps_the_jax_packages_bytes(args):
    from mgwfbp_tpu.data.datasets import synthetic_images_hard as jax_hard
    from mgwfbp_tpu_torch.data.datasets import synthetic_images_hard

    a, b = synthetic_images_hard(*args), jax_hard(*args)
    assert np.array_equal(a.data, b.data)
    assert np.array_equal(a.labels, b.labels)


# --------------------------------------------------------------------------
# mfu_ablation
# --------------------------------------------------------------------------

def test_the_uint8_wrapper_normalises_on_the_device_in_bfloat16():
    from mgwfbp_tpu_torch.bench import make_model
    from mgwfbp_tpu_torch.train.step import model_forward

    model, _ = make_model("lenet", "cpu")
    model.eval()
    x = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (4, 1, 28, 28)).astype(np.uint8))
    bf = torch.bfloat16
    by_hand = (x.to(bf) * torch.tensor(1 / 255, dtype=bf)
               - torch.tensor(0.45, dtype=bf)) * torch.tensor(1 / 0.225,
                                                              dtype=bf)
    want = model_forward(model, by_hand, None, bf)
    got = model_forward(mfu_ablation.uint8_normalize(model), x, None, bf)
    assert torch.equal(got, want)


def test_the_rows_are_the_jax_tools_at_128():
    assert list(mfu_ablation.row_names(128)) == [
        "baseline_b128", "batch_64", "batch_256", "uint8_input_b128",
        "bf16_batchstats_b128"]


# --------------------------------------------------------------------------
# chip_sequence
# --------------------------------------------------------------------------

def test_chip_sequence_runs_every_leg_in_order(tmp_path, monkeypatch,
                                               capsys):
    py = sys.executable
    plan = [("first", [py, "-c", "print('one')"], 30.0, {}),
            ("fails", [py, "-c", "import sys; sys.exit(3)"], 30.0, {}),
            ("hangs", [py, "-c", "import time; time.sleep(30)"], 0.5, {}),
            ("last", [py, "-c", "import os; print(os.environ['LEG'])"], 30.0,
             {"LEG": "env"})]
    monkeypatch.setattr(chip_sequence, "legs", lambda logdir, device: plan)
    rc = chip_sequence.main([str(tmp_path)])
    out = capsys.readouterr().out
    res = json.loads(out.strip().splitlines()[-1])["chip_sequence"]
    assert rc == 1
    assert [(r["leg"], r["rc"]) for r in res] == [
        ("first", 0), ("fails", 3), ("hangs", 124), ("last", 0)]
    assert res[2]["seconds"] < 10
    assert (tmp_path / "last.out").read_text().strip() == "env"
    assert (tmp_path / "first.out").read_text().strip() == "one"
    starts = [ln for ln in out.splitlines() if "] leg " in ln]
    assert [ln.split("] ", 1)[1] for ln in starts] == [
        "leg 1/4: first", "leg 2/4: fails", "leg 3/4: hangs",
        "leg 4/4: last"]


def test_chip_sequence_legs_are_the_jax_scripts():
    plan = chip_sequence.legs("L", "cuda")
    assert [(n, t) for n, _, t, _ in plan] == [
        ("calibrate", 2400.0), ("bench", 2400.0), ("mfu_ablation", 3600.0),
        ("an4_memcheck", 7200.0)]
    env = {n: e for n, _, _, e in plan}
    assert env["bench"]["MGWFBP_BENCH_PROFILE"] == os.path.join(
        "L", "profile.json")
    assert env["an4_memcheck"] == {"MGWFBP_WATCHDOG_S": "900"}
    an4 = plan[3][1]
    assert an4[an4.index("--data-dir") + 1] == "data/an4_memcheck"
    assert an4[an4.index("--max-epochs") + 1] == "300"


# --------------------------------------------------------------------------
# with JAX refused
# --------------------------------------------------------------------------

TINY = ["--model", "lenet", "--batch", "4", "--device", "cpu"]
NOJAX_CASES = {
    "overlap_report": TINY + ["--steps", "1"],
    "overlap_report#hlo": TINY + ["--mode", "hlo"],
    "gamma_sensitivity": ["--models", "lenet", "--batch", "4", "--device",
                          "cpu", "--comm-profile", CPU_FAMILY],
    "policy_grid": TINY + ["--iters", "2", "--warmup", "1", "--rounds", "2"],
    "scaling_efficiency": TINY + ["--iters", "3", "--warmup", "1",
                                  "--comm-profile", CPU_FAMILY],
    "input_bench": ["--model", "lenet", "--data-dir", "{tmp}", "--iters",
                    "2", "--warmup", "1", "--device", "cpu"],
    "mfu_ablation": ["--model", "lenet", "--batch", "4", "--iters", "1",
                     "--device", "cpu"],
    "chip_sequence": ["{tmp}/seq", "--dry-run"],
}
_RUNNER = """
import json, runpy, sys
from mgwfbp_tpu_torch.tools import nojax
nojax.refuse()
results = {}
for case, argv in json.loads(sys.argv[1]):
    module = "mgwfbp_tpu_torch.tools." + case.split("#")[0]
    sys.argv = [module, *argv]
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
        rc = 0
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else int(e.code is not None)
    except Exception as e:  # noqa: BLE001 — reported, the next case runs
        rc = repr(e)
    results[case] = rc
print("RESULTS " + json.dumps(results), flush=True)
"""


@pytest.fixture(scope="module")
def nojax_results(tmp_path_factory):
    """Every case of NOJAX_CASES in one process with JAX refused (one
    torch import for all of them); {case: rc}."""
    tmp = str(tmp_path_factory.mktemp("nojax"))
    cases = [(c, [a.replace("{tmp}", tmp) for a in argv])
             for c, argv in NOJAX_CASES.items()]
    res = subprocess.run(
        [sys.executable, "-c", _RUNNER, json.dumps(cases)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2"))
    lines = [ln for ln in res.stdout.splitlines()
             if ln.startswith("RESULTS ")]
    assert lines, res.stderr[-3000:]
    return json.loads(lines[-1][len("RESULTS "):]), res.stderr


@pytest.mark.parametrize("case", sorted(NOJAX_CASES))
def test_port_tool_runs_with_jax_refused(nojax_results, case):
    results, err = nojax_results
    assert results[case] == 0, err[-3000:]


def test_two_level_validation_runs_at_two_processes(tmp_path):
    from mgwfbp_tpu_torch.runtime.supervisor import free_port

    port = free_port()
    out = tmp_path / "two.json"
    args = nojax.argv("mgwfbp_tpu_torch.tools.two_level_validation",
                      "--ici", "1", "--dcn", "2", "--min-log2", "8",
                      "--max-log2", "9", "--warmup", "1", "--iters", "1",
                      "--device", "cpu", "--out", str(out))
    procs = [subprocess.Popen(
        args, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                           MGWFBP_COORDINATOR=f"127.0.0.1:{port}",
                           MGWFBP_NUM_PROCESSES="2",
                           MGWFBP_PROCESS_ID=str(r))) for r in range(2)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs[0][1][-3000:]
    report = json.loads(outs[0][0])
    assert report["mesh"] == {"ici": 1, "dcn": 2}
    assert len(report["rows"]) == 2
    assert outs[1][0] == ""  # rank 0 writes
    meta = json.loads(out.read_text())["meta"]
    assert meta["solved_schedule"]["hier"]["groups"]


JAX_TOOLS = ("overlap_report", "gamma_sensitivity", "policy_grid",
             "scaling_efficiency", "two_level_validation", "input_bench",
             "mfu_ablation")


def test_the_jax_tools_fail_under_the_refusal(tmp_path):
    runner = """
import runpy, sys
from mgwfbp_tpu_torch.tools import nojax
nojax.refuse()
tmp, names = sys.argv[1], sys.argv[2:]
for name in names:
    sys.argv = [name]
    if name == "input_bench":
        sys.argv += ["--make-data", "--data-dir", tmp]
    try:
        runpy.run_module(name, run_name="__main__", alter_sys=True)
        print(name, "ran")
    except SystemExit as e:
        print(name, "exit", e.code)
    except ImportError as e:
        print(name, "refused", e.name)
"""
    res = subprocess.run(
        [sys.executable, "-c", runner, str(tmp_path), *JAX_TOOLS],
        capture_output=True, text=True, timeout=120, cwd=ROOT, env=dict(
            os.environ, PYTHONPATH=os.pathsep.join(
                [ROOT, os.path.join(ROOT, "tools")])))
    lines = dict(ln.split(" ", 1) for ln in res.stdout.splitlines())
    assert set(lines) == set(JAX_TOOLS), res.stderr[-2000:]
    for name in JAX_TOOLS:
        assert lines[name].startswith("refused"), (name, lines[name])


@pytest.mark.parametrize("module", [
    overlap_report, gamma_sensitivity, policy_grid, scaling_efficiency,
    two_level_validation, mfu_ablation])
def test_a_port_tool_asked_for_the_card_fails_without_one(module):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    argv = {gamma_sensitivity: ["--comm-profile", CPU_FAMILY]}.get(module, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)


def test_input_bench_asked_for_the_card_fails_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        input_bench.main(["--data-dir", str(tmp_path)])
