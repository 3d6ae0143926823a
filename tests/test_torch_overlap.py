"""Port vs reference: overlap accounting and the traced reducer
(mgwfbp_tpu_torch.telemetry.overlap / parallel.allreduce / profiling vs
mgwfbp_tpu.telemetry.overlap).

  * ``attribute_overlap`` equals the JAX replay on seeded inputs, and
    ``group_comm_times`` and ``summarize`` on a port reducer equal the JAX
    functions on the JAX reducer for the same groups, sizes, tb and
    profile: per-group start_s, comm_s, hidden_s and exposed_s within
    1e-12, with identical record keys;
  * with and without torch.profiler recording, ``MergedAllreduce``
    launches the same groups in the same order with bit-identical reduced
    gradients; while it records, each group's work lies in its
    ``mgwfbp_groupNNNN`` range, and on the CPU the trace attributes no
    device time (``trace_group_times`` is None);
  * gamma and pack_beta time the production path: the hook bench launches
    k groups for k parameters under ``wfbp`` and one under ``single``;
  * ``chip_multicard.py``'s gloo rehearsal at two processes calibrates a
    family at worlds 1 and 2, trains on it with telemetry, and both ranks
    resolve one model and write the same cost-model accounting.

The port's reducers run in a one-process gloo world.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mgwfbp_tpu.models import create_model as jax_create_model
from mgwfbp_tpu.parallel import costmodel as jcm
from mgwfbp_tpu.parallel.allreduce import make_merged_allreduce as jax_reducer
from mgwfbp_tpu.telemetry import overlap as jov
from mgwfbp_tpu_torch import models
from mgwfbp_tpu_torch.models.common import init_weights
from mgwfbp_tpu_torch.parallel import costmodel as tcm
from mgwfbp_tpu_torch.parallel.allreduce import make_merged_allreduce
from mgwfbp_tpu_torch.profiling import (
    _HookBench,
    _reducer_s,
    profile_group_overhead,
    profile_pack_overhead,
    trace_group_rows,
    trace_group_times,
)
from mgwfbp_tpu_torch.telemetry import overlap as tov
from mgwfbp_tpu_torch.train.step import cross_entropy

TOL = 1e-12
ROW_FIELDS = ("group", "nbytes", "start_s", "comm_s", "hidden_s", "exposed_s")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def resnet20(tmp_path_factory):
    d = tmp_path_factory.mktemp("pg")
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(str(d), 'rdv')}",
        world_size=1, rank=0,
    )
    jm, _ = jax_create_model("resnet20")
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                        train=False)
    )["params"]
    module, _ = models.create_model("resnet20")
    yield shapes, module
    dist.destroy_process_group()


def _rows_close(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in ROW_FIELDS:
            assert abs(getattr(g, f) - getattr(w, f)) <= TOL, f


@pytest.mark.parametrize("seed", range(4))
def test_attribute_overlap_equals_jax(seed):
    rs = np.random.RandomState(seed)
    n = 30
    tb = rs.uniform(1e-6, 1e-4, n).tolist()
    cuts = sorted(rs.choice(np.arange(1, n), 6, replace=False))
    groups = [list(g) for g in np.split(np.arange(n), cuts)]
    comm = rs.uniform(1e-6, 5e-4, len(groups)).tolist()
    nbytes = rs.randint(4, 1 << 22, len(groups)).tolist()
    _rows_close(tov.attribute_overlap(groups, tb, comm, nbytes),
                jov.attribute_overlap(groups, tb, comm, nbytes))


def _profile(m, sampled: bool):
    ab = m.AlphaBeta(alpha=4e-5, beta=3e-10, gamma=6e-6, overlap=0.9,
                     pack_beta=1e-11)
    if not sampled:
        return ab
    return m.SampledCost(sizes_bytes=(4e3, 6.4e4, 1e6, 1.6e7),
                         times_s=(3e-5, 4e-5, 2e-4, 5e-3), ab=ab, gamma=6e-6,
                         overlap=0.9, pack_beta=1e-11)


@pytest.mark.parametrize("measured", [False, True])
@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("policy", ["mgwfbp", "auto", "wfbp"])
def test_summarize_equals_jax(resnet20, policy, sampled, measured):
    shapes, module = resnet20
    rs = np.random.RandomState(len(policy) + 2 * sampled)
    tb = rs.uniform(2e-6, 2e-4, 65).tolist()
    ours_cost, theirs_cost = _profile(tcm, sampled), _profile(jcm, sampled)
    want_red = jax_reducer(shapes, axis_name="data", policy=policy, tb=tb,
                           cost_model=theirs_cost)
    got_red = make_merged_allreduce(module, policy=policy, tb=tb,
                                    cost_model=ours_cost)
    try:
        assert got_red.layout.groups == want_red.layout.groups
        g = want_red.layout.num_groups
        trace = rs.uniform(1e-6, 1e-3, g).tolist() if measured else None
        got_c = tov.group_comm_times(got_red, ours_cost, trace)
        want_c = jov.group_comm_times(want_red, theirs_cost, trace)
        assert got_c[1:] == want_c[1:]
        assert np.max(np.abs(np.subtract(got_c[0], want_c[0]))) <= TOL
        got = tov.summarize(got_red, ours_cost, tb, 0.0123, measured=trace)
        want = jov.summarize(want_red, theirs_cost, tb, 0.0123, measured=trace)
    finally:
        got_red.detach()
    assert got.attribution == want.attribution == (
        "trace" if measured else "cost-model")
    _rows_close(got.groups, want.groups)
    for f in ("comm_s", "hidden_s", "exposed_s", "efficiency",
              "timeline_end_s"):
        assert abs(getattr(got, f) - getattr(want, f)) <= TOL, f
    ours_f, theirs_f = got.to_event_fields(), want.to_event_fields()
    assert list(ours_f) == list(theirs_f)
    assert all(ours_f[k] == pytest.approx(theirs_f[k], abs=TOL)
               for k in ours_f if k != "attribution")
    assert [list(r) for r in got.group_event_fields(7)] == [
        list(r) for r in want.group_event_fields(7)
    ]


def test_a_comm_free_step_is_fully_hidden():
    s = tov.OverlapSummary(step_s=0.01, tb_total_s=0.004, groups=(),
                           attribution="cost-model")
    assert s.efficiency == 1.0 and s.timeline_end_s == 0.004


def _backward_once(module, reducer, x, y):
    for p in module.parameters():
        p.grad = None
    reducer.begin()
    cross_entropy(module(x), y).backward()
    return [b.clone() for b in reducer.synchronize()], list(reducer.launch_log)


def test_profiler_changes_no_launch_and_no_bit(resnet20):
    from torch.profiler import ProfilerActivity, profile

    module, _ = models.create_model("resnet20")
    init_weights(module, torch.Generator().manual_seed(0))
    module.train()
    rs = np.random.RandomState(0)
    reducer = make_merged_allreduce(module, policy="threshold",
                                    threshold=20_000)
    x = torch.from_numpy(rs.randn(2, 3, 32, 32).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 10, 2).astype(np.int64))
    try:
        assert 1 < reducer.num_groups < 65
        plain, plain_log = _backward_once(module, reducer, x, y)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced, traced_log = _backward_once(module, reducer, x, y)
        again, again_log = _backward_once(module, reducer, x, y)
        # the first backward measures the launch sequence in index order,
        # the later ones launch along it, traced or not
        assert plain_log == list(range(reducer.num_groups))
        assert traced_log == again_log == reducer.launch_sequence
        assert sorted(traced_log) == plain_log
        for a, b, c in zip(plain, traced, again):
            assert torch.equal(a, b) and torch.equal(a, c)
        scopes = sorted({e.name for e in prof.events()
                         if e.name.startswith("mgwfbp_group")})
        assert scopes == [f"mgwfbp_group{gi:04d}"
                          for gi in range(reducer.num_groups)]
        # a CPU trace holds no device time: nothing to attribute
        assert trace_group_rows(
            lambda: _backward_once(module, reducer, x, y)) == []
        assert trace_group_times(
            lambda: _backward_once(module, reducer, x, y),
            reducer.num_groups) is None
    finally:
        reducer.detach()


@pytest.mark.parametrize("policy,k,groups", [("wfbp", 4, 4), ("single", 4, 1)])
def test_the_hook_bench_runs_the_production_path(resnet20, policy, k, groups):
    bench = _HookBench([16] * k, policy, None, torch.device("cpu"))
    try:
        bench.step(True)
        assert bench.reducer.launch_log == list(range(groups))
        for p in bench.params:  # the mean over one rank of d(sum)/dp
            assert torch.equal(p.grad, torch.ones(16))
        bench.step(False)
        assert bench.reducer.launch_log == []
    finally:
        bench.close()


def test_gamma_and_pack_beta_from_the_hook_path(resnet20):
    gamma, samples = profile_group_overhead(
        None, torch.device("cpu"), alpha=0.0, total_elems=1 << 10,
        group_counts=(1, 2, 4), warmup=1, iters=2,
    )
    assert [k for k, _ in samples] == [1, 2, 4]
    assert gamma >= 0.0 and np.isfinite([t for _, t in samples]).all()
    pack_beta = profile_pack_overhead(None, torch.device("cpu"),
                                      total_elems=1 << 10, members=4,
                                      warmup=1, iters=2)
    assert pack_beta >= 0.0 and np.isfinite(pack_beta)


class _SleepBench:
    """A stand-in for a hook bench: an armed step takes ``armed_s`` more
    than a bare one, and every ``spike_every``-th bare step stalls for
    ``spike_s``; ``log`` records the order of the steps."""

    def __init__(self, name, log, armed_s=0.0, spike_every=0, spike_s=0.0):
        self.name, self.log = name, log
        self.armed_s, self.spike_every, self.spike_s = (
            armed_s, spike_every, spike_s)
        self.bare_steps = 0

    def step(self, armed):
        self.log.append((self.name, armed))
        if armed:
            time.sleep(self.armed_s)
            return
        self.bare_steps += 1
        if self.spike_every and self.bare_steps % self.spike_every == 0:
            time.sleep(self.spike_s)


def test_the_reducer_bench_alternates_its_steps_and_ignores_spikes(resnet20):
    log = []
    quiet = _SleepBench("quiet", log, spike_every=10, spike_s=0.02)
    costly = _SleepBench("costly", log, armed_s=0.002)
    got = _reducer_s([quiet, costly], warmup=1, iters=5,
                     device=torch.device("cpu"), group=None, rounds=4)
    cycle = [("quiet", True), ("quiet", False), ("costly", True),
             ("costly", False)]
    assert log == cycle * (1 + 4 * 5)
    # five stalls of 20 ms in 20 bare steps would move a window mean by
    # 5 ms; the medians keep the quiet bench near 0 and the costly one
    # above its 2 ms
    assert abs(got[0]) < 1e-3
    assert got[1] >= 0.002 - 1e-4
    assert got[1] - got[0] > 1e-3


def test_the_multicard_driver_rehearses_over_gloo(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out_dir = tmp_path / "multicard"
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "chip_multicard.py"), "--device",
         "cpu", "--processes", "2", "--min-log2", "8", "--max-log2", "10",
         "--iters", "2", "--warmup", "1", "--gamma-total-log2", "12",
         "--epochs", "1", "--batches", "2", "--batch-size", "4",
         "--out-dir", str(out_dir)],
        capture_output=True, text=True, timeout=240, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])["multicard"]
    assert report["processes"] == 2 and report["backend"] == "gloo"
    assert sorted(report["family"]) == ["1", "2"]
    ranks = report["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    # the same model and schedule on each rank (rank 0's tb is broadcast)
    picked = [[ln for ln in r["log"] if ln.startswith(("cost model:",
                                                      "merge schedule:"))]
              for r in ranks]
    assert picked[0] == picked[1] and len(picked[0]) == 2
    assert any("resolved at world 2" in ln for ln in ranks[0]["log"])
    for r in ranks:
        o = r["overlap"]
        assert o["attribution"] == "cost-model" and 0.0 <= o["efficiency"] <= 1.0
        assert len(r["group_comm_s"]) == o["num_groups"]
        assert sum(r["group_nbytes"]) == 4 * 272_474
        assert r["steps"] == 2  # the epoch's; the traced steps are no spans
    assert ranks[0]["group_comm_s"] == ranks[1]["group_comm_s"]
