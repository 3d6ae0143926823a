"""Port vs reference: the two-level lowering ``hier``
(mgwfbp_tpu_torch.parallel.{costmodel,solver,allreduce,mesh}, profiling,
calibrate, telemetry.overlap, runtime.coordination vs their mgwfbp_tpu
counterparts).

  * ``TwoLevelAlphaBeta`` (its total, per-link and derived fields, on flat
    and sampled links) and ``refit_two_level_from_observations`` (per link
    and by the common factor) equal the JAX ones to 1e-12 relative; a
    two-level profile written by either package loads in the other;
  * the two-level solver (``two_level_leg_costs``, ``simulate_groups_two_
    level``, ``dcn_partition_candidates``, ``two_level_frontier``,
    ``auto_groups_two_level``, ``remap_dcn_groups``, ``align_dcn_groups``,
    ``check_dcn_partition``) and ``build_schedule``'s hier groups and
    ``dcn_groups`` equal JAX's on seeded sizes and tb; a planned reducer
    splits a DCN group at bucket-dtype boundaries as JAX's does (and keeps
    it whole under a wire dtype);
  * the two-level overlap replay and ``summarize`` (``ici_s``, ``dcn_s``,
    ``bottleneck_link``) equal JAX's;
  * 4 gloo ranks as 2 slices of 2: hier's reduced gradients stay within
    1e-6 relative of the float64 mean and of the all_reduce path's, with
    G + D + G collectives; 10 float64 steps end within 1e-6 of all_reduce
    (float32 too); the ``Trainer`` at ``dcn_slices=2`` trains through hier
    to within 1e-6 of all_reduce, compares a group's trace range with its
    inner legs only, and refuses ``update_nworker`` with the JAX message;
  * ``calibrate --two-level --dcn 2`` on 4 CPU processes writes a profile
    the JAX ``load_profile`` reads;
  * ``coordination.release`` destroys the two-level subgroups (a child
    process checks the process-group registry).

Every child runs with an explicit environment and a 240 s bound
(tests/torch_xstep_worker.py).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from mgwfbp_tpu.parallel import costmodel as jcm
from mgwfbp_tpu.parallel import solver as js
from mgwfbp_tpu.parallel.allreduce import make_merged_allreduce as jax_reducer
from mgwfbp_tpu.telemetry import overlap as jov
from mgwfbp_tpu_torch.parallel import costmodel as tcm
from mgwfbp_tpu_torch.parallel import solver as ts
from mgwfbp_tpu_torch.parallel.allreduce import plan_merged_allreduce
from mgwfbp_tpu_torch.telemetry import overlap as tov

import torch_xstep_worker as worker

REL = 1e-12


def _rel(a: float, b: float, tol: float = REL) -> bool:
    return abs(a - b) <= tol * max(abs(a), abs(b), 1e-300)


def _close_tuple(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _rel(float(g), float(w)), (got, want)


def _link(pkg, rs, sampled: bool):
    ab = pkg.AlphaBeta(alpha=float(rs.uniform(1e-6, 3e-3)),
                       beta=float(rs.uniform(1e-11, 1e-8)),
                       gamma=float(rs.uniform(0, 4e-5)),
                       overlap=float(rs.uniform(0.3, 1.0)),
                       pack_beta=float(rs.uniform(0, 1e-11)),
                       update_beta=float(rs.uniform(0, 2e-12)),
                       ag_fraction=float(rs.uniform(0.1, 0.9)))
    if not sampled:
        return ab
    sizes = tuple(float(2 ** k) for k in range(10, 22, 2))
    times = tuple(float(ab.alpha + ab.beta * b * rs.uniform(0.8, 1.2))
                  for b in sizes)
    return pkg.SampledCost(sizes_bytes=sizes, times_s=times, ab=ab,
                           gamma=ab.gamma, overlap=ab.overlap,
                           pack_beta=ab.pack_beta,
                           update_beta=ab.update_beta,
                           ag_fraction=ab.ag_fraction)


def _models(seed: int, sampled: bool = False, ici: int = 4, dcn: int = 2):
    out = []
    for pkg in (tcm, jcm):
        rs = np.random.RandomState(seed)
        out.append(pkg.TwoLevelAlphaBeta(
            ici=_link(pkg, rs, sampled), dcn=_link(pkg, rs, sampled),
            ici_size=ici, dcn_size=dcn))
    return out


def _problem(seed: int, n: int = 10):
    rs = np.random.RandomState(seed + 100)
    return rs.randint(100, 400_000, n).tolist(), \
        rs.uniform(2e-5, 1e-3, n).tolist()


# -- the cost model -----------------------------------------------------------


@pytest.mark.parametrize("seed,sampled,dcn", [(0, False, 2), (1, True, 2),
                                              (2, False, 1)])
def test_two_level_cost_model_equals_jax(seed, sampled, dcn):
    ours, theirs = _models(seed, sampled, dcn=dcn)
    for b in (1.0, 3e3, 7e5, 5e7):
        for f in ("predict", "ici_predict", "dcn_shard_predict"):
            assert _rel(getattr(ours, f)(b), getattr(theirs, f)(b)), f
    for f in ("alpha", "gamma", "overlap", "pack_beta", "update_beta",
              "ag_fraction"):
        assert _rel(getattr(ours, f), getattr(theirs, f)), f


@pytest.mark.parametrize("sampled", [False, True])
def test_two_level_profile_roundtrips_both_ways(tmp_path, sampled):
    ours, theirs = _models(5, sampled)
    p1, p2 = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    tcm.save_profile(p1, ours, meta={"mesh": {"ici": 4, "dcn": 2}})
    jcm.save_profile(p2, theirs)
    from_port, from_jax = jcm.load_profile(p1), tcm.load_profile(p2)
    assert isinstance(from_port, jcm.TwoLevelAlphaBeta)
    assert isinstance(from_jax, tcm.TwoLevelAlphaBeta)
    assert isinstance(from_jax.ici, tcm.SampledCost) == sampled
    for b in (5e3, 5e5, 5e7):
        assert _rel(from_port.predict(b), ours.predict(b))
        assert _rel(from_jax.predict(b), theirs.predict(b))
        assert _rel(from_jax.dcn_shard_predict(b),
                    theirs.dcn_shard_predict(b))
    assert from_jax.ici_size == 4 and from_jax.dcn_size == 2
    assert tcm.resolve_profile(from_jax, 8) is from_jax


@pytest.mark.parametrize("mode", ["per_link", "ici_only", "common",
                                  "common_sampled"])
def test_refit_two_level_equals_jax(mode):
    ours, theirs = _models(9, sampled=mode == "common_sampled")
    rs = np.random.RandomState(4)
    sizes = [1e5, 1e6, 4e6, 9e6]
    obs = [(b, float(rs.uniform(1.5, 2.5)) * theirs.predict(b))
           for b in sizes]
    ici = [(b, float(rs.uniform(2, 4)) * theirs.ici_predict(b))
           for b in sizes]
    dcn = [(b / 4, float(rs.uniform(0.3, 0.7)) * theirs.dcn.predict(b / 4))
           for b in sizes]
    kw = {"per_link": dict(ici_observations=ici, dcn_observations=dcn),
          "ici_only": dict(ici_observations=ici, dcn_observations=dcn[:1]),
          }.get(mode, {})
    got = tcm.refit_two_level_from_observations(ours, obs, **kw)
    want = jcm.refit_two_level_from_observations(theirs, obs, **kw)
    assert type(got.ici).__name__ == type(want.ici).__name__
    for b in (2e4, 3e5, 2e6, 3e7):
        assert _rel(got.predict(b), want.predict(b))
        assert _rel(got.dcn_shard_predict(b), want.dcn_shard_predict(b))
    for f in ("alpha", "gamma", "ag_fraction"):
        assert _rel(getattr(got, f), getattr(want, f))
    with pytest.raises(ValueError, match="observations"):
        tcm.refit_two_level_from_observations(ours, [(1e5, 1.0)])


# -- the solver ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_level_solver_equals_jax(seed):
    ours, theirs = _models(seed)
    sizes, tb = _problem(seed)
    nbytes = [4 * s for s in sizes]
    legs_o, legs_j = ts.two_level_leg_costs(ours), \
        js.two_level_leg_costs(theirs)
    for b in (1.0, 2e4, 3e6):
        for lo, lj in zip(legs_o, legs_j):
            assert _rel(lo(b), lj(b))
        assert _rel(sum(f(b) for f in legs_o), ours.predict(b))
    assert ts.is_two_level(ours) and not ts.is_two_level(ours.ici)
    groups = [[0, 1], [2], [3, 4, 5], [6, 7], [8, 9]]
    for part in ([[0], [1], [2], [3], [4]], [[0, 1, 2, 3, 4]],
                 [[0, 1], [2, 3], [4]]):
        kw = dict(gamma=ours.ici.gamma, dcn_gamma=ours.dcn.gamma,
                  overlap=ours.overlap, pack_beta=ours.pack_beta)
        _close_tuple(
            ts.simulate_groups_two_level(groups, part, nbytes, tb, *legs_o,
                                         **kw),
            js.simulate_groups_two_level(groups, part, nbytes, tb, *legs_j,
                                         **kw))
    assert ts.dcn_partition_candidates(
        groups, nbytes, tb, legs_o[0], legs_o[1], ours.dcn.alpha,
        ours.dcn.gamma) == js.dcn_partition_candidates(
        groups, nbytes, tb, legs_j[0], legs_j[1], theirs.dcn.alpha,
        theirs.dcn.gamma)
    got = ts.two_level_frontier(sizes, tb, ours, max_candidates=8)
    want = js.two_level_frontier(sizes, tb, theirs, max_candidates=8)
    assert [(d, g, p) for d, g, p, _ in got] == \
        [(d, g, p) for d, g, p, _ in want]
    _close_tuple([t for *_, t in got], [t for *_, t in want])
    assert ts.auto_groups_two_level(sizes, tb, ours) == \
        js.auto_groups_two_level(sizes, tb, theirs)
    assert ts.singleton_dcn_groups(4) == js.singleton_dcn_groups(4)


def test_partition_helpers_equal_jax():
    old = [[0, 1, 2], [3, 4], [5]]
    new = [[0], [1, 2], [3, 4], [5]]
    for part in ([[0, 1], [2]], [[0], [1, 2]], [[0, 1, 2]]):
        assert ts.remap_dcn_groups(old, new, part) == \
            js.remap_dcn_groups(old, new, part)
    dts = ["f32", "bf16", "bf16", "f32", "f32"]
    for part in ([[0, 1, 2, 3, 4]], [[0], [1, 2], [3, 4]], [[0, 1], [2, 3, 4]]):
        assert ts.align_dcn_groups(part, dts) == \
            js.align_dcn_groups(part, dts)
    for bad in ([[0], [2]], [[0, 1], [1, 2]]):
        for mod in (ts, js):
            with pytest.raises(ValueError, match="exactly once"):
                mod.check_dcn_partition(bad, 3)


@pytest.mark.parametrize("policy", ["mgwfbp", "auto", "threshold", "wfbp",
                                    "explicit"])
@pytest.mark.parametrize("two_level", [True, False])
def test_build_schedule_hier_equals_jax(policy, two_level):
    ours, theirs = _models(3)
    if not two_level:
        ours, theirs = ours.ici, theirs.ici
    sizes, tb = _problem(3)
    layers_t = [ts.LayerSpec(f"l{i}", s) for i, s in enumerate(sizes)]
    layers_j = [js.LayerSpec(f"l{i}", s) for i, s in enumerate(sizes)]
    kw = dict(policy=policy, threshold=300_000, comm_op="hier")
    if policy == "explicit":
        kw.update(policy="auto", groups=[[0, 1, 2], [3], [4, 5], [6, 7, 8, 9]],
                  dcn_groups=[[0, 1], [2, 3]], policy_detail="pinned")
    got = ts.build_schedule(layers_t, tb, cost_model=ours, **kw)
    want = js.build_schedule(layers_j, tb, cost_model=theirs, **kw)
    assert got.groups == want.groups and got.dcn_groups == want.dcn_groups
    assert got.dcn_groups and got.num_dcn_groups == want.num_dcn_groups
    assert got.policy_detail == want.policy_detail
    _close_tuple((got.predicted_total_time, got.predicted_nonoverlap_time,
                  got.predicted_comm_time),
                 (want.predicted_total_time, want.predicted_nonoverlap_time,
                  want.predicted_comm_time))


class _Mixed(nn.Module):
    """Three leaves of two dtypes (arrival order c, b, a), as
    tests/test_two_level_sched.py builds its tree."""

    def __init__(self):
        super().__init__()
        self.a = nn.Module()
        self.a.w = nn.Parameter(torch.zeros(512))
        self.b = nn.Module()
        self.b.w = nn.Parameter(torch.zeros(256, dtype=torch.bfloat16))
        self.c = nn.Module()
        self.c.w = nn.Parameter(torch.zeros(128))


@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_dcn_groups_split_at_dtype_boundaries_as_jax(wire, monkeypatch):
    from mgwfbp_tpu_torch import convert

    monkeypatch.setattr(convert, "_leaf_map", lambda m: {
        ("params", f"{k}.w"): (f"{k}.w", lambda t: t, lambda t: t)
        for k in ("a", "b", "c")})
    sched, layout, _, _ = plan_merged_allreduce(
        _Mixed(), policy="wfbp", comm_op="hier", dcn_groups=[[0, 1, 2]],
        comm_dtype=getattr(torch, wire) if wire else None)
    rng = np.random.RandomState(1)
    tree = {"a": {"w": jnp.asarray(rng.randn(512), jnp.float32)},
            "b": {"w": jnp.asarray(rng.randn(256), jnp.bfloat16)},
            "c": {"w": jnp.asarray(rng.randn(128), jnp.float32)}}
    red = jax_reducer(tree, axis_name=("data", "dcn"), policy="wfbp",
                      comm_op="hier", dcn_groups=[[0, 1, 2]],
                      comm_dtype=getattr(jnp, wire) if wire else None)
    assert sched.groups == red.schedule.groups
    assert sched.dcn_groups == red.schedule.dcn_groups
    assert len(sched.dcn_groups) == (1 if wire else 3)


# -- overlap ------------------------------------------------------------------


def test_two_level_overlap_replay_equals_jax():
    sizes, tb = _problem(6)
    groups = [[0, 1], [2], [3, 4, 5], [6, 7], [8, 9]]
    part = [[0, 1], [2, 3], [4]]
    nbytes = [4 * sum(sizes[i] for i in g) for g in groups]
    rs = np.random.RandomState(2)
    rs_s, ag_s = (rs.uniform(1e-5, 1e-3, 5).tolist() for _ in range(2))
    dcn_s = rs.uniform(1e-4, 3e-3, 3).tolist()
    got = tov.attribute_overlap_two_level(groups, part, tb, rs_s, dcn_s,
                                          ag_s, nbytes)
    want = jov.attribute_overlap_two_level(groups, part, tb, rs_s, dcn_s,
                                           ag_s, nbytes)
    for g, w in zip(got, want):
        for f in ("start_s", "comm_s", "hidden_s", "exposed_s", "ici_s",
                  "dcn_s"):
            assert _rel(getattr(g, f), getattr(w, f)), f


@pytest.mark.parametrize("measured", [False, True])
@pytest.mark.parametrize("two_level", [True, False])
def test_summarize_hier_equals_jax(measured, two_level):
    ours, theirs = _models(11)
    if not two_level:
        ours, theirs = ours.ici, theirs.ici
    sizes, tb = _problem(11)
    groups = [[0, 1], [2], [3, 4, 5], [6, 7], [8, 9]]
    part = [[0, 1], [2, 3], [4]]

    def red(dtype):
        r = type("R", (), {})()
        r.comm_op = "hier"
        r.layout = type("L", (), {
            "groups": groups, "num_groups": len(groups),
            "group_sizes": [sum(sizes[i] for i in g) for g in groups],
            "dtypes": [dtype] * len(groups)})()
        r.schedule = type("S", (), {"dcn_groups": part})()
        return r

    m = (np.random.RandomState(3).uniform(1e-4, 1e-3, 5).tolist()
         if measured else None)
    s_o = tov.summarize(red(torch.float32), ours, tb, 0.02, measured=m)
    s_j = jov.summarize(red(np.float32), theirs, tb, 0.02, measured=m)
    d_o, d_j = s_o.to_event_fields(), s_j.to_event_fields()
    assert d_o.keys() == d_j.keys()
    assert ("bottleneck_link" in d_o) == two_level
    for k in d_o:
        if isinstance(d_o[k], float):
            assert _rel(d_o[k], d_j[k]), k
        else:
            assert d_o[k] == d_j[k], k
    assert s_o.group_event_fields(1) == pytest.approx(
        s_j.group_event_fields(1), rel=REL)


# -- 4 ranks (2 slices of 2) ----------------------------------------------------------


@pytest.fixture(scope="module")
def hier4(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("hier4"))
    runs = [
        {"name": name, "epochs": 1, "probe": name == "hier",
         "cfg": dict(comm_op=op, dcn_slices=2, batch_size=4,
                     num_batches_per_epoch=3, max_epochs=1, seed=5,
                     augment=False, lr=0.05, policy="threshold",
                     threshold=3000, logdir=os.path.join(tmp, name),
                     checkpoint_dir=None)}
        for name, op in (("hier", "hier"), ("ar", "all_reduce"))]
    spec = {
        "tasks": ["reduce", "traj", "trainer"],
        "reduce": {"seeds": [1, 2], "ops": ["all_reduce", "hier"],
                   "dcn": 2, "threshold": 3000},
        "traj": {"seed": 4, "batch": 2, "steps": 10, "threshold": 3000,
                 "dcn": 2, "runs": [["ar32", "all_reduce", None, "float32"],
                                    ["hier32", "hier", None, "float32"],
                                    ["ar64", "all_reduce", None, "float64"],
                                    ["hier64", "hier", None, "float64"]]},
        "trainer": {"runs": runs},
    }
    return worker.run_ranks(4, tmp, spec)


def _relnorm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("seed", [1, 2])
def test_hier_reduction_matches_float64_and_all_reduce(hier4, seed):
    exact = np.mean([out[f"{seed}/local"].astype(np.float64)
                     for out in hier4], axis=0)
    for out in hier4:
        hier, ar = out[f"{seed}/hier"], out[f"{seed}/all_reduce"]
        assert _relnorm(hier, exact) <= 1e-6
        assert _relnorm(hier, ar) <= 1e-6
        assert np.abs(hier - exact).max() <= 1e-6 * np.abs(exact).max()
        np.testing.assert_array_equal(hier, hier4[0][f"{seed}/hier"])


def test_hier_collectives_per_step(hier4):
    """G reduce-scatters inside the slices, D cross-slice all-reduces, G
    all-gathers inside the slices."""
    out = hier4[0]
    g, d = int(out["hier32/groups"]), int(out["hier32/dcn_groups"])
    assert g >= 2 and d == g  # threshold policy: one DCN group per group
    assert list(out["hier32/launches"]) == [2 * g + d] * 10
    assert list(out["ar32/launches"]) == [g] * 10
    # synchronize launches hier's all-gathers, nothing on all_reduce
    assert int(out["1/hier/launches"]) == g
    assert int(out["1/all_reduce/launches"]) == 0


@pytest.mark.parametrize("dtype,tol", [("64", 1e-6), ("32", 1e-6)])
def test_hier_trajectory_matches_all_reduce(hier4, dtype, tol):
    for out in hier4:
        for k in (1, 5, 10):
            assert _relnorm(out[f"hier{dtype}/params{k}"],
                            out[f"ar{dtype}/params{k}"]) <= tol
    np.testing.assert_array_equal(hier4[0][f"hier{dtype}/final"],
                                  hier4[3][f"hier{dtype}/final"])


def test_hier_trainer_trains_and_probes_as_jax(hier4):
    """The Trainer at dcn_slices=2 reduces through hier to within 1e-6 of
    all_reduce; a group's trace range is compared with its inner legs
    (the JAX trainer's ``_scope_comparable_predictions``); update_nworker
    refuses a multi-slice run with the JAX message."""
    out = hier4[0]
    assert str(out["hier/comm_op"]) == "hier"
    pre = "hier/params/"
    got = np.concatenate([out[k].ravel() for k in sorted(out)
                          if k.startswith(pre)])
    want = np.concatenate([out["ar/params/" + k[len(pre):]].ravel()
                           for k in sorted(out) if k.startswith(pre)])
    assert _relnorm(got, want) <= 1e-6
    cm = jcm.TwoLevelAlphaBeta(ici=jcm.lookup_alpha_beta("ici", 2),
                               dcn=jcm.lookup_alpha_beta("dcn", 2),
                               ici_size=2, dcn_size=2)
    rs_c, _, ag_c = js.two_level_leg_costs(cm)
    for p, b in zip(out["hier/scope_predicted"], out["hier/scope_nbytes"]):
        assert _rel(float(p), rs_c(float(b)) + ag_c(float(b)))
    assert str(out["hier/resize_error"]).startswith(
        "update_nworker cannot re-mesh a multi-slice (dcn) run in place; "
        "relaunch with new --dcn-slices")


# -- calibrate --two-level ------------------------------------------------------


def test_calibrate_two_level_on_four_processes_is_read_by_jax(tmp_path):
    import socket

    out = str(tmp_path / "tl.json")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = [sys.executable, "-m", "mgwfbp_tpu_torch.calibrate", "--out", out,
            "--two-level", "--dcn", "2", "--allgather", "--min-log2", "8",
            "--max-log2", "10", "--iters", "2", "--warmup", "1",
            "--device", "cpu"]
    got = worker.run_children(
        [argv] * 4, cwd=str(tmp_path),
        extra_env={"MGWFBP_COORDINATOR": f"127.0.0.1:{port}",
                   "MGWFBP_NUM_PROCESSES": "4"},
        per_child_env=[{"MGWFBP_PROCESS_ID": str(r)} for r in range(4)])
    report = json.loads(got[0][0].strip().splitlines()[-1])
    assert report["mesh"] == {"ici": 2, "dcn": 2} and report["samples"] == 3
    m = jcm.load_profile(out)
    assert isinstance(m, jcm.TwoLevelAlphaBeta)
    assert m.ici_size == 2 and m.dcn_size == 2
    assert isinstance(m.ici, jcm.SampledCost)
    assert 0.05 <= m.ici.ag_fraction <= 0.95
    assert m.ici.alpha == report["ici"]["alpha_s"]
    assert m.dcn.beta == report["dcn"]["beta_s_per_byte"]
    doc = json.load(open(out))
    assert doc["meta"]["mesh"] == {"ici": 2, "dcn": 2}
    assert doc["meta"]["backend"] == "gloo"
    assert all(o.strip() == "" for o, _ in got[1:])


# -- the subgroups' teardown ---------------------------------------------------------

_RELEASE_CHILD = r"""
import os, sys, tempfile
import torch.distributed as dist
from mgwfbp_tpu_torch.parallel import mesh
from mgwfbp_tpu_torch.runtime import coordination as coord
d = tempfile.mkdtemp()
dist.init_process_group("gloo", init_method=f"file://{d}/rdv", world_size=1,
                        rank=0)
g = mesh.two_level_groups(1)
live = dist.distributed_c10d._world.pg_map
before = (g.inner in live, g.outer in live)
coord.release()
print(before, (g.inner in live, g.outer in live), coord._subgroups)
dist.destroy_process_group()
"""


def test_release_destroys_the_two_level_subgroups():
    """Subgroups left alive until the interpreter finalizes would be torn
    down there, where gloo's teardown can abort a finished process (the
    failure ``coordination.release`` exists for); ``release`` destroys
    them while the interpreter still runs."""
    (out, _), = worker.run_children(
        [[sys.executable, "-c", _RELEASE_CHILD]], timeout_s=120)
    assert out.split("\n")[0] == "(True, True) (False, False) []"
