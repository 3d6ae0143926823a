"""The port's closed-loop schedule autotuner (``parallel/autotune.py``,
``solver.schedule_frontier``, ``costmodel.refit_from_observations``,
``profiling.dcn_shard_nbytes`` and ``time_carried_steps``, and the
trainer's race) against the JAX package's functions, and the race itself
at two gloo ranks.

Held against the JAX functions on seeded inputs (exact for integers,
strings and groups, relative 1e-12 for floats): ``allowed_comm_ops`` for
every base and both ``multi_slice``; ``build_candidates`` and
``schedule_frontier`` on the specs of resnet20 and lenet and on random
specs, under flat, cross-step (with tf) and two-level models, with and
without an incumbent; ``cache_key`` over its whole field grid;
``step_delta_observations``; ``refit_from_observations`` (all_reduce and
rs_opt_ag); ``model_summary``; ``dcn_shard_nbytes``; a cache entry that each
package writes and the other loads, and the schema refusal in both; the
postmortem bundle's ``_schedule_state_doc`` (flat and two-level); the CLI
flags.

The race, at two gloo ranks (``tests/torch_autotune_worker.py``), is
judged by its own measured argmin, never by the JAX autotune tests: with a
scripted timer the committed winner is the argmin of each candidate's
slowest rank, a candidate that raises is contained, with no survivor the
solved schedule stays, and a candidate the gate rejects takes no step; a
real race on LeNet verifies every entry, commits once with both ranks
equal, a second run is a cache hit and ``force=True`` races again; two
groupings under all_reduce give bitwise-equal parameters; an rs_fwd_ag run
swaps to all_reduce and back losslessly, and the checkpoint written while
all_reduce was live restores in the JAX trainer; a cross-world resume
installs the schedule cached at its key; ``tools/autotune_report.py``
renders a port entry (drift's re-race: tests/test_torch_drift.py). No test
here asserts a time.
"""

import dataclasses
import itertools
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from mgwfbp_tpu import profiling as jax_profiling
from mgwfbp_tpu import train_cli as jax_cli
from mgwfbp_tpu.config import make_config as jax_make_config
from mgwfbp_tpu.parallel import autotune as jat
from mgwfbp_tpu.parallel import buckets as jax_buckets
from mgwfbp_tpu.parallel import costmodel as jcm
from mgwfbp_tpu.parallel import solver as jsolver
from mgwfbp_tpu.parallel.mesh import MeshSpec, make_mesh
from mgwfbp_tpu.train.trainer import Trainer as JaxTrainer
from mgwfbp_tpu_torch import models as pzoo
from mgwfbp_tpu_torch import profiling
from mgwfbp_tpu_torch import train_cli
from mgwfbp_tpu_torch.convert import flax_leaves, keystr
from mgwfbp_tpu_torch.parallel import autotune as at
from mgwfbp_tpu_torch.parallel import buckets
from mgwfbp_tpu_torch.parallel import costmodel as cm
from mgwfbp_tpu_torch.parallel import solver
from mgwfbp_tpu_torch.parallel.allreduce import arrival_order
from mgwfbp_tpu_torch.train.trainer import Trainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_autotune_worker as worker  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(a, b, path="") -> None:
    """Exact for ints, strings, None and bools; relative 1e-12 for floats;
    recursive over sequences, dicts and dataclasses."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        _close(dataclasses.asdict(a), dataclasses.asdict(b), path)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        if np.isnan(a) or np.isnan(b):
            assert np.isnan(a) and np.isnan(b), path
        else:
            assert abs(a - b) <= 1e-12 * max(abs(a), abs(b)), (path, a, b)
    else:
        assert a == b, (path, a, b)


# -- inputs ---------------------------------------------------------------------


def _model_specs(name: str) -> list[tuple[str, int, int]]:
    """(name, size, itemsize) of a registry model's leaves in arrival
    order."""
    model, _ = pzoo.create_model(name)
    leaves = flax_leaves(model)
    names = [keystr(p) for p, _ in leaves]
    perm = arrival_order(len(names), names=names)
    return [(names[j], leaves[j][1].numel(), leaves[j][1].element_size())
            for j in perm]


def _random_specs(seed: int) -> list[tuple[str, int, int]]:
    rs = np.random.RandomState(seed)
    n = int(rs.randint(4, 24))
    return [(f"l{i}", int(rs.randint(1, 1 << rs.randint(4, 20))),
             int(rs.choice([2, 4]))) for i in range(n)]


SPECS = {"resnet20": lambda: _model_specs("resnet20"),
         "lenet": lambda: _model_specs("lenet"),
         "rand0": lambda: _random_specs(0), "rand1": lambda: _random_specs(1)}


def _both_specs(raw):
    return ([solver.LayerSpec(n, s, i) for n, s, i in raw],
            [jsolver.LayerSpec(n, s, i) for n, s, i in raw])


def _tb(raw, seed: int):
    rs = np.random.RandomState(100 + seed)
    return [float(x) for x in rs.uniform(1e-5, 2e-4, len(raw))]


def _flat_models(seed: int):
    rs = np.random.RandomState(seed)
    kw = dict(alpha=float(rs.uniform(1e-6, 1e-4)),
              beta=float(rs.uniform(1e-11, 1e-9)),
              gamma=float(rs.uniform(0, 5e-5)),
              overlap=float(rs.uniform(0.3, 1.0)),
              pack_beta=float(rs.choice([0.0, 2e-11])),
              update_beta=float(rs.uniform(0, 5e-10)))
    return cm.AlphaBeta(**kw), jcm.AlphaBeta(**kw)


def _two_level_models(seed: int):
    p, j = _flat_models(seed)
    p2, j2 = _flat_models(seed + 7)
    return (cm.TwoLevelAlphaBeta(ici=p, dcn=dataclasses.replace(
                p2, beta=p2.beta * 20), ici_size=2, dcn_size=2),
            jcm.TwoLevelAlphaBeta(ici=j, dcn=dataclasses.replace(
                j2, beta=j2.beta * 20), ici_size=2, dcn_size=2))


# -- the functions ----------------------------------------------------------------


@pytest.mark.parametrize("multi_slice", [False, True])
def test_allowed_comm_ops_equal_jax(multi_slice):
    for base in solver.COMM_OPS + ("bogus",):
        assert at.allowed_comm_ops(base, multi_slice) == \
            jat.allowed_comm_ops(base, multi_slice)


@pytest.mark.parametrize("spec_name", sorted(SPECS))
@pytest.mark.parametrize("model_kind", ["flat", "cross", "two_level"])
@pytest.mark.parametrize("with_incumbent", [False, True])
def test_build_candidates_equal_jax(spec_name, model_kind, with_incumbent):
    raw = SPECS[spec_name]()
    ps, js = _both_specs(raw)
    tb = _tb(raw, 3)
    seed = sorted(SPECS).index(spec_name)
    if model_kind == "two_level":
        pm, jm = _two_level_models(seed)
        ops = ("all_reduce", "rs_ag", "hier")
    else:
        pm, jm = _flat_models(seed)
        ops = (("rs_fwd_ag", "all_reduce", "rs_ag") if model_kind == "cross"
               else ("all_reduce", "rs_ag", "rs_opt_ag"))
    tf = ([t / 2 for t in tb] if model_kind == "cross" and seed % 2 == 0
          else None)
    incumbent = None
    if with_incumbent:
        third = max(len(raw) // 3, 1)
        groups = [list(range(0, third)), list(range(third, len(raw)))]
        incumbent = ((tuple(map(tuple, groups)), ops[0], ((0, 1),))
                     if model_kind == "two_level"
                     else (tuple(map(tuple, groups)), ops[0]))
    for cap in (1, 3, 6):
        got = at.build_candidates(ps, tb, pm, ops, tf=tf, max_candidates=cap,
                                  incumbent=incumbent)
        want = jat.build_candidates(js, tb, jm, ops, tf=tf,
                                    max_candidates=cap, incumbent=incumbent)
        assert got, (spec_name, model_kind)
        _close(got, want)


@pytest.mark.parametrize("spec_name", sorted(SPECS))
@pytest.mark.parametrize("cross", [False, True])
def test_schedule_frontier_equal_jax(spec_name, cross):
    raw = SPECS[spec_name]()
    sizes = [s for _, s, _ in raw]
    items = [i for _, _, i in raw]
    tb = _tb(raw, 5)
    pm, jm = _flat_models(sorted(SPECS).index(spec_name) + 11)
    for op in ("all_reduce", "rs_opt_ag"):
        pc, jc = solver.effective_cost_fn(pm, op), jsolver.effective_cost_fn(
            jm, op)
        pcross = jcross = None
        if cross:
            prs, pag = solver.cross_step_phase_costs(pm)
            jrs, jag = jsolver.cross_step_phase_costs(jm)
            tf = solver.forward_prior_tf(tb)
            pcross, jcross, pc, jc = (tf, prs, pag), (tf, jrs, jag), prs, jrs
        for cap in (1, 4, 8):
            got = solver.schedule_frontier(
                sizes, tb, pm.alpha, pc, items, gamma=pm.gamma,
                overlap=pm.overlap, pack_beta=pm.pack_beta,
                max_candidates=cap, cross_step=pcross)
            want = jsolver.schedule_frontier(
                sizes, tb, jm.alpha, jc, items, gamma=jm.gamma,
                overlap=jm.overlap, pack_beta=jm.pack_beta,
                max_candidates=cap, cross_step=jcross)
            _close(got, want)


def test_cache_key_equal_jax_over_its_field_grid():
    grid = itertools.product(
        ["resnet20", "lstm/ptb"], [1, 8], ["all_reduce", "hier"],
        [None, "float32", "bfloat16"], [None, "bfloat16"],
        [None, "none", "topk"], [None, 0.01], [None, 32], [None, 1, 4],
        [None, 1, 2])
    n = 0
    for m, w, op, dt, wire, comp, dens, b, acc, dcn in grid:
        kw = dict(comm_dtype=wire, compressor=comp, density=dens,
                  batch_size=b, nsteps_update=acc, dcn_slices=dcn)
        assert at.cache_key(m, w, op, dt, **kw) == jat.cache_key(
            m, w, op, dt, **kw)
        n += 1
    assert n == 2 * 2 * 2 * 3 * 2 * 3 * 2 * 2 * 3 * 3


@pytest.mark.parametrize("seed", range(4))
def test_step_delta_observations_equal_jax(seed):
    rs = np.random.RandomState(seed)
    rows = []
    for i in range(int(rs.randint(1, 7))):
        t = (None if rs.rand() < 0.2 else float(rs.uniform(0.005, 0.05)))
        rows.append(dict(label=f"c{i}", comm_op="all_reduce",
                         num_groups=int(rs.randint(0, 6)), verified=True,
                         measured_step_s=t))
    tb_total = float(rs.uniform(0.001, 0.03))
    got = at.step_delta_observations([at.RaceEntry(**r) for r in rows],
                                     4e6, tb_total)
    want = jat.step_delta_observations([jat.RaceEntry(**r) for r in rows],
                                       4e6, tb_total)
    _close(got, want)


@pytest.mark.parametrize("comm_op", ["all_reduce", "rs_opt_ag"])
@pytest.mark.parametrize("seed", range(3))
def test_refit_from_observations_equal_jax(comm_op, seed):
    pm, jm = _flat_models(seed)
    rs = np.random.RandomState(50 + seed)
    obs = [(float(b), float(3e-5 + b * 2e-10 + rs.uniform(0, 1e-6)))
           for b in rs.uniform(1e4, 1e7, 5)]
    got = cm.refit_from_observations(pm, obs, comm_op)
    want = jcm.refit_from_observations(jm, obs, comm_op)
    _close(got, want)
    if comm_op == "rs_opt_ag":
        # the fitted rate is split between the wire and the update
        assert 0 < got.update_beta < got.beta + got.update_beta
    with pytest.raises(ValueError):
        cm.refit_from_observations(pm, obs[:1], comm_op)


def test_model_summary_equal_jax():
    for seed in range(3):
        pm, jm = _flat_models(seed)
        _close(at.model_summary(pm), jat.model_summary(jm))
        pt, jt = _two_level_models(seed)
        _close(at.model_summary(pt), jat.model_summary(jt))
        assert set(at.model_summary(pt)) >= {"ici", "dcn"}
        _close(at.model_summary(cm.refit_two_level_from_observations(
            pt, [(1e5, 1e-3), (1e6, 3e-3)])), jat.model_summary(
            jcm.refit_two_level_from_observations(
                jt, [(1e5, 1e-3), (1e6, 3e-3)])))


@pytest.mark.parametrize("ici", [1, 2, 3, 4])
@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_dcn_shard_nbytes_equal_jax(ici, wire):
    import jax.numpy as jnp

    raw = _random_specs(ici)
    shapes = [(s,) for _, s, _ in raw]
    dt = [torch.float32 if i == 4 else torch.bfloat16 for _, _, i in raw]
    jdt = [jnp.float32 if i == 4 else jnp.bfloat16 for _, _, i in raw]
    groups = [list(range(k, min(k + 3, len(raw))))
              for k in range(0, len(raw), 3)]
    tl = buckets.build_layout([torch.empty(s, dtype=d, device="meta")
                               for s, d in zip(shapes, dt)], groups)
    jl = jax_buckets.build_layout(
        [jax.ShapeDtypeStruct(s, d) for s, d in zip(shapes, jdt)], groups)
    dcn = [list(range(k, min(k + 2, tl.num_groups)))
           for k in range(0, tl.num_groups, 2)]
    got = profiling.dcn_shard_nbytes(
        tl, dcn, ici, getattr(torch, wire) if wire else None)
    want = jax_profiling.dcn_shard_nbytes(
        jl, dcn, ici, getattr(jnp, wire) if wire else None)
    assert got == want


def test_time_carried_steps_carries_the_state():
    state, dt = profiling.time_carried_steps(lambda s: s + 1, 0, 3, warmup=2)
    assert state == 5 and dt >= 0.0


def _entry(key: str) -> dict:
    return {"key": key, "model": "lenet", "world": 2, "comm_op": "all_reduce",
            "dtype": None, "layer_names": ["a", "b"], "winner": "x:mgwfbp",
            "groups": [[0], [1]], "dcn_groups": [], "measured_step_s": 0.01,
            "tb_source": "trace", "race": [], "refit": None,
            "solved_group_times": [[4, 1e-5]],
            "measured_group_times": None}


def test_cache_entries_round_trip_between_the_packages(tmp_path):
    port_path = at.entry_path(str(tmp_path / "p"), "k1")
    jax_path = jat.entry_path(str(tmp_path / "j"), "k1")
    at.save_cache_entry(port_path, _entry("k1"))
    jat.save_cache_entry(jax_path, _entry("k1"))
    with open(port_path) as a, open(jax_path) as b:
        assert a.read() == b.read()  # letter for letter
    assert jat.load_cache_entry(port_path) == at.load_cache_entry(jax_path)
    assert at.load_cache_entry(port_path)["schema_version"] == \
        at.CACHE_SCHEMA_VERSION == jat.CACHE_SCHEMA_VERSION
    assert at.load_cache_entry(str(tmp_path / "none.json")) is None
    bad = dict(_entry("k1"), schema_version=2)
    with open(port_path, "w") as f:
        json.dump(bad, f)
    for load in (at.load_cache_entry, jat.load_cache_entry):
        with pytest.raises(ValueError, match="schedule-cache entry schema"):
            load(port_path)


def test_public_names_match_the_jax_module():
    public = {n for n, v in vars(jat).items() if not n.startswith("_")
              and not isinstance(v, types.ModuleType)}
    assert {"CACHE_SCHEMA_VERSION", "Candidate", "RaceEntry",
            "allowed_comm_ops", "build_candidates", "cache_key",
            "entry_path", "load_cache_entry", "model_summary",
            "save_cache_entry", "step_delta_observations"} <= public
    assert public <= set(vars(at)), public - set(vars(at))


def test_cli_autotune_flags_give_the_jax_config_fields():
    argv = ["--dnn", "lenet", "--autotune", "--autotune-steps", "5",
            "--schedule-cache", "some/dir"]
    got = train_cli.config_from_args(train_cli.build_parser().parse_args(argv))
    want = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
    for field in ("autotune", "autotune_steps", "autotune_candidates",
                  "schedule_cache"):
        assert getattr(got, field) == getattr(want, field), field
    plain = train_cli.config_from_args(
        train_cli.build_parser().parse_args(["--dnn", "lenet"]))
    assert (plain.autotune, plain.autotune_steps, plain.schedule_cache) == \
        (False, 3, None)


@pytest.mark.parametrize("two_level", [False, True])
def test_schedule_state_doc_equals_jax(two_level):
    """The postmortem bundle's ``schedule.json`` of one schedule and cost
    model, from each trainer's method."""
    raw = _model_specs("lenet")
    ps, js = _both_specs(raw)
    tb = _tb(raw, 9)
    pm, jm = _two_level_models(2) if two_level else _flat_models(2)
    op = "hier" if two_level else "all_reduce"
    psched = solver.build_schedule(ps, tb, policy="auto", cost_model=pm,
                                   comm_op=op)
    jsched = jsolver.build_schedule(js, tb, policy="auto", cost_model=jm,
                                    comm_op=op)

    def fake(sched, model, policy_detail):
        layout = types.SimpleNamespace(num_groups=len(sched.groups),
                                       groups=sched.groups)
        red = types.SimpleNamespace(comm_op=op, layout=layout,
                                    num_groups=len(sched.groups),
                                    schedule=dataclasses.replace(
                                        sched, policy_detail=policy_detail))
        return types.SimpleNamespace(
            iteration=7, reducer=red, cost_model=model,
            config=types.SimpleNamespace(policy="auto"),
            _measured_group_times=[1e-3] * len(sched.groups))

    for detail in ("", "autotune:x"):
        got = Trainer._schedule_state_doc(fake(psched, pm, detail))
        want = JaxTrainer._schedule_state_doc(fake(jsched, jm, detail))
        _close(got, want)
        assert set(got["schedule"]) >= {"dcn_groups"}
        assert set(got["cost_model"]) >= {"alpha", "update_beta"}


# -- the race at two gloo ranks -----------------------------------------------------


def lenet_cfg(tmp: str, name: str, **kw) -> dict:
    base = dict(batch_size=4, num_batches_per_epoch=4, max_epochs=1, seed=5,
                augment=False, lr=0.01, logdir=os.path.join(tmp, "logs", name),
                checkpoint_dir=None, schedule_cache=os.path.join(tmp, "cache",
                                                                 name),
                autotune_steps=2)
    base.update(kw)
    return base


# per-rank scripted step times: rank 0's argmin is candidate 1, rank 1's
# candidate 0, the argmin of the per-candidate maximum candidate 4
SCRIPT = {"0": [5.0, 1.0, 4.0, 3.0, 2.0, 6.0] + [9.0] * 6,
          "1": [1.0, 5.0, 2.0, 4.0, 3.0, 6.0] + [9.0] * 6}


def _resume_cached(tmp: str) -> dict:
    """A world-1 run's committed epoch (written here, in this process) and a
    cache entry for the same run at world 2 (one group); the 2-rank run
    then resumes across worlds and installs the cached schedule."""
    cfg = lenet_cfg(tmp, "resume", checkpoint_dir=os.path.join(tmp, "ck"),
                    telemetry=True)
    from mgwfbp_tpu_torch.config import make_config

    t = Trainer(make_config("lenet", **cfg), device="cpu",
                synthetic_data=True, profile_backward=False)
    try:
        t.fit(1)
    finally:
        t.close()
    names = [n for n, _, _ in _model_specs("lenet")]
    key = at.cache_key("lenet", 2, "all_reduce", None, batch_size=4)
    at.save_cache_entry(at.entry_path(cfg["schedule_cache"], key), {
        "key": key, "model": "lenet", "world": 2, "comm_op": "all_reduce",
        "dtype": None, "layer_names": names, "winner": "all_reduce:single",
        "groups": [list(range(len(names)))], "dcn_groups": [],
        "measured_step_s": 0.01, "race": []})
    return {"name": "resume_cached", "action": "init", "cfg": cfg,
            "env": {"MGWFBP_ELASTIC_RESUME": "1"}}


@pytest.fixture(scope="module")
def races(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("races"))
    real = lenet_cfg(tmp, "real", autotune=True)
    runs = [
        {"name": "scripted", "cfg": lenet_cfg(tmp, "scripted"),
         "script": SCRIPT},
        {"name": "raise_one", "cfg": lenet_cfg(tmp, "raise_one"),
         "script": {r: ["raise" if k == 1 else v for k, v in enumerate(s)]
                    for r, s in SCRIPT.items()}},
        {"name": "all_raise", "cfg": lenet_cfg(tmp, "all_raise"),
         "script": {r: ["raise"] * 12 for r in SCRIPT}},
        {"name": "reject", "cfg": lenet_cfg(tmp, "reject"),
         "script": SCRIPT, "reject": ["rs_ag:"]},
        {"name": "real", "cfg": real, "action": "fit"},
        {"name": "real_hit", "cfg": real, "action": "fit", "force": True},
        {"name": "grp_single", "action": "fit",
         "cfg": lenet_cfg(tmp, "grp_single", policy="single")},
        {"name": "grp_wfbp", "action": "fit",
         "cfg": lenet_cfg(tmp, "grp_wfbp", policy="wfbp")},
        _resume_cached(tmp),
    ]
    outs = worker.run_ranks(2, tmp, {"tasks": ["race"],
                                     "race": {"runs": runs}})
    return outs, tmp


def _j(out, key):
    return json.loads(str(out[key]))


def test_scripted_winner_is_the_argmin_of_each_candidate_slowest_rank(races):
    outs, _ = races
    rows = [_j(out, "scripted/rows") for out in outs]
    labels = [r["label"] for r in rows[0]]
    assert labels == [r["label"] for r in rows[1]] and len(labels) >= 5
    slowest = [max(rows[0][i]["measured"], rows[1][i]["measured"])
               for i in range(len(labels))]
    want = labels[int(np.argmin(slowest))]
    for r, out in enumerate(outs):
        rep = _j(out, "scripted/report")
        assert rep["winner"] == want and rep["source"] == "race"
        # neither rank's own argmin
        own = [row["measured"] for row in rows[r]]
        assert labels[int(np.argmin(own))] != want
        assert _j(out, "scripted/groups_after") == rep["groups"]
    np.testing.assert_array_equal(outs[0]["scripted/params"],
                                  outs[1]["scripted/params"])


def test_a_candidate_that_raises_is_contained(races):
    outs, _ = races
    for out in outs:
        rows = _j(out, "raise_one/rows")
        assert rows[1]["verified"] and rows[1]["measured"] is None
        rep = _j(out, "raise_one/report")
        assert rep["winner"] != rows[1]["label"]
        assert rep["cache_path"] is not None


def test_with_no_survivor_the_solved_schedule_stays(races):
    outs, _ = races
    for out in outs:
        rep = _j(out, "all_raise/report")
        assert rep["cache_path"] is None and "winner" not in rep
        assert all(e["measured_step_s"] is None for e in rep["race"])
        assert _j(out, "all_raise/groups_after") == \
            _j(out, "all_raise/groups_before")
        assert str(out["all_raise/comm_op"]) == "all_reduce"


def test_a_candidate_the_gate_rejects_takes_no_step(races):
    outs, _ = races
    for out in outs:
        rows = _j(out, "reject/rows")
        rejected = [r for r in rows if r["label"].startswith("rs_ag:")]
        assert rejected
        for r in rejected:
            assert not r["verified"] and r["measured"] is None
            assert r["unchanged"] and r["timed_windows"] == 0
        for r in rows:
            if not r["label"].startswith("rs_ag:"):
                assert r["verified"] and not r["unchanged"]
        assert not _j(out, "reject/report")["winner"].startswith("rs_ag:")


def test_real_race_verifies_every_entry_and_commits_once(races):
    outs, tmp = races
    reps = [_j(out, "real/report") for out in outs]
    for rep in reps:
        assert rep["source"] == "race"
        assert rep["race"] and all(e["verified"] for e in rep["race"])
        assert all(e["measured_step_s"] is not None for e in rep["race"])
        gate = rep["gate"]
        assert len(gate) == len(rep["race"])
        assert all(g["rules"] == [] and g["collectives"] >= g["num_groups"]
                   for g in gate)
    assert reps[0]["winner"] == reps[1]["winner"]
    assert reps[0]["groups"] == reps[1]["groups"]
    # agreed times: identical race tables on both ranks
    assert reps[0]["race"] == reps[1]["race"]
    np.testing.assert_array_equal(outs[0]["real/params"],
                                  outs[1]["real/params"])
    entries = os.listdir(os.path.join(tmp, "cache", "real"))
    assert entries == ["lenet_w2_all_reduce_None_b4.json"]


def test_second_run_is_a_cache_hit_and_force_races_again(races):
    outs, _ = races
    for out in outs:
        first = _j(out, "real/report")
        hit = _j(out, "real_hit/report")
        assert hit["source"] == "cache" and hit["groups"] == first["groups"]
        assert hit["winner"] == first["winner"]
        forced = _j(out, "real_hit/forced")
        assert forced["source"] == "race" and forced["race"]
    np.testing.assert_array_equal(outs[0]["real_hit/params"],
                                  outs[1]["real_hit/params"])


def test_two_groupings_under_all_reduce_update_bitwise_alike(races):
    outs, _ = races
    for out in outs:
        assert len(_j(out, "grp_single/groups_after")) == 1
        assert len(_j(out, "grp_wfbp/groups_after")) > 1
        np.testing.assert_array_equal(out["grp_single/params"],
                                      out["grp_wfbp/params"])
        np.testing.assert_array_equal(out["grp_single/losses"],
                                      out["grp_wfbp/losses"])


def test_cross_world_resume_installs_the_cached_schedule(races):
    """The resize seam consults the schedule cache (the JAX trainer's
    ``_cached_schedule_entry``): a 2-rank run resuming a world-1 run's
    commit installs the entry committed at its own key."""
    from mgwfbp_tpu_torch.telemetry import events

    outs, _ = races
    for out in outs:
        groups = _j(out, "resume_cached/groups_after")
        assert len(groups) == 1 and int(out["resume_cached/iteration"]) == 4
        rows = events.read_event_set(str(out["resume_cached/events"]))
        (resize,) = events.events_of(rows, "resize")
        assert resize["schedule_source"] == "schedule-cache"
        assert resize["num_groups"] == 1


def test_autotune_report_tool_renders_a_port_entry(races):
    _, tmp = races
    path = os.path.join(tmp, "cache", "real",
                        "lenet_w2_all_reduce_None_b4.json")
    entry = at.load_cache_entry(path)
    env = {k: v for k, v in os.environ.items() if k in (
        "PATH", "HOME", "TMPDIR", "LANG", "LC_ALL", "LD_LIBRARY_PATH")}
    env["PYTHONPATH"] = ROOT
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "autotune_report.py"),
         path], capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode == 0, res.stderr
    assert f"committed winner: {entry['winner']}" in res.stdout
    for e in entry["race"]:
        assert e["label"] in res.stdout


# -- the swap through the interchange form -----------------------------------------


@pytest.fixture(scope="module")
def swapped(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("swap"))
    cfg = dict(batch_size=4, num_batches_per_epoch=4, max_epochs=2, seed=5,
               augment=False, lr=0.01, policy="threshold", threshold=3000,
               comm_op="rs_fwd_ag", logdir=os.path.join(tmp, "logs"),
               checkpoint_dir=os.path.join(tmp, "ck"), ckpt_async=False)
    outs = worker.run_ranks(2, tmp, {"tasks": ["swap"],
                                     "swap": {"cfg": cfg, "profile": False}})
    return outs, tmp


def test_rs_fwd_ag_swaps_to_all_reduce_and_back_losslessly(swapped):
    outs, _ = swapped
    for out in outs:
        assert bool(out["to_ar/lossless"]) and bool(out["back/lossless"])
        assert str(out["to_ar/comm_op"]) == "all_reduce"
        assert not bool(out["to_ar/sharded"])
        assert str(out["back/comm_op"]) == "rs_fwd_ag"
        assert int(out["back/step"]) == 6
    for key in ("saved/params", "back/params"):
        np.testing.assert_array_equal(outs[0][key], outs[1][key])


def test_checkpoint_written_after_the_swap_restores_in_jax(swapped):
    outs, tmp = swapped
    cfg = jax_make_config(
        "lenet", batch_size=4, num_batches_per_epoch=4, max_epochs=2, seed=5,
        augment=False, lr=0.01, policy="threshold", threshold=3000,
        logdir="", checkpoint_dir=os.path.join(tmp, "ck"),
        comm_op="all_reduce")
    t = JaxTrainer(cfg, synthetic_data=True, profile_backward=False,
                   mesh=make_mesh(MeshSpec(data=2), devices=jax.devices()[:2]))
    try:
        assert t.iteration == int(outs[0]["saved/iteration"])
        got = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
               for path, v in jax.tree_util.tree_flatten_with_path(
                   t._eval_params())[0]}
        pre = "saved/flax/"
        want = {k[len(pre):]: v for k, v in outs[0].items()
                if k.startswith(pre)}
        assert got.keys() == want.keys() and got
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    finally:
        t.close()
