"""Port vs reference: the cross-step lowering ``rs_fwd_ag``
(mgwfbp_tpu_torch.parallel.{solver,allreduce}, train.step, train.trainer,
checkpoint, telemetry.overlap vs their mgwfbp_tpu counterparts).

  * the cross-step solver (``cross_step_phase_costs``, ``forward_prior_tf``,
    ``simulate_cross_step``, ``auto_groups_cross_step``, ``effective_cost_fn``
    and ``build_schedule`` for rs_fwd_ag) equals the JAX functions to 1e-12
    relative on seeded sizes, tb and tf, and a planned reducer's groups and
    predictions equal the JAX ``make_merged_allreduce``'s;
  * the cross-step overlap replay (``attribute_overlap_cross_step``,
    ``summarize``) equals the JAX one;
  * the carry: the port's shard layout of a parameter tree equals the JAX
    ``scatter_params`` rows, and it unpacks back bit for bit;
  * 2 gloo ranks, the narrow ResNet-20: over 10 ``TrainStep``s rs_fwd_ag's
    parameters equal the port's own rs_opt_ag's bit for bit, with and
    without the clip (the same shard update; only the gather moves), with
    G reduce-scatters, G all-gathers (none on the first step) and the
    clip's all-reduce per step; between steps the module is one update
    stale and a forward of it raises until ``materialize``;
  * 2 gloo ranks, the ``Trainer``: an rs_fwd_ag run ends where an
    rs_opt_ag run ends, bit for bit; every reader of the stale parameters
    (evaluation, the checkpoint save, the end of ``fit``, ``--pretrain``,
    the rollback, the SIGTERM drain and its resume) sees what rs_opt_ag
    sees; checkpoints interchange with ``all_reduce`` both ways; a
    preempted run resumes bit for bit with the carry in flight; a
    non-finite step keeps the pre-step shards and count; the forward
    profile lands in ``tb_profile.json`` (schema 2, ``tf_s``), which the
    JAX reader reads;
  * between the packages: the JAX trainer's rs_fwd_ag step (sharded
    parameter rows) restores in the port, the port's in the JAX trainer,
    and a 2 -> 1 relaunch of the port resumes from the world-2 carry.

Every child runs with an explicit environment and a 240 s bound
(tests/torch_xstep_worker.py).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from mgwfbp_tpu.config import make_config as jax_make_config
from mgwfbp_tpu.optim import OptimSpec as JaxOptimSpec
from mgwfbp_tpu.parallel import costmodel as jcm
from mgwfbp_tpu.parallel import solver as js
from mgwfbp_tpu.parallel.allreduce import make_merged_allreduce as jax_reducer
from mgwfbp_tpu.parallel.mesh import MeshSpec, make_mesh
from mgwfbp_tpu.profiling import load_layer_profile as jax_load_layer_profile
from mgwfbp_tpu.telemetry import overlap as jov
from mgwfbp_tpu_torch.config import make_config
from mgwfbp_tpu_torch.convert import flatten_flax, variables_to_flax
from mgwfbp_tpu_torch.models.resnet_cifar import CifarResNet
from mgwfbp_tpu_torch.optim import OptimSpec
from mgwfbp_tpu_torch.parallel import costmodel as tcm
from mgwfbp_tpu_torch.parallel import solver as ts
from mgwfbp_tpu_torch.parallel.allreduce import (
    plan_merged_allreduce,
    sharded_optim_step,
)
from mgwfbp_tpu_torch.telemetry import overlap as tov
from mgwfbp_tpu_torch.train import Trainer

import torch_xstep_worker as worker

REL = 1e-12
STEPS = 10


def _rel(a: float, b: float) -> bool:
    return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)


def _close_tuple(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _rel(float(g), float(w)), (got, want)


def _problem(seed: int, n: int = 12):
    rs = np.random.RandomState(seed)
    sizes = rs.randint(10, 300_000, n).tolist()
    tb = rs.uniform(1e-5, 2e-3, n).tolist()
    tf = rs.uniform(5e-6, 1e-3, n).tolist()
    ab = dict(alpha=float(rs.uniform(1e-6, 1e-3)),
              beta=float(rs.uniform(1e-11, 1e-9)),
              gamma=float(rs.uniform(0, 5e-5)),
              overlap=float(rs.uniform(0.3, 1.0)),
              pack_beta=float(rs.uniform(0, 1e-11)),
              update_beta=float(rs.uniform(0, 3e-12)),
              ag_fraction=float(rs.uniform(0.02, 0.98)))
    return sizes, tb, tf, tcm.AlphaBeta(**ab), jcm.AlphaBeta(**ab)


# -- the solver ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cross_step_solver_equals_jax(seed):
    sizes, tb, tf, ours, theirs = _problem(seed)
    nbytes = [4 * s for s in sizes]
    (rs_o, ag_o), (rs_t, ag_t) = (ts.cross_step_phase_costs(ours),
                                  js.cross_step_phase_costs(theirs))
    eff_o = ts.effective_cost_fn(ours, "rs_fwd_ag")
    eff_t = js.effective_cost_fn(theirs, "rs_fwd_ag")
    for b in (1.0, 4e3, 3e6, 1e8):
        assert _rel(rs_o(b), rs_t(b)) and _rel(ag_o(b), ag_t(b))
        assert _rel(eff_o(b), eff_t(b))
        assert _rel(rs_o(b) + ag_o(b), eff_o(b))
    assert ts.forward_prior_tf(tb) == js.forward_prior_tf(tb)
    for groups in ([[i] for i in range(len(sizes))],
                   [list(range(len(sizes)))],
                   [[0, 1, 2], [3], [4, 5, 6, 7], [8, 9, 10, 11]]):
        _close_tuple(
            ts.simulate_cross_step(groups, nbytes, tb, tf, rs_o, ag_o,
                                   ours.gamma, ours.overlap, ours.pack_beta),
            js.simulate_cross_step(groups, nbytes, tb, tf, rs_t, ag_t,
                                   theirs.gamma, theirs.overlap,
                                   theirs.pack_beta))
    assert ts.auto_groups_cross_step(sizes, tb, tf, ours) == \
        js.auto_groups_cross_step(sizes, tb, tf, theirs)


@pytest.mark.parametrize("policy", ["mgwfbp", "auto", "threshold", "single",
                                    "wfbp"])
@pytest.mark.parametrize("with_tf", [True, False])
def test_build_schedule_rs_fwd_ag_equals_jax(policy, with_tf):
    sizes, tb, tf, ours, theirs = _problem(7)
    layers_t = [ts.LayerSpec(f"l{i}", s) for i, s in enumerate(sizes)]
    layers_j = [js.LayerSpec(f"l{i}", s) for i, s in enumerate(sizes)]
    kw = dict(tf=tf if with_tf else None, policy=policy, threshold=200_000,
              comm_op="rs_fwd_ag")
    got = ts.build_schedule(layers_t, tb, cost_model=ours, **kw)
    want = js.build_schedule(layers_j, tb, cost_model=theirs, **kw)
    assert got.groups == want.groups and got.dcn_groups == want.dcn_groups
    assert got.policy_detail == want.policy_detail
    _close_tuple((got.predicted_total_time, got.predicted_nonoverlap_time,
                  got.predicted_comm_time),
                 (want.predicted_total_time, want.predicted_nonoverlap_time,
                  want.predicted_comm_time))
    assert [b for b, _ in got.predicted_group_times] == \
        [b for b, _ in want.predicted_group_times]
    _close_tuple([t for _, t in got.predicted_group_times],
                 [t for _, t in want.predicted_group_times])


def _narrow():
    m = CifarResNet(depth=worker.DEPTH, widths=worker.WIDTHS,
                    num_classes=worker.NC)
    params, _ = variables_to_flax(m)
    return m, params


def test_planned_reducer_equals_jax_make_merged_allreduce():
    """The port's plan (groups, predictions) for the narrow ResNet-20 on
    rs_fwd_ag equals the JAX reducer's on the same Flax tree."""
    model, params = _narrow()
    cm_t = tcm.lookup_alpha_beta("10GbE", 4)
    cm_j = jcm.lookup_alpha_beta("10GbE", 4)
    sched, layout, perm, _ = plan_merged_allreduce(
        model, policy="auto", cost_model=cm_t, comm_op="rs_fwd_ag")
    red = jax_reducer(
        jax.tree_util.tree_map(np.asarray, params), axis_name="data",
        policy="auto", cost_model=cm_j, comm_op="rs_fwd_ag",
        optim_spec=JaxOptimSpec(lr=0.1), world_size=4)
    assert list(perm) == list(red.perm)
    assert sched.groups == red.schedule.groups
    assert sched.policy_detail == red.schedule.policy_detail
    _close_tuple((sched.predicted_total_time, sched.predicted_comm_time),
                 (red.schedule.predicted_total_time,
                  red.schedule.predicted_comm_time))


def test_carry_layout_equals_jax_scatter_params():
    """The rows each rank carries (the port packs the Flax-layout leaves
    on its layout) equal the JAX ``scatter_params`` rows, and unpack back
    bit for bit."""
    model, params = _narrow()
    sched, layout, perm, leaves = plan_merged_allreduce(
        model, policy="threshold", threshold=3000, comm_op="rs_fwd_ag")
    optim = sharded_optim_step(OptimSpec(lr=0.1), layout, perm, leaves, 4)
    host = list(flatten_flax(params).values())
    rows = optim.pack_slot(host)
    red = jax_reducer(
        jax.tree_util.tree_map(np.asarray, params), axis_name="data",
        policy="threshold", threshold=3000, comm_op="rs_fwd_ag",
        optim_spec=JaxOptimSpec(lr=0.1), world_size=4)
    want = red.optim.scatter_params(jax.tree_util.tree_map(np.asarray,
                                                           params))
    assert len(rows) == len(want.groups)
    for got, w in zip(rows, want.groups):
        np.testing.assert_array_equal(got, np.asarray(w))
    back = optim.unpack_slot(rows)
    for a, b in zip(back, host):
        np.testing.assert_array_equal(a.reshape(b.shape), b)


# -- overlap ------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_cross_step_overlap_replay_equals_jax(seed):
    sizes, tb, tf, ours, theirs = _problem(seed, n=10)
    groups = [[0, 1], [2], [3, 4, 5], [6], [7, 8, 9]]
    nbytes = [4 * sum(sizes[i] for i in g) for g in groups]
    rs = np.random.RandomState(seed + 10)
    rs_s = rs.uniform(1e-5, 1e-3, len(groups)).tolist()
    ag_s = rs.uniform(1e-5, 1e-3, len(groups)).tolist()
    got, fe_o = tov.attribute_overlap_cross_step(groups, tb, tf, rs_s, ag_s,
                                                 nbytes)
    want, fe_j = jov.attribute_overlap_cross_step(groups, tb, tf, rs_s, ag_s,
                                                  nbytes)
    assert _rel(fe_o, fe_j)
    for g, w in zip(got, want):
        for f in ("start_s", "comm_s", "hidden_s", "exposed_s", "ag_start_s",
                  "ag_s"):
            assert _rel(getattr(g, f), getattr(w, f)), f

    class Red:
        comm_op = "rs_fwd_ag"

    for measured in (None, rs_s):
        r_o, r_j = Red(), Red()
        r_o.layout = type("L", (), {
            "groups": groups, "num_groups": len(groups),
            "group_sizes": [b // 4 for b in nbytes],
            "dtypes": [torch.float32] * len(groups)})()
        r_j.layout = type("L", (), {
            "groups": groups, "num_groups": len(groups),
            "group_sizes": [b // 4 for b in nbytes],
            "dtypes": [np.float32] * len(groups)})()
        s_o = tov.summarize(r_o, ours, tb, 0.05, measured=measured, tf=tf)
        s_j = jov.summarize(r_j, theirs, tb, 0.05, measured=measured, tf=tf)
        d_o, d_j = s_o.to_event_fields(), s_j.to_event_fields()
        assert d_o.keys() == d_j.keys()
        for k in d_o:
            if isinstance(d_o[k], float):
                assert _rel(d_o[k], d_j[k]), k
            else:
                assert d_o[k] == d_j[k], k
        assert s_o.group_event_fields(3)[1].keys() == \
            s_j.group_event_fields(3)[1].keys()


# -- 2 ranks: the step ----------------------------------------------------------


@pytest.fixture(scope="module")
def traj(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("xstep_traj"))
    spec = {"tasks": ["traj"], "traj": {
        "seed": 3, "batch": 4, "steps": STEPS, "threshold": 3000,
        "health": ["opt", "fwd"],
        "runs": [["opt", "rs_opt_ag", None, "float32"],
                 ["fwd", "rs_fwd_ag", None, "float32"],
                 ["opt_clip", "rs_opt_ag", 0.5, "float32"],
                 ["fwd_clip", "rs_fwd_ag", 0.5, "float32"]]}}
    return worker.run_ranks(2, d, spec)


@pytest.mark.parametrize("clip", ["", "_clip"])
def test_rs_fwd_ag_equals_rs_opt_ag_bitwise_over_ten_steps(traj, clip):
    for out in traj:
        for k in range(1, STEPS + 1):
            np.testing.assert_array_equal(out[f"fwd{clip}/params{k}"],
                                          out[f"opt{clip}/params{k}"])
        np.testing.assert_array_equal(out[f"fwd{clip}/final"],
                                      out[f"opt{clip}/final"])
    np.testing.assert_array_equal(traj[0][f"fwd{clip}/final"],
                                  traj[1][f"fwd{clip}/final"])


@pytest.mark.parametrize("clip", ["", "_clip"])
def test_collectives_per_step(traj, clip):
    """G reduce-scatters and the clip's all-reduce every step; the G
    all-gathers of the previous update from the second step on, in the
    next forward (rs_opt_ag issues them in its own step)."""
    out = traj[0]
    g = int(out[f"fwd{clip}/groups"])
    c = 1 if clip else 0
    assert list(out[f"opt{clip}/launches"]) == [2 * g + c] * STEPS
    assert list(out[f"fwd{clip}/launches"]) == \
        [g + c] + [2 * g + c] * (STEPS - 1)
    # the last update's gathers: launched by materialize
    assert int(out[f"fwd{clip}/materialize_launches"]) == g


def test_health_statistics_read_the_shards_as_rs_opt_ag_reads_them(traj):
    """The in-step health statistics of rs_fwd_ag: the local gradient
    norms equal rs_opt_ag's bit for bit; the update ratio, taken on the
    carried shards (old and new, summed over the ranks), equals rs_opt_ag's
    on the gathered parameters to float32 rounding."""
    for out in traj:
        opt, fwd = out["opt/health"], out["fwd/health"]
        assert opt.shape == fwd.shape and opt.shape[0] == STEPS
        np.testing.assert_array_equal(fwd[:, :-1], opt[:, :-1])
        np.testing.assert_allclose(fwd[:, -1], opt[:, -1], rtol=1e-5)
        assert np.all(fwd[:, -1] > 0)


def test_stale_module_raises_until_materialized(traj):
    for out in traj:
        assert bool(out["fwd/stale_differs"])
        assert bool(out["fwd/stale_forward_raised"])


# -- 2 ranks: the trainer ---------------------------------------------------------


def _cfg(tmp: str, name: str, **kw) -> dict:
    base = dict(batch_size=4, num_batches_per_epoch=4, max_epochs=2, seed=5,
                augment=False, lr=0.05, policy="threshold", threshold=3000,
                logdir=os.path.join(tmp, "logs", name),
                checkpoint_dir=os.path.join(tmp, "ck", name),
                ckpt_async=False)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(rank outputs, the checkpoint root) of one 2-rank run of every
    trainer scenario."""
    tmp = str(tmp_path_factory.mktemp("xstep_trainer"))
    lenet = dict(dnn="lenet")
    runs = [
        # readers with the parameters stale, then the same on rs_opt_ag
        {"name": "fwd_read", "read": True,
         "cfg": _cfg(tmp, "fwd_read", comm_op="rs_fwd_ag")},
        {"name": "opt_read", "read": True,
         "cfg": _cfg(tmp, "opt_read", comm_op="rs_opt_ag")},
        # two epochs through fit, with a mid-epoch save every 2 steps
        {"name": "fwd", "epochs": 2,
         "cfg": _cfg(tmp, "fwd", comm_op="rs_fwd_ag", ckpt_every_steps=2)},
        {"name": "opt", "epochs": 2,
         "cfg": _cfg(tmp, "opt", comm_op="rs_opt_ag", ckpt_every_steps=2)},
        # interchange: all_reduce resumes rs_fwd_ag's epoch-1 boundary (its
        # step 8 is the newest: restored, then no epoch left)
        {"name": "ar_from_fwd", "epochs": 0,
         "cfg": _cfg(tmp, "fwd", comm_op="all_reduce")},
        {"name": "ar", "epochs": 1,
         "cfg": _cfg(tmp, "ar", comm_op="all_reduce")},
        {"name": "fwd_from_ar", "epochs": 0,
         "cfg": _cfg(tmp, "ar", comm_op="rs_fwd_ag")},
        # a SIGTERM drain at step 3 (the carry in flight), then the resume
        {"name": "pre", "epochs": 2, "env": {
            "MGWFBP_FAULT_PLAN": "preempt@step=3"},
         "cfg": _cfg(tmp, "pre", comm_op="rs_fwd_ag")},
        {"name": "pre_resumed", "epochs": 2,
         "cfg": _cfg(tmp, "pre", comm_op="rs_fwd_ag")},
        # --pretrain from rs_fwd_ag's committed steps
        {"name": "pretrained", "epochs": 0,
         "cfg": _cfg(tmp, "pretrained", comm_op="rs_fwd_ag",
                     pretrain=os.path.join(tmp, "ck", "fwd",
                                           make_config("resnet20", **_cfg(
                                               tmp, "fwd", comm_op="rs_fwd_ag"
                                           ), nworkers=2).tag()))},
        # a rollback after a non-finite step, on both lowerings
        {"name": "fwd_rb", "epochs": 1, "env": {
            "MGWFBP_FAULT_PLAN": "nan@step=3"},
         "cfg": _cfg(tmp, "fwd_rb", comm_op="rs_fwd_ag", ckpt_every_steps=2,
                     bad_step_limit=1)},
        {"name": "opt_rb", "epochs": 1, "env": {
            "MGWFBP_FAULT_PLAN": "nan@step=3"},
         "cfg": _cfg(tmp, "opt_rb", comm_op="rs_opt_ag", ckpt_every_steps=2,
                     bad_step_limit=1)},
        # the non-finite guard, and the forward profile (LeNet)
        {"name": "guard", "guard": True, "profile": True, **lenet,
         "cfg": _cfg(tmp, "guard", comm_op="rs_fwd_ag", policy="mgwfbp",
                     bad_step_limit=0)},
        # for the JAX reader: LeNet at rs_fwd_ag, one epoch
        {"name": "lenet", "epochs": 1, **lenet,
         "cfg": _cfg(tmp, "lenet", comm_op="rs_fwd_ag", lr=0.01)},
    ]
    outs = worker.run_ranks(2, tmp, {"tasks": ["trainer"],
                                     "trainer": {"runs": runs}})
    return outs, tmp


def _params(out: dict, name: str) -> dict:
    pre = f"{name}/params/"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


def _equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys() and a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_trainer_rs_fwd_ag_ends_where_rs_opt_ag_ends(trained):
    outs, _ = trained
    for out in outs:
        assert str(out["fwd/comm_op"]) == "rs_fwd_ag"
        _equal(_params(out, "fwd"), _params(out, "opt"))
        for kind in ("bstats", "trace"):
            _equal({k: v for k, v in out.items()
                    if k.startswith(f"fwd/{kind}/")},
                   {k.replace("opt/", "fwd/", 1): v for k, v in out.items()
                    if k.startswith(f"opt/{kind}/")})
        assert int(out["fwd/count"]) == int(out["opt/count"]) == 8
    _equal(_params(outs[0], "fwd"), _params(outs[1], "fwd"))


def test_stale_readers_see_current_parameters(trained):
    """Evaluation and the checkpoint save run while the module is one
    update stale; each materializes first, so both equal rs_opt_ag's."""
    outs, tmp = trained
    for out in outs:
        assert bool(out["fwd_read/stale"]) and not bool(out["opt_read/stale"])
        np.testing.assert_array_equal(out["fwd_read/eval"],
                                      out["opt_read/eval"])
        _equal(_params(out, "fwd_read"), _params(out, "opt_read"))
    from mgwfbp_tpu_torch.checkpoint import open_step, read_step

    steps = {}
    for name in ("fwd_read", "opt_read"):
        root = os.path.join(tmp, "ck", name)
        (tag,) = os.listdir(root)
        params, _, _ = read_step(os.path.join(root, tag), 4)
        src = open_step(os.path.join(root, tag, "sharded", f"{4:08d}"))
        assert src.section_kind("params") == (
            "sharded" if name == "fwd_read" else "replicated")
        steps[name] = params
    _equal(steps["fwd_read"], steps["opt_read"])
    _equal(steps["fwd_read"], _params(outs[0], "fwd_read"))


def test_serving_reads_the_stale_run_s_commit_as_rs_opt_ag_s(trained,
                                                             monkeypatch):
    """What a serving replica or the shadow scorer publishes is the
    committed step: rs_fwd_ag's (sharded parameter rows, saved while the
    module was stale) serves the logits rs_opt_ag's does."""
    from mgwfbp_tpu_torch import models as pzoo
    from mgwfbp_tpu_torch.serving.model import ServingModel

    _, tmp = trained
    monkeypatch.setitem(pzoo._REGISTRY, "resnet20", worker.narrow_resnet)
    x = np.random.RandomState(2).randn(3, 32, 32, 3).astype(np.float32)
    got = []
    for name in ("fwd_read", "opt_read"):
        root = os.path.join(tmp, "ck", name)
        (tag,) = os.listdir(root)
        model = ServingModel(*pzoo.create_model("resnet20"), device="cpu",
                             max_batch=4)
        snap = model.load_step(os.path.join(root, tag), 4)
        assert snap.step == 4
        got.append(model.run_padded(x)[0])
    np.testing.assert_array_equal(got[0], got[1])


def test_checkpoint_interchange_with_all_reduce(trained):
    outs, _ = trained
    for out in outs:
        assert str(out["ar_from_fwd/comm_op"]) == "all_reduce"
        _equal(_params(out, "ar_from_fwd"), _params(out, "fwd"))
        assert int(out["ar_from_fwd/iteration"]) == 8
        _equal(_params(out, "fwd_from_ar"), _params(out, "ar"))
        assert int(out["fwd_from_ar/count"]) == int(out["ar/step"]) == 4


def test_preempted_run_resumes_bitwise_with_the_carry_in_flight(trained):
    outs, _ = trained
    for out in outs:
        assert bool(out["pre/preempted"])
        assert int(out["pre/iteration"]) == 3
        _equal(_params(out, "pre_resumed"), _params(out, "fwd"))
        assert int(out["pre_resumed/count"]) == 8


def test_pretrain_and_rollback_rescatter_the_carry(trained):
    outs, _ = trained
    for out in outs:
        _equal(_params(out, "pretrained"), _params(out, "fwd"))
        _equal(_params(out, "fwd_rb"), _params(out, "opt_rb"))
        assert int(out["fwd_rb/count"]) == int(out["opt_rb/count"])


def test_nonfinite_step_keeps_the_pre_step_carry(trained):
    outs, _ = trained
    for out in outs:
        assert float(out["guard/guard_nonfinite"]) > 0
        assert bool(out["guard/guard_kept"])


def test_trainer_writes_the_forward_profile(trained):
    _, tmp = trained
    root = os.path.join(tmp, "logs", "guard")
    (tag,) = os.listdir(root)
    path = os.path.join(root, tag, "tb_profile.json")
    with open(path) as f:
        doc = json.load(f)
    assert doc["schema_version"] == 2 and doc["tf_source"] == "hooks"
    assert len(doc["tf_s"]) == len(doc["tb_s"]) == 10
    assert all(t >= 0 for t in doc["tf_s"]) and sum(doc["tf_s"]) > 0
    assert jax_load_layer_profile(path)["tf_s"] == doc["tf_s"]


# -- between the packages ---------------------------------------------------------


def _jax_lenet_cfg(ckpt_dir: str, **kw):
    base = dict(batch_size=4, num_batches_per_epoch=4, max_epochs=2, seed=5,
                augment=False, lr=0.01, policy="threshold", threshold=3000,
                logdir="", checkpoint_dir=ckpt_dir, comm_op="rs_fwd_ag")
    base.update(kw)
    return jax_make_config("lenet", **base)


def _jax_trainer(cfg):
    from mgwfbp_tpu.train.trainer import Trainer as JaxTrainer

    return JaxTrainer(cfg, synthetic_data=True, profile_backward=False,
                      mesh=make_mesh(MeshSpec(data=2),
                                     devices=jax.devices()[:2]))


def test_port_rs_fwd_ag_step_restores_in_jax(trained):
    outs, tmp = trained
    t = _jax_trainer(_jax_lenet_cfg(os.path.join(tmp, "ck", "lenet"),
                                    comm_op="all_reduce"))
    try:
        assert t.iteration == 4
        got = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
               for path, v in jax.tree_util.tree_flatten_with_path(
                   t._eval_params())[0]}
        _equal(got, _params(outs[0], "lenet"))
    finally:
        t.close()


def test_jax_rs_fwd_ag_step_restores_in_the_port(tmp_path):
    """The JAX trainer's rs_fwd_ag run (2 devices) commits sharded
    parameter rows; the port resumes that step at one worker with the
    JAX run's gathered parameters, bit for bit."""
    ck = str(tmp_path / "ck")
    t = _jax_trainer(_jax_lenet_cfg(ck, max_epochs=1))
    t.fit(1)
    t.checkpointer.wait()
    want = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                t._eval_params())[0]}
    tag = t.config.tag()
    t.close()
    from mgwfbp_tpu_torch.checkpoint import open_step

    cfg = make_config("lenet", batch_size=4, num_batches_per_epoch=4,
                      max_epochs=1, seed=5, augment=False, lr=0.01,
                      logdir="", checkpoint_dir=None,
                      pretrain=os.path.join(ck, tag))
    p = Trainer(cfg, device="cpu", synthetic_data=True,
                profile_backward=False)
    try:
        params, _ = variables_to_flax(p.model)
        _equal(flatten_flax(params), want)
        assert p.iteration == 4
    finally:
        p.close()
    steps = sorted(int(s) for s in os.listdir(os.path.join(ck, tag,
                                                           "sharded")))
    assert open_step(os.path.join(ck, tag, "sharded", f"{steps[-1]:08d}")) \
        .section_kind("params") == "sharded"


def test_two_to_one_relaunch_resumes_the_world_two_carry(trained,
                                                         monkeypatch):
    """A one-process relaunch under elastic resume reads the world-2
    rs_fwd_ag run's sharded rows (its newest step) and resumes where that
    run ended, with the replicated optimizer of one worker."""
    outs, tmp = trained
    from mgwfbp_tpu_torch import models as pzoo

    monkeypatch.setenv("MGWFBP_ELASTIC_RESUME", "1")
    monkeypatch.delenv("MGWFBP_FAULT_PLAN", raising=False)
    monkeypatch.setitem(pzoo._REGISTRY, "resnet20", worker.narrow_resnet)
    cfg = make_config("resnet20", **_cfg(tmp, "fwd", comm_op="rs_fwd_ag"))
    t = Trainer(cfg, device="cpu", synthetic_data=True,
                profile_backward=False)
    try:
        assert t.world == 1 and t.reducer is None and t.iteration == 8
        params, _ = variables_to_flax(t.model)
        _equal(flatten_flax(params), _params(outs[0], "fwd"))
        m = t.train_epoch(t.start_epoch)
        assert np.isfinite(m["loss"])
    finally:
        t.close()
