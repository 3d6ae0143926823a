"""Sharded optimizer checkpoints (rs_opt_ag) between the packages and
across world sizes, on the CPU (LeNet on the shrunk synthetic MNIST twin;
multi-rank port runs are gloo processes, tests/torch_lowering_worker.py).

  * an rs_opt_ag step of the JAX ``Trainer`` (a 2-device mesh) restores
    in the port at world 1 (cross-world, the replicated optimizer) and at
    world 2 (all_reduce, and rs_opt_ag re-sharding it): parameters and the
    momentum trace bit for bit;
  * an rs_opt_ag step of the port (2 gloo ranks, each writing its rows of
    ``opt.s0.g<gi>``) restores through the JAX reader into the replicated
    optax tree, and natively into a JAX rs_opt_ag trainer at world 2
    (``read_rows`` on its own layout), bit for bit;
  * the port's rs_opt_ag step restores at worlds 4 and 1;
  * an rs_opt_ag step restores into an all_reduce run and an all_reduce
    step into an rs_opt_ag run, and each resumed run ends where an
    uninterrupted all_reduce one does (1e-6: the two lowerings round the
    update differently);
  * with batch statistics (the narrow ResNet-20 at 2 gloo ranks), a
    resumed rs_opt_ag run ends bit for bit where an uninterrupted one
    does, and its step restores into an all_reduce run and through the
    JAX reader, the statistics included.
"""

import os

import jax
import numpy as np
import pytest
import torch

from mgwfbp_tpu.checkpoint import Checkpointer as JaxCheckpointer
from mgwfbp_tpu.config import make_config as jax_make_config
from mgwfbp_tpu.parallel.mesh import MeshSpec, make_mesh
from mgwfbp_tpu.train.trainer import Trainer as JaxTrainer
from mgwfbp_tpu_torch.config import make_config
from mgwfbp_tpu_torch.convert import (
    flatten_flax,
    flax_path,
    momentum_to_flax,
    variables_to_flax,
)
from mgwfbp_tpu_torch.train import Trainer

import torch_lowering_worker

SYNTH = {"MGWFBP_SYNTH_TRAIN_N": "64", "MGWFBP_SYNTH_VAL_N": "32"}
KW = dict(batch_size=4, lr=0.05, max_epochs=4, seed=7, policy="wfbp",
          num_batches_per_epoch=2, logdir="")


@pytest.fixture(autouse=True, scope="module")
def _small_twin():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    saved = {k: os.environ.get(k) for k in
             (*SYNTH, "MGWFBP_FAULT_PLAN", "MGWFBP_ELASTIC_RESUME")}
    os.environ.update(SYNTH)
    os.environ.pop("MGWFBP_FAULT_PLAN", None)
    os.environ.pop("MGWFBP_ELASTIC_RESUME", None)
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    torch.set_num_threads(before)


def _np(tree) -> dict:
    return flatten_flax(jax.tree_util.tree_map(np.asarray, tree))


def _jax_trace(jt: JaxTrainer) -> dict:
    """The JAX trainer's momentum trace, gathered when sharded."""
    state = jt.state
    opt = (jt.reducer.optim.gather(state.opt_state, jt.tx, state.params)
           if jt._sharded_opt else state.opt_state)
    traces = [s.trace for s in jax.tree_util.tree_leaves(
        opt, is_leaf=lambda n: hasattr(n, "trace"))]
    return _np(traces[0])


def _jax_trainer(root, world: int, comm_op: str) -> JaxTrainer:
    cfg = jax_make_config("lenet", checkpoint_dir=str(root), comm_op=comm_op,
                          **KW)
    return JaxTrainer(cfg, synthetic_data=True, profile_backward=False,
                      mesh=make_mesh(MeshSpec(data=world),
                                     devices=jax.devices()[:world]))


def _port_trainer(root, comm_op: str = "all_reduce") -> Trainer:
    return Trainer(make_config("lenet", checkpoint_dir=str(root),
                               comm_op=comm_op, **KW),
                   device="cpu", synthetic_data=True, profile_backward=False)


def _port_state(t: Trainer) -> tuple[dict, dict]:
    return (flatten_flax(variables_to_flax(t.model)[0]),
            momentum_to_flax(t.model, t.optimizer))


def _rank_part(out: dict, name: str, part: str) -> dict:
    pre = f"{name}/{part}/"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


def _rank_state(out: dict, name: str) -> tuple[dict, dict]:
    return _rank_part(out, name, "params"), _rank_part(out, name, "trace")


def _assert_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _runs(root, *specs, dnn: str = "lenet") -> list:
    """Trainer runs for the worker: (name, comm_op, epochs, env)."""
    return [{"name": name, "dnn": dnn, "epochs": epochs, "env": env,
             "cfg": {**KW, "checkpoint_dir": str(root), "comm_op": op}}
            for name, op, epochs, env in specs]


# -- JAX writes, the port reads ----------------------------------------------


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    """An rs_opt_ag epoch of the JAX trainer on a 2-device mesh, committed;
    (checkpoint root, params, gathered trace)."""
    root = tmp_path_factory.mktemp("jax_rsopt")
    jt = _jax_trainer(root, 2, "rs_opt_ag")
    assert jt._sharded_opt
    jt.fit(1)
    want = (_np(jt.state.params), _jax_trace(jt))
    assert jt.checkpointer is not None
    jt.close()
    src = JaxCheckpointer(os.path.join(str(root), jt.config.tag()))
    assert src.open_sharded(src.latest_step()).section_kind("opt") == "sharded"
    src.close()
    return root, want


def test_jax_rs_opt_ag_step_restores_in_the_port_at_world_1(jax_step):
    root, (want_p, want_t) = jax_step
    os.environ["MGWFBP_ELASTIC_RESUME"] = "1"
    try:
        t = _port_trainer(root)
    finally:
        os.environ.pop("MGWFBP_ELASTIC_RESUME")
    try:
        assert t.world == 1 and t.reducer is None and t.iteration == 2
        params, trace = _port_state(t)
        _assert_equal(params, want_p)
        _assert_equal(trace, want_t)
        assert np.abs(np.concatenate([a.ravel() for a in trace.values()])
                      ).max() > 0
    finally:
        t.close()


def test_jax_rs_opt_ag_step_restores_in_the_port_at_world_2(jax_step,
                                                            tmp_path):
    root, (want_p, want_t) = jax_step
    ranks = torch_lowering_worker.spawn(2, str(tmp_path), {
        "task": "trainer",
        "runs": _runs(root, ("ar", "all_reduce", 0, {}),
                      ("rs", "rs_opt_ag", 0, {})),
    }, {"unused": np.zeros(1)}, timeout_s=240)
    for out in ranks:
        for name in ("ar", "rs"):
            params, trace = _rank_state(out, name)
            _assert_equal(params, want_p)
            _assert_equal(trace, want_t)
            assert int(out[f"{name}/iteration"]) == 2
        assert str(out["rs/comm_op"]) == "rs_opt_ag"
        assert int(out["rs/count"]) == int(out["rs/step"]) == 2


# -- the port writes --------------------------------------------------------


@pytest.fixture(scope="module")
def port_step(tmp_path_factory):
    """An rs_opt_ag epoch of the port at 2 gloo ranks, committed at its
    end; (checkpoint root, the run's tag dir, params, gathered trace)."""
    root = tmp_path_factory.mktemp("port_rsopt")
    work = tmp_path_factory.mktemp("port_rsopt_work")
    ranks = torch_lowering_worker.spawn(2, str(work), {
        "task": "trainer", "runs": _runs(root, ("w", "rs_opt_ag", 1, {})),
    }, {"unused": np.zeros(1)}, timeout_s=240)
    params, trace = _rank_state(ranks[0], "w")
    p1, t1 = _rank_state(ranks[1], "w")
    _assert_equal(p1, params)
    _assert_equal(t1, trace)
    tags = [d for d in os.listdir(root) if "-n2-" in d]
    assert len(tags) == 1
    return root, os.path.join(str(root), tags[0]), params, trace


def test_port_rs_opt_ag_step_restores_in_jax(port_step, tmp_path):
    root, tag_dir, want_p, want_t = port_step
    ck = JaxCheckpointer(tag_dir)
    step = ck.latest_step()
    src = ck.open_sharded(step)
    assert src.section_kind("opt") == "sharded" and src.world == 2
    assert sorted(src.manifest["processes"]) == ["0", "1"]
    # the replicated optax tree, through the JAX reader
    jt = _jax_trainer(tmp_path / "template", 1, "all_reduce")
    snap = ck.restore(jt.state)
    ck.close()
    jt.close()
    _assert_equal(_np(snap.state.params), want_p)
    traces = [s.trace for s in jax.tree_util.tree_leaves(
        snap.state.opt_state, is_leaf=lambda n: hasattr(n, "trace"))]
    _assert_equal(_np(traces[0]), want_t)
    # natively, re-sliced onto a JAX rs_opt_ag layout at world 2
    jn = _jax_trainer(root, 2, "rs_opt_ag")
    try:
        assert jn._sharded_opt and jn.iteration == step
        _assert_equal(_np(jn.state.params), want_p)
        _assert_equal(_jax_trace(jn), want_t)
    finally:
        jn.close()


def test_port_rs_opt_ag_step_restores_at_world_4(port_step, tmp_path):
    root, _, want_p, want_t = port_step
    ranks = torch_lowering_worker.spawn(4, str(tmp_path), {
        "task": "trainer",
        "runs": _runs(root, ("r4", "rs_opt_ag", 0,
                             {"MGWFBP_ELASTIC_RESUME": "1"})),
    }, {"unused": np.zeros(1)}, timeout_s=240)
    for out in ranks:
        params, trace = _rank_state(out, "r4")
        _assert_equal(params, want_p)
        _assert_equal(trace, want_t)
        assert int(out["r4/iteration"]) == 2 and int(out["r4/count"]) == 2


def test_port_rs_opt_ag_step_restores_at_world_1(port_step):
    root, _, want_p, want_t = port_step
    os.environ["MGWFBP_ELASTIC_RESUME"] = "1"
    try:
        t = _port_trainer(root, "rs_opt_ag")
    finally:
        os.environ.pop("MGWFBP_ELASTIC_RESUME")
    try:
        assert t.reducer is None and t.comm_op == "all_reduce"
        assert t.iteration == 2
        params, trace = _port_state(t)
        _assert_equal(params, want_p)
        _assert_equal(trace, want_t)
    finally:
        t.close()


# -- switching lowerings at a resume ------------------------------------------


@pytest.mark.parametrize("first,then", [("rs_opt_ag", "all_reduce"),
                                        ("all_reduce", "rs_opt_ag")])
def test_resume_across_lowerings_ends_where_an_uninterrupted_run_does(
        tmp_path, first, then):
    runs = (_runs(tmp_path / "u", ("u", "all_reduce", 2, {}))
            + _runs(tmp_path / "s", ("a", first, 1, {}), ("b", then, 1, {})))
    ranks = torch_lowering_worker.spawn(2, str(tmp_path), {
        "task": "trainer", "runs": runs}, {"unused": np.zeros(1)},
        timeout_s=240)
    for out in ranks:
        assert int(out["b/iteration"]) == int(out["u/iteration"]) == 4
        assert str(out["b/comm_op"]) == then
        for part in (0, 1):
            got = _rank_state(out, "b")[part]
            want = _rank_state(out, "u")[part]
            assert sorted(got) == sorted(want)
            for k in want:
                scale = max(float(np.abs(want[k]).max()), 1e-3)
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                           atol=1e-6 * scale, err_msg=k)
    for k in _rank_state(ranks[0], "b")[0]:
        np.testing.assert_array_equal(_rank_state(ranks[0], "b")[0][k],
                                      _rank_state(ranks[1], "b")[0][k])


# -- a model with batch statistics --------------------------------------------


def test_bn_rs_opt_ag_step_resumes_bitwise_and_restores_with_its_statistics(
        tmp_path):
    runs = (_runs(tmp_path / "u", ("u", "rs_opt_ag", 2, {}), dnn="resnet20")
            + _runs(tmp_path / "s", ("a", "rs_opt_ag", 1, {}),
                    ("b", "rs_opt_ag", 1, {}), ("c", "all_reduce", 0, {}),
                    dnn="resnet20"))
    ranks = torch_lowering_worker.spawn(2, str(tmp_path), {
        "task": "trainer", "runs": runs}, {"unused": np.zeros(1)},
        timeout_s=240)
    want = {part: _rank_part(ranks[0], "b", part)
            for part in ("params", "trace", "bstats")}
    assert want["bstats"] and np.abs(np.concatenate(
        [a.ravel() for a in want["trace"].values()])).max() > 0
    for out in ranks:
        assert (int(out["u/iteration"]) == int(out["b/iteration"])
                == int(out["c/iteration"]) == 4)
        assert str(out["c/comm_op"]) == "all_reduce"
        for part in want:
            _assert_equal(_rank_part(out, "u", part), want[part])
            _assert_equal(_rank_part(out, "b", part), want[part])
            _assert_equal(_rank_part(out, "c", part), want[part])
    tags = [d for d in os.listdir(tmp_path / "s") if "-n2-" in d]
    assert len(tags) == 1
    ck = JaxCheckpointer(os.path.join(str(tmp_path / "s"), tags[0]))
    try:
        src = ck.open_sharded(ck.latest_step())
        assert src.section_kind("opt") == "sharded"
        for section, part in (("params", "params"),
                              ("batch_stats", "bstats")):
            _assert_equal(
                {flax_path(str(doc["path"])): np.asarray(
                    src.read_leaf(section, j))
                 for j, doc in enumerate(src.section_docs(section))},
                want[part])
        _assert_equal(
            {flax_path(str(doc["path"])): np.asarray(
                src.read_leaf("opt", j, slot=0))
             for j, doc in enumerate(src.leaves)},
            want["trace"])
    finally:
        ck.close()
