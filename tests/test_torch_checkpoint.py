"""The port's checkpoints against the JAX package's, on the CPU.

  * the optimizer section round-trips both ways, bit for bit: a step the
    port's trainer commits restores through the JAX package's
    ``Checkpointer.restore`` into the same optax leaves (the momentum trace
    in Flax layout, the schedule's count), params and batch statistics;
    a step the JAX trainer commits restores into the port's
    ``momentum_buffer``s, step counter, carry and weights;
  * a resume in either package from one committed step matches the other
    within the cross-program bound (rtol 2e-5, atol 1e-6), in both
    directions: a narrow ResNet-20 with batch statistics, and the small
    LSTM resumed mid-epoch with its carry;
  * the port's ``Checkpointer`` keeps the JAX one's contract: class-aware
    GC keeps epoch boundaries, a boundary save onto a step save promotes
    the entry, a lost sidecar heals from the manifest, a restore into
    another structure names the offending leaf;
  * an async save owns its payload: steps applied in place after the
    submission do not reach the committed step;
  * what the port cannot read it refuses by name: ``--ckpt-format
    replicated``, an orbax step, a sharded parameter section; a sharded
    optimizer section restores;
  * the serving hot reload reads a step the new ``Checkpointer`` wrote.

Narrow models come from patching both registries (the JAX tests' idiom):
ResNet-20's name with depth 8 and widths (4, 8, 16); the LSTM with hidden
16, one layer, no dropout, and momentum 0.9 (PTB's preset has none), so
that the optimizer section holds a trace behind the norm clip.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgwfbp_tpu import models as jzoo
from mgwfbp_tpu.checkpoint import Checkpointer as JaxCheckpointer
from mgwfbp_tpu.config import make_config as jax_make_config
from mgwfbp_tpu.models import ModelMeta as JaxMeta
from mgwfbp_tpu.parallel.mesh import MeshSpec, make_mesh
from mgwfbp_tpu.train.trainer import Trainer as JaxTrainer
from mgwfbp_tpu.utils.faults import Preempted as JaxPreempted
from mgwfbp_tpu_torch import models as pzoo
from mgwfbp_tpu_torch.checkpoint import (
    Checkpointer,
    CheckpointRestoreError,
    TrainState,
    peek_steps,
    read_step,
    shape_only,
)
from mgwfbp_tpu_torch.config import make_config
from mgwfbp_tpu_torch.convert import flatten_flax, momentum_to_flax, variables_to_flax
from mgwfbp_tpu_torch.models import ModelMeta
from mgwfbp_tpu_torch.train import Trainer
from mgwfbp_tpu_torch.utils.faults import Preempted

RTOL, ATOL = 2e-5, 1e-6  # the repo's cross-program bound


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def narrow(monkeypatch):
    """Narrow resnet20 and lstm in both registries; no fault plan."""
    from mgwfbp_tpu.models.lstm import PTBLSTM as JaxLSTM
    from mgwfbp_tpu.models.resnet_cifar import CifarResNet as JaxResNet
    from mgwfbp_tpu_torch.models.lstm import PTBLSTM
    from mgwfbp_tpu_torch.models.resnet_cifar import CifarResNet

    def j_resnet(nc):
        nc = nc or 10
        return (JaxResNet(depth=8, widths=(4, 8, 16), num_classes=nc),
                JaxMeta("resnet20", "cifar10", nc, (32, 32, 3)))

    def p_resnet(nc):
        nc = nc or 10
        return (CifarResNet(depth=8, widths=(4, 8, 16), num_classes=nc),
                ModelMeta("resnet20", "cifar10", nc, (32, 32, 3)))

    def j_lstm(nc):
        nc = nc or 10000
        return (JaxLSTM(vocab_size=nc, hidden_size=16, num_layers=1,
                        dropout=0.0),
                JaxMeta("lstm", "ptb", nc, (35,), input_dtype=jnp.int32,
                        task="lm", has_carry=True))

    def p_lstm(nc):
        nc = nc or 10000
        return (PTBLSTM(nc, 16, 1, 0.0),
                ModelMeta("lstm", "ptb", nc, (35,), input_dtype=np.int32,
                          task="lm", has_carry=True))

    monkeypatch.setitem(jzoo._REGISTRY, "resnet20", j_resnet)
    monkeypatch.setitem(jzoo._REGISTRY, "lstm", j_lstm)
    monkeypatch.setitem(pzoo._REGISTRY, "resnet20", p_resnet)
    monkeypatch.setitem(pzoo._REGISTRY, "lstm", p_lstm)
    monkeypatch.delenv("MGWFBP_FAULT_PLAN", raising=False)


def _kw(name: str, root) -> dict:
    base = dict(logdir="", checkpoint_dir=str(root), num_batches_per_epoch=4,
                max_epochs=2, seed=3)
    if name == "lstm":
        base.update(batch_size=2, lr=1.0, momentum=0.9)
    else:
        base.update(batch_size=4, lr=0.05)
    return base


def _jax_trainer(name: str, root):
    mesh = make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    return JaxTrainer(jax_make_config(name, **_kw(name, root)), mesh=mesh,
                      profile_backward=False, synthetic_data=True)


def _port_trainer(name: str, root):
    return Trainer(make_config(name, **_kw(name, root)), device="cpu",
                   synthetic_data=True)


def _np(tree) -> dict:
    return flatten_flax(jax.tree_util.tree_map(np.asarray, tree))


def _preempted_at_2(make, name: str, root, monkeypatch, exc):
    """A writer that trains two steps and drains (the fault plan delivers
    SIGTERM after step 2; the drain commits step 2 mid-epoch)."""
    monkeypatch.setenv("MGWFBP_FAULT_PLAN", "preempt@step=2")
    t = make(name, root)
    monkeypatch.delenv("MGWFBP_FAULT_PLAN")
    with pytest.raises(exc):
        t.fit(1)
    t.close()


def _port_state(t: Trainer) -> dict:
    params, bstats = variables_to_flax(t.model)
    return {"params": flatten_flax(params), "batch_stats": flatten_flax(bstats),
            "trace": momentum_to_flax(t.model, t.optimizer)}


def _jax_state(t: JaxTrainer) -> dict:
    opt = t.state.opt_state
    traces = [s.trace for s in jax.tree_util.tree_leaves(
        opt, is_leaf=lambda n: hasattr(n, "trace"))]
    return {"params": _np(t.state.params),
            "batch_stats": _np(t.state.batch_stats),
            "trace": _np(traces[0])}


def _assert_close(got: dict, want: dict, exact: bool = False) -> None:
    """Bitwise, or params and batch statistics within the cross-program
    bound. The momentum trace is a sum of gradients, and the JAX package's
    float32 gradients near the stem are the inexact side on the CPU
    (ROADMAP Queue 3; measured: 1.06e-06 on a 0.25-scale stem trace after
    4 steps), so the trace is held to RTOL of its leaf's largest
    magnitude instead of ATOL."""
    for part in want:
        assert list(got[part]) == list(want[part]), part
        for k in want[part]:
            g, w = got[part][k], want[part][k]
            if exact:
                np.testing.assert_array_equal(g, w)
                continue
            atol = ATOL if part != "trace" else max(
                ATOL, RTOL * float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol,
                                       err_msg=f"{part} {k}")


# -- the optimizer section, both ways -------------------------------------


@pytest.mark.parametrize("name", ["resnet20", "lstm"])
def test_port_commit_restores_in_jax_bitwise(narrow, tmp_path, monkeypatch,
                                             name):
    _preempted_at_2(_port_trainer, name, tmp_path, monkeypatch, Preempted)
    port = _port_trainer(name, tmp_path)  # resumes: the committed state
    want = _port_state(port)
    want_carry = [a.numpy() for layer in (port._resume_carry or ())
                  for a in layer]
    port.close()
    jt = _jax_trainer(name, tmp_path / "unused")
    ck = JaxCheckpointer(port.ckpt_dir)
    snap = ck.restore(jt.state, carry_template=jt._carry_template())
    ck.close()
    assert snap.iteration == 2 and snap.mid_epoch and snap.epoch_step == 2
    assert int(snap.state.step) == 2
    got = {"params": _np(snap.state.params),
           "batch_stats": _np(snap.state.batch_stats)}
    leaves = jax.tree_util.tree_flatten_with_path(snap.state.opt_state)[0]
    counts = [np.asarray(x) for kp, x in leaves
              if jax.tree_util.keystr(kp).endswith(".count")]
    assert [int(c) for c in counts] == [2]
    traces = [s.trace for s in jax.tree_util.tree_leaves(
        snap.state.opt_state, is_leaf=lambda n: hasattr(n, "trace"))]
    got["trace"] = _np(traces[0])
    _assert_close(got, want, exact=True)
    if name == "lstm":
        carry = [np.asarray(x) for x in jax.tree_util.tree_leaves(snap.carry)]
        assert len(carry) == len(want_carry) == 2
        for a, b in zip(carry, want_carry):
            np.testing.assert_array_equal(a, b)
    jt.close()


@pytest.mark.parametrize("name", ["resnet20", "lstm"])
def test_jax_commit_restores_in_port_bitwise(narrow, tmp_path, monkeypatch,
                                             name):
    _preempted_at_2(_jax_trainer, name, tmp_path, monkeypatch, JaxPreempted)
    jt = _jax_trainer(name, tmp_path)  # resumes
    want = _jax_state(jt)
    want_carry = [np.asarray(x)
                  for x in jax.tree_util.tree_leaves(jt._resume_carry)]
    jt.close()
    port = _port_trainer(name, tmp_path)
    assert port.iteration == 2 and port.train_step.step == 2
    assert port._resume_epoch == 0 and port._resume_skip_steps == 2
    _assert_close(_port_state(port), want, exact=True)
    if name == "lstm":
        got = [a.numpy() for layer in port._resume_carry for a in layer]
        for a, b in zip(got, want_carry):
            np.testing.assert_array_equal(a, b)
    else:
        assert port._resume_carry is None
    port.close()


# -- a resume in either package from one committed step -------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name", ["resnet20", "lstm"])
def test_resume_matches_across_packages(narrow, tmp_path, monkeypatch, writer,
                                        name):
    """One committed mid-epoch step (2 of 4), resumed by both packages,
    which finish the epoch: params, batch statistics and momentum agree."""
    src = tmp_path / "src"
    if writer == "jax":
        _preempted_at_2(_jax_trainer, name, src, monkeypatch, JaxPreempted)
    else:
        _preempted_at_2(_port_trainer, name, src, monkeypatch, Preempted)
    for who in ("jax", "port"):
        shutil.copytree(src, tmp_path / who)
    jt = _jax_trainer(name, tmp_path / "jax")
    assert jt.iteration == 2 and jt._resume_skip_steps == 2
    jt.fit(1)
    want = _jax_state(jt)
    jt.close()
    port = _port_trainer(name, tmp_path / "port")
    assert port.iteration == 2 and port._resume_skip_steps == 2
    port.fit(1)
    assert port.iteration == 4
    _assert_close(_port_state(port), want)
    port.close()


# -- the manager's contract ---------------------------------------------


def _payload(step: int, epoch: int, epoch_step: int, w: float = 0.0):
    manifest = {
        "format_version": 1, "step": step, "world": 1, "process_count": 1,
        "mesh_axes": {"data": 1, "seq": 1}, "comm_op": "all_reduce",
        "leaves": [{"path": "['w']", "shape": [4], "dtype": "float32"}],
        "rng": [0, 0],
        "meta": {"epoch": epoch, "iteration": step, "epoch_step": epoch_step,
                 "mid_epoch": epoch_step > 0, "train_step": step},
        "params": {"kind": "replicated"},
        "batch_stats": {"kind": "replicated", "leaves": []},
    }
    return manifest, {"params.l0": np.full(4, w, np.float32)}


def _template() -> TrainState:
    return TrainState(step=0, params={"w": shape_only((4,), np.float32)},
                      batch_stats={})


def test_gc_keeps_epoch_boundaries_despite_step_bursts(tmp_path):
    """Counterpart of test_resilience.py:183: mid-epoch step saves must not
    evict the epoch-boundary history."""
    ck = Checkpointer(str(tmp_path), max_to_keep=2)
    it = 0
    for epoch in range(3):
        for s in range(1, 4):  # 3 mid-epoch saves per epoch
            it += 1
            ck.save_sharded(*_payload(it, epoch, s))
        ck.save_sharded(*_payload(it, epoch, 0))  # the boundary
    assert ck.all_epochs() == [1, 2]
    assert peek_steps(str(tmp_path)) == ck.all_steps()
    mids = [s for s in ck.all_steps() if ck._index[str(s)]["mid_epoch"]]
    assert 1 <= len(mids) <= 2
    assert ck.restore(_template(), epoch=1).iteration == 6
    # the sidecar survives a fresh manager
    assert Checkpointer(str(tmp_path), max_to_keep=2).all_epochs() == [1, 2]


def test_boundary_save_onto_step_checkpoint_promotes_entry(narrow, tmp_path):
    """Counterpart of test_resilience.py:220: --ckpt-every-steps dividing
    the epoch, the boundary save dedups onto the step save; the promoted
    entry resumes as a boundary (next epoch, no skip), and the carry
    model's entry keeps describing its carry."""
    for name in ("resnet20", "lstm"):
        cfg = make_config(name, **{**_kw(name, tmp_path / name),
                                   "ckpt_every_steps": 2})
        t = Trainer(cfg, device="cpu", synthetic_data=True)
        t.fit(1)
        entry = t.checkpointer._index["4"]
        assert entry["mid_epoch"] is False
        assert entry["has_carry"] is (name == "lstm")
        t.close()
        t2 = Trainer(cfg, device="cpu", synthetic_data=True)
        assert t2.start_epoch == 1 and t2._resume_epoch is None
        assert t2.iteration == 4
        t2.close()


def test_lost_sidecar_heals_from_the_manifest(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save_sharded(*_payload(17, 2, 5, w=1.5))
    os.remove(os.path.join(str(tmp_path), "steps_index.json"))
    snap = Checkpointer(str(tmp_path)).restore(_template())
    assert snap.mid_epoch and snap.epoch == 2 and snap.epoch_step == 5
    np.testing.assert_array_equal(snap.state.params["w"], np.full(4, 1.5))


def test_restore_mismatch_names_offending_leaf(narrow, tmp_path):
    """Counterpart of test_resilience.py:596: a step of one structure
    restored into another raises CheckpointRestoreError naming leaves."""
    t = _port_trainer("resnet20", tmp_path)
    t.fit(1)
    run_dir = t.ckpt_dir
    t.close()
    other = _port_trainer("lstm", tmp_path / "other")
    with pytest.raises(CheckpointRestoreError) as exc:
        Checkpointer(run_dir).restore(other._template())
    msg = str(exc.value)
    assert "config drift" in msg and "params" in msg
    assert any("Embed_0" in m or "BasicBlock_0" in m
               for m in exc.value.mismatches)
    other.close()
    # the optimizer section is checked too: a template whose optimizer has
    # another structure (no momentum: a count only) names the trace leaves
    params, bstats, _ = read_step(run_dir, 4)
    tmpl = TrainState(
        step=0,
        params={k: shape_only(v.shape, v.dtype) for k, v in params.items()},
        batch_stats={k: shape_only(v.shape, v.dtype)
                     for k, v in bstats.items()},
        opt_state={"[1].count": shape_only((), np.int32)},
    )
    with pytest.raises(CheckpointRestoreError) as exc:
        Checkpointer(run_dir).restore(tmpl)
    assert any(m.startswith("opt_state[1].trace") for m in
               exc.value.mismatches)


# -- the async writer owns its payload -----------------------------------


def test_async_save_holds_its_own_steps_weights(narrow, tmp_path):
    """Submit a step's save, apply more steps in place before its commit:
    the committed step still holds the weights of the step it names."""
    t = _port_trainer("resnet20", tmp_path)
    t.config.num_batches_per_epoch = 2
    t.train_epoch(0)
    at_2 = _port_state(t)
    assert t.save_step(0, 2, background=True) is None  # in flight
    assert t.checkpointer.pending_async_step() == 2
    x, y = t._to_device(*t.bundle.train.load_batch(0, 2))
    for _ in range(3):  # in-place updates of params, momentum, statistics
        t.step_batch(x[None], y[None])
    assert not np.array_equal(_port_state(t)["params"]["fc.kernel"],
                              at_2["params"]["fc.kernel"])
    t._poll_async_ckpt(block=True)
    assert t.checkpointer.pending_async_step() is None
    params, bstats, meta = read_step(t.ckpt_dir, 2)
    assert meta["train_step"] == 2 and meta["opt_count"] == 2
    _assert_close({"params": params, "batch_stats": bstats},
                  {k: at_2[k] for k in ("params", "batch_stats")}, exact=True)
    t.close()


def test_async_writer_failure_raises_at_the_next_poll(narrow, tmp_path,
                                                     monkeypatch):
    t = _port_trainer("resnet20", tmp_path)
    t.config.num_batches_per_epoch = 1
    t.train_epoch(0)

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "save", broken)
    t.save_step(0, 1, background=True)
    with pytest.raises(RuntimeError, match="disk full"):
        t._poll_async_ckpt(block=True)
    assert t.checkpointer.latest_step() is None
    monkeypatch.undo()
    t.close()


# -- refusals ------------------------------------------------------------


def test_replicated_format_and_orbax_entries_are_refused(narrow, tmp_path):
    cfg = make_config("resnet20", **{**_kw("resnet20", tmp_path),
                                     "ckpt_format": "replicated"})
    with pytest.raises(ValueError, match="orbax.*ROADMAP Queue 1 item 2"):
        Trainer(cfg, device="cpu", synthetic_data=True)
    orbax_step = tmp_path / "orbax_run" / "7"
    orbax_step.mkdir(parents=True)
    ck = Checkpointer(str(tmp_path / "orbax_run"))
    assert ck.latest_step() == 7 and ck.entry_format(7) == "orbax"
    with pytest.raises(CheckpointRestoreError, match="orbax"):
        ck.restore(_template())


def test_sharded_optimizer_section_is_refused(tmp_path):
    """A sharded optimizer section (rs_opt_ag) restores: its rows, written
    by two processes, re-sliced into the replicated trace and the count;
    so does a sharded parameter section (rs_fwd_ag's carry): one process's
    row, re-sliced into the leaf."""
    manifest, files = _payload(3, 0, 3)
    manifest["opt"] = {"kind": "sharded", "slots": 1}
    manifest["layout"] = {"world": 2, "shard_sizes": [2],
                          "group_dtypes": ["float32"],
                          "leaf_slots": [[0, 0]]}
    manifest["processes"] = {"0": {"rows": [0]}}
    manifest["meta"]["opt_count"] = 3
    files["opt.s0.g0"] = np.asarray([[1.0, 2.0]], np.float32)
    ck = Checkpointer(str(tmp_path / "opt"))
    ck.save_sharded(manifest, files)
    # the second process's row, as its own process subtree
    manifest["processes"]["1"] = {"rows": [1]}
    p1 = os.path.join(ck._shard_step_dir(3), "p00001")
    os.makedirs(p1)
    np.save(os.path.join(p1, "opt.s0.g0.npy"),
            np.asarray([[3.0, 4.0]], np.float32))
    import json

    with open(os.path.join(ck._shard_step_dir(3), "manifest.json"), "w") as f:
        json.dump(manifest, f)
    template = _template()
    template.opt_state = {"[0].trace['w']": shape_only((4,), np.float32),
                          "[1].count": shape_only((), np.int32)}
    snap = Checkpointer(str(tmp_path / "opt")).restore(template)
    np.testing.assert_array_equal(snap.state.opt_state["[0].trace['w']"],
                                  [1.0, 2.0, 3.0, 4.0])
    assert int(snap.state.opt_state["[1].count"]) == 3
    manifest, files = _payload(3, 0, 3)
    manifest["params"] = {"kind": "sharded"}
    manifest["layout"] = {"world": 1, "shard_sizes": [4],
                          "group_dtypes": ["float32"],
                          "leaf_slots": [[0, 0]]}
    manifest["processes"] = {"0": {"rows": [0]}}
    files = {"params.g0": np.asarray([[5.0, 6.0, 7.0, 8.0]], np.float32)}
    ck = Checkpointer(str(tmp_path / "params"))
    ck.save_sharded(manifest, files)
    snap = ck.restore(_template())
    np.testing.assert_array_equal(snap.state.params["w"], [5.0, 6.0, 7.0, 8.0])


# -- serving reads the new Checkpointer's steps --------------------------


def test_serving_hot_reload_reads_a_checkpointer_step(narrow, tmp_path):
    from mgwfbp_tpu_torch.serving.model import (
        ServingModel,
        committed_sharded_steps,
    )

    t = _port_trainer("resnet20", tmp_path)
    t.config.ckpt_every_steps = 2
    t.fit(1)
    want = _port_state(t)
    ckpt_dir = t.ckpt_dir
    t.close()
    assert committed_sharded_steps(ckpt_dir) == [2, 4]
    module, meta = pzoo.create_model("resnet20")
    served = ServingModel(module, meta, device="cpu").load_step(ckpt_dir, 4)
    got, bstats = variables_to_flax(served.module)
    _assert_close({"params": flatten_flax(got),
                   "batch_stats": flatten_flax(bstats)},
                  {k: want[k] for k in ("params", "batch_stats")},
                  exact=True)
