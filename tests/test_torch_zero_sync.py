"""The port's zero-sync step loop against the JAX package's: the step
decides its non-finite guard on the device (``jnp.where(ok, new, old)`` over
the whole state and the carry in the JAX step; ``torch.where`` and an
update made an exact no-op in the port), and the trainer reads each step's
flag one step late, ``MGWFBP_GUARD_CHECK_INTERVAL`` steps at a time.

  * at four gloo ranks (tests/torch_zero_sync_worker.py), a full-width
    ResNet-20 step of every lowering (all_reduce, rs_ag, rs_opt_ag,
    rs_fwd_ag, hier over two slices of two), with the health statistics
    off and on: no host synchronisation inside an observed step (SCH005
    and every other schedule rule clean), none inside a step whose batch
    holds a NaN on one rank, which leaves every rank's whole state bitwise
    as it was (parameters or carried shards, momentum or sharded slots
    and their count, batch-norm statistics, the step counter); the next
    finite step advances the counter;
  * one process, the small PTB LSTM with its carry, six steps with a NaN
    batch at step 3 under a warm-up schedule whose rate moves every step:
    the NaN step's whole state, carry included, is bitwise unchanged
    (``torch.equal``), as the JAX step's is, and the six steps track the
    JAX package's six on a one-device mesh within the trajectory bounds of
    the existing parity tests (rtol 2e-5, atol 1e-6): the learning rate's
    index stayed on the skipped step, with nothing read back;
  * a ``Trainer`` epoch reads the device as often with the guard on as
    off, and with telemetry on as off (the JAX trainer's
    ``test_grad_guard_zero_sync`` and ``test_zero_sync_guard``), and at
    most ceil(steps / N) + 1 times under ``MGWFBP_GUARD_CHECK_INTERVAL=N``;
  * ``nan@step=3`` is reported as one ``bad_step`` at step 3 at interval 1
    and at interval 100 (the drain at the epoch's end);
    ``nan@step=2,count=3`` with ``bad_step_limit=2`` and no checkpointer
    keeps skipping: the counter ends at 3 of 6, the parameters finite.
"""

from __future__ import annotations

import math
import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgwfbp_tpu.models import ModelMeta as JaxMeta
from mgwfbp_tpu.models.lstm import PTBLSTM as JaxLSTM
from mgwfbp_tpu.optim import make_optimizer as jax_make_optimizer
from mgwfbp_tpu.parallel.mesh import MeshSpec, make_mesh
from mgwfbp_tpu.telemetry.events import events_of, read_events
from mgwfbp_tpu.train.step import TrainState, make_train_step
from mgwfbp_tpu_torch import models as pzoo
from mgwfbp_tpu_torch.analysis.schedule_check import HostObserver
from mgwfbp_tpu_torch.config import make_config
from mgwfbp_tpu_torch.convert import flatten_flax, state_from_flax
from mgwfbp_tpu_torch.models import ModelMeta
from mgwfbp_tpu_torch.models.lstm import PTBLSTM
from mgwfbp_tpu_torch.optim import make_optimizer
from mgwfbp_tpu_torch.train import Trainer
from mgwfbp_tpu_torch.train.step import TrainStep

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_zero_sync_worker as worker  # noqa: E402

TRAJ_RTOL, TRAJ_ATOL = 2e-5, 1e-6  # tests/test_torch_train_dist.py's
V, H, T, B = 50, 16, 7, 2  # the small LSTM, its window, its batch
STEPS, BAD = 6, 3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# -- four ranks, every lowering ---------------------------------------------


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return worker.run_ranks(4, str(tmp_path_factory.mktemp("zero_sync")))


CASES = [f"{op}/health={h}" for op in worker.OPS for h in (False, True)]


@pytest.mark.parametrize("case", CASES)
def test_no_sync_inside_any_lowerings_step_and_a_bad_step_keeps_it_all(
        four_ranks, case):
    for rank, out in enumerate(four_ranks):
        rec = out[case]
        assert rec["syncs"] == [] and rec["findings"] == [], (rank, rec)
        assert rec["nan_syncs"] == [], (rank, rec)
        assert rec["nonfinite"] > 0 and rec["next_nonfinite"] == 0
        assert rec["unchanged"], (rank, case)
        assert rec["step_before"] == rec["step_after"] == 2
        assert rec["step_next"] == 3
        assert rec["params_finite"]
        assert rec["ratio_nan"] == case.endswith("True")
        # the guard's count rides the metrics' mean: every rank alike
        assert rec["nonfinite"] == four_ranks[0][case]["nonfinite"]


# -- one process: the LSTM and its carry against the JAX step ----------------


def _tokens(seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, V, (1, B, T)).astype(
        np.int32)


OPT = dict(momentum=0.9, weight_decay=1e-4, lr_schedule="auto",
           dataset="ptb", max_epochs=10, warmup_epochs=5,
           num_batches_per_epoch=2)


def _jax_run(jm, params, xs, ys):
    """(state, carry) after each of the JAX step's steps, on one device."""
    tx, _ = jax_make_optimizer(0.5, **OPT)
    mesh = make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    meta = JaxMeta(name="lstm", dataset="ptb", num_classes=V,
                   input_shape=(T,), input_dtype=jnp.int32, task="lm",
                   has_carry=True)
    step = make_train_step(jm, meta, tx, mesh, None, donate=False)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats={}, opt_state=tx.init(params),
                       rng=jax.random.PRNGKey(0))
    carry = jm.initial_carry(B)
    out = []
    for x, y in zip(xs, ys):
        state, metrics, carry = step(state, {"x": x, "y": y}, carry)
        out.append((state, carry, metrics))
    return out


def _flat_state(model, opt, carry, step) -> list[torch.Tensor]:
    return ([p.detach().clone() for p in model.parameters()]
            + [s["momentum_buffer"].clone() for s in opt.state.values()]
            + [t.clone() for layer in carry for t in layer]
            + [step._pos.clone()])


def test_lstm_bad_step_keeps_state_and_carry_and_tracks_jax():
    jm = JaxLSTM(vocab_size=V, hidden_size=H, dropout=0.0)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        partial(jm.init, train=False))(
        jax.random.PRNGKey(5), jnp.zeros((1, T), jnp.int32))["params"])
    xs = [_tokens(10 + k) for k in range(STEPS)]
    ys = [_tokens(20 + k) for k in range(STEPS)]
    xs[BAD - 1] = xs[BAD - 1].copy()
    xs[BAD - 1][0, 1, 2] = V  # outside the vocabulary: a NaN embedding row
    want = _jax_run(jm, params, xs, ys)

    model = PTBLSTM(V, H, 2, 0.0)
    model.load_state_dict(state_from_flax(model, params), strict=True)
    opt, lr_fn, _ = make_optimizer(model.parameters(), 0.5, **OPT)
    # the schedule's index matters on the bad step: every step has its own
    # rate
    assert len({lr_fn(k) for k in range(STEPS)}) == STEPS
    step = TrainStep(model, opt, lr_fn, task="lm")
    carry = model.initial_carry(B)
    for k in range(STEPS):
        before = _flat_state(model, opt, carry, step) if k else None
        with HostObserver() as host:
            metrics, carry = step(torch.from_numpy(xs[k]).long(),
                                  torch.from_numpy(ys[k]).long(), carry)
        assert host.syncs == []
        state, jcarry, jmetrics = want[k]
        bad = k == BAD - 1
        assert (float(metrics["grads_nonfinite"]) > 0) == bad
        assert (float(jmetrics["grads_nonfinite"]) > 0) == bad
        if bad:
            after = _flat_state(model, opt, carry, step)
            assert all(torch.equal(a, b) for a, b in zip(before, after))
            prev = want[k - 1]
            assert all(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                lambda a, b: np.array_equal(np.asarray(a), np.asarray(b)),
                (prev[0], prev[1]), (state, jcarry))))
        assert step.step == int(state.step) == k + 1 - (k >= BAD - 1)
        got = flatten_flax(_port_params(model))
        for key, w in flatten_flax(jax.tree_util.tree_map(
                np.asarray, state.params)).items():
            np.testing.assert_allclose(got[key], w, rtol=TRAJ_RTOL,
                                       atol=TRAJ_ATOL,
                                       err_msg=f"{key} after step {k + 1}")
        for li, (c, h) in enumerate(carry):
            for part, t, w in (("c", c, jcarry[li][0]),
                               ("h", h, jcarry[li][1])):
                np.testing.assert_allclose(
                    t.numpy(), np.asarray(w), rtol=TRAJ_RTOL,
                    atol=TRAJ_ATOL, err_msg=f"carry {li}{part} {k + 1}")


def _port_params(model) -> dict:
    from mgwfbp_tpu_torch.convert import variables_to_flax

    return variables_to_flax(model)[0]


# -- the trainer: late reads ---------------------------------------------------


@pytest.fixture
def narrow(monkeypatch, tmp_path):
    from mgwfbp_tpu_torch.models.resnet_cifar import CifarResNet

    monkeypatch.setitem(pzoo._REGISTRY, "resnet20", lambda nc: (
        CifarResNet(depth=8, widths=(4, 8, 16), num_classes=nc or 10),
        ModelMeta("resnet20", "cifar10", nc or 10, (32, 32, 3))))
    monkeypatch.delenv("MGWFBP_FAULT_PLAN", raising=False)
    monkeypatch.delenv("MGWFBP_GUARD_CHECK_INTERVAL", raising=False)
    monkeypatch.setenv("MGWFBP_LOG_INTERVAL", "1000")  # no mid-loop reads
    monkeypatch.chdir(tmp_path)


def _cfg(tmp_path, **kw):
    base = dict(lr=0.01, max_epochs=1, logdir=str(tmp_path),
                checkpoint_dir=None, seed=11, batch_size=4,
                num_batches_per_epoch=8)
    base.update(kw)
    return make_config("resnet20", **base)


def _epoch_reads(tmp_path, **kw) -> tuple[int, Trainer]:
    """Host reads of one training epoch (every ``.item()``, ``float(t)``,
    ``.tolist()``, ``.numpy()`` and device-to-host copy; and
    ``torch.cuda.synchronize``)."""
    t = Trainer(_cfg(tmp_path, **kw), device="cpu", synthetic_data=True,
                profile_backward=False)
    syncs = []
    real = torch.cuda.synchronize

    def counted(*a, **k):
        syncs.append("torch.cuda.synchronize")
        return real(*a, **k)

    torch.cuda.synchronize = counted
    try:
        with HostObserver() as host:
            t.train_epoch(0)
    finally:
        torch.cuda.synchronize = real
    return len(host.syncs) + len(syncs), t


def test_guard_and_telemetry_add_no_read_to_an_epoch(narrow, tmp_path):
    n = {}
    for name, kw in (("base", {}), ("guard_off", {"grad_guard": False}),
                     ("telemetry", {"telemetry": True}),
                     ("both", {"telemetry": True, "grad_guard": False})):
        n[name], t = _epoch_reads(tmp_path / name, **kw)
        assert len(t.losses) == 8 and np.isfinite(t.losses).all()
        t.close()
    assert n["base"] == n["guard_off"] == n["telemetry"] == n["both"], n
    # interval 1: one read per step after the first, one at the epoch's end
    assert n["base"] <= 8 + 1


@pytest.mark.parametrize("interval", [1, 3, 100])
def test_reads_per_epoch_follow_the_interval(narrow, tmp_path, monkeypatch,
                                             interval):
    monkeypatch.setenv("MGWFBP_GUARD_CHECK_INTERVAL", str(interval))
    reads, t = _epoch_reads(tmp_path, telemetry=True)
    assert t._guard_interval == interval
    assert 1 <= reads <= math.ceil(8 / interval) + 1
    t.close()


def test_interval_is_at_least_one(narrow, tmp_path, monkeypatch):
    monkeypatch.setenv("MGWFBP_GUARD_CHECK_INTERVAL", "0")
    t = Trainer(_cfg(tmp_path), device="cpu", synthetic_data=True,
                profile_backward=False)
    assert t._guard_interval == 1
    t.close()


def _events(tmp_path, cfg, name):
    return events_of(read_events(os.path.join(
        str(tmp_path), cfg.tag(), "telemetry.jsonl")), name)


@pytest.mark.parametrize("interval", [1, 100])
def test_injected_nan_is_reported_at_its_step(narrow, tmp_path, monkeypatch,
                                              interval):
    monkeypatch.setenv("MGWFBP_FAULT_PLAN", "nan@step=3")
    monkeypatch.setenv("MGWFBP_GUARD_CHECK_INTERVAL", str(interval))
    cfg = _cfg(tmp_path, telemetry=True)
    t = Trainer(cfg, device="cpu", synthetic_data=True,
                profile_backward=False)
    out = t.train_epoch(0)
    (bad,) = _events(tmp_path, cfg, "bad_step")
    assert bad["step"] == 3 and bad["epoch"] == 0
    assert t.train_step.step == 7 and t.iteration == 8
    assert np.isnan(t.losses[2]) and np.isfinite(out["loss"])
    assert out["first_loss"] == t.losses[0]
    t.close()


def test_bad_steps_without_checkpointer_keep_skipping(narrow, tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("MGWFBP_FAULT_PLAN", "nan@step=2,count=3")
    cfg = _cfg(tmp_path, telemetry=True, bad_step_limit=2,
               num_batches_per_epoch=6)
    t = Trainer(cfg, device="cpu", synthetic_data=True,
                profile_backward=False)
    m = t.train_epoch(0)
    assert np.isfinite(m["loss"])
    assert t.train_step.step == 3  # 6 steps, 3 dropped: the JAX state.step
    assert all(bool(torch.isfinite(p).all()) for p in t.model.parameters())
    assert [e["step"] for e in _events(tmp_path, cfg, "bad_step")] == [2, 3, 4]
    assert not _events(tmp_path, cfg, "rollback")
    t.close()


def _profile(port: int, query: str = "") -> tuple[int, dict]:
    import json
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/profile{query}", timeout=10) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def test_rollback_in_a_profile_windows_drain_frees_the_window(
        narrow, tmp_path, monkeypatch):
    """A /profile window drains the loop's queued flags before it traces.
    When that drain ends a bad streak in a rollback, the request it took
    fails (it never stays ``running``), and /profile arms and runs again."""
    monkeypatch.setenv("MGWFBP_FAULT_PLAN", "nan@step=5")
    cfg = _cfg(tmp_path, checkpoint_dir=str(tmp_path / "ckpt"),
               ckpt_every_steps=2, bad_step_limit=1, metrics_port=0)
    t = Trainer(cfg, device="cpu", synthetic_data=True,
                profile_backward=False)
    real_poll = t.checkpointer.poll_async
    # every save has committed by the next step's poll: the rollback
    # lands on step 4
    t.checkpointer.poll_async = lambda block=False, durable=False: (
        real_poll(block=True, durable=durable))
    port = t._metrics_server.port
    real_window = t._maybe_profile_window
    armed = []

    def arm_after_the_bad_step(epoch):
        # the bad step is the newest queued one: only the window's drain
        # reads its flag
        if t.iteration == 5 and not armed:
            armed.append(_profile(port, "?steps=2")[0])
        real_window(epoch)

    t._maybe_profile_window = arm_after_the_bad_step
    try:
        t.fit(1)
        (rb,) = _events(tmp_path, cfg, "rollback")
        assert armed == [200] and rb["restored_iteration"] == 4
        assert not _events(tmp_path, cfg, "profile")
        code, doc = _profile(port)
        assert code == 200 and doc["state"] == "failed"
        assert "rolled back" in doc["error"]
        assert t._pending == type(t._pending)()
        # armed again: the next epoch's first boundary runs the window
        assert _profile(port, "?steps=1")[0] == 200
        t.fit(1)
        code, doc = _profile(port)
        assert code == 200 and doc["state"] == "done"
        assert doc["result"]["steps"] == 1
        assert len(_events(tmp_path, cfg, "profile")) == 1
    finally:
        t.close()


def test_rollback_in_a_reraces_drain_keeps_the_rerace_armed(narrow,
                                                           tmp_path):
    """A drift re-race drains the loop's queued flags before it races; a
    rollback raised there leaves the re-race armed for after it."""
    from mgwfbp_tpu_torch.train.trainer import _RollbackRequested

    t = Trainer(_cfg(tmp_path), device="cpu", synthetic_data=True,
                profile_backward=False)

    def drain_rolls_back(**_):
        raise _RollbackRequested(1)

    t.autotune = drain_rolls_back
    # one process has no reducer (nothing to race): stand one in
    reducer, t.reducer = t.reducer, object()
    t._drift_reautotune_pending = True
    try:
        with pytest.raises(_RollbackRequested):
            t._drift_reautotune()
        assert t._drift_reautotune_pending
    finally:
        t.reducer = reducer
        t.close()
