"""The port's resilience layer on the CPU: the fault plan, the guard and
rollback, the preemption drain and resume, the CLI's rc 75, two ranks over
gloo, and the profiling functions' device default.

  * ``utils.faults.parse_plan`` accepts and refuses what the JAX parser
    accepts and refuses, with the same messages, and answers the same
    queries; the trainer consumes every kind, keeping the hard kinds of its
    own supervisor incarnation only;
  * counterparts of ``tests/test_resilience.py``: a NaN step is skipped
    (:104), K consecutive bad steps roll back (:130), persistent NaNs
    abort (:163), without a checkpointer training keeps skipping (:323),
    preempt and resume equal an uninterrupted run bit for bit (:401), the
    carry model resumes mid-epoch bit for bit (:453), a preemption without
    a checkpoint directory still drains (:499);
  * ``train_cli`` in a subprocess: a real SIGTERM gives rc 75, the
    ``preempted`` line and the ``preempt`` event; the same command again
    resumes mid-epoch and finishes;
  * two ranks over gloo (tests/torch_dist_worker.py ``drain``): only rank
    0 gets the signal, both drain at the same step with rc 75, and the
    resumed 2-rank run equals the uninterrupted one bit for bit;
  * without a card, ``profiling``'s public functions raise when no device
    is given.

Narrow models (ResNet-20's name at depth 8, widths (4, 8, 16); the LSTM at
hidden 16, one layer, no dropout) come from patching the port's registry.
"""

import json
import multiprocessing as mp
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mgwfbp_tpu.utils import faults as jax_faults
from mgwfbp_tpu_torch import models as pzoo
from mgwfbp_tpu_torch.config import make_config
from mgwfbp_tpu_torch.convert import flatten_flax, momentum_to_flax, variables_to_flax
from mgwfbp_tpu_torch.models import ModelMeta
from mgwfbp_tpu_torch.telemetry import events_of, read_events
from mgwfbp_tpu_torch.train import Trainer
from mgwfbp_tpu_torch.utils import faults
from mgwfbp_tpu_torch.utils.faults import Preempted

import torch_dist_worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def narrow(monkeypatch):
    from mgwfbp_tpu_torch.models.lstm import PTBLSTM
    from mgwfbp_tpu_torch.models.resnet_cifar import CifarResNet

    def p_resnet(nc):
        nc = nc or 10
        return (CifarResNet(depth=8, widths=(4, 8, 16), num_classes=nc),
                ModelMeta("resnet20", "cifar10", nc, (32, 32, 3)))

    def p_lstm(nc):
        nc = nc or 10000
        return (PTBLSTM(nc, 16, 1, 0.0),
                ModelMeta("lstm", "ptb", nc, (35,), input_dtype=np.int32,
                          task="lm", has_carry=True))

    monkeypatch.setitem(pzoo._REGISTRY, "resnet20", p_resnet)
    monkeypatch.setitem(pzoo._REGISTRY, "lstm", p_lstm)
    monkeypatch.delenv("MGWFBP_FAULT_PLAN", raising=False)


def _cfg(dnn="resnet20", **kw):
    base = dict(lr=0.01, max_epochs=2, logdir="", checkpoint_dir=None,
                seed=11, batch_size=4, num_batches_per_epoch=6)
    if dnn == "lstm":
        base.update(batch_size=1, lr=1.0)
    base.update(kw)
    return make_config(dnn, **base)


def _trainer(cfg) -> Trainer:
    return Trainer(cfg, device="cpu", synthetic_data=True)


def _events(tmp_path, cfg, *names) -> list[dict]:
    return events_of(read_events(os.path.join(
        str(tmp_path), cfg.tag(), "telemetry.jsonl")), *names)


def _state(t: Trainer) -> dict:
    params, bstats = variables_to_flax(t.model)
    return {**{f"p/{k}": v for k, v in flatten_flax(params).items()},
            **{f"b/{k}": v for k, v in flatten_flax(bstats).items()},
            **{f"m/{k}": v for k, v in
               momentum_to_flax(t.model, t.optimizer).items()}}


def _assert_bitwise(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- the fault plan ------------------------------------------------------

PLANS = [
    "nan@step=3,count=2; stall@secs=0.5,phase=eval ;"
    "preempt@step=6,signal=SIGINT;chip_unavailable",
    "preempt@step=4,proc=1",
    "kill@step=4,proc=1,inc=2;wedge@step=3,secs=300",
    "stall@secs=1.0,phase=eval,step=500",
    "",
    " ; ",
]
MALFORMED = [
    "explode@step=1", "nan@when=3", "nan", "stall@phase=train",
    "nan@step=three", "preempt@step=1,signal=SIGKILL", "nan@step=1,count=0",
    "stall@secs=1,phase=evaluation", "nan@step=1,proc=-1", "kill@step",
    "wedge@step=3", "nan@step=1,", "kill@step=1,inc=-1", "stall@secs=-1",
]


def _queries(mod, text: str) -> list:
    plan = mod.parse_plan(text)
    out = [plan.describe(), bool(plan), plan.chip_unavailable(),
           plan.for_process(1).describe(), plan.for_incarnation(2).describe()]
    out += [plan.nan_at(s) for s in (2, 3, 3, 4, 5)]
    out += [plan.stall_secs("eval", 500), plan.stall_secs("train")]
    out += [plan.preempt_signal_after(s) for s in (3, 4, 7, 8)]
    out += [plan.kill_after(s) for s in (3, 4)]
    out += [plan.wedge_secs(3)]
    return out


@pytest.mark.parametrize("text", PLANS)
def test_fault_plan_parses_and_answers_like_jax(text):
    assert _queries(faults, text) == _queries(jax_faults, text)


@pytest.mark.parametrize("text", MALFORMED)
def test_fault_plan_refuses_what_jax_refuses(text):
    with pytest.raises(ValueError) as want:
        jax_faults.parse_plan(text)
    with pytest.raises(ValueError) as got:
        faults.parse_plan(text)
    assert str(got.value) == str(want.value)


def test_unported_fault_kinds_are_refused_by_name(narrow, monkeypatch):
    """The refusal this test held is gone: ``stall``, ``kill`` and
    ``wedge`` have consumers now (the trainer, the watchdog and the
    supervisor). The trainer builds with each plan, keeps the specs of its
    process, and drops the hard kinds of other supervisor incarnations, as
    the JAX trainer does."""
    assert not hasattr(faults.FaultPlan, "check_ported")
    plans = [  # (plan, MGWFBP_INCARNATION, the specs the trainer keeps)
        ("stall@secs=4,step=3", "0", ["stall@step=3,secs=4,phase=train"]),
        ("kill@step=2", "0", ["kill@step=2"]),
        ("wedge@step=2,secs=1", "0", ["wedge@step=2,secs=1"]),
        ("kill@step=2,inc=1;wedge@step=3,secs=5,inc=2;nan@step=1", "2",
         ["wedge@step=3,secs=5,inc=2", "nan@step=1"]),
        ("kill@step=2;stall@secs=1,phase=eval", "1",
         ["stall@secs=1,phase=eval"]),
        ("kill@step=2,proc=1;wedge@step=4,secs=2,proc=0", "0",
         ["wedge@step=4,secs=2,proc=0"]),
    ]
    for text, inc, kept in plans:
        monkeypatch.setenv("MGWFBP_FAULT_PLAN", text)
        monkeypatch.setenv("MGWFBP_INCARNATION", inc)
        t = _trainer(_cfg())
        try:
            assert [sp.describe() for sp in t._faults.specs] == kept, text
            want = (jax_faults.parse_plan(text).for_process(0)
                    .for_incarnation(int(inc)).describe())
            assert t._faults.describe() == want
        finally:
            t.close()
    assert faults.PREEMPT_RC == jax_faults.PREEMPT_RC == 75


# -- the guard and rollback ------------------------------------------------


def test_nan_step_is_skipped_and_training_recovers(narrow, tmp_path,
                                                   monkeypatch):
    monkeypatch.setenv("MGWFBP_FAULT_PLAN", "nan@step=3")
    cfg = _cfg(logdir=str(tmp_path), telemetry=True)
    t = _trainer(cfg)
    m = t.train_epoch(0)
    assert np.isfinite(m["loss"]) and "grads_nonfinite" not in m
    assert t.train_step.step == 5  # 6 loader steps, one dropped
    assert t.iteration == 6
    assert all(np.isfinite(p.detach().numpy()).all()
               for p in t.model.parameters())
    (bad,) = _events(tmp_path, cfg, "bad_step")
    assert bad["step"] == 3 and bad["nonfinite"] > 0
    t.close()


def test_consecutive_bad_steps_roll_back_to_checkpoint(narrow, tmp_path,
                                                       monkeypatch):
    """The port reads the guard's count at the step that made it (the JAX
    trainer one step late), so step 4's save must be committed by step 5:
    synchronous saves here, the async case below."""
    monkeypatch.setenv("MGWFBP_FAULT_PLAN", "nan@step=4,count=2")
    cfg = _cfg(logdir=str(tmp_path), telemetry=True,
               checkpoint_dir=str(tmp_path / "ckpt"), ckpt_every_steps=2,
               bad_step_limit=2, ckpt_async=False)
    t = _trainer(cfg)
    m = t.fit(1)
    assert np.isfinite(m["train"]["loss"])
    assert len(_events(tmp_path, cfg, "bad_step")) == 2
    (rb,) = _events(tmp_path, cfg, "rollback")
    assert rb["bad_steps"] == 2 and rb["restored_iteration"] == 4
    assert not _events(tmp_path, cfg, "resume")
    assert max(s["step"] for s in _events(tmp_path, cfg, "step")) == 6
    assert t.iteration == 6 and t.train_step.step == 5
    t.close()


def test_rollback_abandons_an_in_flight_async_save(narrow, tmp_path,
                                                   monkeypatch):
    """A save submitted during the bad streak is dropped uncommitted, and
    the rollback lands on the newest committed step."""
    monkeypatch.setenv("MGWFBP_FAULT_PLAN", "nan@step=5,count=2")
    cfg = _cfg(logdir=str(tmp_path), telemetry=True,
               checkpoint_dir=str(tmp_path / "ckpt"), ckpt_every_steps=2,
               bad_step_limit=2)
    t = _trainer(cfg)
    real_poll = t.checkpointer.poll_async

    def slow_poll(block=False, durable=False):
        # the writer has not finished by the next step's poll
        return real_poll(block=block, durable=durable) if block else None

    t.checkpointer.poll_async = slow_poll
    t.fit(1)
    (rb,) = _events(tmp_path, cfg, "rollback")
    # the guard reads step 6's flag one step late, after step 7: step 4's
    # save committed when step 6's began; step 6's, submitted during the
    # bad streak, was in flight at the rollback and was abandoned
    assert rb["restored_iteration"] == 4
    # the replay re-saved step 6 over the abandoned payload
    assert t.checkpointer.all_steps() == [2, 4, 6]
    t.close()


def test_persistent_nans_abort_instead_of_rollback_livelock(narrow, tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv("MGWFBP_FAULT_PLAN", "nan@step=5;nan@step=5")
    cfg = _cfg(logdir=str(tmp_path), checkpoint_dir=str(tmp_path / "ckpt"),
               ckpt_every_steps=2, bad_step_limit=1)
    t = _trainer(cfg)
    real_poll = t.checkpointer.poll_async

    def committing_poll(block=False, durable=False):
        # every save has committed by the next step's poll, so both
        # rollbacks land on step 4 whatever the host's load (an in-flight
        # save abandoned at a rollback is
        # test_rollback_abandons_an_in_flight_async_save's case)
        return real_poll(block=True, durable=durable)

    t.checkpointer.poll_async = committing_poll
    with pytest.raises(RuntimeError, match="persistent non-finite"):
        t.fit(1)
    t.close()


def test_bad_steps_without_checkpointer_keep_skipping(narrow, tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("MGWFBP_FAULT_PLAN", "nan@step=2,count=3")
    cfg = _cfg(logdir=str(tmp_path), telemetry=True, bad_step_limit=2)
    t = _trainer(cfg)
    m = t.train_epoch(0)
    assert np.isfinite(m["loss"])
    assert t.train_step.step == 3  # 6 steps, 3 dropped
    assert len(_events(tmp_path, cfg, "bad_step")) == 3
    assert not _events(tmp_path, cfg, "rollback")
    t.close()


# -- the drain and resume ------------------------------------------------


def test_preempt_resume_bitwise_equals_uninterrupted(narrow, tmp_path,
                                                     monkeypatch):
    t_a = _trainer(_cfg(logdir=str(tmp_path / "a")))
    t_a.fit(1)
    want = _state(t_a)
    t_a.close()

    cfg_b = _cfg(logdir=str(tmp_path / "b"),
                 checkpoint_dir=str(tmp_path / "b_ckpt"), ckpt_every_steps=2,
                 telemetry=True)
    monkeypatch.setenv("MGWFBP_FAULT_PLAN", "preempt@step=3")
    t_b = _trainer(cfg_b)
    with pytest.raises(Preempted) as exc:
        t_b.fit(1)
    assert exc.value.iteration == 3
    t_b.close()
    (pre,) = _events(tmp_path / "b", cfg_b, "preempt")
    assert pre["signal"] == "SIGTERM" and pre["iteration"] == 3

    monkeypatch.delenv("MGWFBP_FAULT_PLAN")
    t_b2 = _trainer(cfg_b)
    assert t_b2.iteration == 3 and t_b2.start_epoch == 0
    t_b2.fit(1)
    assert t_b2.iteration == 6 and t_b2.train_step.step == 6
    _assert_bitwise(_state(t_b2), want)
    (res,) = _events(tmp_path / "b", cfg_b, "resume")
    assert res["mid_epoch"] is True and res["iteration"] == 3
    t_b2.close()


def test_carry_model_mid_epoch_resume_bitwise(narrow, tmp_path, monkeypatch):
    base = dict(max_epochs=1, num_batches_per_epoch=4, seed=2)
    t_a = _trainer(_cfg("lstm", logdir=str(tmp_path / "a"), **base))
    t_a.fit(1)
    want, want_carry = _state(t_a), [c.numpy() for l in t_a.carry for c in l]
    t_a.close()

    cfg_b = _cfg("lstm", logdir=str(tmp_path / "b"),
                 checkpoint_dir=str(tmp_path / "b_ckpt"), **base)
    monkeypatch.setenv("MGWFBP_FAULT_PLAN", "preempt@step=2")
    t_b = _trainer(cfg_b)
    with pytest.raises(Preempted):
        t_b.fit(1)
    t_b.close()
    monkeypatch.delenv("MGWFBP_FAULT_PLAN")
    t_b2 = _trainer(cfg_b)
    assert t_b2.iteration == 2 and t_b2._resume_carry is not None
    t_b2.fit(1)
    _assert_bitwise(_state(t_b2), want)
    for a, b in zip([c.numpy() for l in t_b2.carry for c in l], want_carry):
        np.testing.assert_array_equal(a, b)
    t_b2.close()


def test_preempt_without_checkpoint_dir_still_drains(narrow, tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv("MGWFBP_FAULT_PLAN", "preempt@step=2")
    cfg = _cfg(logdir=str(tmp_path), telemetry=True)
    t = _trainer(cfg)
    with pytest.raises(Preempted):
        t.fit(1)
    assert _events(tmp_path, cfg, "preempt")
    assert not _events(tmp_path, cfg, "checkpoint")
    t.close()


def test_zero_momentum_of_a_lazy_buffer_resumes_like_a_fresh_one(
        narrow, tmp_path, monkeypatch):
    """Step 1 is skipped (NaN), so torch has made no momentum buffer yet: the
    drain after it writes zeros (optax's initial trace), and the resumed
    step 2 equals step 2 of the uninterrupted run, whose buffers torch
    makes from the gradient."""
    monkeypatch.setenv("MGWFBP_FAULT_PLAN", "nan@step=1")
    t_a = _trainer(_cfg(num_batches_per_epoch=2))
    t_a.fit(1)
    assert t_a.train_step.step == 1
    want = _state(t_a)
    t_a.close()
    cfg = _cfg(num_batches_per_epoch=2, checkpoint_dir=str(tmp_path))
    monkeypatch.setenv("MGWFBP_FAULT_PLAN", "nan@step=1;preempt@step=1")
    t_b = _trainer(cfg)
    assert not t_b.optimizer.state
    with pytest.raises(Preempted):
        t_b.fit(1)
    t_b.close()
    monkeypatch.delenv("MGWFBP_FAULT_PLAN")
    t_b2 = _trainer(cfg)
    assert t_b2.train_step.step == 0 and t_b2.iteration == 1
    assert all(not s["momentum_buffer"].any()
               for s in t_b2.optimizer.state.values())
    t_b2.fit(1)
    _assert_bitwise(_state(t_b2), want)
    t_b2.close()


def test_pretrain_loads_weights_and_counters_not_the_optimizer(narrow,
                                                               tmp_path):
    src = _trainer(_cfg(checkpoint_dir=str(tmp_path / "src"),
                        num_batches_per_epoch=3))
    src.fit(1)
    want = _state(src)
    src_dir = src.ckpt_dir
    src.close()
    t = _trainer(_cfg(seed=5, pretrain=src_dir))
    assert t.start_epoch == 1 and t.iteration == 3 and t.train_step.step == 3
    got = _state(t)
    _assert_bitwise({k: v for k, v in got.items() if not k.startswith("m/")},
                    {k: v for k, v in want.items() if not k.startswith("m/")})
    assert not t.optimizer.state  # a fresh optimizer
    t.close()


# -- the CLI: a real SIGTERM, rc 75, the same command resumes -------------


def test_cli_sigterm_exits_75_and_the_rerun_resumes(tmp_path):
    logdir, ckpt = tmp_path / "logs", tmp_path / "ckpt"
    cmd = [sys.executable, "-m", "mgwfbp_tpu_torch.train_cli", "--dnn",
           "resnet20", "--synthetic", "--device", "cpu", "--epochs", "1",
           "--num-batches-per-epoch", "40", "--batch-size", "2",
           "--ckpt-every-steps", "5", "--telemetry", "--logdir", str(logdir),
           "--checkpoint-dir", str(ckpt)]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    env.pop("MGWFBP_FAULT_PLAN", None)
    tag = "resnet20-cifar10-n1-bs2-lr0.1-auto-th0-s0"
    stream = logdir / tag / "telemetry.jsonl"
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, cwd=str(tmp_path), env=env)
    try:
        deadline = time.time() + 240
        while time.time() < deadline and p.poll() is None:
            if stream.exists() and '"event": "step"' in stream.read_text():
                break
            time.sleep(0.02)
        p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=240)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode == 75, err[-3000:]
    doc = json.loads(out.strip().splitlines()[-1])
    assert doc["preempted"] is True and doc["signal"] == "SIGTERM"
    k = doc["iteration"]
    assert 1 <= k < 40
    (pre,) = events_of(read_events(str(stream)), "preempt")
    assert pre["iteration"] == k
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path), env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "eval" in json.loads(res.stdout.strip().splitlines()[-1])
    recs = read_events(str(stream))
    (resume,) = events_of(recs, "resume")
    assert resume["iteration"] == k and resume["mid_epoch"] is True
    steps = [r["step"] for r in events_of(recs, "step")]
    assert steps == list(range(1, 41))


# -- two ranks over gloo ---------------------------------------------------


def test_two_ranks_drain_together_and_resume_bitwise(tmp_path):
    out_dir = str(tmp_path)
    spec = dict(depth=8, widths=[4, 8, 16], batch=4, tasks=["drain"],
                drain=dict(steps=6))
    with open(os.path.join(out_dir, "spec.json"), "w") as f:
        json.dump(spec, f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=torch_dist_worker.run,
                         args=(r, 2, os.path.join(out_dir, "unused"), out_dir))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
            assert not p.is_alive(), f"rank {procs.index(p)} hung"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert [p.exitcode for p in procs] == [0, 0]
    ranks = []
    for r in range(2):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            ranks.append({k: z[k] for k in z.files})
    for r, got in enumerate(ranks):
        assert got["drain/rcs"].tolist() == [0, 75, 0]
        line = json.loads(str(got["drain/preempted"]))
        assert line["preempted"] is True and line["iteration"] == 3
        assert line["signal"] == ("SIGTERM" if r == 0 else "PEER")
        (pre,) = json.loads(str(got["drain/preempt_events"]))
        assert pre["iteration"] == 3
        (res,) = json.loads(str(got["drain/resume_events"]))
        assert res["iteration"] == 3 and res["mid_epoch"] is True
        assert int(got["drain/a/step"]) == int(got["drain/b/step"]) == 6
        a = {k[len("drain/a/"):]: v for k, v in got.items()
             if k.startswith("drain/a/") and k != "drain/a/step"}
        b = {k[len("drain/b/"):]: v for k, v in got.items()
             if k.startswith("drain/b/") and k != "drain/b/step"}
        assert len(a) > 30
        _assert_bitwise(a, b)


# -- the profiling functions' device default ------------------------------


def test_profiling_functions_refuse_the_cpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    from mgwfbp_tpu_torch import profiling as prof

    for fn in (prof.profile_allreduce, prof.profile_allgather,
               prof.profile_group_overhead, prof.profile_pack_overhead,
               prof.profile_overlap_capability):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prof.measure_step_time(lambda: None)
