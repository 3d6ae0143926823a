"""The live /profile window of the port's trainer (``Trainer.
_run_profile_window``) and the straggler probe, on the CPU.

  * ``/profile?steps=2`` on a CPU lenet ``Trainer``: the request is taken
    at the next step boundary on the training thread; the status and the
    result carry the JAX plane's keys (``supported``, ``state``,
    ``max_steps``, ``result`` with ``steps``, ``iteration``, ``wall_s``,
    ``attribution``, ``trace_dir``, ``groups``, and the port's
    ``comm_tail_ms``); one worker has no reducer, so ``attribution`` is
    ``"none"`` and the tail None; the window's Chrome trace is on disk
    under ``<logdir>/<tag>/profile/iterNNNNNNNN``; a ``profile`` record
    lands in the stream; the window's steps are genuine optimizer steps
    (the iteration moves on by 2); a bad query answers 400, a second arm
    409, and a request past ``PROFILE_MAX_STEPS`` is clamped, as in JAX;
  * two gloo ranks (``lenet``, a merge schedule over both): rank 0 alone
    is armed, the group agrees on the window through ``gather_values`` at
    the agree interval, and both ranks' results hold
    ``per_process_device_s`` of the lockstep shape (one row per rank, one
    entry per merge group; zeros, since the CPU attributes nothing), and
    each group row the span recorder's ``ready_to_done_ms`` and
    ``after_backward_ms`` beside the result's ``comm_tail_ms``;
  * the same two ranks under a 0.6 s ``stall`` on rank 1 before steps 5-7
    (rank 0's busy time is a millisecond; the alarm needs 0.1 s): both
    streams carry the identical ``straggler`` records naming process 1,
    raised and then cleared, which the JAX reader and schema accept.
"""

import json
import os
import urllib.error
import urllib.request

import pytest
import torch

from mgwfbp_tpu.telemetry import events as jax_events
from mgwfbp_tpu.telemetry.serve import MetricsAggregator as JaxAggregator
from mgwfbp_tpu_torch.config import make_config
from mgwfbp_tpu_torch.telemetry import events
from mgwfbp_tpu_torch.telemetry.serve import PROFILE_MAX_STEPS
from mgwfbp_tpu_torch.train import Trainer

from test_torch_watchdog import _run_children


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _get(port: int, path: str) -> tuple[int, dict]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


RESULT_KEYS = {"steps", "iteration", "wall_s", "attribution", "trace_dir",
               "groups", "comm_tail_ms"}


def test_profile_window_on_a_cpu_trainer(tmp_path):
    cfg = make_config("lenet", batch_size=4, num_batches_per_epoch=5,
                      max_epochs=1, logdir=str(tmp_path), checkpoint_dir=None,
                      seed=5, augment=False, metrics_port=0)
    t = Trainer(cfg, device="cpu", synthetic_data=True,
                profile_backward=False)
    try:
        port = t._metrics_server.port
        code, doc = _get(port, "/profile")
        assert code == 200 and doc == {"supported": True, "state": "idle",
                                       "max_steps": PROFILE_MAX_STEPS}
        assert _get(port, "/profile?steps=abc")[0] == 400
        assert _get(port, "/profile?steps=0")[0] == 400
        code, doc = _get(port, "/profile?steps=2")
        assert code == 200 and doc == {"armed": True, "steps": 2,
                                       "max_steps": PROFILE_MAX_STEPS}
        code, doc = _get(port, "/profile?steps=3")
        assert code == 409 and doc["state"] == "armed"
        t.fit(1)
        code, status = _get(port, "/profile")
    finally:
        t.close()
    # the JAX plane's document for the same state machine
    jagg = JaxAggregator()
    jagg.enable_profile()
    jagg.arm_profile(2)
    jagg.take_profile_request()
    jagg.set_profile_result(status["result"])
    assert status == jagg.profile_status()
    result = status["result"]
    assert set(result) == RESULT_KEYS
    assert result["attribution"] == "none" and result["groups"] == []
    assert result["comm_tail_ms"] is None  # no merge group to mark
    assert result["steps"] == 2 and result["iteration"] == 3
    assert result["trace_dir"].endswith(os.path.join("profile",
                                                     "iter00000001"))
    with open(os.path.join(result["trace_dir"], "trace.json")) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    rows = events.read_event_set(t.telemetry.path)
    prof = events.events_of(rows, "profile")
    assert [(r["step"], r["steps"], r["attribution"], r["device_s"])
            for r in prof] == [(3, 2, "none", [])]
    # 5 loop steps + 2 window steps
    assert [r["step"] for r in events.events_of(rows, "step")] == [
        1, 4, 5, 6, 7]
    assert jax_events.read_event_set(t.telemetry.path) == rows
    # past the ceiling: clamped
    agg = t._metrics_agg
    assert agg.arm_profile(10 * PROFILE_MAX_STEPS)[1]["steps"] == (
        PROFILE_MAX_STEPS)


_RANK = r"""
import json, os, sys, datetime
import torch, torch.distributed as dist
torch.set_num_threads(1)
from mgwfbp_tpu_torch.config import make_config
from mgwfbp_tpu_torch.train import Trainer
rank, rdv, logdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{rdv}", world_size=2,
                        rank=rank, timeout=datetime.timedelta(seconds=60))
cfg = make_config("lenet", batch_size=4, num_batches_per_epoch=8,
                  max_epochs=1, logdir=logdir, checkpoint_dir=None, seed=5,
                  augment=False, metrics_port=0, policy="threshold",
                  threshold=20000)
t = Trainer(cfg, device="cpu", synthetic_data=True, profile_backward=False)
if rank == 0:
    t._metrics_agg.arm_profile(2)  # rank 1 is not armed: the group agrees
t.fit(1)
doc = {"profile": t._metrics_agg.profile_status(),
       "groups": t.reducer.num_groups, "stream": t.telemetry.path}
t.close()
dist.destroy_process_group()
print(json.dumps(doc))
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("two_ranks")
    plan = ";".join(f"stall@secs=0.6,step={s},proc=1" for s in (5, 6, 7))
    return _run_children(
        [[str(r), str(d / "rdv"), str(d / "logs")] for r in range(2)],
        timeout_s=240, script=_RANK, extra_env={
            "MGWFBP_AGREE_INTERVAL": "1", "MGWFBP_FAULT_PLAN": plan,
            "MGWFBP_DRIFT_HYSTERESIS": "1",
            "MGWFBP_STRAGGLER_MIN_EXCESS_S": "0.1",
        })


def test_two_rank_window_has_the_lockstep_shape(two_ranks):
    g = two_ranks[0]["groups"]
    assert g >= 1 and two_ranks[1]["groups"] == g
    results = [d["profile"]["result"] for d in two_ranks]
    for res in results:
        assert set(res) == RESULT_KEYS | {"per_process_device_s"}
        assert res["attribution"] == "none"
        assert res["per_process_device_s"] == {"0": [0.0] * g,
                                               "1": [0.0] * g}
        assert [r["group"] for r in res["groups"]] == list(range(g))
        assert all(r["nbytes"] > 0 and r["predicted_s"] > 0
                   for r in res["groups"])
        # the span recorder's marks of the window's steps: on gloo done(g)
        # is the host's wait returning, after the group's launch and after
        # the backward's end
        assert all(r["ready_to_done_ms"] >= 0 and r["after_backward_ms"] >= 0
                   for r in res["groups"])
        assert res["comm_tail_ms"] >= 0
    # both ranks ran the same window at the same step, each wrote its trace
    assert results[0]["iteration"] == results[1]["iteration"]
    assert results[0]["steps"] == results[1]["steps"] == 2
    assert results[0]["trace_dir"] == results[1]["trace_dir"]
    assert sorted(os.listdir(results[0]["trace_dir"])) == [
        "trace.p0.json", "trace.p1.json"]


def test_two_rank_straggler_alarm_names_the_slow_rank(two_ranks):
    streams = [events.read_event_set(d["stream"]) for d in two_ranks]
    assert [os.path.basename(d["stream"]) for d in two_ranks] == [
        "telemetry.p0.jsonl", "telemetry.p1.jsonl"]
    recs = [[{k: v for k, v in r.items() if k != "wall"}
             for r in events.events_of(s, "straggler")] for s in streams]
    assert recs[0] == recs[1]  # agreed: identical on every process
    assert [r["active"] for r in recs[0]] == [True, False]
    assert recs[0][0]["slow_process"] == 1
    assert recs[0][0]["excess_s"] >= 0.1 and recs[0][0]["step"] == 5
    assert recs[0][1]["step"] == 8
    for d, rows in zip(two_ranks, streams):
        assert jax_events.read_event_set(d["stream"]) == rows
        for r in rows:
            assert all(k in r for k in jax_events.EVENT_TYPES[r["event"]])
