"""The port's supervisor on the CPU (``mgwfbp_tpu_torch/runtime/``), held
against the JAX package's where the two can run side by side.

  * ``classify_rc``'s decision table and ``_LivenessTracker`` on the same
    observation sequences give the JAX package's answers (the cases of
    ``tests/test_selfheal.py:35-100``);
  * the policies with tiny fake children (``python -c`` scripts, as
    ``tests/test_selfheal.py`` and ``tests/test_multihost.py`` drive the
    JAX supervisor): resubmit after rc 75 with a bounded backoff, the
    budget spent gives 75, rc 86 stops, a crash heals at the same world, a
    SIGKILL shrinks 2 -> 1, a crash loop at one step stops, ``--no-heal``
    propagates, a wedge verdict SIGTERMs the group, ``--resize-to``, a
    serving replica respawns, ``MGWFBP_INCARNATION`` reaches the children;
  * a child that cannot get its card fails as a classified crash the
    healer stops on (never a relaunch loop, never a quiet CPU run);
  * one supervised 2-process gloo run of ``mgwfbp_tpu_torch.train_cli``
    (lenet) under ``preempt@step=4,proc=1`` resubmits and ends bit-identical
    to an uninterrupted run (``tests/test_multihost.py:599-650``'s scenario).

Each test that starts processes bounds its own time.
"""

import glob
import json
import os
import signal
import sys
import time

import numpy as np
import pytest

from mgwfbp_tpu.runtime import supervisor as jax_sup
from mgwfbp_tpu_torch.runtime import supervisor as sup_mod
from mgwfbp_tpu_torch.runtime.supervise import build_parser
from mgwfbp_tpu_torch.runtime.supervisor import (
    Supervisor,
    _LivenessTracker,
    classify_rc,
    default_train_cmd,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stub(script, n=2, **kw):
    return Supervisor([sys.executable, "-c", script], n, **kw)


def _read_events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# -- the decision table and the liveness tracker, against the JAX package --

RC_CASES = [0, 75, 86, -9, 137, -15, 143, -2, -11, 139, 1, 3, 130, 255]


@pytest.mark.parametrize("rc", RC_CASES)
def test_classify_rc_decision_table_matches_jax(rc):
    assert classify_rc(rc) == jax_sup.classify_rc(rc)


# each case: observations (idx, status or None, now), then classify queries
# (idx, now, grace) -> compared verdict by verdict, and max_step
LIVENESS_CASES = {
    "never_seen_is_unknown": (
        [(0, None, 0.0)], [(0, 1000.0, 5.0)]),
    "frozen_step_past_grace_is_wedged": (
        [(0, {"step": 3, "healthy": True}, 0.0)],
        [(0, 4.0, 5.0), (0, 6.0, 5.0)]),
    "progress_resets_the_clock": (
        [(0, {"step": 3, "healthy": True}, 0.0),
         (0, {"step": 4, "healthy": True}, 6.0)], [(0, 10.0, 5.0)]),
    "step_zero_never_wedges": (
        [(0, {"step": 0, "healthy": True}, 0.0)], [(0, 1e6, 5.0)]),
    "sticky_unhealthy_is_wedged": (
        [(0, {"step": 0, "healthy": False}, 0.0),
         (0, {"step": 0, "healthy": False}, 6.0)],
        [(0, 3.0, 5.0), (0, 6.0, 5.0)]),
    "recovery_clears_unhealthy": (
        [(0, {"step": 0, "healthy": False}, 0.0),
         (0, {"step": 1, "healthy": True}, 2.0)], [(0, 6.0, 5.0)]),
    "seen_then_silent_is_unreachable": (
        [(0, {"step": 2, "healthy": True}, 0.0), (0, None, 1.0)],
        [(0, 3.0, 5.0), (0, 7.0, 5.0)]),
    "answering_again_clears_unreachable": (
        [(0, {"step": 2, "healthy": True}, 0.0), (0, None, 1.0),
         (0, {"step": 3, "healthy": True}, 7.5)], [(0, 8.0, 5.0)]),
    "max_step_tracks_the_group": (
        [(0, {"step": 4}, 0.0), (1, {"step": 7}, 0.0)],
        [(0, 1.0, 5.0), (1, 1.0, 5.0), (2, 1.0, 5.0)]),
}


@pytest.mark.parametrize("case", sorted(LIVENESS_CASES))
def test_liveness_tracker_matches_jax(case):
    observations, queries = LIVENESS_CASES[case]
    answers = []
    for mod_tracker in (_LivenessTracker, jax_sup._LivenessTracker):
        t = mod_tracker()
        out = [t.max_step()]
        for idx, status, now in observations:
            t.observe(idx, None if status is None else dict(status), now)
        out += [t.classify(i, now=n, grace_s=g) for i, n, g in queries]
        out.append(t.max_step())
        answers.append(out)
    assert answers[0] == answers[1]


def test_backoff_and_env_garbage_fail_fast():
    s = _stub("raise SystemExit(0)", backoff_base_s=1.0, backoff_max_s=5.0)
    assert [s.backoff_s(r) for r in (1, 2, 3, 4, 5)] == [1.0, 2.0, 4.0,
                                                          5.0, 5.0]
    with pytest.raises(ValueError, match="MGWFBP_LIVENESS_GRACE_S"):
        _stub("raise SystemExit(0)", env={"MGWFBP_LIVENESS_GRACE_S": "soon"})
    with pytest.raises(ValueError, match="resize_to"):
        _stub("raise SystemExit(0)", resize_to=0)


def test_cli_defaults_match_jax_and_fleet_server_is_refused(capsys):
    from mgwfbp_tpu.runtime.supervise import build_parser as jax_parser

    ours = vars(build_parser().parse_args(["--processes", "2"]))
    theirs = vars(jax_parser().parse_args(["--processes", "2"]))
    assert ours == theirs
    # the fan-in is served now (tests/test_torch_fleet.py drives it): the
    # flag parses as in JAX and a supervisor takes it
    argv = ["--processes", "1", "--fleet-port", "0", "--fleet-file", "f.json"]
    assert vars(build_parser().parse_args(argv)) == vars(
        jax_parser().parse_args(argv))
    sup = _stub("raise SystemExit(0)", fleet_port=0)
    assert sup.fleet_port == 0 and sup.fleet_server is None
    assert "item 5" not in capsys.readouterr().err
    assert default_train_cmd(["--dnn", "x"])[1:] == [
        "-m", "mgwfbp_tpu_torch.train_cli", "--dnn", "x"]


# -- the rc policy with fake children --------------------------------------

def test_resubmits_preempted_group_with_bounded_backoff(tmp_path):
    script = (
        "import os, sys\n"
        f"flag = os.path.join({str(tmp_path)!r}, "
        "'done_' + os.environ['MGWFBP_PROCESS_ID'])\n"
        "if not os.path.exists(flag):\n"
        "    open(flag, 'w').close()\n"
        "    sys.exit(75)\n"
        "sys.exit(0)\n"
    )
    delays = []
    s = _stub(script, backoff_base_s=0.5, sleep=delays.append,
              log_dir=str(tmp_path / "logs"))
    assert s.run() == 0
    assert delays == [0.5]
    assert [r.returncodes for r in s.results] == [[75, 75], [0, 0]]
    assert len(glob.glob(str(tmp_path / "logs" / "p*.i*.log"))) == 4


def test_restart_budget_spent_exits_75():
    s = _stub("import sys; sys.exit(75)", n=1, max_restarts=2,
              sleep=lambda _: None)
    assert s.run() == 75
    assert len(s.results) == 3


def test_watchdog_abort_stops():
    s = _stub("import sys; sys.exit(86)", n=1, sleep=lambda _: None)
    assert s.run() == 86
    assert len(s.results) == 1


def test_crash_heals_at_the_same_world(tmp_path):
    script = (
        "import os, sys, time\n"
        f"d = {str(tmp_path)!r}\n"
        "inc = os.environ['MGWFBP_INCARNATION']\n"
        "pid = os.environ['MGWFBP_PROCESS_ID']\n"
        "open(os.path.join(d, f'seen_i{inc}_p{pid}'), 'w').close()\n"
        "if inc == '0' and pid == '1':\n"
        "    sys.exit(3)\n"
        "if inc == '0':\n"
        "    time.sleep(120)\n"
        "sys.exit(0)\n"
    )
    s = _stub(script, sleep=lambda _: None, log_dir=str(tmp_path / "logs"),
              drain_grace_s=10.0)
    t0 = time.monotonic()
    assert s.run() == 0
    assert time.monotonic() - t0 < 60
    assert s.processes == 2 and s._heal_restarts == {"crash": 1}
    rcs = s.results[0].returncodes
    assert rcs[1] == 3 and rcs[0] != 0
    assert s.results[1].returncodes == [0, 0]
    seen = {p for p in os.listdir(str(tmp_path)) if p.startswith("seen_")}
    assert {"seen_i0_p0", "seen_i0_p1", "seen_i1_p0", "seen_i1_p1"} <= seen
    events = _read_events(tmp_path / "logs" / "telemetry.supervisor.jsonl")
    assert events[0]["event"] == "header"
    assert events[0]["run"]["process_index"] == -1
    (fail,) = [e for e in events if e["event"] == "failure"]
    (heal,) = [e for e in events if e["event"] == "heal"]
    assert (fail["class"], fail["target"], fail["rc"]) == ("crash", "p1", 3)
    assert (heal["action"], heal["world"]) == ("relaunch", 2)


def test_sigkill_shrinks_two_to_one(tmp_path):
    script = (
        "import os, signal, sys, time\n"
        f"d = {str(tmp_path)!r}\n"
        "inc = os.environ['MGWFBP_INCARNATION']\n"
        "n = os.environ['MGWFBP_NUM_PROCESSES']\n"
        "pid = os.environ['MGWFBP_PROCESS_ID']\n"
        "open(os.path.join(d, f'seen_i{inc}_n{n}_p{pid}_'\n"
        "     + os.environ.get('MGWFBP_ELASTIC_RESUME', '0')), 'w').close()\n"
        "if inc == '0' and pid == '1':\n"
        "    os.kill(os.getpid(), signal.SIGKILL)\n"
        "if inc == '0':\n"
        "    time.sleep(120)\n"
        "sys.exit(0)\n"
    )
    s = _stub(script, sleep=lambda _: None, log_dir=str(tmp_path / "logs"),
              drain_grace_s=10.0)
    assert s.run() == 0
    assert s.processes == 1
    assert [len(r.returncodes) for r in s.results] == [2, 1]
    assert s.results[0].returncodes[1] == -9
    assert s._heal_restarts == {"oom_kill": 1}
    assert os.path.exists(tmp_path / "seen_i1_n1_p0_1")
    events = _read_events(tmp_path / "logs" / "telemetry.supervisor.jsonl")
    heal = [e for e in events if e["event"] == "heal"][0]
    assert (heal["action"], heal["old_world"], heal["world"]) == (
        "shrink", 2, 1)


@pytest.mark.parametrize("limits,reason,lives", [
    ((1, 99), "budget", 2),      # heal_max_restarts=1
    ((99, 2), "crash_loop", 2),  # heal_same_step_limit=2
])
def test_heal_stops_on_budget_or_crash_loop(tmp_path, limits, reason, lives):
    s = _stub("import sys; sys.exit(7)", n=1, sleep=lambda _: None,
              heal_max_restarts=limits[0], heal_same_step_limit=limits[1],
              log_dir=str(tmp_path / "logs"))
    assert s.run() == 7
    assert len(s.results) == lives
    events = _read_events(tmp_path / "logs" / "telemetry.supervisor.jsonl")
    stops = [e for e in events if e["event"] == "heal"
             and e["action"] == "stop"]
    assert stops and stops[0]["reason"] == reason


def test_no_heal_propagates_and_tears_down_stragglers():
    script = (
        "import os, sys, time\n"
        "if os.environ['MGWFBP_PROCESS_ID'] == '0':\n"
        "    sys.exit(3)\n"
        "time.sleep(300)\n"
    )
    s = _stub(script, grace_s=1.0, heal=False)
    t0 = time.monotonic()
    assert s.run() == 3
    assert time.monotonic() - t0 < 30
    rcs = s.results[0].returncodes
    assert rcs[0] == 3 and rcs[1] != 0
    assert len(s.results) == 1


class _FakeProc:
    def __init__(self):
        self.signals = []

    def poll(self):
        return None

    def send_signal(self, sig):
        self.signals.append(sig)


def test_wedge_verdict_sigterms_the_group(monkeypatch):
    s = _stub("raise SystemExit(0)", env={"MGWFBP_METRICS_PORT": "9100"},
              liveness_grace_s=0.0)
    frozen = {"step": 5, "healthy": True}
    monkeypatch.setattr(s, "_child_status", lambda i, timeout_s=2.0: frozen)
    procs = [_FakeProc(), _FakeProc()]
    s._poll_liveness(procs)
    assert s._pending_failure is None
    time.sleep(0.01)
    s._liveness_poll_t = -1e9
    s._poll_liveness(procs)
    assert s._pending_failure == {"class": "wedged", "target": "p0,p1",
                                  "step": 5}
    assert all(p.signals == [signal.SIGTERM] for p in procs)
    s._liveness_poll_t = -1e9
    s._poll_liveness(procs)
    assert all(len(p.signals) == 1 for p in procs)


def test_wedge_failure_takes_the_heal_budget_not_the_resubmit(tmp_path):
    s = _stub("import sys; sys.exit(75)", n=1, sleep=lambda _: None,
              log_dir=str(tmp_path / "logs"), max_restarts=1)
    real = s._run_group

    def run_group(incarnation):
        result = real(incarnation)
        if incarnation == 0:
            s._pending_failure = {"class": "wedged", "target": "p0",
                                  "step": 3}
        return result

    s._run_group = run_group
    assert s.run() == 75
    assert s._heal_restarts == {"wedged": 1}
    assert len(s.results) == 3


def test_resize_to_relaunches_at_the_new_size(tmp_path):
    script = (
        "import os, sys\n"
        f"d = {str(tmp_path)!r}\n"
        "n = os.environ['MGWFBP_NUM_PROCESSES']\n"
        "pid = os.environ['MGWFBP_PROCESS_ID']\n"
        "open(os.path.join(d, f'seen_n{n}_p{pid}_'\n"
        "     + os.environ.get('MGWFBP_ELASTIC_RESUME', '0')), 'w').close()\n"
        "flag = os.path.join(d, 'drained_' + pid)\n"
        "if not os.path.exists(flag):\n"
        "    open(flag, 'w').close()\n"
        "    sys.exit(75)\n"
        "sys.exit(0)\n"
    )
    s = _stub(script, resize_to=1, sleep=lambda _: None)
    assert s.run() == 0
    assert [r.returncodes for r in s.results] == [[75, 75], [0]]
    seen = {os.path.basename(p) for p in glob.glob(str(tmp_path / "seen_*"))}
    assert {"seen_n2_p0_1", "seen_n2_p1_1", "seen_n1_p0_1"} <= seen
    assert s.processes == 1 and not s._resize_signaled


def test_resize_drains_a_stepping_group_itself(tmp_path, monkeypatch):
    """With the live plane on, the supervisor SIGTERMs the group once a
    child reports a step."""
    s = _stub("raise SystemExit(0)", env={"MGWFBP_METRICS_PORT": "0"},
              resize_to=1)
    monkeypatch.setattr(s, "_child_status",
                        lambda i, timeout_s=2.0: {"step": 1})
    procs = [_FakeProc(), _FakeProc()]
    s._maybe_trigger_resize(procs)
    assert s._resize_signaled
    assert all(p.signals == [signal.SIGTERM] for p in procs)


def test_serve_replica_respawns_under_its_budget(tmp_path):
    s = _stub("import time; time.sleep(2.5)", n=1, serve_replicas=1,
              serve_cmd=[sys.executable, "-c", "import sys; sys.exit(1)"],
              serve_max_restarts=2, backoff_base_s=0.05, backoff_max_s=0.1,
              log_dir=str(tmp_path / "logs"))
    assert s.run() == 0
    assert s._serve_restarts == [2]
    assert 0 in s._serve_exit_warned
    events = _read_events(tmp_path / "logs" / "telemetry.supervisor.jsonl")
    respawns = [e for e in events if e["event"] == "heal"
                and e["action"] == "respawn_serve"]
    assert len(respawns) == 2 and respawns[0]["target"] == "serve0"
    fails = [e for e in events if e["event"] == "failure"
             and e["target"] == "serve0"]
    assert fails and fails[0]["class"] == "crash"


def test_children_get_the_launch_contract(tmp_path):
    s = _stub("raise SystemExit(0)", env={"MGWFBP_METRICS_PORT": "0"},
              log_dir=str(tmp_path))
    env = s._child_env(1, 12345, incarnation=2)
    assert env["MGWFBP_INCARNATION"] == "2"
    assert env["MGWFBP_PROCESS_ID"] == "1"
    assert env["MGWFBP_NUM_PROCESSES"] == "2"
    assert env["MGWFBP_COORDINATOR"] == "127.0.0.1:12345"
    assert env["MGWFBP_ELASTIC_RESUME"] == "1"
    assert env["MGWFBP_METRICS_PORT_FILE"] == str(
        tmp_path / "metrics_port.p1.json")
    serve = s._serve_env(0)
    assert "MGWFBP_COORDINATOR" not in serve
    assert serve["MGWFBP_SERVE_REPLICA"] == "0"
    assert serve["MGWFBP_METRICS_PORT_FILE"].endswith(
        "metrics_port.serve0.json")
    # fleet.json from the port files, in Prometheus http_sd format
    with open(tmp_path / "metrics_port.p0.json", "w") as f:
        json.dump({"host": "127.0.0.1", "port": 4242}, f)
    s._refresh_fleet()
    with open(tmp_path / "fleet.json") as f:
        assert json.load(f) == [{"targets": ["127.0.0.1:4242"], "labels": {
            "job": "mgwfbp", "process": "0", "role": "train"}}]


# -- real children -------------------------------------------------------

def _train_args(tmp_path, name: str, *extra: str) -> list[str]:
    return ["--dnn", "lenet", "--synthetic", "--device", "cpu",
            "--batch-size", "8", "--num-batches-per-epoch", "8",
            "--epochs", "1", "--no-profile-backward", "--telemetry",
            "--ckpt-every-steps", "3",
            "--checkpoint-dir", str(tmp_path / name / "ckpt"),
            "--logdir", str(tmp_path / name / "logs"), *extra]


def _child_env(plan: str = "") -> dict:
    env = dict(os.environ, PYTHONPATH=ROOT, MGWFBP_FAULT_PLAN=plan,
               OMP_NUM_THREADS="1", MGWFBP_SYNTH_TRAIN_N="256",
               MGWFBP_SYNTH_VAL_N="64")
    return env


def test_child_without_a_card_is_a_crash_the_healer_stops_on(tmp_path):
    """Two ranks asked for the card on a machine without one: each child
    fails as a crash, and the healer stops after its crash-loop limit
    instead of relaunching forever or falling back to the CPU."""
    args = _train_args(tmp_path, "nocard")
    args[args.index("--device") + 1] = "cuda"
    s = Supervisor(default_train_cmd(args), 2, env=_child_env(),
                   sleep=lambda _: None, log_dir=str(tmp_path / "sup"))
    t0 = time.monotonic()
    assert s.run() == 1
    assert time.monotonic() - t0 < 120
    assert len(s.results) == 3
    # the first child to fail is a crash (its peer may be SIGTERMed by the
    # healer before it fails too)
    events = _read_events(tmp_path / "sup" / "telemetry.supervisor.jsonl")
    fails = [e for e in events if e["event"] == "failure"]
    assert len(fails) >= 3 and {e["class"] for e in fails} == {"crash"}
    assert [e["action"] for e in events if e["event"] == "heal"] == [
        "relaunch", "relaunch", "stop"]
    with open(tmp_path / "sup" / "p0.i0.log") as f:
        assert "no CUDA device is available" in f.read()


def _final_state(root: str) -> tuple[int, dict]:
    from mgwfbp_tpu_torch.checkpoint import peek_steps, read_step

    (tag,) = os.listdir(os.path.join(root, "ckpt"))
    d = os.path.join(root, "ckpt", tag)
    step = peek_steps(d)[-1]
    params, bstats, _ = read_step(d, step)
    opt = {os.path.basename(p): np.load(p) for p in glob.glob(os.path.join(
        d, "sharded", f"{step:08d}", "p00000", "opt.*.npy"))}
    return step, {**params, **bstats, **opt}


def test_two_process_preempt_resume_bitwise_under_supervisor(tmp_path):
    s = Supervisor(default_train_cmd(_train_args(tmp_path, "faulted")), 2,
                   env=_child_env("preempt@step=4,proc=1"),
                   backoff_base_s=0.1, log_dir=str(tmp_path / "sup_f"))
    t0 = time.monotonic()
    assert s.run() == 0
    assert [r.returncodes for r in s.results] == [[75, 75], [0, 0]]
    ref = Supervisor(default_train_cmd(_train_args(tmp_path, "clean")), 2,
                     env=_child_env(), log_dir=str(tmp_path / "sup_c"))
    assert ref.run() == 0 and len(ref.results) == 1
    assert time.monotonic() - t0 < 180
    step_a, a = _final_state(str(tmp_path / "faulted"))
    step_b, b = _final_state(str(tmp_path / "clean"))
    assert step_a == step_b == 8
    assert list(a) == list(b) and len(a) > 0
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    from mgwfbp_tpu_torch.telemetry import events_of, read_events

    (tag,) = os.listdir(tmp_path / "faulted" / "logs")
    for p in (0, 1):
        recs = read_events(str(tmp_path / "faulted" / "logs" / tag /
                               f"telemetry.p{p}.jsonl"))
        assert len(events_of(recs, "preempt")) == 1
        assert len(events_of(recs, "resume")) == 1
        assert max(r["step"] for r in events_of(recs, "step")) == 8


def test_one_process_heals_preempt_kill_and_wedge_bitwise(tmp_path):
    """The CPU twin of the card's heal run: a preemption (rc 75,
    resubmitted), a SIGKILL in incarnation 1 (oom_kill, relaunched at the
    same world: one process has no survivors to shrink to) and a wedge in
    incarnation 2 (the liveness monitor's verdict, SIGTERM, drain, heal),
    then the end: four incarnations, the failure and heal events in
    order, and the final commit equal bit for bit to an uninterrupted
    run's."""
    def run(name, plan):
        args = _train_args(tmp_path, name)
        args[args.index("--ckpt-every-steps") + 1] = "2"
        args[args.index("--num-batches-per-epoch") + 1] = "10"
        env = dict(_child_env(plan), MGWFBP_METRICS_PORT="0",
                   MGWFBP_LIVENESS_GRACE_S="3")
        s = Supervisor(default_train_cmd(args), 1, env=env,
                       backoff_base_s=0.1, log_dir=str(tmp_path / name / "sup"))
        assert s.run() == 0
        return s

    t0 = time.monotonic()
    healed = run("heal", "preempt@step=3;kill@step=6,inc=1;"
                         "wedge@step=8,secs=600,inc=2")
    assert [r.returncodes for r in healed.results] == [[75], [-9], [75], [0]]
    events = _read_events(tmp_path / "heal" / "sup" /
                          "telemetry.supervisor.jsonl")
    assert [(e["event"], e.get("class"), e.get("action")) for e in events
            if e["event"] in ("failure", "heal")] == [
        ("failure", "oom_kill", None), ("heal", "oom_kill", "relaunch"),
        ("failure", "wedged", None), ("heal", "wedged", "relaunch")]
    wedge = [e for e in events if e.get("class") == "wedged"][0]
    assert wedge["step"] == 7  # the frozen step: the wedge is before step 8
    with open(tmp_path / "heal" / "sup" / "fleet.json") as f:
        assert json.load(f)[0]["labels"]["role"] == "train"
    clean = run("clean", "")
    assert len(clean.results) == 1
    assert time.monotonic() - t0 < 240
    step_a, a = _final_state(str(tmp_path / "heal"))
    step_b, b = _final_state(str(tmp_path / "clean"))
    assert step_a == step_b == 10
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_no_port_file_names_the_runtime_item_as_missing():
    """The runtime and utils item is ported: no file of the port, and not
    the card's smoke, refuses anything naming it."""
    paths = glob.glob(os.path.join(ROOT, "mgwfbp_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    assert sup_mod.__file__ in paths
    for path in paths:
        with open(path) as f:
            assert "Queue 1 item 4" not in f.read(), path
