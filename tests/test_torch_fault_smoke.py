"""The port's fault smoke (``mgwfbp_tpu_torch/tools/fault_smoke.py``) and
pre-PR gate (``mgwfbp_tpu_torch/tools/check.py``), the counterparts of the
JAX package's ``tools/fault_smoke.py`` and ``tools/check.sh``.

  * the single-process lifecycle runs end to end on the CPU (two
    ``train_cli`` processes: nan@2, a stall, preempt@4 to rc 75 with
    ``/postmortems`` probed mid-run and the bundle on disk, then the resume
    to step 12), under its own time limit;
  * the other five lifecycles (``--async-ckpt``, ``--processes 2``,
    ``--resize``, ``--serve``, ``--chaos``) are marked ``slow``: each
    starts several processes (a supervised group, its relaunch, a serve-off
    baseline), as ``check.sh`` runs them under 600 s each;
  * every lifecycle's verdict (``check_*``) is held on recorded event lists
    inside tier-1: the lists as a passing run records them pass, and each
    mutation of one recorded fact fails;
  * the gate's stages, their order, commands, expected exit codes and
    timeouts are checked without running them, and the gate runs every
    stage and fails when one fails.
"""

import copy
import json
import os
import subprocess
import sys

import pytest

from mgwfbp_tpu_torch.runtime.supervisor import GroupResult
from mgwfbp_tpu_torch.tools import check, fault_smoke as fs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SINGLE_TIMEOUT_S = 300
LIFECYCLE_TIMEOUT_S = 600


def _smoke(*flags: str, timeout_s: float) -> dict:
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("MGWFBP_FAULT_PLAN", None)
    res = subprocess.run(
        [sys.executable, "-m", "mgwfbp_tpu_torch.tools.fault_smoke",
         "--device", "cpu", *flags], capture_output=True, text=True,
        timeout=timeout_s, cwd=ROOT, env=env)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_single_process_lifecycle_on_the_cpu():
    out = _smoke(timeout_s=SINGLE_TIMEOUT_S)
    assert out["fault_smoke"] == "ok" and out["device"] == "cpu"
    assert (out["bad_steps"], out["preempt_iteration"],
            out["resume_iteration"], out["final_step"]) == (1, 4, 4, 12)
    assert out["live_metrics_probed"] == ["healthz", "metrics",
                                          "postmortems"]
    assert out["postmortem_bundle"].endswith(os.path.join("postmortems",
                                                          "0000"))


@pytest.mark.slow
@pytest.mark.parametrize("flags", [("--async-ckpt",), ("--processes", "2"),
                                   ("--resize",), ("--serve",),
                                   ("--chaos",)],
                         ids=lambda f: f[0].strip("-"))
def test_group_and_plane_lifecycles_on_the_cpu(flags):
    out = _smoke(*flags, timeout_s=LIFECYCLE_TIMEOUT_S)
    assert "ok" in out.values()


# -- the verdicts on recorded event lists ------------------------------------


def _steps(n=12, process=None, dur=0.01):
    rows = []
    for s in range(1, n + 1):
        r = {"event": "step", "step": s, "epoch": (s - 1) // 6,
             "start_s": s * dur, "dur_s": dur}
        if process is not None:
            r["process"] = process
        rows.append(r)
    return rows


def _faulted():
    recs = [{"event": "header", "schema_version": 2}] + _steps(4)
    recs += [{"event": "bad_step", "step": 2, "epoch": 0, "nonfinite": 31},
             {"event": "checkpoint", "epoch": 0, "iteration": 2,
              "mid_epoch": True},
             {"event": "preempt", "signal": "SIGTERM", "epoch": 0,
              "iteration": 4}]
    bundle = {"manifest": {"trigger": "bad_step", "step": 2,
                           "path": "/r/postmortems/0000"},
              "events": [{"event": "bad_step", "step": 2}],
              "schedule": {"comm_op": "all_reduce", "num_groups": 0}}
    probes = {"metrics": "mgwfbp_steps_total 1", "healthz": "ok",
              "postmortems": {"total": 1, "recent": [
                  {"trigger": "bad_step", "step": 2}]}}
    return dict(rc=fs.PREEMPT_RC, probes=probes, recs=recs, bundle=bundle)


def _resumed():
    recs = _steps(12) + [{"event": "resume", "epoch": 0, "iteration": 4,
                          "mid_epoch": True}]
    return dict(rc=0, recs=recs)


def _merged_group(processes=2):
    merged = []
    for p in range(processes):
        merged += _steps(12, p)
        merged += [
            {"event": "bad_step", "step": 2, "process": p},
            {"event": "preempt", "iteration": 4, "process": p,
             "signal": "SIGTERM" if p == 1 else "PEER"},
            {"event": "resume", "iteration": 4, "mid_epoch": True,
             "process": p}]
    for i, r in enumerate(merged):
        r["t"] = float(i)
    return merged


def _group():
    served = {i: {"run": {"process_index": i}} for i in range(2)}
    fleet = {"reachable": 2, "straggler_table": [{"process": 0},
                                                 {"process": 1}]}
    sd = [{"targets": [f"127.0.0.1:{9000 + i}"],
           "labels": {"process": str(i)}} for i in range(2)]
    return dict(processes=2, rc=0,
                results=[GroupResult(0, [75, 75]), GroupResult(1, [0, 0])],
                served=served, fleet_doc=fleet, fleet_metrics="...", sd=sd,
                merged=_merged_group())


def _resize():
    merged = _merged_group()
    # the relaunch at world 1 is process 0 alone, which resumes once
    merged = [r for r in merged if r["event"] != "bad_step" and not (
        r["event"] == "resume" and r["process"] == 1)]
    merged.append({"event": "resize", "old_world": 2, "new_world": 1,
                   "schedule_source": "relaunch-reshard",
                   "t": merged[-1]["t"] + 1.0})
    manifest = {"world": 2, "processes": {"0": {"rows": [0]},
                                          "1": {"rows": [1]}},
                "layout": {"shard_sizes": [100, 30]}}
    shapes = {(p, g): (1, n) for p in (0, 1)
              for g, n in enumerate((100, 30))}
    return dict(processes=2, resize_to=1, rc=0,
                results=[GroupResult(0, [75, 75]), GroupResult(1, [0])],
                fleet_resize={"from": 2, "to": 1}, merged=merged,
                manifest=manifest, shard_shapes=shapes)


def _async():
    on = _steps(12) + [
        {"event": "checkpoint", "iteration": i, "mid_epoch": True,
         "async": True, "commit_iteration": i + (1 if i % 4 else 0),
         "duration_s": 0.01} for i in (2, 4, 8, 10)]
    return dict(off_recs=_steps(12), on_recs=on)


def _serve():
    on = _steps(12) + [
        {"event": "reload", "step": 2, "lag_s": 0.1},
        {"event": "reload", "step": 8, "lag_s": 0.1},
        {"event": "shadow_eval", "step": 2, "loss": 2.3},
        {"event": "shadow_eval", "step": 8, "loss": 2.1}]
    first = {"served_step": 2, "outputs": [[0.0] * 10] * 2}
    advanced = {"served_step": 8, "outputs": [[0.0] * 10] * 2}
    return dict(rc=0, first=first, advanced=advanced,
                serving_status={"stats": {"requests": 3}}, num_classes=10,
                off_recs=_steps(12), on_recs=on)


def _kill():
    merged = _steps(4, 0) + _steps(4, 1) + _steps(12, 0)
    merged += [
        {"event": "failure", "class": "oom_kill", "target": "p1",
         "process": -1, "rc": -9},
        {"event": "heal", "action": "shrink", "class": "oom_kill",
         "old_world": 2, "world": 1, "process": -1},
        {"event": "resize", "old_world": 2, "new_world": 1, "process": 0},
        {"event": "resume", "iteration": 4, "process": 0}]
    for i, r in enumerate(merged):
        r["t"] = float(i)
    return dict(rc=0, results=[GroupResult(0, [75, -9]),
                               GroupResult(1, [0])],
                processes_after=1, committed=[2, 4], merged=merged)


def _wedge():
    merged = _steps(12, 0) + _steps(12, 1)
    merged += [
        {"event": "failure", "class": "wedged", "target": "p0,p1",
         "process": -1, "step": 2},
        {"event": "heal", "action": "relaunch", "class": "wedged",
         "world": 2, "process": -1},
        {"event": "resume", "iteration": 2, "process": 0},
        {"event": "resume", "iteration": 2, "process": 1}]
    for i, r in enumerate(merged):
        r["t"] = float(i)
    return dict(rc=0, results=[GroupResult(0, [75, 75]),
                               GroupResult(1, [0, 0])],
                processes_after=2, healed_in=35.0, merged=merged)


def _event(name, key="recs"):
    """The first ``name`` record of kw[key]."""
    return lambda kw: next(r for r in kw[key] if r["event"] == name)


def _set(path, value):
    """A mutation: set kw[path[0]]...[path[-1]] to value."""
    def f(kw):
        d = kw
        for k in path[:-1]:
            d = d[k]
        d[path[-1]] = value
    return f


def _edit(find, key, value):
    """A mutation: set ``key`` of the record ``find`` picks."""
    def f(kw):
        find(kw)[key] = value
    return f


def _drop(key, event):
    """A mutation: remove every ``event`` record from kw[key]."""
    def f(kw):
        kw[key] = [r for r in kw[key] if r.get("event") != event]
    return f


VERDICTS = {
    "faulted": (fs.check_faulted_run, _faulted, {
        "rc_0": _set(["rc"], 0),
        "no_healthz": _set(["probes", "healthz"], None),
        "no_postmortems_probe": _set(["probes", "postmortems"], None),
        "bad_step_3": _edit(_event("bad_step"), "step", 3),
        "no_bad_step": _drop("recs", "bad_step"),
        "preempt_by_peer": _edit(_event("preempt"), "signal", "PEER"),
        "preempt_at_5": _edit(_event("preempt"), "iteration", 5),
        "no_mid_epoch_ckpt": _edit(_event("checkpoint"), "mid_epoch",
                                   False),
        "bundle_trigger": _set(["bundle", "manifest", "trigger"], "stall"),
        "bundle_no_schedule": _set(["bundle", "schedule"], None),
    }),
    "resumed": (fs.check_resumed_run, _resumed, {
        "rc_1": _set(["rc"], 1),
        "boundary_resume": _edit(_event("resume"), "mid_epoch", False),
        "resume_at_2": _edit(_event("resume"), "iteration", 2),
        "stopped_early": lambda kw: kw.update(recs=kw["recs"][:-3]
                                              + kw["recs"][-1:]),
    }),
    "group": (fs.check_group_run, _group, {
        "rc_75": _set(["rc"], 75),
        "one_served": lambda kw: kw["served"].pop(1),
        "no_fleet_doc": _set(["fleet_doc"], None),
        "fleet_one_reachable": _set(["fleet_doc", "reachable"], 1),
        "sd_one_process": lambda kw: kw["sd"].pop(),
        "no_resubmission": lambda kw: kw["results"].pop(),
        "both_sigterm": lambda kw: [r.update(signal="SIGTERM")
                                    for r in kw["merged"]
                                    if r["event"] == "preempt"],
        "p0_boundary_resume": lambda kw: next(
            r for r in kw["merged"] if r["event"] == "resume").update(
                mid_epoch=False),
        "p1_no_bad_step": lambda kw: kw.update(merged=[
            r for r in kw["merged"]
            if not (r["event"] == "bad_step" and r["process"] == 1)]),
        "p1_stopped_early": lambda kw: kw.update(merged=[
            r for r in kw["merged"]
            if not (r["event"] == "step" and r["process"] == 1
                    and r["step"] == 12)]),
        "timeline_out_of_order": lambda kw: kw["merged"][3].update(t=-1.0),
    }),
    "resize": (fs.check_resize_run, _resize, {
        "rc_1": _set(["rc"], 1),
        "relaunched_at_2": _set(["results"], [GroupResult(0, [75, 75]),
                                              GroupResult(1, [0, 0])]),
        "no_fleet_view": _set(["fleet_resize"], None),
        "no_resize_event": _drop("merged", "resize"),
        "resize_from_cache": _edit(_event("resize", "merged"),
                                   "schedule_source", "schedule-cache"),
        "world_sized_shard": _set(["shard_shapes", (0, 0)], (2, 100)),
        "resumed_elsewhere": lambda kw: next(
            r for r in kw["merged"] if r["event"] == "resume").update(
                iteration=2),
    }),
    "async": (fs.check_async_run, _async, {
        "sync_save": lambda kw: next(
            r for r in kw["on_recs"] if r["event"] == "checkpoint").pop(
                "async"),
        "never_overlapped": lambda kw: [
            r.update(commit_iteration=r["iteration"]) for r in kw["on_recs"]
            if r["event"] == "checkpoint"],
        "slow_steps": lambda kw: [r.update(dur_s=1.0) for r in kw["on_recs"]
                                  if r["event"] == "step"],
        "no_saves": _drop("on_recs", "checkpoint"),
    }),
    "serve": (fs.check_serve_run, _serve, {
        "rc_1": _set(["rc"], 1),
        "never_answered": _set(["first"], None),
        "never_advanced": _set(["advanced"], None),
        "wrong_width": _set(["num_classes"], 11),
        "no_serving_status": _set(["serving_status"], None),
        "one_reload": lambda kw: kw.update(on_recs=[
            r for r in kw["on_recs"]
            if not (r["event"] == "reload" and r["step"] == 8)]),
        "boundary_reloads_only": lambda kw: [
            r.update(step=6 * (i + 1)) for i, r in enumerate(
                x for x in kw["on_recs"] if x["event"] == "reload")],
        "nan_shadow": lambda kw: next(
            r for r in kw["on_recs"] if r["event"] == "shadow_eval").update(
                loss=float("nan")),
        "slow_steps": lambda kw: [r.update(dur_s=1.0) for r in kw["on_recs"]
                                  if r["event"] == "step"],
    }),
    "kill": (fs.check_kill_run, _kill, {
        "rc_1": _set(["rc"], 1),
        "p1_drained": _set(["results"], [GroupResult(0, [75, 75]),
                                         GroupResult(1, [0])]),
        "survivor_crashed": _set(["results"], [GroupResult(0, [1, -9]),
                                               GroupResult(1, [0])]),
        "not_shrunk": _set(["processes_after"], 2),
        "nothing_committed": _set(["committed"], []),
        "resumed_before_last_commit": _set(["committed"], [2, 4, 6]),
        "verdict_from_a_child": lambda kw: next(
            r for r in kw["merged"] if r["event"] == "failure").update(
                process=0),
        "relaunch_not_shrink": lambda kw: next(
            r for r in kw["merged"] if r["event"] == "heal").update(
                action="relaunch"),
        "stopped_early": lambda kw: kw.update(merged=[
            r for r in kw["merged"]
            if not (r["event"] == "step" and r["step"] == 12)]),
    }),
    "wedge": (fs.check_wedge_run, _wedge, {
        "rc_1": _set(["rc"], 1),
        "slow_heal": _set(["healed_in"], 300.0),
        "not_drained": _set(["results"], [GroupResult(0, [75, -15]),
                                          GroupResult(1, [0, 0])]),
        "shrunk": _set(["processes_after"], 1),
        "p1_not_named": lambda kw: next(
            r for r in kw["merged"] if r["event"] == "failure").update(
                target="p0"),
        "one_resumed": lambda kw: kw.update(merged=[
            r for r in kw["merged"]
            if not (r["event"] == "resume" and r["process"] == 1)]),
    }),
}


@pytest.mark.parametrize("name", sorted(VERDICTS))
def test_verdict_passes_a_recorded_run(name):
    verdict, good, _ = VERDICTS[name]
    assert isinstance(verdict(**good()), dict)


@pytest.mark.parametrize("name,mutation", [
    (name, m) for name in sorted(VERDICTS) for m in VERDICTS[name][2]])
def test_verdict_fails_a_broken_record(name, mutation):
    verdict, good, mutations = VERDICTS[name]
    kw = copy.deepcopy(good())
    mutations[mutation](kw)
    with pytest.raises(AssertionError):
        verdict(**kw)


# -- the gate ----------------------------------------------------------------


def test_gate_stages_without_running_them(tmp_path):
    probe = str(tmp_path / "probe.py")
    st = check.stages(probe, ruff=None)
    assert len(st) == 11
    assert st[0].name == "ruff" and st[0].cmd is None
    assert "ruff not installed" in st[0].notice
    with_ruff = check.stages(probe, ruff="/bin/ruff")[0].cmd
    assert with_ruff[:3] == ["/bin/ruff", "check", "mgwfbp_tpu_torch"]
    assert with_ruff[3:] == check.port_test_files()
    assert st[1].cmd[1:] == ["-m", "mgwfbp_tpu_torch.analysis", "--device",
                             "cpu"] and st[1].want_rc == 0
    assert st[2].cmd[-1] == probe and st[2].want_rc == 32
    assert "--skip-step" in st[2].cmd
    assert st[3].cmd[1:] == ["-m", "mgwfbp_tpu_torch.tools.telemetry_report",
                             "--selftest"]
    flags = [s.cmd[5:] for s in st[4:10]]
    assert flags == [[], ["--async-ckpt"], ["--processes", "2"],
                     ["--resize"], ["--serve"], ["--chaos"]]
    for s in st[4:10]:
        assert s.cmd[1:5] == ["-m", "mgwfbp_tpu_torch.tools.fault_smoke",
                              "--device", "cpu"]
        assert s.timeout_s == 600 and s.want_rc == 0
    tier1 = st[10].cmd
    files = check.port_test_files()
    assert os.path.join("tests", "test_torch_fault_smoke.py") in files
    assert all(os.path.basename(f).startswith("test_torch_") for f in files)
    assert tier1[3:3 + len(files)] == files
    assert tier1[tier1.index("-m", 3) + 1] == "not slow"
    assert tier1[-6:] == ["-p", "xdist", "-n", "4", "--dist", "loadfile"]
    assert st[10].timeout_s == check.TIER1_TIMEOUT_S


def test_the_thr_probe_is_the_gates(tmp_path):
    """The probe the gate writes fails the race checker with exactly the
    THR bit (the gate's third stage, run here)."""
    probe = tmp_path / "probe.py"
    probe.write_text(check.THR_PROBE)
    stage = check.stages(str(probe))[2]
    rc = subprocess.run(stage.cmd, cwd=ROOT, capture_output=True,
                        env=dict(os.environ, PYTHONPATH=ROOT),
                        timeout=120).returncode
    assert rc == check.THR_BIT


def test_the_gate_runs_every_stage_and_fails_on_one(tmp_path, monkeypatch,
                                                    capsys):
    marks = tmp_path / "marks"

    def cmd(name, rc):
        return [sys.executable, "-c",
                f"open({str(marks)!r}, 'a').write({name!r}); "
                f"raise SystemExit({rc})"]

    def fake(names_rcs):
        return lambda probe, ruff=None: [
            check.Stage(n, cmd(n, rc), timeout_s=60, want_rc=want)
            for n, rc, want in names_rcs]

    monkeypatch.setattr(check, "stages", fake(
        [("a", 0, 0), ("b", 3, 0), ("c", 32, 32)]))
    assert check.main([]) == 1
    assert marks.read_text() == "abc"
    assert "FAILED: b: exit 3, want 0" in capsys.readouterr().err
    marks.unlink()
    monkeypatch.setattr(check, "stages", fake([("a", 0, 0), ("c", 32, 32)]))
    assert check.main([]) == 0
    assert marks.read_text() == "ac"
    assert "ALL GREEN" in capsys.readouterr().out
    slow = check.Stage("slow", [sys.executable, "-c",
                                "import time; time.sleep(30)"], timeout_s=1)
    assert check.run_stage(slow, dict(os.environ)) is False
    skip = check.Stage("skip", None, notice="skipped here")
    assert check.run_stage(skip, dict(os.environ)) is True
