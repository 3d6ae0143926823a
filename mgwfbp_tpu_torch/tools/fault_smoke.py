"""Fault-injection smoke: the port's resilience lifecycles, end to end.

The port's counterpart of the JAX package's ``tools/fault_smoke.py``: the
same six lifecycles with the same assertions, driving the port's
``train_cli``, supervisor, flight recorder and serving plane on LeNet
(synthetic MNIST). ``--device`` (default ``cuda``) is passed to every
child; the pre-PR gate (``python -m mgwfbp_tpu_torch.tools.check``) passes
``--device cpu``. A group of several processes on a machine with one card
runs ``--device cpu`` (the launcher gives each process a card of its own).

Single-process (default) drives the REAL launcher twice through
subprocesses:

  1. a LeNet run with ``MGWFBP_FAULT_PLAN=
     "nan@step=2;stall@secs=3,step=4;preempt@step=4"``: it must drop the
     NaN step (``bad_step`` event), write a flight-recorder postmortem
     bundle for it that the live ``/postmortems`` endpoint serves MID-RUN
     (the stall before step 4 holds the run open long enough to probe),
     drain the injected SIGTERM (step-indexed checkpoint + ``preempt``
     event) and exit rc 75 (EX_TEMPFAIL, restart-friendly); the live
     ``/metrics`` and ``/healthz`` are probed mid-run too;
  2. the same command with no fault plan: it must resume from the exact
     mid-epoch step (``resume`` event with mid_epoch) and finish rc 0.

The zero-sync loop reads each step's guard late
(``MGWFBP_GUARD_CHECK_INTERVAL``): the assertions hold the step a record
reports, never the moment it was read.

``--processes 2``: a 2-process group under the auto-resubmit supervisor
with ``preempt@step=4,proc=1`` signaling ONE process; the group must agree
to drain (the un-signaled process records signal ``PEER``), exit rc 75,
get resubmitted, resume mid-epoch on both processes and finish; the
per-process streams must merge into one monotonic timeline
(``telemetry_merge``); each process serves its own port (base +
process_index) and the supervisor's ``/fleet/status`` answers mid-run
with a straggler table naming both, ``/fleet/metrics`` merges both under a
``process`` label and ``fleet.json`` holds both endpoints.

``--resize``: the supervisor's ``--resize-to 1`` drains a 2-process
rs_opt_ag group itself, relaunches it at 1 process from the shard-native
checkpoint (each process's file holds its own shard rows only), which
resumes at the drained step and finishes; ``/fleet/status`` shows the
resize while it happens.

``--async-ckpt``: every mid-epoch save goes through the async writer (at
least one overlapping a later step) and the median step stays within a
generous envelope of a checkpoints-off run.

``--serve``: a ``--serve-shadow`` run answers POST /predict mid-run, the
served step advances across mid-epoch commits (``reload`` and
``shadow_eval`` events), and the median step stays within the envelope of
a serve-off run.

``--chaos``: a SIGKILL mid-epoch (the supervisor classifies the -9 and
shrinks to the survivor, which resumes at the last committed shard-native
step) and a 300 s wedge (only the liveness monitor sees it; the heal must
land in bounded time), with failure/heal events in the supervisor's own
stream and a monotonic merged timeline across the heal.

The verdict of each lifecycle is a ``check_*`` function over what the run
recorded (return codes, probes, event lists), so it can be held on
recorded event lists without running anything.

Usage:
  python -m mgwfbp_tpu_torch.tools.fault_smoke [--device cpu]
      [--processes 2 | --resize | --async-ckpt | --serve | --chaos]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Optional

from mgwfbp_tpu_torch.runtime.supervisor import (
    Supervisor,
    default_train_cmd,
)
from mgwfbp_tpu_torch.runtime.supervisor import free_port as _free_port
from mgwfbp_tpu_torch.telemetry import (
    events_of,
    find_stream_paths,
    read_event_set,
)
from mgwfbp_tpu_torch.tools.telemetry_merge import (
    check_monotonic,
    merge_streams,
)

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PREEMPT_RC = 75  # mirrors mgwfbp_tpu_torch.utils.faults.PREEMPT_RC
STEPS_PER_EPOCH = 6
FINAL_STEP = 2 * STEPS_PER_EPOCH  # two epochs


def _probe(port: int, path: str, timeout_s: float = 1.0):
    """(http status, body) of one endpoint probe, or (None, reason)."""
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout_s
        ) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:  # 503 from /healthz is an answer
        return e.code, e.read().decode()
    except Exception as e:  # noqa: BLE001 — not up yet
        return None, str(e)


def _probe_post(port: int, path: str, doc: dict, timeout_s: float = 2.0):
    """(http status, body) of one POST probe, or (None, reason)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:  # 4xx/5xx is an answer
        return e.code, e.read().decode()
    except Exception as e:  # noqa: BLE001 — not up yet
        return None, str(e)


def _train_args(logdir: str, device: str, ckpt: bool = True,
                extra: tuple = ()) -> list[str]:
    """The train_cli arguments of every lifecycle: LeNet, batch 8, 6 steps
    an epoch, two epochs."""
    args = [
        "--dnn", "lenet", "--synthetic", "--no-profile-backward",
        "--batch-size", "8", "--num-batches-per-epoch", str(STEPS_PER_EPOCH),
        "--max-epochs", "2", "--epochs", "2", "--seed", "7",
        "--logdir", logdir, "--device", device,
    ]
    if ckpt:
        args += [
            "--checkpoint-dir", os.path.join(logdir, "ckpt"),
            "--ckpt-every-steps", "2",
        ]
    return args + ["--telemetry", *extra]


def _env(plan: str, device: str, **extra) -> dict:
    """A child's environment: the fault plan, the checkout importable, one
    intra-op thread per CPU process (several share the host)."""
    env = dict(os.environ)
    env["MGWFBP_FAULT_PLAN"] = plan
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    if device == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _run(
    logdir: str, fault_plan: str, device: str, metrics_port: int = 0,
    ckpt: bool = True, extra: tuple = (),
) -> tuple[int, dict]:
    """One real-launcher run; with metrics_port > 0 the live plane is
    probed WHILE the run is up (mid-run, not post-hoc). Returns (rc, probe
    results)."""
    env = _env(fault_plan, device)
    if metrics_port:
        env["MGWFBP_METRICS_PORT"] = str(metrics_port)
    # child output goes to FILES, not pipes: this loop does not drain
    # while polling, and a chatty child filling a 64 KiB pipe buffer
    # would block forever
    out_path = os.path.join(logdir, "fault_smoke_child.log")
    cmd = default_train_cmd(_train_args(logdir, device, ckpt, extra))
    with open(out_path, "w") as sink:
        proc = subprocess.Popen(cmd, env=env, cwd=_ROOT, stdout=sink,
                                stderr=subprocess.STDOUT)
        probes: dict = {}
        deadline = time.monotonic() + 600
        while proc.poll() is None:
            if time.monotonic() > deadline:
                proc.kill()
                proc.wait()
                raise AssertionError("fault-smoke run timed out")
            if metrics_port and "metrics" not in probes:
                code, body = _probe(metrics_port, "/metrics")
                if code == 200 and "mgwfbp_steps_total" in body:
                    probes["metrics"] = body
                    code, body = _probe(metrics_port, "/healthz")
                    assert code == 200, f"/healthz mid-run: {code} {body}"
                    probes["healthz"] = body.strip()
            if metrics_port and "postmortems" not in probes:
                # the injected-NaN bad step must leave a flight-recorder
                # bundle that /postmortems lists WHILE the run is up (the
                # stall@step=4 in the plan holds the window open)
                code, body = _probe(metrics_port, "/postmortems")
                if code == 200:
                    doc = json.loads(body)
                    if doc.get("total", 0) >= 1 and doc.get("recent"):
                        probes["postmortems"] = doc
            time.sleep(0.1)
    with open(out_path) as f:
        tail = f.read()[-4000:]
    if proc.returncode not in (0, PREEMPT_RC):
        sys.stderr.write(tail)
    if metrics_port:
        assert "metrics" in probes, (
            "live /metrics endpoint never answered mid-run "
            f"(port {metrics_port}); child tail:\n" + tail
        )
    return proc.returncode, probes


def _events(logdir: str) -> list[dict]:
    paths = glob.glob(os.path.join(logdir, "*", "telemetry.jsonl"))
    assert len(paths) == 1, f"expected one telemetry stream, got {paths}"
    return read_event_set(paths[0])


def _supervise(sup: Supervisor) -> tuple[threading.Thread, dict]:
    rc_box: dict = {}
    runner = threading.Thread(
        target=lambda: rc_box.update(rc=sup.run()), daemon=True
    )
    runner.start()
    return runner, rc_box


def _tag_dirs(d: str) -> list[str]:
    return sorted(
        p for p in glob.glob(os.path.join(d, "*"))
        if os.path.isdir(p) and find_stream_paths(p)
    )


def _last_step(merged: list[dict], process: Optional[int] = None) -> int:
    return max(r["step"] for r in events_of(merged, "step")
               if process is None or r["process"] == process)


# ---------------------------------------------------------------------------
# the verdicts: each holds what one lifecycle recorded
# ---------------------------------------------------------------------------


def check_faulted_run(rc: int, probes: dict, recs: list[dict],
                      bundle: dict) -> dict:
    """The single-process faulted run: rc 75, /healthz ok and /postmortems
    naming the bad step mid-run, a bad step at step 2, SIGTERM at
    iteration 4, a mid-epoch checkpoint, the bundle on disk."""
    assert rc == PREEMPT_RC, (
        f"faulted run exited rc {rc}, want {PREEMPT_RC} (EX_TEMPFAIL)"
    )
    assert probes.get("healthz") == "ok", probes
    pm_doc = probes.get("postmortems")
    assert pm_doc is not None, (
        "/postmortems never listed the injected-NaN bundle mid-run; "
        f"probes: {sorted(probes)}"
    )
    assert pm_doc["recent"][0]["trigger"] == "bad_step", pm_doc
    assert pm_doc["recent"][0]["step"] == 2, pm_doc
    bad = events_of(recs, "bad_step")
    assert bad and bad[0]["step"] == 2, f"bad_step missing/wrong: {bad}"
    assert bad[0]["nonfinite"] > 0
    (pre,) = events_of(recs, "preempt")
    assert pre["signal"] == "SIGTERM" and pre["iteration"] == 4, pre
    ckpts = events_of(recs, "checkpoint")
    assert any(c.get("mid_epoch") for c in ckpts), ckpts
    # the bundle itself is on disk, atomic and complete, naming the bad step
    assert bundle["manifest"]["trigger"] == "bad_step", bundle
    assert bundle["manifest"]["step"] == 2, bundle["manifest"]
    assert any(
        r.get("event") == "bad_step" for r in bundle["events"]
    ), "ring dump lacks the triggering bad_step record"
    assert bundle.get("schedule"), "schedule state missing from bundle"
    return {"bad_steps": len(bad), "preempt_iteration": pre["iteration"]}


def check_resumed_run(rc: int, recs: list[dict]) -> dict:
    """The relaunch: rc 0, resumed mid-epoch at iteration 4, both epochs
    finished."""
    assert rc == 0, f"resume run exited rc {rc}"
    resumes = events_of(recs, "resume")
    assert resumes and resumes[-1]["mid_epoch"], resumes
    assert resumes[-1]["iteration"] == 4, resumes
    final = max(s["step"] for s in events_of(recs, "step"))
    assert final == FINAL_STEP, "resumed run did not finish both epochs"
    return {"resume_iteration": resumes[-1]["iteration"],
            "final_step": final}


def check_group_run(processes: int, rc, results: list, served: dict,
                    fleet_doc, fleet_metrics, sd: list,
                    merged: list[dict]) -> dict:
    """The supervised group: rc 0 after one resubmission; every process
    served its own /status; the fleet plane named every process; the
    agreed drain (SIGTERM on p1, PEER on p0) at iteration 4; every process
    resumed mid-epoch there, saw the bad step 2 and finished."""
    assert rc == 0, f"supervised group finished rc {rc}, want 0"
    assert set(served) == set(range(processes)), (
        f"live /status never answered on every per-process port: got "
        f"{sorted(served)}"
    )
    for i, st in served.items():
        assert st["run"]["process_index"] == i, (i, st["run"])
    assert fleet_doc is not None, (
        "/fleet/status never served a live straggler table naming every "
        "process"
    )
    assert fleet_doc["reachable"] == processes, fleet_doc
    assert fleet_metrics is not None, (
        "/fleet/metrics never merged every child under the process label"
    )
    sd_procs = {g["labels"]["process"] for g in sd}
    assert sd_procs == {str(i) for i in range(processes)}, sd
    assert len(results) == 2, (
        f"expected preempt + 1 resubmission, got "
        f"{[r.returncodes for r in results]}"
    )
    assert results[0].preempted, results[0]
    assert results[1].ok, results[1]
    check_monotonic(merged)
    pre = events_of(merged, "preempt")
    signals = {r["process"]: r["signal"] for r in pre}
    assert signals.get(1) == "SIGTERM", signals  # the signaled process
    assert signals.get(0) == "PEER", signals     # drained by agreement
    assert all(r["iteration"] == 4 for r in pre), pre
    resumes = events_of(merged, "resume")
    assert {r["process"] for r in resumes} == set(range(processes))
    assert all(
        r["mid_epoch"] and r["iteration"] == 4 for r in resumes
    ), resumes
    bad = events_of(merged, "bad_step")
    assert {r["process"] for r in bad} == set(range(processes))
    assert all(r["step"] == 2 for r in bad), bad
    for p in range(processes):
        last = _last_step(merged, p)
        assert last == FINAL_STEP, f"process {p} stopped at step {last}"
    return {"preempt_signals": signals}


def check_resize_run(processes: int, resize_to: int, rc, results: list,
                     fleet_resize, merged: list[dict], manifest: dict,
                     shard_shapes: dict) -> dict:
    """The supervisor-driven resize: rc 0, a drained incarnation at
    ``processes`` and a finished one at ``resize_to``, the fleet view of
    the resize, a ``resize`` event (relaunch-reshard) from world
    ``processes`` to ``resize_to``, every process drained at one
    iteration and the relaunch resumed there, both epochs finished, and
    each process's optimizer shard file holding its own rows only
    (``shard_shapes``: {(process, group): shape})."""
    assert rc == 0, f"supervised resize finished rc {rc}, want 0"
    assert len(results) == 2, (
        f"expected drain + 1 resized incarnation, got "
        f"{[r.returncodes for r in results]}"
    )
    assert results[0].preempted, results[0]
    assert len(results[0].returncodes) == processes
    assert results[1].ok, results[1]
    assert len(results[1].returncodes) == resize_to, (
        f"resized incarnation launched at the wrong size: {results[1]}"
    )
    assert fleet_resize is not None, (
        "/fleet/status never surfaced the resize view"
    )
    assert fleet_resize["from"] == processes, fleet_resize
    assert fleet_resize["to"] == resize_to, fleet_resize
    check_monotonic(merged)
    resizes = events_of(merged, "resize")
    assert resizes, "no resize telemetry event recorded"
    rz = resizes[-1]
    assert rz["old_world"] == processes, rz
    assert rz["new_world"] == resize_to, rz
    assert rz["schedule_source"] == "relaunch-reshard", rz
    pre = events_of(merged, "preempt")
    assert len(pre) == processes, pre
    drained = pre[0]["iteration"]
    assert all(r["iteration"] == drained for r in pre), pre
    resumes = events_of(merged, "resume")
    assert resumes and resumes[-1]["iteration"] == drained, (
        f"resumed at {resumes}, drained at {drained}"
    )
    final = _last_step(merged)
    assert final == FINAL_STEP, (
        f"resized run stopped at step {final}, want {FINAL_STEP}"
    )
    rows = {p: doc["rows"] for p, doc in manifest["processes"].items()}
    assert sorted(r for v in rows.values() for r in v) == list(
        range(manifest["world"])
    ), rows
    for p, prows in rows.items():
        for gi, shard in enumerate(manifest["layout"]["shard_sizes"]):
            shape = tuple(shard_shapes[(int(p), gi)])
            assert shape == (len(prows), shard), (p, gi, shape)
    return {"drained_iteration": drained,
            "resize_event": {k: rz[k] for k in (
                "old_world", "new_world", "schedule_source")}}


def _post_warmup_median_step_s(recs: list[dict]) -> float:
    steps = sorted(events_of(recs, "step"), key=lambda r: r["step"])
    assert len(steps) >= 8, f"run too short: {len(steps)} steps"
    durs = sorted(float(r["dur_s"]) for r in steps[2:])
    return durs[len(durs) // 2]


def _within_envelope(on_median: float, off_median: float, what: str) -> None:
    # a generous CPU-jitter envelope that a synchronous save, a synchronous
    # reload or an on-loop dispatcher would still trip
    assert on_median <= off_median * 3.0 + 0.05, (
        f"{what} median step {on_median * 1e3:.2f} ms vs "
        f"{off_median * 1e3:.2f} ms without — it is back on the step path"
    )


def check_async_run(off_recs: list[dict], on_recs: list[dict]) -> dict:
    """Async checkpoints: every mid-epoch save async, committed at or
    after its submit, at least one committed later (the write overlapped
    training), each with a positive duration; the median step within the
    envelope of the checkpoints-off run."""
    off_median = _post_warmup_median_step_s(off_recs)
    on_median = _post_warmup_median_step_s(on_recs)
    mids = [c for c in events_of(on_recs, "checkpoint")
            if c.get("mid_epoch")]
    assert mids, "no mid-epoch checkpoint events"
    assert all(c.get("async") for c in mids), (
        f"mid-epoch saves bypassed the async writer: {mids}"
    )
    assert all(
        int(c["commit_iteration"]) >= int(c["iteration"]) for c in mids
    ), mids
    overlapped = [c for c in mids
                  if int(c["commit_iteration"]) > int(c["iteration"])]
    assert overlapped, (
        "every async save committed within its own submit step — the "
        f"payload write never overlapped training: {mids}"
    )
    assert all(float(c["duration_s"]) > 0 for c in mids), mids
    _within_envelope(on_median, off_median, "async-ckpt")
    return {
        "ckpt_off_median_step_ms": round(off_median * 1e3, 3),
        "async_median_step_ms": round(on_median * 1e3, 3),
        "async_saves": len(mids),
        "overlapping_saves": len(overlapped),
        "max_overlap_steps": max(
            int(c["commit_iteration"]) - int(c["iteration"]) for c in mids
        ),
    }


def check_serve_run(rc: int, first, advanced, serving_status, num_classes,
                    off_recs: list[dict], on_recs: list[dict]) -> dict:
    """The serving plane: rc 0, /predict answered mid-run and the served
    step advanced, one logits row of ``num_classes`` per input, /status's
    serving section with request stats, two or more ordered reloads (one
    of a mid-epoch commit), finite shadow losses, and the median step
    within the envelope of the serve-off run."""
    assert rc == 0, f"serve-on run exited {rc}"
    assert first is not None, "POST /predict never answered 200 mid-run"
    assert advanced is not None, (
        "served step never advanced past the first served commit "
        f"(stuck at {first['served_step']})"
    )
    assert len(advanced["outputs"]) == 2, advanced
    assert len(advanced["outputs"][0]) == num_classes, advanced
    assert serving_status is not None, (
        "/status never carried a serving section with request stats"
    )
    # the serve_stats emit is throttled (~1 s), so the snapshot may trail
    # the live request count: presence with >= 1 is the pin
    assert serving_status["stats"]["requests"] >= 1, serving_status
    reloads = events_of(on_recs, "reload")
    assert len(reloads) >= 2, f"fewer than 2 hot-reloads: {reloads}"
    rsteps = [int(r["step"]) for r in reloads]
    assert rsteps == sorted(rsteps), reloads
    assert any(s % STEPS_PER_EPOCH != 0 for s in rsteps), rsteps
    shadows = events_of(on_recs, "shadow_eval")
    assert shadows, "no shadow_eval events in the stream"
    assert all(
        float(s["loss"]) == float(s["loss"]) for s in shadows
    ), shadows  # NaN check
    off_median = _post_warmup_median_step_s(off_recs)
    on_median = _post_warmup_median_step_s(on_recs)
    _within_envelope(on_median, off_median, "serve-on")
    return {
        "first_served_step": int(first["served_step"]),
        "advanced_served_step": int(advanced["served_step"]),
        "reload_steps": rsteps,
        "shadow_evals": len(shadows),
        "requests_served": serving_status["stats"]["requests"],
        "serve_off_median_step_ms": round(off_median * 1e3, 3),
        "serve_on_median_step_ms": round(on_median * 1e3, 3),
    }


def check_kill_run(rc, results: list, processes_after: int,
                   committed: list[int], merged: list[dict]) -> dict:
    """Chaos A: p1 died by SIGKILL, the survivor exited 75 on the
    coordination deadline, the supervisor classified oom_kill and shrank
    2 -> 1 (its own events, process -1), the resize event 2 -> 1, the
    resume at the last committed shard-native step, both epochs
    finished."""
    assert rc == 0, f"chaos kill run finished rc {rc}, want 0"
    assert len(results) == 2, (
        f"expected kill + 1 healed incarnation, got "
        f"{[r.returncodes for r in results]}"
    )
    rcs0 = results[0].returncodes
    assert rcs0[1] == -9, f"process 1 did not die by SIGKILL: {rcs0}"
    assert rcs0[0] == PREEMPT_RC, (
        f"survivor exited rc {rcs0[0]}, want {PREEMPT_RC} — the "
        "coordination deadline did not convert the dead-peer hang into a "
        "restart-friendly exit"
    )
    assert processes_after == 1, (
        f"supervisor did not shrink to the survivor: {processes_after}"
    )
    r1 = results[1]
    assert r1.ok and len(r1.returncodes) == 1, r1
    assert committed, "no committed shard-native step survived"
    check_monotonic(merged)
    fails = events_of(merged, "failure")
    oom = [r for r in fails if r["class"] == "oom_kill"]
    assert oom and oom[0]["target"] == "p1", fails
    assert oom[0]["process"] == -1, oom  # the supervisor's verdict
    heals = events_of(merged, "heal")
    shrinks = [r for r in heals if r["action"] == "shrink"]
    assert shrinks, heals
    assert shrinks[0]["old_world"] == 2, shrinks
    assert shrinks[0]["world"] == 1, shrinks
    resizes = events_of(merged, "resize")
    assert resizes and resizes[-1]["old_world"] == 2, resizes
    assert resizes[-1]["new_world"] == 1, resizes
    resumed = events_of(merged, "resume")
    assert resumed, "healed incarnation recorded no resume event"
    assert resumed[-1]["iteration"] == committed[-1], (
        f"resumed at iteration {resumed[-1]['iteration']}, but the last "
        f"committed shard-native step is {committed[-1]}"
    )
    final = _last_step(merged)
    assert final == FINAL_STEP, (
        f"shrunk world stopped at step {final}, want {FINAL_STEP}"
    )
    return {"resumed_iteration": resumed[-1]["iteration"]}


def check_wedge_run(rc, results: list, processes_after: int,
                    healed_in: float, merged: list[dict]) -> dict:
    """Chaos B: healed in under 240 s, the SIGTERMed group drained 75/75,
    relaunched at the same world, the liveness monitor's verdict (process
    -1) naming p1 among the frozen set, a same-world relaunch heal, both
    processes resumed and finished."""
    assert rc == 0, f"chaos wedge run finished rc {rc}, want 0"
    # bounded: the heal lands far under both the 300 s wedge and the
    # 600 s barrier default
    assert healed_in < 240, (
        f"wedge heal took {healed_in:.0f}s — the liveness monitor is not "
        "bounding detection"
    )
    assert len(results) == 2, (
        f"expected wedge + 1 healed incarnation, got "
        f"{[r.returncodes for r in results]}"
    )
    assert results[0].returncodes == [PREEMPT_RC, PREEMPT_RC], (
        f"SIGTERMed group did not drain restart-friendly: "
        f"{results[0].returncodes}"
    )
    assert processes_after == 2, "wedge heal must NOT shrink the world"
    r1 = results[1]
    assert r1.ok and len(r1.returncodes) == 2, r1
    check_monotonic(merged)
    fails = events_of(merged, "failure")
    wedged = [r for r in fails if r["class"] == "wedged"]
    # the wedged process freezes its peer at the next collective inside
    # the same grace window, so the verdict names the frozen SET; the
    # wedged p1 must be in it
    assert wedged and "p1" in wedged[0]["target"].split(","), fails
    assert wedged[0]["process"] == -1, wedged  # the monitor's verdict
    heals = events_of(merged, "heal")
    rel = [r for r in heals if r["action"] == "relaunch"]
    assert rel and rel[0]["world"] == 2, heals
    resumed = events_of(merged, "resume")
    assert {r["process"] for r in resumed} == {0, 1}, resumed
    for p in range(2):
        last = _last_step(merged, p)
        assert last == FINAL_STEP, f"process {p} stopped at step {last}"
    return {"wedged_failure_step": wedged[0].get("step")}


# ---------------------------------------------------------------------------
# the lifecycles
# ---------------------------------------------------------------------------


def single_process(device: str) -> dict:
    from mgwfbp_tpu_torch.telemetry.recorder import list_bundles, read_bundle

    with tempfile.TemporaryDirectory(prefix="mgwfbp_fault_smoke_") as d:
        port = _free_port()
        rc, probes = _run(
            d, "nan@step=2;stall@secs=3,step=4;preempt@step=4", device,
            metrics_port=port,
        )
        recs = _events(d)
        tag_dirs = [p for p in glob.glob(os.path.join(d, "*"))
                    if os.path.isdir(os.path.join(p, "postmortems"))]
        assert len(tag_dirs) == 1, f"postmortem directories: {tag_dirs}"
        bundles = list_bundles(tag_dirs[0])
        assert bundles, f"no postmortem bundle on disk under {d}"
        bundle = read_bundle(bundles[0])
        out = check_faulted_run(rc, probes, recs, bundle)
        rc, _ = _run(d, "", device)
        out.update(check_resumed_run(rc, _events(d)))
        return {"fault_smoke": "ok", "device": device, **out,
                "live_metrics_probed": sorted(probes),
                "postmortem_bundle": bundle["manifest"]["path"]}


def multi_process(processes: int, device: str) -> dict:
    with tempfile.TemporaryDirectory(prefix="mgwfbp_mh_smoke_") as d:
        # one plan for the whole group: NaN-poison a step on every process,
        # preempt ONLY process 1; the drain must be agreed
        base_port = _free_port()
        env = _env("nan@step=2;preempt@step=4,proc=1", device,
                   MGWFBP_METRICS_PORT=base_port)
        fleet_port = _free_port()
        sup = Supervisor(
            default_train_cmd(_train_args(d, device)), processes,
            backoff_base_s=0.2, log_dir=os.path.join(d, "supervisor"),
            env=env, fleet_port=fleet_port,
        )
        runner, rc_box = _supervise(sup)
        # mid-run: every process serves a DISTINCT port, each reporting its
        # own process_index in /status; the fleet fan-in answers with a
        # live straggler table naming every process
        served: dict = {}
        fleet_doc = fleet_metrics = None
        deadline = time.monotonic() + 590
        while runner.is_alive() and (
            len(served) < processes or fleet_doc is None
            or fleet_metrics is None
        ):
            if time.monotonic() > deadline:
                break
            for i in range(processes):
                if i in served:
                    continue
                code, body = _probe(base_port + i, "/status")
                if code == 200:
                    served[i] = json.loads(body)
            if fleet_doc is None:
                code, body = _probe(fleet_port, "/fleet/status",
                                    timeout_s=10.0)
                if code == 200:
                    doc = json.loads(body)
                    named = {r["process"]
                             for r in doc.get("straggler_table", [])}
                    if named == set(range(processes)):
                        fleet_doc = doc
            if fleet_metrics is None:
                code, body = _probe(fleet_port, "/fleet/metrics",
                                    timeout_s=10.0)
                if code == 200 and all(
                    f'mgwfbp_current_step{{process="{i}"}}' in body
                    for i in range(processes)
                ):
                    fleet_metrics = body
            time.sleep(0.1)
        runner.join(timeout=600)
        assert not runner.is_alive(), "supervised group wedged"
        sd_path = os.path.join(d, "supervisor", "fleet.json")
        assert os.path.exists(sd_path), sd_path
        with open(sd_path) as f:
            sd = json.load(f)
        tag_dirs = _tag_dirs(d)
        assert len(tag_dirs) == 1, f"expected one run dir, got {tag_dirs}"
        paths = find_stream_paths(tag_dirs[0])
        assert len(paths) == processes, (
            f"expected {processes} per-process streams, got {paths}"
        )
        merged = merge_streams(paths)
        out = check_group_run(processes, rc_box.get("rc"), sup.results,
                              served, fleet_doc, fleet_metrics, sd, merged)
        return {
            "fault_smoke": "ok", "device": device, "processes": processes,
            "incarnations": [r.returncodes for r in sup.results],
            "merged_records": len(merged), **out,
            "metrics_ports": [base_port + i for i in range(processes)],
            "fleet_straggler_table": fleet_doc["straggler_table"],
            "fleet_sd_targets": sorted(t for g in sd for t in g["targets"]),
        }


def _world_ckpt(d: str, world: int) -> str:
    tags = [t for t in glob.glob(os.path.join(d, "ckpt", "*"))
            if f"-n{world}-" in os.path.basename(t)]
    assert tags, os.listdir(os.path.join(d, "ckpt"))
    return tags[0]


def resize_smoke(device: str, processes: int = 2, resize_to: int = 1) -> dict:
    import numpy as np

    with tempfile.TemporaryDirectory(prefix="mgwfbp_resize_smoke_") as d:
        # the stall holds the run open so the supervisor's /status poll sees
        # a completed step before the group finishes; the drain itself
        # comes from the supervisor, not the plan
        env = _env("stall@secs=4,step=2", device,
                   MGWFBP_METRICS_PORT=_free_port())
        fleet_port = _free_port()
        # rs_opt_ag: the optimizer state lives as 1/world shards, the state
        # the shard-native format exists for
        sup = Supervisor(
            default_train_cmd(_train_args(d, device)
                              + ["--comm-op", "rs_opt_ag"]),
            processes, backoff_base_s=0.2,
            log_dir=os.path.join(d, "supervisor"), env=env,
            fleet_port=fleet_port, resize_to=resize_to,
        )
        runner, rc_box = _supervise(sup)
        fleet_resize = None
        deadline = time.monotonic() + 560
        while runner.is_alive() and time.monotonic() < deadline:
            if fleet_resize is None:
                code, body = _probe(fleet_port, "/fleet/status",
                                    timeout_s=10.0)
                if code == 200:
                    doc = json.loads(body)
                    if doc.get("resize"):
                        fleet_resize = doc["resize"]
            time.sleep(0.1)
        runner.join(timeout=600)
        assert not runner.is_alive(), "supervised resize group wedged"
        tag_dirs = _tag_dirs(d)
        assert len(tag_dirs) == 2, (
            f"expected one tag dir per world size, got {tag_dirs}"
        )
        paths = [p for t in tag_dirs for p in find_stream_paths(t)]
        assert len(paths) == processes + resize_to, paths
        merged = merge_streams(paths)
        manifests = sorted(glob.glob(os.path.join(
            _world_ckpt(d, processes), "sharded", "*", "manifest.json")))
        assert manifests, "the group committed no shard-native step"
        with open(manifests[-1]) as f:
            manifest = json.load(f)
        step_dir = os.path.dirname(manifests[-1])
        shapes = {}
        for p in manifest["processes"]:
            for gi in range(len(manifest["layout"]["shard_sizes"])):
                arr = np.load(os.path.join(step_dir, f"p{int(p):05d}",
                                           f"opt.s0.g{gi}.npy"),
                              mmap_mode="r")
                shapes[(int(p), gi)] = arr.shape
        out = check_resize_run(processes, resize_to, rc_box.get("rc"),
                               sup.results, fleet_resize, merged, manifest,
                               shapes)
        return {"fault_smoke": "ok", "mode": "resize", "device": device,
                "incarnations": [r.returncodes for r in sup.results], **out,
                "fleet_resize_view": fleet_resize,
                "merged_records": len(merged)}


def async_ckpt_smoke(device: str) -> dict:
    with tempfile.TemporaryDirectory(prefix="mgwfbp_async_off_") as d:
        rc, _ = _run(d, "", device, ckpt=False)
        assert rc == 0, f"ckpt-off run exited rc {rc}"
        off = _events(d)
    with tempfile.TemporaryDirectory(prefix="mgwfbp_async_on_") as d:
        rc, _ = _run(d, "", device)
        assert rc == 0, f"async-ckpt run exited rc {rc}"
        on = _events(d)
    return {"async_ckpt_smoke": "ok", "device": device,
            **check_async_run(off, on)}


def serve_smoke(device: str) -> dict:
    from mgwfbp_tpu_torch import models

    with tempfile.TemporaryDirectory(prefix="mgwfbp_serve_off_") as d:
        rc, _ = _run(d, "", device)
        assert rc == 0, f"serve-off baseline exited rc {rc}"
        off = _events(d)
    _, meta = models.create_model("lenet")
    h, w, c = meta.input_shape
    inputs = [[[[0.5] * c] * w] * h] * 2  # a batch of 2 constant images
    with tempfile.TemporaryDirectory(prefix="mgwfbp_serve_on_") as d:
        port = _free_port()
        # two stalls hold the run open: the first while an EARLY commit is
        # served, the second after later mid-epoch commits land; the
        # served step observed across them must advance. The loop commits
        # an async save at the step after its submit (the save of step 2
        # lands with step 3), so each stall sits one step after a commit
        env = _env("stall@secs=4,step=4;stall@secs=4,step=10", device,
                   MGWFBP_METRICS_PORT=port)
        out_path = os.path.join(d, "serve_smoke_child.log")
        first = advanced = serving_status = None
        cmd = default_train_cmd(_train_args(d, device,
                                            extra=("--serve-shadow",)))
        with open(out_path, "w") as sink:
            proc = subprocess.Popen(cmd, env=env, cwd=_ROOT, stdout=sink,
                                    stderr=subprocess.STDOUT)
            deadline = time.monotonic() + 600
            while proc.poll() is None:
                if time.monotonic() > deadline:
                    proc.kill()
                    proc.wait()
                    raise AssertionError("serve smoke run timed out")
                code, body = _probe_post(port, "/predict",
                                         {"inputs": inputs})
                if code == 200:
                    doc = json.loads(body)
                    if first is None:
                        first = doc
                    elif (advanced is None and int(doc["served_step"])
                          > int(first["served_step"])):
                        advanced = doc
                if advanced is not None and serving_status is None:
                    code, body = _probe(port, "/status")
                    if code == 200:
                        st = json.loads(body).get("serving")
                        if st and st.get("stats"):
                            serving_status = st
                time.sleep(0.1)
        if proc.returncode != 0:
            with open(out_path) as f:
                sys.stderr.write(f.read()[-4000:])
        out = check_serve_run(proc.returncode, first, advanced,
                              serving_status, meta.num_classes, off,
                              _events(d))
    return {"serve_smoke": "ok", "device": device, **out}


def chaos_smoke(device: str) -> dict:
    out: dict = {"fault_smoke": "ok", "mode": "chaos", "device": device}

    # ---- A: SIGKILL mid-epoch -> shrink to the survivor ----------------
    with tempfile.TemporaryDirectory(prefix="mgwfbp_chaos_kill_") as d:
        # drain-less: process 1 dies by SIGKILL once it has stepped past 4
        # (the inc=0 default keeps the fault out of the healed
        # incarnation); the survivor must give up on the dead peer's
        # collective in seconds
        env = _env("kill@step=4,proc=1", device, MGWFBP_COORD_TIMEOUT_S=20,
                   MGWFBP_METRICS_PORT=_free_port())
        sup = Supervisor(
            default_train_cmd(_train_args(d, device)
                              + ["--comm-op", "rs_opt_ag"]),
            2, backoff_base_s=0.2, drain_grace_s=90.0,
            log_dir=os.path.join(d, "supervisor"), env=env,
        )
        runner, rc_box = _supervise(sup)
        runner.join(timeout=600)
        assert not runner.is_alive(), "chaos kill group wedged"
        # the commit marker is the manifest: the resumed iteration must be
        # the LAST committed shard-native step of the 2-process world
        committed = []
        for m in glob.glob(os.path.join(_world_ckpt(d, 2), "sharded", "*",
                                        "manifest.json")):
            with open(m) as f:
                committed.append(int(json.load(f)["step"]))
        committed.sort()
        sup_stream = os.path.join(d, "supervisor",
                                  "telemetry.supervisor.jsonl")
        assert os.path.exists(sup_stream), "supervisor stream missing"
        tag_dirs = _tag_dirs(d)
        assert len(tag_dirs) == 2, (
            f"expected one tag dir per world size, got {tag_dirs}"
        )
        paths = [p for t in tag_dirs for p in find_stream_paths(t)]
        assert len(paths) == 3, paths  # 2 streams at n2, 1 at n1
        merged = merge_streams(paths + [sup_stream])
        res = check_kill_run(rc_box.get("rc"), sup.results, sup.processes,
                             committed, merged)
        out["kill"] = {"incarnations": [r.returncodes for r in sup.results],
                       "shrunk_to": sup.processes,
                       "committed_steps": committed, **res,
                       "merged_records": len(merged)}

    # ---- B: wedge -> liveness verdict -> bounded heal -------------------
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="mgwfbp_chaos_wedge_") as d:
        # process 1 stops stepping for 300 s at step 3 but keeps serving
        # HTTP: only the liveness monitor's frozen-step verdict sees it
        env = _env("wedge@step=3,secs=300,proc=1", device,
                   MGWFBP_LIVENESS_GRACE_S=6, MGWFBP_COORD_TIMEOUT_S=60,
                   MGWFBP_METRICS_PORT=_free_port())
        sup = Supervisor(
            default_train_cmd(_train_args(d, device)), 2,
            backoff_base_s=0.2, drain_grace_s=90.0,
            log_dir=os.path.join(d, "supervisor"), env=env,
        )
        runner, rc_box = _supervise(sup)
        runner.join(timeout=600)
        assert not runner.is_alive(), "chaos wedge group wedged for real"
        healed_in = time.monotonic() - t0
        sup_stream = os.path.join(d, "supervisor",
                                  "telemetry.supervisor.jsonl")
        tag_dirs = _tag_dirs(d)
        assert len(tag_dirs) == 1, tag_dirs  # the same world both times
        paths = find_stream_paths(tag_dirs[0])
        assert len(paths) == 2, paths
        merged = merge_streams(paths + [sup_stream])
        res = check_wedge_run(rc_box.get("rc"), sup.results, sup.processes,
                              healed_in, merged)
        out["wedge"] = {"incarnations": [r.returncodes for r in sup.results],
                        "healed_in_s": round(healed_in, 1), **res,
                        "merged_records": len(merged)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the children's --device (default cuda; the gate "
                         "passes cpu)")
    ap.add_argument("--processes", type=int, default=1,
                    help="1 = single-process lifecycle (default); >1 = "
                         "supervised group with an agreed drain + "
                         "auto-resubmit")
    ap.add_argument("--resize", action="store_true",
                    help="elastic-resize lifecycle: 2-process supervised "
                         "group drained by the supervisor's --resize-to "
                         "policy, relaunched at 1 process from the "
                         "shard-native checkpoint, resumed to completion")
    ap.add_argument("--async-ckpt", action="store_true", dest="async_ckpt",
                    help="async shard-writer lifecycle: checkpoints-off vs "
                         "async-ckpt step-time envelope + async checkpoint "
                         "event contract")
    ap.add_argument("--chaos", action="store_true",
                    help="self-healing lifecycle: SIGKILL a process "
                         "mid-epoch (the supervisor shrinks to the survivor "
                         "off the last committed shard-native step) and "
                         "wedge one (the liveness monitor heals the group "
                         "in bounded time)")
    ap.add_argument("--serve", action="store_true",
                    help="serving-plane lifecycle: --serve-shadow run "
                         "answering POST /predict mid-run, served step "
                         "advancing across mid-epoch commits, step-time "
                         "envelope vs a serve-off run")
    args = ap.parse_args(argv)
    if args.chaos:
        out = chaos_smoke(args.device)
    elif args.serve:
        out = serve_smoke(args.device)
    elif args.async_ckpt:
        out = async_ckpt_smoke(args.device)
    elif args.resize:
        out = resize_smoke(args.device, max(args.processes, 2), 1)
    elif args.processes > 1:
        out = multi_process(args.processes, args.device)
    else:
        out = single_process(args.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
