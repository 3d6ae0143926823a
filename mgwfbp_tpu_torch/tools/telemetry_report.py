"""Telemetry-stream report: overlap table + run trend from one events file.

The port's counterpart of the JAX package's ``tools/telemetry_report.py``,
with its flags and output formats, on the port's own telemetry functions
(it imports nothing of JAX). Reads a run's telemetry JSONL (written by
`mgwfbp_tpu_torch.telemetry`, enabled with ``--telemetry`` on the train
CLI) and prints:

  * the run header (model/world/comm_op/policy);
  * the step-time trend — span count, mean/min/max seconds per step, first
    vs last 10-span window (throughput drift over the run);
  * the per-merge-group exposed/hidden comm table from the latest overlap
    snapshot, with the attribution source (``trace`` on backends whose op
    metadata keeps the `mgwfbp_groupNNNN` scopes; ``cost-model`` on the
    CPU mesh, whose traces drop the name stack);
  * the aggregate overlap-efficiency number (hidden / total comm — the
    paper's headline metric);
  * the alarms table — cost-model drift rows (kind, merge group, residual
    vs band) and live straggler rows (slow process, excess) from the
    drift detector / multi-host probe (telemetry/drift.py), raise and
    clear edges both;
  * lifecycle events: resizes (and which schedule path won), checkpoints,
    autotune race rows, watchdog stalls, bench skips.

Optionally renders the same stream for external viewers:

  python -m mgwfbp_tpu_torch.tools.telemetry_report <run>/telemetry.jsonl
  python -m mgwfbp_tpu_torch.tools.telemetry_report <run>/telemetry.jsonl \
      --chrome-trace trace.json --prometheus metrics.prom
  python -m mgwfbp_tpu_torch.tools.telemetry_report --live http://host:port
  python -m mgwfbp_tpu_torch.tools.telemetry_report --selftest

``--live`` renders the overlap/alarms/lifecycle view from a RUNNING
job's /status + /metrics endpoints (telemetry/serve.py) instead of JSONL
files; pointed at a supervisor's fleet fan-in it renders the group view
(/fleet/status: per-process table, live stragglers, fleet alarms).

``--selftest`` exercises the full pipeline (writer -> reader -> report ->
Chrome trace -> Prometheus) on a synthetic stream in a temp dir — the
standing-gate smoke ``python -m mgwfbp_tpu_torch.tools.check`` runs, no
card or dataset needed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def _fmt_s(v) -> str:
    return f"{v:.6g}" if isinstance(v, (int, float)) else "n/a"


def _window_mean(spans: list[dict], sl: slice) -> float:
    w = spans[sl]
    return sum(float(s["dur_s"]) for s in w) / max(len(w), 1)


def format_report(records: list[dict]) -> str:
    from mgwfbp_tpu_torch.telemetry import events_of

    lines: list[str] = []
    header = next(iter(events_of(records, "header")), {})
    run = header.get("run", {}) or {}
    desc = ", ".join(f"{k}={v}" for k, v in sorted(run.items()))
    lines.append(
        f"telemetry stream: schema v{header.get('schema_version', '?')}"
        + (f" ({desc})" if desc else "")
    )

    steps = events_of(records, "step")
    if steps:
        durs = [float(s["dur_s"]) for s in steps]
        lines.append("")
        lines.append(
            f"steps: {len(steps)} spans, mean {_fmt_s(sum(durs)/len(durs))} "
            f"s/step (min {_fmt_s(min(durs))}, max {_fmt_s(max(durs))})"
        )
        if len(steps) >= 20:
            first = _window_mean(steps, slice(0, 10))
            last = _window_mean(steps, slice(-10, None))
            drift = (last - first) / first * 100.0 if first > 0 else 0.0
            lines.append(
                f"trend: first-10 {_fmt_s(first)} s -> last-10 "
                f"{_fmt_s(last)} s ({drift:+.1f}%)"
            )
    else:
        lines.append("steps: none recorded")

    from mgwfbp_tpu_torch.telemetry.export import latest_snapshot

    snap, rows = latest_snapshot(records)
    if snap is not None:
        lines.append("")
        lines.append(
            f"overlap snapshot (step {snap.get('step')}, attribution="
            f"{snap.get('attribution')}):"
        )
        cross = float(snap.get("tf_total_s", 0.0) or 0.0) > 0.0
        hier = float(snap.get("dcn_s", 0.0) or 0.0) > 0.0
        lines.append(
            f"  {'group':>5} {'bytes':>12} {'comm_s':>10} {'hidden_s':>10} "
            f"{'exposed_s':>10}"
            + (f" {'ag_s':>10}" if cross else "")
            + (f" {'ici_s':>10} {'dcn_s':>10}" if hier else "")
        )
        for r in rows:
            row = (
                f"  {int(r['group']):>5} {int(r['nbytes']):>12} "
                f"{_fmt_s(r['comm_s']):>10} {_fmt_s(r['hidden_s']):>10} "
                f"{_fmt_s(r['exposed_s']):>10}"
            )
            if cross:
                # cross-step regime: ag_s is the deferred all-gather leg
                # riding the NEXT step's forward
                row += f" {_fmt_s(r.get('ag_s', 0.0)):>10}"
            if hier:
                # hierarchical regime: each group's comm split by LINK
                row += (
                    f" {_fmt_s(r.get('ici_s', 0.0)):>10} "
                    f"{_fmt_s(r.get('dcn_s', 0.0)):>10}"
                )
            lines.append(row)
        tail = (
            f"(forward {_fmt_s(snap.get('tf_total_s'))} s, backward "
            if cross
            else "(backward "
        )
        lines.append(
            f"  total comm {_fmt_s(snap.get('comm_s'))} s = hidden "
            f"{_fmt_s(snap.get('hidden_s'))} s + exposed "
            f"{_fmt_s(snap.get('exposed_s'))} s "
            + tail
            + f"{_fmt_s(snap.get('tb_total_s'))} s, step "
            f"{_fmt_s(snap.get('step_s'))} s)"
        )
        if cross:
            lines.append(
                "  cross-step regime (rs_fwd_ag): each group's AG is "
                "deferred into the next step's forward; hidden counts "
                "both forward- and backward-side overlap"
            )
        if hier:
            lines.append(
                "  hierarchical regime (hier): comm split by link — ici "
                f"{_fmt_s(snap.get('ici_s'))} s vs dcn "
                f"{_fmt_s(snap.get('dcn_s'))} s; bottleneck link: "
                f"{snap.get('bottleneck_link')}"
            )
        lines.append(
            f"overlap efficiency: {float(snap.get('efficiency', 0.0)):.4f} "
            "(hidden / total comm; 1.0 = fully hidden)"
        )
    else:
        lines.append("")
        lines.append("overlap: no snapshot recorded (single-device run, "
                     "policy 'none', or telemetry off during fit)")

    lines.extend(_health_section(records))
    lines.extend(_serving_section(records))

    alarms = events_of(records, "drift_alarm", "straggler", "health_alarm")
    if alarms:
        lines.append("")
        lines.append("alarms:")
        lines.append(
            f"  {'kind':>17} {'edge':>6} {'group/proc':>10} "
            f"{'residual':>10} {'band':>8} {'step':>8}"
        )
        for r in alarms:
            if r.get("event") == "drift_alarm":
                kind = str(r.get("kind"))
                who = (
                    str(r.get("group"))
                    if int(r.get("group", -1)) >= 0 else "agg"
                )
                residual = _fmt_s(r.get("residual"))
                band = _fmt_s(r.get("band"))
            elif r.get("event") == "health_alarm":
                kind = str(r.get("kind"))
                who = (
                    str(r.get("group"))
                    if int(r.get("group", -1)) >= 0 else "agg"
                )
                residual = _fmt_s(r.get("value"))
                band = _fmt_s(r.get("band"))
            else:
                kind = "straggler"
                who = f"p{r.get('slow_process')}"
                residual = _fmt_s(r.get("excess_s"))
                band = "-"
            lines.append(
                f"  {kind:>17} "
                f"{'RAISE' if r.get('active') else 'clear':>6} "
                f"{who:>10} {residual:>10} {band:>8} "
                f"{str(r.get('step', '-')):>8}"
            )

    lifecycle = []
    for ev, render in (
        ("resize", lambda r: (
            f"resize {r.get('old_world')} -> {r.get('new_world')} "
            f"({r.get('schedule_source')}, {r.get('num_groups')} groups)")),
        ("checkpoint", _ckpt_line),
        ("autotune_race", lambda r: (
            f"autotune race {r.get('label')}: "
            f"{_fmt_s(r.get('measured_step_s'))} s/step "
            f"({'verified' if r.get('verified') else 'rejected'})")),
        ("autotune_commit", lambda r: (
            f"autotune commit {r.get('winner')} "
            f"({r.get('comm_op')}, {r.get('num_groups')} groups, "
            f"source={r.get('source')})")),
        ("watchdog_stall", lambda r: (
            f"WATCHDOG STALL in {r.get('phase')!r} after "
            f"{_fmt_s(r.get('idle_s'))} s"
            + (" (aborted)" if r.get("abort") else ""))),
        ("bench_skip", lambda r: f"bench skipped: {r.get('detail')}"),
        ("bad_step", lambda r: (
            f"BAD STEP {r.get('step')} (epoch {r.get('epoch')}): "
            f"{_fmt_s(r.get('nonfinite'))} non-finite gradient element(s), "
            "update dropped")),
        ("rollback", lambda r: (
            f"ROLLBACK after {r.get('bad_steps')} consecutive bad steps "
            f"-> restored iter {r.get('restored_iteration')} "
            f"(epoch {r.get('restored_epoch')})")),
        ("preempt", lambda r: (
            f"PREEMPTED by {r.get('signal')} at epoch {r.get('epoch')} "
            f"iter {r.get('iteration')} (checkpointed, rc 75)")),
        ("resume", lambda r: (
            f"resumed at epoch {r.get('epoch')} iter {r.get('iteration')}"
            + (" (mid-epoch)" if r.get("mid_epoch") else " (boundary)"))),
        ("failure", lambda r: (
            f"FAILURE [{r.get('class')}] on {r.get('target')}"
            + (f" rc {r.get('rc')}" if r.get("rc") is not None else "")
            + (f" at step {r.get('step')}"
               if r.get("step") is not None else "")
            + (f" ({r.get('op')})" if r.get("op") else ""))),
        ("heal", lambda r: (
            f"HEAL {r.get('action')}"
            + (f" [{r.get('class')}]" if r.get("class") else "")
            + (f" {r.get('old_world')} -> {r.get('world')} proc(s)"
               if r.get("action") == "shrink"
               else (f" at world {r.get('world')}"
                     if r.get("world") is not None else ""))
            + (f" (reason: {r.get('reason')})" if r.get("reason") else "")
            + (f" ({r.get('restarts')} restart(s))"
               if r.get("restarts") is not None else ""))),
    ):
        for r in events_of(records, ev):
            lifecycle.append(render(r))
    if lifecycle:
        lines.append("")
        lines.append("lifecycle:")
        lines.extend(f"  {s}" for s in lifecycle)

    # checkpoint save-duration trend: creeping save cost is a
    # regression signal (state growth, fs contention), and a save whose
    # async payload write overlapped more than one optimizer step is
    # worth surfacing — that is the writer earning its keep, or, when
    # the overlap keeps growing, the writer falling behind the cadence
    saves = [
        r for r in events_of(records, "checkpoint")
        if r.get("duration_s") is not None
    ]
    if saves:
        durs = [float(r["duration_s"]) for r in saves]
        n_async = sum(1 for r in saves if r.get("async"))
        lines.append("")
        lines.append(
            f"checkpoint saves ({len(saves)}, {n_async} async):"
        )
        half = len(durs) // 2
        trend = ""
        if half >= 1 and len(durs) >= 4:
            early = sum(durs[:half]) / half
            late = sum(durs[half:]) / (len(durs) - half)
            trend = (
                f", trend {_fmt_s(early)} -> {_fmt_s(late)} s"
                + (" [REGRESSING]" if late > 1.5 * early else "")
            )
        lines.append(
            f"  duration mean {_fmt_s(sum(durs) / len(durs))} s, "
            f"max {_fmt_s(max(durs))} s{trend}"
        )
        for r in saves:
            ov = _ckpt_overlap_steps(r)
            if ov > 1:
                lines.append(
                    f"  save at iter {r.get('iteration')} overlapped "
                    f"{ov} steps (committed at iter "
                    f"{r.get('commit_iteration')})"
                )
    return "\n".join(lines)


def _ckpt_overlap_steps(r: dict) -> int:
    """Steps the async payload write spanned: submit iteration to commit
    iteration (0 for synchronous saves, which block the loop)."""
    if not r.get("async") or r.get("commit_iteration") is None:
        return 0
    return int(r["commit_iteration"]) - int(r.get("iteration", 0))


def _ckpt_line(r: dict) -> str:
    s = f"checkpoint epoch {r.get('epoch')} iter {r.get('iteration')}"
    if r.get("duration_s") is not None:
        s += (
            f" [{r.get('format')} {_fmt_s(r.get('duration_s'))} s, "
            f"{int(r.get('bytes', 0)) // 1024} KiB/proc]"
        )
    if r.get("async"):
        ov = _ckpt_overlap_steps(r)
        s += f" [async, +{ov} step(s) to commit]"
    return s


def _ewma(values: list[float], alpha: float = 0.1):
    out = None
    for v in values:
        if v != v:  # NaN — a bad step's loss; skip, don't poison
            continue
        out = v if out is None else alpha * v + (1.0 - alpha) * out
    return out


def _health_section(records: list[dict]) -> list[str]:
    """Training-health section: loss trend/EWMA, grad-norm
    trend, update ratio, the per-merge-group grad-norm trend, and the
    postmortem bundle index."""
    from mgwfbp_tpu_torch.telemetry import events_of

    lines: list[str] = []
    health = events_of(records, "health")
    if health:
        losses = [float(h.get("loss", float("nan"))) for h in health]
        norms = [float(h.get("grad_norm", float("nan"))) for h in health]
        ratios = [
            float(h.get("update_ratio", float("nan"))) for h in health
        ]
        finite_n = [v for v in norms if v == v]
        lines.append("")
        lines.append(f"training health ({len(health)} records):")
        lines.append(
            f"  loss: first {_fmt_s(losses[0])} -> last "
            f"{_fmt_s(losses[-1])} (ewma {_fmt_s(_ewma(losses))}); "
            f"update/param ratio last {_fmt_s(ratios[-1])}"
        )
        if finite_n:
            lines.append(
                f"  grad norm: first {_fmt_s(norms[0])} -> last "
                f"{_fmt_s(norms[-1])} (max {_fmt_s(max(finite_n))})"
            )
        bad = sum(1 for v in losses if v != v)
        if bad:
            lines.append(
                f"  non-finite loss records: {bad} (see bad_step rows)"
            )
        per_group = [h.get("group_norms") for h in health]
        per_group = [g for g in per_group if g]
        if per_group and len(per_group[-1]) == len(per_group[0]):
            lines.append(
                f"  {'group':>5} {'gnorm_first':>12} {'gnorm_last':>12}"
            )
            for gi in range(len(per_group[0])):
                lines.append(
                    f"  {gi:>5} {_fmt_s(per_group[0][gi]):>12} "
                    f"{_fmt_s(per_group[-1][gi]):>12}"
                )
        comp = [h.get("compression_error") for h in health]
        comp = [c for c in comp if c]
        if comp:
            lines.append(
                f"  compression error (worst group): first "
                f"{_fmt_s(max(comp[0]))} -> last {_fmt_s(max(comp[-1]))}"
            )
    pms = events_of(records, "postmortem")
    if pms:
        lines.append("")
        lines.append(f"postmortem bundles ({len(pms)}):")
        lines.append(f"  {'trigger':>15} {'step':>8}  path")
        for r in pms:
            lines.append(
                f"  {str(r.get('trigger')):>15} "
                f"{str(r.get('step', '-')):>8}  {r.get('path')}"
            )
    return lines


def _serving_section(records: list[dict]) -> list[str]:
    """Serving-plane section: hot-reload count + lag trend,
    request latency quantiles, queue depth trend, batch fill, and the
    shadow-eval loss against the training loss it shadows."""
    from mgwfbp_tpu_torch.telemetry import events_of

    lines: list[str] = []
    reloads = events_of(records, "reload")
    stats = events_of(records, "serve_stats")
    shadows = events_of(records, "shadow_eval")
    if not (reloads or stats or shadows):
        return lines
    lines.append("")
    lines.append("serving:")
    if reloads:
        lags = [float(r.get("lag_s", 0.0)) for r in reloads]
        lines.append(
            f"  hot-reloads: {len(reloads)} (step "
            f"{reloads[0].get('step')} -> {reloads[-1].get('step')}), "
            f"reload lag mean {_fmt_s(sum(lags) / len(lags))} s, "
            f"max {_fmt_s(max(lags))} s"
        )
    if stats:
        last = stats[-1]
        lines.append(
            f"  requests: {last.get('requests')} total, latency p50 "
            f"{_fmt_s(last.get('latency_p50_s'))} s / p95 "
            f"{_fmt_s(last.get('latency_p95_s'))} s / p99 "
            f"{_fmt_s(last.get('latency_p99_s'))} s, batch fill "
            f"{_fmt_s(last.get('batch_fill'))}"
        )
        depths = [float(s.get("queue_depth", 0)) for s in stats]
        lines.append(
            f"  queue depth: first {_fmt_s(depths[0])} -> last "
            f"{_fmt_s(depths[-1])} (max {_fmt_s(max(depths))})"
        )
    if shadows:
        first, last = shadows[0], shadows[-1]
        line = (
            f"  shadow eval: {len(shadows)} scores, loss "
            f"{_fmt_s(first.get('loss'))} (step {first.get('step')}) -> "
            f"{_fmt_s(last.get('loss'))} (step {last.get('step')})"
        )
        if last.get("train_loss") is not None:
            delta = float(last["loss"]) - float(last["train_loss"])
            line += (
                f"; vs training loss {_fmt_s(last.get('train_loss'))} "
                f"(delta {delta:+.4g})"
            )
        lines.append(line)
    return lines


def _alarm_lines(alarms: list[dict]) -> list[str]:
    """Active-alarm table rows (live /status and /fleet/status share the
    same alarm dicts the aggregator keeps)."""
    lines = [
        f"  {'kind':>14} {'group/proc':>10} {'residual':>10} {'band':>8}"
    ]
    for a in alarms:
        if a.get("alarm") == "straggler" or "slow_process" in a:
            kind = "straggler"
            who = f"p{a.get('slow_process')}"
            residual = _fmt_s(a.get("excess_s"))
            band = "-"
        else:
            # drift alarms report `residual`, health alarms `value`
            kind = str(a.get("kind"))
            who = (
                str(a.get("group"))
                if int(a.get("group", -1)) >= 0 else "agg"
            )
            residual = _fmt_s(a.get("residual", a.get("value")))
            band = _fmt_s(a.get("band"))
        procs = a.get("processes")
        lines.append(
            f"  {kind:>14} {who:>10} {residual:>10} {band:>8}"
            + (f"  reported by {sorted(procs)}" if procs else "")
        )
    return lines


def format_live_report(status: dict, values: dict) -> str:
    """One process's live view, from its /status JSON + parsed /metrics
    (same sections as the post-hoc report, sourced from the running
    job)."""
    lines: list[str] = []
    run = status.get("run", {}) or {}
    desc = ", ".join(f"{k}={v}" for k, v in sorted(run.items()))
    lines.append(f"live /status ({desc})" if desc else "live /status")
    lines.append(
        f"health: {'ok' if status.get('healthy') else 'UNHEALTHY'}"
        + (
            f" — {status.get('health_reason')}"
            if not status.get("healthy") else ""
        )
        + f" (uptime {_fmt_s(status.get('uptime_s'))} s)"
    )
    lines.append("")
    lines.append(
        f"steps: {values.get('mgwfbp_steps_total', 0)} recorded, at step "
        f"{status.get('step')} epoch {status.get('epoch')}, mean "
        f"{_fmt_s(values.get('mgwfbp_step_seconds'))} s/step "
        "(rolling window)"
    )
    sched = status.get("schedule")
    if sched:
        lines.append(
            f"schedule: {sched.get('comm_op')} x "
            f"{sched.get('num_groups')} group(s) "
            f"({sched.get('policy_detail')})"
        )
    eff = status.get("overlap_efficiency")
    if eff is not None:
        lines.append(
            f"overlap efficiency: {float(eff):.4f} (hidden "
            f"{_fmt_s(values.get('mgwfbp_comm_hidden_seconds'))} s + "
            f"exposed {_fmt_s(values.get('mgwfbp_comm_exposed_seconds'))}"
            " s per step)"
        )
    health = status.get("health")
    if health:
        lines.append(
            f"training health (step {health.get('step')}): loss "
            f"{_fmt_s(health.get('loss'))}, grad norm "
            f"{_fmt_s(health.get('grad_norm'))}, update/param ratio "
            f"{_fmt_s(health.get('update_ratio'))}"
        )
        gn = health.get("group_norms") or []
        if gn:
            lines.append(
                "  per-group grad norms: "
                + ", ".join(
                    f"g{gi}={_fmt_s(v)}" for gi, v in enumerate(gn)
                )
            )
        comp = health.get("compression_error") or []
        if comp:
            lines.append(
                f"  compression error (worst group): {_fmt_s(max(comp))}"
            )
    serving = status.get("serving")
    if serving:
        lines.append("")
        lines.append(
            f"serving: step {serving.get('step')}, "
            f"{serving.get('reloads', 0)} hot-reload(s), reload lag "
            f"{_fmt_s(serving.get('reload_lag_s'))} s"
        )
        st = serving.get("stats") or {}
        if st:
            lines.append(
                f"  requests {st.get('requests', 0)}, queue depth "
                f"{st.get('queue_depth', 0)}, batch fill "
                f"{_fmt_s(st.get('batch_fill'))}, latency p50 "
                f"{_fmt_s(st.get('latency_p50_s'))} s / p95 "
                f"{_fmt_s(st.get('latency_p95_s'))} s / p99 "
                f"{_fmt_s(st.get('latency_p99_s'))} s"
            )
        sh = serving.get("shadow") or {}
        if sh:
            line = (
                f"  shadow eval (step {sh.get('step')}): loss "
                f"{_fmt_s(sh.get('loss'))}"
            )
            if sh.get("train_loss") is not None:
                line += f" vs training {_fmt_s(sh.get('train_loss'))}"
            lines.append(line)
    pm = status.get("postmortems") or {}
    if pm.get("total"):
        lines.append(
            f"postmortem bundles: {pm['total']} written"
        )
        for b in pm.get("recent", []):
            lines.append(
                f"  {b.get('trigger')} @ step {b.get('step')}: "
                f"{b.get('path')}"
            )
    alarms = status.get("active_alarms") or []
    lines.append("")
    if alarms:
        lines.append(f"active alarms ({len(alarms)}):")
        lines.extend(_alarm_lines(alarms))
    else:
        lines.append("active alarms: none")
    lines.append("")
    lines.append("lifecycle counters:")
    for key, label in (
        ("mgwfbp_checkpoints_total", "checkpoints"),
        ("mgwfbp_resizes_total", "resizes"),
        ("mgwfbp_bad_steps_total", "bad steps"),
        ("mgwfbp_rollbacks_total", "rollbacks"),
        ("mgwfbp_preempts_total", "preempts"),
        ("mgwfbp_resumes_total", "resumes"),
        ("mgwfbp_failures_total", "hard failures"),
        ("mgwfbp_heals_total", "heals"),
        ("mgwfbp_watchdog_stalls_total", "watchdog stalls"),
        ("mgwfbp_autotune_commits_total", "autotune commits"),
        ("mgwfbp_drift_alarms_total", "drift alarms"),
        ("mgwfbp_straggler_alarms_total", "straggler alarms"),
        ("mgwfbp_health_alarms_total", "health alarms"),
        ("mgwfbp_postmortems_total", "postmortem bundles"),
        ("mgwfbp_profile_windows_total", "profile windows"),
        ("mgwfbp_serve_requests_total", "predict requests"),
        ("mgwfbp_serve_reloads_total", "hot-reloads"),
        ("mgwfbp_shadow_evals_total", "shadow evals"),
    ):
        v = values.get(key, 0)
        if v:
            lines.append(f"  {label}: {v}")
    prof = status.get("profile") or {}
    if prof.get("state") not in (None, "idle"):
        lines.append("")
        lines.append(f"profile window: {prof.get('state')}")
        res = prof.get("result")
        if res:
            lines.append(
                f"  {res.get('steps')} step(s), attribution="
                f"{res.get('attribution')}"
                + (
                    ", " + ", ".join(
                        f"g{g['group']}={_fmt_s(g.get('device_s'))}s"
                        for g in res.get("groups", [])
                        if "device_s" in g
                    ) if res.get("groups") else ""
                )
            )
    return "\n".join(lines)


def format_fleet_report(doc: dict) -> str:
    """The supervisor fan-in's group view (/fleet/status)."""
    lines = [
        f"fleet /fleet/status: {doc.get('reachable', 0)} process(es) "
        f"reachable, {len(doc.get('unreachable') or [])} unreachable, "
        f"{'healthy' if doc.get('healthy') else 'UNHEALTHY'}"
    ]
    table = doc.get("straggler_table") or []
    if table:
        lines.append("")
        lines.append("live straggler table (mean-excess vs fastest):")
        lines.append(
            f"  {'proc':>5} {'step':>8} {'mean_step_s':>12} "
            f"{'excess_s':>10} {'excess_%':>9}"
        )
        for r in table:
            lines.append(
                f"  {r['process']:>5} {str(r.get('step', '-')):>8} "
                f"{_fmt_s(r['mean_step_s']):>12} "
                f"{_fmt_s(r.get('excess_s')):>10} "
                f"{r.get('excess_pct', 0.0):>8.1f}%"
            )
    slow = doc.get("slowest_process")
    if slow:
        lines.append(
            f"slowest: process {slow['process']} "
            f"(+{_fmt_s(slow['excess_s'])} s/step, "
            f"+{slow['excess_pct']:.1f}%)"
        )
    heal = doc.get("heal")
    if heal:
        lines.append("")
        state = "enabled" if heal.get("enabled") else "DISABLED (--no-heal)"
        lines.append(
            f"self-healing: {state}, liveness grace "
            f"{_fmt_s(heal.get('liveness_grace_s'))} s, budget "
            f"{heal.get('budget')} restart(s)/class"
        )
        restarts = heal.get("restarts") or {}
        if restarts:
            lines.append(
                "  heals so far: " + ", ".join(
                    f"{cls}={n}" for cls, n in sorted(restarts.items())
                )
            )
        pending = heal.get("pending_failure")
        if pending:
            lines.append(
                f"  PENDING FAILURE: {pending.get('class')} on "
                f"{pending.get('target')} (step {pending.get('step')}) "
                "— draining to heal"
            )
    serving = doc.get("serving")
    if serving:
        lines.append("")
        lines.append(
            f"serve replicas: {serving.get('alive', 0)}/"
            f"{serving.get('replicas', 0)} alive, restarts "
            f"{serving.get('restarts')} (budget "
            f"{serving.get('restart_budget')}/replica)"
        )
    alarms = doc.get("active_alarms") or []
    lines.append("")
    if alarms:
        lines.append(f"fleet active alarms ({len(alarms)}):")
        lines.extend(_alarm_lines(alarms))
    else:
        lines.append("fleet active alarms: none")
    pms = doc.get("postmortems") or []
    if pms:
        lines.append("")
        lines.append("fleet postmortem bundles:")
        for row in pms:
            lines.append(
                f"  p{row.get('process')}: {row.get('total')} bundle(s)"
            )
            for b in row.get("recent", []):
                lines.append(
                    f"    {b.get('trigger')} @ step {b.get('step')}: "
                    f"{b.get('path')}"
                )
    for u in doc.get("unreachable") or []:
        lines.append(
            f"UNREACHABLE: p{u.get('process')} at {u.get('target')} "
            f"({u.get('error')})"
        )
    return "\n".join(lines)


def _fetch(url: str, timeout_s: float = 5.0):
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            return resp.status, resp.read().decode()
    except Exception as e:  # noqa: BLE001 — refused/timeout: try the
        # other endpoint family, then report
        return None, str(e)


def live_report(base: str) -> int:
    """Render from a RUNNING job: per-process /status + /metrics, or a
    supervisor fan-in's /fleet/status."""
    from mgwfbp_tpu_torch.telemetry.export import parse_metrics_text

    base = base.rstrip("/")
    if not base.startswith("http"):
        base = "http://" + base
    code, body = _fetch(base + "/status")
    if code == 200:
        status = json.loads(body)
        mcode, mtext = _fetch(base + "/metrics")
        values = parse_metrics_text(mtext) if mcode == 200 else {}
        print(format_live_report(status, values))
        return 0
    fcode, fbody = _fetch(base + "/fleet/status")
    if fcode == 200:
        print(format_fleet_report(json.loads(fbody)))
        return 0
    print(
        f"telemetry_report: no live endpoint at {base} "
        f"(/status: {code or body}; /fleet/status: {fcode or fbody})",
        file=sys.stderr,
    )
    return 2


def _synthetic_stream(path: str) -> None:
    """Write a small but complete stream: header, steps, an overlap
    snapshot with a known hidden/exposed split, and lifecycle events."""
    from mgwfbp_tpu_torch.telemetry import EventWriter, attribute_overlap

    w = EventWriter(path, run={"model": "selftest", "world": 8})
    tb = [0.010, 0.010, 0.010]
    groups = [(0, 1), (2,)]
    comm = [0.015, 0.010]
    nbytes = [1 << 20, 1 << 19]
    rows = attribute_overlap(groups, tb, comm, nbytes)
    step_s = 0.045
    for i in range(24):
        w.emit("step", step=i, epoch=0, start_s=i * step_s, dur_s=step_s)
    hidden = sum(r.hidden_s for r in rows)
    total = sum(r.comm_s for r in rows)
    w.emit(
        "overlap", step=23, epoch=0, step_s=step_s,
        tb_total_s=sum(tb), comm_s=total, hidden_s=hidden,
        exposed_s=total - hidden,
        efficiency=hidden / total, attribution="cost-model",
        timeline_end_s=max(sum(tb), max(r.start_s + r.comm_s for r in rows)),
    )
    for r in rows:
        w.emit(
            "comm_group", step=23, group=r.group, nbytes=r.nbytes,
            comm_s=r.comm_s, start_s=r.start_s, hidden_s=r.hidden_s,
            exposed_s=r.exposed_s, attribution="cost-model",
        )
    w.emit("resize", old_world=8, new_world=4,
           schedule_source="schedule-cache", num_groups=2)
    w.emit("checkpoint", epoch=0, iteration=24, mid_epoch=False)
    # async shard-native saves: one committed at the next
    # cadence step, one whose payload write overlapped three steps
    w.emit("checkpoint", epoch=0, iteration=8, mid_epoch=True,
           epoch_step=8, duration_s=0.030, bytes=1 << 20,
           format="sharded", commit_iteration=9, **{"async": True})
    w.emit("checkpoint", epoch=0, iteration=16, mid_epoch=True,
           epoch_step=16, duration_s=0.140, bytes=1 << 20,
           format="sharded", commit_iteration=19, **{"async": True})
    w.emit("drift_alarm", kind="comm_residual", step=20, residual=4.5,
           band=3.0, active=True, group=1)
    w.emit("drift_alarm", kind="comm_residual", step=23, residual=1.2,
           band=3.0, active=False, group=1)
    w.emit("straggler", step=22, slow_process=1, excess_s=0.013,
           step_s_max=0.058, step_s_min=0.045, active=True)
    # training-health stream + alarm + postmortem
    for i in range(24):
        w.emit(
            "health", step=i, epoch=0,
            loss=2.0 - 0.05 * i if i != 20 else 9.0,
            grad_norm=1.0 + (8.0 if i == 20 else 0.0),
            update_ratio=1e-3,
            group_norms=[0.8, 0.6],
            compression_error=[0.02, 0.03],
        )
    w.emit("health_alarm", kind="loss_spike", step=20, value=5.2,
           band=2.0, active=True, group=-1)
    w.emit("health_alarm", kind="loss_spike", step=22, value=1.1,
           band=2.0, active=False, group=-1)
    w.emit("postmortem", trigger="health_alarm", step=20,
           path="/tmp/run/postmortems/0000")
    # serving plane: hot-reloads, request stats, shadow evals
    w.emit("reload", step=8, lag_s=0.4, duration_s=0.05)
    w.emit("reload", step=16, lag_s=0.6, duration_s=0.04)
    w.emit("serve_stats", requests=10, queue_depth=1, batch_fill=0.5,
           latency_p50_s=0.02, latency_p95_s=0.04, latency_p99_s=0.05)
    w.emit("serve_stats", requests=24, queue_depth=0, batch_fill=0.75,
           latency_p50_s=0.018, latency_p95_s=0.035, latency_p99_s=0.04)
    w.emit("shadow_eval", step=8, loss=1.9, train_loss=1.8)
    w.emit("shadow_eval", step=16, loss=1.4, train_loss=1.35)
    # self-healing supervisor: a hard-failure verdict and the
    # healing action taken, as the supervisor's own stream records them
    w.emit("failure", **{"class": "oom_kill"}, target="p1", rc=-9,
           step=20)
    w.emit("heal", action="shrink", **{"class": "oom_kill"}, target="p1",
           old_world=2, world=1, restarts=1)
    w.emit("failure", **{"class": "wedged"}, target="p0,p1", step=21)
    w.emit("heal", action="relaunch", **{"class": "wedged"},
           target="p0,p1", world=2, restarts=1)
    w.close()


def selftest() -> int:
    """Writer -> reader -> report -> exports round trip on synthetic data."""
    from mgwfbp_tpu_torch.telemetry import read_events
    from mgwfbp_tpu_torch.telemetry.export import (
        write_chrome_trace, write_prometheus,
    )

    with tempfile.TemporaryDirectory(prefix="mgwfbp_tel_selftest_") as d:
        path = os.path.join(d, "telemetry.jsonl")
        _synthetic_stream(path)
        records = read_events(path)
        report = format_report(records)
        assert "overlap efficiency" in report, report
        assert "alarms:" in report and "straggler" in report, report
        # Training-health section, health alarm row, and the
        # postmortem index table all render from the same stream
        assert "training health (24 records)" in report, report
        assert "loss_spike" in report, report
        assert "postmortem bundles (1):" in report, report
        assert "/tmp/run/postmortems/0000" in report, report
        assert "gnorm_first" in report, report
        # The save-duration trend section renders, async saves
        # are marked in the lifecycle, and the save whose payload write
        # spanned >1 step is flagged with its commit iteration
        assert "checkpoint saves (2, 2 async):" in report, report
        assert "[async, +1 step(s) to commit]" in report, report
        assert (
            "save at iter 16 overlapped 3 steps (committed at iter 19)"
            in report
        ), report
        assert "save at iter 8 overlapped" not in report, report
        # The serving section renders latency quantiles, queue
        # depth trend, batch fill, reload lag, shadow-vs-training loss
        assert "serving:" in report, report
        assert "hot-reloads: 2 (step 8 -> 16)" in report, report
        assert "latency p50 0.018 s / p95 0.035 s / p99 0.04 s" in report
        assert "queue depth: first 1 -> last 0" in report, report
        assert "shadow eval: 2 scores" in report, report
        assert "vs training loss 1.35 (delta +0.05)" in report, report
        # Failure verdicts and healing actions render in the
        # lifecycle section
        assert "FAILURE [oom_kill] on p1 rc -9 at step 20" in report
        assert (
            "HEAL shrink [oom_kill] 2 -> 1 proc(s) (1 restart(s))"
            in report
        ), report
        assert "FAILURE [wedged] on p0,p1 at step 21" in report, report
        assert (
            "HEAL relaunch [wedged] at world 2 (1 restart(s))" in report
        ), report
        trace_path = os.path.join(d, "trace.json")
        doc = write_chrome_trace(trace_path, records)
        with open(trace_path) as f:
            loaded = json.load(f)
        assert loaded["traceEvents"] and doc["traceEvents"]
        prom = write_prometheus(os.path.join(d, "metrics.prom"), records)
        assert "mgwfbp_steps_total 24" in prom, prom
        assert "mgwfbp_overlap_efficiency" in prom
        # the file dump and the live /metrics endpoint share ONE registry
        # + aggregator; serving the replayed stream must render the very
        # same text (the two surfaces cannot diverge)
        from mgwfbp_tpu_torch.telemetry.export import render_metrics
        from mgwfbp_tpu_torch.telemetry.serve import MetricsAggregator

        agg = MetricsAggregator()
        agg.replay(records)
        assert render_metrics(agg.values()) == prom
        assert "mgwfbp_drift_alarms_total 1" in prom, prom
        assert "mgwfbp_health_alarms_total 1" in prom, prom
        assert "mgwfbp_postmortems_total 1" in prom, prom
        assert "mgwfbp_health_grad_norm" in prom, prom
        assert "mgwfbp_serve_reloads_total 2" in prom, prom
        assert "mgwfbp_shadow_evals_total 2" in prom, prom
        assert "mgwfbp_serve_step 16" in prom, prom
        assert "mgwfbp_serve_latency_p95_seconds 0.035" in prom, prom
        assert "mgwfbp_shadow_eval_delta 0.05" in prom, prom
        assert "mgwfbp_failures_total 2" in prom, prom
        assert "mgwfbp_heals_total 2" in prom, prom
        # --live round trip: serve the replayed aggregator over HTTP and
        # render the live report from /status + /metrics; then fan two
        # such children into a fleet view and render that
        from mgwfbp_tpu_torch.telemetry.export import parse_metrics_text
        from mgwfbp_tpu_torch.telemetry.fleet import FleetServer, scrape_fleet
        from mgwfbp_tpu_torch.telemetry.serve import TelemetryServer

        srv = TelemetryServer(agg, 0, host="127.0.0.1")
        fleet = FleetServer(
            lambda: {0: ("127.0.0.1", srv.port),
                     1: ("127.0.0.1", srv.port)},
            port=0,
            # the supervisor's heal/serving state flows through the
            # fan-in meta verbatim
            meta_provider=lambda: {
                "heal": {
                    "enabled": True, "restarts": {"oom_kill": 1},
                    "budget": 2, "liveness_grace_s": 120.0,
                },
                "serving": {
                    "replicas": 2, "alive": 1, "restarts": [0, 2],
                    "restart_budget": 3,
                },
            },
        )
        try:
            code, body = _fetch(f"http://127.0.0.1:{srv.port}/status")
            assert code == 200, body
            status = json.loads(body)
            code, mtext = _fetch(f"http://127.0.0.1:{srv.port}/metrics")
            assert code == 200 and parse_metrics_text(mtext), mtext
            live = format_live_report(status, parse_metrics_text(mtext))
            assert "steps: 24 recorded" in live, live
            # the --live view carries the same serving section, sourced
            # from /status's `serving` document
            assert "serving: step 16, 2 hot-reload(s)" in live, live
            assert "shadow eval (step 16)" in live, live
            # Failure/heal lifecycle counters in the live view
            assert "hard failures: 2" in live, live
            assert "heals: 2" in live, live
            children = scrape_fleet(
                {0: ("127.0.0.1", srv.port), 1: ("127.0.0.1", srv.port)}
            )
            assert all(c.reachable for c in children)
            code, fbody = _fetch(
                f"http://127.0.0.1:{fleet.port}/fleet/status"
            )
            assert code == 200, fbody
            fdoc = json.loads(fbody)
            assert {r["process"] for r in fdoc["straggler_table"]} == {
                0, 1,
            }, fdoc
            code, fmet = _fetch(
                f"http://127.0.0.1:{fleet.port}/fleet/metrics"
            )
            assert 'mgwfbp_steps_total{process="0"} 24' in fmet, fmet
            assert 'mgwfbp_steps_total{process="1"} 24' in fmet, fmet
            # The supervisor's heal + serve-replica state
            # renders in the fleet view
            freport = format_fleet_report(fdoc)
            assert "self-healing: enabled" in freport, freport
            assert "heals so far: oom_kill=1" in freport, freport
            assert (
                "serve replicas: 1/2 alive, restarts [0, 2] "
                "(budget 3/replica)" in freport
            ), freport
            print(format_fleet_report(fdoc))
            print()
        finally:
            fleet.close()
            srv.close()
        print(report)
        print()
        print(
            f"telemetry selftest OK: {len(records)} records, "
            f"{len(loaded['traceEvents'])} trace events"
        )
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="telemetry_report",
        description="Render a run's telemetry event stream: overlap table, "
        "step trend, lifecycle; optional Chrome-trace/Prometheus export",
    )
    p.add_argument("events", nargs="?",
                   help="telemetry JSONL path, or a run dir containing "
                   "telemetry.jsonl")
    p.add_argument("--chrome-trace", dest="chrome_trace", default=None,
                   help="write a chrome://tracing / Perfetto JSON here")
    p.add_argument("--prometheus", default=None,
                   help="write a Prometheus text-exposition dump here")
    p.add_argument("--live", default=None, metavar="URL",
                   help="render from a RUNNING job's /status + /metrics "
                        "(or a supervisor fan-in's /fleet/status) "
                        "instead of JSONL files, e.g. "
                        "http://127.0.0.1:9100")
    p.add_argument("--selftest", action="store_true",
                   help="run the synthetic end-to-end smoke and exit")
    args = p.parse_args(argv)

    if args.selftest:
        return selftest()
    if args.live:
        return live_report(args.live)
    if not args.events:
        p.error("events path required (or --selftest, or --live URL)")
    path = args.events
    if os.path.isdir(path):
        path = os.path.join(path, "telemetry.jsonl")

    # read_event_set handles size-rotated streams (telemetry.jsonl.0000,
    # .0001, ... + the active file) as one continuous timeline; a bare
    # un-rotated file reads identically
    from mgwfbp_tpu_torch.telemetry import read_event_set

    try:
        records = read_event_set(path)
    except FileNotFoundError:
        print(f"telemetry_report: no events file at {path}", file=sys.stderr)
        return 2
    print(format_report(records))
    if args.chrome_trace:
        from mgwfbp_tpu_torch.telemetry.export import write_chrome_trace

        doc = write_chrome_trace(args.chrome_trace, records)
        print(f"chrome trace: {args.chrome_trace} "
              f"({len(doc['traceEvents'])} events; open in Perfetto)")
    if args.prometheus:
        from mgwfbp_tpu_torch.telemetry.export import write_prometheus

        write_prometheus(args.prometheus, records)
        print(f"prometheus dump: {args.prometheus}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
