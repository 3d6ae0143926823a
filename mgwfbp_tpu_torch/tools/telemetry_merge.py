"""Merge a multi-host group's per-process telemetry streams into ONE
global timeline, plus a per-process overlap/straggler table.

The port's counterpart of the JAX package's ``tools/telemetry_merge.py``,
with its flags and output formats, on the port's stream readers.

Each process of a `MGWFBP_NUM_PROCESSES>1` run writes its own stream
(``telemetry.pN.jsonl``, process_index in the header's run metadata —
``mgwfbp_tpu_torch/telemetry/events.py`` `stream_filename`). Post-mortems need the GROUP
view: which host straggled, whether the agreed drain / resume really
covered every process, where the overlap efficiency diverged. This tool
reconstructs that view:

  * every record gets an absolute timestamp ``t`` — span records
    (``start_s`` relative to the stream's header wall anchor) re-anchor
    onto the header wall, everything else keeps its own emit wall — and
    a ``process`` tag; records from every stream merge time-sorted into
    one monotonic timeline. A supervisor-resubmitted run APPENDS to the
    same streams with the original anchor preserved (events.EventWriter),
    so both incarnations land on one continuous axis.
  * the straggler table compares per-process step spans at the same
    global step: a process whose spans consistently exceed the group
    minimum is the straggler the MG-WFBP schedule is stalling on.

Usage:
    python -m mgwfbp_tpu_torch.tools.telemetry_merge <run-dir>   # report
    python -m mgwfbp_tpu_torch.tools.telemetry_merge <run-dir> \
        --out merged.jsonl
    python -m mgwfbp_tpu_torch.tools.telemetry_merge \
        logs/a/telemetry.p0.jsonl logs/a/telemetry.p1.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from mgwfbp_tpu_torch.telemetry import (
    events_of,
    find_stream_paths,
    read_event_set,
)


def load_stream(path: str) -> tuple[dict, list[dict]]:
    """(header, records) of one per-process stream (rotation-aware)."""
    records = read_event_set(path)
    if not records or records[0].get("event") != "header":
        raise ValueError(f"{path}: not a telemetry stream (no header)")
    return records[0], records


# default slack for wall-clock steps (NTP) and for a span's re-anchored
# start trailing its emit wall; beyond this the stream is treated as
# corrupt. Long runs that crossed a real clock step (NTP slew, VM
# suspend/resume) can raise it via --clock-slack / slack_s.
_CLOCK_SLACK_S = 1.0


def _validate_stream(
    path: str, anchor: float, records: list[dict],
    slack_s: float = _CLOCK_SLACK_S,
) -> None:
    """The per-stream consistency the global timeline rests on, checked
    BEFORE the merge sort can paper over it: emit walls never go
    backwards across appends/rotation (a resubmitted incarnation extends
    the stream in real time), and every span's re-anchored absolute
    start precedes its own emit wall (a span that 'starts' after it was
    written means the writer lost the set's original anchor)."""
    last_wall = None
    for i, rec in enumerate(records):
        wall = float(rec.get("wall", anchor))
        if last_wall is not None and wall < last_wall - slack_s:
            raise ValueError(
                f"{path}: record {i} wall clock jumps backwards "
                f"({last_wall:.3f} -> {wall:.3f}); segments mis-ordered "
                "or stream corrupt"
            )
        last_wall = wall
        if "start_s" in rec:
            t = anchor + float(rec["start_s"])
            if t > wall + slack_s:
                raise ValueError(
                    f"{path}: record {i} span starts {t - wall:.3f}s "
                    "after its own emit wall — the writer re-anchored "
                    "mid-run and the incarnations no longer share one "
                    "time axis"
                )


def merge_streams(
    paths: list[str], *, slack_s: float = _CLOCK_SLACK_S,
) -> list[dict]:
    """One time-sorted global record list; each record carries ``t``
    (absolute seconds) and ``process`` (stream's process_index). Raises
    ValueError when any input stream is internally inconsistent
    (`_validate_stream`) — a sorted output is only meaningful if the
    per-stream timelines were sane going in."""
    if not paths:
        raise ValueError("no telemetry streams to merge")
    merged: list[dict] = []
    for path in paths:
        header, records = load_stream(path)
        anchor = float(header.get("wall", 0.0))
        run = header.get("run") or {}
        proc = int(run.get("process_index", 0))
        _validate_stream(path, anchor, records, slack_s)
        for rec in records:
            if "start_s" in rec:
                t = anchor + float(rec["start_s"])
            else:
                t = float(rec.get("wall", anchor))
            merged.append({**rec, "process": proc, "t": round(t, 6)})
    merged.sort(key=lambda r: (r["t"], r.get("process", 0)))
    return merged


def straggler_table(merged: list[dict]) -> list[dict]:
    """Per-process step/overlap summary over the merged timeline.

    ``mean_excess_s`` is the per-step span minus the fastest process's
    span at the SAME global step, averaged — the group-synchronous cost
    this process adds. Steps seen by only one process (single-host
    segments) contribute zero excess.
    """
    by_step: dict[tuple, dict[int, float]] = {}
    per_proc: dict[int, dict] = {}
    for rec in events_of(merged, "step"):
        p = int(rec["process"])
        d = per_proc.setdefault(
            p, {"steps": 0, "dur_sum": 0.0, "dur_max": 0.0,
                "excess_sum": 0.0, "efficiency": None},
        )
        d["steps"] += 1
        dur = float(rec["dur_s"])
        d["dur_sum"] += dur
        d["dur_max"] = max(d["dur_max"], dur)
        by_step.setdefault(int(rec["step"]), {})[p] = dur
    for durs in by_step.values():
        if len(durs) < 2:
            continue
        fastest = min(durs.values())
        for p, dur in durs.items():
            per_proc[p]["excess_sum"] += dur - fastest
    for rec in events_of(merged, "overlap"):
        p = int(rec["process"])
        if p in per_proc:
            per_proc[p]["efficiency"] = float(rec["efficiency"])
    rows = []
    for p in sorted(per_proc):
        d = per_proc[p]
        n = max(d["steps"], 1)
        rows.append({
            "process": p,
            "steps": d["steps"],
            "mean_step_s": d["dur_sum"] / n,
            "max_step_s": d["dur_max"],
            "mean_excess_s": d["excess_sum"] / n,
            "overlap_efficiency": d["efficiency"],
        })
    return rows


def check_monotonic(merged: list[dict]) -> None:
    """Output-format guarantee of `merge_streams` (which also validated
    each INPUT stream's internal consistency — the non-trivial half)."""
    last = None
    for rec in merged:
        if last is not None and rec["t"] < last:
            raise AssertionError(
                f"merged timeline not monotonic at t={rec['t']}"
            )
        last = rec["t"]


def render_report(merged: list[dict], paths: list[str]) -> str:
    lines = []
    t0, t1 = merged[0]["t"], merged[-1]["t"]
    procs = sorted({r["process"] for r in merged})
    resumes = events_of(merged, "resume")
    preempts = events_of(merged, "preempt")
    lines.append(
        f"merged {len(merged)} records from {len(paths)} stream(s), "
        f"{len(procs)} process(es), span {t1 - t0:.1f}s"
    )
    if preempts or resumes:
        # every process emits its own preempt/resume rows; incarnations
        # are a GROUP property, so count one process's restarts
        per_proc = max(
            (sum(1 for r in resumes if r["process"] == p) for p in procs),
            default=0,
        )
        lines.append(
            f"lifecycle: {len(preempts)} preempt row(s), {len(resumes)} "
            f"resume row(s) — {per_proc + 1} incarnation(s) on one "
            "timeline"
        )
    rows = straggler_table(merged)
    if rows:
        lines.append("")
        lines.append(
            f"{'proc':>4}  {'steps':>6}  {'mean step':>10}  "
            f"{'max step':>10}  {'straggle':>10}  {'overlap eff':>11}"
        )
        for r in rows:
            eff = (
                f"{r['overlap_efficiency']:.3f}"
                if r["overlap_efficiency"] is not None else "-"
            )
            lines.append(
                f"{r['process']:>4}  {r['steps']:>6}  "
                f"{r['mean_step_s']:>10.4g}  {r['max_step_s']:>10.4g}  "
                f"{r['mean_excess_s']:>10.4g}  {eff:>11}"
            )
    return "\n".join(lines)


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="+",
                    help="stream files, or one directory holding "
                         "telemetry[.pN].jsonl streams")
    ap.add_argument("--clock-slack", type=float, default=_CLOCK_SLACK_S,
                    metavar="SECONDS",
                    help="wall-clock tolerance for the stream-consistency "
                         "checks (default %(default)ss); raise for runs "
                         "that crossed an NTP step or VM suspend")
    ap.add_argument("--out", default=None,
                    help="write the merged timeline as JSONL here "
                         "(report still prints)")
    args = ap.parse_args(argv)
    paths = list(args.paths)
    if len(paths) == 1 and os.path.isdir(paths[0]):
        paths = find_stream_paths(paths[0])
        if not paths:
            print(f"no telemetry streams under {args.paths[0]}",
                  file=sys.stderr)
            return 2
    merged = merge_streams(paths, slack_s=args.clock_slack)
    check_monotonic(merged)
    if args.out:
        with open(args.out, "w") as f:
            for rec in merged:
                f.write(json.dumps(rec) + "\n")
    print(render_report(merged, paths))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
