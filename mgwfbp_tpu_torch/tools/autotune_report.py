"""Autotune cache-entry report: solved vs measured group times + refit deltas.

The port's counterpart of the JAX package's ``tools/autotune_report.py``,
with its output format. Reads one committed schedule-cache entry (written
by the closed-loop autotuner, ``mgwfbp_tpu_torch/parallel/autotune.py``)
and prints:

  * the committed winner (label, comm_op, groups, measured step time);
  * the race table — every candidate that was verified/raced, with its
    predicted and measured step times;
  * per-group solved-vs-measured times (measured column present only when
    the backend's profiler trace attributed group scopes — on the CPU mesh
    the refit runs from step-time deltas and the column reads n/a);
  * the cost-model refit: alpha/beta/gamma/update_beta before -> after.

Usage:
  python -m mgwfbp_tpu_torch.tools.autotune_report \
      profiles/schedule_cache/<key>.json
"""

from __future__ import annotations

import argparse
import sys


def _fmt_s(v) -> str:
    return f"{v:.6g}" if isinstance(v, (int, float)) and v is not None else "n/a"


def _delta_pct(before, after) -> str:
    try:
        if before:
            return f"{(after - before) / before * 100.0:+.1f}%"
    except TypeError:
        pass
    return "n/a"


def format_report(entry: dict) -> str:
    lines: list[str] = []
    key = entry.get("key", "?")
    lines.append(
        f"autotune cache entry: {key} "
        f"(model={entry.get('model')}, world={entry.get('world')}, "
        f"comm_op={entry.get('comm_op')}, dtype={entry.get('dtype')})"
    )
    cross = " [cross-step]" if entry.get("comm_op") == "rs_fwd_ag" else ""
    lines.append(
        f"committed winner: {entry.get('winner')}{cross} — "
        f"{len(entry.get('groups', []))} group(s), "
        f"measured {_fmt_s(entry.get('measured_step_s'))} s/step"
    )

    lines.append("")
    lines.append("race:")
    lines.append(
        f"  {'label':<40} {'groups':>6} {'verified':>8} "
        f"{'predicted_s':>12} {'measured_s':>12}"
    )
    for r in entry.get("race", []):
        label = r.get("label", "?")
        if r.get("comm_op") == "rs_fwd_ag":
            # cross-step candidate: its AG legs ride the NEXT step's
            # forward (one-step deferred gathers), priced by the
            # two-phase simulate
            label += " [cross-step]"
        lines.append(
            f"  {label:<40} {r.get('num_groups', 0):>6} "
            f"{str(r.get('verified', False)):>8} "
            f"{_fmt_s(r.get('predicted_total_s')):>12} "
            f"{_fmt_s(r.get('measured_step_s')):>12}"
        )

    solved = entry.get("solved_group_times") or []
    measured = entry.get("measured_group_times")
    lines.append("")
    lines.append("group times (committed schedule):")
    lines.append(
        f"  {'group':>5} {'bytes':>12} {'solved_s':>12} {'measured_s':>12}"
    )
    for gi, (nbytes, pred) in enumerate(solved):
        m = measured[gi] if measured and gi < len(measured) else None
        lines.append(
            f"  {gi:>5} {int(nbytes):>12} {_fmt_s(pred):>12} {_fmt_s(m):>12}"
        )
    if not measured:
        lines.append(
            "  (no per-group trace attribution on this backend; "
            "refit used step-time deltas)"
        )

    refit = entry.get("refit")
    lines.append("")
    if refit:
        before, after = refit.get("before", {}), refit.get("after", {})
        lines.append(f"cost-model refit (observations: {refit.get('source')}):")
        for k in ("alpha", "beta", "gamma", "pack_beta", "update_beta"):
            b, a = before.get(k), after.get(k)
            lines.append(
                f"  {k:<12} {_fmt_s(b):>12} -> {_fmt_s(a):>12}  "
                f"{_delta_pct(b, a)}"
            )
    else:
        lines.append("cost-model refit: none recorded")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="autotune_report",
        description="print solved-vs-measured group times and refit deltas "
        "from an autotune schedule-cache entry",
    )
    p.add_argument("entry", help="path to a schedule_cache/<key>.json entry")
    args = p.parse_args(argv)
    # the canonical reader: same schema validation as the autotuner itself
    from mgwfbp_tpu_torch.parallel.autotune import load_cache_entry

    try:
        entry = load_cache_entry(args.entry)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    if entry is None:
        print(f"{args.entry}: no such cache entry", file=sys.stderr)
        return 1
    print(format_report(entry))
    return 0


if __name__ == "__main__":
    sys.exit(main())
