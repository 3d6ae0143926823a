"""Policy A/B grid on the running world (the counterpart of the JAX
package's ``tools/policy_grid.py``): sec/iter of {mgwfbp, auto, wfbp,
single, none} for one model, the reference's core experimental method
(batch_dist_mpi.sh thresholds x models; settings.py:34 oracle swap), as one
JSON artifact.

    python -m mgwfbp_tpu_torch.tools.policy_grid --model resnet20 --batch 8 \\
        [--comm-profile p.json] [--thresholds 1000000] [--out grid.json]

Protocol (the JAX tool's): every policy's step is built and warmed FIRST,
each on its own model from the same initial weights (the bench's
``_Grid``), all solved from ONE backward profile; then the steps are timed
round-robin in ``--rounds`` interleaved windows, each step read back (a
host synchronisation per iteration, as the JAX tool's), and each policy
keeps its best and its median window. ``single#control`` is a second,
independently built ``single``: the two run the identical program, so
their paired per-round deltas measure the protocol's own noise, the
yardstick every policy-vs-policy delta must clear (3 x its median
|delta|). A one-sided sign test counts the rounds a row lost to the
fastest.

Several processes (one per card) come from the launch environment, as
``runtime.supervise --processes N`` starts a group
(``MGWFBP_COORDINATOR``/``MGWFBP_NUM_PROCESSES``/``MGWFBP_PROCESS_ID``,
``parallel.mesh.init_distributed``); every rank runs every window, each
window's seconds are the slowest rank's, and rank 0 writes. Every policy's
model, optimizer and reducer stay resident on the card for the whole run.
"""

from __future__ import annotations

import argparse
import statistics as _st
import sys
import time

POLICIES = ("mgwfbp", "auto", "wfbp", "single", "none")


def _binom_tail_p(k: int, n: int) -> float:
    """One-sided sign-test p-value: P(X >= k) for X ~ Binomial(n, 0.5)."""
    from math import comb

    return sum(comb(n, i) for i in range(k, n + 1)) * 0.5 ** n


def _finite_or_none(v):
    return v if v is not None and v == v else None  # NaN is not a number


def schedule_fields(reducer) -> dict:
    """A row's schedule fields: merge groups, predictions, the auto detail."""
    if reducer is None:
        return {"merge_groups": 0, "predicted_nonoverlap_s": None,
                "predicted_total_s": None}
    s = reducer.schedule
    return {
        "merge_groups": s.num_groups,
        "predicted_nonoverlap_s": _finite_or_none(
            s.predicted_nonoverlap_time),
        "predicted_total_s": _finite_or_none(s.predicted_total_time),
        **({"policy_detail": s.policy_detail} if s.policy_detail else {}),
    }


def verdicts(windows: dict, results: dict, policies) -> dict:
    """The JAX tool's statistics over each policy's per-round windows
    (seconds): the prediction check against wfbp, the noise pair, the
    paired deltas against the fastest, the sign test and the conclusion."""
    base = "wfbp"
    scheduled = [p for p in policies
                 if results[p].get("predicted_total_s") is not None]
    prediction_check = None
    if base in scheduled:
        # the solver predicts bwd+comm, not the full step, so compare the
        # INTER-POLICY deltas, predicted against measured
        prediction_check = {}
        for p in scheduled:
            if p == base:
                continue
            pred_d = (results[p]["predicted_total_s"]
                      - results[base]["predicted_total_s"])
            meas_d = (results[p]["sec_per_iter"]
                      - results[base]["sec_per_iter"])
            prediction_check[f"{p}-vs-{base}"] = {
                "predicted_delta_s": round(pred_d, 6),
                "measured_delta_s": round(meas_d, 6),
                "gap_fraction_of_step": round(
                    abs(pred_d - meas_d) / results[base]["sec_per_iter"], 4),
            }
    med = {p: _st.median(windows[p]) for p in policies}
    noise = None
    if "single#control" in windows and "single" in windows:
        nd = [a - b for a, b in zip(windows["single"],
                                    windows["single#control"])]
        med_abs = _st.median([abs(d) for d in nd])
        # a single stalled round can blow the max |delta| up; the bound a
        # MEDIAN paired delta must clear is 3x the pair's median |delta|
        bound = 3.0 * med_abs
        noise = {
            "pair": ["single", "single#control"],
            "per_round_delta_s": [round(d, 6) for d in nd],
            "median_abs_delta_s": round(med_abs, 6),
            "max_abs_delta_s": round(max(abs(d) for d in nd), 6),
            "bound_s": round(bound, 6),
            "bound_rule": ("3 * median |noise delta| (robust to stalled "
                           "rounds)"),
            "bound_frac_of_step": round(
                bound / min(med["single"], med["single#control"]), 4),
        }
    # the '#'-tagged control is the noise yardstick, never the winner
    real = [p for p in policies if "#" not in p]
    best = min(real, key=lambda p: med[p])
    comparisons, beats, ties = {}, [], []
    for p in policies:
        if p == best:
            continue
        # deltas are rounded FIRST and every verdict field derives from
        # the rounded values, so a reader of the artifact can recompute them
        dl = [round(a - b, 6) for a, b in zip(windows[p], windows[best])]
        md = _st.median(dl)
        entry = {
            "per_round_delta_s": dl,
            "median_delta_s": round(md, 6),
            "median_delta_frac_of_step": round(md / med[best], 4),
            "slower_in_every_round": all(d > 0 for d in dl),
            "sign_test_p": round(_binom_tail_p(
                sum(1 for d in dl if d > 0), len(dl)), 4),
        }
        if noise is not None:
            outside = abs(md) > noise["bound_s"]
            entry["outside_noise"] = outside
            (beats if outside else ties).append(p)
        comparisons[f"{p}-vs-{best}"] = entry
    conclusion = {"fastest_by_median": best,
                  "fastest_median_sec_per_iter": round(med[best], 6)}
    if noise is not None:
        conclusion["beats_outside_noise"] = beats
        conclusion["ties_within_noise"] = ties
        conclusion["consistent_losers_sign_test"] = [
            p for p in real if p != best
            and comparisons[f"{p}-vs-{best}"]["slower_in_every_round"]]
        conclusion["note"] = (
            f"'{best}' is fastest by median-of-rounds; rows in "
            "ties_within_noise are statistically indistinguishable from it "
            "(their median paired delta is inside 3x the identical-program "
            "noise pair's median |delta|). consistent_losers_sign_test "
            "lists rows slower than the winner in EVERY round (one-sided "
            "p = 0.5**rounds).")
    out = {**({"noise_pair": noise} if noise is not None else {}),
           "paired_deltas_vs_fastest": comparisons,
           "conclusion": conclusion}
    if prediction_check:
        out["prediction_check_vs_wfbp"] = prediction_check
    return out


def run_grid(model_name, batch, nsteps, comm_profile, iters, warmup,
             rounds=5, policies=POLICIES, noise_control=True,
             device="cuda") -> dict:
    """Interleaved A/B (module docstring); every rank calls it."""
    from mgwfbp_tpu_torch.bench import _Grid, random_batch
    from mgwfbp_tpu_torch.parallel.mesh import world_size
    from mgwfbp_tpu_torch.profiling import _agree_max
    from mgwfbp_tpu_torch.profiling import _sync as sync
    from mgwfbp_tpu_torch.tools.overlap_report import (
        cost_model_for,
        measure_tb,
    )
    from mgwfbp_tpu_torch.utils.device import device_kind

    world = world_size()
    cost = cost_model_for(comm_profile, world)
    if noise_control and "single" in policies:
        policies = tuple(policies) + ("single#control",)
    runs = {}
    tb = None
    for policy in policies:
        # "<policy>#<tag>" rows are independently built duplicates
        grid = _Grid(model_name, batch, iters, device, None, cost)
        if tb is None:
            # one backward profile feeds every policy's solve
            tb = measure_tb(grid.model, grid.meta, batch, device)
        step, reducer = grid.build_step(policy.split("#", 1)[0], tb)
        x, y = random_batch(grid.meta, nsteps, batch, device)
        for _ in range(max(warmup, 1)):
            m = step(x, y)
        float(m["loss"])
        runs[policy] = {"step": step, "x": x, "y": y, "reducer": reducer,
                        "grid": grid, "windows": []}
    per_window = max(iters // rounds, 1)
    for _ in range(rounds):
        for policy in policies:
            r = runs[policy]
            sync(device)
            t0 = time.perf_counter()
            for _ in range(per_window):
                float(r["step"](r["x"], r["y"])["loss"])  # a sync per iter
            r["windows"].append((time.perf_counter() - t0) / per_window)
    # a window lasts as long as its slowest rank
    flat = _agree_max([w for p in policies for w in runs[p]["windows"]],
                      None, device)
    windows = {p: flat[i * rounds:(i + 1) * rounds]
               for i, p in enumerate(policies)}
    global_batch = batch * world
    results = {}
    for policy in policies:
        w = windows[policy]
        dt = min(w)
        results[policy] = {
            "sec_per_iter": round(dt, 6),
            "median_sec_per_iter": round(_st.median(w), 6),
            "window_secs": [round(v, 6) for v in w],
            "samples_per_sec": round(global_batch / dt, 2),
            **schedule_fields(runs[policy]["reducer"]),
        }
    groups = {p: [list(g) for g in r["reducer"].schedule.groups]
              for p, r in runs.items() if r["reducer"] is not None}
    for r in runs.values():
        if r["reducer"] is not None:
            r["reducer"].detach()
        r["grid"].close()
    return {
        "model": model_name,
        "batch_per_device": batch,
        "nsteps_update": nsteps,
        "iters": iters,
        "rounds": rounds,
        "protocol": (
            "interleaved round-robin; per-policy min and median of rounds; "
            "paired per-round deltas vs identical-program noise pair; each "
            "window the slowest rank's"
        ),
        "comm_profile": comm_profile,
        "n_devices": world,
        "device_kind": device_kind(device),
        "global_batch": global_batch,
        "tb_s": list(tb),
        "policies": results,
        "groups": groups,
        **verdicts(windows, results, policies),
    }


def main(argv=None) -> int:
    from mgwfbp_tpu_torch.tools.overlap_report import (
        add_device_flag,
        run_tool,
        write_report,
    )

    ap = argparse.ArgumentParser(
        prog="python -m mgwfbp_tpu_torch.tools.policy_grid",
        description="the merge-policy A/B grid, interleaved")
    ap.add_argument("--model", default="resnet20")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--nsteps", type=int, default=1)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--comm-profile", dest="comm_profile", default=None)
    ap.add_argument("--thresholds", default=None,
                    help="comma list of element-count thresholds, each run "
                         "as an extra 'threshold:N' row beside the default "
                         "policy set")
    ap.add_argument("--note", default=None,
                    help="environment context recorded into the artifact")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--no-noise-control", dest="noise_control",
                    action="store_false",
                    help="skip the duplicate single#control row")
    ap.add_argument("--out", default=None)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    policies = POLICIES
    if args.thresholds:
        policies = tuple(f"threshold:{int(t)}"
                         for t in args.thresholds.split(",")) + POLICIES

    def body(device, rank):
        report = run_grid(args.model, args.batch, args.nsteps,
                          args.comm_profile, args.iters, args.warmup,
                          rounds=args.rounds, policies=policies,
                          noise_control=args.noise_control, device=device)
        if args.note:
            report["environment_note"] = args.note
        if rank == 0:
            write_report(report, args.out)

    run_tool(body, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
