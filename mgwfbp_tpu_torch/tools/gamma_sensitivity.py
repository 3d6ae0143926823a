"""Gamma sensitivity of the auto-policy argmin (the counterpart of the JAX
package's ``tools/gamma_sensitivity.py``).

gamma (the per-collective pack and dispatch overhead) is the worst
calibrated term of the cost model, and it both gates the scan's merge rule
and scales with the group count in every simulation. For each model this
tool re-runs the auto argmin (``parallel.solver.auto_groups``) with gamma
scaled x{0.7, 1.0, 1.3} and reports whether the chosen schedule flips, and
what a flip costs under the unscaled model (``simulate_groups``). A flip
with near-zero regret is a plateau (two schedules within noise of each
other); a flip with material regret would mean gamma's calibration limits
auto's wins.

    python -m mgwfbp_tpu_torch.tools.gamma_sensitivity \\
        --models resnet20,resnet56,vgg16 --comm-profile p.json [--out g.json]

tb is measured on the card by the gradient hooks
(``overlap_report.measure_tb``); ``--comm-profile`` is a profile the card
calibrated (``python -m mgwfbp_tpu_torch.calibrate --out p.json``),
resolved at the world's size (at least 2). Rank 0 writes.
"""

from __future__ import annotations

import argparse
import sys

SCALES = (0.7, 1.0, 1.3)


def sensitivity(layers, tb, cost, scales=SCALES) -> dict:
    """The JAX tool's per-scale rows, flips and worst regret for one model's
    arrival-order layers, tb and cost model."""
    from mgwfbp_tpu_torch.parallel.solver import auto_groups, simulate_groups

    sizes = [lay.size for lay in layers]
    itemsizes = [lay.itemsize for lay in layers]
    nbytes = [lay.nbytes for lay in layers]
    gamma0 = float(getattr(cost, "gamma", 0.0))
    overlap = float(getattr(cost, "overlap", 1.0))
    pack_beta = float(getattr(cost, "pack_beta", 0.0))
    rows, choices = {}, {}
    for s in scales:
        g = gamma0 * s
        groups, detail = auto_groups(
            sizes, tb, alpha=cost.alpha, cost=cost.predict,
            itemsize=itemsizes, gamma=g, overlap=overlap,
            pack_beta=pack_beta,
        )
        # regret: how much worse this choice is than the unscaled-model
        # optimum, PRICED UNDER THE UNSCALED MODEL (if the true gamma is
        # gamma0 but we calibrated gamma0*s, we pick `groups` and pay this)
        t_at_nominal, _, _ = simulate_groups(
            groups, nbytes, tb, cost.predict, gamma0, overlap, pack_beta)
        rows[str(s)] = {
            "gamma": g,
            "chosen": detail,
            "num_groups": len(groups),
            "group_shape_hash": hash(tuple(map(tuple, groups))) & 0xFFFFFFFF,
            "time_under_nominal_gamma_s": round(t_at_nominal, 6),
        }
        choices[str(s)] = tuple(map(tuple, groups))
    t_opt = rows["1.0"]["time_under_nominal_gamma_s"]
    for r in rows.values():
        r["regret_vs_nominal_s"] = round(
            r["time_under_nominal_gamma_s"] - t_opt, 6)
        r["regret_frac"] = round(
            (r["time_under_nominal_gamma_s"] - t_opt) / max(t_opt, 1e-12), 5)
    return {
        "gamma_nominal": gamma0,
        "overlap": overlap,
        "pack_beta": pack_beta,
        "by_scale": rows,
        "schedule_flips_at": sorted(
            {s for s in map(str, scales) if choices[s] != choices["1.0"]}),
        "max_regret_frac": max(r["regret_frac"] for r in rows.values()),
        "_groups": {k: [list(g) for g in v] for k, v in choices.items()},
    }


def analyze_model(model_name, batch, comm_profile, scales=SCALES,
                  device="cuda") -> dict:
    from mgwfbp_tpu_torch.bench import make_model
    from mgwfbp_tpu_torch.parallel.mesh import world_size
    from mgwfbp_tpu_torch.tools import overlap_report

    model, meta = make_model(model_name, device)
    # looked up at call time, so a test can feed both packages one tb
    tb = overlap_report.measure_tb(model, meta, batch, device)
    n_dev = world_size()
    res = sensitivity(overlap_report.arrival_layers(model), list(tb),
                      overlap_report.cost_model_for(comm_profile, n_dev),
                      scales)
    groups = res.pop("_groups")
    return {
        "model": model_name,
        "batch_per_device": batch,
        "n_devices": n_dev,
        "gamma_nominal": res["gamma_nominal"],
        "overlap": res["overlap"],
        "pack_beta": res["pack_beta"],
        "tb_total_s": round(sum(tb), 6),
        "tb_source": getattr(tb, "source", None),
        "tb_s": list(tb),
        "by_scale": res["by_scale"],
        "schedule_flips_at": res["schedule_flips_at"],
        "max_regret_frac": res["max_regret_frac"],
        "groups_at_1.0": groups["1.0"],
    }


def main(argv=None) -> int:
    from mgwfbp_tpu_torch.tools.overlap_report import (
        add_device_flag,
        run_tool,
        write_report,
    )

    ap = argparse.ArgumentParser(
        prog="python -m mgwfbp_tpu_torch.tools.gamma_sensitivity",
        description="the auto argmin against gamma's calibration error")
    ap.add_argument("--models", default="resnet20,resnet56,vgg16")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--comm-profile", dest="comm_profile", required=True,
                    help="a profile the card calibrated (calibrate --out)")
    ap.add_argument("--out", default=None)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    models = [m.strip() for m in args.models.split(",") if m.strip()]

    def body(device, rank):
        per_model = {m: analyze_model(m, args.batch, args.comm_profile,
                                      device=device) for m in models}
        worst = max(r["max_regret_frac"] for r in per_model.values())
        report = {
            "what": (
                "auto-policy argmin re-run with gamma x{0.7,1.0,1.3}; a "
                "'flip' is a different chosen schedule, its regret is the "
                "extra time paid under the NOMINAL gamma"
            ),
            "scales": list(SCALES),
            "comm_profile": args.comm_profile,
            "models": per_model,
            "conclusion": {
                "max_regret_frac_any_model_any_scale": worst,
                "gamma_error_band_is_decision_safe": bool(worst < 0.02),
            },
        }
        if rank == 0:
            write_report(report, args.out)

    run_tool(body, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
