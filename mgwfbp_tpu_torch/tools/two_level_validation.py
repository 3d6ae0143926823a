"""Validate the two-level cost model against measurement (the counterpart
of the JAX package's ``tools/two_level_validation.py``), on a world split
into ``--dcn`` slices of ``--ici`` ranks (``parallel.mesh.
two_level_groups``).

  1. COMPOSITION: ``costmodel.TwoLevelAlphaBeta`` prices a bucket's
     hierarchical all-reduce as ici(full payload) + dcn(payload / ici).
     Each link is swept on its own (``profiling.profile_two_level``), then
     one bucket's hier collectives (a reduce-scatter over the slice, an
     all-reduce of the shard across slices, an all-gather over the slice:
     the hier lowering's per-bucket calls) and the flat all-reduce over the
     world are timed at every payload; each row holds the prediction gaps,
     raw and dispatch-corrected (the two standalone sweeps carry two
     dispatches where one hier bucket carries one; the correction
     subtracts a no-op's time, a one-kernel copy of the shard).
  2. SOLVED SCHEDULE: a dozen mixed-size layers solved by
     ``solver.auto_groups_two_level`` (nested inner and DCN partitions),
     lowered by the port's ``MergedAllreduce(comm_op='hier')`` from its
     gradient hooks and timed against the flat single-link solve under
     all_reduce, the race the autotuner runs live.

Where both levels share one fabric (the cards of one host, gloo through
host memory), the links differ only by group size and contention: the
check validates the model's composition and the solver's machinery, not a
slower link.

    python -m mgwfbp_tpu_torch.tools.two_level_validation --ici 2 --dcn 2 \\
        [--out two_level.json]

Needs ``--ici`` x ``--dcn`` processes from the launch environment
(``MGWFBP_COORDINATOR``/``MGWFBP_NUM_PROCESSES``/``MGWFBP_PROCESS_ID``);
rank 0 writes ``--out`` as a two-level profile (``save_profile``) whose
meta is the report.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

SOLVED_LAYERS = 12
SOLVED_SIZES = (1 << 14, 1 << 16, 1 << 18)


def composition(nbytes, t_ici, t_dcn, t_noop, t_hier, t_flat, model_sampled,
                ici: int, dcn: int) -> dict:
    """The composition check's rows and summaries from per-payload timings
    (dicts keyed by payload bytes) and the per-link sampled model (the JAX
    tool's arithmetic)."""
    from mgwfbp_tpu_torch.parallel.costmodel import (
        SampledCost,
        TwoLevelAlphaBeta,
        fit_alpha_beta,
    )

    model = TwoLevelAlphaBeta(ici=model_sampled.ici.ab,
                              dcn=model_sampled.dcn.ab, ici_size=ici,
                              dcn_size=dcn)
    sc_id = SampledCost(
        tuple(nbytes), tuple(t_noop[b] for b in nbytes),
        ab=fit_alpha_beta(nbytes, [t_noop[b] for b in nbytes]))
    rows, gaps_ab, gaps_sc, gaps_corr = [], [], [], []
    for b in nbytes:
        pred_ab = model.predict(b)
        pred_sc = model_sampled.predict(b)
        pred_corr = pred_sc - sc_id.predict(b / max(ici, 1))
        meas = t_hier[b]
        gap_ab = (pred_ab - meas) / meas
        gap_sc = (pred_sc - meas) / meas
        gap_corr = (pred_corr - meas) / meas
        gaps_ab.append(abs(gap_ab))
        gaps_sc.append(abs(gap_sc))
        gaps_corr.append(abs(gap_corr))
        rows.append({
            "payload_bytes": b,
            "measured_ici_only_s": round(t_ici[b], 6),
            "measured_dcn_only_s": round(t_dcn[b], 6),
            "measured_noop_s": round(t_noop[b], 6),
            "measured_hier_s": round(meas, 6),
            "measured_flat_s": round(t_flat[b], 6),
            "predicted_hier_ab_fit_s": round(pred_ab, 6),
            "predicted_hier_sampled_s": round(pred_sc, 6),
            "predicted_hier_dispatch_corrected_s": round(pred_corr, 6),
            "prediction_gap_ab_fit_frac": round(gap_ab, 4),
            "prediction_gap_sampled_frac": round(gap_sc, 4),
            "prediction_gap_corrected_frac": round(gap_corr, 4),
            "hier_vs_flat": round(meas / t_flat[b], 4),
        })
    return {
        "rows": rows,
        "median_abs_gap_sampled_frac": round(float(np.median(gaps_sc)), 4),
        "max_abs_gap_sampled_frac": round(float(np.max(gaps_sc)), 4),
        "median_abs_gap_corrected_frac": round(
            float(np.median(gaps_corr)), 4),
        "max_abs_gap_corrected_frac": round(float(np.max(gaps_corr)), 4),
        "median_abs_gap_ab_fit_frac": round(float(np.median(gaps_ab)), 4),
        "median_hier_vs_flat": round(
            float(np.median([r["hier_vs_flat"] for r in rows])), 4),
    }


def _time(fn, warmup: int, iters: int, device) -> float:
    """Seconds per call of ``fn`` (each call synchronised), agreed to the
    world's slowest rank by the caller."""
    from mgwfbp_tpu_torch.profiling import _sync as sync

    for _ in range(warmup):
        fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        sync(device)
    return (time.perf_counter() - t0) / max(iters, 1)


def hier_bucket(x, levels):
    """One bucket's hier collectives, the mean over the world: reduce-scatter
    over the slice, all-reduce of the shard across slices, all-gather over
    the slice (``x`` padded to a multiple of ``levels.ici``)."""
    import torch
    import torch.distributed as dist

    shard = torch.empty(x.numel() // levels.ici, dtype=x.dtype,
                        device=x.device)
    dist.reduce_scatter_tensor(shard, x, group=levels.inner)
    dist.all_reduce(shard, group=levels.outer)
    shard.div_(levels.ici * levels.dcn)
    dist.all_gather_into_tensor(x, shard, group=levels.inner)
    return x


def solved_layers():
    """(tree-order sizes, names) of the synthetic model: the JAX tool's
    draw, its leaves named as the JAX tree's."""
    rs = np.random.RandomState(0)
    sizes = [int(s) for s in rs.choice(SOLVED_SIZES, size=SOLVED_LAYERS)]
    return sizes, [f"['layer{i:02d}']['w']" for i in range(len(sizes))]


def _solved_schedule_check(model, levels, warmup, iters, device) -> dict:
    """The solved nested hier schedule raced against the flat single-link
    solve, both lowered by the port's reducer from its gradient hooks."""
    import torch

    from mgwfbp_tpu_torch.parallel.allreduce import (
        MergedAllreduce,
        arrival_order,
    )
    from mgwfbp_tpu_torch.parallel.buckets import build_layout
    from mgwfbp_tpu_torch.parallel.solver import (
        LayerSpec,
        auto_groups,
        build_schedule,
        simulate_groups,
        simulate_groups_two_level,
        singleton_dcn_groups,
        two_level_leg_costs,
    )
    from mgwfbp_tpu_torch.profiling import _agree_max

    tree_sizes, names = solved_layers()
    perm = arrival_order(len(names), names=names)
    sizes = [tree_sizes[j] for j in perm]  # arrival order, as the solver's
    tb_total = model.predict(float(sum(sizes)) * 4)
    tb = [tb_total * s / sum(sizes) for s in sizes]
    nbytes = [s * 4 for s in sizes]
    specs = [LayerSpec(names[j], tree_sizes[j], 4) for j in perm]
    hier = build_schedule(specs, tb, policy="auto", cost_model=model,
                          comm_op="hier")
    flat_groups, flat_detail = auto_groups(sizes, tb, alpha=model.alpha,
                                           cost=model.predict)
    flat = build_schedule(specs, tb, policy="auto", cost_model=model,
                          groups=flat_groups, policy_detail=flat_detail)

    def reducer(schedule, comm_op):
        gen = torch.Generator().manual_seed(0)
        params = [torch.randn(n, generator=gen).to(device).requires_grad_()
                  for n in tree_sizes]
        arr = [params[j] for j in perm]
        red = MergedAllreduce(
            schedule, build_layout(arr, schedule.groups), perm, params,
            comm_op=comm_op, levels=levels if comm_op == "hier" else None,
        ).attach()

        def step():
            for p in params:
                p.grad = None
            red.begin()
            sum(p.sum() for p in params).backward()
            red.synchronize()
        return red, step

    times = {}
    for name, schedule, op in (("hier", hier, "hier"),
                               ("flat", flat, "all_reduce")):
        red, step = reducer(schedule, op)
        times[name] = _time(step, warmup, iters, device)
        red.detach()
    t_hier, t_flat = _agree_max([times["hier"], times["flat"]], None, device)
    rs_c, dcn_c, ag_c = two_level_leg_costs(model)
    pred_hier, _, _ = simulate_groups_two_level(
        hier.groups, hier.dcn_groups, nbytes, tb, rs_c, dcn_c, ag_c)
    pred_flat, _, _ = simulate_groups(flat.groups, nbytes, tb, model.predict)
    pred_single, _, _ = simulate_groups_two_level(
        hier.groups, singleton_dcn_groups(len(hier.groups)), nbytes, tb,
        rs_c, dcn_c, ag_c)
    return {
        "layer_sizes": tree_sizes,
        "hier": {
            "detail": hier.policy_detail,
            "groups": [list(g) for g in hier.groups],
            "dcn_groups": [list(d) for d in hier.dcn_groups],
            "predicted_s": round(float(pred_hier), 6),
            "predicted_singleton_dcn_s": round(float(pred_single), 6),
            "measured_s": round(t_hier, 6),
        },
        "flat": {
            "detail": flat_detail,
            "groups": [list(g) for g in flat.groups],
            "predicted_s": round(float(pred_flat), 6),
            "measured_s": round(t_flat, 6),
        },
        "solved_hier_vs_flat_measured": round(t_hier / t_flat, 4),
        "solved_hier_vs_flat_predicted": round(
            float(pred_hier) / float(pred_flat), 4),
    }


def run(ici, dcn, min_log2, max_log2, warmup, iters, device="cuda"):
    import torch
    import torch.distributed as dist

    from mgwfbp_tpu_torch.parallel.mesh import two_level_groups, world_size
    from mgwfbp_tpu_torch.profiling import _agree_max, profile_two_level
    from mgwfbp_tpu_torch.utils.device import device_kind

    world = world_size()
    if ici * dcn != world:
        raise ValueError(f"--ici {ici} x --dcn {dcn} is not the world of "
                         f"{world} process(es)")
    levels = two_level_groups(dcn)
    sizes = [2 ** k for k in range(min_log2, max_log2 + 1)]
    model_sampled, raw = profile_two_level(levels, device, sizes=sizes,
                                           warmup=warmup, iters=iters)
    nbytes = raw["sizes_bytes"]
    t_ici = dict(zip(nbytes, model_sampled.ici.times_s))
    t_dcn = dict(zip(nbytes, model_sampled.dcn.times_s))
    t_noop, t_hier, t_flat = {}, {}, {}
    for b in nbytes:
        n = max(int(b) // 4, ici)
        n += (-n) % ici
        x = torch.ones(n, device=device)
        shard = torch.ones(n // ici, device=device)
        t_noop[b] = _time(lambda: shard.clone(), warmup, iters, device)
        t_flat[b] = _time(lambda: dist.all_reduce(x), warmup, iters, device)
        t_hier[b] = _time(lambda: hier_bucket(x, levels), warmup, iters,
                          device)
    k = len(nbytes)
    agreed = _agree_max([t_noop[b] for b in nbytes]
                        + [t_flat[b] for b in nbytes]
                        + [t_hier[b] for b in nbytes], None, device)
    t_noop = dict(zip(nbytes, agreed[:k]))
    t_flat = dict(zip(nbytes, agreed[k:2 * k]))
    t_hier = dict(zip(nbytes, agreed[2 * k:]))
    report = {
        "mesh": {"ici": ici, "dcn": dcn},
        "device_kind": device_kind(device),
        "backend": dist.get_backend(),
        "warmup": warmup,
        "iters": iters,
        "fit": raw["fit"],
        **composition(nbytes, t_ici, t_dcn, t_noop, t_hier, t_flat,
                      model_sampled, ici, dcn),
        "solved_schedule": _solved_schedule_check(
            model_sampled, levels, warmup, iters, device),
        "caveat": (
            "both levels on one fabric (one host's cards, or gloo through "
            "host memory): this validates the model's COMPOSITION (inner "
            "term on the full payload + outer term on the 1/ici shard) and "
            "the two-link solver's machinery, not a slower outer link"
        ),
    }
    return model_sampled, report


def main(argv=None) -> int:
    from mgwfbp_tpu_torch.tools.overlap_report import (
        add_device_flag,
        run_tool,
        write_report,
    )

    ap = argparse.ArgumentParser(
        prog="python -m mgwfbp_tpu_torch.tools.two_level_validation",
        description="the two-level cost model against measurement")
    ap.add_argument("--ici", type=int, default=2)
    ap.add_argument("--dcn", type=int, default=2)
    ap.add_argument("--min-log2", type=int, default=13)
    ap.add_argument("--max-log2", type=int, default=23)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--out", default=None)
    add_device_flag(ap)
    args = ap.parse_args(argv)

    def body(device, rank):
        from mgwfbp_tpu_torch.parallel.costmodel import save_profile

        model, report = run(args.ici, args.dcn, args.min_log2, args.max_log2,
                            args.warmup, args.iters, device)
        if rank == 0:
            if args.out:
                save_profile(args.out, model, meta=report)
            write_report(report, None)

    run_tool(body, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
