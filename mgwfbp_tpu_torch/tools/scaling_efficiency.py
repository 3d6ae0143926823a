"""Weak-scaling efficiency (the counterpart of the JAX package's
``tools/scaling_efficiency.py``). Two parts, one JSON artifact:

  measured  - sec/iter of the port's train step (``TrainStep`` with the
              merged all-reduce of ``--policy``) at data extents
              {1, 2, 4, ...} up to the world, each over the first n ranks
              (a subgroup, as ``calibrate --world-sizes`` measures), the
              per-worker batch held constant: efficiency(n) = t(1) / t(n),
              1.0 is perfect weak scaling; each extent's merge groups;

  predicted - solver-simulated efficiency at target extents, per policy:
              efficiency = t1 / (t1 + predicted non-overlapped comm), from
              the tb and t1 measured here, with the same simulation the
              merge solver optimizes (``solver.build_schedule``).

The targets default to the extents of the ``--comm-profile`` family the
card calibrated, each resolved at its extent and labelled by the profile's
device kind (``"<device kind> x<n>"``); ``--targets 2,4,8`` names extents.
Without a profile there are no default targets. The JAX tool's TPU
topologies (``v5e-4``, ``v5e-16``, ``v5e-64``, priced on its ``ici`` and
``dcn`` priors) stay accepted only so that the arithmetic can be held
against the JAX tool's; they describe no card.

    python -m mgwfbp_tpu_torch.tools.scaling_efficiency --model resnet20 \\
        --batch 8 --comm-profile family.json [--out scaling.json]

Several processes (one per card) come from the launch environment; rank 0
writes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

POLICIES = ("mgwfbp", "auto", "wfbp", "single")
EXTENTS = (1, 2, 4, 8, 16, 32)
TPU_TARGETS = ("v5e-4", "v5e-16", "v5e-64")  # parity with the JAX tool only


def tpu_target_cost(tname: str):
    """The JAX tool's TPU topologies on its priors (parity only)."""
    from mgwfbp_tpu_torch.parallel.costmodel import (
        TwoLevelAlphaBeta,
        lookup_alpha_beta,
    )

    if tname == "v5e-4":
        return lookup_alpha_beta("ici", 4), 4
    if tname == "v5e-16":
        return lookup_alpha_beta("ici", 16), 16
    if tname == "v5e-64":
        return TwoLevelAlphaBeta(
            ici=lookup_alpha_beta("ici", 16), dcn=lookup_alpha_beta("dcn", 4),
            ici_size=16, dcn_size=4), 64
    raise ValueError(f"unknown target {tname!r}")


def profile_targets(comm_profile):
    """(label -> (cost model, n)) for every extent of the profile's family
    (a flat profile: its one world), labelled by its device kind."""
    from mgwfbp_tpu_torch.parallel.costmodel import (
        ProfileFamily,
        load_profile,
        resolve_profile,
    )

    model = load_profile(comm_profile)
    with open(comm_profile) as f:
        kind = json.load(f).get("meta", {}).get("device_kind", "profile")
    if isinstance(model, ProfileFamily):
        extents = sorted(model.entries)
    else:
        extents = [2]
    return {f"{kind} x{n}": (resolve_profile(model, n), n) for n in extents}


def target_costs(targets, comm_profile) -> dict:
    """label -> (cost model, n) for the named targets: ``v5e-*`` (parity),
    an extent n of the profile (``"4"``), or a label of
    ``profile_targets``; all the profile's extents when ``targets`` is
    empty."""
    from mgwfbp_tpu_torch.parallel.costmodel import (
        load_profile,
        resolve_profile,
    )

    out = {}
    known = profile_targets(comm_profile) if comm_profile else {}
    if not targets:
        return known
    for t in targets:
        if t in TPU_TARGETS:
            out[t] = tpu_target_cost(t)
        elif t in known:
            out[t] = known[t]
        elif t.isdigit() and comm_profile:
            n = int(t)
            label = next((k for k, (_, m) in known.items() if m == n),
                         f"x{n}")
            out[label] = (resolve_profile(load_profile(comm_profile), n), n)
        else:
            raise ValueError(
                f"unknown target {t!r}: an extent of --comm-profile, a "
                f"label of it ({sorted(known)}) or {', '.join(TPU_TARGETS)}")
    return out


def predicted_targets(layers, tb, t1: float, costs: dict) -> dict:
    """Per target and policy: merge groups, the predicted non-overlapped
    comm and efficiency t1 / (t1 + non-overlap) (the JAX arithmetic)."""
    from mgwfbp_tpu_torch.parallel.solver import build_schedule

    predicted = {}
    for tname, (cm, nchips) in costs.items():
        per_policy = {}
        for pol in POLICIES:
            sched = build_schedule(layers, list(tb), policy=pol,
                                   cost_model=cm)
            nonoverlap = sched.predicted_nonoverlap_time
            per_policy[pol] = {
                "merge_groups": sched.num_groups,
                "predicted_nonoverlap_s": round(nonoverlap, 8),
                "predicted_efficiency": round(t1 / (t1 + nonoverlap), 4),
            }
        predicted[tname] = {"n_chips": nchips, "policies": per_policy}
    return predicted


def _measure_step(step, x, y, iters, warmup, device) -> float:
    """Best-of-3-window sec/iter (the policy-grid protocol): one read back
    brackets each window."""
    from mgwfbp_tpu_torch.profiling import _sync as sync

    for _ in range(max(warmup, 1)):
        m = step(x, y)
    float(m["loss"])
    windows = []
    per_window = max(iters // 3, 1)
    for _ in range(3):
        sync(device)
        t0 = time.perf_counter()
        for _ in range(per_window):
            m = step(x, y)
        float(m["loss"])
        windows.append((time.perf_counter() - t0) / per_window)
    return min(windows)


def run(model_name, batch, policy, comm_profile, targets, iters, warmup,
        dtype_name, device="cuda") -> dict:
    import torch
    import torch.distributed as dist

    from mgwfbp_tpu_torch.bench import make_model, random_batch
    from mgwfbp_tpu_torch.parallel.mesh import rank, world_size
    from mgwfbp_tpu_torch.profiling import _agree_max
    from mgwfbp_tpu_torch.tools.overlap_report import (
        _build_setup,
        arrival_layers,
        measure_tb,
    )
    from mgwfbp_tpu_torch.utils.device import device_kind

    if dtype_name in ("float32", "f32"):
        compute_dtype = None
    elif dtype_name in ("bfloat16", "bf16"):
        compute_dtype = torch.bfloat16
    else:
        raise ValueError(f"--dtype {dtype_name!r}: float32 or bfloat16")
    model, meta = make_model(model_name, device)
    tb = measure_tb(model, meta, batch, device, compute_dtype)
    layers = arrival_layers(model, 2 if compute_dtype == torch.bfloat16
                            else 4)
    del model

    world, me = world_size(), rank()
    extents = [n for n in EXTENTS if n <= world]
    measured, t1, groups_at = {}, None, {}
    for n in extents:
        # every rank creates every subgroup, in one order
        group = dist.new_group(list(range(n))) if world > 1 else None
        dt = 0.0
        if me < n:
            _, _, step, reducer, _ = _build_setup(
                model_name, batch, policy if n > 1 else "none", 1,
                comm_profile, tb=tb, device=device, group=group,
                compute_dtype=compute_dtype)
            x, y = random_batch(meta, 1, batch, device)
            dt = _measure_step(step, x, y, iters, warmup, device)
            groups_at[n] = reducer.num_groups if reducer else 0
            if reducer is not None:
                reducer.detach()
            del step
        # the extent's time is its slowest rank's
        dt = _agree_max([dt], None, device)[0]
        if n == 1:
            t1 = dt
        measured[str(n)] = {
            "sec_per_iter": round(dt, 6),
            "samples_per_sec": round(batch * n / dt, 2),
            "efficiency": round(t1 / dt, 4),
            "merge_groups": groups_at.get(n, 0),
        }
    predicted = predicted_targets(layers, tb, t1,
                                  target_costs(targets, comm_profile))
    kind = None
    if comm_profile:
        from mgwfbp_tpu_torch.parallel.costmodel import load_profile

        kind = type(load_profile(comm_profile)).__name__
    return {
        "model": model_name,
        "batch_per_device": batch,
        "policy_measured": policy,
        "compute_dtype": dtype_name,
        "device_kind": device_kind(device),
        "available_devices": world,
        "comm_profile": comm_profile,
        "comm_profile_kind": kind,
        "tb_total_s": round(sum(tb), 6),
        "t1_sec_per_iter": round(t1, 6),
        "measured_weak_scaling": measured,
        "predicted_targets": predicted,
        "method": (
            "weak scaling: per-worker batch fixed, efficiency = t(1)/t(n), "
            "each extent over the first n ranks; predictions: efficiency = "
            "t1/(t1 + solver-simulated nonoverlapped comm) per policy, the "
            "same simulation the merge solver optimizes; targets are the "
            "--comm-profile's extents (v5e-* names: the JAX tool's TPU "
            "priors, kept for parity only)"
        ),
    }


def main(argv=None) -> int:
    from mgwfbp_tpu_torch.tools.overlap_report import (
        add_device_flag,
        run_tool,
        write_report,
    )

    ap = argparse.ArgumentParser(
        prog="python -m mgwfbp_tpu_torch.tools.scaling_efficiency",
        description="measured weak scaling and solver-predicted targets")
    ap.add_argument("--model", default="resnet20")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--policy", default="mgwfbp")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--comm-profile", dest="comm_profile", default=None,
                    help="a profile the card calibrated; its extents are the "
                         "default targets")
    ap.add_argument("--targets", default="",
                    help="comma list: extents of --comm-profile (default: "
                         "all of them); v5e-4/16/64 for parity only")
    ap.add_argument("--note", default=None)
    ap.add_argument("--out", default=None)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    from mgwfbp_tpu_torch.utils.device import set_matmul_precision

    set_matmul_precision(args.dtype)

    def body(device, rank):
        report = run(args.model, args.batch, args.policy, args.comm_profile,
                     [t for t in args.targets.split(",") if t], args.iters,
                     args.warmup, args.dtype, device)
        if args.note:
            report["environment_note"] = args.note
        if rank == 0:
            write_report(report, args.out)

    run_tool(body, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
