"""Communication calibration CLI (counterpart of ``mgwfbp_tpu/calibrate.py``):
measure the merge schedule's cost model on the live world and write a
profile that ``train_cli --comm-profile`` loads.

    python -m mgwfbp_tpu_torch.calibrate --out p.json --prior-extend 56GbIB
    python -m mgwfbp_tpu_torch.calibrate --out tb.json --forward --model resnet20
    python -m mgwfbp_tpu_torch.train_cli --dnn resnet20 --comm-profile p.json

The flags and the JSON report line are the JAX CLI's, plus ``--device``
(default ``cuda``; a missing card raises, ``cpu`` runs over gloo). One
process forms a one-rank group; several come from the launch environment
``parallel.mesh.init_distributed`` reads (``MGWFBP_COORDINATOR`` /
``MGWFBP_NUM_PROCESSES`` / ``MGWFBP_PROCESS_ID``, SLURM, OpenMPI), one per
card, and rank 0 writes the profile. Modes:

  * default: a sampled all-reduce curve plus gamma, pack_beta and overlap
    over the whole world;
  * ``--world-sizes 2,4``: one entry per extent, each over the first n
    ranks, in a ``family`` profile;
  * ``--prior-extend CONN``: the whole world measured, the other extents of
    ``--prior-world-sizes`` taking CONN's alpha-beta with the measured
    gamma, pack_beta and overlap (``meta`` names which field came from
    where); the mode for one card, where a one-rank all-reduce moves no
    bytes and alpha, beta measure only the dispatch floor;
  * ``--forward --model M``: a layer profile (tb and tf from hooks,
    schema 2) of a classifier on random images or of a language model on
    random tokens (the LSTM from a zero carry, the transformer through
    dense attention, as both train);
  * ``--two-level --dcn D [--ici I]``: the world split into D slices of I
    ranks (``parallel.mesh.two_level_groups``; I * D must be the world),
    an all-reduce sweep over only the inner groups and over only the outer
    groups, each link fit on its own (``--allgather`` adds the inner
    link's ag_fraction), written as a ``two_level`` profile of measured
    curves that both packages' ``load_profile`` read and ``--comm-op
    hier`` schedules on.

``update_beta`` (the rs_opt_ag shard update's cost per bucket byte) is
measured with the bucket-path benchmarks (``--no-gamma`` saves it as 0.0).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Optional

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mgwfbp-calibrate-torch")
    p.add_argument("--out", required=True, help="output profile json path")
    p.add_argument("--min-log2", type=int, default=13,
                   help="smallest payload (log2 elements)")
    p.add_argument("--max-log2", type=int, default=24,
                   help="largest payload (log2 elements)")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--no-gamma", action="store_true",
                   help="skip the bucket-path benchmarks (gamma, pack_beta, "
                        "update_beta): all save as 0.0")
    p.add_argument("--no-overlap", action="store_true",
                   help="skip the comm/compute overlap probe (saves 1.0)")
    p.add_argument("--allgather", action="store_true",
                   help="also sweep an all-gather and fit ag_fraction")
    p.add_argument("--gamma-total-log2", type=int, default=22,
                   help="fixed total payload for the gamma fit (log2 elems)")
    p.add_argument("--world-sizes", default=None,
                   help="comma list of world sizes to calibrate, each over "
                        "the first n ranks: a 'family' profile")
    p.add_argument("--prior-extend", default=None, metavar="CONN",
                   help="measure the whole world and fill the extents of "
                        "--prior-world-sizes from the named alpha-beta "
                        "prior, with the measured gamma/pack_beta/overlap "
                        "(a 'family' profile; meta separates measured_fields "
                        "from prior_fields)")
    p.add_argument("--prior-world-sizes", default="2,4,8,16",
                   help="extents for the prior-extended entries")
    p.add_argument("--two-level", dest="two_level", action="store_true",
                   help="per-link calibration of an (ici x dcn) world "
                        "(needs --dcn > 1): an all-reduce sweep over only "
                        "the inner groups and only the outer groups, each "
                        "link fit on its own, written as a two-level "
                        "profile of measured curves (kind 'two_level'); "
                        "--allgather adds the inner link's RS/AG split")
    p.add_argument("--ici", type=int, default=None,
                   help="ranks per slice for --two-level (default: world "
                        "/ dcn)")
    p.add_argument("--dcn", type=int, default=2,
                   help="slices for --two-level")
    p.add_argument("--forward", action="store_true",
                   help="layer-profile mode (needs --model): per-layer "
                        "backward AND forward seconds from hooks, written as "
                        "a schema-2 layer profile (tb_profile.json format)")
    p.add_argument("--model", default=None,
                   help="model to benchmark in --forward mode (e.g. resnet20)")
    p.add_argument("--batch-size", type=int, default=8,
                   help="per-device batch for the --forward benchmark")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv: Optional[list[str]] = None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.prior_extend and args.world_sizes:
        p.error("--prior-extend and --world-sizes are mutually exclusive: "
                "the former measures ONE world size and prior-fills the "
                "rest, the latter measures each listed extent")
    if args.forward and not args.model:
        p.error("--forward needs --model (the layer profile is per-model)")
    if args.two_level and (
        args.world_sizes or args.prior_extend or args.forward
    ):
        p.error("--two-level is its own calibration mode; it does not "
                "combine with --world-sizes/--prior-extend/--forward")
    from mgwfbp_tpu_torch.utils.device import set_matmul_precision
    from mgwfbp_tpu_torch.utils.logging import get_logger

    # calibration times float32 work: the precision the trainer sets for it
    set_matmul_precision(None, log=get_logger("mgwfbp.calibrate"))
    if args.forward:
        return _forward_main(args)
    if args.two_level:
        return _two_level_main(args)
    return _comm_main(args)


def _calibrate_group(args, group, device):
    """The sampled curve plus gamma, pack_beta, overlap (and ag_fraction)
    over one process group."""
    from mgwfbp_tpu_torch.parallel.costmodel import SampledCost
    from mgwfbp_tpu_torch.profiling import (
        fit_ag_fraction,
        profile_allgather,
        profile_allreduce,
        profile_group_overhead,
        profile_overlap_capability,
        profile_pack_overhead,
        profile_update_beta,
    )

    sizes = tuple(2**k for k in range(args.min_log2, args.max_log2 + 1))
    prof = profile_allreduce(group, device, sizes=sizes, warmup=args.warmup,
                             iters=args.iters)
    gamma, gsamples, pack_beta, update_beta = 0.0, None, 0.0, 0.0
    if not args.no_gamma:  # the bucket-path benchmarks
        gamma, gsamples = profile_group_overhead(
            group, device, alpha=prof.model.alpha,
            total_elems=2**args.gamma_total_log2,
        )
        pack_beta = profile_pack_overhead(group, device)
        update_beta = profile_update_beta(group, device)
    overlap = 1.0
    if not args.no_overlap:
        overlap = profile_overlap_capability(group, device)
    ag_fraction = 0.5
    if args.allgather:
        ag_prof = profile_allgather(group, device, sizes=sizes,
                                    warmup=args.warmup, iters=args.iters)
        ag_fraction = fit_ag_fraction(prof, ag_prof)
    model = SampledCost(
        sizes_bytes=tuple(prof.sizes_bytes),
        times_s=tuple(prof.times_s),
        ab=prof.model,
        gamma=gamma,
        overlap=overlap,
        pack_beta=pack_beta,
        update_beta=update_beta,
        ag_fraction=ag_fraction,
    )
    return model, prof, gsamples


def _fields(model) -> dict:
    return {
        "alpha_s": model.alpha,
        "beta_s_per_byte": model.beta,
        "gamma_s": model.gamma,
        "overlap": model.overlap,
        "pack_beta_s_per_byte": model.pack_beta,
        "update_beta_s_per_byte": model.update_beta,
        "ag_fraction": model.ag_fraction,
    }


def _comm_main(args) -> int:
    import torch.distributed as dist

    from mgwfbp_tpu_torch.parallel.costmodel import (
        AlphaBeta,
        ProfileFamily,
        lookup_alpha_beta,
        save_profile,
    )
    from mgwfbp_tpu_torch.parallel.mesh import start_group
    from mgwfbp_tpu_torch.utils.device import device_kind

    rdv = tempfile.TemporaryDirectory(prefix="mgwfbp_calibrate_")
    device, started = start_group(args.device, rdv.name)
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
        meta = {
            "device_kind": device_kind(device),
            "n_devices": world,
            "backend": backend,
            "link": (
                "nccl" if backend == "nccl"
                else "gloo through host memory (not a card's link)"
            ),
            "payload_log2_range": [args.min_log2, args.max_log2],
            "iters": args.iters,
        }
        if world == 1:
            meta["note"] = (
                "a one-rank all-reduce moves no bytes: alpha and beta here "
                "measure the collective's dispatch floor"
            )
        if args.prior_extend:
            measured, _, gamma_samples = _calibrate_group(args, None, device)
            prior_sizes = sorted(
                {int(s) for s in args.prior_world_sizes.split(",")} - {world}
            )
            entries: dict = {world: measured}
            for n in prior_sizes:
                ab = lookup_alpha_beta(args.prior_extend, n)
                entries[n] = AlphaBeta(
                    alpha=ab.alpha, beta=ab.beta, gamma=measured.gamma,
                    overlap=measured.overlap, pack_beta=measured.pack_beta,
                    update_beta=measured.update_beta,
                    ag_fraction=measured.ag_fraction,
                )
            out_model = ProfileFamily(entries=entries)
            meta["measured_fields"] = {
                str(world): "all (sampled curve + gamma + pack_beta + overlap)",
                **{
                    str(n): "gamma, pack_beta, overlap "
                            f"(measured at world={world} over {backend})"
                    for n in prior_sizes
                },
            }
            meta["prior_fields"] = {
                str(n): f"alpha, beta ({args.prior_extend} prior: no world "
                        f"of {n} available to measure)"
                for n in prior_sizes
            }
            if gamma_samples:
                meta["gamma_samples_s"] = [[k, t] for k, t in gamma_samples]
            report = {
                "measured_world": world,
                **_fields(measured),
                "prior_extended": prior_sizes,
                "out": args.out,
            }
        elif args.world_sizes:
            extents = sorted({int(s) for s in args.world_sizes.split(",")})
            if extents[-1] > world:
                raise SystemExit(
                    f"--world-sizes {extents[-1]}: only {world} devices "
                    "available (one process per device)"
                )
            entries, summary = {}, {}
            for n in extents:
                sub = dist.new_group(list(range(n)))
                if rank < n:
                    model, _, _ = _calibrate_group(args, sub, device)
                    entries[n] = model
                    summary[str(n)] = _fields(model)
                dist.barrier()
            out_model = ProfileFamily(entries=entries)
            meta["world_sizes"] = extents
            report = {"family": summary, "out": args.out}
        else:
            out_model, prof, gamma_samples = _calibrate_group(
                args, None, device
            )
            if gamma_samples:
                meta["gamma_samples_s"] = [[k, t] for k, t in gamma_samples]
            report = {
                **_fields(out_model),
                "samples": len(prof.sizes_bytes),
                "out": args.out,
            }
        if rank == 0:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            save_profile(args.out, out_model, meta=meta)
            print(json.dumps(report), flush=True)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
        rdv.cleanup()
    return 0


def _two_level_main(args) -> int:
    """--two-level: the per-link sweeps over a two-level split of the
    world (``profiling.profile_two_level``) -> a two_level profile, written
    and reported by rank 0."""
    import torch.distributed as dist

    from mgwfbp_tpu_torch.parallel.costmodel import save_profile
    from mgwfbp_tpu_torch.parallel.mesh import start_group, two_level_groups
    from mgwfbp_tpu_torch.profiling import profile_two_level
    from mgwfbp_tpu_torch.utils.device import device_kind

    dcn = int(args.dcn)
    if dcn <= 1:
        raise SystemExit("--two-level needs --dcn > 1")
    rdv = tempfile.TemporaryDirectory(prefix="mgwfbp_calibrate_")
    device, started = start_group(args.device, rdv.name)
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        ici = int(args.ici) if args.ici else world // dcn
        if ici < 1 or ici * dcn != world:
            raise SystemExit(
                f"--two-level: {ici} x {dcn} does not make the world of "
                f"{world} rank(s) (one process per device)")
        levels = two_level_groups(dcn)
        sizes = tuple(2**k for k in range(args.min_log2, args.max_log2 + 1))
        model, raw = profile_two_level(
            levels, device, sizes=sizes, warmup=args.warmup,
            iters=args.iters, allgather=args.allgather,
        )
        backend = dist.get_backend()
        meta = {
            "device_kind": device_kind(device),
            "backend": backend,
            "link": (
                "nccl" if backend == "nccl"
                else "gloo through host memory (not a card's link)"
            ),
            "mesh": {"ici": ici, "dcn": dcn},
            "payload_log2_range": [args.min_log2, args.max_log2],
            "iters": args.iters,
            "fit": raw["fit"],
            "ag_fraction": raw["ag_fraction"],
        }
        if rank == 0:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            save_profile(args.out, model, meta=meta)
            print(json.dumps({
                "ici": {
                    "alpha_s": model.ici.alpha,
                    "beta_s_per_byte": model.ici.beta,
                    "ag_fraction": raw["ag_fraction"],
                },
                "dcn": {
                    "alpha_s": model.dcn.alpha,
                    "beta_s_per_byte": model.dcn.beta,
                },
                "mesh": {"ici": ici, "dcn": dcn},
                "samples": len(raw["sizes_bytes"]),
                "out": args.out,
            }), flush=True)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
        rdv.cleanup()
    return 0


def _forward_main(args) -> int:
    """--forward: per-layer backward and forward seconds from hooks on one
    device, written as a schema-2 layer profile."""
    import numpy as np
    import torch

    from mgwfbp_tpu_torch import models as zoo
    from mgwfbp_tpu_torch.convert import flax_leaves, keystr
    from mgwfbp_tpu_torch.models.common import init_weights
    from mgwfbp_tpu_torch.parallel.allreduce import arrival_order
    from mgwfbp_tpu_torch.profiling import (
        benchmark_backward,
        benchmark_forward,
        layer_profile_doc,
        save_layer_profile,
    )
    from mgwfbp_tpu_torch.train.step import forward_loss
    from mgwfbp_tpu_torch.utils.device import device_kind, resolve_device

    if args.model not in zoo.model_names():
        raise SystemExit(
            f"--forward --model {args.model}: unknown model; the port's "
            f"models: {', '.join(zoo.model_names())}"
        )
    device = resolve_device(args.device)
    model, meta = zoo.create_model(args.model)
    model = zoo.for_training(model)
    init_weights(model, torch.Generator().manual_seed(0))
    model.to(device).train()
    b = max(args.batch_size, 1)
    rs = np.random.RandomState(0)
    carry = lengths = None
    if meta.task == "ctc":
        # a speech batch, as the JAX --forward builds it: (b, time, freq)
        # spectrograms at full length, label ids over an eighth of the
        # frames (at least 4)
        t = int(meta.input_shape[0])
        label_t = max(t // 8, 4)
        x = torch.from_numpy(
            rs.randn(b, *meta.input_shape).astype(np.float32)).to(device)
        y = torch.from_numpy(
            rs.randint(1, meta.num_classes, (b, label_t)).astype(np.int64)
        ).to(device)
        lengths = (torch.full((b,), t, dtype=torch.int64, device=device),
                   torch.full((b,), label_t, dtype=torch.int64,
                              device=device))
    elif meta.task == "lm":
        # integer tokens and next-token targets; a BPTT model from its
        # zero carry, as an epoch starts
        x, y = (
            torch.from_numpy(
                rs.randint(0, meta.num_classes, (b, *meta.input_shape))
                .astype(np.int64)
            ).to(device)
            for _ in range(2)
        )
        if meta.has_carry:
            carry = model.initial_carry(b, device)
    else:
        x = torch.from_numpy(
            rs.randn(b, *meta.input_shape).astype(np.float32)
        ).to(device).movedim(-1, -3).contiguous()
        y = torch.from_numpy(
            rs.randint(0, meta.num_classes, (b,)).astype(np.int64)
        ).to(device)
    leaves = flax_leaves(model)
    names = [keystr(path) for path, _ in leaves]
    params = [t for _, t in leaves]
    perm = arrival_order(len(names), names=names)

    def loss_of():
        return forward_loss(model, meta.task, x, y, carry,
                            lengths=lengths)[0]

    tb = benchmark_backward(model, loss_of, params, perm,
                            warmup=args.warmup, iters=args.iters)
    tf = benchmark_forward(model, loss_of, params, perm,
                           warmup=args.warmup, iters=args.iters)
    doc = layer_profile_doc(
        tb, [names[j] for j in perm], tf=tf,
        meta={"model": args.model, "batch_size": b,
              "device_kind": device_kind(device)},
    )
    save_layer_profile(args.out, doc)
    print(json.dumps({
        "model": args.model,
        "tb_total_s": doc["total_s"],
        "tf_total_s": doc["tf_total_s"],
        "layers": len(doc["tb_s"]),
        "source": doc["source"],
        "tf_source": doc["tf_source"],
        "out": args.out,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
