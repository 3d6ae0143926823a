"""The card runs in order (the counterpart of the JAX package's
``tools/chip_sequence.sh``): each leg a process of its own under its
timeout, writing ``<logdir>/<leg>.out`` and ``<logdir>/<leg>.err``; a leg
that fails or times out does not block the later ones (they exercise
independent paths).

    python -m mgwfbp_tpu_torch.tools.chip_sequence [logdir] [--device cuda]
        [--legs calibrate,bench,mfu_ablation,an4_memcheck] [--dry-run]

from the repo root (the AN4 leg reads ``data/an4_memcheck``).

The legs, in dependency order:

  1. ``calibrate``: ``python -m mgwfbp_tpu_torch.calibrate --out
     <logdir>/profile.json --prior-extend 56GbIB`` (the lightest leg; its
     profile feeds the bench through ``MGWFBP_BENCH_PROFILE``);
  2. ``bench``: ``python -m mgwfbp_tpu_torch.bench``;
  3. ``mfu_ablation``: ``python -m mgwfbp_tpu_torch.tools.mfu_ablation
     --out <logdir>/mfu_ablation.json``;
  4. ``an4_memcheck``: the AN4 memorisation run, ``python -m
     mgwfbp_tpu_torch.train_cli --dnn lstman4 --data-dir data/an4_memcheck
     --max-epochs 300 --logdir <logdir>/an4_memcheck`` under
     ``MGWFBP_WATCHDOG_S=900``.

Prints one ``[seq HH:MM:SS]`` line as each leg starts and ends (its exit
code; 124 for a timeout), then one JSON line; exits 1 when a leg failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

DEFAULT_LOGDIR = os.path.join("logs", "chip_sequence_torch")


def legs(logdir: str, device: str) -> list[tuple[str, list, float, dict]]:
    """(name, argv, timeout seconds, extra environment) of each leg, in
    order."""
    py = sys.executable
    profile = os.path.join(logdir, "profile.json")
    return [
        ("calibrate", [py, "-m", "mgwfbp_tpu_torch.calibrate", "--out",
                       profile, "--prior-extend", "56GbIB", "--device",
                       device], 2400.0, {}),
        ("bench", [py, "-m", "mgwfbp_tpu_torch.bench", "--device", device],
         2400.0, {"MGWFBP_BENCH_PROFILE": profile}),
        ("mfu_ablation", [py, "-m", "mgwfbp_tpu_torch.tools.mfu_ablation",
                          "--out", os.path.join(logdir, "mfu_ablation.json"),
                          "--device", device], 3600.0, {}),
        ("an4_memcheck", [py, "-m", "mgwfbp_tpu_torch.train_cli", "--dnn",
                          "lstman4", "--data-dir", "data/an4_memcheck",
                          "--max-epochs", "300", "--logdir",
                          os.path.join(logdir, "an4_memcheck"), "--device",
                          device], 7200.0, {"MGWFBP_WATCHDOG_S": "900"}),
    ]


def _stamp(msg: str) -> None:
    print(f"[seq {time.strftime('%H:%M:%S', time.gmtime())}] {msg}",
          flush=True)


def run_leg(name: str, argv: list, timeout_s: float, env: dict,
            logdir: str) -> dict:
    """One leg under its timeout; its output to ``<logdir>/<name>.out``
    and ``.err``. rc 124 when the timeout ended it."""
    t0 = time.monotonic()
    with open(os.path.join(logdir, f"{name}.out"), "w") as out, \
            open(os.path.join(logdir, f"{name}.err"), "w") as err:
        try:
            rc = subprocess.run(argv, stdout=out, stderr=err,
                                timeout=timeout_s,
                                env={**os.environ, **env}).returncode
        except subprocess.TimeoutExpired:
            rc = 124
    return {"leg": name, "rc": rc, "seconds": time.monotonic() - t0,
            "timeout_s": timeout_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mgwfbp_tpu_torch.tools.chip_sequence",
        description="the card runs in order, each under its timeout")
    ap.add_argument("logdir", nargs="?", default=DEFAULT_LOGDIR)
    ap.add_argument("--device", default="cuda",
                    help="passed to every leg (cpu for a rehearsal)")
    ap.add_argument("--legs", default=None,
                    help="comma list of the legs to run (default: all, in "
                         "order)")
    ap.add_argument("--dry-run", action="store_true",
                    help="print each leg's command, timeout and environment "
                         "and run none")
    args = ap.parse_args(argv)
    os.makedirs(args.logdir, exist_ok=True)
    plan = legs(args.logdir, args.device)
    if args.legs:
        wanted = args.legs.split(",")
        unknown = sorted(set(wanted) - {name for name, *_ in plan})
        if unknown:
            ap.error(f"unknown legs {unknown}")
        plan = [leg for leg in plan if leg[0] in wanted]
    if args.dry_run:
        print(json.dumps({"chip_sequence_plan": [
            {"leg": name, "argv": cmd, "timeout_s": timeout_s, "env": env}
            for name, cmd, timeout_s, env in plan]}), flush=True)
        return 0
    results = []
    for i, (name, cmd, timeout_s, env) in enumerate(plan, 1):
        _stamp(f"leg {i}/{len(plan)}: {name}")
        res = run_leg(name, cmd, timeout_s, env, args.logdir)
        _stamp(f"{name} rc={res['rc']} ({res['seconds']:.1f} s)")
        results.append(res)
    _stamp("done")
    print(json.dumps({"chip_sequence": results, "logdir": args.logdir}),
          flush=True)
    return 0 if all(r["rc"] == 0 for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
