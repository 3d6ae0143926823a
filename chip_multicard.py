"""Calibration and overlap accounting across several cards of one host.

    python3 chip_multicard.py                       # every card of the host
    python3 chip_multicard.py --device cpu --processes 4 --min-log2 8 \\
        --max-log2 10 --iters 2 --warmup 1 --gamma-total-log2 12 \\
        --batches 2                                 # a gloo rehearsal

Two steps, each N processes (one per card, ``LOCAL_RANK`` = process id)
started together on a localhost rendezvous:

  1. ``python -m mgwfbp_tpu_torch.calibrate --world-sizes 1,2,..,N``: a
     family profile measured over the first n ranks for each n;
  2. ``python -m mgwfbp_tpu_torch.train_cli --dnn resnet20 --synthetic
     --policy mgwfbp --comm-profile <family> --telemetry`` with
     ``MGWFBP_TELEMETRY_TRACE=1``: ResNet-20 at the per-worker batch 32 on
     the family resolved at N, two traced steps, then the epochs.

Prints the calibrated constants per world size, each rank's resolved cost
model, schedule, traced per-group device times (or why none) and last
overlap record, and one JSON line ``{"multicard": ...}``. Every process is
joined with a timeout and killed if it outlives it. Writes under
``--out-dir`` (default ``build/multicard``).

With ``--heal`` the script runs another step instead of those two: a
supervised ResNet-20
group of N processes (``python -m mgwfbp_tpu_torch.runtime.supervise``)
whose last process SIGKILLs itself after step 8
(``kill@step=8,proc=N-1``). The survivors are blocked in the step's
all-reduce, which the dead peer never joins (``MGWFBP_AGREE_INTERVAL=1000``
keeps the gloo drain vote out of the way, so the NCCL path is the one
measured); the collective timeout ``MGWFBP_COORD_TIMEOUT_S`` (30 s) ends
them. The healer shrinks the group to N-1, which resumes from the last
committed step under the n-N tag and trains to the end. Prints one JSON
line ``{"multicard_heal": ...}``: the exit codes of each incarnation, the
seconds from the kill to the survivors' exit, the heal, the resize and the
final step.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_group(n: int, argv: list[str], out_dir: str, name: str,
               timeout_s: float, extra_env: dict) -> list[str]:
    """Start ``python -m <argv>`` in n processes of one world; return each
    one's standard output. Fails (exit 1) on a non-zero exit or a hang."""
    port = _free_port()
    procs, logs = [], []
    for r in range(n):
        env = dict(os.environ, PYTHONPATH=ROOT,
                   MGWFBP_COORDINATOR=f"127.0.0.1:{port}",
                   MGWFBP_NUM_PROCESSES=str(n), MGWFBP_PROCESS_ID=str(r),
                   LOCAL_RANK=str(r), **extra_env)
        log = open(os.path.join(out_dir, f"{name}.rank{r}.err"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", *argv], stdout=subprocess.PIPE,
            stderr=log, text=True, cwd=out_dir, env=env,
        ))
    outs, codes = [], []
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                out = ""
            outs.append(out)
            codes.append(p.poll())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
        for log in logs:
            log.close()
    if codes != [0] * n:
        print(f"chip_multicard: {name} ranks exited {codes} (logs in "
              f"{out_dir})", file=sys.stderr, flush=True)
        raise SystemExit(1)
    return outs


HEAL_COORD_TIMEOUT_S = 30


def _stamp(line: str) -> float:
    """Wall time of a log line (``YYYY-mm-dd HH:MM:SS,mmm ...``)."""
    day, ms = line[:23].split(",")
    return time.mktime(time.strptime(day, "%Y-%m-%d %H:%M:%S")) + int(ms) / 1e3


def heal_phase(n: int, device: str, out_dir: str, batch_size: int,
               env: dict) -> dict:
    """The supervised group, a SIGKILL of its last process, the survivors'
    exit through the collective timeout, the shrink to n-1 and its
    cross-world resume."""
    sys.path.insert(0, ROOT)
    from mgwfbp_tpu_torch.telemetry import events_of, read_events, stream_filename

    root = os.path.join(out_dir, "heal")
    shutil.rmtree(root, ignore_errors=True)
    log_dir = os.path.join(root, "sup")
    os.makedirs(log_dir)
    kill_step = 8
    cmd = [sys.executable, "-m", "mgwfbp_tpu_torch.runtime.supervise",
           "--processes", str(n), "--log-dir", log_dir, "--",
           "--dnn", "resnet20", "--synthetic", "--device", device,
           "--max-epochs", "2", "--num-batches-per-epoch", "12",
           "--batch-size", str(batch_size), "--ckpt-every-steps", "5",
           "--no-ckpt-async", "--telemetry",
           "--checkpoint-dir", os.path.join(root, "ckpt"),
           "--logdir", os.path.join(root, "logs")]
    full_env = dict(os.environ, PYTHONPATH=ROOT, **env,
                    MGWFBP_FAULT_PLAN=f"kill@step={kill_step},proc={n - 1}",
                    MGWFBP_COORD_TIMEOUT_S=str(HEAL_COORD_TIMEOUT_S),
                    MGWFBP_AGREE_INTERVAL="1000", MGWFBP_METRICS_PORT="0")
    t0 = time.perf_counter()
    with open(os.path.join(root, "supervise.err"), "w") as err:
        p = subprocess.Popen(cmd, stdout=err, stderr=subprocess.STDOUT,
                             env=full_env, cwd=out_dir)
        try:
            rc = p.wait(timeout=900)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rc = None
    wall = time.perf_counter() - t0
    with open(os.path.join(root, "supervise.err")) as f:
        lines = f.read().splitlines()
    if rc != 0:
        print("chip_multicard: heal phase rc", rc, "\n" + "\n".join(lines[-20:]),
              file=sys.stderr, flush=True)
        raise SystemExit(1)
    codes = [ln.split("exit codes ", 1)[1] for ln in lines
             if "exit codes" in ln]
    first_exit = [ln for ln in lines if "exited HARD" in ln][0]
    all_exit = [ln for ln in lines if "incarnation 0: exit codes" in ln][0]
    sup = read_events(os.path.join(log_dir, "telemetry.supervisor.jsonl"))
    heal = [e for e in sup if e["event"] == "heal"]
    if not heal or heal[0]["action"] != "shrink" or heal[0]["world"] != n - 1:
        print(f"chip_multicard: heal events {heal}", file=sys.stderr)
        raise SystemExit(1)
    tags = os.listdir(os.path.join(root, "logs"))
    (tag,) = [t for t in tags if f"-n{n - 1}-" in t]
    recs = read_events(os.path.join(root, "logs", tag,
                                    stream_filename(0, n - 1)))
    resize = events_of(recs, "resize")
    steps = events_of(recs, "step")
    with open(os.path.join(log_dir, "p0.i0.log")) as f:
        survivor = [ln for ln in f.read().splitlines()
                    if "Watchdog" in ln or "timeout" in ln.lower()
                    or "coordination" in ln][-6:]
    out = {
        "processes": n, "device": device, "kill_step": kill_step,
        "coord_timeout_s": HEAL_COORD_TIMEOUT_S, "exit_codes": codes,
        "kill_to_survivors_exit_s": _stamp(all_exit) - _stamp(first_exit),
        "heal": heal[0], "resize": resize[0] if resize else None,
        "final_step": steps[-1]["step"] if steps else None,
        "survivor_log": survivor, "wall_s": wall,
    }
    print(f"heal: exit codes {codes}; the survivors left "
          f"{out['kill_to_survivors_exit_s']:.2f} s after the kill "
          f"(timeout {HEAL_COORD_TIMEOUT_S} s); {heal[0]['action']} "
          f"{heal[0]['old_world']} -> {heal[0]['world']}; resize "
          f"{resize[0]['old_world'] if resize else None} -> "
          f"{resize[0]['new_world'] if resize else None} at iteration "
          f"{resize[0]['iteration'] if resize else None}; final step "
          f"{out['final_step']}", flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="chip_multicard")
    p.add_argument("--processes", type=int, default=None,
                   help="world size (default: the host's card count)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out-dir", default=os.path.join(ROOT, "build",
                                                     "multicard"))
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batches", type=int, default=20,
                   help="optimizer steps per epoch")
    p.add_argument("--batch-size", type=int, default=32)
    for flag in ("--min-log2", "--max-log2", "--iters", "--warmup",
                 "--gamma-total-log2"):
        p.add_argument(flag, default=None)
    p.add_argument("--heal", action="store_true",
                   help="run the supervised heal step instead")
    args = p.parse_args(argv)
    n = args.processes
    if n is None:
        import torch

        n = torch.cuda.device_count()
    if n < 2:
        print(f"chip_multicard: needs 2 or more processes, got {n}",
              file=sys.stderr)
        return 1
    os.makedirs(args.out_dir, exist_ok=True)
    sweep = [x for flag in ("min_log2", "max_log2", "iters", "warmup",
                            "gamma_total_log2")
             if getattr(args, flag) is not None
             for x in ("--" + flag.replace("_", "-"), getattr(args, flag))]
    family = os.path.join(args.out_dir, "family.json")
    # CPU ranks share the host's cores: one intra-op thread each
    env = {"OMP_NUM_THREADS": "1"} if args.device == "cpu" else {}
    extents = ",".join(str(1 << k) for k in range(n.bit_length())
                       if (1 << k) <= n)
    if str(n) not in extents.split(","):
        extents += f",{n}"

    if args.heal:
        print(json.dumps({"multicard_heal": heal_phase(
            n, args.device, args.out_dir, args.batch_size, env)}), flush=True)
        return 0

    t0 = time.perf_counter()
    outs = _run_group(
        n, ["mgwfbp_tpu_torch.calibrate", "--out", family, "--world-sizes",
            extents, "--device", args.device, *sweep],
        args.out_dir, "calibrate", 900, env,
    )
    calibrate_s = time.perf_counter() - t0
    report = json.loads(outs[0].strip().splitlines()[-1])
    for w, f in sorted(report["family"].items(), key=lambda kv: int(kv[0])):
        print(f"calibrate world {w}: alpha {f['alpha_s']:.4g} s, beta "
              f"{f['beta_s_per_byte']:.4g} s/B, gamma {f['gamma_s']:.4g} s, "
              f"pack_beta {f['pack_beta_s_per_byte']:.4g} s/B, overlap "
              f"{f['overlap']:.4g}", flush=True)
    with open(family) as fh:
        meta = json.load(fh)["meta"]

    logdir = os.path.join(args.out_dir, "logs")
    shutil.rmtree(logdir, ignore_errors=True)
    t0 = time.perf_counter()
    outs = _run_group(
        n, ["mgwfbp_tpu_torch.train_cli", "--dnn", "resnet20", "--synthetic",
            "--device", args.device, "--epochs", str(args.epochs),
            "--num-batches-per-epoch", str(args.batches), "--batch-size",
            str(args.batch_size), "--policy", "mgwfbp", "--comm-profile",
            family, "--telemetry", "--logdir", logdir],
        args.out_dir, "train", 900, {**env, "MGWFBP_TELEMETRY_TRACE": "1"},
    )
    train_s = time.perf_counter() - t0
    metrics = json.loads(outs[0].strip().splitlines()[-1])

    sys.path.insert(0, ROOT)
    from mgwfbp_tpu_torch.telemetry import events_of, find_stream_paths, read_events

    (tag,) = os.listdir(logdir)
    ranks = []
    for r, path in enumerate(find_stream_paths(os.path.join(logdir, tag))):
        recs = read_events(path)
        with open(os.path.join(args.out_dir, f"train.rank{r}.err")) as fh:
            log = fh.read().splitlines()
        pick = [ln.split("mgwfbp.trainer: ", 1)[-1] for ln in log
                if "cost model:" in ln or "merge schedule:" in ln
                or "telemetry trace:" in ln or "backward benchmark" in ln]
        overlap = events_of(recs, "overlap")[-1]
        groups = [g for g in events_of(recs, "comm_group")
                  if g["step"] == overlap["step"]]
        spans = [s["dur_s"] for s in events_of(recs, "step")]
        ranks.append({
            "rank": r, "log": pick, "overlap": overlap,
            "group_comm_s": [g["comm_s"] for g in groups],
            "group_nbytes": [g["nbytes"] for g in groups],
            "step_span_median_s": sorted(spans)[len(spans) // 2],
            "steps": len(spans),
        })
        print(f"train rank {r}: " + " | ".join(pick), flush=True)
        print(f"train rank {r}: overlap ({overlap['attribution']}) "
              f"efficiency {overlap['efficiency']:.4f}: "
              f"{overlap['comm_s'] * 1e3:.4f} ms comm per step = "
              f"{overlap['hidden_s'] * 1e3:.4f} hidden + "
              f"{overlap['exposed_s'] * 1e3:.4f} exposed, step "
              f"{overlap['step_s'] * 1e3:.3f} ms, {overlap['num_groups']} "
              "groups", flush=True)
    print(json.dumps({"multicard": {
        "processes": n, "device": args.device,
        "device_kind": meta.get("device_kind"), "backend": meta.get("backend"),
        "calibrate_s": calibrate_s, "train_s": train_s,
        "family": report["family"], "gamma_samples_s": meta.get(
            "gamma_samples_s"),
        "train": metrics, "ranks": ranks,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
