"""The benchmark of ``mgwfbp_tpu_torch``'s data-parallel training.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the cards of this machine and prints
one JSON line as the last line of standard output, after the check's
numbers beside their limits on standard error. A cell on several cards
starts one process per card (``--rank``), joined through the program's
launch environment (``MGWFBP_COORDINATOR``, ``MGWFBP_NUM_PROCESSES``,
``MGWFBP_PROCESS_ID``) on a free local port; rank 0's result comes back
through a file in a directory under ``TMPDIR``.

``--device cpu`` skips the look for a card and ``--fault`` plants one of
``benchmark.faults``: both are for the harness's own tests.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the program's build and kernel caches at fixed paths inside the checkout
CACHE = os.path.join(ROOT, ".benchmark_cache")
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(CACHE, "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
# no prefetch threads: the window feeds device batches itself
os.environ["MGWFBP_DATA_WORKERS"] = "0"
os.environ.setdefault("USE_FLAX", "0")
RANK_TIMEOUT_S = 330.0


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--fault", default=None)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--t-start", type=float, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--workdir", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr)
    return 2


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(name: str, world: int):
    """This rank's device: the port's ``init_distributed`` (its launch
    environment) at several ranks, else card 0 or the CPU."""
    import torch

    from mgwfbp_tpu_torch.parallel.mesh import init_distributed

    if world > 1:
        return init_distributed(device=name)
    if name != "cuda":
        return torch.device("cpu")
    torch.cuda.set_device(0)
    return torch.device("cuda", 0)


def rank_main(args: argparse.Namespace) -> int:
    """One rank of a multi-card cell (or the whole of a one-card cell)."""
    import torch

    from benchmark import drive, spec

    cell = spec.load_cell(ROOT, args.workload)
    world = cell.ranks
    rank = args.rank or 0
    if args.device == "cuda" and not (torch.cuda.is_available() and
                                      torch.cuda.device_count() >= cell.chips):
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA "
              f"card(s); {torch.cuda.device_count()} here", file=sys.stderr)
        return 2
    device = rank_device(args.device, world)
    result = drive.run_rank(
        cell, args.seed, args.seconds, bool(args.trace), device, rank, world,
        args.t_start or T_START, args.workdir, fault=args.fault)
    if world > 1:
        import torch.distributed as dist

        dist.destroy_process_group()
    with open(os.path.join(args.workdir, f"result{rank}.json"), "w") as f:
        json.dump(result, f)
    return 0


def core_shares(world: int) -> list[list[int]]:
    """This process's cores in ``world`` contiguous shares, one a rank: the
    ranks' host threads (the Python loop, autograd's, NCCL's) do not
    compete for cores or migrate between them, as a launcher that binds
    each process to its own cores runs them."""
    cores = sorted(os.sched_getaffinity(0))
    n = max(len(cores) // world, 1)
    return [cores[(r * n) % len(cores):][:n] for r in range(world)]


def launch(script: str, argv: list[str], world: int, device: str,
           timeout_s: float = RANK_TIMEOUT_S) -> int:
    """Start ``world`` processes of ``script argv --rank r`` and wait for
    all of them; any that fails or outlives the time limit ends the
    others."""
    port = free_port()
    procs = []
    for r, cpus in enumerate(core_shares(world)):
        env = dict(os.environ, MGWFBP_COORDINATOR=f"127.0.0.1:{port}",
                   MGWFBP_NUM_PROCESSES=str(world), MGWFBP_PROCESS_ID=str(r),
                   OMP_NUM_THREADS=str(len(cpus)))
        procs.append(subprocess.Popen(
            [sys.executable, script, *argv, "--rank", str(r)], env=env,
            stdout=sys.stderr, cwd=ROOT,
            preexec_fn=lambda cpus=cpus: os.sched_setaffinity(0, cpus)))
    deadline = time.time() + timeout_s
    rc = 0
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.time() > deadline:
                rc = 1
                break
            time.sleep(0.2)
        rc = rc or max(p.returncode or 0 for p in procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return rc


def main(argv=None) -> int:
    args = parse(argv)
    if args.rank is not None:
        return rank_main(args)
    if not os.path.exists(os.path.join(ROOT, "mgwfbp_tpu_torch")):
        return fail("the program (mgwfbp_tpu_torch) is not in this checkout")
    from benchmark import spec

    try:
        cell = spec.load_cell(ROOT, args.workload)
    except (KeyError, OSError, ValueError) as e:
        return fail(str(e))
    args.workdir = tempfile.mkdtemp(prefix="benchmark-")
    try:
        if cell.ranks > 1:
            argv = ["--workload", args.workload, "--seed", str(args.seed),
                    "--seconds", str(args.seconds), "--trace",
                    str(args.trace), "--device", args.device,
                    "--t-start", repr(T_START), "--workdir", args.workdir]
            rc = launch(os.path.abspath(__file__),
                        argv + (["--fault", args.fault] if args.fault else []),
                        cell.ranks, args.device)
        else:
            args.rank = 0
            rc = rank_main(args)
        path = os.path.join(args.workdir, "result0.json")
        if rc != 0 or not os.path.exists(path):
            return fail(f"a rank failed (rc {rc})")
        with open(path) as f:
            result = json.load(f)
    finally:
        shutil.rmtree(args.workdir, ignore_errors=True)
    from benchmark.drive import forbidden_modules

    stray = sorted(set(result.pop("stray")) | set(forbidden_modules()))
    if stray:
        return fail(f"forbidden modules loaded: {', '.join(stray)}")
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
