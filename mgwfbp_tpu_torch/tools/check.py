"""The port's pre-PR gate: ruff -> static analysis -> THR probe -> telemetry
selftest -> the six fault-smoke lifecycles -> the port's tier-1 tests.

The counterpart of the JAX package's ``tools/check.sh``, over the port and
its tests, runnable where JAX is not installed up to the last stage (the
tier-1 tests hold the port against the JAX package, so they import it).
Any failing stage fails the gate (exit 1); every stage runs. ruff is
skipped with a notice when it is not installed (its configuration lives in
``pyproject.toml``). The fault-smoke lifecycles run on the CPU, each under
its own hard timeout: a coordination, fan-in, reload or heal bug fails as a
hang, which must fail the gate, not wedge it.

Usage:
  python -m mgwfbp_tpu_torch.tools.check [--list]
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LIFECYCLE_TIMEOUT_S = 600  # each fault-smoke lifecycle (check.sh's)
TIER1_TIMEOUT_S = 1470  # the port's tier-1 tests
THR_BIT = 32  # the THR family's exit bit (mgwfbp_tpu_torch.analysis)
TIER1_WORKERS = 4  # pytest-xdist workers of the tier-1 stage (--dist loadfile)

# a thread that pops from a list the main thread appends to, no lock: the
# race checker must fail it with exactly the THR bit
THR_PROBE = '''import threading


class Buf:
    def __init__(self):
        self._rows = []
        self._t = threading.Thread(target=self._drain)
        self._t.start()

    def _drain(self):
        while True:
            self._rows.pop()

    def push(self, x):
        self._rows.append(x)
'''

# (flag, what the lifecycle proves) in check.sh's order
LIFECYCLES = (
    ((), "NaN skip + preempt/resume lifecycle"),
    (("--async-ckpt",), "async checkpoints: step-time envelope vs "
                        "checkpoints off + async event contract"),
    (("--processes", "2"), "2-process agreed drain -> supervisor resubmit "
                           "-> resume; /fleet/status probed mid-run"),
    (("--resize",), "supervisor-triggered drain -> relaunch at 1 process "
                    "from the shard-native checkpoint -> resume"),
    (("--serve",), "--serve-shadow run answers POST /predict mid-run; the "
                   "served step advances; step-time envelope vs serve off"),
    (("--chaos",), "SIGKILL mid-epoch -> shrink to the survivor; wedge -> "
                   "liveness heal in bounded time"),
)


@dataclasses.dataclass
class Stage:
    """One gate stage: ``cmd`` run from the checkout's root, passing when it
    exits ``want_rc`` within ``timeout_s``; ``cmd`` None is a skip with
    ``notice``."""

    name: str
    cmd: Optional[list[str]]
    timeout_s: Optional[float] = None
    want_rc: int = 0
    quiet: bool = False  # stdout discarded (a report nobody reads here)
    notice: str = ""


def port_test_files() -> list[str]:
    return sorted(os.path.relpath(p, ROOT) for p in glob.glob(
        os.path.join(ROOT, "tests", "test_torch_*.py")))


def stages(probe_path: str, ruff: Optional[str] = None) -> list[Stage]:
    """The gate's stages in order; ``probe_path`` is where the THR probe
    is written before it runs, ``ruff`` the ruff binary (None: skipped)."""
    py = sys.executable
    out = [Stage(
        "ruff", [ruff, "check", "mgwfbp_tpu_torch", *port_test_files()]
        if ruff else None,
        notice="ruff not installed; skipping (config lives in "
               "pyproject.toml)")]
    out.append(Stage(
        "mgwfbp_tpu_torch.analysis (jit-safety lint -> THR race checker -> "
        "SPMD lockstep checker -> ANA001 -> observed-step schedule check)",
        [py, "-m", "mgwfbp_tpu_torch.analysis", "--device", "cpu"]))
    out.append(Stage(
        "THR seeded probe (exits with exactly the THR bit)",
        [py, "-m", "mgwfbp_tpu_torch.analysis", "--skip-lint",
         "--skip-spmd", "--skip-step", probe_path],
        want_rc=THR_BIT, quiet=True))
    out.append(Stage(
        "telemetry report smoke (writer -> report -> exports)",
        [py, "-m", "mgwfbp_tpu_torch.tools.telemetry_report", "--selftest"],
        quiet=True))
    for flags, what in LIFECYCLES:
        out.append(Stage(
            f"fault smoke {' '.join(flags) or '(single process)'}: {what}",
            [py, "-m", "mgwfbp_tpu_torch.tools.fault_smoke", "--device",
             "cpu", *flags], timeout_s=LIFECYCLE_TIMEOUT_S))
    out.append(Stage(
        "the port's tier-1 tests",
        [py, "-m", "pytest", *port_test_files(), "-q", "-m", "not slow",
         "-p", "no:cacheprovider", "-p", "no:randomly", "-p", "xdist",
         "-n", str(TIER1_WORKERS), "--dist", "loadfile"],
        timeout_s=TIER1_TIMEOUT_S))
    return out


def run_stage(stage: Stage, env: dict) -> bool:
    if stage.cmd is None:
        print(stage.notice, flush=True)
        return True
    t0 = time.monotonic()
    try:
        rc = subprocess.run(
            stage.cmd, cwd=ROOT, env=env, timeout=stage.timeout_s,
            stdout=subprocess.DEVNULL if stage.quiet else None,
        ).returncode
    except subprocess.TimeoutExpired:
        print(f"FAILED: {stage.name}: no end within {stage.timeout_s:g} s",
              file=sys.stderr, flush=True)
        return False
    secs = time.monotonic() - t0
    if rc != stage.want_rc:
        print(f"FAILED: {stage.name}: exit {rc}, want {stage.want_rc} "
              f"({secs:.1f} s)", file=sys.stderr, flush=True)
        return False
    print(f"passed in {secs:.1f} s", flush=True)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--list", action="store_true",
                    help="print the stages and exit")
    args = ap.parse_args(argv)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    with tempfile.TemporaryDirectory(prefix="mgwfbp_check_") as work:
        probe = os.path.join(work, "thr_probe.py")
        todo = stages(probe, shutil.which("ruff"))
        if args.list:
            for i, stage in enumerate(todo, 1):
                print(f"[{i}/{len(todo)}] {stage.name}")
            return 0
        with open(probe, "w") as f:
            f.write(THR_PROBE)
        ok = True
        for i, stage in enumerate(todo, 1):
            print(f"== [{i}/{len(todo)}] {stage.name} ==", flush=True)
            ok = run_stage(stage, env) and ok
    if ok:
        print("check: ALL GREEN")
        return 0
    print("check: FAILURES (see above)", file=sys.stderr)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
