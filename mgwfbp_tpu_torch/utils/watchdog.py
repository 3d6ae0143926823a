"""Training-progress watchdog (counterpart of
``mgwfbp_tpu/utils/watchdog.py``): detect a hung step loop.

A CUDA call or an NCCL collective whose peer is gone can block the step
loop forever with no error. The watchdog turns that silence into a signal:
a daemon thread checks a monotonic heartbeat the loop touches; when no
progress lands within ``timeout_s`` it logs CRITICAL with the stalled
phase, dumps every thread's stack with ``faulthandler`` and, with
``MGWFBP_WATCHDOG_ABORT=1``, exits the process with rc 86 so a supervisor
can stop and point at the dumps instead of the job hanging until someone
kills it.

Knobs: ``MGWFBP_WATCHDOG_S`` (the timeout; unset or 0 disables the
watchdog), ``MGWFBP_WATCHDOG_ABORT=1``, ``MGWFBP_WATCHDOG_COMPILE_S``
(``COMPILE_ALLOW_S``, default 600: the extra deadline of a known-long
silent first-use phase) and ``MGWFBP_WATCHDOG_CKPT_S``
(``CHECKPOINT_ALLOW_S``, default 180: a synchronous checkpoint).

The hot path costs one ``time.monotonic()`` store per step, no lock (a
torn read delays detection by one check at most).
"""

from __future__ import annotations

import faulthandler
import logging
import os
import sys
import threading
import time
from typing import Optional

from mgwfbp_tpu_torch.utils.logging import get_logger
from mgwfbp_tpu_torch.utils.platform import env_float

# the rc of a watchdog abort (runtime/supervisor.py stops on it)
WATCHDOG_RC = 86

# extra deadline for known-long silent phases (seconds): the first step
# (the loader's start-up with the native library's g++ build, cuDNN's and
# cuBLAS's first use), the first evaluation, a synchronous checkpoint
COMPILE_ALLOW_S = env_float("MGWFBP_WATCHDOG_COMPILE_S", 600.0)
CHECKPOINT_ALLOW_S = env_float("MGWFBP_WATCHDOG_CKPT_S", 180.0)


class ProgressWatchdog:
    """Arm around a step loop; ``beat(phase)`` from the loop body.

    ``on_stall(phase=, idle_s=, timeout_s=, abort=)`` is called from the
    watcher thread each time the deadline fires, after the stack dump and
    before a configured abort; its own failure never masks the signal."""

    def __init__(
        self,
        timeout_s: Optional[float] = None,
        abort: Optional[bool] = None,
        check_interval_s: float = 10.0,
        on_stall=None,
    ):
        self.timeout_s = (timeout_s if timeout_s is not None
                          else env_float("MGWFBP_WATCHDOG_S", 0.0))
        self.abort = (abort if abort is not None
                      else os.environ.get("MGWFBP_WATCHDOG_ABORT") == "1")
        self.check_interval_s = check_interval_s
        self.on_stall = on_stall
        self.log = get_logger("mgwfbp.watchdog")
        self._last = time.monotonic()
        self._phase = "startup"
        self._allow = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired = False

    @property
    def enabled(self) -> bool:
        return self.timeout_s > 0

    # mgwfbp: thread-safe -- lock-free heartbeat by design: stores are
    # GIL-atomic and the watcher tolerates one stale or lenient check (the
    # _last/_allow ordering below); a lock here would let a wedged holder
    # stall the very thread meant to detect wedges
    def beat(self, phase: str = "step", allow_s: float = 0.0) -> None:
        """Record progress. ``allow_s`` extends the deadline of the phase
        being entered (a known-long silent phase) until the next beat."""
        self._phase = phase
        # _last strictly before _allow: a watcher waking mid-beat sees the
        # fresh time with the old (larger) allowance, one lenient check,
        # never a stale time with no allowance (an abort of a healthy run)
        self._last = time.monotonic()
        self._allow = max(float(allow_s), 0.0)

    def _dump_all_stacks(self) -> None:
        """faulthandler dump of every thread to stderr and to the log files
        the trainer and the watchdog have open: the post-mortem of a call
        that cannot be interrupted from Python."""
        streams = [sys.stderr]
        for name in ("mgwfbp.trainer", "mgwfbp.watchdog"):
            for h in logging.getLogger(name).handlers:
                stream = getattr(h, "stream", None)
                if stream is not None and stream not in streams:
                    streams.append(stream)
        for s in streams:
            try:
                s.write(f"\n== watchdog stall in {self._phase!r}: "
                        "all-thread traceback dump ==\n")
                # faulthandler writes to the fd, past Python's buffer: flush
                # the banner first so it lands before the tracebacks
                s.flush()
                faulthandler.dump_traceback(file=s, all_threads=True)
                s.flush()
            except Exception:  # noqa: BLE001 — a closed stream must not
                # mask the other targets or the abort
                continue

    def _watch(self) -> None:
        while not self._stop.wait(min(self.check_interval_s, self.timeout_s)):
            idle = time.monotonic() - self._last
            if idle > self.timeout_s + self._allow:
                self.fired = True
                self.log.critical(
                    "no training progress for %.0f s (stalled in %r; "
                    "timeout %.0f s): a wedged card, a collective whose peer "
                    "is gone or a blocked host call%s", idle, self._phase,
                    self.timeout_s,
                    "; aborting (MGWFBP_WATCHDOG_ABORT=1)" if self.abort
                    else "",
                )
                self._dump_all_stacks()
                if self.on_stall is not None:
                    try:
                        self.on_stall(phase=self._phase, idle_s=float(idle),
                                      timeout_s=float(self.timeout_s),
                                      abort=bool(self.abort))
                    except Exception:  # noqa: BLE001 — the stall signal
                        # must never be masked by its own reporting
                        self.log.exception("watchdog on_stall hook failed")
                if self.abort:
                    # the stalled call cannot be interrupted from Python:
                    # leaving the process hands control to the supervisor
                    os._exit(WATCHDOG_RC)
                self.beat(self._phase)  # re-arm: warn periodically

    def __enter__(self) -> "ProgressWatchdog":
        if self.enabled:
            self.beat("startup")
            self._thread = threading.Thread(target=self._watch, daemon=True,
                                            name="mgwfbp-watchdog")
            self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)


# ---------------------------------------------------------------------------
# the exit trace: where a process's teardown spends its time
# ---------------------------------------------------------------------------

# seconds between samples of the main thread's stack; unset or 0 disarms
# the exit trace (``exit_mark`` then writes nothing)
STACK_SAMPLE_ENV = "MGWFBP_STACK_SAMPLE_S"
EXIT_TRACE_PREFIX = "mgwfbp exit trace:"


def _trace_armed() -> bool:
    return env_float(STACK_SAMPLE_ENV, 0.0) > 0.0


def exit_mark(what: str) -> None:
    """With ``MGWFBP_STACK_SAMPLE_S`` set, one stderr line placing a step of
    the process's teardown in time (monotonic and wall seconds), to be read
    beside NCCL's own timestamped lines when a survivor of a dead peer is
    slow to leave."""
    if _trace_armed():
        print(f"{EXIT_TRACE_PREFIX} {what} monotonic {time.monotonic():.3f} "
              f"wall {time.time():.3f}", file=sys.stderr, flush=True)


def _sample(main_ident: int, interval_s: float) -> None:
    while True:
        time.sleep(interval_s)
        frame = sys._current_frames().get(main_ident)
        if frame is None or not _trace_armed():
            return
        where = " <- ".join(
            f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno} "
            f"{f.f_code.co_name}"
            for f in _innermost(frame, 4))
        exit_mark(f"main thread at {where}")


def _innermost(frame, n: int) -> list:
    out = []
    while frame is not None and len(out) < n:
        out.append(frame)
        frame = frame.f_back
    return out


def start_stack_sampler() -> Optional[threading.Thread]:
    """With ``MGWFBP_STACK_SAMPLE_S`` set: a daemon thread that writes the
    main thread's innermost frames every that many seconds as an
    ``exit_mark`` line (where a blocked teardown waits), until the main
    thread ends or the variable is unset; None otherwise."""
    if not _trace_armed():
        return None
    t = threading.Thread(
        target=_sample, name="mgwfbp-stack-sampler", daemon=True,
        args=(threading.main_thread().ident, env_float(STACK_SAMPLE_ENV, 0.0)))
    t.start()
    return t
