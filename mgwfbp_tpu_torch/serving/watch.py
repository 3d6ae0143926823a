"""Hot-reload watcher: committed checkpoint steps -> live param swaps.

Port of ``mgwfbp_tpu/serving/watch.py``, with its polls serialized by a
lock. Polls the checkpoint directory for newly COMMITTED shard-native
steps (manifest present — the atomic manifest rename is the visibility
barrier, so a step this watcher sees is always fully readable) and
installs the newest one into the ServingModel.
The only device work on this thread is copying the new weights to the
serving device — no collectives.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from mgwfbp_tpu_torch.checkpoint import CheckpointRestoreError
from mgwfbp_tpu_torch.serving.model import (
    LiveSnapshot,
    ServingModel,
    committed_sharded_steps,
    open_committed_step,
)
from mgwfbp_tpu_torch.utils.logging import get_logger

DEFAULT_POLL_S = 0.25

# a step that failed to load this many times is skipped for good (the
# next committed step supersedes it anyway); without the cap a corrupt
# directory would hot-loop the watcher forever
_MAX_LOAD_ATTEMPTS = 3

log = get_logger("mgwfbp.serving.watch")


class ReloadWatcher:
    """Background poller driving ServingModel hot-reloads.

    ``poll_once`` is also the synchronous entry point (tests and the
    standalone CLI's startup wait call it directly); the background
    thread just runs it on a cadence.
    """

    def __init__(
        self,
        model: ServingModel,
        directory: str,
        *,
        poll_s: float = DEFAULT_POLL_S,
        emit: Optional[Callable[[str, dict], None]] = None,
        on_reload: Optional[Callable[[LiveSnapshot], None]] = None,
    ):
        self.model = model
        self.directory = directory
        self._poll_s = float(poll_s)
        self._emit = emit
        self._on_reload = on_reload
        # polls are serialized: a poll_now() racing the watcher thread
        # would otherwise load the same step twice, or install an older
        # step over a newer one; the lock also guards the load-failure
        # ledger
        self._poll_lock = threading.Lock()
        self._failed: dict[int, int] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="mgwfbp-serve-reload", daemon=True
        )
        self._started = False

    def start(self) -> None:
        if not self._started:
            self._started = True
            self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._started:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — the watcher must
                # survive any single bad poll (torn directory, transient
                # I/O); the next committed step gets a fresh attempt
                log.warning("reload poll failed: %s", e)

    def poll_once(self) -> Optional[int]:
        """Install the newest committed step if it is newer than the one
        being served. Returns the newly served step, or None when
        nothing changed."""
        with self._poll_lock:
            return self._poll_locked()

    def _poll_locked(self) -> Optional[int]:
        steps = committed_sharded_steps(self.directory)
        current = self.model.served_step()
        target = None
        for step in reversed(steps):
            if current is not None and step <= current:
                break
            if self._failed.get(step, 0) < _MAX_LOAD_ATTEMPTS:
                target = step
                break
        if target is None:
            return None
        t0 = time.monotonic()
        try:
            src, commit_wall = open_committed_step(self.directory, target)
            snap = self.model.install_source(src, target, commit_wall)
        except CheckpointRestoreError as e:
            self._failed[target] = self._failed.get(target, 0) + 1
            log.warning(
                "hot-reload of step %d failed (attempt %d/%d): %s",
                target, self._failed[target], _MAX_LOAD_ATTEMPTS, e,
            )
            return None
        duration = time.monotonic() - t0
        lag = max(0.0, time.time() - snap.commit_wall)
        log.info(
            "hot-reloaded step %d (lag %.3fs, load %.3fs)",
            target, lag, duration,
        )
        if self._emit is not None:
            try:
                self._emit("reload", {
                    "step": int(target),
                    "lag_s": round(lag, 6),
                    "duration_s": round(duration, 6),
                })
            except Exception as e:  # noqa: BLE001 — telemetry must not
                # block the swap
                log.warning("reload emit failed: %s", e)
        if self._on_reload is not None:
            try:
                self._on_reload(snap)
            except Exception as e:  # noqa: BLE001 — the hook is
                # advisory; its failure must not stall reloads
                log.warning("on_reload hook failed: %s", e)
        return int(target)
