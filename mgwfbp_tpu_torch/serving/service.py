"""Request plane: bounded queue + dispatcher thread (micro-batching).

Port of ``mgwfbp_tpu/serving/service.py``; the packer and the stats are
the reference's, line for line. Out-of-vocabulary token ids are answered
as the reference answers them (200, NaN rows: see
``models.transformer.take_fill``).

Continuous micro-batching in the MG-WFBP spirit — never compute with an
idle slot you could have filled, never wait longer than the deadline to
fill it: handler threads park requests on a bounded queue; one
dispatcher thread packs them into the next fixed ``max_batch`` slot and
flushes when the slot is full OR the oldest parked request has waited
``flush_ms`` (deadline-or-full). One forward shape, one live
snapshot per flush — every response in a batch carries the same
``served_step`` by construction.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np

from mgwfbp_tpu_torch.serving.model import ServingModel
from mgwfbp_tpu_torch.utils.logging import get_logger

SERVE_FLUSH_MS_ENV = "MGWFBP_SERVE_FLUSH_MS"
SERVE_QUEUE_ENV = "MGWFBP_SERVE_QUEUE"
DEFAULT_FLUSH_MS = 20.0
DEFAULT_QUEUE_LIMIT = 64

# a request parked longer than this has lost its client; the bound also
# keeps handler threads from accumulating forever if the dispatcher dies
_REQUEST_TIMEOUT_S = 30.0

# serve_stats cadence: the dispatcher emits at most one snapshot per
# interval, so a hot request plane cannot flood the telemetry stream
_STATS_INTERVAL_S = 1.0

# latency quantile window (recent requests)
_LATENCY_WINDOW = 256

log = get_logger("mgwfbp.serving.service")


def _env_float(name: str, default: float) -> float:
    raw = (os.environ.get(name) or "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


class _Pending:
    """One parked request: the handler thread blocks on `done` until the
    dispatcher fills (code, doc) and sets it."""

    __slots__ = ("x", "n", "t0", "done", "code", "doc")

    def __init__(self, x: np.ndarray):
        self.x = x
        self.n = int(x.shape[0])
        self.t0 = time.monotonic()
        self.done = threading.Event()
        self.code = 500
        self.doc: dict = {"error": "dispatcher dropped the request"}


class PredictService:
    """The POST /predict backend (TelemetryServer.attach_predict)."""

    def __init__(
        self,
        model: ServingModel,
        *,
        flush_ms: Optional[float] = None,
        queue_limit: Optional[int] = None,
        emit: Optional[Callable[[str, dict], None]] = None,
    ):
        self.model = model
        self.max_batch = model.max_batch
        self._flush_s = (
            flush_ms if flush_ms is not None
            else _env_float(SERVE_FLUSH_MS_ENV, DEFAULT_FLUSH_MS)
        ) / 1000.0
        limit = int(
            queue_limit if queue_limit is not None
            else _env_float(SERVE_QUEUE_ENV, DEFAULT_QUEUE_LIMIT)
        )
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, limit))
        self._emit = emit
        # a request the packer pulled but could not fit into the flushing
        # slot; owned by the dispatcher thread alone (never touched by a
        # handler thread), so it needs no lock
        self._carry: Optional[_Pending] = None
        # rolling stats shared between the dispatcher (writer) and the
        # handler/report threads (`stats()` readers)
        self._stats_lock = threading.Lock()
        self._requests = 0
        self._batches = 0
        self._fill_sum = 0.0
        self._fill_n = 0
        self._latencies: list[float] = []
        self._last_stats_emit = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="mgwfbp-serve-dispatch", daemon=True
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
        # fail anything still parked so no handler thread waits out the
        # full request timeout against a dead dispatcher
        drained = []
        if self._carry is not None:
            drained.append(self._carry)
            # _carry is dispatcher-owned; this write runs after
            # _stop.set() + thread.join(), so the dispatcher has exited
            # (or, past the join timeout, is wedged inside a forward and
            # will never touch _carry again before process exit)
            self._carry = None
        while True:
            try:
                drained.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for p in drained:
            p.code, p.doc = 503, {"error": "serving plane shut down"}
            p.done.set()

    # -- handler-thread side -----------------------------------------------
    def handle(self, inputs) -> tuple[int, dict]:
        """One /predict request (runs on an HTTP handler thread).
        Returns (http status, response doc)."""
        if self.model.snapshot() is None:
            return 503, {"error": "no checkpoint served yet"}
        try:
            x = np.asarray(inputs, self.model.input_np_dtype)
        except (TypeError, ValueError) as e:
            return 400, {"error": f"inputs not coercible to a batch: {e}"}
        want = tuple(self.model.meta.input_shape)
        if x.ndim == len(want) and tuple(x.shape) == want:
            x = x[None]  # single example rides as a batch of one
        if x.ndim != len(want) + 1 or tuple(x.shape[1:]) != want:
            return 400, {
                "error": f"inputs must be (n, {', '.join(map(str, want))})"
                         f" or a single example, got {tuple(x.shape)}"
            }
        if not 1 <= x.shape[0] <= self.max_batch:
            return 400, {
                "error": f"batch of {x.shape[0]} exceeds the serve slot "
                         f"({self.max_batch}); split the request"
            }
        pending = _Pending(x)
        try:
            self._queue.put_nowait(pending)
        except queue.Full:
            return 429, {
                "error": "request queue full; retry with backoff",
                "queue_limit": self._queue.maxsize,
            }
        if not pending.done.wait(_REQUEST_TIMEOUT_S):
            return 504, {"error": "request timed out in the batch queue"}
        return pending.code, pending.doc

    # -- dispatcher thread ---------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            batch = self._gather()
            if batch:
                self._flush(batch)

    def _gather(self) -> list[_Pending]:
        """Deadline-or-full packing: block for a first request, then keep
        pulling until the slot is full or `flush_ms` has passed since the
        first arrival. A request that would overflow the slot is carried
        into the NEXT batch (never split, never reordered)."""
        batch: list[_Pending] = []
        n = 0
        if self._carry is not None:
            batch.append(self._carry)
            n = self._carry.n
            self._carry = None
        else:
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                return []
            batch.append(first)
            n = first.n
        deadline = time.monotonic() + self._flush_s
        while n < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if n + nxt.n > self.max_batch:
                self._carry = nxt
                break
            batch.append(nxt)
            n += nxt.n
        return batch

    def _flush(self, batch: list[_Pending]) -> None:
        now = time.monotonic()
        n = sum(p.n for p in batch)
        try:
            outs, step = self.model.run_padded(
                np.concatenate([p.x for p in batch], axis=0)
            )
        except Exception as e:  # noqa: BLE001 — a bad batch must answer,
            # not kill the dispatcher thread (the request plane outlives
            # any single failed flush)
            log.warning("predict flush failed: %s", e)
            for p in batch:
                p.code, p.doc = 500, {"error": f"forward failed: {e}"}
                p.done.set()
            return
        off = 0
        done = time.monotonic()
        for p in batch:
            p.code = 200
            p.doc = {
                "outputs": outs[off:off + p.n].tolist(),
                "served_step": int(step),
            }
            off += p.n
            p.done.set()
        with self._stats_lock:
            self._requests += len(batch)
            self._batches += 1
            self._fill_sum += n / self.max_batch
            self._fill_n += 1
            for p in batch:
                self._latencies.append(done - p.t0)
            del self._latencies[:-_LATENCY_WINDOW]
            snap = (
                self._stats_locked()
                if (self._emit is not None
                    and now - self._last_stats_emit >= _STATS_INTERVAL_S)
                else None
            )
            if snap is not None:
                self._last_stats_emit = now
        if snap is not None:
            try:
                self._emit("serve_stats", snap)
            except Exception as e:  # noqa: BLE001 — telemetry must not
                # take down the request plane
                log.warning("serve_stats emit failed: %s", e)

    # -- stats ---------------------------------------------------------------
    def _stats_locked(self) -> dict:
        lats = sorted(self._latencies)

        def q(p: float) -> float:
            if not lats:
                return 0.0
            return lats[min(len(lats) - 1, int(p * len(lats)))]

        fill = self._fill_sum / self._fill_n if self._fill_n else 0.0
        return {
            "requests": int(self._requests),
            "queue_depth": int(self._queue.qsize()),
            "batch_fill": round(fill, 4),
            "batches": int(self._batches),
            "latency_p50_s": round(q(0.50), 6),
            "latency_p95_s": round(q(0.95), 6),
            "latency_p99_s": round(q(0.99), 6),
        }

    def stats(self) -> dict:
        with self._stats_lock:
            return self._stats_locked()
