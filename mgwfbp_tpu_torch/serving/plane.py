"""ServePlane: the assembled serving subsystem behind one seam.

Port of ``mgwfbp_tpu/serving/plane.py``. Composition only — model plane
(ServingModel) + reload watcher + request dispatcher (PredictService),
wired to one ``emit(event, fields)`` sink and optionally attached to a
TelemetryServer's POST /predict route. The shadow scorer is not ported yet
(ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import Callable, Optional

from mgwfbp_tpu_torch.serving.model import ServingModel
from mgwfbp_tpu_torch.serving.service import PredictService
from mgwfbp_tpu_torch.serving.watch import DEFAULT_POLL_S, ReloadWatcher
from mgwfbp_tpu_torch.utils.logging import get_logger

log = get_logger("mgwfbp.serving.plane")


class ServePlane:
    def __init__(
        self,
        model: ServingModel,
        checkpoint_dir: str,
        *,
        emit: Optional[Callable[[str, dict], None]] = None,
        server=None,
        shadow: bool = False,
        poll_s: float = DEFAULT_POLL_S,
        flush_ms: Optional[float] = None,
        queue_limit: Optional[int] = None,
    ):
        if shadow:
            raise NotImplementedError(
                "shadow scoring is not ported yet (ROADMAP.md Queue 1: "
                "'Shadow scorer')"
            )
        self.model = model
        self.service = PredictService(
            model, flush_ms=flush_ms, queue_limit=queue_limit, emit=emit
        )
        self.watcher = ReloadWatcher(
            model, checkpoint_dir, poll_s=poll_s, emit=emit
        )
        self._server = server
        if server is not None:
            server.attach_predict(self.service)
        self._closed = False

    def start(self) -> None:
        """Open for business: dispatcher first (requests already routed
        here 503 until a snapshot lands), then the reload watcher."""
        self.service.start()
        self.watcher.start()

    def poll_now(self) -> Optional[int]:
        """Synchronous reload check (startup waits and tests)."""
        return self.watcher.poll_once()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._server is not None:
            self._server.attach_predict(None)  # /predict answers 503 again
        self.watcher.close()
        self.service.close()
