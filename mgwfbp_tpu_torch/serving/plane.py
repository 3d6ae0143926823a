"""ServePlane: the assembled serving subsystem behind one seam.

Port of ``mgwfbp_tpu/serving/plane.py``. Composition only — model plane
(ServingModel) + reload watcher + request dispatcher (PredictService) +
shadow scorer (``shadow=True``: every reload is scored on the held-out
stream, ``serving/shadow.py``), wired to one ``emit(event, fields)`` sink
and optionally attached to a TelemetryServer's POST /predict route. The
trainer embeds one in-process (``--serve-shadow``); the standalone CLI
(``serving/__main__.py``) runs one per replica.
"""

from __future__ import annotations

from typing import Callable, Optional

from mgwfbp_tpu_torch.serving.model import ServingModel
from mgwfbp_tpu_torch.serving.service import PredictService
from mgwfbp_tpu_torch.serving.shadow import ShadowScorer
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
        train_loss_fn: Optional[Callable[[], Optional[float]]] = None,
    ):
        self.model = model
        self.service = PredictService(
            model, flush_ms=flush_ms, queue_limit=queue_limit, emit=emit
        )
        self.scorer = (
            ShadowScorer(model, emit=emit, train_loss_fn=train_loss_fn)
            if shadow else None
        )
        self.watcher = ReloadWatcher(
            model, checkpoint_dir, poll_s=poll_s, emit=emit,
            on_reload=self.scorer.score if self.scorer is not None else None,
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
