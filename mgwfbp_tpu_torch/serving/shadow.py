"""Shadow-eval: score a deterministic held-out stream per reload (a copy
of ``mgwfbp_tpu/serving/shadow.py``).

Every newly served checkpoint is scored against the same fixed synthetic
held-out batches, drawn host-side with numpy from one seed exactly as the
JAX scorer draws them, so two replicas, two runs or the two packages
score identical data and their ``shadow_eval`` series compare. The score
rides the telemetry stream and renders as the served-vs-training loss
gauges (``mgwfbp_shadow_eval_loss`` / ``_delta``). The loss is taken in
float64 on the host from the served logits.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from mgwfbp_tpu_torch.serving.model import LiveSnapshot, ServingModel
from mgwfbp_tpu_torch.utils.logging import get_logger

DEFAULT_SHADOW_BATCHES = 2
DEFAULT_SHADOW_SEED = 20190227  # MG-WFBP's INFOCOM day; any fixed value

log = get_logger("mgwfbp.serving.shadow")


class ShadowScorer:
    """Cross-entropy over fixed synthetic batches (classify models).

    Non-classify tasks are not scored (logged once, `score` returns
    None) — /predict still serves them; shadow-eval is simply dark.
    """

    def __init__(
        self,
        model: ServingModel,
        *,
        batches: int = DEFAULT_SHADOW_BATCHES,
        seed: int = DEFAULT_SHADOW_SEED,
        emit: Optional[Callable[[str, dict], None]] = None,
        train_loss_fn: Optional[Callable[[], Optional[float]]] = None,
    ):
        self.model = model
        self._emit = emit
        self._train_loss_fn = train_loss_fn
        self.supported = model.meta.task == "classify"
        if not self.supported:
            log.info(
                "shadow-eval dark for task %r (classify only); "
                "/predict serves regardless", model.meta.task,
            )
            self._data: list = []
            return
        rng = np.random.default_rng(seed)
        b = model.max_batch
        shape = (b,) + tuple(model.meta.input_shape)
        self._data = [
            (
                rng.standard_normal(shape).astype(model.input_np_dtype),
                rng.integers(0, model.meta.num_classes, size=b),
            )
            for _ in range(max(1, int(batches)))
        ]

    def score(self, snap: LiveSnapshot) -> Optional[float]:
        """Mean cross-entropy of the held-out stream against the served
        snapshot; emits the `shadow_eval` event (train_loss riding along
        when the provider knows it)."""
        if not self.supported:
            return None
        losses = []
        for x, labels in self._data:
            logits, step = self.model.run_padded(x)
            if step != snap.step:
                # a newer reload landed mid-score; the fresher snapshot
                # will be scored by its own reload callback
                return None
            logits = np.asarray(logits, np.float64)
            m = logits.max(axis=-1, keepdims=True)
            lse = m[:, 0] + np.log(np.exp(logits - m).sum(axis=-1))
            losses.append(
                float(np.mean(lse - logits[np.arange(len(labels)), labels]))
            )
        loss = float(np.mean(losses))
        fields: dict = {"step": int(snap.step), "loss": round(loss, 6)}
        if self._train_loss_fn is not None:
            train_loss = self._train_loss_fn()
            if train_loss is not None:
                fields["train_loss"] = float(train_loss)
        if self._emit is not None:
            try:
                self._emit("shadow_eval", fields)
            except Exception as e:  # noqa: BLE001 — scoring is advisory
                log.warning("shadow_eval emit failed: %s", e)
        return loss
