"""Scalar summary writer — the reference's TensorBoard seam, made live.

The reference scaffolds tensorboardX (`SummaryWriter` construction and
`writer.add_scalar` hooks at dist_trainer.py:19,136-137 and
dl_trainer.py:713-715,753-755) but ships it disabled (`writer = None`). Here
the same seam is a working component: scalars stream to an append-only JSONL
event file next to the run's logs (greppable, no heavyweight dependency), and
when a TensorBoard writer package happens to be installed the same calls
mirror into real event files. The JSONL schema is one object per line:

    {"wall": <unix s>, "step": <int>, "tag": "train/loss", "value": <float>}
"""

from __future__ import annotations

import json
import os
import time


class ScalarWriter:
    """Append-only JSONL scalar event writer with optional TensorBoard
    mirroring (tensorboardX or torch.utils.tensorboard, whichever imports;
    neither is required).

    With `stream` (a telemetry `EventWriter`, telemetry/events.py), this
    becomes a thin VIEW over the run's structured event stream: scalars
    are emitted as typed ``scalar`` records into the same file the step
    spans and overlap snapshots land in (one file per run), and no
    separate events.jsonl is opened. Without it, the legacy standalone
    JSONL layout is preserved (schema v1 of the telemetry stream —
    `telemetry.read_events` migrates it)."""

    def __init__(
        self, logdir: str, filename: str = "events.jsonl", stream=None
    ):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._stream = stream
        self._f = None
        if stream is None:
            self.path = os.path.join(logdir, filename)
            self._f = open(self.path, "a", buffering=1)  # line-buffered
        else:
            self.path = stream.path
        self._tb = self._make_tb_writer(logdir)

    @staticmethod
    def _make_tb_writer(logdir: str):
        for mod, cls in (
            ("tensorboardX", "SummaryWriter"),
            ("torch.utils.tensorboard", "SummaryWriter"),
        ):
            try:
                import importlib

                m = importlib.import_module(mod)
                return getattr(m, cls)(logdir)
            except Exception:  # noqa: BLE001 — optional dependency probing
                continue
        return None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._stream is not None:
            try:
                self._stream.emit(
                    "scalar", tag=tag, value=float(value), step=int(step)
                )
            except (TypeError, ValueError):
                raise  # schema misuse is a bug; surface it
            except Exception:  # noqa: BLE001 — a dying stream (disk full)
                # must not take down the training run; same contract as
                # Trainer._emit_event, which disables its end separately
                self._stream = None
        elif self._f is not None:
            self._f.write(
                json.dumps(
                    {
                        "wall": round(time.time(), 3),
                        "step": int(step),
                        "tag": tag,
                        "value": float(value),
                    }
                )
                + "\n"
            )
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def add_scalars(self, prefix: str, scalars: dict, step: int) -> None:
        for k, v in scalars.items():
            try:
                self.add_scalar(f"{prefix}/{k}", float(v), step)
            except (TypeError, ValueError):
                continue  # non-scalar metric (e.g. nested dict)

    def close(self) -> None:
        # a shared stream is owned by its creator (the trainer), not here
        if self._f is not None and not self._f.closed:
            self._f.close()
        if self._tb is not None:
            try:
                self._tb.close()
            except Exception:  # noqa: BLE001
                pass


def read_events(path: str) -> list[dict]:
    """Load an events.jsonl file back (for tests / offline plotting)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
