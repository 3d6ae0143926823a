"""Hostname-tagged logging with run-config tags.

Parity with the reference's logger setup (settings.py:42-53: formatter with
hostname, file+stream handlers) and its PREFIX run-tagging scheme
(settings.py:7-40: a string concatenated from the active feature flags so
every log line/dir identifies the experiment; dist_trainer.py:127-141 encodes
the full config in the log-dir name).
"""

from __future__ import annotations

import logging
import os
import socket
from typing import Mapping, Optional

_FMT = "%(asctime)s [{host}] %(levelname)s %(name)s: %(message)s"


def get_logger(
    name: str = "mgwfbp",
    logfile: Optional[str] = None,
    level: int = logging.INFO,
) -> logging.Logger:
    """Stream + optional file logger. Safe to call repeatedly: a second call
    with a DIFFERENT logfile (e.g. two Trainer runs in one process) swaps the
    file handler to the new path instead of silently logging to the old one.
    """
    logger = logging.getLogger(name)
    fmt = logging.Formatter(_FMT.format(host=socket.gethostname()))
    if not getattr(logger, "_mgwfbp_configured", False):
        logger.setLevel(level)
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        logger.propagate = False
        logger._mgwfbp_configured = True  # type: ignore[attr-defined]
    current = getattr(logger, "_mgwfbp_logfile", None)
    if logfile != current:
        for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
            logger.removeHandler(h)
            h.close()
        if logfile:
            os.makedirs(os.path.dirname(logfile) or ".", exist_ok=True)
            fh = logging.FileHandler(logfile)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
        logger._mgwfbp_logfile = logfile  # type: ignore[attr-defined]
    return logger


def run_tag(cfg: Mapping[str, object]) -> str:
    """Deterministic experiment tag from config entries, e.g.
    'resnet20-cifar10-n8-bs32-lr0.1-mgwfbp' (reference PREFIX +
    dist_trainer.py:127-128 dir naming)."""
    parts = []
    for k in ("dnn", "dataset", "nworkers", "batch_size", "lr", "policy",
              "threshold", "seed"):
        if k in cfg and cfg[k] is not None:
            v = cfg[k]
            prefix = {"nworkers": "n", "batch_size": "bs", "lr": "lr",
                      "threshold": "th", "seed": "s"}.get(k, "")
            parts.append(f"{prefix}{v}")
    return "-".join(str(p) for p in parts) if parts else "run"
