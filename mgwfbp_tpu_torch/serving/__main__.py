"""Standalone serving replica: ``python -m mgwfbp_tpu_torch.serving``.

One process = one replica: builds the ServingModel for a named model on
one device (``--device``, default ``cuda``), watches a checkpoint directory
for committed shard-native steps (written by either package), and serves
POST /predict plus /healthz and /status on the role-aware port
(``base + serve offset + replica``); /status also carries the replica's
flash kernel launches (``kernel_launches``). The supervisor runs replicas
under ``--serve-replicas`` and respawns a dead one.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading
import time
from typing import Optional

from mgwfbp_tpu_torch.serving.watch import DEFAULT_POLL_S
from mgwfbp_tpu_torch.utils.logging import get_logger

SERVE_REPLICA_ENV = "MGWFBP_SERVE_REPLICA"

log = get_logger("mgwfbp.serving")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mgwfbp_tpu_torch.serving",
        description="standalone serving replica (hot-reload + /predict)",
    )
    p.add_argument("--dnn", required=True, help="model name (models registry)")
    p.add_argument("--dataset", default=None,
                   help="dataset override (retargets classes)")
    p.add_argument("--checkpoint-dir", required=True,
                   help="checkpoint directory to watch for committed steps")
    p.add_argument("--device", default="cuda",
                   help="device to serve on: cuda (default; fails without a "
                        "card) or cpu")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="base metrics port (default: MGWFBP_METRICS_PORT; "
                        "the replica serves base + serve offset + replica)")
    p.add_argument("--replica", type=int, default=None,
                   help=f"replica index (default: {SERVE_REPLICA_ENV} or 0)")
    p.add_argument("--max-batch", type=int, default=None,
                   help="batch slot size (default: MGWFBP_SERVE_MAX_BATCH)")
    p.add_argument("--flush-ms", type=float, default=None,
                   help="micro-batch flush deadline "
                        "(default: MGWFBP_SERVE_FLUSH_MS)")
    p.add_argument("--queue-limit", type=int, default=None,
                   help="bounded request queue size "
                        "(default: MGWFBP_SERVE_QUEUE)")
    p.add_argument("--poll-s", type=float, default=DEFAULT_POLL_S,
                   help="checkpoint poll interval")
    p.add_argument("--max-seconds", type=float, default=None,
                   help="exit after this long (smokes/tests; default: run "
                        "until SIGTERM/SIGINT)")
    return p


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    from mgwfbp_tpu_torch import models
    from mgwfbp_tpu_torch.serving.model import ServingModel
    from mgwfbp_tpu_torch.serving.plane import ServePlane
    from mgwfbp_tpu_torch.telemetry.serve import (
        METRICS_PORT_ENV,
        MetricsAggregator,
        start_metrics_server,
    )
    from mgwfbp_tpu_torch.utils.device import set_matmul_precision

    set_matmul_precision(None, log=log)  # the served forward is float32

    replica = (
        args.replica if args.replica is not None
        else int(os.environ.get(SERVE_REPLICA_ENV) or 0)
    )
    module, meta = models.create_model(args.dnn, dataset=args.dataset)
    model = ServingModel(module, meta, device=args.device,
                         max_batch=args.max_batch)

    run = {
        "role": "serve",
        "replica": int(replica),
        "dnn": meta.name,
        "dataset": meta.dataset,
        "checkpoint_dir": args.checkpoint_dir,
        "max_batch": model.max_batch,
        "device": str(model.device),
    }
    from mgwfbp_tpu_torch.ops import flash_attention

    # the replica's flash kernel launches, read per /status request (a
    # supervised replica is another process: this is how its launches are
    # counted)
    agg = MetricsAggregator(run=run, extra_status=lambda: {
        "kernel_launches": {"flash_attention_fwd": flash_attention.launches},
    })
    base_port = (
        args.metrics_port if args.metrics_port is not None
        else (int(os.environ[METRICS_PORT_ENV])
              if os.environ.get(METRICS_PORT_ENV) else None)
    )
    server = start_metrics_server(agg, base_port, replica, role="serve")
    plane = ServePlane(
        model,
        args.checkpoint_dir,
        emit=agg.observe,
        server=server,
        poll_s=args.poll_s,
        flush_ms=args.flush_ms,
        queue_limit=args.queue_limit,
    )

    stop = threading.Event()
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: stop.set())

    plane.start()
    log.info(
        "serving replica %d: %s on %s watching %r (slot %d)%s",
        replica, meta.name, model.device, args.checkpoint_dir,
        model.max_batch,
        f" on port {server.port}" if server is not None else "",
    )
    deadline = (
        time.monotonic() + args.max_seconds
        if args.max_seconds is not None else None
    )
    try:
        while not stop.wait(0.2):
            if deadline is not None and time.monotonic() >= deadline:
                break
    finally:
        plane.close()
        if server is not None:
            server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
