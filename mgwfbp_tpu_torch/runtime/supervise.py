"""``python -m mgwfbp_tpu_torch.runtime.supervise``: launch a coordinated
training group under the supervisor (counterpart of
``mgwfbp_tpu/runtime/supervise.py``, same flags and defaults).

    python -m mgwfbp_tpu_torch.runtime.supervise --processes 2 -- \\
        --dnn lenet --synthetic --device cpu --telemetry --logdir logs \\
        --checkpoint-dir checkpoints --ckpt-every-steps 25
    MGWFBP_METRICS_PORT=0 python -m mgwfbp_tpu_torch.runtime.supervise \\
        --processes 1 --log-dir sup -- --dnn resnet20 --synthetic \\
        --checkpoint-dir checkpoints --ckpt-every-steps 5

Everything after ``--`` goes to ``mgwfbp_tpu_torch.train_cli`` verbatim;
every child gets MGWFBP_COORDINATOR / MGWFBP_NUM_PROCESSES /
MGWFBP_PROCESS_ID / MGWFBP_INCARNATION. One process per card: a group of
several processes on a one-card machine runs ``--device cpu`` (gloo), as
NCCL takes one rank per card and the launcher refuses more ranks than
cards. rc 75 resubmits the group with a bounded backoff, rc 86 (a watchdog
abort) stops and names the stack dumps, hard failures heal by default
(crashes relaunch at the same world, SIGKILLs shrink to the survivors,
children whose /status step froze are drained and relaunched) under
per-class budgets; ``--no-heal`` tears down and propagates.
``MGWFBP_METRICS_PORT`` (0: ephemeral) turns on the children's live
plane, which the liveness monitor scrapes; ``--fleet-port`` serves the
fan-in over it (/fleet/metrics, /fleet/status, /fleet/profile).
"""

from __future__ import annotations

import argparse
import shlex
import sys
from typing import Optional

from mgwfbp_tpu_torch.runtime.supervisor import (
    Supervisor,
    default_serve_cmd,
    default_train_cmd,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mgwfbp-supervise-torch",
        description="multi-process training group supervisor (resubmit on "
                    "rc 75, stop on rc 86, heal hard failures)",
    )
    p.add_argument("--processes", type=int, required=True,
                   help="process-group size (MGWFBP_NUM_PROCESSES)")
    p.add_argument("--max-restarts", dest="max_restarts", type=int,
                   default=3,
                   help="resubmission budget for preempted (rc 75) groups")
    p.add_argument("--backoff-base", dest="backoff_base", type=float,
                   default=1.0,
                   help="first resubmit delay in seconds (doubles per "
                        "restart, capped by --backoff-max)")
    p.add_argument("--backoff-max", dest="backoff_max", type=float,
                   default=60.0)
    p.add_argument("--grace", type=float, default=10.0,
                   help="seconds between SIGTERM and SIGKILL when tearing "
                        "down stragglers")
    p.add_argument("--drain-grace", dest="drain_grace", type=float,
                   default=120.0,
                   help="seconds peers get to finish their agreed drain "
                        "after the first rc-75 exit")
    p.add_argument("--log-dir", dest="log_dir", default=None,
                   help="capture each child's stdout+stderr to "
                        "<log-dir>/p<idx>.i<incarnation>.log, and write "
                        "telemetry.supervisor.jsonl and fleet.json there "
                        "(default: inherit this terminal)")
    p.add_argument("--port", type=int, default=None,
                   help="coordinator port (default: a free one per "
                        "incarnation)")
    p.add_argument("--fleet-port", dest="fleet_port", type=int,
                   default=None,
                   help="serve the live fan-in (/fleet/metrics, "
                        "/fleet/status, /fleet/profile) on this port; 0 = "
                        "ephemeral (logged); needs MGWFBP_METRICS_PORT for "
                        "the children")
    p.add_argument("--fleet-file", dest="fleet_file", default=None,
                   help="persist the children's bound metrics endpoints "
                        "here in Prometheus http_sd format (default: "
                        "<log-dir>/fleet.json when --log-dir is set)")
    p.add_argument("--resize-to", dest="resize_to", type=int, default=None,
                   help="elastic resize: relaunch the group at this many "
                        "processes at the next drain. With "
                        "MGWFBP_METRICS_PORT set the supervisor drains the "
                        "group itself (SIGTERM once a child reports a "
                        "completed step); the relaunch resumes from the "
                        "exact step at the new world")
    p.add_argument("--serve-replicas", dest="serve_replicas", type=int,
                   default=0,
                   help="spawn this many hot-reload serving replicas "
                        "(python -m mgwfbp_tpu_torch.serving) beside the "
                        "training group for the whole supervisor run; a "
                        "dead replica respawns under --serve-max-restarts")
    p.add_argument("--serve-args", dest="serve_args", default=None,
                   help="arguments for the serving CLI, one shell-quoted "
                        "string (e.g. --serve-args '--dnn transformer "
                        "--checkpoint-dir ckpts/<tag>')")
    p.add_argument("--no-heal", dest="heal", action="store_false",
                   default=True,
                   help="disable self-healing: a hard child failure tears "
                        "the group down and propagates its rc")
    p.add_argument("--heal-max-restarts", dest="heal_max_restarts",
                   type=int, default=2,
                   help="per-failure-class healing budget (crash, "
                        "oom_kill, wedged, ... each get this many "
                        "relaunches before the supervisor gives up)")
    p.add_argument("--liveness-grace", dest="liveness_grace", type=float,
                   default=None,
                   help="seconds a child's /status step may stay frozen "
                        "(or its endpoint unreachable) before it is "
                        "declared wedged and the group is healed "
                        "(default: MGWFBP_LIVENESS_GRACE_S or 120)")
    p.add_argument("--serve-max-restarts", dest="serve_max_restarts",
                   type=int, default=3,
                   help="per-replica respawn budget for dead serve "
                        "replicas (backoff-spaced; spent = the replica "
                        "stays down)")
    p.add_argument("train_args", nargs=argparse.REMAINDER,
                   help="arguments for mgwfbp_tpu_torch.train_cli (prefix "
                        "with --)")
    return p


def main(argv: Optional[list[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    train_args = args.train_args
    if train_args and train_args[0] == "--":
        train_args = train_args[1:]
    sup = Supervisor(
        default_train_cmd(train_args),
        args.processes,
        max_restarts=args.max_restarts,
        backoff_base_s=args.backoff_base,
        backoff_max_s=args.backoff_max,
        grace_s=args.grace,
        drain_grace_s=args.drain_grace,
        log_dir=args.log_dir,
        port=args.port,
        fleet_port=args.fleet_port,
        fleet_file=args.fleet_file,
        resize_to=args.resize_to,
        serve_replicas=args.serve_replicas,
        serve_cmd=(
            default_serve_cmd(shlex.split(args.serve_args or ""))
            if args.serve_replicas else None
        ),
        heal=args.heal,
        heal_max_restarts=args.heal_max_restarts,
        liveness_grace_s=args.liveness_grace,
        serve_max_restarts=args.serve_max_restarts,
    )
    return sup.run()


if __name__ == "__main__":
    sys.exit(main())
