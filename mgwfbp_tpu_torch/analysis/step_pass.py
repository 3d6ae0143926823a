"""The step pass of ``python -m mgwfbp_tpu_torch.analysis`` (the
counterpart of the JAX CLI's jaxpr pass): observe real train steps of one
model and hold them to the schedule rules (``analysis.schedule_check``).

The JAX pass traces one program per configuration on a virtual 8-device
mesh. A torch step has no program, so this pass runs steps, in ONE group
of two gloo ranks (two processes of this module, started by ``run``; two
ranks share the card on ``cuda``). Inside that group, after one warm-up
step each, it observes:

  * one step per policy x lowering (``--policies`` x ``--comm-ops``), the
    global-norm clip on for rs_opt_ag and rs_fwd_ag, hier over two slices
    of one rank: SCH001-SCH009 (``verify_observed_step``);
  * one step with the non-finite guard off (wfbp, all_reduce): SCH008's
    other direction;
  * one step with the health statistics off and one with them on, on
    all_reduce and rs_opt_ag (mgwfbp): SCH010 (``compare_footprints``).

The schedules solve as the JAX pass's do: mgwfbp on the alpha-beta prior
(1e-4 s, 1e-9 s/B), hier on a slow-DCN two-level prior. A configuration
that fails to build or run, a rank that fails or a group that outlives
its deadline is TRC000 (exit bit 16), as is ``device="cuda"`` without a
card: the pass never falls back to the CPU.

Each rank writes its findings to ``rank<r>.json`` in a scratch directory;
``run`` returns their union. Observed classify models only: another task
is TRC000.
"""

from __future__ import annotations

import datetime
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional, Sequence

from mgwfbp_tpu_torch.analysis.rules import Finding

WORLD = 2
DCN_SLICES = 2
SEED = 0
BATCH = 8  # per rank
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _trc(where: str, msg: str) -> Finding:
    return Finding(where, 0, "TRC000", msg)


# -- building and observing (used by the worker and the tests' worker) -------


def build_step(model_name: str, policy: str, comm_op: str, *, world: int,
               device, norm_clip: Optional[float] = None,
               grad_guard: bool = True, health_stats: bool = False,
               levels=None, seed: int = SEED):
    """(TrainStep, reducer, meta) of ``model_name`` under ``policy`` and
    ``comm_op`` at ``world`` ranks of the running group, the optimizer
    SGD (lr 0.1, momentum 0.9) with ``norm_clip``."""
    import torch

    from mgwfbp_tpu_torch import models as zoo
    from mgwfbp_tpu_torch.models.common import init_weights
    from mgwfbp_tpu_torch.optim import make_optimizer
    from mgwfbp_tpu_torch.parallel.allreduce import (
        SHARDED_OPS,
        make_merged_allreduce,
    )
    from mgwfbp_tpu_torch.parallel.costmodel import (
        AlphaBeta,
        TwoLevelAlphaBeta,
    )
    from mgwfbp_tpu_torch.train.step import TrainStep

    model, meta = zoo.create_model(model_name)
    if meta.task != "classify":
        raise ValueError(f"the step pass observes classify models; "
                         f"{model_name!r} is {meta.task!r}")
    init_weights(model, torch.Generator().manual_seed(seed))
    model.to(device)
    opt, lr_fn, _, spec = make_optimizer(
        model.parameters(), 0.1, momentum=0.9, weight_decay=0.0,
        norm_clip=norm_clip, world_size=world, return_spec=True)
    kw: dict = {}
    if policy in ("mgwfbp", "auto"):
        if comm_op == "hier":
            kw["cost_model"] = TwoLevelAlphaBeta(
                ici=AlphaBeta(1e-5, 2e-11), dcn=AlphaBeta(2.5e-3, 6e-10),
                ici_size=world // DCN_SLICES, dcn_size=DCN_SLICES)
        else:
            kw["cost_model"] = AlphaBeta(1e-4, 1e-9)
    reducer = make_merged_allreduce(
        model, policy=policy, comm_op=comm_op, world_size=world,
        optim_spec=spec if comm_op in SHARDED_OPS else None,
        levels=levels if comm_op == "hier" else None, **kw)
    step = TrainStep(model, opt, lr_fn, reducer=reducer,
                     grad_guard=grad_guard, norm_clip=spec.norm_clip,
                     health_stats=health_stats)
    return step, reducer, meta


def batches(meta, device, rank: int, seed: int = SEED):
    """Endless (x, y) batches of one micro-step, drawn per rank from
    ``seed``."""
    import numpy as np
    import torch

    rs = np.random.RandomState(seed + 1000 * rank)
    h, w, c = meta.input_shape
    while True:
        x = rs.randn(1, BATCH, c, h, w).astype(np.float32)
        y = rs.randint(0, meta.num_classes, (1, BATCH))
        yield (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))


def observe(step, reducer, data, file: str):
    """One warm-up step (the optimizer state exists from here on), the
    parameters made current, then one observed step
    (``verify_observed_step``)."""
    from mgwfbp_tpu_torch.analysis.schedule_check import verify_observed_step

    step(*next(data))
    reducer.materialize()
    return verify_observed_step(lambda: step(*next(data)), step, file=file)


def observe_all(spec: dict, rank: int, world: int, device) -> list[Finding]:
    """Every configuration of the pass (module docstring), in one order on
    every rank."""
    from mgwfbp_tpu_torch.analysis.schedule_check import compare_footprints
    from mgwfbp_tpu_torch.parallel.mesh import two_level_groups

    model = spec["model"]
    ops = list(spec["comm_ops"])
    levels = two_level_groups(DCN_SLICES) if "hier" in ops else None
    findings: list[Finding] = []

    def run(file: str, policy: str, op: str, **kw):
        try:
            step, reducer, meta = build_step(
                model, policy, op, world=world, device=device,
                levels=levels, **kw)
            try:
                return observe(step, reducer, batches(meta, device, rank),
                               file)
            finally:
                reducer.detach()
        except Exception as e:  # noqa: BLE001 — a failure to build or run
            # is TRC000, distinct from any rule
            findings.append(_trc(file, f"{file} failed to build or run: "
                                       f"{type(e).__name__}: {e}"))
            return None

    def clip(op: str) -> Optional[float]:
        return 1.0 if op in ("rs_opt_ag", "rs_fwd_ag") else None

    for policy in spec["policies"]:
        for op in ops:
            obs = run(f"<step {model}/{policy}/{op}>", policy, op,
                      norm_clip=clip(op))
            if obs is not None:
                findings.extend(obs.findings)
    obs = run(f"<step {model}/wfbp/all_reduce guard-off>", "wfbp",
              "all_reduce", grad_guard=False)
    if obs is not None:
        findings.extend(obs.findings)
    for op in ("all_reduce", "rs_opt_ag"):
        file = f"<health-stats {model}/mgwfbp/{op}>"
        base = run(file, "mgwfbp", op, norm_clip=clip(op))
        stats = run(file, "mgwfbp", op, norm_clip=clip(op),
                    health_stats=True)
        if base is not None and stats is not None:
            findings.extend(compare_footprints(base, stats, file=file))
    return findings


def _worker(rank: int, world: int, rendezvous: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from mgwfbp_tpu_torch.runtime import coordination

    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    device = torch.device(spec["device"])
    if device.type == "cuda":
        torch.cuda.set_device(0)  # the ranks share the card
    dist.init_process_group(
        "gloo", init_method=f"file://{rendezvous}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        findings = observe_all(spec, rank, world, device)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump([[x.file, x.line, x.rule_id, x.message]
                       for x in findings], f)
    finally:
        coordination.release()
        dist.destroy_process_group()


# -- the pass ------------------------------------------------------------------


def run(model: str = "lenet",
        policies: Sequence[str] = ("wfbp", "single", "mgwfbp"),
        comm_ops: Sequence[str] = ("all_reduce", "rs_opt_ag", "rs_fwd_ag",
                                   "hier"),
        device: str = "cuda", timeout_s: float = 300.0) -> list[Finding]:
    """The step pass's findings (module docstring): two gloo ranks of this
    module observe every configuration; TRC000 when they cannot."""
    where = f"<step pass {model}>"
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            return [_trc(where, "no CUDA device: the step pass observes "
                               "steps on the card (--device cpu observes "
                               "them on the CPU)")]
    out_dir = tempfile.mkdtemp(prefix="mgwfbp-step-pass-")
    try:
        with open(os.path.join(out_dir, "spec.json"), "w") as f:
            json.dump({"model": model, "policies": list(policies),
                       "comm_ops": list(comm_ops), "device": device}, f)
        rdv = os.path.join(out_dir, "rendezvous")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_PKG_PARENT] + [p for p in [env.get("PYTHONPATH")] if p])
        env.setdefault("OMP_NUM_THREADS", "1")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "mgwfbp_tpu_torch.analysis.step_pass",
             str(r), str(WORLD), rdv, out_dir],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for r in range(WORLD)]
        outs: list = [("", "")] * WORLD

        def drain(i: int) -> None:
            outs[i] = procs[i].communicate()

        threads = [threading.Thread(target=drain, args=(i,), daemon=True)
                   for i in range(WORLD)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + timeout_s
        for t in threads:
            t.join(max(deadline - time.monotonic(), 0.0))
        hung = any(t.is_alive() for t in threads)
        for p in procs:
            if p.poll() is None:
                p.kill()
        for t in threads:
            t.join(10)
        if hung:
            return [_trc(where, f"the step pass's ranks outlived "
                               f"{timeout_s:.0f} s and were killed")]
        findings: list[Finding] = []
        seen: set = set()
        for r, p in enumerate(procs):
            path = os.path.join(out_dir, f"rank{r}.json")
            if p.returncode != 0 or not os.path.exists(path):
                tail = (outs[r][1] or "").strip().splitlines()[-8:]
                return [_trc(where, f"rank {r} of the step pass failed "
                                   f"(rc {p.returncode}): "
                                   + " | ".join(tail))]
            with open(path) as f:
                for file, line, rule, msg in json.load(f):
                    key = (file, rule, msg)
                    if key not in seen:
                        seen.add(key)
                        findings.append(Finding(file, line, rule, msg))
        return findings
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
