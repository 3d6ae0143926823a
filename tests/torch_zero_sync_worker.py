"""One rank of tests/test_torch_zero_sync.py's four-rank gloo group, and the
harness that starts it (``run_ranks``).

Each rank is a child process with an explicit environment (drained with
its peers and killed after 240 s: ``torch_xstep_worker.run_children``),
started as ``python tests/torch_zero_sync_worker.py RANK WORLD RENDEZVOUS
OUT_DIR``. It imports torch and the port only (no JAX). For every lowering
(all_reduce, rs_ag, rs_opt_ag, rs_fwd_ag, hier over two slices of two) it
builds a full-width ResNet-20 step through the step pass
(``analysis.step_pass.build_step``; the global-norm clip on for the
sharded lowerings), with and without the health statistics, and records:

  * the host synchronisations and the findings of one observed step
    (``step_pass.observe``);
  * one step whose batch holds a NaN on rank 0 only, observed too: its
    synchronisations, its non-finite count, and whether the whole state
    (parameters or carried shards, momentum buffers or sharded slots and
    their count, batch-norm statistics, the step counter) is bitwise what
    it was before it on this rank;
  * the step counter before it, after it and after one more finite step.

Each rank writes ``<out_dir>/rank<r>.json``.
"""

from __future__ import annotations

import datetime
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_xstep_worker as xw  # noqa: E402

OPS = ("all_reduce", "rs_ag", "rs_opt_ag", "rs_fwd_ag", "hier")


def run_ranks(world: int, out_dir: str, timeout_s: float = 240.0) -> list:
    """``world`` ranks of this worker; each rank's {case: record}."""
    rdv = os.path.join(out_dir, "rendezvous")
    xw.run_children([[sys.executable, os.path.abspath(__file__), str(r),
                      str(world), rdv, out_dir] for r in range(world)],
                    timeout_s=timeout_s, cwd=out_dir)
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _state(step, reducer) -> list:
    """Every tensor of the state a bad step must keep, cloned."""
    tensors = [p.detach() for p in step.params]
    if step.buffers is not None:
        tensors.append(step.buffers)
    for st in step.optimizer.state.values():
        tensors += [v for v in st.values() if hasattr(v, "clone")]
    state = getattr(reducer, "opt_state", None)
    if state is not None:
        tensors += [t for slot in state.slots for t in slot]
        tensors.append(state.count_t)
    tensors += list(getattr(reducer, "param_shards", None) or ())
    tensors.append(step._pos)
    return [t.clone() for t in tensors]


def _cases(world: int, rank: int) -> dict:
    import torch

    from mgwfbp_tpu_torch.analysis import schedule_check as sc
    from mgwfbp_tpu_torch.analysis import step_pass as sp
    from mgwfbp_tpu_torch.parallel.mesh import two_level_groups

    device = torch.device("cpu")
    levels = two_level_groups(2)
    out: dict = {}
    for op in OPS:
        for health in (False, True):
            clip = 1.0 if op in ("rs_opt_ag", "rs_fwd_ag") else None
            step, reducer, meta = sp.build_step(
                "resnet20", "mgwfbp", op, world=world, device=device,
                norm_clip=clip, health_stats=health, levels=levels)
            try:
                data = sp.batches(meta, device, rank)
                obs = sp.observe(step, reducer, data, f"<{op}>")
                rec = {"syncs": [s.op for s in obs.syncs],
                       "findings": [[f.rule_id, f.message]
                                    for f in obs.findings]}
                reducer.materialize()
                before = _state(step, reducer)
                rec["step_before"] = step.step
                x, y = next(data)
                if rank == 0:
                    x = x.clone()
                    x[0, 0, 0, 0, 0] = float("nan")
                metrics = {}
                with sc.HostObserver() as host:
                    metrics.update(step(x, y))
                rec["nan_syncs"] = [s.op for s in host.syncs]
                rec["nonfinite"] = float(metrics["grads_nonfinite"])
                rec["ratio_nan"] = bool(
                    health and torch.isnan(metrics["health/update_ratio"]))
                after = _state(step, reducer)
                rec["unchanged"] = all(
                    torch.equal(a, b) for a, b in zip(before, after))
                rec["step_after"] = step.step
                m = step(*next(data))
                rec["next_nonfinite"] = float(m["grads_nonfinite"])
                rec["step_next"] = step.step
                reducer.materialize()
                rec["params_finite"] = all(
                    bool(torch.isfinite(p).all()) for p in step.params)
            finally:
                reducer.detach()
            out[f"{op}/health={health}"] = rec
    return out


def main(rank: int, world: int, rendezvous: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{rendezvous}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        out = _cases(world, rank)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
