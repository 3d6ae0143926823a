"""One rank of tests/test_torch_step_rules.py's two-rank gloo group, and the
harness that starts it (``run_ranks``).

Each rank is a child process with an explicit environment (drained with
its peer and killed after 240 s: ``torch_xstep_worker.run_children``),
started as ``python tests/torch_step_rules_worker.py RANK WORLD RENDEZVOUS
OUT_DIR``. It imports torch and the port only (no JAX), and observes, one
case after another, a LeNet step built by the step pass
(``analysis.step_pass.build_step``) and held to SCH001-SCH010
(``verify_observed_step``; ``compare_footprints`` for the health cases):
the clean step of each lowering, then each mutation, and writes the rule
ids and messages of every case to ``<out_dir>/rank<r>.json``.
"""

from __future__ import annotations

import datetime
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_xstep_worker as xw  # noqa: E402


def run_ranks(world: int, out_dir: str, timeout_s: float = 240.0) -> list:
    """``world`` ranks of this worker; each rank's {case: [findings]}."""
    rdv = os.path.join(out_dir, "rendezvous")
    xw.run_children([[sys.executable, os.path.abspath(__file__), str(r),
                      str(world), rdv, out_dir] for r in range(world)],
                    timeout_s=timeout_s, cwd=out_dir)
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _cases(world: int, rank: int) -> dict:
    import torch
    import torch.distributed as dist

    from mgwfbp_tpu_torch.analysis import schedule_check as sc
    from mgwfbp_tpu_torch.analysis import step_pass as sp
    from mgwfbp_tpu_torch.parallel.allreduce import (
        collective_scope,
        group_scope_name,
    )
    from mgwfbp_tpu_torch.train import step as step_mod

    device = torch.device("cpu")
    out: dict = {}

    def record(name, findings):
        out[name] = [[f.rule_id, f.message] for f in findings]

    def observed(name, policy="mgwfbp", op="all_reduce", mutate=None,
                 **kw):
        clip = 1.0 if op in ("rs_opt_ag", "rs_fwd_ag") else None
        step, reducer, meta = sp.build_step(
            "lenet", policy, op, world=world, device=device,
            norm_clip=clip, **kw)
        try:
            if mutate is not None:
                mutate(step, reducer)
            return sp.observe(step, reducer, sp.batches(meta, device, rank),
                              f"<{name}>")
        finally:
            reducer.detach()

    for op in ("all_reduce", "rs_opt_ag", "rs_fwd_ag"):
        record(f"clean/{op}", observed(f"clean/{op}", op=op).findings)

    # SCH005: a gradient hook that reads its gradient back, by each form
    def hook_read(read):
        def mutate(step, reducer):
            step.params[0].register_hook(lambda g: (read(g), g)[1])
        return mutate

    record("sch005/hook_item", observed(
        "sch005/hook_item",
        mutate=hook_read(lambda g: g.sum().item())).findings)
    record("sch005/hook_tolist", observed(
        "sch005/hook_tolist",
        mutate=hook_read(lambda g: g.reshape(-1)[:2].tolist())).findings)
    record("sch005/branch_on_tensor", observed(
        "sch005/branch_on_tensor",
        mutate=hook_read(lambda g: 1 if g.abs().sum() > 0 else 0)).findings)

    # SCH006: a parameter rebound out of place by the update
    real_update = step_mod.sgd_update_

    def rebind_param(step, reducer):
        p = step.params[1]

        def rebinding(*a, **k):
            real_update(*a, **k)
            p.data = p.data.clone()
        step_mod.sgd_update_ = rebinding

    try:
        record("sch006/param_rebound", observed(
            "sch006/param_rebound", mutate=rebind_param).findings)
    finally:
        step_mod.sgd_update_ = real_update

    # SCH006: the sharded state rebound to the update's fresh tensors, as
    # the reducer's _update_shards and reduce_and_defer did before their
    # state was updated in place (cut from that code)
    def parent_update_shards(self, g_shards, p_shard, lr, after, ok=None):
        optim, state = self.optim, self.opt_state
        clip_scale = self._clip_scale(g_shards)
        count = state.count_t
        for gi in range(self.num_groups):
            with collective_scope(group_scope_name(gi)):
                p = p_shard(gi)
                old = [state.slots[s][gi] for s in range(optim.num_slots)]
                new_p, slots_out = optim.update_shard(
                    gi, g_shards[gi], p, old, count, clip_scale, self.rank,
                    lr=lr,
                )
                g_shards[gi] = None
                if ok is not None:
                    new_p = torch.where(ok, new_p, p)
                    slots_out = [torch.where(ok, n, o)
                                 for n, o in zip(slots_out, old)]
                for s in range(optim.num_slots):
                    state.slots[s][gi] = slots_out[s]
                after(gi, new_p)
        count.add_(1 if ok is None else ok)

    def parent_defer(self, lr=None, ok=None):
        g_shards = self._reduced_shards("reduce_and_defer")
        shards = self.param_shards

        def keep(gi, new_p):
            shards[gi] = new_p

        self._update_shards(g_shards, lambda gi: shards[gi], lr, keep, ok)
        self._stale = True

    def parent_sharded(step, reducer):
        reducer._update_shards = parent_update_shards.__get__(reducer)
        reducer.reduce_and_defer = torch.no_grad()(
            parent_defer).__get__(reducer)

    for op in ("rs_opt_ag", "rs_fwd_ag"):
        record(f"sch006/parent_{op}", observed(
            f"sch006/parent_{op}", op=op, mutate=parent_sharded).findings)

    # SCH008 both ways: the guard's count outside its range, and a
    # guard-off build that still runs the count
    real_count = step_mod.nonfinite_count

    def unscoped_count(tensors):
        flat = torch.cat([t.reshape(-1) for t in tensors])
        return torch.count_nonzero(~torch.isfinite(flat)).float()

    step_mod.nonfinite_count = unscoped_count
    try:
        record("sch008/guard_without_range", observed(
            "sch008/guard_without_range").findings)
    finally:
        step_mod.nonfinite_count = real_count
    record("clean/guard_off", observed(
        "clean/guard_off", policy="wfbp", grad_guard=False).findings)

    def count_left_in(step, reducer):
        sync = reducer.synchronize

        def synchronize():
            reduced = sync()
            step_mod.nonfinite_count(reduced)
            return reduced
        reducer.synchronize = synchronize

    record("sch008/guard_off_with_count", observed(
        "sch008/guard_off_with_count", policy="wfbp", grad_guard=False,
        mutate=count_left_in).findings)

    # SCH010: the health statistics, clean and with an extra all-reduce or
    # an extra read-back in their build
    def footprint(name, op, mutate=None):
        base = observed(f"{name}/off", op=op)
        stats = observed(f"{name}/on", op=op, health_stats=True,
                         mutate=mutate)
        return sc.compare_footprints(base, stats, file=f"<{name}>")

    def extra(action):
        def mutate(step, reducer):
            norms = step._grad_norms

            def grad_norms():
                v = norms()
                action(v)
                return v
            step._grad_norms = grad_norms
        return mutate

    def extra_all_reduce(v):
        with collective_scope("metrics_reduce"):
            dist.all_reduce(torch.zeros(1))

    def extra_read_back(v):
        v.tolist()

    for op in ("all_reduce", "rs_opt_ag"):
        record(f"clean/health_{op}", footprint(f"health_{op}", op))
    record("sch010/extra_all_reduce", footprint(
        "sch010/extra_all_reduce", "all_reduce", extra(extra_all_reduce)))
    record("sch010/extra_read_back", footprint(
        "sch010/extra_read_back", "all_reduce", extra(extra_read_back)))
    return out


def main(rank: int, world: int, rendezvous: str, out_dir: str) -> None:
    import torch.distributed as dist

    from mgwfbp_tpu_torch.runtime import coordination

    dist.init_process_group(
        "gloo", init_method=f"file://{rendezvous}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        out = _cases(world, rank)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        coordination.release()
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
