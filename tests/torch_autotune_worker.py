"""One rank of the autotune and schedule-verifier tests' multi-process runs
(gloo), and the harness that starts them: tests/test_torch_autotune.py and
tests/test_torch_schedule_check.py call ``run_ranks``.

Each rank is a child process with an explicit environment, drained with
its peers and killed after 240 s (``torch_xstep_worker.run_children``),
started as ``python tests/torch_autotune_worker.py RANK WORLD RENDEZVOUS
OUT_DIR``. It imports torch and the port only (no JAX), reads
``<out_dir>/spec.json``, runs the spec's tasks in order and writes
``<out_dir>/rank<r>.npz``:

  * ``race``: ``Trainer`` runs (LeNet or the narrow ResNet-20, synthetic
    data), each racing its schedule (``autotune``, ``fit`` with
    ``autotune`` on, a forced re-race after it) or only built (``init``:
    a resume), with the timer scripted
    per rank (``profiling.time_carried_steps``: a time per call in race
    order, ``"raise"`` to fail) and the gate scripted to reject the
    candidates whose labels start as named
    (``schedule_check.check_collectives``); per raced
    candidate whether its state came back unchanged and how many timed
    windows it ran, then the report, the live groups, the parameters and
    the iteration;
  * ``swap``: an rs_fwd_ag run swapped to all_reduce and back, the
    interchange state before and after each swap, a checkpoint written
    while all_reduce is live and the parameters at each point (at the
    save also in Flax layout, per path);
  * ``gate``: one step of the narrow ResNet-20 per lowering observed and
    checked (``verify_step_against_reducer``), then the mutations (a
    dropped group collective, a wrong wire dtype, a wrong payload size, an
    extra collective outside the ranges, a layout that misses a leaf);
    the rule ids and the observed collectives of each.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_xstep_worker as xw  # noqa: E402

ROOT = xw.ROOT


def run_ranks(world: int, out_dir: str, spec: dict,
              timeout_s: float = 240.0) -> list[dict]:
    """``world`` ranks of this worker on ``spec``; each rank's outputs."""
    with open(os.path.join(out_dir, "spec.json"), "w") as f:
        json.dump(spec, f)
    rdv = os.path.join(out_dir, "rendezvous")
    xw.run_children([[sys.executable, os.path.abspath(__file__), str(r),
                      str(world), rdv, out_dir] for r in range(world)],
                    timeout_s=timeout_s, cwd=out_dir)
    out = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


def _flat_params(model) -> np.ndarray:
    from mgwfbp_tpu_torch.convert import flax_leaves

    return xw._flat([t for _, t in flax_leaves(model)])


def _trainer(run: dict):
    from mgwfbp_tpu_torch.config import make_config
    from mgwfbp_tpu_torch.train import Trainer

    return Trainer(make_config(run.get("dnn", "lenet"), **run["cfg"]),
                   device="cpu", synthetic_data=True,
                   profile_backward=bool(run.get("profile", True)))


def _scripted(run: dict, rank: int, calls: list):
    """The scripted timer of ``run`` for this rank (None: the real one)."""
    script = (run.get("script") or {}).get(str(rank))
    if script is None:
        return None

    def timer(step_once, state, iters, warmup=1, device=None):
        k = len(calls)
        calls.append(k)
        t = script[k] if k < len(script) else 100.0
        if t == "raise":
            raise RuntimeError("scripted failure of a candidate")
        for _ in range(warmup + iters):
            state = step_once(state)
        return state, float(t)

    return timer


def _race(spec: dict, rank: int, world: int, out: dict) -> None:
    import torch

    from mgwfbp_tpu_torch import profiling
    from mgwfbp_tpu_torch.analysis import schedule_check
    from mgwfbp_tpu_torch.analysis.rules import Finding

    xw._narrow_registry()
    real_timer = profiling.time_carried_steps
    real_check = schedule_check.check_collectives
    for run in spec["runs"]:
        name = run["name"]
        calls: list = []
        timer = _scripted(run, rank, calls)
        reject = list(run.get("reject", ()))

        def check(records, reducer, leaves, file="<observed step>"):
            found = real_check(records, reducer, leaves, file=file)
            detail = reducer.schedule.policy_detail or ""
            if any(detail.startswith(f"autotune:{lbl}") for lbl in reject):
                found.append(Finding(file, 0, "SCH001",
                                     "scripted rejection"))
            return found

        profiling.time_carried_steps = timer or real_timer
        schedule_check.check_collectives = check
        saved = {k: os.environ.get(k) for k in run.get("env", {})}
        os.environ.update(run.get("env", {}))
        try:
            t = _trainer(run)
            try:
                out[f"{name}/groups_before"] = np.asarray(json.dumps(
                    [list(g) for g in t.reducer.layout.groups]))
                race_rows = []
                inner = t._race_candidate

                def observed(cand, batch_iter, steps, inner=inner):
                    before = (_flat_params(t.model), t.iteration,
                              int(t.train_step.step), len(calls))
                    e = inner(cand, batch_iter, steps)
                    after = (_flat_params(t.model), t.iteration,
                             int(t.train_step.step), len(calls))
                    race_rows.append({
                        "label": cand.label, "verified": e.verified,
                        "measured": e.measured_step_s,
                        "unchanged": bool(
                            np.array_equal(before[0], after[0])
                            and before[1:3] == after[1:3]),
                        "timed_windows": after[3] - before[3],
                    })
                    return e

                t._race_candidate = observed
                if run.get("action") == "fit":
                    t.fit(run.get("epochs", 1))
                elif run.get("action") != "init":
                    t.autotune()
                out[f"{name}/report"] = np.asarray(json.dumps(
                    t.autotune_report, default=str))
                out[f"{name}/rows"] = np.asarray(json.dumps(race_rows))
                if run.get("force"):
                    t.autotune(force=True)
                    out[f"{name}/forced"] = np.asarray(json.dumps(
                        t.autotune_report, default=str))
                t._materialize()
                out[f"{name}/groups_after"] = np.asarray(json.dumps(
                    [list(g) for g in t.reducer.layout.groups]))
                out[f"{name}/comm_op"] = np.asarray(t.comm_op)
                out[f"{name}/params"] = _flat_params(t.model)
                out[f"{name}/iteration"] = np.int64(t.iteration)
                out[f"{name}/step"] = np.int64(t.train_step.step)
                out[f"{name}/losses"] = np.asarray(t.losses, np.float64)
                if t.telemetry is not None:
                    out[f"{name}/events"] = np.asarray(t.telemetry.path)
            finally:
                t.close()
        finally:
            profiling.time_carried_steps = real_timer
            schedule_check.check_collectives = real_check
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        torch.distributed.barrier()


def _state_equal(a, b) -> bool:
    """Two interchange states hold the same arrays."""
    if a.step != b.step:
        return False
    for x, y in ((a.params, b.params), (a.batch_stats, b.batch_stats),
                 (a.opt_state, b.opt_state)):
        if x.keys() != y.keys() or not all(
                np.array_equal(np.asarray(x[k]), np.asarray(y[k])) for k in x):
            return False
    return True


def _swap(spec: dict, rank: int, world: int, out: dict) -> None:
    from mgwfbp_tpu_torch.convert import host_leaves

    t = _trainer(spec)
    try:
        batches = t._autotune_batches()

        def steps(n):
            for _ in range(n):
                t._apply_train_step(next(batches))

        steps(2)
        groups = t.reducer.layout.groups
        s0 = t._interchange_state()
        t._swap_reducer(t._reducer_for(groups, "all_reduce", detail="swap"))
        out["to_ar/lossless"] = np.bool_(_state_equal(
            s0, t._interchange_state()))
        out["to_ar/comm_op"] = np.asarray(t.comm_op)
        out["to_ar/sharded"] = np.bool_(t._sharded_opt or t._cross_step)
        steps(2)
        out["saved/params"] = _flat_params(t.model)
        for k, v in host_leaves(t.model, "params").items():
            out[f"saved/flax/{k}"] = v
        out["saved/iteration"] = np.int64(t.iteration)
        t.save_step(0, 4, wait=True)
        s1 = t._interchange_state()
        t._swap_reducer(t._reducer_for(groups, "rs_fwd_ag", detail="back"))
        out["back/lossless"] = np.bool_(_state_equal(
            s1, t._interchange_state()))
        out["back/comm_op"] = np.asarray(t.comm_op)
        steps(2)
        t._materialize()
        out["back/params"] = _flat_params(t.model)
        out["back/step"] = np.int64(t.train_step.step)
        out["ckpt_dir"] = np.asarray(t.ckpt_dir)
    finally:
        t.close()


def _gate(spec: dict, rank: int, world: int, out: dict) -> None:
    import dataclasses

    import torch
    import torch.distributed as dist

    from mgwfbp_tpu_torch.analysis.schedule_check import (
        verify_step_against_reducer,
    )
    from mgwfbp_tpu_torch.convert import flax_leaves
    from mgwfbp_tpu_torch.models.common import init_weights
    from mgwfbp_tpu_torch.optim import make_optimizer
    from mgwfbp_tpu_torch.parallel import allreduce as ar
    from mgwfbp_tpu_torch.parallel.compression import make_compressor
    from mgwfbp_tpu_torch.parallel.mesh import two_level_groups
    from mgwfbp_tpu_torch.train.step import TrainStep

    rs = np.random.RandomState(spec["seed"] + rank)
    levels = two_level_groups(world) if world > 1 else None

    def build(op, clip=None, sparse=False):
        model, _ = xw.narrow_resnet()
        init_weights(model, torch.Generator().manual_seed(spec["seed"]))
        opt, lr_fn, _, optim_spec = make_optimizer(
            model.parameters(), 0.05, momentum=0.9, weight_decay=1e-4,
            num_batches_per_epoch=4, norm_clip=clip, world_size=world,
            return_spec=True)
        reducer = ar.make_merged_allreduce(
            model, policy="threshold", threshold=spec["threshold"],
            comm_op=op, world_size=world,
            optim_spec=optim_spec if op in ar.SHARDED_OPS else None,
            levels=levels if op == "hier" else None,
            compressor=make_compressor("topk", 0.3) if sparse else None)
        step = TrainStep(model, opt, lr_fn, reducer=reducer,
                         norm_clip=optim_spec.norm_clip)
        leaves = [t for _, t in flax_leaves(model)]
        return model, reducer, step, [leaves[j] for j in reducer.perm]

    def batch():
        x = torch.from_numpy(rs.randn(1, 4, 3, 32, 32).astype(np.float32))
        y = torch.from_numpy(rs.randint(0, xw.NC, (1, 4)))
        return x, y

    def observe(name, reducer, step, arr, steps_before=1):
        for _ in range(steps_before):
            step(*batch())
        # as the trainer's gate: the window starts from current parameters
        reducer.materialize()
        findings, records = verify_step_against_reducer(
            lambda: step(*batch()), reducer, arr, file=f"<{name}>")
        out[f"{name}/rules"] = np.asarray(json.dumps(
            sorted({f.rule_id for f in findings})))
        out[f"{name}/messages"] = np.asarray(json.dumps(
            [f.format() for f in findings]))
        out[f"{name}/records"] = np.asarray(json.dumps([
            [r.kind, r.numel, str(r.dtype), list(r.scopes), r.phase]
            for r in records]))
        out[f"{name}/groups"] = np.int64(reducer.num_groups)
        out[f"{name}/dcn_groups"] = np.int64(len(reducer.dcn_groups))
        reducer.detach()

    for op, clip, sparse in (("all_reduce", None, False),
                             ("rs_ag", None, False),
                             ("rs_opt_ag", 1.0, False),
                             ("rs_fwd_ag", 1.0, False),
                             ("hier", None, False),
                             ("all_reduce", None, True)):
        name = "topk" if sparse else op
        _, reducer, step, arr = build(op, clip, sparse)
        observe(f"clean/{name}", reducer, step, arr)

    # the mutations, each on a fresh all_reduce reducer
    def mutate_launch(reducer, fn):
        orig = reducer._launch_all_reduce
        reducer._launch_all_reduce = lambda gi, buf: fn(orig, gi, buf)

    _, reducer, step, arr = build("all_reduce")

    def dropped(orig, gi, buf):
        if gi == 1:  # no collective: the group is "reduced" locally
            reducer._inflight.append(ar._Inflight(gi, [], buf))
            return None
        return orig(gi, buf)

    mutate_launch(reducer, dropped)
    observe("mut/dropped", reducer, step, arr, steps_before=0)

    _, reducer, step, arr = build("all_reduce")
    mutate_launch(reducer, lambda orig, gi, buf: orig(
        gi, buf.double() if gi == 0 else buf))
    observe("mut/wire_dtype", reducer, step, arr, steps_before=0)

    _, reducer, step, arr = build("all_reduce")
    mutate_launch(reducer, lambda orig, gi, buf: orig(
        gi, torch.cat([buf, buf.new_zeros(1)]) if gi == 0 else buf))
    observe("mut/payload", reducer, step, arr, steps_before=0)

    model, reducer, step, arr = build("all_reduce")
    first = next(model.parameters())
    extra = first.register_post_accumulate_grad_hook(
        lambda p: dist.all_reduce(torch.zeros(1)))
    observe("mut/extra", reducer, step, arr, steps_before=0)
    extra.remove()

    _, reducer, step, arr = build("all_reduce")
    covered = reducer.layout
    # a layout that misses the last leaf of group 0
    g0 = covered.groups[0][:-1]
    reducer.layout = dataclasses.replace(
        covered, groups=(g0,) + covered.groups[1:],
        offsets=(covered.offsets[0][:-1],) + covered.offsets[1:],
        group_sizes=(covered.group_sizes[0]
                     - int(arr[covered.groups[0][-1]].numel()),)
        + covered.group_sizes[1:])
    findings, _ = verify_step_against_reducer(lambda: None, reducer, arr)
    out["mut/layout/rules"] = np.asarray(json.dumps(
        sorted({f.rule_id for f in findings})))
    reducer.detach()


def main(rank: int, world: int, rdv: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    torch.manual_seed(0)
    torch.set_num_threads(1)
    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    try:
        out: dict = {}
        for task in spec["tasks"]:
            {"race": _race, "swap": _swap, "gate": _gate}[task](
                spec[task], rank, world, out)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
