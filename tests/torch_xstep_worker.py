"""One rank of the cross-step and two-level tests' multi-process runs
(gloo), and the harness that starts them: tests/test_torch_cross_step.py
and tests/test_torch_two_level.py call ``run_ranks``.

Each rank is a child process with an explicit environment, started as
``python tests/torch_xstep_worker.py RANK WORLD RENDEZVOUS OUT_DIR``. It
imports torch and the port only (no JAX), reads ``<out_dir>/spec.json``,
runs the spec's tasks in order and writes ``<out_dir>/rank<r>.npz``:

  * ``traj``: ``TrainStep``s of the narrow ResNet-20 (depth 8, widths 4, 8,
    16) from one seeded initialisation over seeded global batches (this
    rank's slice), once per run in ``runs`` (label, comm_op, norm clip,
    dtype); the parameters after every step in Flax leaf order (on
    rs_fwd_ag gathered from the carried shards, never from the stale
    module), the parameters once materialized, the collectives of every
    step, the group and DCN-group counts, the health statistics of every
    step for the runs named in ``health`` and, on rs_fwd_ag, whether a
    forward of the stale module raised;
  * ``reduce``: seeded per-rank gradients planted by a backward of
    sum(p * g) and reduced by ``synchronize`` on each lowering in ``ops``;
    the local gradients and the reduced ones, Flax leaf order;
  * ``trainer``: ``Trainer`` runs in sequence (the narrow ResNet-20 or
    LeNet, synthetic data), each with its config overrides, environment
    additions and what to do (``fit`` epochs, or ``read``: one epoch of
    steps, then the readers with the parameters still stale); after each,
    the parameters, the batch statistics, the momentum in Flax layout, the
    counters, what the readers returned and, with ``probe``, the
    per-group predictions a trace is compared against and what
    ``update_nworker`` raises.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH, WIDTHS, NC = 8, (4, 8, 16), 10
# what a child needs of the environment; nothing else of the test
# worker's (whose variables earlier tests may have set) leaks in
CHILD_ENV_KEYS = ("PATH", "HOME", "TMPDIR", "LANG", "LC_ALL",
                  "LD_LIBRARY_PATH")


def run_children(argvs: list, timeout_s: float = 240.0,
                 extra_env: dict = None, cwd: str = None,
                 per_child_env: list = None) -> list:
    """Run one process per argv with an explicit environment (plus
    ``extra_env`` and the child's entry of ``per_child_env``), drain every
    child's pipes at once and return (stdout, stderr) per child. A child
    that fails, or a group that outlives ``timeout_s`` (every child is then
    killed), fails the caller with every child's stderr."""
    env = {k: os.environ[k] for k in CHILD_ENV_KEYS if k in os.environ}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", **(extra_env or {}))
    procs = [subprocess.Popen(
        argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**env, **((per_child_env or [{}] * len(argvs))[i])}, cwd=cwd)
        for i, argv in enumerate(argvs)]
    outs: list = [None] * len(procs)

    def drain(i: int) -> None:
        outs[i] = procs[i].communicate()

    threads = [threading.Thread(target=drain, args=(i,), daemon=True)
               for i in range(len(procs))]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout_s
    for t in threads:
        t.join(max(deadline - time.monotonic(), 0.0))
    hung = [i for i, t in enumerate(threads) if t.is_alive()]
    for p in procs:
        if p.poll() is None:
            p.kill()
    for t in threads:
        t.join(10)
    report = "\n".join(
        f"child {i}: rc {p.returncode}, stderr:\n"
        f"{(outs[i] or ('', ''))[1][-3000:]}" for i, p in enumerate(procs))
    assert not hung, f"child(ren) {hung} still running after " \
        f"{timeout_s:.0f} s; killed\n{report}"
    assert [p.returncode for p in procs] == [0] * len(procs), report
    return outs


def run_ranks(world: int, out_dir: str, spec: dict,
              timeout_s: float = 240.0) -> list[dict]:
    """``world`` ranks of this worker on ``spec``; each rank's outputs."""
    with open(os.path.join(out_dir, "spec.json"), "w") as f:
        json.dump(spec, f)
    rdv = os.path.join(out_dir, "rendezvous")
    run_children([[sys.executable, os.path.abspath(__file__), str(r),
                   str(world), rdv, out_dir] for r in range(world)],
                 timeout_s=timeout_s, cwd=out_dir)
    out = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


# -- the rank's side ----------------------------------------------------------


def narrow_resnet(nc=None):
    """The registry's resnet20 entry at the tests' narrow width."""
    from mgwfbp_tpu_torch.models import ModelMeta
    from mgwfbp_tpu_torch.models.resnet_cifar import CifarResNet

    nc = nc or NC
    return (CifarResNet(depth=DEPTH, widths=WIDTHS, num_classes=nc),
            ModelMeta("resnet20", "cifar10", nc, (32, 32, 3)))


def _narrow_registry() -> None:
    from mgwfbp_tpu_torch import models as pzoo

    pzoo._REGISTRY["resnet20"] = narrow_resnet


def _flat(leaves) -> np.ndarray:
    import torch

    return torch.cat([t.detach().reshape(-1).cpu() for t in leaves]).numpy()


def _carried_leaves(reducer) -> list:
    """The parameters the carried shards hold (every rank's all-gathered
    and unpacked), in leaf (tree) order: what the next forward gathers."""
    import torch
    import torch.distributed as dist

    from mgwfbp_tpu_torch.parallel import buckets

    arr: list = [None] * len(reducer.perm)
    for gi, shard in enumerate(reducer.param_shards):
        full = shard.new_empty(reducer.optim.padded_size(gi))
        dist.all_gather_into_tensor(full, shard)
        for k, v in buckets.unpack_group(full, reducer.layout, gi,
                                         reducer._shapes).items():
            arr[k] = v
    leaves: list = [None] * len(arr)
    for k, j in enumerate(reducer.perm):
        leaves[j] = arr[k]
    return [torch.as_tensor(t) for t in leaves]


def _traj(spec: dict, rank: int, world: int, out: dict) -> None:
    import torch

    from mgwfbp_tpu_torch.convert import flax_leaves
    from mgwfbp_tpu_torch.models.common import init_weights
    from mgwfbp_tpu_torch.models.resnet_cifar import CifarResNet
    from mgwfbp_tpu_torch.optim import make_optimizer
    from mgwfbp_tpu_torch.parallel.allreduce import (
        SHARDED_OPS,
        make_merged_allreduce,
    )
    from mgwfbp_tpu_torch.parallel.mesh import two_level_groups
    from mgwfbp_tpu_torch.train.step import TrainStep

    b, steps = spec["batch"], spec["steps"]
    rs = np.random.RandomState(spec["seed"])
    xs = rs.randn(steps, b * world, 3, 32, 32).astype(np.float32)
    ys = rs.randint(0, NC, (steps, b * world))
    levels = two_level_groups(spec["dcn"]) if spec.get("dcn") else None
    for label, op, clip, dtype_name in spec["runs"]:
        dtype = getattr(torch, dtype_name)
        model = CifarResNet(depth=DEPTH, widths=WIDTHS, num_classes=NC)
        init_weights(model, torch.Generator().manual_seed(spec["seed"]))
        model = model.to(dtype)
        opt, lr_fn, _, optim_spec = make_optimizer(
            model.parameters(), 0.1, momentum=0.9, weight_decay=1e-4,
            num_batches_per_epoch=steps, norm_clip=clip, world_size=world,
            return_spec=True)
        reducer = make_merged_allreduce(
            model, policy="threshold", threshold=spec["threshold"],
            comm_op=op, world_size=world,
            optim_spec=optim_spec if op in SHARDED_OPS else None,
            levels=levels if op == "hier" else None)
        health = label in spec.get("health", ())
        step = TrainStep(model, opt, lr_fn, reducer=reducer,
                         norm_clip=optim_spec.norm_clip, health_stats=health)
        leaves = [t for _, t in flax_leaves(model)]
        launches, stats = [], []
        for k in range(steps):
            x = torch.from_numpy(xs[k, rank * b:(rank + 1) * b]).to(dtype)
            y = torch.from_numpy(ys[k, rank * b:(rank + 1) * b])
            before = reducer.launches
            m = step(x[None], y[None])
            launches.append(reducer.launches - before)
            if health:
                stats.append([float(v) for k, v in m.items()
                              if k.startswith("health/")])
            now = (_carried_leaves(reducer) if op == "rs_fwd_ag"
                   else leaves)
            out[f"{label}/params{k + 1}"] = _flat(now)
        if op == "rs_fwd_ag":
            out[f"{label}/stale_differs"] = np.bool_(
                not np.array_equal(_flat(leaves),
                                   out[f"{label}/params{steps}"]))
            try:
                model(torch.from_numpy(xs[0, :1]).to(dtype))
                out[f"{label}/stale_forward_raised"] = np.bool_(False)
            except RuntimeError as e:
                out[f"{label}/stale_forward_raised"] = np.bool_(
                    "stale" in str(e))
            before = reducer.launches
            reducer.materialize()
            out[f"{label}/materialize_launches"] = np.int64(
                reducer.launches - before)
        out[f"{label}/final"] = _flat(leaves)
        out[f"{label}/launches"] = np.asarray(launches)
        if health:
            out[f"{label}/health"] = np.asarray(stats, np.float64)
        out[f"{label}/groups"] = np.int64(reducer.num_groups)
        out[f"{label}/dcn_groups"] = np.int64(len(reducer.dcn_groups))
        reducer.detach()


def _reduce(spec: dict, rank: int, world: int, out: dict) -> None:
    import torch

    from mgwfbp_tpu_torch.convert import flax_leaves
    from mgwfbp_tpu_torch.models.common import init_weights
    from mgwfbp_tpu_torch.models.resnet_cifar import CifarResNet
    from mgwfbp_tpu_torch.parallel.allreduce import make_merged_allreduce
    from mgwfbp_tpu_torch.parallel.mesh import two_level_groups

    levels = two_level_groups(spec["dcn"])
    for seed in spec["seeds"]:
        rs = np.random.RandomState(1000 * seed + rank)
        model = CifarResNet(depth=DEPTH, widths=WIDTHS, num_classes=NC)
        init_weights(model, torch.Generator().manual_seed(seed))
        params = [t for _, t in flax_leaves(model)]
        grads = [torch.from_numpy(rs.randn(*p.shape).astype(np.float32))
                 for p in params]
        out[f"{seed}/local"] = _flat(grads)
        for op in spec["ops"]:
            reducer = make_merged_allreduce(
                model, policy="threshold", threshold=spec["threshold"],
                comm_op=op, levels=levels if op == "hier" else None)
            for p in params:
                p.grad = None
            reducer.begin()
            sum((p * g).sum() for p, g in zip(params, grads)).backward()
            before = reducer.launches
            reducer.synchronize()
            out[f"{seed}/{op}"] = _flat([p.grad for p in params])
            out[f"{seed}/{op}/launches"] = np.int64(reducer.launches - before)
            reducer.detach()


def _trainer(spec: dict, rank: int, world: int, out: dict) -> None:
    import torch

    from mgwfbp_tpu_torch.config import make_config
    from mgwfbp_tpu_torch.convert import (
        _param_rules,
        flatten_flax,
        momentum_to_flax,
        variables_to_flax,
    )
    from mgwfbp_tpu_torch.train import Trainer
    from mgwfbp_tpu_torch.utils.faults import Preempted

    _narrow_registry()
    os.environ.pop("MGWFBP_FAULT_PLAN", None)
    for run in spec["runs"]:
        name = run["name"]
        saved = {k: os.environ.get(k) for k in run.get("env", {})}
        os.environ.update(run.get("env", {}))
        try:
            t = Trainer(make_config(run.get("dnn", "resnet20"), **run["cfg"]),
                        device="cpu", synthetic_data=True,
                        profile_backward=bool(run.get("profile", False)))
            try:
                if run.get("read"):
                    t.train_epoch(0)
                    out[f"{name}/stale"] = np.bool_(
                        t.reducer is not None and t.reducer.stale)
                    ev = t.evaluate()
                    out[f"{name}/eval"] = np.asarray(
                        [ev[k] for k in sorted(ev)], np.float64)
                    t.save_step(0, t._steps_per_epoch(), wait=True)
                elif run.get("epochs"):
                    try:
                        t.fit(run["epochs"])
                    except Preempted:
                        out[f"{name}/preempted"] = np.bool_(True)
                if run.get("guard"):
                    _guard(t, name, out)
                if run.get("probe"):
                    predicted, nbytes = t._scope_comparable_predictions()
                    out[f"{name}/scope_predicted"] = np.asarray(predicted)
                    out[f"{name}/scope_nbytes"] = np.asarray(nbytes)
                    out[f"{name}/dcn_groups"] = np.asarray(
                        [len(d) for d in t.reducer.dcn_groups])
                    try:
                        t.update_nworker(2 * world)
                    except Exception as e:  # noqa: BLE001 — recorded
                        out[f"{name}/resize_error"] = np.asarray(str(e))
                params, bstats = variables_to_flax(t.model)
                for k, v in flatten_flax(params).items():
                    out[f"{name}/params/{k}"] = v
                for k, v in flatten_flax(bstats).items():
                    out[f"{name}/bstats/{k}"] = v
                if t._sharded_opt:
                    rules = _param_rules(t.model)
                    slots = t.reducer.optim.gather(t.reducer.opt_state)
                    mom = ({p: r[1](torch.from_numpy(a)).contiguous().numpy()
                            for (p, r), a in zip(rules.items(), slots[0])}
                           if slots else {})
                    out[f"{name}/count"] = np.int64(t.reducer.opt_state.count)
                else:
                    mom = momentum_to_flax(t.model, t.optimizer)
                for k, v in mom.items():
                    out[f"{name}/trace/{k}"] = v
                out[f"{name}/iteration"] = np.int64(t.iteration)
                out[f"{name}/step"] = np.int64(t.train_step.step)
                out[f"{name}/comm_op"] = np.asarray(t.comm_op)
            finally:
                t.close()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


def _guard(t, name: str, out: dict) -> None:
    """One clean step, then a poisoned one: the carried shards, the
    optimizer state and its count before and after the poisoned step."""
    import torch

    from mgwfbp_tpu_torch.train.trainer import _poison_batch, batch_fields

    def step(k, poison=False):
        fields = list(batch_fields(t.bundle.train.load_batch(0, k)))
        if poison:
            fields[0], ok = _poison_batch(fields[0])
            assert ok
        return t.step_batch(*t._to_device(*(f[None] for f in fields)))

    step(0)
    red = t.reducer
    before = ([s.clone() for s in red.param_shards],
              [[s.clone() for s in slot] for slot in red.opt_state.slots],
              red.opt_state.count)
    m = step(1, poison=True)
    out[f"{name}/guard_nonfinite"] = np.float64(m["grads_nonfinite"])
    out[f"{name}/guard_kept"] = np.bool_(
        all(torch.equal(a, b) for a, b in zip(before[0], red.param_shards))
        and all(torch.equal(a, b) for sa, sb in zip(
            before[1], red.opt_state.slots) for a, b in zip(sa, sb))
        and before[2] == red.opt_state.count)


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
            {"traj": _traj, "reduce": _reduce, "trainer": _trainer}[
                task](spec[task], rank, world, out)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
