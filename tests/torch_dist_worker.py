"""One rank of the port's multi-process CPU tests (gloo), started by
tests/test_torch_train_dist.py with torch.multiprocessing (spawn).

Imports torch and the port only (no JAX), reads its inputs from
``<out_dir>/spec.npz`` + ``spec.json`` and writes ``<out_dir>/rank<r>.npz``:

  * ``merge``: for each policy, one backward of a small CifarResNet on a
    per-rank batch through the merged all-reduce, against the same
    gradients (copied by hooks before the reduction) reduced leaf by leaf
    with ``dist.all_reduce``; the launch order of the groups; a micro-step
    that is not the last launches nothing;
  * ``train``: the port's TrainStep from the spec's initial weights over
    the spec's global batches (this rank's slice), state saved after
    steps 1 and 5, one run per ``nsteps_update``;
  * ``nan``: a step whose batch holds a NaN on one rank leaves the whole
    state (parameters, batch statistics, momentum, step counter) as it was.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mgwfbp_tpu_torch.convert import (  # noqa: E402
    flatten_flax,
    flax_leaves,
    state_from_flax,
    variables_to_flax,
)
from mgwfbp_tpu_torch.models.resnet_cifar import CifarResNet  # noqa: E402
from mgwfbp_tpu_torch.optim import make_optimizer  # noqa: E402
from mgwfbp_tpu_torch.parallel.allreduce import make_merged_allreduce  # noqa: E402
from mgwfbp_tpu_torch.parallel.costmodel import lookup_alpha_beta  # noqa: E402
from mgwfbp_tpu_torch.train.step import TrainStep, cross_entropy  # noqa: E402

POLICIES = ("mgwfbp", "threshold", "single", "wfbp")


def _model(spec: dict, arrays) -> CifarResNet:
    m = CifarResNet(depth=spec["depth"], widths=tuple(spec["widths"]),
                    num_classes=spec["num_classes"])
    params = {k[len("params/"):]: arrays[k] for k in arrays.files
              if k.startswith("params/")}
    bstats = {k[len("bstats/"):]: arrays[k] for k in arrays.files
              if k.startswith("bstats/")}
    m.load_state_dict(state_from_flax(m, params, bstats))
    return m


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).movedim(-1, -3).contiguous()


def _merge(spec, arrays, rank, world, out) -> None:
    model = _model(spec, arrays).train()
    b = spec["batch"]
    x = _nchw(arrays["merge_x"][rank * b:(rank + 1) * b])
    y = torch.from_numpy(arrays["merge_y"][rank * b:(rank + 1) * b]).long()
    params = [t for _, t in flax_leaves(model)]
    cost = lookup_alpha_beta("10GbE", world)
    for policy in POLICIES:
        reducer = make_merged_allreduce(
            model, policy=policy, cost_model=cost,
            threshold=spec["threshold"],
        )
        copies: dict[int, torch.Tensor] = {}
        hooks = [
            p.register_post_accumulate_grad_hook(
                lambda t, j=j: copies.__setitem__(j, t.grad.detach().clone())
            )
            for j, p in enumerate(params)
        ]
        # a micro-step that is not the last launches nothing
        for p in params:
            p.grad = None
        reducer.begin(active=False)
        cross_entropy(model(x), y).backward()
        out[f"{policy}/inactive_launches"] = np.int64(reducer.launches)
        for p in params:
            p.grad = None
        copies.clear()
        reducer.begin(active=True)
        cross_entropy(model(x), y).backward()
        reducer.synchronize()
        for h in hooks:
            h.remove()
        reducer.detach()
        out[f"{policy}/num_groups"] = np.int64(reducer.num_groups)
        out[f"{policy}/launches"] = np.int64(reducer.launches)
        out[f"{policy}/launch_log"] = np.asarray(reducer.launch_log)
        worst = 0.0
        exact = True
        for j, p in enumerate(params):
            leafwise = copies[j].clone()
            dist.all_reduce(leafwise)
            leafwise.div_(world)
            absum = copies[j].abs()
            dist.all_reduce(absum)
            # float32 reassociation bound of two W-term sums, each off by
            # at most (W - 1) roundings of the partial sums (<= sum |g|)
            bound = 2 * (world - 1) * 2.0 ** -24 * absum / world
            diff = (p.grad - leafwise).abs()
            exact = exact and bool(torch.equal(p.grad, leafwise))
            worst = max(worst, float((diff - bound).max()))
        out[f"{policy}/bitwise"] = np.bool_(exact)
        out[f"{policy}/excess_over_bound"] = np.float64(worst)


def _state(model: torch.nn.Module, step: TrainStep) -> dict:
    params, bstats = variables_to_flax(model)
    out = {f"params/{k}": v for k, v in flatten_flax(params).items()}
    out.update({f"bstats/{k}": v for k, v in flatten_flax(bstats).items()})
    for i, p in enumerate(step.params):
        buf = step.optimizer.state.get(p, {}).get("momentum_buffer")
        if buf is not None:
            out[f"momentum/{i}"] = buf.detach().numpy().copy()
    out["step"] = np.int64(step.step)
    return out


def _train(spec, arrays, rank, world, out, n: int) -> None:
    model = _model(spec, arrays)
    b = spec["batch"]
    opt, lr_fn, _ = make_optimizer(
        model.parameters(), spec["lr"], momentum=0.9, weight_decay=1e-4,
        lr_schedule="auto", dataset="cifar10", max_epochs=141,
        warmup_epochs=5, num_batches_per_epoch=spec["batches_per_epoch"],
    )
    reducer = make_merged_allreduce(
        model, policy="mgwfbp", cost_model=lookup_alpha_beta("10GbE", world)
    )
    step = TrainStep(model, opt, lr_fn, reducer=reducer, nsteps_update=n)
    xs, ys = arrays[f"x_n{n}"], arrays[f"y_n{n}"]
    for k in range(xs.shape[0]):
        x = _nchw(xs[k][:, rank * b:(rank + 1) * b])
        y = torch.from_numpy(ys[k][:, rank * b:(rank + 1) * b]).long()
        m = step(x, y)
        out[f"train_n{n}/metrics{k + 1}"] = np.asarray(
            [m["loss"], m["accuracy"], m["grads_nonfinite"]]
        )
        if k + 1 in (1, 5):
            for key, v in _state(model, step).items():
                out[f"train_n{n}/s{k + 1}/{key}"] = v
    if spec.get("nan_step") and n == 1:
        # one more step whose batch holds a NaN on the last rank only
        before = _state(model, step)
        x = _nchw(xs[0][:, rank * b:(rank + 1) * b])
        if rank == world - 1:
            x[0, 0, 0, 0, 0] = float("nan")
        m = step(x, torch.from_numpy(ys[0][:, rank * b:(rank + 1) * b]).long())
        after = _state(model, step)
        out[f"nan_n{n}/nonfinite"] = np.float64(m["grads_nonfinite"])
        out[f"nan_n{n}/unchanged"] = np.bool_(
            before.keys() == after.keys()
            and all(np.array_equal(before[k], after[k]) for k in before)
        )
    reducer.detach()


def run(rank: int, world: int, init_file: str, out_dir: str) -> None:
    torch.manual_seed(0)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", world_size=world, rank=rank
    )
    try:
        with open(os.path.join(out_dir, "spec.json")) as f:
            spec = json.load(f)
        arrays = np.load(os.path.join(out_dir, "spec.npz"))
        out: dict[str, np.ndarray] = {}
        if "merge" in spec["tasks"]:
            _merge(spec, arrays, rank, world, out)
        for n in spec.get("train_nsteps", ()):
            _train(spec, arrays, rank, world, out, n)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
