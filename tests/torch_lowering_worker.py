"""One rank of the lowering tests' multi-process runs (gloo), started by
tests/test_torch_compression.py, tests/test_torch_sharded_optim.py and
tests/test_torch_sharded_ckpt.py with torch.multiprocessing (spawn).

Imports torch and the port only (no JAX), reads its inputs from
``<out_dir>/spec.json`` + ``spec.npz`` and writes ``<out_dir>/rank<r>.npz``:

  * ``topk``: ``TopKCompressor.allreduce`` (mean) of each of the spec's
    buckets ``topk_x[b, rank]``;
  * ``rsopt_once``: one ``reduce_and_update`` of the narrow ResNet-20 from
    the spec's weights, with this rank's gradients ``grads/<rank>/<path>``
    (Flax layout) planted by a backward of sum(p * g); the new parameters
    and the gathered momentum, both in Flax layout;
  * ``traj``: 10 ``TrainStep``s of the narrow ResNet-20 from the spec's
    weights over the spec's global batches (this rank's slice), once per
    lowering in ``ops``, at the spec's dtype; the flat parameters after
    every step, each run's launches and its optimizer-state bytes;
  * ``trainer``: ``Trainer`` runs in sequence (the narrow ResNet-20 in the
    registry, synthetic data), each with its config overrides, fault-plan
    free environment additions and ``fit`` epochs; after each, the
    parameters, the batch statistics, the momentum (gathered on
    rs_opt_ag) in Flax layout, and the counters.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mgwfbp_tpu_torch import models as pzoo  # noqa: E402
from mgwfbp_tpu_torch.convert import (  # noqa: E402
    _param_rules,
    flatten_flax,
    momentum_to_flax,
    state_from_flax,
    variables_to_flax,
)
from mgwfbp_tpu_torch.models import ModelMeta  # noqa: E402
from mgwfbp_tpu_torch.models.resnet_cifar import CifarResNet  # noqa: E402
from mgwfbp_tpu_torch.optim import OptimSpec, make_optimizer  # noqa: E402
from mgwfbp_tpu_torch.parallel.allreduce import make_merged_allreduce  # noqa: E402
from mgwfbp_tpu_torch.parallel.compression import TopKCompressor  # noqa: E402
from mgwfbp_tpu_torch.train.step import TrainStep  # noqa: E402

DEPTH, WIDTHS, NC = 8, (4, 8, 16), 10


def _model(arrays) -> CifarResNet:
    m = CifarResNet(depth=DEPTH, widths=WIDTHS, num_classes=NC)
    params = {k[len("params/"):]: arrays[k] for k in arrays.files
              if k.startswith("params/")}
    bstats = {k[len("bstats/"):]: arrays[k] for k in arrays.files
              if k.startswith("bstats/")}
    m.load_state_dict(state_from_flax(m, params, bstats))
    return m


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).movedim(-1, -3).contiguous()


def _flax_slots(model, optim, state) -> list[dict]:
    """The gathered optimizer slots in Flax layout, keyed by Flax path."""
    rules = _param_rules(model)
    out = []
    for leaves in optim.gather(state):
        out.append({path: rule[1](torch.from_numpy(a)).contiguous().numpy()
                    for (path, rule), a in zip(rules.items(), leaves)})
    return out


def _topk(spec, arrays, rank, out) -> None:
    comp = TopKCompressor(density=spec["density"])
    xs = arrays["topk_x"]
    for b in range(xs.shape[0]):
        got = comp.allreduce(torch.from_numpy(xs[b, rank].copy()))
        out[f"topk/{b}"] = got.numpy()


def _rsopt_once(spec, arrays, rank, world, out) -> None:
    model = _model(arrays)
    o = spec["optim"]
    optim_spec = OptimSpec(lr=o["lr"], momentum=o["momentum"],
                           weight_decay=o["weight_decay"],
                           norm_clip=o["norm_clip"])
    reducer = make_merged_allreduce(
        model, policy=spec["policy"], threshold=spec["threshold"],
        comm_op="rs_opt_ag", optim_spec=optim_spec, world_size=world,
    )
    rules = _param_rules(model)
    loss = 0.0
    for path, (p, _, to_torch) in rules.items():
        g = to_torch(torch.from_numpy(arrays[f"grads/{rank}/{path}"]))
        loss = loss + (p * g.contiguous()).sum()
    reducer.begin()
    loss.backward()
    reducer.reduce_and_update()
    params, _ = variables_to_flax(model)
    for k, v in flatten_flax(params).items():
        out[f"params/{k}"] = v
    for s, slot in enumerate(_flax_slots(model, reducer.optim,
                                         reducer.opt_state)):
        for k, v in slot.items():
            out[f"slot{s}/{k}"] = v
    out["groups"] = np.asarray([len(g) for g in reducer.layout.groups])
    out["launches"] = np.int64(reducer.launches)
    reducer.detach()


def _traj(spec, arrays, rank, world, out) -> None:
    dtype = getattr(torch, spec["dtype"])
    b = spec["batch"]
    xs, ys = arrays["x"], arrays["y"]
    for op in spec["ops"]:
        model = _model(arrays).to(dtype)
        opt, lr_fn, _, optim_spec = make_optimizer(
            model.parameters(), spec["lr"], momentum=0.9, weight_decay=1e-4,
            num_batches_per_epoch=spec["batches_per_epoch"],
            norm_clip=spec["norm_clip"], world_size=world, return_spec=True,
        )
        reducer = make_merged_allreduce(
            model, policy=spec["policy"], comm_op=op,
            optim_spec=optim_spec if op == "rs_opt_ag" else None,
            world_size=world,
        )
        step = TrainStep(model, opt, lr_fn, reducer=reducer,
                         norm_clip=optim_spec.norm_clip)
        for k in range(xs.shape[0]):
            x = _nchw(xs[k][:, rank * b:(rank + 1) * b]).to(dtype)
            y = torch.from_numpy(ys[k][:, rank * b:(rank + 1) * b]).long()
            step(x, y)
            out[f"{op}/params{k + 1}"] = torch.cat(
                [p.detach().reshape(-1) for p in model.parameters()]).numpy()
        out[f"{op}/launches"] = np.int64(reducer.launches)
        out[f"{op}/groups"] = np.int64(reducer.num_groups)
        if op == "rs_opt_ag":
            out[f"{op}/state_bytes"] = np.int64(
                reducer.optim.state_bytes_per_device())
            out[f"{op}/replicated_bytes"] = np.int64(
                reducer.optim.replicated_state_bytes())
            out[f"{op}/live_bytes"] = np.int64(sum(
                t.numel() * t.element_size()
                for slot in reducer.opt_state.slots for t in slot))
        reducer.detach()


def _narrow_registry() -> None:
    def p_resnet(nc):
        nc = nc or NC
        return (CifarResNet(depth=DEPTH, widths=WIDTHS, num_classes=nc),
                ModelMeta("resnet20", "cifar10", nc, (32, 32, 3)))

    pzoo._REGISTRY["resnet20"] = p_resnet


def _trainer(spec, rank, world, out) -> None:
    from mgwfbp_tpu_torch.config import make_config
    from mgwfbp_tpu_torch.train import Trainer

    _narrow_registry()
    os.environ.pop("MGWFBP_FAULT_PLAN", None)
    for run in spec["runs"]:
        saved = {k: os.environ.get(k) for k in run.get("env", {})}
        os.environ.update(run.get("env", {}))
        try:
            t = Trainer(make_config(run.get("dnn", "resnet20"), **run["cfg"]),
                        device="cpu", synthetic_data=True,
                        profile_backward=False)
            try:
                if run.get("epochs"):
                    t.fit(run["epochs"])
                name = run["name"]
                params, bstats = variables_to_flax(t.model)
                for k, v in flatten_flax(params).items():
                    out[f"{name}/params/{k}"] = v
                for k, v in flatten_flax(bstats).items():
                    out[f"{name}/bstats/{k}"] = v
                if t._sharded_opt:
                    slots = _flax_slots(t.model, t.reducer.optim,
                                        t.reducer.opt_state)
                    mom = slots[0] if slots else {}
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


def run(rank: int, world: int, init_file: str, out_dir: str) -> None:
    torch.manual_seed(0)
    torch.set_num_threads(1)
    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", world_size=world, rank=rank
    )
    try:
        arrays = np.load(os.path.join(out_dir, "spec.npz"))
        out: dict[str, np.ndarray] = {}
        task = spec["task"]
        if task == "topk":
            _topk(spec, arrays, rank, out)
        elif task == "rsopt_once":
            _rsopt_once(spec, arrays, rank, world, out)
        elif task == "traj":
            _traj(spec, arrays, rank, world, out)
        elif task == "trainer":
            _trainer(spec, rank, world, out)
        else:
            raise ValueError(f"unknown task {task!r}")
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def spawn(world: int, out_dir: str, spec: dict, arrays: dict,
          timeout_s: float = 150.0) -> list[dict]:
    """Run ``world`` ranks of ``run`` (spawned, each join bounded) and
    return each rank's outputs; a rank that hangs or fails fails the
    caller."""
    import torch.multiprocessing as mp

    with open(os.path.join(out_dir, "spec.json"), "w") as f:
        json.dump(spec, f)
    np.savez(os.path.join(out_dir, "spec.npz"), **arrays)
    init_file = os.path.join(out_dir, "rendezvous")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, world, init_file, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout_s)
            assert not p.is_alive(), f"rank {procs.index(p)} hung"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert [p.exitcode for p in procs] == [0] * world
    out = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out
