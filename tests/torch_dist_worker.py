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
    steps 1 and 5, one run per ``nsteps_update``, at the spec's compute
    ``dtype`` (float32 when absent);
  * ``nan``: a step whose batch holds a NaN on one rank leaves the whole
    state (parameters, batch statistics, momentum, step counter) as it was;
  * ``lm_nsteps``: the same for the small PTB LSTM and its BPTT carry
    (tests/test_torch_train_lm.py): the port's TrainStep from the spec's
    initial weights and a zero carry over the spec's global token batches
    (this rank's rows), parameters and carry saved after steps 1 and 3,
    one run per ``nsteps_update``; then a step whose batch holds a token
    outside the vocabulary on the last rank (a NaN embedding row) leaves
    parameters, momentum, step counter and carry as they were;
  * ``zoo`` (tests/test_torch_zoo_small.py): for each named registry model
    (dropout off), the port's TrainStep with the mgwfbp merged all-reduce
    from the spec's initial weights over the spec's global batches (this
    rank's slice), parameters, the groups and each step's all-reduce
    launches saved after every step;
  * ``an4`` (tests/test_torch_an4_train.py): the small DeepSpeech from
    the spec's weights and batch statistics, the port's ctc TrainStep with
    the mgwfbp merged all-reduce and the an4 preset's optimizer (anneal,
    norm clip scaled to the world) over the spec's global ctc batches
    (this rank's rows), the state saved after steps 1 and 3;
  * ``drain`` (run in a world of its own, which ``train_cli.main`` starts
    and tears down three times over file rendezvous): a narrow ResNet-20
    through ``train_cli.main`` uninterrupted (run A), then with
    ``MGWFBP_FAULT_PLAN=preempt@step=3,proc=0`` so that only rank 0 gets a
    SIGTERM (run B), then the same command again (run B2, the resume);
    each rank records the three exit codes, its printed ``preempted`` line,
    its ``preempt`` and ``resume`` telemetry events, and the params and
    momentum of A's and B2's last committed steps.
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
from mgwfbp_tpu_torch.models.lstm import PTBLSTM  # noqa: E402
from mgwfbp_tpu_torch.models.resnet_cifar import CifarResNet  # noqa: E402
from mgwfbp_tpu_torch.optim import (  # noqa: E402
    make_optimizer,
    scaled_clip_threshold,
)
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
    step = TrainStep(model, opt, lr_fn, reducer=reducer, nsteps_update=n,
                     compute_dtype=getattr(torch, spec["dtype"])
                     if spec.get("dtype") else None)
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


def _lm_state(model, step, carry) -> dict:
    out = _state(model, step)
    for li, (c, h) in enumerate(carry):
        out[f"carry/{li}/c"] = c.detach().numpy().copy()
        out[f"carry/{li}/h"] = h.detach().numpy().copy()
    return out


def _lm_train(spec, arrays, rank, world, out, n: int) -> None:
    lm = spec["lm"]
    model = PTBLSTM(lm["vocab"], lm["hidden"], 2, 0.0)
    params = {k[len("lm_params/"):]: arrays[k] for k in arrays.files
              if k.startswith("lm_params/")}
    model.load_state_dict(state_from_flax(model, params))
    b = lm["batch"]
    opt, lr_fn, _ = make_optimizer(
        model.parameters(), lm["lr"], momentum=lm["momentum"],
        weight_decay=0.0, lr_schedule="ptb", dataset="ptb",
        num_batches_per_epoch=lm["batches_per_epoch"],
    )
    reducer = make_merged_allreduce(
        model, policy="mgwfbp", cost_model=lookup_alpha_beta("10GbE", world)
    )
    step = TrainStep(model, opt, lr_fn, reducer=reducer, nsteps_update=n,
                     norm_clip=scaled_clip_threshold(lm["norm_clip"], world),
                     task="lm")
    carry = model.initial_carry(b)
    xs, ys = arrays[f"lm_x_n{n}"], arrays[f"lm_y_n{n}"]
    rows = slice(rank * b, (rank + 1) * b)
    for k in range(xs.shape[0]):
        x = torch.from_numpy(xs[k][:, rows])
        y = torch.from_numpy(ys[k][:, rows])
        m, carry = step(x, y, carry)
        out[f"lm_n{n}/metrics{k + 1}"] = np.asarray(
            [m["loss"], m["perplexity"], m["grads_nonfinite"]]
        )
        if k + 1 in (1, 3):
            for key, v in _lm_state(model, step, carry).items():
                out[f"lm_n{n}/s{k + 1}/{key}"] = v
    if n == 1:
        # one more step whose batch holds a token outside the vocabulary
        # on the last rank only: its embedding row is NaN, as in jnp.take
        before = _lm_state(model, step, carry)
        x = torch.from_numpy(xs[0][:, rows].copy())
        if rank == world - 1:
            x[0, 0, 0] = lm["vocab"]
        m, carry = step(x, torch.from_numpy(ys[0][:, rows]), carry)
        after = _lm_state(model, step, carry)
        out["lm_nan/nonfinite"] = np.float64(m["grads_nonfinite"])
        out["lm_nan/unchanged"] = np.bool_(
            before.keys() == after.keys()
            and all(np.array_equal(before[k], after[k]) for k in before)
        )
    reducer.detach()


def _zoo(spec, arrays, rank, world, out) -> None:
    from mgwfbp_tpu_torch import models as zoo

    z = spec["zoo"]
    b = z["batch"]
    rows = slice(rank * b, (rank + 1) * b)
    for name in z["models"]:
        model, meta = zoo.create_model(name)
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        prefix = f"{name}/params/"
        model.load_state_dict(state_from_flax(model, {
            k[len(prefix):]: arrays[k] for k in arrays.files
            if k.startswith(prefix)}))
        opt, lr_fn, _ = make_optimizer(
            model.parameters(), z["lr"], momentum=0.9, weight_decay=1e-4,
            lr_schedule="auto", dataset=meta.dataset, max_epochs=141,
            warmup_epochs=5, num_batches_per_epoch=z["batches_per_epoch"],
        )
        reducer = make_merged_allreduce(
            model, policy="mgwfbp", cost_model=lookup_alpha_beta("10GbE", world)
        )
        step = TrainStep(model, opt, lr_fn, reducer=reducer)
        out[f"{name}/groups"] = np.int64(reducer.num_groups)
        xs, ys = arrays[f"{name}/x"], arrays[f"{name}/y"]
        for k in range(xs.shape[0]):
            before = reducer.launches
            step(_nchw(xs[k][rows])[None],
                 torch.from_numpy(ys[k][rows]).long()[None])
            out[f"{name}/s{k + 1}/launches"] = np.int64(
                reducer.launches - before)
            for key, v in flatten_flax(variables_to_flax(model)[0]).items():
                out[f"{name}/s{k + 1}/{key}"] = v
        reducer.detach()


def _an4(spec, arrays, rank, world, out) -> None:
    from mgwfbp_tpu_torch.models.deepspeech import DeepSpeech

    a = spec["an4"]
    model = DeepSpeech(hidden_size=a["hidden"], num_layers=a["layers"])
    params = {k[len("an4_params/"):]: arrays[k] for k in arrays.files
              if k.startswith("an4_params/")}
    bstats = {k[len("an4_bstats/"):]: arrays[k] for k in arrays.files
              if k.startswith("an4_bstats/")}
    model.load_state_dict(state_from_flax(model, params, bstats))
    opt, lr_fn, _ = make_optimizer(
        model.parameters(), a["lr"], momentum=0.9, weight_decay=1e-4,
        lr_schedule="anneal", dataset="an4", max_epochs=100,
        num_batches_per_epoch=a["batches_per_epoch"],
    )
    reducer = make_merged_allreduce(
        model, policy="mgwfbp", cost_model=lookup_alpha_beta("10GbE", world)
    )
    step = TrainStep(model, opt, lr_fn, reducer=reducer, task="ctc",
                     norm_clip=scaled_clip_threshold(a["norm_clip"], world))
    b = a["batch"]
    rows = slice(rank * b, (rank + 1) * b)
    fields = [arrays[f"an4_{k}"] for k in ("x", "y", "ilen", "llen")]
    for k in range(fields[0].shape[0]):
        x, y, ilen, llen = (torch.from_numpy(f[k][:, rows]) for f in fields)
        m = step(x, y.long(), lengths=(ilen.long(), llen.long()))
        out[f"an4/metrics{k + 1}"] = np.asarray(
            [m["loss"], m["grads_nonfinite"]])
        if k + 1 in (1, 3):
            for key, v in _state(model, step).items():
                out[f"an4/s{k + 1}/{key}"] = v
    reducer.detach()


def _drain(spec, rank, world, out_dir, out) -> None:
    import contextlib
    import io

    from mgwfbp_tpu_torch import models as zoo
    from mgwfbp_tpu_torch import train_cli
    from mgwfbp_tpu_torch.checkpoint import Checkpointer, read_step
    from mgwfbp_tpu_torch.models import ModelMeta
    from mgwfbp_tpu_torch.telemetry import events_of, read_events

    d = spec["drain"]

    def narrow(nc):
        nc = nc or 10
        return (CifarResNet(depth=spec["depth"], widths=tuple(spec["widths"]),
                            num_classes=nc),
                ModelMeta("resnet20", "cifar10", nc, (32, 32, 3)))

    zoo._REGISTRY["resnet20"] = narrow

    def cli(run: str, ckpt: str, plan: str = "") -> tuple[int, str]:
        os.environ["MGWFBP_FAULT_PLAN"] = plan
        argv = [
            "--dnn", "resnet20", "--synthetic", "--device", "cpu",
            "--epochs", "1", "--num-batches-per-epoch", str(d["steps"]),
            "--batch-size", str(spec["batch"]), "--policy", "mgwfbp",
            "--connection", "10GbE", "--no-profile-backward",
            "--ckpt-every-steps", "2", "--telemetry",
            "--checkpoint-dir", os.path.join(out_dir, ckpt),
            "--logdir", os.path.join(out_dir, f"logs_{ckpt}"),
            "--coordinator", f"file://{os.path.join(out_dir, 'rdv_' + run)}",
            "--num-processes", str(world), "--process-id", str(rank),
        ]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train_cli.main(argv)
        return rc, buf.getvalue().strip().splitlines()[-1]

    rc_a, _ = cli("a", "ckpt_a")
    rc_b, line_b = cli("b", "ckpt_b", "preempt@step=3,proc=0")
    rc_b2, _ = cli("b2", "ckpt_b")
    out["drain/rcs"] = np.asarray([rc_a, rc_b, rc_b2])
    out["drain/preempted"] = np.asarray(line_b)
    (tag,) = os.listdir(os.path.join(out_dir, "ckpt_b"))
    recs = read_events(os.path.join(out_dir, "logs_ckpt_b", tag,
                                    f"telemetry.p{rank}.jsonl"))
    out["drain/preempt_events"] = np.asarray(
        json.dumps(events_of(recs, "preempt")))
    out["drain/resume_events"] = np.asarray(
        json.dumps(events_of(recs, "resume")))
    for run in ("a", "b"):
        ckdir = os.path.join(out_dir, f"ckpt_{run}", tag)
        last = Checkpointer(ckdir).latest_step()
        params, bstats, meta = read_step(ckdir, last)
        out[f"drain/{run}/step"] = np.int64(last)
        for k, v in {**params, **bstats}.items():
            out[f"drain/{run}/{k}"] = v
        p0 = os.path.join(ckdir, "sharded", f"{last:08d}", "p00000")
        for name in os.listdir(p0):
            if name.startswith("opt."):
                out[f"drain/{run}/{name[:-4]}"] = np.load(
                    os.path.join(p0, name))


def run(rank: int, world: int, init_file: str, out_dir: str) -> None:
    torch.manual_seed(0)
    torch.set_num_threads(1)
    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    if "drain" in spec["tasks"]:
        out: dict[str, np.ndarray] = {}
        _drain(spec, rank, world, out_dir, out)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        return
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", world_size=world, rank=rank
    )
    try:
        arrays = np.load(os.path.join(out_dir, "spec.npz"))
        out: dict[str, np.ndarray] = {}
        if "merge" in spec["tasks"]:
            _merge(spec, arrays, rank, world, out)
        for n in spec.get("train_nsteps", ()):
            _train(spec, arrays, rank, world, out, n)
        for n in spec.get("lm_nsteps", ()):
            _lm_train(spec, arrays, rank, world, out, n)
        if "zoo" in spec["tasks"]:
            _zoo(spec, arrays, rank, world, out)
        if "an4" in spec["tasks"]:
            _an4(spec, arrays, rank, world, out)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
