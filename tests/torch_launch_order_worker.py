"""One rank of the launch-sequence tests' multi-process runs (gloo),
started by tests/test_torch_launch_order.py through
``torch_xstep_worker.run_children`` as ``python
tests/torch_launch_order_worker.py RANK WORLD RENDEZVOUS OUT_DIR``. It
imports torch and the port only (no JAX), reads ``<out_dir>/spec.json``
and writes ``<out_dir>/rank<r>.npz``.

Every run trains ResNet-20 at its published widths from one seeded
initialisation over seeded global batches (``batch`` images a rank) with
``TrainStep`` and the merged collectives, and records per step the
groups launched (``launch_log``), the hooks' order (``arrivals``), the
reducer's ``launch_sequence`` and, on rs_fwd_ag, the groups
``gather_params`` launched; after the last step its reduced gradients
(``.grad`` after ``synchronize``; the mean shards on rs_opt_ag and
rs_fwd_ag) and the parameters (rs_fwd_ag's materialized first). A run is
one of:

  * ``measured``: the reducer as built (its first armed backward measures
    the launch sequence, every later one follows it);
  * ``pinned``: the same with the sequence pinned to group-index order
    (``pin_index_order``), the comparison the measured run must equal
    bit for bit;
  * ``forced``: as ``measured``, but on the last rank every hook is held
    back until the backward has produced every gradient and then
    delivered in arrival-position order, so that rank's hooks fire in
    another order than rank 0's;
  * ``accumulate``: two micro-steps a step (the first one disarmed);
  * ``reattach``: after ``steps`` steps the reducer is detached and
    attached again, and ``steps`` more steps run.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NC = 10


def pin_index_order(reducer) -> None:
    """Keep ``reducer`` in group-index order: mark its sequences adopted
    before it measures (a test-only helper; no run of the port pins)."""
    reducer._order_state = "adopted"


def _flat(tensors) -> np.ndarray:
    import torch

    return torch.cat([t.detach().reshape(-1).cpu() for t in tensors]).numpy()


def _forced(reducer) -> None:
    """Hold this rank's hooks until every gradient exists, then deliver
    them in arrival-position order, whatever order autograd produced them
    in."""
    deliver = reducer._on_grad
    held: list[int] = []

    def on_grad(k: int) -> None:
        if not reducer._active:
            return
        held.append(k)
        if len(held) == len(reducer.arrival_params):
            for kk in sorted(held):
                deliver(kk)
            held.clear()

    reducer._on_grad = on_grad


def _run(spec: dict, run: dict, rank: int, world: int, levels, out: dict):
    import torch

    from mgwfbp_tpu_torch.convert import flax_leaves, keystr
    from mgwfbp_tpu_torch.models import create_model
    from mgwfbp_tpu_torch.models.common import init_weights
    from mgwfbp_tpu_torch.optim import make_optimizer
    from mgwfbp_tpu_torch.parallel.allreduce import (
        SHARDED_OPS,
        make_merged_allreduce,
    )
    from mgwfbp_tpu_torch.parallel.compression import make_compressor
    from mgwfbp_tpu_torch.parallel.costmodel import lookup_alpha_beta
    from mgwfbp_tpu_torch.train.step import TrainStep

    label, op, mode = run["label"], run["op"], run["mode"]
    b, steps = spec["batch"], spec["steps"]
    n = 2 if mode == "accumulate" else 1
    total = 2 * steps if mode == "reattach" else steps
    rs = np.random.RandomState(spec["seed"])
    xs = rs.randn(total, n, b * world, 3, 32, 32).astype(np.float32)
    ys = rs.randint(0, NC, (total, n, b * world))
    model, _ = create_model("resnet20")
    init_weights(model, torch.Generator().manual_seed(spec["seed"]))
    clip = run.get("clip")
    opt, lr_fn, _, optim_spec = make_optimizer(
        model.parameters(), 0.1, momentum=0.9, weight_decay=1e-4,
        num_batches_per_epoch=total, norm_clip=clip, world_size=world,
        return_spec=True)
    reducer = make_merged_allreduce(
        model, policy=run.get("policy", "wfbp"),
        cost_model=lookup_alpha_beta("10GbE", world),
        comm_op="all_reduce" if op == "topk" else op, world_size=world,
        compressor=make_compressor("topk", 0.05) if op == "topk" else None,
        optim_spec=optim_spec if op in SHARDED_OPS else None,
        levels=levels if op == "hier" else None)
    if mode == "pinned":
        pin_index_order(reducer)
    if mode == "forced" and rank == world - 1:
        _forced(reducer)
    gathered: list[int] = []
    if op == "rs_fwd_ag":
        launch_gather = reducer._launch_gather

        def logged(gi, shard):
            gathered.append(gi)
            return launch_gather(gi, shard)

        reducer._launch_gather = logged
    # the reduced gradients of each step: .grad after synchronize, or the
    # sharded lowerings' mean shards
    reduced: list = []
    leaves = [p for _, p in flax_leaves(model)]
    if op in SHARDED_OPS:
        shards = reducer._reduced_shards

        def kept_shards(what):
            got = shards(what)
            reduced[:] = [_flat(got)]
            return got

        reducer._reduced_shards = kept_shards
    else:
        sync = reducer.synchronize

        def kept_sync():
            got = sync()
            reduced[:] = [_flat([p.grad for p in leaves])]
            return got

        reducer.synchronize = kept_sync
    step = TrainStep(model, opt, lr_fn, reducer=reducer, nsteps_update=n,
                     norm_clip=optim_spec.norm_clip)
    for k in range(total):
        if mode == "reattach" and k == steps:
            reducer.detach()
            out[f"{label}/sequence_after_detach"] = np.asarray(
                reducer.launch_sequence)
            reducer.attach()
        gathered.clear()
        x = torch.from_numpy(xs[k, :, rank * b:(rank + 1) * b])
        y = torch.from_numpy(ys[k, :, rank * b:(rank + 1) * b])
        before = reducer.launches
        step(x, y)
        out[f"{label}/launches{k + 1}"] = np.int64(reducer.launches - before)
        out[f"{label}/launch_log{k + 1}"] = np.asarray(reducer.launch_log)
        out[f"{label}/arrivals{k + 1}"] = np.asarray(reducer.arrivals)
        out[f"{label}/sequence{k + 1}"] = np.asarray(reducer.launch_sequence)
        out[f"{label}/gathered{k + 1}"] = np.asarray(gathered, np.int64)
    if op == "rs_fwd_ag":
        out[f"{label}/gather_sequence"] = np.asarray(reducer.gather_sequence)
        reducer.materialize()
    out[f"{label}/grads"] = reduced[0]
    out[f"{label}/params"] = _flat(leaves)
    out[f"{label}/groups"] = np.asarray(json.dumps(
        [list(map(int, g)) for g in reducer.layout.groups]))
    out[f"{label}/group_of"] = np.asarray(reducer.group_of)
    names = [keystr(path) for path, _ in flax_leaves(model)]
    out[f"{label}/stem"] = np.asarray([
        k for k, j in enumerate(reducer.perm)
        if names[j].startswith("['ConvBN_0']")])
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
        from mgwfbp_tpu_torch.parallel.mesh import two_level_groups

        levels = two_level_groups(spec["dcn"]) if spec.get("dcn") else None
        out: dict = {}
        for run in spec["runs"]:
            _run(spec, run, rank, world, levels, out)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
