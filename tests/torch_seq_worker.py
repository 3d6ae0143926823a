"""One rank of the sequence-parallel tests' multi-process runs (gloo), and
the harness that starts them: tests/test_torch_ringattn.py and
tests/test_torch_seq_parallel.py call ``run_ranks``.

Each rank is a child process with an explicit environment (started by
``torch_xstep_worker.run_children``, which kills a group that outlives its
timeout), run as ``python tests/torch_seq_worker.py RANK WORLD RENDEZVOUS
OUT_DIR``. It imports torch and the port only (no JAX), reads
``<out_dir>/spec.json`` and ``spec.npz``, runs the spec's tasks in order and
writes ``<out_dir>/rank<r>.npz``. Rank r of a world of W ranks at seq
extent S has data index r // S and ring position r % S
(``parallel.mesh.seq_groups``); it holds the rows of its data index and
the time slice of its ring position:

  * ``ring``: for each case of the spec (``q``, ``k``, ``v``, ``go`` global
    (B, T, H, D) arrays, causal or not), ``ring_attention`` on this rank's
    time slice and its q, k, v gradients under the upstream gradient
    ``go``; the output and the gradients' slices, and the point-to-point
    operations the forward and the backward launched;
  * ``step``: the small transformer from the spec's Flax weights, one
    ``TrainStep`` (plain SGD, lr 0.1) on the spec's global batch: the loss
    and the parameters (Flax layout, leaf order), for each reducer of ``reducers``
    (``none``: the plain per-leaf mean over the world; ``wfbp``: the merged
    all-reduce over the world);
  * ``eval``: ``lm_eval_sums`` of the same model on this rank's slice of
    the eval batch, summed over the world;
  * ``trainer``: ``Trainer`` with ``seq_parallel`` S on the registered
    transformer at the spec's narrow width (synthetic PTB; the backward
    profile with ``profile``, checkpoints under ``ckpt``): one epoch of
    ``batches`` steps, ``evaluate`` and the epoch's boundary checkpoint;
    the train loss, the eval metrics,
    the sizes and the point-to-point operations of the construction and
    of the epoch.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_xstep_worker import run_children  # noqa: E402


def run_ranks(world: int, out_dir: str, spec: dict, arrays: dict = None,
              timeout_s: float = 120.0) -> list[dict]:
    """``world`` ranks of this worker on ``spec`` (and ``arrays``); each
    rank's outputs."""
    with open(os.path.join(out_dir, "spec.json"), "w") as f:
        json.dump(spec, f)
    np.savez(os.path.join(out_dir, "spec.npz"), **(arrays or {}))
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


def _slice(a: np.ndarray, pos: int, seq: int, axis: int = 1) -> np.ndarray:
    t = a.shape[axis] // seq
    return np.take(a, np.arange(pos * t, (pos + 1) * t), axis=axis)


def _ring(spec, arrays, ctx, out) -> None:
    import torch

    from mgwfbp_tpu_torch.parallel import ringattn

    group, pos, seq = ctx["group"], ctx["pos"], ctx["seq"]
    for name, causal in spec["cases"]:
        q, k, v = (torch.tensor(_slice(arrays[f"{name}_{t}"], pos, seq),
                                requires_grad=True) for t in "qkv")
        go = torch.tensor(_slice(arrays[f"{name}_go"], pos, seq))
        before = ringattn.p2p_ops
        o = ringattn.ring_attention(q, k, v, group, causal=causal)
        fwd = ringattn.p2p_ops - before
        (o * go).sum().backward()
        out[f"{name}_out"] = o.detach().numpy()
        for t, leaf in zip("qkv", (q, k, v)):
            out[f"{name}_d{t}"] = leaf.grad.numpy()
        out[f"{name}_p2p"] = np.asarray(
            [fwd, ringattn.p2p_ops - before - fwd])


def small_transformer(spec):
    from mgwfbp_tpu_torch.models.transformer import TransformerLM

    return TransformerLM(
        vocab_size=spec["vocab"], d_model=spec["d_model"],
        num_heads=spec["heads"], num_layers=spec["layers"],
        d_ff=spec["d_ff"], max_len=spec["window"], dropout=0.0)


def _weights(model, arrays) -> None:
    from mgwfbp_tpu_torch.convert import state_from_flax

    params = {k[len("params/"):]: arrays[k] for k in arrays.files
              if k.startswith("params/")}
    model.load_state_dict(state_from_flax(model, params))


def _step(spec, arrays, ctx, out) -> None:
    import torch

    from mgwfbp_tpu_torch.convert import flatten_flax, variables_to_flax
    from mgwfbp_tpu_torch.parallel.allreduce import make_merged_allreduce
    from mgwfbp_tpu_torch.parallel.costmodel import AlphaBeta
    from mgwfbp_tpu_torch.train.step import TrainStep

    group, pos, seq, d, data = (ctx[k] for k in
                                ("group", "pos", "seq", "data", "ndata"))
    rows = arrays["x"].shape[1] // data
    x = _slice(arrays["x"][:, d * rows:(d + 1) * rows], pos, seq, axis=2)
    y = _slice(arrays["y"][:, d * rows:(d + 1) * rows], pos, seq, axis=2)
    for name in spec["reducers"]:
        model = small_transformer(spec)
        _weights(model, arrays)
        model.set_seq_group(group)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        reducer = None if name == "none" else make_merged_allreduce(
            model, policy=name, cost_model=AlphaBeta(1e-5, 1e-10))
        step = TrainStep(model, opt, lambda s: 0.1, reducer=reducer,
                         task="lm", seq_group=group)
        m = step(torch.from_numpy(x), torch.from_numpy(y))
        out[f"step_{name}_loss"] = np.asarray(m["loss"])
        params = flatten_flax(variables_to_flax(model)[0])
        for j, a in enumerate(params.values()):
            out[f"step_{name}_p{j}"] = a


def _eval(spec, arrays, ctx, out) -> None:
    import torch
    import torch.distributed as dist

    from mgwfbp_tpu_torch.train.step import lm_eval_sums

    group, pos, seq = ctx["group"], ctx["pos"], ctx["seq"]
    model = small_transformer(spec)
    _weights(model, arrays)
    model.set_seq_group(group)
    model.eval()
    x = torch.from_numpy(_slice(arrays["x"][0], pos, seq))
    y = torch.from_numpy(_slice(arrays["y"][0], pos, seq))
    sums, _ = lm_eval_sums(model, x, y)
    dist.all_reduce(sums)
    out["eval_sums"] = sums.numpy()


def _trainer(spec, arrays, ctx, out) -> None:
    from mgwfbp_tpu_torch import models as pzoo
    from mgwfbp_tpu_torch.config import make_config
    from mgwfbp_tpu_torch.models import ModelMeta
    from mgwfbp_tpu_torch.parallel import ringattn
    from mgwfbp_tpu_torch.train.trainer import Trainer

    def narrow(nc=None, hwc=None):
        nc = nc or 10000
        return (small_transformer(dict(spec, vocab=nc)),
                ModelMeta("transformer", "ptb", nc, (spec["window"],),
                          np.int32, "lm", has_carry=False))

    pzoo._REGISTRY["transformer"] = narrow
    cfg = make_config(
        "transformer", batch_size=spec["batch"], max_epochs=1,
        num_batches_per_epoch=spec["batches"], logdir=spec["logdir"],
        checkpoint_dir=spec.get("ckpt"), seq_parallel=ctx["seq"], seed=3,
        num_steps=spec["window"])
    before = ringattn.p2p_ops
    t = Trainer(cfg, device="cpu", synthetic_data=True,
                profile_backward=spec.get("profile", False))
    out["trainer_init_p2p"] = np.asarray(ringattn.p2p_ops - before)
    before = ringattn.p2p_ops
    m = t.train_epoch(0)
    out["trainer_p2p"] = np.asarray(ringattn.p2p_ops - before)
    ev = t.evaluate()
    out["trainer_loss"] = np.asarray(m["loss"])
    out["trainer_sizes"] = np.asarray([t.data_size, t.seq_size,
                                       t.seq_index, t.data_index])
    for k in ("loss", "count", "perplexity"):
        out[f"trainer_eval_{k}"] = np.asarray(ev[k])
    if t.checkpointer is not None:
        t._save_snapshot(0, spec["batches"], False, wait=True)
    t.close()


TASKS = {"ring": _ring, "step": _step, "eval": _eval, "trainer": _trainer}


def main(rank: int, world: int, rdv: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    torch.manual_seed(0)
    torch.set_num_threads(1)
    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    arrays = np.load(os.path.join(out_dir, "spec.npz"))
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=world, rank=rank)
    try:
        from mgwfbp_tpu_torch.parallel.mesh import seq_groups

        seq = int(spec["seq"])
        ctx = {"seq": seq, "pos": rank % seq, "data": rank // seq,
               "ndata": world // seq}
        out: dict = {}
        for task in spec["tasks"]:
            if task != "trainer" and "group" not in ctx:
                ctx["group"] = seq_groups(seq)
            TASKS[task](spec.get(task, spec), arrays, ctx, out)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        from mgwfbp_tpu_torch.runtime import coordination

        coordination.release()
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
