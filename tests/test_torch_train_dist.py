"""Port vs reference, across processes: the merged all-reduce and the
train step under torch.distributed (gloo, one process per rank, started
with torch.multiprocessing; tests/torch_dist_worker.py is the rank's body).

  * merged all-reduce == the same gradients all-reduced leaf by leaf, for
    the policies mgwfbp/threshold/single/wfbp: bit for bit at 2 ranks (a
    sum of two does not depend on its order); at 4 ranks gloo's ring
    chunking sets each element's summation order, so the bound is the
    float32 reassociation bound of two 4-term sums, elementwise
    2 * (W - 1) * 2^-24 * sum_r |g_r| / W;
  * groups launch in index order on every rank, and a micro-step that is
    not the last launches nothing;
  * a 4-rank port TrainStep matches ``make_train_step`` on a 4-device JAX
    CPU mesh (same initial weights, same global batches, mgwfbp schedule)
    after 1 and 5 steps, with nsteps_update 1 and 2 (tolerance TRAJ_*);
  * a step whose batch holds a NaN on one rank keeps the whole state
    (parameters, batch statistics, optimizer state, step counter) in both
    packages.

Every process join has its own timeout, so a hang fails the test.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from mgwfbp_tpu.models import ModelMeta
from mgwfbp_tpu.models.resnet_cifar import CifarResNet as JaxResNet
from mgwfbp_tpu.optim import make_optimizer as jax_make_optimizer
from mgwfbp_tpu.parallel.allreduce import make_merged_allreduce as jax_reducer
from mgwfbp_tpu.parallel.costmodel import lookup_alpha_beta as jax_lookup
from mgwfbp_tpu.parallel.mesh import MeshSpec, make_mesh
from mgwfbp_tpu.train.step import TrainState, make_train_step
from mgwfbp_tpu_torch.convert import flatten_flax

import torch_dist_worker

DEPTH, WIDTHS, NC, HW, B = 8, (4, 8, 16), 10, 16, 4
LR, BPE, STEPS = 0.1, 2, 5
POLICIES = torch_dist_worker.POLICIES
JOIN_TIMEOUT_S = 150
# 5 SGD steps of the same float32 math in another order (XLA's fused convs
# and psum tree vs torch's kernels and gloo's ring) hold the repo's
# cross-program bound; measured max abs error 1.2e-07 on params and 3.0e-07
# on batch statistics (both of magnitude up to ~2)
TRAJ_RTOL, TRAJ_ATOL = 2e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _spawn(world: int, out_dir: str, spec: dict, arrays: dict) -> list[dict]:
    with open(os.path.join(out_dir, "spec.json"), "w") as f:
        json.dump(spec, f)
    np.savez(os.path.join(out_dir, "spec.npz"), **arrays)
    init_file = os.path.join(out_dir, "rendezvous")
    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(target=torch_dist_worker.run,
                    args=(r, world, init_file, out_dir))
        for r in range(world)
    ]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
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


def _init_weights(seed: int = 0):
    model = JaxResNet(depth=DEPTH, widths=WIDTHS, num_classes=NC)
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, HW, HW, 3)),
                   train=False)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    bstats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    return model, params, bstats


def _arrays(params, bstats, world: int, seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    out = {f"params/{k}": a for k, a in flatten_flax(params).items()}
    out.update({f"bstats/{k}": a for k, a in flatten_flax(bstats).items()})
    out["merge_x"] = rng.randn(world * B, HW, HW, 3).astype(np.float32)
    out["merge_y"] = rng.randint(0, NC, world * B).astype(np.int32)
    for n in (1, 2):
        out[f"x_n{n}"] = rng.randn(STEPS, n, world * B, HW, HW, 3).astype(
            np.float32
        )
        out[f"y_n{n}"] = rng.randint(0, NC, (STEPS, n, world * B)).astype(
            np.int32
        )
    return out


def _spec(**kw) -> dict:
    return dict(depth=DEPTH, widths=list(WIDTHS), num_classes=NC, batch=B,
                threshold=2000, lr=LR, batches_per_epoch=BPE, **kw)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    _, params, bstats = _init_weights()
    d = str(tmp_path_factory.mktemp("gloo2"))
    return _spawn(2, d, _spec(tasks=["merge"]), _arrays(params, bstats, 2))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    model, params, bstats = _init_weights()
    arrays = _arrays(params, bstats, 4)
    d = str(tmp_path_factory.mktemp("gloo4"))
    ranks = _spawn(
        4, d, _spec(tasks=["merge"], train_nsteps=[1, 2], nan_step=True),
        arrays,
    )
    return ranks, (model, params, bstats, arrays)


@pytest.mark.parametrize("policy", POLICIES)
def test_merged_equals_leafwise_at_two_ranks_bitwise(two_ranks, policy):
    for r in two_ranks:
        assert bool(r[f"{policy}/bitwise"]), policy


@pytest.mark.parametrize("policy", POLICIES)
def test_merged_within_reassociation_bound_at_four_ranks(four_ranks, policy):
    for r in four_ranks[0]:
        assert float(r[f"{policy}/excess_over_bound"]) <= 0.0, policy


def test_groups_launch_in_index_order_on_every_rank(two_ranks, four_ranks):
    for ranks in (two_ranks, four_ranks[0]):
        for policy in POLICIES:
            logs = [r[f"{policy}/launch_log"].tolist() for r in ranks]
            g = int(ranks[0][f"{policy}/num_groups"])
            assert all(log == logs[0] for log in logs), (policy, logs)
            assert all(log == list(range(g)) for log in logs), (policy, logs)
            assert all(int(r[f"{policy}/launches"]) == g for r in ranks)
    # the policies really differ in how many collectives they issue
    counts = {p: int(two_ranks[0][f"{p}/num_groups"]) for p in POLICIES}
    leaves = 29  # stem 3, 3 blocks x 6, 2 shortcuts x 3, fc 2
    assert counts["single"] == 1 and counts["wfbp"] == leaves
    assert 1 < counts["threshold"] < leaves


def test_microstep_that_is_not_the_last_launches_nothing(two_ranks, four_ranks):
    for ranks in (two_ranks, four_ranks[0]):
        for r in ranks:
            for policy in POLICIES:
                assert int(r[f"{policy}/inactive_launches"]) == 0


def _jax_run(model, params, bstats, arrays, n: int, world: int = 4):
    meta = ModelMeta(name="resnet8", dataset="cifar10", num_classes=NC,
                     input_shape=(HW, HW, 3))
    tx, _ = jax_make_optimizer(
        LR, momentum=0.9, weight_decay=1e-4, lr_schedule="auto",
        dataset="cifar10", max_epochs=141, warmup_epochs=5,
        num_batches_per_epoch=BPE,
    )
    mesh = make_mesh(MeshSpec(data=world), devices=jax.devices()[:world])
    reducer = jax_reducer(params, axis_name="data", policy="mgwfbp",
                          cost_model=jax_lookup("10GbE", world))
    step = make_train_step(model, meta, tx, mesh, reducer, nsteps_update=n,
                           donate=False)
    state = TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=bstats,
        opt_state=tx.init(params), rng=jax.random.PRNGKey(0),
    )
    saved = {}
    for k in range(STEPS):
        state, _ = step(state, {"x": arrays[f"x_n{n}"][k],
                                "y": arrays[f"y_n{n}"][k]})
        if k + 1 in (1, 5):
            saved[k + 1] = state
    if n != 1:
        return saved, None, None, None
    # the NaN step: a NaN in the last device's slice of the first batch
    x = np.array(arrays[f"x_n{n}"][0])
    x[0, (world - 1) * B, 0, 0, 0] = np.nan
    after, metrics = step(state, {"x": x, "y": arrays[f"y_n{n}"][0]})
    return saved, state, after, metrics


@pytest.fixture(scope="module")
def jax_runs(four_ranks):
    model, params, bstats, arrays = four_ranks[1]
    return {n: _jax_run(model, params, bstats, arrays, n) for n in (1, 2)}


@pytest.mark.parametrize("n,after", [(1, 1), (1, 5), (2, 1), (2, 5)])
def test_four_rank_step_matches_jax_mesh(four_ranks, jax_runs, n, after):
    ranks = four_ranks[0]
    state = jax_runs[n][0][after]
    want = {f"params/{k}": np.asarray(v)
            for k, v in flatten_flax(state.params).items()}
    want.update({f"bstats/{k}": np.asarray(v)
                 for k, v in flatten_flax(state.batch_stats).items()})
    prefix = f"train_n{n}/s{after}/"
    for r in ranks:
        assert int(r[prefix + "step"]) == after == int(state.step)
        for key, w in want.items():
            np.testing.assert_allclose(
                r[prefix + key], w, rtol=TRAJ_RTOL, atol=TRAJ_ATOL,
                err_msg=f"{key} after {after} step(s), nsteps_update={n}",
            )
    # replicas stay bit-identical across ranks
    for key in want:
        assert all(np.array_equal(r[prefix + key], ranks[0][prefix + key])
                   for r in ranks)


def test_nan_step_keeps_the_whole_state_in_both_packages(four_ranks, jax_runs):
    for r in four_ranks[0]:
        assert float(r["nan_n1/nonfinite"]) > 0
        assert bool(r["nan_n1/unchanged"])
    _, before, after, metrics = jax_runs[1]
    assert float(metrics["grads_nonfinite"]) > 0
    same = jax.tree_util.tree_map(
        lambda a, b: np.array_equal(np.asarray(a), np.asarray(b)),
        before, after,
    )
    assert all(jax.tree_util.tree_leaves(same))
