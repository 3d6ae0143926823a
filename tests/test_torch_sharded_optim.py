"""The port's rs_ag and rs_opt_ag lowerings (the sharded optimizer) against
the JAX package's functions and against the port's own all_reduce path, on
the CPU.

The JAX package's trajectories of these paths are not the oracle (some of
its own tests of them fail; ROADMAP.md "Rules for every item"). The port
is held against:

  * JAX's functions on the same inputs: ``OptimSpec`` from
    ``make_optimizer(return_spec=True)``; ``ShardedOptimStep.update_shard``
    for sgd, sgd+nesterov, sgd+wd, adam, adamw and the clip, in float32
    (1e-6) and float64 (1e-12); the layout helpers (``shard_size``,
    ``padded_size``, ``decay_mask_vec``, ``manifest_layout``, the state
    bytes) for a narrow ResNet-20 at worlds 2, 3 and 4; one
    ``reduce_and_update`` at 4 gloo ranks against ``merged_rs_opt_ag`` on
    a 4-device mesh (1e-6); ``effective_cost_fn`` with ``update_beta``;
  * its own all_reduce path: 10 steps of rs_ag and of rs_opt_ag (SGD
    momentum, weight decay, the scaled norm clip) at 2 ranks in float32
    (1e-6) and float64 (1e-12), and at 3 ranks, where the buckets do not
    divide and carry padding; the ranks' parameters bit-identical after
    every step; the optimizer state at 1/world of the replicated bytes
    plus the pad;
  * the construction errors, as JAX raises them.

Multi-rank runs are gloo processes (tests/torch_lowering_worker.py), each
join bounded.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mgwfbp_tpu.optim import OptimSpec as JaxSpec
from mgwfbp_tpu.optim import make_optimizer as jax_make_optimizer
from mgwfbp_tpu.parallel import buckets as jbuckets
from mgwfbp_tpu.parallel.allreduce import ShardedOptimStep as JaxStep
from mgwfbp_tpu.parallel.allreduce import make_merged_allreduce as jax_reducer
from mgwfbp_tpu.parallel.costmodel import AlphaBeta as JaxAB
from mgwfbp_tpu.parallel.mesh import MeshSpec, make_mesh
from mgwfbp_tpu.parallel.solver import LayerSpec as JaxLayer
from mgwfbp_tpu.parallel.solver import build_schedule as jax_build_schedule
from mgwfbp_tpu.utils.platform import get_shard_map
from mgwfbp_tpu_torch.convert import flatten_flax
from mgwfbp_tpu_torch.models.resnet_cifar import CifarResNet
from mgwfbp_tpu_torch.optim import OptimSpec, make_optimizer
from mgwfbp_tpu_torch.parallel import buckets as tbuckets
from mgwfbp_tpu_torch.parallel.allreduce import (
    ShardedOptimStep,
    make_merged_allreduce,
    plan_merged_allreduce,
    sharded_optim_step,
)
from mgwfbp_tpu_torch.parallel.costmodel import AlphaBeta
from mgwfbp_tpu_torch.parallel.solver import LayerSpec, build_schedule

import torch_lowering_worker

shard_map = get_shard_map()
DEPTH, WIDTHS, NC, HW, B = 8, (4, 8, 16), 10, 16, 4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def one_rank_group(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


# -- OptimSpec ------------------------------------------------------------


@pytest.mark.parametrize("clip,world", [(None, 1), (0.25, 1), (400.0, 4)])
def test_optim_spec_equals_jax(clip, world):
    kw = dict(momentum=0.9, weight_decay=1e-4, lr_schedule="auto",
              dataset="cifar10", max_epochs=141, warmup_epochs=5,
              num_batches_per_epoch=7, norm_clip=clip, world_size=world)
    model = CifarResNet(depth=DEPTH, widths=WIDTHS, num_classes=NC)
    *_, ours = make_optimizer(model.parameters(), 0.1, return_spec=True, **kw)
    *_, theirs = jax_make_optimizer(0.1, return_spec=True, **kw)
    for f in ("kind", "momentum", "nesterov", "weight_decay", "decoupled_wd",
              "mask_ndim_gt1", "b1", "b2", "eps", "num_slots"):
        assert getattr(ours, f) == getattr(theirs, f), f
    if clip is None:
        assert ours.norm_clip is None and theirs.norm_clip is None
    else:  # scaled by sqrt(1/P): a float64 and a float32 square root
        assert ours.norm_clip == pytest.approx(theirs.norm_clip, rel=1e-7)
    for count in (0, 1, 6, 35, 700, 20000):
        assert ours.learning_rate(count) == pytest.approx(
            float(theirs.learning_rate(jnp.int32(count))), rel=1e-6)
    # the torch.optim.SGD built from the same locals
    opt, *_ = make_optimizer(model.parameters(), 0.1, **kw)
    assert opt.defaults["momentum"] == ours.momentum
    assert {g["weight_decay"] for g in opt.param_groups} == {
        ours.weight_decay, 0.0}


def test_optim_spec_rejects_what_jax_rejects():
    for kw in (dict(kind="lion"), dict(kind="sgd", decoupled_wd=True)):
        with pytest.raises(ValueError) as ours:
            OptimSpec(lr=0.1, **kw)
        with pytest.raises(ValueError) as theirs:
            JaxSpec(lr=0.1, **kw)
        assert str(ours.value) == str(theirs.value)


# -- update_shard ---------------------------------------------------------

SPECS = {
    "sgd": dict(kind="sgd"),
    "sgd-nesterov": dict(kind="sgd", momentum=0.9, nesterov=True),
    "sgd-wd": dict(kind="sgd", momentum=0.9, weight_decay=1e-2),
    "adam": dict(kind="adam"),
    "adamw": dict(kind="adam", weight_decay=1e-2, decoupled_wd=True),
    "clip": dict(kind="sgd", momentum=0.9, weight_decay=1e-2, norm_clip=0.5),
}
# arrival-order leaves: a matrix, a bias, a matrix; two groups at world 3
SHAPES = ((8, 16), (16,), (16, 4))
GROUPS = ((0, 1), (2,))


def _steps(name: str, world: int):
    class Leaf:
        def __init__(self, shape):
            self.shape, self.dtype = shape, torch.float32

    ours_layout = tbuckets.build_layout([Leaf(s) for s in SHAPES], GROUPS)

    class JLeaf:
        def __init__(self, shape):
            self.shape, self.dtype = shape, jnp.float32

    theirs_layout = jbuckets.build_layout([JLeaf(s) for s in SHAPES], GROUPS)
    ours = ShardedOptimStep(OptimSpec(lr=0.05, **SPECS[name]), ours_layout,
                            SHAPES, (2, 1, 0), world)
    theirs = JaxStep(JaxSpec(lr=0.05, **SPECS[name]), theirs_layout, SHAPES,
                     (2, 1, 0), ("data",), world)
    return ours, theirs


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_update_shard_equals_jax(name, dtype):
    world = 3
    ours, theirs = _steps(name, world)
    rtol = 1e-6 if dtype == "float32" else 1e-12
    rng = np.random.RandomState(sorted(SPECS).index(name))
    with jax.enable_x64(dtype == "float64"):
        for gi in range(len(GROUPS)):
            n = ours.shard_size(gi)
            assert n == theirs.shard_size(gi)
            for rank in range(world):
                for count, norm in ((0, 0.2), (4, 3.0)):
                    g = rng.randn(n).astype(dtype)
                    p = rng.randn(n).astype(dtype)
                    slots = [rng.randn(n).astype(dtype)]
                    slots.append(np.abs(rng.randn(n)).astype(dtype))
                    slots = slots[:ours.num_slots]
                    clip = None
                    if ours.spec.norm_clip is not None:
                        clip = (norm, ours.spec.norm_clip)
                    got_p, got_s = ours.update_shard(
                        gi, torch.from_numpy(g), torch.from_numpy(p),
                        [torch.from_numpy(s) for s in slots], count,
                        None if clip is None else tuple(
                            torch.tensor(c, dtype=getattr(torch, dtype))
                            for c in clip),
                        rank)
                    want_p, want_s = theirs.update_shard(
                        gi, jnp.asarray(g), jnp.asarray(p),
                        tuple(jnp.asarray(s) for s in slots),
                        jnp.asarray(count, jnp.int32),
                        None if clip is None else tuple(
                            jnp.asarray(c, dtype) for c in clip),
                        jnp.asarray(rank, jnp.int32))
                    assert got_p.dtype == getattr(torch, dtype)
                    np.testing.assert_allclose(
                        got_p.numpy(), np.asarray(want_p), rtol=rtol,
                        atol=rtol * 1e-1)
                    assert len(got_s) == len(want_s) == ours.num_slots
                    for a, b in zip(got_s, want_s):
                        np.testing.assert_allclose(
                            a.numpy(), np.asarray(b), rtol=rtol,
                            atol=rtol * 1e-1)


def test_padding_stays_zero_under_decay():
    """Pad elements carry zero gradient and zero parameter; decay, momentum
    and the clip keep them zero."""
    ours, _ = _steps("clip", 3)
    gi = 1  # 64 elements over 3 ranks: the last shard holds 2 of pad
    n = ours.shard_size(gi)
    assert ours.padded_size(gi) - ours.layout.group_sizes[gi] == 2
    mask = ours.decay_mask_vec(gi)
    assert not mask[ours.layout.group_sizes[gi]:].any()
    g = torch.zeros(n)
    p = torch.zeros(n)
    g[:-2], p[:-2] = 1.0, 1.0
    new_p, (mu,) = ours.update_shard(
        gi, g, p, [torch.zeros(n)], 0,
        (torch.tensor(3.0), torch.tensor(0.5)), 2)
    assert not new_p[-2:].any() and not mu[-2:].any()


# -- the layout helpers ---------------------------------------------------


def _jax_init(seed: int = 0):
    from mgwfbp_tpu.models.resnet_cifar import CifarResNet as JaxResNet

    model = JaxResNet(depth=DEPTH, widths=WIDTHS, num_classes=NC)
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, HW, HW, 3)),
                   train=False)
    return (jax.tree_util.tree_map(np.asarray, v["params"]),
            jax.tree_util.tree_map(np.asarray, v["batch_stats"]))


@pytest.mark.parametrize("world", [2, 3, 4])
def test_layout_helpers_equal_jax(world):
    jparams, _ = _jax_init()
    model = CifarResNet(depth=DEPTH, widths=WIDTHS, num_classes=NC)
    spec = OptimSpec(lr=0.1, momentum=0.9, weight_decay=1e-4)
    _, layout, perm, params = plan_merged_allreduce(
        model, policy="threshold", threshold=500, comm_op="rs_opt_ag")
    ours = sharded_optim_step(spec, layout, perm, params, world)
    theirs = jax_reducer(
        jparams, axis_name="data", policy="threshold", threshold=500,
        comm_op="rs_opt_ag", optim_spec=JaxSpec(lr=0.1, momentum=0.9,
                                                weight_decay=1e-4),
        world_size=world).optim
    assert ours.layout.groups == theirs.layout.groups
    assert ours.layout.num_groups > 3
    assert list(ours.perm) == list(theirs.perm)
    for gi in range(ours.layout.num_groups):
        assert ours.shard_size(gi) == theirs.shard_size(gi)
        assert ours.padded_size(gi) == theirs.padded_size(gi)
        np.testing.assert_array_equal(ours.decay_mask_vec(gi),
                                      theirs.decay_mask_vec(gi))
    assert ours.manifest_layout() == theirs.manifest_layout()
    assert ours.state_bytes_per_device() == theirs.state_bytes_per_device()
    assert ours.replicated_state_bytes() == theirs.replicated_state_bytes()
    if world == 3:  # some group does not divide: its shards carry pad
        assert any(ours.padded_size(gi) != layout.group_sizes[gi]
                   for gi in range(layout.num_groups))


@pytest.mark.parametrize("world", [2, 3, 4])
def test_padded_bucket_and_shards_equal_jax_host_pack(world):
    model = CifarResNet(depth=DEPTH, widths=WIDTHS, num_classes=NC)
    _, layout, perm, params = plan_merged_allreduce(
        model, policy="threshold", threshold=500, comm_op="rs_opt_ag")
    rng = np.random.default_rng(world)
    arr = [torch.from_numpy(rng.standard_normal(params[j].shape)
                            .astype(np.float32)) for j in perm]
    for gi in range(layout.num_groups):
        want = jbuckets.pack_group_host([a.numpy() for a in arr], layout,
                                        gi, world)
        padded = tbuckets.padded_group_size(layout, gi, world)
        np.testing.assert_array_equal(
            tbuckets.pack_group(arr, layout, gi, padded).numpy(), want)
        np.testing.assert_array_equal(
            tbuckets.pack_group(arr, layout, gi).numpy(),
            want[:layout.group_sizes[gi]])
        n = padded // world
        for r in range(world):
            np.testing.assert_array_equal(
                tbuckets.pack_shard(arr, layout, gi, r * n, (r + 1) * n)
                .numpy(), want[r * n:(r + 1) * n])


# -- one reduce_and_update against merged_rs_opt_ag ---------------------------


def test_reduce_and_update_equals_jax_merged_rs_opt_ag(tmp_path):
    world = 4
    jparams, bstats = _jax_init()
    rng = np.random.RandomState(7)
    flat = flatten_flax(jparams)
    grads = [{k: rng.randn(*a.shape).astype(np.float32) for k, a in
              flat.items()} for _ in range(world)]
    optim = dict(lr=0.1, momentum=0.9, weight_decay=1e-4, norm_clip=0.5)
    arrays = {f"params/{k}": a for k, a in flat.items()}
    arrays.update({f"bstats/{k}": a
                   for k, a in flatten_flax(bstats).items()})
    for r in range(world):
        arrays.update({f"grads/{r}/{k}": g for k, g in grads[r].items()})
    ranks = torch_lowering_worker.spawn(
        world, str(tmp_path),
        {"task": "rsopt_once", "optim": optim, "policy": "threshold",
         "threshold": 2000}, arrays)

    spec = JaxSpec(lr=0.1, kind="sgd", momentum=0.9, weight_decay=1e-4,
                   norm_clip=0.5)
    mar = jax_reducer(jparams, axis_name="data", policy="threshold",
                      threshold=2000, comm_op="rs_opt_ag", optim_spec=spec,
                      world_size=world)
    mesh = make_mesh(MeshSpec(data=world), devices=jax.devices()[:world])
    treedef = jax.tree_util.tree_structure(jparams)
    keys = list(flat)
    stacked = jax.tree_util.tree_unflatten(treedef, [
        np.stack([grads[r][k] for r in range(world)]) for k in keys])

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P("data"), P(), mar.optim.partition_spec()),
        out_specs=(P(), mar.optim.partition_spec()), check_vma=False)
    def step(gs, p, os_):
        return mar.reduce_and_update(
            jax.tree_util.tree_map(lambda x: x[0], gs), p, os_)

    new_p, new_os = jax.jit(step)(stacked, jparams, mar.optim.init())
    trace = mar.optim.gather(new_os, spec.make_tx(), jparams)
    traces = [s.trace for s in jax.tree_util.tree_leaves(
        trace, is_leaf=lambda n: hasattr(n, "trace"))]
    want_p = flatten_flax(jax.tree_util.tree_map(np.asarray, new_p))
    want_t = flatten_flax(jax.tree_util.tree_map(np.asarray, traces[0]))
    assert list(ranks[0]["groups"]) == [len(g) for g in mar.layout.groups]
    for r in range(world):
        for k in keys:
            np.testing.assert_allclose(ranks[r][f"params/{k}"], want_p[k],
                                       rtol=1e-6, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(ranks[r][f"slot0/{k}"], want_t[k],
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    # one reduce-scatter and one all-gather per group, and the clip
    assert int(ranks[0]["launches"]) == 2 * mar.layout.num_groups + 1
    assert not np.allclose(want_p[keys[0]], flat[keys[0]])


# -- against the port's own all_reduce, ten steps ---------------------------


def _traj_arrays(world: int, dtype: str) -> dict:
    jparams, bstats = _jax_init(1)
    rng = np.random.RandomState(world)
    out = {f"params/{k}": a for k, a in flatten_flax(jparams).items()}
    out.update({f"bstats/{k}": a for k, a in flatten_flax(bstats).items()})
    out["x"] = rng.randn(10, 1, world * B, HW, HW, 3).astype(np.float32)
    out["y"] = rng.randint(0, NC, (10, 1, world * B)).astype(np.int32)
    return out


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    """(world, dtype) -> every rank's outputs of 10 steps per lowering."""
    out = {}
    for world, dtype in ((2, "float32"), (2, "float64"), (3, "float32")):
        d = tmp_path_factory.mktemp(f"traj{world}{dtype}")
        out[(world, dtype)] = torch_lowering_worker.spawn(
            world, str(d),
            {"task": "traj", "dtype": dtype, "batch": B, "lr": 0.1,
             "batches_per_epoch": 2, "norm_clip": 1.0, "policy": "wfbp",
             "ops": ["all_reduce", "rs_ag", "rs_opt_ag"]},
            _traj_arrays(world, dtype), timeout_s=240)
    return out


@pytest.mark.parametrize("world,dtype",
                         [(2, "float32"), (2, "float64"), (3, "float32")])
def test_ten_steps_match_the_all_reduce_path(trajectories, world, dtype):
    ranks = trajectories[(world, dtype)]
    tol = 1e-6 if dtype == "float32" else 1e-12
    for k in range(1, 11):
        base = ranks[0][f"all_reduce/params{k}"]
        for op in ("rs_ag", "rs_opt_ag"):
            got = ranks[0][f"{op}/params{k}"]
            rel = np.linalg.norm(got - base) / np.linalg.norm(base)
            assert rel <= tol, (op, k, rel)
            np.testing.assert_allclose(got, base, rtol=tol,
                                       atol=tol * np.abs(base).max())
        for op in ("all_reduce", "rs_ag", "rs_opt_ag"):
            for r in range(1, world):  # replicas stay identical
                np.testing.assert_array_equal(
                    ranks[r][f"{op}/params{k}"], ranks[0][f"{op}/params{k}"])
    # the parameters moved: 10 steps are not a no-op
    assert not np.allclose(ranks[0]["rs_opt_ag/params10"],
                           ranks[0]["rs_opt_ag/params1"])
    groups = int(ranks[0]["all_reduce/groups"])
    assert int(ranks[0]["all_reduce/launches"]) == 10 * groups
    assert int(ranks[0]["rs_ag/launches"]) == 10 * 2 * groups
    # a reduce-scatter and an all-gather per group, and the clip's
    assert int(ranks[0]["rs_opt_ag/launches"]) == 10 * (2 * groups + 1)


@pytest.mark.parametrize("world", [2, 3])
def test_opt_state_bytes_are_one_over_world_plus_pad(trajectories, world):
    r0 = trajectories[(world, "float32")][0]
    state, rep = int(r0["rs_opt_ag/state_bytes"]), int(
        r0["rs_opt_ag/replicated_bytes"])
    assert int(r0["rs_opt_ag/live_bytes"]) == state - 4  # + the int32 count
    groups = int(r0["all_reduce/groups"])
    # each group pads by fewer than `world` elements of 4 bytes
    assert rep / world <= state - 4 < rep / world + 4 * groups
    if world == 3:
        assert state - 4 > rep / world  # ResNet-20's groups do not divide
    else:
        assert state - 4 == rep // 2


# -- errors and pricing ------------------------------------------------------


def test_construction_errors(one_rank_group):
    from mgwfbp_tpu_torch.parallel.compression import TopKCompressor

    model = CifarResNet(depth=DEPTH, widths=WIDTHS, num_classes=NC)
    spec = OptimSpec(lr=0.1, momentum=0.9)
    with pytest.raises(ValueError, match="requires optim_spec and world_size"):
        make_merged_allreduce(model, policy="single", comm_op="rs_opt_ag")
    jtree = {"a": jnp.ones((8,), jnp.float32)}
    with pytest.raises(ValueError, match="requires optim_spec and world_size"):
        jax_reducer(jtree, axis_name="data", policy="single",
                    comm_op="rs_opt_ag")
    with pytest.raises(ValueError, match="cannot combine with a sparsifying"):
        make_merged_allreduce(model, policy="single", comm_op="rs_opt_ag",
                              optim_spec=spec, world_size=1,
                              compressor=TopKCompressor(0.01))
    with pytest.raises(ValueError, match="cannot combine with a sparsifying"):
        make_merged_allreduce(model, policy="single", comm_op="rs_ag",
                              compressor=TopKCompressor(0.01))
    # the cross-step and two-level lowerings are accepted with what they
    # need (an OptimSpec, the two-level groups) and refused without it
    with pytest.raises(ValueError, match="requires optim_spec and world_size"):
        make_merged_allreduce(model, policy="single", comm_op="rs_fwd_ag")
    with pytest.raises(ValueError, match="two-level process groups"):
        make_merged_allreduce(model, policy="single", comm_op="hier")
    fwd = make_merged_allreduce(model, policy="single", comm_op="rs_fwd_ag",
                                optim_spec=spec, world_size=1)
    fwd.begin()
    sum(p.sum() for p in model.parameters()).backward()
    fwd.reduce_and_defer()
    assert fwd.stale and fwd.opt_state.count == 1
    fwd.materialize()
    assert not fwd.stale
    fwd.detach()
    for p in model.parameters():
        p.grad = None
    with pytest.raises(ValueError, match="rebuild the reducer"):
        make_merged_allreduce(model, policy="single", comm_op="rs_opt_ag",
                              optim_spec=spec, world_size=2)
    red = make_merged_allreduce(model, policy="single", comm_op="rs_opt_ag",
                                optim_spec=spec, world_size=1)
    red.begin()
    sum(p.sum() for p in model.parameters()).backward()
    with pytest.raises(RuntimeError, match="reduce_and_update"):
        red.synchronize()
    red.reduce_and_update()
    assert red.opt_state.count == 1
    red.detach()
    plain = make_merged_allreduce(model, policy="single")
    with pytest.raises(RuntimeError, match="requires comm_op='rs_opt_ag'"):
        plain.reduce_and_update()
    plain.detach()


def test_update_beta_prices_the_middle_as_jax():
    ours_cm = AlphaBeta(alpha=1e-5, beta=1e-9, update_beta=2e-9)
    theirs_cm = JaxAB(alpha=1e-5, beta=1e-9, update_beta=2e-9)
    layers = [LayerSpec(f"l{i}", 1000 * (i + 1)) for i in range(6)]
    jlayers = [JaxLayer(f"l{i}", 1000 * (i + 1)) for i in range(6)]
    tb = [1e-5] * 6
    for policy in ("single", "wfbp", "mgwfbp", "auto"):
        for op in ("all_reduce", "rs_ag", "rs_opt_ag"):
            ours = build_schedule(layers, tb, policy=policy,
                                  cost_model=ours_cm, comm_op=op)
            theirs = jax_build_schedule(jlayers, tb, policy=policy,
                                        cost_model=theirs_cm, comm_op=op)
            assert ours.groups == theirs.groups, (policy, op)
            assert ours.predicted_comm_time == theirs.predicted_comm_time
            assert ours.predicted_total_time == theirs.predicted_total_time
            assert ours.predicted_group_times == theirs.predicted_group_times
    plain = build_schedule(layers, tb, policy="single", cost_model=ours_cm)
    mid = build_schedule(layers, tb, policy="single", cost_model=ours_cm,
                         comm_op="rs_opt_ag")
    assert mid.predicted_comm_time == pytest.approx(
        plain.predicted_comm_time + 2e-9 * 4 * 21000)


def test_a_non_finite_step_keeps_the_sharded_state(one_rank_group):
    """The guard on rs_opt_ag counts the local gradients; a step with a NaN
    leaves the parameters, the shards, their count and the step counter
    as they were, and the reduce-scatters it launched are drained."""
    model = CifarResNet(depth=DEPTH, widths=WIDTHS, num_classes=NC)
    opt, lr_fn, _, spec = make_optimizer(
        model.parameters(), 0.1, num_batches_per_epoch=2, return_spec=True)
    red = make_merged_allreduce(model, policy="wfbp", comm_op="rs_opt_ag",
                                optim_spec=spec, world_size=1)
    from mgwfbp_tpu_torch.train.step import TrainStep

    step = TrainStep(model, opt, lr_fn, reducer=red, health_stats=True)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 2, 3, HW, HW).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, NC, (1, 2)))
    step(x, y)
    before = ([p.detach().clone() for p in model.parameters()],
              [t.clone() for t in red.opt_state.slots[0]],
              red.opt_state.count, step.step)
    bad = x.clone()
    bad[0, 0, 0, 0, 0] = float("nan")
    out = step(bad, y)
    assert out["grads_nonfinite"] > 0
    # the skipped step's health: NaN update ratio, and the local gradient
    # norm (the sharded path's) holds the NaN
    assert np.isnan(out["health/update_ratio"])
    assert np.isnan(out["health/grad_norm"])
    assert red.opt_state.count == before[2] == step.step == before[3] == 1
    for a, b in zip(model.parameters(), before[0]):
        assert torch.equal(a.detach(), b)
    for a, b in zip(red.opt_state.slots[0], before[1]):
        assert torch.equal(a, b)
    out = step(x, y)  # the next finite step runs
    assert out["grads_nonfinite"] == 0 and red.opt_state.count == 2
    assert np.isfinite(out["health/update_ratio"])
    red.detach()
