"""The port's top-k compressor and its cost models against the JAX
package's, on the CPU.

  * the registry and its errors, and ``k_for``, equal to JAX's;
  * ``TopKCompressor.allreduce`` at 2 and 4 gloo ranks (one process each,
    tests/torch_lowering_worker.py) against JAX's inside ``shard_map`` on
    a 2- and 4-device mesh, on the same seeded float32 buckets drawn
    without ties: equal within 1e-7; a bucket whose k >= n is the dense
    mean; the dense result holds only entries some rank kept, each rank's
    largest;
  * ``topk_time``, ``sparse_allgather_time(_ethernet)`` and
    ``choose_density`` equal to JAX's on a grid;
  * the step's compression error (``health/comp_err_gNNNN``, measured by
    the reducer's hooks) against JAX's ``_compression_error_entries`` on
    the same local gradients within 1e-6, and with a bfloat16 wire by
    kept energy, which ties cannot change.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mgwfbp_tpu.parallel import compression as jcomp
from mgwfbp_tpu.parallel import costmodel as jcm
from mgwfbp_tpu.parallel.mesh import MeshSpec, make_mesh
from mgwfbp_tpu.utils.platform import get_shard_map
from mgwfbp_tpu_torch.parallel import compression as tcomp
from mgwfbp_tpu_torch.parallel import costmodel as tcm

import torch_lowering_worker

shard_map = get_shard_map()
DENSITY = 0.05


def _no_ties(rng, shape) -> np.ndarray:
    """float32 values whose magnitudes are all distinct (a permutation of
    well-separated levels with random signs)."""
    n = int(np.prod(shape))
    mags = (np.arange(1, n + 1, dtype=np.float64) / n + 0.01)
    vals = rng.permutation(mags) * rng.choice([-1.0, 1.0], n)
    return vals.astype(np.float32).reshape(shape)


# -- the registry --------------------------------------------------------


@pytest.mark.parametrize("name,density", [
    (None, 1.0), ("none", 0.3), ("topk", 0.01), ("topk", 1.0),
    ("gzip", 0.1),
])
def test_make_compressor_and_its_errors_equal_jax(name, density):
    def outcome(make):
        try:
            c = make(name, density)
        except (KeyError, ValueError) as e:
            return type(e).__name__, str(e)
        return (None if c is None else (c.name, c.density, c.sparse())), ""

    assert outcome(tcomp.make_compressor) == outcome(jcomp.make_compressor)


@pytest.mark.parametrize("density", [0.0, -0.5, 1.5])
def test_topk_density_bounds_equal_jax(density):
    with pytest.raises(ValueError, match="density must be in"):
        tcomp.TopKCompressor(density=density)
    with pytest.raises(ValueError, match="density must be in"):
        jcomp.TopKCompressor(density=density)


def test_k_for_equals_jax():
    for d in (0.001, 0.01, 0.05, 0.25, 0.5, 1.0):
        ours, theirs = tcomp.TopKCompressor(d), jcomp.TopKCompressor(d)
        for n in (1, 2, 3, 7, 100, 999, 4096, 272474):
            assert ours.k_for(n) == theirs.k_for(n), (d, n)


# -- the sparse collective ----------------------------------------------


def _jax_topk(xs: np.ndarray, world: int) -> list[np.ndarray]:
    """JAX's TopKCompressor.allreduce of each bucket xs[b] (world, n) on a
    ``world``-device mesh."""
    mesh = make_mesh(MeshSpec(data=world), devices=jax.devices()[:world])
    comp = jcomp.TopKCompressor(DENSITY)

    @functools.partial(shard_map, mesh=mesh, in_specs=P("data"),
                       out_specs=P(), check_vma=False)
    def f(x):
        return comp.allreduce(x[0], ("data",), True)

    return [np.asarray(jax.jit(f)(jnp.asarray(x))) for x in xs]


@pytest.mark.parametrize("world", [2, 4])
def test_topk_allreduce_equals_jax(tmp_path, world):
    rng = np.random.RandomState(world)
    n = 600
    xs = _no_ties(rng, (3, world, n))
    ranks = torch_lowering_worker.spawn(
        world, str(tmp_path), {"task": "topk", "density": DENSITY},
        {"topk_x": xs},
    )
    want = _jax_topk(xs, world)
    for b in range(xs.shape[0]):
        for r in range(world):
            np.testing.assert_allclose(ranks[r][f"topk/{b}"], want[b],
                                       rtol=0, atol=1e-7)
        # ranks agree bit for bit: the scatter-add runs in rank order
        for r in range(1, world):
            np.testing.assert_array_equal(ranks[r][f"topk/{b}"],
                                          ranks[0][f"topk/{b}"])
        # each rank's k largest, and nothing else, reach the dense bucket
        k = tcomp.TopKCompressor(DENSITY).k_for(n)
        kept = np.zeros(n, bool)
        for r in range(world):
            kept[np.argsort(-np.abs(xs[b, r]))[:k]] = True
        got = ranks[0][f"topk/{b}"]
        assert not got[~kept].any()
        want_dense = np.zeros(n, np.float64)
        for r in range(world):
            top = np.argsort(-np.abs(xs[b, r]))[:k]
            want_dense[top] += xs[b, r, top]
        np.testing.assert_allclose(got, want_dense / world, rtol=0,
                                   atol=1e-7)


def test_topk_allreduce_is_the_dense_mean_when_k_covers_n(tmp_path):
    """k >= n (density 0.9 of a 3-element bucket keeps all 3): the dense
    mean, as JAX's pmean."""
    rng = np.random.RandomState(0)
    xs = _no_ties(rng, (1, 2, 3))
    assert tcomp.TopKCompressor(0.9).k_for(3) == 3
    ranks = torch_lowering_worker.spawn(
        2, str(tmp_path), {"task": "topk", "density": 0.9}, {"topk_x": xs})
    for r in range(2):
        np.testing.assert_allclose(ranks[r]["topk/0"], xs[0].mean(0),
                                   rtol=0, atol=1e-7)


# -- the cost models -----------------------------------------------------


def test_topk_and_sparse_allgather_times_equal_jax():
    for n in (0, 1, 2, 1000, 2 ** 20, 25_557_032):
        assert tcm.topk_time(n) == jcm.topk_time(n)
        assert tcm.topk_time(n, 1e-9) == jcm.topk_time(n, 1e-9)
        for p in (2, 4, 16):
            for d in (0.001, 0.01, 0.25):
                assert tcm.sparse_allgather_time(
                    1e-5, 1e-9, n, p, d) == jcm.sparse_allgather_time(
                    1e-5, 1e-9, n, p, d)
                assert tcm.sparse_allgather_time_ethernet(
                    n, p, d) == jcm.sparse_allgather_time_ethernet(n, p, d)
                assert tcm.sparse_allgather_time_ethernet(
                    n, p, d, 2) == jcm.sparse_allgather_time_ethernet(
                    n, p, d, 2)


@pytest.mark.parametrize("conn", ["ici", "10GbE", "56GbIB", "1GbE-large"])
def test_choose_density_equals_jax(conn):
    for p in (2, 4, 8, 16):
        ours, theirs = tcm.lookup_alpha_beta(conn, p), \
            jcm.lookup_alpha_beta(conn, p)
        for n in (0, 10, 1000, 272_474, 4 * 2 ** 20, 25_557_032):
            assert tcm.choose_density(n, p, ours) == jcm.choose_density(
                n, p, theirs), (conn, p, n)
            assert tcm.choose_density(
                n, p, ours, candidates=(0.5, 0.1), itemsize=2
            ) == jcm.choose_density(
                n, p, theirs, candidates=(0.5, 0.1), itemsize=2)


# -- the compression error -------------------------------------------------


def _error_case(wire):
    """The port's comp_err_gNNNN of a one-rank step over a narrow ResNet-20
    whose local gradients are planted, and JAX's
    ``_compression_error_entries`` of the same gradients."""
    import torch.distributed as dist

    from mgwfbp_tpu.parallel.allreduce import make_merged_allreduce as jmerge
    from mgwfbp_tpu.train.step import _compression_error_entries
    from mgwfbp_tpu_torch.convert import _param_rules, flax_shapes
    from mgwfbp_tpu_torch.models.resnet_cifar import CifarResNet
    from mgwfbp_tpu_torch.parallel.allreduce import make_merged_allreduce

    model = CifarResNet(depth=8, widths=(4, 8, 16), num_classes=10)
    rng = np.random.RandomState(5)
    grads = {p: _no_ties(rng, s) for p, s in flax_shapes(model).items()}
    reducer = make_merged_allreduce(
        model, policy="wfbp", compressor=tcomp.TopKCompressor(DENSITY),
        comm_dtype=wire)
    reducer.track_compression_error = True
    loss = 0.0
    for path, (p, _, to_torch) in _param_rules(model).items():
        loss = loss + (p * to_torch(torch.from_numpy(grads[path]))
                       .contiguous()).sum()
    reducer.begin()
    loss.backward()
    got = [float(e) for e in reducer.compression_errors]
    reducer.synchronize()
    reducer.detach()
    nested: dict = {}
    for path, g in grads.items():
        *mods, leaf = path.split(".")
        node = nested
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = jnp.asarray(g)
    jred = jmerge(nested, axis_name="data", policy="wfbp",
                  compressor=jcomp.TopKCompressor(DENSITY),
                  comm_dtype=None if wire is None else jnp.bfloat16)
    want = _compression_error_entries(nested, jred)
    assert dist.get_world_size() == 1
    return got, [float(want[k]) for k in sorted(want)], reducer


@pytest.fixture
def one_rank_group(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def test_compression_error_equals_jax(one_rank_group):
    got, want, reducer = _error_case(None)
    assert len(got) == len(want) == reducer.num_groups
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert max(got) > 0.1  # 95 % of the entries dropped: a real error


def test_compression_error_with_a_bfloat16_wire_by_kept_energy(
        one_rank_group):
    """With a bfloat16 wire the k-set may differ at ties; the error is
    1 - kept energy / total energy of the wire-cast bucket, which ties
    cannot change."""
    got, want, _ = _error_case(torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_train_step_reports_the_compression_error(one_rank_group):
    """``TrainStep(health_stats=True)`` over a top-k reducer returns each
    group's ``health/comp_err_gNNNN`` with the step's own metrics, as the
    reducer measured it in that step, beside the norms."""
    from mgwfbp_tpu_torch.models.resnet_cifar import CifarResNet
    from mgwfbp_tpu_torch.optim import make_optimizer
    from mgwfbp_tpu_torch.parallel.allreduce import make_merged_allreduce
    from mgwfbp_tpu_torch.train.step import TrainStep

    model = CifarResNet(depth=8, widths=(4, 8, 16), num_classes=10)
    opt, lr_fn, _ = make_optimizer(model.parameters(), 0.1,
                                   num_batches_per_epoch=2)
    red = make_merged_allreduce(model, policy="threshold", threshold=2000,
                                compressor=tcomp.TopKCompressor(DENSITY))
    step = TrainStep(model, opt, lr_fn, reducer=red, health_stats=True)
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(1, 2, 3, 16, 16).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, (1, 2)))
    step(x, y)
    out = step(x, y)
    first = [float(e) for e in red.compression_errors]
    keys = [f"health/comp_err_g{gi:04d}" for gi in range(red.num_groups)]
    assert [k for k in out if k.startswith("health/comp_err_g")] == keys
    np.testing.assert_allclose([out[k] for k in keys], first, rtol=1e-6)
    assert all(0.0 < v < 1.0 for v in first)
    assert "health/gnorm_g0000" in out and "health/update_ratio" in out
    red.detach()
