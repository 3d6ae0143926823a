"""Port vs reference: the MG-WFBP schedule (mgwfbp_tpu_torch.parallel
solver / costmodel / buckets / allreduce vs mgwfbp_tpu.parallel).

Over ResNet-20's 65 parameter leaves, the port's reducer (arrival
permutation from its own module's Flax paths, layer specs, solver) must
produce merge groups IDENTICAL to the JAX package's ``make_merged_allreduce``
for every policy, under seeded tb profiles and the 10GbE / 56GbIB / ici
cost models at 2, 4, 8 and 16 workers, and the same predictions (the same
numpy arithmetic, so equal to the last bit). The port's reducer is built in
a one-process gloo world; nothing is launched.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mgwfbp_tpu.models import create_model as jax_create_model
from mgwfbp_tpu.parallel.allreduce import make_merged_allreduce as jax_reducer
from mgwfbp_tpu.parallel.costmodel import AlphaBeta as JaxAlphaBeta
from mgwfbp_tpu.parallel.costmodel import lookup_alpha_beta as jax_lookup
from mgwfbp_tpu.parallel.costmodel import save_profile as jax_save_profile
from mgwfbp_tpu_torch import models
from mgwfbp_tpu_torch.parallel import buckets
from mgwfbp_tpu_torch.parallel.allreduce import make_merged_allreduce
from mgwfbp_tpu_torch.parallel.costmodel import load_profile, lookup_alpha_beta

POLICIES = ("mgwfbp", "auto", "threshold", "single", "wfbp")
CONNECTIONS = ("10GbE", "56GbIB", "ici")
WORLDS = (2, 4, 8, 16)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def resnet20(tmp_path_factory):
    d = tmp_path_factory.mktemp("pg")
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(str(d), 'rdv')}",
        world_size=1, rank=0,
    )
    jm, _ = jax_create_model("resnet20")
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                        train=False)
    )["params"]
    module, _ = models.create_model("resnet20")
    yield shapes, module
    dist.destroy_process_group()


def _tb(seed: int) -> list[float]:
    # per-leaf backward seconds of the scale a card's ResNet-20 step has
    return list(np.random.RandomState(seed).uniform(2e-6, 2e-4, 65))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("connection", CONNECTIONS)
@pytest.mark.parametrize("policy", POLICIES)
def test_groups_identical_to_jax(resnet20, policy, connection, world):
    shapes, module = resnet20
    tb = _tb(world * 7 + len(connection))
    kw = dict(policy=policy, tb=tb, threshold=12_000)
    want = jax_reducer(shapes, axis_name="data",
                       cost_model=jax_lookup(connection, world), **kw)
    got = make_merged_allreduce(
        module, cost_model=lookup_alpha_beta(connection, world), **kw
    )
    try:
        assert got.schedule.layer_names == want.schedule.layer_names
        assert got.perm == want.perm
        assert got.schedule.groups == want.schedule.groups
        assert got.layout.groups == want.layout.groups
        assert got.layout.offsets == want.layout.offsets
        assert got.schedule.policy_detail == want.schedule.policy_detail
        assert (got.schedule.predicted_total_time
                == want.schedule.predicted_total_time)
        assert (got.schedule.predicted_group_times
                == want.schedule.predicted_group_times)
    finally:
        got.detach()


@pytest.mark.parametrize("policy", ["mgwfbp", "auto"])
def test_profile_written_by_jax_solves_alike(resnet20, tmp_path, policy):
    """A calibrated profile (with the per-group and packing costs that open
    the isolate-bigs candidates) written by the JAX package loads in the
    port and solves to the same groups; without tb both fall back to the
    same volume prior."""
    shapes, module = resnet20
    path = str(tmp_path / "profile.json")
    jax_save_profile(path, JaxAlphaBeta(
        alpha=3e-5, beta=4e-10, gamma=1e-5, overlap=0.8, pack_beta=2e-10,
    ), meta={"device": "test"})
    cost = load_profile(path)
    assert cost.pack_beta == 2e-10 and cost.overlap == 0.8
    for tb in (_tb(1), None):
        want = jax_reducer(shapes, axis_name="data", policy=policy, tb=tb,
                           cost_model=JaxAlphaBeta(3e-5, 4e-10, 1e-5, 0.8,
                                                   2e-10))
        got = make_merged_allreduce(module, policy=policy, tb=tb,
                                    cost_model=cost)
        got.detach()
        assert got.schedule.groups == want.schedule.groups
        assert got.schedule.policy_detail == want.schedule.policy_detail


def test_profile_written_by_the_port_loads_in_jax(tmp_path):
    from mgwfbp_tpu.parallel.costmodel import load_profile as jax_load

    from mgwfbp_tpu_torch.parallel.costmodel import (
        AlphaBeta,
        SampledCost,
        save_profile,
    )

    flat = AlphaBeta(alpha=2e-5, beta=3e-10, gamma=4e-6, pack_beta=1e-11)
    sampled = SampledCost(sizes_bytes=(1e3, 1e6, 1e8),
                          times_s=(1e-5, 2e-5, 4e-3), ab=flat)
    for model in (flat, sampled):
        path = str(tmp_path / f"{type(model).__name__}.json")
        save_profile(path, model, meta={"device": "test"})
        theirs, ours = jax_load(path), load_profile(path)
        for nbytes in (10.0, 5e4, 3e6, 1e9):
            assert theirs.predict(nbytes) == ours.predict(nbytes)
        assert (theirs.alpha, theirs.gamma) == (ours.alpha, ours.gamma)


def test_layout_splits_dtypes_and_packs_round_trip():
    leaves = [torch.arange(6.0).reshape(2, 3), torch.ones(4),
              torch.zeros(2, dtype=torch.bfloat16), torch.full((3,), 2.0)]
    layout = buckets.build_layout(leaves, [[0, 1, 2, 3]])
    assert layout.groups == ((0, 1), (2,), (3,))
    assert layout.offsets == ((0, 6), (0,), (0,))
    assert layout.group_sizes == (10, 2, 3)
    assert layout.dtypes == (torch.float32, torch.bfloat16, torch.float32)
    flat = buckets.pack_group(leaves, layout, 0)
    back = buckets.unpack_group(flat, layout, 0, [t.shape for t in leaves])
    assert torch.equal(back[0], leaves[0]) and torch.equal(back[1], leaves[1])
    with pytest.raises(ValueError, match="multiple groups"):
        buckets.build_layout(leaves, [[0, 1], [1, 2, 3]])
    with pytest.raises(ValueError, match="do not cover"):
        buckets.build_layout(leaves, [[0, 1]])
