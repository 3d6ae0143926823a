"""Port vs reference: the DenseNets (mgwfbp_tpu_torch.models.densenet vs
mgwfbp_tpu.models.densenet).

  * densenet (BC-100-12), densenet121/161/201 have the JAX tree (leaf
    paths, shapes, counts through ``jax.eval_shape`` at full width);
    DenseNet-201 gives the MG-WFBP solver 604 leaves, on which the port's
    schedule equals the JAX solver's (the solve's time is printed);
  * the dense layer and the transition, training mode, from the JAX
    blocks' own init: output, batch statistics within rtol 2e-5 / atol
    1e-5, gradients within rel 1e-4 of max(1, |leaf|);
  * DenseNet-BC-100 whole, batch 2, at 8 x 8 (the leaves do not depend on
    the input's size; 8 x 8 keeps the float64 run short): the port in float64
    within 1e-6 of float64 ``jax.grad`` of the JAX ``make_loss_fn``, and in
    float32 within 1e-4 of it: the JAX float32 side is the inexact one here
    (3e-3 from float64 against the port's 1.4e-6, measured at 32 x 32);
  * DenseNet-121 in eval mode (the ImageNet stem: a SAME 7x7/2 conv and a
    SAME 3x3/2 max pool) at 64 x 64 with batch statistics off their init:
    logits within 2e-5 of max(1, the largest logit) (one training pass
    leaves running variances that 121 layers of eval-mode normalization
    amplify into logits of order 1e4).
"""

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgwfbp_tpu.models import create_model as jax_create_model
from mgwfbp_tpu.models import densenet as jdensenet
from mgwfbp_tpu_torch import models
from mgwfbp_tpu_torch.convert import flatten_flax, flax_shapes, variables_to_flax
from mgwfbp_tpu_torch.models import densenet
from mgwfbp_tpu_torch.train.step import forward_loss

from torch_zoo_util import (
    block_parity,
    f64_parity,
    images,
    labels,
    nchw,
    port_model,
)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name,leaves,bn_leaves,params", [
    ("densenet", 299, 198, 769_162),
    ("densenet121", 364, 242, 7_978_856),
    ("densenet161", 484, 322, 28_681_000),
    ("densenet201", 604, 402, 20_013_928),
])
def test_registered_densenet_has_the_jax_tree(name, leaves, bn_leaves, params):
    jm, jmeta = jax_create_model(name)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + tuple(jmeta.input_shape)),
        train=False))
    with torch.device("meta"):
        module, meta = models.create_model(name)
    for coll in ("params", "batch_stats"):
        want = {p: tuple(s.shape) for p, s in flatten_flax(shapes[coll]).items()}
        got = flax_shapes(module, coll)
        assert list(got) == list(want) and got == want, coll
    n = sum(math.prod(s) for s in flax_shapes(module).values())
    assert (len(flax_shapes(module)), len(flax_shapes(module, "batch_stats")),
            n) == (leaves, bn_leaves, params)
    assert sum(p.numel() for p in module.parameters()) == params
    assert meta.input_shape == tuple(jmeta.input_shape)


@pytest.mark.parametrize("link", [("56GbIB", 16), ("10GbE", 2)])
def test_solver_at_604_leaves_matches_jax(link):
    """DenseNet-201's 604 leaves in the arrival permutation, tb from the
    size prior: the port's mgwfbp schedule equals the JAX solver's (groups,
    predicted times). The solve's time on this host is printed."""
    import time

    from mgwfbp_tpu.parallel import solver as jsolver
    from mgwfbp_tpu.parallel.allreduce import arrival_order as jax_arrival
    from mgwfbp_tpu.parallel.costmodel import lookup_alpha_beta as jax_lookup
    from mgwfbp_tpu_torch.convert import flax_leaves, keystr
    from mgwfbp_tpu_torch.parallel import solver
    from mgwfbp_tpu_torch.parallel.allreduce import arrival_order
    from mgwfbp_tpu_torch.parallel.costmodel import lookup_alpha_beta

    with torch.device("meta"):
        module, _ = models.create_model("densenet201")
    leaves = flax_leaves(module)
    names = [keystr(p) for p, _ in leaves]
    perm = arrival_order(len(names), names=names)
    assert len(names) == 604 and perm == jax_arrival(len(names), names=names)
    specs = [solver.LayerSpec(name=names[j], size=leaves[j][1].numel(),
                              itemsize=4) for j in perm]
    jspecs = [jsolver.LayerSpec(name=s.name, size=s.size, itemsize=4)
              for s in specs]
    cost, jcost = lookup_alpha_beta(*link), jax_lookup(*link)
    tb = solver.size_prior_tb(specs, cost)
    t0 = time.perf_counter()
    got = solver.build_schedule(specs, tb, policy="mgwfbp", cost_model=cost)
    port_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = jsolver.build_schedule(jspecs, tb, policy="mgwfbp",
                                  cost_model=jcost)
    jax_s = time.perf_counter() - t0
    assert [list(g) for g in got.groups] == [list(g) for g in want.groups]
    assert got.predicted_nonoverlap_time == pytest.approx(
        want.predicted_nonoverlap_time, rel=1e-12)
    print(f"mgwfbp solve of 604 leaves ({link[0]} at {link[1]}): "
          f"{len(got.groups)} groups, port {port_s:.4f} s, JAX {jax_s:.4f} s")


def test_dense_layer_matches_jax():
    x = images(2, (8, 8, 64), seed=1)
    block_parity(jdensenet.DenseLayer(growth_rate=32),
                 densenet.DenseLayer(64, 32), x)


def test_transition_matches_jax():
    x = images(2, (8, 8, 256), seed=2)
    block_parity(jdensenet.Transition(features=128),
                 densenet.Transition(256, 128), x)


def test_densenet_bc_gradients_match_jax_in_float64(tmp_path):
    m, _ = port_model("densenet", seed=1)
    x, y = images(2, (8, 8, 3), seed=3), labels(2, 10, 3)
    errs = f64_parity(
        tmp_path, "densenet", m, x, y,
        lambda mod, xt: forward_loss(mod, "classify", xt,
                                     torch.from_numpy(y))[0], f32_rel=1e-4)
    print(f"densenet vs float64 jax.grad: {errs}")


def test_densenet121_eval_logits_match_jax():
    m, _ = port_model("densenet121", seed=2)
    hw = (64, 64, 3)
    m.train()
    with torch.no_grad():  # statistics off their init
        m(nchw(images(4, hw, seed=4)))
    params, bstats = variables_to_flax(m)
    jm, _ = jax_create_model("densenet121")
    x = images(2, hw, seed=5)
    want = np.asarray(jax.jit(partial(jm.apply, train=False))(
        {"params": params, "batch_stats": bstats}, x))
    m.eval()
    with torch.no_grad():
        got = m(nchw(x)).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 2e-5 * scale
