"""The port's ring attention (``mgwfbp_tpu_torch.parallel.ringattn``) at 2
and 4 gloo ranks against the JAX package on the CPU.

Inputs are seeded numpy arrays, (B, T, H, D) = (2, 32, 2, 8) float32; rank
r holds time slice r of a ring of S ranks (``tests/torch_seq_worker.py``'s
``ring`` task, one process per rank, the group killed after its timeout).
The JAX side runs as tests/test_ringattn.py runs it, ``ring_attention``
under ``shard_map`` on a (8 / S, S) mesh of the 8 CPU devices, and
``local_attention`` on the whole sequence. At S = 2 and 4, causal and full:

  * the port's output equals the JAX ring's and the JAX ``local_attention``
    at rtol = atol = 2e-5;
  * the q, k and v gradients under a seeded upstream gradient, which reach
    the other ranks' K and V back through ``_RingShift``'s reverse shift,
    equal ``jax.grad`` of the JAX ``local_attention`` at the same bound;
  * each forward and each backward launches 2 (S - 1) point-to-point
    operations (one send and one receive per rotation);
  * uniform q and k make the last causal position the mean of every v row
    (the softmax-normalisation case of tests/test_ringattn.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from mgwfbp_tpu.parallel.mesh import SEQ_AXIS, MeshSpec, make_mesh
from mgwfbp_tpu.parallel.ringattn import local_attention, ring_attention
from mgwfbp_tpu.utils.platform import get_shard_map

import torch_seq_worker

shard_map = get_shard_map()
SHAPE = (2, 32, 2, 8)
TOL = 2e-5
CASES = (("causal", True), ("full", False))


def _arrays() -> dict:
    rs = np.random.RandomState(0)
    out = {}
    for name, _ in CASES:
        for t in ("q", "k", "v", "go"):
            out[f"{name}_{t}"] = rs.randn(*SHAPE).astype(np.float32)
    b, t, h, d = 1, 16, 1, 4
    out["uniform_q"] = np.zeros((b, t, h, d), np.float32)
    out["uniform_k"] = np.zeros((b, t, h, d), np.float32)
    out["uniform_v"] = np.random.RandomState(2).randn(b, t, h, d).astype(
        np.float32)
    out["uniform_go"] = np.ones((b, t, h, d), np.float32)
    return out


ARRAYS = _arrays()


@pytest.fixture(scope="module", params=[2, 4], ids=["s2", "s4"])
def ring(request, tmp_path_factory):
    seq = request.param
    spec = {"seq": seq, "tasks": ["ring"],
            "cases": [[n, c] for n, c in CASES] + [["uniform", True]]}
    outs = torch_seq_worker.run_ranks(
        seq, str(tmp_path_factory.mktemp(f"ring{seq}")), spec, ARRAYS)
    return seq, outs


def _gathered(outs, key: str) -> np.ndarray:
    return np.concatenate([o[key] for o in outs], axis=1)


def _jax_ring(seq: int, name: str, causal: bool) -> np.ndarray:
    mesh = make_mesh(MeshSpec(data=8 // seq, seq=seq))
    spec = P(None, SEQ_AXIS)
    f = shard_map(
        lambda q, k, v: ring_attention(q, k, v, axis_name=SEQ_AXIS,
                                       causal=causal),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False)
    q, k, v = (jnp.asarray(ARRAYS[f"{name}_{t}"]) for t in "qkv")
    return np.asarray(jax.jit(f)(q, k, v))


def _jax_local(name: str, causal: bool):
    q, k, v, go = (jnp.asarray(ARRAYS[f"{name}_{t}"])
                   for t in ("q", "k", "v", "go"))
    out = local_attention(q, k, v, causal=causal)
    grads = jax.grad(
        lambda q, k, v: jnp.sum(local_attention(q, k, v, causal=causal)
                                * go), argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name,causal", CASES)
def test_ring_output_equals_the_jax_ring_and_local_attention(ring, name,
                                                             causal):
    seq, outs = ring
    got = _gathered(outs, f"{name}_out")
    np.testing.assert_allclose(got, _jax_ring(seq, name, causal),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, _jax_local(name, causal)[0],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name,causal", CASES)
def test_ring_gradients_equal_jax_grad_of_local_attention(ring, name,
                                                          causal):
    _, outs = ring
    _, grads = _jax_local(name, causal)
    for t, want in zip("qkv", grads):
        np.testing.assert_allclose(_gathered(outs, f"{name}_d{t}"), want,
                                   rtol=TOL, atol=TOL, err_msg=f"d{t}")


def test_each_pass_launches_two_p2p_ops_per_rotation(ring):
    seq, outs = ring
    for o in outs:
        for name, _ in CASES:
            assert o[f"{name}_p2p"].tolist() == [2 * (seq - 1)] * 2


def test_ring_attention_softmax_normalized(ring):
    _, outs = ring
    out = _gathered(outs, "uniform_out")
    v = ARRAYS["uniform_v"]
    np.testing.assert_allclose(out[0, -1, 0], v[0].mean(axis=0)[0],
                               rtol=1e-5, atol=1e-5)
    # every causal position is the mean of the v rows up to it
    want = np.cumsum(v[0, :, 0], axis=0) / np.arange(1, 17)[:, None]
    np.testing.assert_allclose(out[0, :, 0], want, rtol=1e-5, atol=1e-5)
