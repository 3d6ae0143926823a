"""Port vs reference: the language models on the training path
(mgwfbp_tpu_torch data/ptb, models/lstm, the transformer's training
variant, the LM loss, carry and evaluation of train/step and train/trainer,
vs mgwfbp_tpu).

  * the PTB data: the synthetic stream, ``windowed_lm_dataset``,
    ``carry_layout`` and the loaders' batches are BIT-IDENTICAL at 1, 2 and
    4 ranks;
  * the small PTB LSTM (vocab 50, hidden 16, dropout 0) on weights carried
    from the JAX module's own init: logits and carry over two consecutive
    windows, the carry threaded, within 1e-5; the gradients of the LM loss
    against ``jax.grad`` within 2e-5 on all 27 leaves; the convert round
    trip bit for bit;
  * the small transformer (dropout 0) trains through dense attention, as
    the JAX registry builds it: gradients within 2e-5 of ``jax.grad``,
    the flash kernel launched no time; the registered module keeps flash
    attention for serving, and its backward still refuses;
  * at full width, from shapes only: the same leaf paths and sizes (the
    LSTM's 27 leaves, 66,022,000 parameters), the same arrival
    permutation and identical mgwfbp groups on the ici and 56Gb IB priors;
  * a 4-rank gloo port TrainStep on the small LSTM against
    ``make_train_step`` on a 4-device JAX CPU mesh after 1 and 3 steps,
    with nsteps_update 1 and 2: parameters and carry within the TRAJ_*
    bounds of tests/test_torch_train_dist.py; a step whose batch holds a
    token outside the vocabulary (a NaN embedding row, ``jnp.take``'s
    "fill") keeps parameters, optimizer state, step counter and carry in
    both packages;
  * the trainer's LM evaluation equals ``make_eval_step``'s over the same
    validation batches, and its commit reads back equal;
  * the CLI trains both models on the CPU and prints one JSON line whose
    loss falls, with a finite perplexity; its event stream, in the JAX
    schema, adds the loss and perplexity to the step and epoch records.

Every parity case runs without dropout: the two packages' random streams
differ. Tolerances: the same float32 math in another order (XLA's scan
and fused matmuls vs torch's LSTM kernel) holds 1e-5 on logits and carry
and 2e-5 on gradients.
"""

import json
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mgwfbp_tpu.data import ShardInfo as JaxShardInfo
from mgwfbp_tpu.data import data_prepare as jax_data_prepare
from mgwfbp_tpu.data import ptb as jax_ptb
from mgwfbp_tpu.models import ModelMeta
from mgwfbp_tpu.models import create_model as jax_create_model
from mgwfbp_tpu.models.lstm import PTBLSTM as JaxLSTM
from mgwfbp_tpu.models.transformer import TransformerLM as JaxTransformer
from mgwfbp_tpu.optim import make_optimizer as jax_make_optimizer
from mgwfbp_tpu.parallel.allreduce import arrival_order as jax_arrival_order
from mgwfbp_tpu.parallel.allreduce import make_merged_allreduce as jax_reducer
from mgwfbp_tpu.parallel.costmodel import lookup_alpha_beta as jax_lookup
from mgwfbp_tpu.parallel.mesh import MeshSpec, make_mesh
from mgwfbp_tpu.telemetry import events as jev
from mgwfbp_tpu.train.step import (
    TrainState,
    make_eval_step,
    make_loss_fn,
    make_train_step,
)
from mgwfbp_tpu_torch import models
from mgwfbp_tpu_torch.checkpoint import read_step
from mgwfbp_tpu_torch.config import make_config
from mgwfbp_tpu_torch.convert import (
    flatten_flax,
    flax_leaves,
    keystr,
    params_from_flax,
    params_to_flax,
    state_from_flax,
)
from mgwfbp_tpu_torch.data import ShardInfo, data_prepare
from mgwfbp_tpu_torch.data import ptb
from mgwfbp_tpu_torch.models.lstm import PTBLSTM
from mgwfbp_tpu_torch.models.transformer import TransformerLM
from mgwfbp_tpu_torch.ops import flash_attention
from mgwfbp_tpu_torch.parallel.allreduce import (
    arrival_order,
    make_merged_allreduce,
)
from mgwfbp_tpu_torch.parallel.costmodel import lookup_alpha_beta
from mgwfbp_tpu_torch.train import Trainer
from mgwfbp_tpu_torch.train.step import forward_loss

from test_torch_train_dist import TRAJ_ATOL, TRAJ_RTOL, _spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, H, T, B = 50, 16, 7, 2  # the small LSTM, its window, per-rank batch
WORLD = 4
OUT_TOL = 1e-5
GRAD_TOL = 2e-5
LM_OPT = dict(lr=2.0, momentum=0.9, norm_clip=0.25, batches_per_epoch=4)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(shape, seed: int, vocab: int = V) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(np.int32)


def _jax_lstm(seed: int = 0):
    jm = JaxLSTM(vocab_size=V, hidden_size=H, dropout=0.0)
    v = jax.jit(partial(jm.init, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, T), jnp.int32)
    )
    return jm, _np(v["params"])


def _port_lstm(params) -> PTBLSTM:
    m = PTBLSTM(V, H, 2, 0.0)
    m.load_state_dict(state_from_flax(m, params), strict=True)
    return m


def _lm_meta(name: str, has_carry: bool, vocab: int = V) -> ModelMeta:
    return ModelMeta(name=name, dataset="ptb", num_classes=vocab,
                     input_shape=(T,), input_dtype=jnp.int32, task="lm",
                     has_carry=has_carry)


# -- data ---------------------------------------------------------------


@pytest.mark.parametrize("nranks", [1, 2, 4])
def test_ptb_stream_windows_and_layout_bit_identical(nranks):
    stream = ptb.synthetic_ptb_stream(64, seed=3)
    assert np.array_equal(stream, jax_ptb.synthetic_ptb_stream(64, seed=3))
    got = ptb.windowed_lm_dataset(stream, 11)
    want = jax_ptb.windowed_lm_dataset(stream, 11)
    assert np.array_equal(got.data, want.data)
    assert np.array_equal(got.labels, want.labels)
    for rank in range(nranks):
        got = ptb.carry_layout(stream, 9, 3, rank, nranks)
        want = jax_ptb.carry_layout(stream, 9, 3, rank, nranks)
        assert got.data.dtype == want.data.dtype == np.int32
        assert np.array_equal(got.data, want.data)
        assert np.array_equal(got.labels, want.labels)


@pytest.mark.parametrize("nranks", [1, 2, 4])
def test_ptb_loader_batches_bit_identical(nranks):
    for rank in range(nranks):
        kw = dict(batch_size=5, seed=1, synthetic=True, num_steps=20)
        got = data_prepare("ptb", shard=ShardInfo(rank, nranks), **kw)
        want = jax_data_prepare("ptb", shard=JaxShardInfo(rank, nranks), **kw)
        assert got.num_batches_per_epoch == want.num_batches_per_epoch
        assert got.num_classes == want.num_classes == 10000
        for split in ("train", "val"):
            gb = [(np.asarray(x), np.asarray(y)) for x, y in getattr(got, split)]
            wb = [(np.asarray(x), np.asarray(y))
                  for x, y in getattr(want, split)]
            assert len(gb) == len(wb) > 0
            for (gx, gy), (wx, wy) in zip(gb, wb):
                assert gx.shape == (5, 20)
                assert np.array_equal(gx, wx) and np.array_equal(gy, wy)


# -- the small models ---------------------------------------------------


def test_lstm_logits_and_carry_over_two_windows():
    jm, params = _jax_lstm()
    port = _port_lstm(params).eval()
    x = _tokens((2, 3, T), 0)
    apply = jax.jit(lambda p, x, c: jm.apply({"params": p}, x, carry=c,
                                             train=False))
    jc, pc = jm.initial_carry(3), None
    for w in range(2):
        jl, jc = apply(params, jnp.asarray(x[w]), jc)
        with torch.no_grad():
            pl, pc = port(torch.from_numpy(x[w]), pc)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0,
                                   atol=OUT_TOL)
        assert len(pc) == len(jc) == 2
        for (c, h), (jcc, jh) in zip(pc, jc):  # Flax's (c, h) order
            np.testing.assert_allclose(c.numpy(), np.asarray(jcc), rtol=0,
                                       atol=OUT_TOL)
            np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0,
                                       atol=OUT_TOL)


def _jax_grads(jm, meta, params, x, y, carry):
    loss_fn = make_loss_fn(jm, meta)
    grads, (_, _, metrics) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        params, {}, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
        jax.random.PRNGKey(0), carry,
    )
    return _np(grads), float(metrics["loss"]), float(metrics["perplexity"])


def _port_grads(module, task, x, y, carry=None):
    for p in module.parameters():
        p.grad = None
    loss, metric, _ = forward_loss(module, task, torch.from_numpy(x),
                                   torch.from_numpy(y), carry)
    loss.backward()
    # dense kernels are (out, in) in torch, (in, out) in Flax
    grads = {p: t.grad.numpy().T if p.endswith(".kernel") else t.grad.numpy()
             for p, t in flax_leaves(module)}
    return grads, float(loss.detach()), float(metric)


def _assert_grads_equal(got, want, n_leaves):
    want = flatten_flax(want)
    assert list(got) == list(want) and len(want) == n_leaves
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=GRAD_TOL,
                                   err_msg=k)


def test_lstm_gradients_match_jax_grad_on_all_leaves():
    jm, params = _jax_lstm()
    port = _port_lstm(params).train()
    x, y = _tokens((3, T), 1), _tokens((3, T), 2)
    rs = np.random.RandomState(3)
    carry = tuple((rs.randn(3, H).astype(np.float32) * 0.5,
                   rs.randn(3, H).astype(np.float32) * 0.5) for _ in range(2))
    want, jloss, jppl = _jax_grads(
        jm, _lm_meta("lstm", True), params, x, y,
        jax.tree_util.tree_map(jnp.asarray, carry),
    )
    got, loss, ppl = _port_grads(
        port, "lm", x, y,
        tuple((torch.from_numpy(c), torch.from_numpy(h)) for c, h in carry),
    )
    assert loss == pytest.approx(jloss, abs=OUT_TOL)
    assert ppl == pytest.approx(jppl, rel=OUT_TOL)
    _assert_grads_equal(got, want, 27)


def test_lstm_convert_round_trips_bit_for_bit():
    _, params = _jax_lstm(seed=4)
    port = _port_lstm(params)
    back = flatten_flax(params_to_flax(port))
    want = flatten_flax(params)
    assert list(back) == list(want)
    assert all(np.array_equal(back[k], want[k]) for k in want)
    state = params_from_flax(back)
    own = port.state_dict()
    assert sorted(state) == sorted(own)
    assert all(torch.equal(state[k], own[k]) for k in own)


def _jax_transformer(vocab: int = V):
    jm = JaxTransformer(vocab_size=vocab, d_model=32, num_heads=2,
                        num_layers=2, d_ff=64, max_len=64, dropout=0.0)
    v = jax.jit(partial(jm.init, train=False))(
        jax.random.PRNGKey(5), jnp.zeros((1, 16), jnp.int32)
    )
    return jm, _np(v["params"])


def _port_transformer(params, vocab: int = V) -> TransformerLM:
    # built as the port's registry builds it, flash attention on
    m = TransformerLM(vocab, d_model=32, num_heads=2, num_layers=2, d_ff=64,
                      max_len=64, dropout=0.0, attn_impl="flash")
    m.load_state_dict(params_from_flax(params), strict=True)
    return m


def test_transformer_trains_through_dense_attention():
    jm, params = _jax_transformer()
    assert jm.attn_impl == "dense"
    x, y = _tokens((2, 16), 6), _tokens((2, 16), 7)
    served = _port_transformer(params)
    # the flash kernel takes this shape, and has no backward
    loss, _, _ = forward_loss(served, "lm", torch.from_numpy(x),
                              torch.from_numpy(y))
    with pytest.raises(NotImplementedError, match="backward"):
        loss.backward()
    port = models.for_training(_port_transformer(params)).train()
    assert port.attn_impl == "dense"
    assert all(b.attn_impl == "dense" for b in port.blocks)
    before = flash_attention.launches
    want, jloss, _ = _jax_grads(jm, _lm_meta("transformer", False), params,
                                x, y, None)
    got, loss, ppl = _port_grads(port, "lm", x, y)
    assert flash_attention.launches == before
    assert loss == pytest.approx(jloss, abs=OUT_TOL)
    assert ppl == pytest.approx(float(np.exp(loss)), rel=1e-6)
    _assert_grads_equal(got, want, len(flatten_flax(params)))


def test_registry_serves_flash_and_trainer_trains_dense(tmp_path):
    module, meta = models.create_model("transformer")
    assert module.attn_impl == "flash" and meta.task == "lm"
    cfg = make_config("transformer", logdir=str(tmp_path), checkpoint_dir=None)
    assert cfg.num_steps == 64 and cfg.batch_size == 16
    tr = Trainer(cfg, device="cpu", synthetic_data=True)
    try:
        assert tr.model.attn_impl == "dense"
        assert all(b.attn_impl == "dense" for b in tr.model.blocks)
        assert tr.meta.input_shape == (64,) and tr.carry is None
        assert tr.bundle.train.load_batch(0, 0)[0].shape == (16, 64)
        # a window past the position table gets a longer one
        longer = tr.model.with_max_len(5000)
        assert longer.pos_embed.num_embeddings == 5000
        assert longer.attn_impl == "dense" and longer.d_ff == 1024
    finally:
        tr.close()
    _, lstm_meta = models.create_model("lstm")
    assert (lstm_meta.task, lstm_meta.has_carry, lstm_meta.input_shape) == (
        "lm", True, (35,))


# -- full width, from shapes ---------------------------------------------


def _jax_shapes(name: str):
    jm, _ = jax_create_model(name)
    return jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 35), jnp.int32),
                        train=False)
    )["params"]


@pytest.fixture(scope="module")
def one_rank_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("pg_lm")
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(str(d), 'rdv')}",
        world_size=1, rank=0,
    )
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("name,n_leaves,n_params", [
    ("lstm", 27, 66_022_000), ("transformer", 54, None),
])
def test_full_width_leaves_arrival_and_schedules_equal_jax(
    one_rank_world, name, n_leaves, n_params
):
    shapes = _jax_shapes(name)
    jflat = [(jax.tree_util.keystr(kp), tuple(s.shape)) for kp, s in
             jax.tree_util.tree_flatten_with_path(shapes)[0]]
    with torch.device("meta"):
        module, _ = models.create_model(name)
    leaves = flax_leaves(module)
    got = [(keystr(p), tuple(t.shape) if p.rsplit(".", 1)[-1] != "kernel"
            else tuple(reversed(t.shape))) for p, t in leaves]
    assert got == jflat and len(got) == n_leaves
    if n_params is not None:
        assert sum(t.numel() for _, t in leaves) == n_params
    names = [n for n, _ in jflat]
    perm = arrival_order(len(names), names=names)
    assert perm == jax_arrival_order(len(names), names=names)
    if name == "lstm":  # the 60 MB embedding first, though its hooks fire last
        assert names[perm[0]] == "['embedding']['embedding']"
    for connection, world in (("ici", 1), ("ici", 16), ("56GbIB", 16)):
        want = jax_reducer(shapes, axis_name="data", policy="mgwfbp",
                           cost_model=jax_lookup(connection, world))
        red = make_merged_allreduce(
            module, policy="mgwfbp",
            cost_model=lookup_alpha_beta(connection, world),
        )
        red.detach()
        assert red.perm == want.perm
        assert red.schedule.groups == want.schedule.groups, (connection, world)


# -- four ranks against the JAX mesh -------------------------------------


def _lm_arrays(params) -> dict:
    out = {f"lm_params/{k}": a for k, a in flatten_flax(params).items()}
    for n in (1, 2):
        out[f"lm_x_n{n}"] = _tokens((3, n, WORLD * B, T), 10 + n)
        out[f"lm_y_n{n}"] = _tokens((3, n, WORLD * B, T), 20 + n)
    return out


@pytest.fixture(scope="module")
def lm_four_ranks(tmp_path_factory):
    jm, params = _jax_lstm(seed=8)
    arrays = _lm_arrays(params)
    spec = dict(tasks=[], lm_nsteps=[1, 2],
                lm=dict(vocab=V, hidden=H, batch=B, **LM_OPT))
    d = str(tmp_path_factory.mktemp("gloo4_lm"))
    return _spawn(WORLD, d, spec, arrays), (jm, params, arrays)


def _jax_lm_run(jm, params, arrays, n: int):
    tx, _ = jax_make_optimizer(
        LM_OPT["lr"], momentum=LM_OPT["momentum"], weight_decay=0.0,
        lr_schedule="ptb", dataset="ptb",
        num_batches_per_epoch=LM_OPT["batches_per_epoch"],
        norm_clip=LM_OPT["norm_clip"], world_size=WORLD,
    )
    mesh = make_mesh(MeshSpec(data=WORLD), devices=jax.devices()[:WORLD])
    reducer = jax_reducer(params, axis_name="data", policy="mgwfbp",
                          cost_model=jax_lookup("10GbE", WORLD))
    step = make_train_step(jm, _lm_meta("lstm", True), tx, mesh, reducer,
                           nsteps_update=n, donate=False)
    state = TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
        opt_state=tx.init(params), rng=jax.random.PRNGKey(0),
    )
    carry = jm.initial_carry(WORLD * B)
    saved = {}
    for k in range(3):
        state, _, carry = step(state, {"x": arrays[f"lm_x_n{n}"][k],
                                       "y": arrays[f"lm_y_n{n}"][k]}, carry)
        if k + 1 in (1, 3):
            saved[k + 1] = (state, carry)
    if n != 1:
        return saved, None
    x = np.array(arrays["lm_x_n1"][0])
    x[0, (WORLD - 1) * B, 0] = V  # outside the vocabulary: a NaN row
    after = step(state, {"x": x, "y": arrays["lm_y_n1"][0]}, carry)
    return saved, ((state, carry), after)


@pytest.fixture(scope="module")
def jax_lm_runs(lm_four_ranks):
    jm, params, arrays = lm_four_ranks[1]
    return {n: _jax_lm_run(jm, params, arrays, n) for n in (1, 2)}


@pytest.mark.parametrize("n,after", [(1, 1), (1, 3), (2, 1), (2, 3)])
def test_four_rank_lstm_step_matches_jax_mesh(lm_four_ranks, jax_lm_runs, n,
                                               after):
    ranks = lm_four_ranks[0]
    state, carry = jax_lm_runs[n][0][after]
    prefix = f"lm_n{n}/s{after}/"
    for r, out in enumerate(ranks):
        assert int(out[prefix + "step"]) == after == int(state.step)
        for k, w in flatten_flax(_np(state.params)).items():
            np.testing.assert_allclose(
                out[prefix + f"params/{k}"], w, rtol=TRAJ_RTOL,
                atol=TRAJ_ATOL, err_msg=f"{k} after {after} step(s), n={n}",
            )
        rows = slice(r * B, (r + 1) * B)
        for li, (c, h) in enumerate(carry):
            for part, w in (("c", c), ("h", h)):
                np.testing.assert_allclose(
                    out[prefix + f"carry/{li}/{part}"], np.asarray(w)[rows],
                    rtol=TRAJ_RTOL, atol=TRAJ_ATOL,
                    err_msg=f"carry {li} {part}, rank {r}",
                )
    for key in ranks[0]:  # replicas stay bit-identical across ranks
        if key.startswith(prefix + "params/"):
            assert all(np.array_equal(o[key], ranks[0][key]) for o in ranks)


def test_out_of_vocabulary_step_keeps_state_and_carry_in_both_packages(
    lm_four_ranks, jax_lm_runs
):
    for out in lm_four_ranks[0]:
        assert float(out["lm_nan/nonfinite"]) > 0
        assert bool(out["lm_nan/unchanged"])
    (before, carry), (after, metrics, carry_after) = jax_lm_runs[1][1]
    assert float(metrics["grads_nonfinite"]) > 0
    same = jax.tree_util.tree_map(
        lambda a, b: np.array_equal(np.asarray(a), np.asarray(b)),
        (before, carry), (after, carry_after),
    )
    assert all(jax.tree_util.tree_leaves(same))


# -- evaluation and the CLI ----------------------------------------------


@pytest.mark.parametrize("name", ["lstm", "transformer"])
def test_trainer_evaluation_and_commit_equal_jax(tmp_path, name):
    vocab = 10000  # the synthetic PTB vocabulary, at small widths
    cfg = make_config(name, batch_size=4, num_steps=12, logdir=str(tmp_path),
                      checkpoint_dir=str(tmp_path / "ckpt"))
    tr = Trainer(cfg, device="cpu", synthetic_data=True)
    if name == "lstm":
        jm = JaxLSTM(vocab_size=vocab, hidden_size=H, dropout=0.0)
        params = _np(jax.jit(partial(jm.init, train=False))(
            jax.random.PRNGKey(9), jnp.zeros((1, 12), jnp.int32)
        )["params"])
        tr.model = _port_lstm_at(params, vocab)
    else:
        jm, params = _jax_transformer(vocab)
        tr.model = models.for_training(_port_transformer(params, vocab))
    try:
        got = tr.evaluate()
        tr.save_step(0)
        saved, bstats, _ = read_step(tr.ckpt_dir, 0)
    finally:
        tr.close()
    # the commit reads back equal to the weights the evaluation ran on
    want_p = flatten_flax(params)
    assert bstats == {} and list(saved) == list(want_p)
    assert all(np.array_equal(saved[k], want_p[k]) for k in want_p)
    meta = _lm_meta(name, name == "lstm", vocab)
    mesh = make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    step = make_eval_step(jm, meta, mesh)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats={}, opt_state=(), rng=jax.random.PRNGKey(0))
    want = jax_data_prepare("ptb", batch_size=4, seed=0, synthetic=True,
                            num_steps=12)
    carry = jm.initial_carry(4) if name == "lstm" else None
    loss = count = 0.0
    for x, y in want.val:
        batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
        if carry is not None:
            sums, carry = step(state, batch, carry)
        else:
            sums = step(state, batch)
        loss += float(sums["loss"])
        count += float(sums["count"])
    assert got["count"] == count > 0
    assert got["loss"] == pytest.approx(loss / count, abs=OUT_TOL)
    assert got["perplexity"] == pytest.approx(np.exp(loss / count), rel=1e-4)


def _port_lstm_at(params, vocab: int) -> PTBLSTM:
    m = PTBLSTM(vocab, H, 2, 0.0)
    m.load_state_dict(state_from_flax(m, params), strict=True)
    return m


def test_cli_trains_both_language_models_on_the_cpu(tmp_path):
    """Two epochs of the same four batches (the PTB loader does not
    shuffle): four fresh batches of 10000-token text carry nothing a next
    unseen batch could profit from, so the loss is read where the batches
    repeat."""
    # one evaluation, after the second epoch
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2",
               MGWFBP_EVAL_EVERY_EPOCHS="2")
    procs = {
        name: subprocess.Popen(
            [sys.executable, "-m", "mgwfbp_tpu_torch.train_cli", "--dnn",
             name, "--synthetic", "--device", "cpu", "--batch-size", "4",
             "--num-batches-per-epoch", "4", "--epochs", "2", "--logdir",
             str(tmp_path / name), "--telemetry"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=str(tmp_path), env=env,
        )
        for name in ("lstm", "transformer")
    }
    for name, p in procs.items():
        try:
            out, err = p.communicate(timeout=240)
        finally:
            if p.poll() is None:
                p.kill()
                p.communicate()
        assert p.returncode == 0, err[-3000:]
        lines = [ln for ln in out.strip().splitlines() if ln.startswith("{")]
        assert len(lines) == 1, out
        doc = json.loads(lines[0])
        train, ev = doc["train"], doc["eval"]
        assert train["loss"] < train["first_loss"], (name, train)
        assert np.isfinite([train["perplexity"], ev["perplexity"]]).all()
        assert ev["perplexity"] == pytest.approx(np.exp(ev["loss"]))
        assert "accuracy" not in train
        # the stream keeps the JAX schema: a step record carries no loss
        # (the step reads nothing back); the epoch records add the loss
        # and perplexity
        (tag,) = os.listdir(tmp_path / name)
        (path,) = jev.find_stream_paths(str(tmp_path / name / tag))
        recs = jev.read_events(path)
        steps = jev.events_of(recs, "step")
        assert [r["step"] for r in steps] == list(range(1, 9))
        assert not [r for r in steps if "loss" in r or "perplexity" in r]
        for r in jev.events_of(recs, "epoch"):
            assert r["perplexity"] == pytest.approx(np.exp(r["loss"]),
                                                    rel=1e-5)
