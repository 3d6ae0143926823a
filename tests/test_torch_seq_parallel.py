"""Sequence parallelism in the port (``--seq-parallel``: ``parallel.mesh.
seq_groups``, ring attention in ``TransformerLM``, the trainer's time
slices) against the JAX package's (data x seq) path, as
tests/test_seq_parallel.py holds the JAX one against data parallelism.

The port runs in gloo processes (``tests/torch_seq_worker.py``, four ranks
a world, each group killed after its timeout); the JAX side on the 8 CPU
devices. The small transformer (vocab 50, d_model 32, 2 heads, 2 layers,
d_ff 64, window 32, dropout 0) starts from the JAX ``create_train_state``
weights, carried across by ``convert``; the batch is seeded numpy tokens
(one step of 8 windows).

  * the step: at data 2 x seq 2, one seq-parallel ``TrainStep`` (plain SGD,
    lr 0.1) gives the parameters of the JAX data-parallel step on the same
    global batch (the bounds of tests/test_seq_parallel.py: loss rel 1e-5,
    parameters rtol 2e-4, atol 2e-5), on every rank alike;
  * the reducer: the wfbp merged all-reduce over the world equals the
    plain per-leaf mean at rtol 1e-5;
  * eval: at seq 4, ``lm_eval_sums`` on each rank's slice, summed over the
    world, counts 8 * S samples, and loss / count equals the JAX mean token
    loss of the unsharded forward at rel 1e-5;
  * the trainer: ``Trainer`` at ``seq_parallel`` 4 (the registered
    transformer at a narrow width, 64-token windows) trains one epoch of 4
    steps and evaluates: a finite loss, an integer true ``count`` (the val
    windows, each once), no ring traffic while the backward profile runs,
    2 (S - 1) point-to-point operations per layer per forward and per
    backward, and a manifest recording the mesh (data 1, seq 4);
  * the refusals, in the JAX messages: a carry model (the step's and the
    trainer's), a window or a world the seq extent does not divide, and
    ``--comm-op hier`` with a seq extent, at the trainer and at the CLI.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mgwfbp_tpu.models import ModelMeta
from mgwfbp_tpu.models import create_model as jax_create_model
from mgwfbp_tpu.models.transformer import TransformerLM as JaxTransformerLM
from mgwfbp_tpu.optim import sgd
from mgwfbp_tpu.parallel.mesh import SEQ_AXIS, MeshSpec, make_mesh
from mgwfbp_tpu.train import create_train_state, make_train_step
from mgwfbp_tpu_torch import train_cli
from mgwfbp_tpu_torch.config import check_hier, make_config
from mgwfbp_tpu_torch.convert import flatten_flax
from mgwfbp_tpu_torch.data import ShardInfo, data_prepare
from mgwfbp_tpu_torch.models.lstm import PTBLSTM
from mgwfbp_tpu_torch.train import trainer as trainer_mod
from mgwfbp_tpu_torch.train.step import TrainStep

import torch_seq_worker

VOCAB, T = 50, 32
SMALL = dict(vocab=VOCAB, d_model=32, heads=2, layers=2, d_ff=64, window=T)
NARROW = dict(d_model=16, heads=2, layers=1, d_ff=32, window=64, batch=2,
              batches=4)


def _jax_setup():
    model = JaxTransformerLM(
        vocab_size=VOCAB, d_model=32, num_heads=2, num_layers=2, d_ff=64,
        max_len=T, dropout=0.0)
    meta = ModelMeta(
        name="transformer", dataset="ptb", num_classes=VOCAB,
        input_shape=(T,), input_dtype=jnp.int32, task="lm", has_carry=False)
    tx = sgd(0.1, momentum=0.0, weight_decay=0.0)
    state = create_train_state(
        jax.random.PRNGKey(0), model, jnp.zeros((1, T), jnp.int32), tx)
    rs = np.random.RandomState(0)
    x = rs.randint(0, VOCAB, (1, 8, T)).astype(np.int32)
    y = rs.randint(0, VOCAB, (1, 8, T)).astype(np.int32)
    return model, meta, tx, state, x, y


@pytest.fixture(scope="module")
def jax_side():
    model, meta, tx, state, x, y = _jax_setup()
    step = make_train_step(model, meta, tx, make_mesh(MeshSpec(data=8, seq=1)),
                           None, donate=False)
    s_dp, m_dp = step(state, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    logits = model.apply({"params": state.params}, jnp.asarray(x[0]),
                         train=False)
    per = optax.softmax_cross_entropy_with_integer_labels(
        logits, jnp.asarray(y[0])).mean()
    arrays = {f"params/{k}": np.asarray(a)
              for k, a in flatten_flax(state.params).items()}
    arrays.update(x=x, y=y)
    return {
        "arrays": arrays, "loss": float(m_dp["loss"]),
        "params": [np.asarray(a)
                   for a in jax.tree_util.tree_leaves(s_dp.params)],
        "eval_loss": float(per),
    }


@pytest.fixture(scope="module")
def data2_seq2(jax_side, tmp_path_factory):
    spec = dict(SMALL, seq=2, tasks=["step"], reducers=["none", "wfbp"])
    return torch_seq_worker.run_ranks(
        4, str(tmp_path_factory.mktemp("d2s2")), spec, jax_side["arrays"])


@pytest.fixture(scope="module")
def seq4(jax_side, tmp_path_factory):
    root = tmp_path_factory.mktemp("s4")
    spec = dict(SMALL, seq=4, tasks=["eval", "trainer"],
                trainer=dict(NARROW, logdir=str(root / "logs"),
                             ckpt=str(root / "ckpt"), profile=True))
    outs = torch_seq_worker.run_ranks(4, str(root), spec, jax_side["arrays"])
    return outs, root


def test_seq_parallel_step_matches_jax_data_parallel(jax_side, data2_seq2):
    for rank, out in enumerate(data2_seq2):
        assert float(out["step_none_loss"]) == pytest.approx(
            jax_side["loss"], rel=1e-5)
        for j, want in enumerate(jax_side["params"]):
            np.testing.assert_allclose(
                out[f"step_none_p{j}"], want, rtol=2e-4, atol=2e-5,
                err_msg=f"rank {rank}, leaf {j}")
    for out in data2_seq2[1:]:
        for j in range(len(jax_side["params"])):
            np.testing.assert_array_equal(out[f"step_none_p{j}"],
                                          data2_seq2[0][f"step_none_p{j}"])


def test_seq_parallel_with_mgwfbp_reducer(jax_side, data2_seq2):
    for out in data2_seq2:
        assert np.isfinite(float(out["step_wfbp_loss"]))
        for j in range(len(jax_side["params"])):
            np.testing.assert_allclose(out[f"step_wfbp_p{j}"],
                                       out[f"step_none_p{j}"], rtol=1e-5)


def test_seq_parallel_eval_matches_unsharded(jax_side, seq4):
    outs, _ = seq4
    for out in outs:
        loss, count = out["eval_sums"].tolist()
        assert count == 8 * 4
        assert loss / count == pytest.approx(jax_side["eval_loss"], rel=1e-5)


def _val_windows() -> int:
    bundle = data_prepare("ptb", batch_size=NARROW["batch"],
                          shard=ShardInfo(0, 1), seed=3, synthetic=True,
                          num_steps=NARROW["window"])
    return sum(len(xb) for xb, _ in bundle.val)


def test_trainer_seq_parallel_end_to_end(seq4):
    outs, root = seq4
    layers, s = NARROW["layers"], 4
    for r, out in enumerate(outs):
        assert out["trainer_sizes"].tolist() == [1, 4, r, 0]
        assert np.isfinite(float(out["trainer_loss"]))
        assert np.isfinite(float(out["trainer_eval_perplexity"]))
        count = float(out["trainer_eval_count"])
        assert count == float(int(count)) and count == _val_windows()
        # no ring traffic in the backward profile (Trainer construction);
        # each train step: 2 (S - 1) per layer forward and again backward
        assert int(out["trainer_init_p2p"]) == 0
        assert int(out["trainer_p2p"]) == (
            NARROW["batches"] * layers * 2 * 2 * (s - 1))
    # every rank of the ring saw the same loss
    assert len({float(o["trainer_eval_loss"]) for o in outs}) == 1
    manifests = glob.glob(str(root / "ckpt" / "*" / "sharded" / "*" /
                              "manifest.json"))
    assert manifests
    with open(manifests[0]) as f:
        doc = json.load(f)
    assert doc["mesh_axes"] == {"data": 1, "seq": 4}
    assert doc["world"] == 4 and doc["process_count"] == 4
    assert "-n1-" in os.path.basename(os.path.dirname(
        os.path.dirname(os.path.dirname(manifests[0]))))


# -- the refusals --------------------------------------------------------------


def _message(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_carry_model_rejects_seq_axis():
    jax_model, jax_meta = jax_create_model("lstm")
    want = _message(lambda: make_train_step(
        jax_model, jax_meta, sgd(0.1), make_mesh(MeshSpec(data=2, seq=4)),
        None, seq_axis=SEQ_AXIS))
    lstm = PTBLSTM(vocab_size=VOCAB, hidden_size=8, num_layers=1)
    opt = torch.optim.SGD(lstm.parameters(), lr=0.1)
    got = _message(lambda: TrainStep(lstm, opt, lambda s: 0.1, task="lm",
                                     seq_group=object()))
    assert got == want


@pytest.fixture
def world4(monkeypatch):
    """The trainer's view of a 4-rank world (rank 0); every refusal below
    fires before its first collective."""
    monkeypatch.setattr(trainer_mod, "world_size", lambda: 4)
    monkeypatch.setattr(trainer_mod, "rank", lambda: 0)


def _trainer(tmp_path, dnn: str, **kw):
    cfg = make_config(dnn, batch_size=2, max_epochs=1, logdir=str(tmp_path),
                      checkpoint_dir=None, **kw)
    return trainer_mod.Trainer(cfg, device="cpu", synthetic_data=True,
                               profile_backward=False)


@pytest.mark.parametrize("dnn", ["lstm", "lenet"])
def test_trainer_refuses_a_model_without_seq_support(tmp_path, world4, dnn):
    msg = _message(lambda: _trainer(tmp_path, dnn, seq_parallel=2))
    assert msg == (
        f"model {dnn!r} does not support sequence parallelism (needs a "
        "carry-free lm model with a seq_axis attribute, e.g. 'transformer')")


def test_trainer_refuses_a_window_the_seq_extent_does_not_divide(
        tmp_path, world4):
    msg = _message(lambda: _trainer(tmp_path, "transformer", seq_parallel=4,
                                    num_steps=30))
    assert msg == "sequence length 30 not divisible by seq mesh extent 4"


@pytest.mark.parametrize("world,seq", [(4, 3), (1, 2)])
def test_trainer_refuses_a_world_the_seq_extent_does_not_divide(
        tmp_path, monkeypatch, world, seq):
    monkeypatch.setattr(trainer_mod, "world_size", lambda: world)
    monkeypatch.setattr(trainer_mod, "rank", lambda: 0)
    want = _message(lambda: make_mesh(MeshSpec(data=-1, seq=seq),
                                      devices=jax.devices()[:world]))
    msg = _message(lambda: _trainer(tmp_path, "transformer",
                                    seq_parallel=seq))
    assert msg == want


def test_hier_with_a_seq_extent_is_refused(tmp_path, world4):
    want = ("--comm-op hier needs a multi-slice mesh (--dcn-slices > 1) and "
            "no sequence parallelism; got dcn=2, seq=2")
    assert _message(lambda: check_hier("hier", 2, 2)) == want
    assert _message(lambda: _trainer(tmp_path, "transformer",
                                     seq_parallel=2, comm_op="hier",
                                     dcn_slices=2, policy="wfbp")) == want


@pytest.mark.parametrize("argv,fragment", [
    (["--comm-op", "hier", "--dcn-slices", "2", "--seq-parallel", "2"],
     "no sequence parallelism; got dcn=2, seq=2"),
    (["--seq-parallel", "3", "--num-processes", "4"],
     "4 devices not divisible by seq=3 x dcn=1"),
])
def test_cli_refuses_before_the_rendezvous(capsys, argv, fragment):
    with pytest.raises(SystemExit) as e:
        train_cli.main(["--dnn", "transformer", "--synthetic", "--device",
                        "cpu", *argv])
    assert e.value.code == 2
    assert fragment in capsys.readouterr().err


def test_cli_takes_seq_parallel_into_the_config():
    cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(
        ["--dnn", "transformer", "--seq-parallel", "4"]))
    assert cfg.seq_parallel == 4 and cfg.num_steps == 64
