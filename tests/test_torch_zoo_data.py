"""Port vs reference around the zoo: MNIST data, checkpoints, serving, the
evaluator, calibration and the trainer's entry points
(mgwfbp_tpu_torch.{data,checkpoint,serving,evaluate,calibrate,train} vs
mgwfbp_tpu's, on the CPU).

  * MNIST idx files (plain and gzipped) that the test writes read back
    exactly, in both packages;
  * the MNIST loaders hand over batches bit-identical to the JAX package's,
    synthetic twin (4096 / 512 images) and real files, at 1 and 2 ranks;
  * a caffe_cifar step the port's trainer commits restores through the JAX
    ``Checkpointer`` (params, the momentum trace, the count), and the
    reverse; a googlenet step the port writes (batch statistics off their
    init) reads back through the JAX package's shard reader, leaf for leaf,
    and the JAX model's eval logits on it equal the port's (within 1e-4
    of max(1, |logit|));
  * ``/predict`` on an mnistnet checkpoint of either package answers as the
    JAX server does (rtol / atol 2e-5);
  * ``evaluate`` gives vgg16's top-1 / top-5 equal to the trainer's own;
  * ``calibrate --forward`` profiles zoo models (googlenet through its aux
    loss) and still refuses ``lstman4``, naming Queue 1 item 3;
  * the trainer feeds the inceptions 299 x 299 images and takes a step;
    ``train_cli`` trains mnistnet.
"""

import gzip
import json
import os
import struct

import jax
import numpy as np
import pytest
import torch

from mgwfbp_tpu import models as jzoo
from mgwfbp_tpu.checkpoint import Checkpointer as JaxCheckpointer
from mgwfbp_tpu.config import make_config as jax_make_config
from mgwfbp_tpu.data import ShardInfo as JaxShardInfo
from mgwfbp_tpu.data import data_prepare as jax_data_prepare
from mgwfbp_tpu.data.datasets import load_mnist as jax_load_mnist
from mgwfbp_tpu.parallel.mesh import MeshSpec, make_mesh
from mgwfbp_tpu.serving import model as jax_serving
from mgwfbp_tpu.train.trainer import Trainer as JaxTrainer
from mgwfbp_tpu_torch import calibrate, train_cli
from mgwfbp_tpu_torch import evaluate as port_evaluate
from mgwfbp_tpu_torch import models
from mgwfbp_tpu_torch.checkpoint import save_replicated_step
from mgwfbp_tpu_torch.config import make_config
from mgwfbp_tpu_torch.convert import flatten_flax, momentum_to_flax, variables_to_flax
from mgwfbp_tpu_torch.data import ShardInfo, data_prepare
from mgwfbp_tpu_torch.data.datasets import load_mnist
from mgwfbp_tpu_torch.serving.model import ServingModel
from mgwfbp_tpu_torch.serving.plane import ServePlane
from mgwfbp_tpu_torch.telemetry.serve import MetricsAggregator, TelemetryServer
from mgwfbp_tpu_torch.train import Trainer

from torch_zoo_util import images, nchw, seeded

RTOL, ATOL = 2e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _write_idx(path: str, arr: np.ndarray) -> None:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


def _mnist_files(root, n_train=96, n_test=40, suffix=""):
    rs = np.random.RandomState(7)
    out = {}
    for prefix, n in (("train", n_train), ("t10k", n_test)):
        img = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
        lbl = rs.randint(0, 10, n).astype(np.uint8)
        _write_idx(os.path.join(root, f"{prefix}-images-idx3-ubyte{suffix}"), img)
        _write_idx(os.path.join(root, f"{prefix}-labels-idx1-ubyte{suffix}"), lbl)
        out[prefix] = (img, lbl)
    return out


@pytest.mark.parametrize("suffix", ["", ".gz"])
def test_mnist_idx_files_read_back_exactly(tmp_path, suffix):
    files = _mnist_files(str(tmp_path), suffix=suffix)
    for split, prefix in (("train", "train"), ("test", "t10k")):
        got = load_mnist(str(tmp_path), split)
        want = jax_load_mnist(str(tmp_path), split)
        img, lbl = files[prefix]
        assert got.data.shape == (len(img), 28, 28, 1) and got.data.dtype == np.uint8
        assert np.array_equal(got.data[..., 0], img)
        assert np.array_equal(got.labels, lbl.astype(np.int32))
        assert np.array_equal(got.data, want.data)
        assert np.array_equal(got.labels, want.labels)
        assert got.num_classes == want.num_classes == 10
    assert load_mnist(str(tmp_path / "none"), "train") is None


def _batches(loader, epoch, n):
    loader.set_epoch(epoch)
    out = []
    for i, (x, y) in enumerate(loader):
        if i == n:
            break
        out.append((np.asarray(x), np.asarray(y)))
    return out


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("real", [False, True])
def test_mnist_batches_bit_identical(tmp_path, world, real):
    if real:
        _mnist_files(str(tmp_path))
    kw = dict(batch_size=8, seed=2, data_dir=str(tmp_path),
              synthetic=None if real else True)
    for rank in range(world):
        want = jax_data_prepare("mnist", shard=JaxShardInfo(rank, world), **kw)
        got = data_prepare("mnist", shard=ShardInfo(rank, world), **kw)
        assert got.synthetic is (not real) and want.synthetic is (not real)
        assert got.num_batches_per_epoch == want.num_batches_per_epoch == (
            96 if real else 4096) // (8 * world)
        for epoch in (0, 1):
            pairs = zip(_batches(got.train, epoch, 3),
                        _batches(want.train, epoch, 3))
            for (gx, gy), (wx, wy) in pairs:
                assert gx.shape == (8, 28, 28, 1) and gx.dtype == np.float32
                assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
        val_got, val_want = list(got.val), list(want.val)
        assert len(val_got) == len(val_want) > 0
        for (gx, gy), (wx, wy) in zip(val_got, val_want):
            assert np.array_equal(gx, wx) and np.array_equal(gy, wy)


# ---------------------------------------------------------------------------
# checkpoints and serving
# ---------------------------------------------------------------------------


def _kw(root) -> dict:
    return dict(logdir="", checkpoint_dir=str(root), num_batches_per_epoch=3,
                batch_size=4, lr=0.05, seed=3, max_epochs=2)


@pytest.fixture
def small_synth(monkeypatch):
    monkeypatch.setenv("MGWFBP_SYNTH_TRAIN_N", "64")
    monkeypatch.setenv("MGWFBP_SYNTH_VAL_N", "16")
    monkeypatch.delenv("MGWFBP_FAULT_PLAN", raising=False)


def test_caffe_cifar_step_of_the_port_restores_in_jax(tmp_path, small_synth):
    t = Trainer(make_config("caffe_cifar", **_kw(tmp_path)), device="cpu",
                synthetic_data=True)
    t.fit(1)
    trace = momentum_to_flax(t.model, t.optimizer)
    params, _ = variables_to_flax(t.model)
    root, step = t.ckpt_dir, t.iteration
    t.close()
    mesh = make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    jt = JaxTrainer(jax_make_config("caffe_cifar", **_kw(tmp_path)),
                    mesh=mesh, profile_backward=False, synthetic_data=True)
    ck = JaxCheckpointer(root)
    try:
        snap = ck.restore(jt.state)
    finally:
        ck.close()
        jt.close()
    assert snap.iteration == step
    got = flatten_flax(jax.tree_util.tree_map(np.asarray, snap.state.params))
    want = flatten_flax(params)
    assert list(got) == list(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    opt_leaves = [np.asarray(a) for a in
                  jax.tree_util.tree_leaves(snap.state.opt_state)]
    for k, v in trace.items():  # every momentum trace is an optax leaf
        assert any(a.shape == v.shape and np.array_equal(a, v)
                   for a in opt_leaves), k
    assert int(snap.state.step) == step


def test_caffe_cifar_step_of_jax_restores_in_the_port(tmp_path, small_synth):
    mesh = make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    cfg = jax_make_config("caffe_cifar", **_kw(tmp_path))
    jt = JaxTrainer(cfg, mesh=mesh, profile_backward=False,
                    synthetic_data=True)
    jt.fit(1)
    jt.checkpointer.wait()
    want = flatten_flax(jax.tree_util.tree_map(np.asarray, jt.state.params))
    root = os.path.join(cfg.checkpoint_dir, cfg.tag())
    jt.close()
    t = Trainer(make_config("caffe_cifar", **_kw(tmp_path)), device="cpu",
                synthetic_data=True)
    try:
        assert t.ckpt_dir == root and t.iteration == 3  # resumed
        got = flatten_flax(variables_to_flax(t.model)[0])
        assert list(got) == list(want)
        assert all(np.array_equal(got[k], want[k]) for k in want)
        trace = momentum_to_flax(t.model, t.optimizer)
        assert any(np.abs(v).max() > 0 for v in trace.values())
    finally:
        t.close()


def test_googlenet_step_of_the_port_restores_in_jax(tmp_path):
    """The JAX package's shard reader takes the port's googlenet step
    (params and batch statistics off their init), and the JAX model's eval
    logits on it equal the port's."""
    from functools import partial

    from mgwfbp_tpu.checkpoint import MANIFEST_FILE, SHARD_SUBDIR
    from mgwfbp_tpu.checkpoint import ShardSource as JaxShardSource
    from mgwfbp_tpu_torch.convert import flax_path

    module, meta = models.create_model("googlenet")
    seeded(module, 5)
    module.train()
    with torch.no_grad():  # batch statistics off their init
        module(nchw(images(2, meta.input_shape, seed=6)))
    params, bstats = variables_to_flax(module)
    save_replicated_step(str(tmp_path), 7, params, batch_stats=bstats)
    step_dir = os.path.join(str(tmp_path), SHARD_SUBDIR, f"{7:08d}")
    with open(os.path.join(step_dir, MANIFEST_FILE)) as f:
        src = JaxShardSource(step_dir, json.load(f))
    src.validate()
    restored = {}
    for section, want in (("params", params), ("batch_stats", bstats)):
        flat = {flax_path(str(doc["path"])): np.asarray(src.read_leaf(section, j))
                for j, doc in enumerate(src.section_docs(section))}
        want = flatten_flax(want)
        assert list(flat) == list(want)
        assert all(np.array_equal(flat[k], want[k]) for k in want)
        restored[section] = flat
    nest = {}
    for section, flat in restored.items():
        tree = nest.setdefault(section, {})
        for path, leaf in flat.items():
            *mods, name = path.split(".")
            node = tree
            for m in mods:
                node = node.setdefault(m, {})
            node[name] = leaf
    jm, _ = jzoo.create_model("googlenet")
    x = images(1, meta.input_shape, seed=8)
    want = np.asarray(jax.jit(partial(jm.apply, train=False))(nest, x))
    module.eval()
    with torch.no_grad():
        got = module(nchw(x)).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape == (1, 1000)
    assert float(np.abs(got - want).max()) <= 1e-4 * scale


def _post(port: int, body: bytes):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _mnistnet_checkpoint(tmp_path, writer: str) -> str:
    """A committed mnistnet step: the port's seeded weights through
    ``save_replicated_step``, or a step of the JAX trainer."""
    if writer == "port":
        module, _ = models.create_model("mnistnet")
        seeded(module, 9)
        params, _ = variables_to_flax(module)
        save_replicated_step(str(tmp_path), 3, params)
        return str(tmp_path)
    cfg = jax_make_config("mnistnet", checkpoint_dir=str(tmp_path / "ckpt"),
                          logdir="", batch_size=4, num_batches_per_epoch=3,
                          seed=9)
    jt = JaxTrainer(cfg, mesh=make_mesh(MeshSpec(data=1),
                                        devices=jax.devices()[:1]),
                    profile_backward=False, synthetic_data=True)
    try:
        jt.fit(1)
        jt.checkpointer.wait()
    finally:
        jt.close()
    return os.path.join(cfg.checkpoint_dir, cfg.tag())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_predict_serves_mnistnet_like_jax(tmp_path, writer, monkeypatch):
    monkeypatch.delenv("MGWFBP_FAULT_PLAN", raising=False)
    monkeypatch.chdir(tmp_path)  # the JAX trainer may log under ./logs
    tag = _mnistnet_checkpoint(tmp_path, writer)
    _, meta = models.create_model("mnistnet")
    jmod, jmeta = jzoo.create_model("mnistnet")
    jm = jax_serving.ServingModel(
        jmod, jmeta, mesh=make_mesh(MeshSpec(data=1), devices=jax.devices()[:1]),
        max_batch=4)
    agg = MetricsAggregator(run={"role": "serve"})
    server = TelemetryServer(agg, 0)
    plane = ServePlane(ServingModel(models.create_model("mnistnet")[0], meta,
                                    device="cpu", max_batch=4),
                       tag, emit=agg.observe, server=server, poll_s=60.0)
    plane.start()
    try:
        step = plane.poll_now()
        assert step == 3  # both writers commit after 3 steps
        jm.load_step(tag, step)
        x = images(3, meta.input_shape, seed=10)
        want, jstep = jm.run_padded(x)
        code, doc = _post(server.port, json.dumps({"inputs": x.tolist()}).encode())
        assert code == 200 and doc["served_step"] == jstep == step
        got = np.asarray(doc["outputs"], np.float32)
        assert got.shape == (3, 10)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)
    finally:
        plane.close()
        server.close()


# ---------------------------------------------------------------------------
# evaluator, calibration, trainer, CLI
# ---------------------------------------------------------------------------


def test_evaluate_vgg16_equals_the_trainers_own(tmp_path, small_synth):
    cfg = make_config("vgg16", **dict(_kw(tmp_path), num_batches_per_epoch=2))
    t = Trainer(cfg, device="cpu", synthetic_data=True)
    metrics = t.fit(1)
    root = t.ckpt_dir
    t.close()
    got = port_evaluate.evaluate("vgg16", root, synthetic=True, batch_size=4,
                                 seed=3, device="cpu")
    ev = metrics["eval"]
    assert got["count"] == ev["count"] == 16
    for k in ("top1", "top5"):
        assert got[k] == ev[k]
    assert got["loss"] == pytest.approx(ev["loss"], rel=1e-6)


@pytest.mark.parametrize("model,leaves", [("lenet", 10), ("googlenet", 187)])
def test_calibrate_forward_profiles_zoo_models(tmp_path, model, leaves):
    out = tmp_path / "p.json"
    assert calibrate.main(["--out", str(out), "--forward", "--model", model,
                           "--device", "cpu", "--batch-size", "1",
                           "--iters", "1", "--warmup", "0"]) == 0
    doc = json.loads(out.read_text())
    assert len(doc["tb_s"]) == len(doc["tf_s"]) == leaves
    assert all(np.isfinite(doc["tb_s"])) and doc["meta"]["model"] == model


def test_calibrate_forward_still_refuses_lstman4(tmp_path):
    """``calibrate --forward --model lstman4`` now writes the speech
    model's layer profile: 78 leaves in the arrival permutation's order."""
    out = tmp_path / "x.json"
    assert calibrate.main(["--out", str(out), "--forward", "--model",
                           "lstman4", "--device", "cpu", "--batch-size", "1",
                           "--iters", "1", "--warmup", "0"]) == 0
    doc = json.loads(out.read_text())
    assert len(doc["tb_s"]) == len(doc["arrival_names"]) == 78
    assert doc["arrival_names"][0].startswith("['rnn_4']")
    assert all(np.isfinite(doc["tb_s"]))


def test_the_trainer_feeds_inceptions_299_and_steps(tmp_path, monkeypatch):
    monkeypatch.setenv("MGWFBP_SYNTH_TRAIN_N", "2")
    monkeypatch.setenv("MGWFBP_SYNTH_VAL_N", "1")
    cfg = make_config("inceptionv3", batch_size=1, logdir="",
                      num_batches_per_epoch=1, augment=False)
    t = Trainer(cfg, device="cpu", profile_backward=False,
                synthetic_data=True)
    try:
        x, _ = t.bundle.train.load_batch(0, 0)
        assert x.shape == (1, 299, 299, 3)
        assert t.meta.has_aux_logits
        metrics = t.train_epoch(0)
        assert np.isfinite(metrics["loss"]) and len(t.losses) == 1
        ev = t.evaluate()  # eval mode: the main logits only
        assert ev["count"] == 1 and np.isfinite(ev["loss"])
    finally:
        t.close()


def test_train_cli_trains_mnistnet(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("MGWFBP_FAULT_PLAN", raising=False)
    assert train_cli.main([
        "--dnn", "mnistnet", "--synthetic", "--device", "cpu", "--epochs",
        "2", "--num-batches-per-epoch", "8", "--batch-size", "16",
        "--logdir", str(tmp_path)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    train = line["train"]
    assert np.isfinite(train["loss"]) and train["loss"] < train["first_loss"]
