"""Port vs reference: the serving path (mgwfbp_tpu_torch.serving /
checkpoint / telemetry.serve vs mgwfbp_tpu's).

The JAX ``Trainer`` commits shard-native steps for a tiny transformer,
patched into the registry as tests/test_seq_parallel.py does, once with
``comm_op="rs_fwd_ag"`` (params stored sharded in merge-group rows) and once
with ``"all_reduce"`` (params stored replicated, one file per leaf). The
port's ``ServingModel`` serves the same steps as the JAX ``ServingModel``;
``/predict`` through both HTTP planes answers alike, bad requests included;
and the JAX reader accepts a step the port's ``save_replicated_step`` wrote.

Tolerance: logits within 1e-5 (rtol and atol), as in
tests/test_torch_transformer.py (the same float32 math in another order).
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from mgwfbp_tpu import models as jax_models
from mgwfbp_tpu.config import make_config
from mgwfbp_tpu.models.transformer import TransformerLM as JaxLM
from mgwfbp_tpu.parallel.mesh import MeshSpec, make_mesh
from mgwfbp_tpu.serving import model as jax_serving
from mgwfbp_tpu.serving.service import PredictService as JaxService
from mgwfbp_tpu.telemetry import serve as jax_telemetry
from mgwfbp_tpu.train.trainer import Trainer
from mgwfbp_tpu_torch import models
from mgwfbp_tpu_torch.checkpoint import (
    CheckpointRestoreError,
    _np_dtype,
    _viewed,
    leaf_to_tensor,
    save_replicated_step,
)
from mgwfbp_tpu_torch.convert import params_to_flax
from mgwfbp_tpu_torch.models.transformer import TransformerLM, init_weights
from mgwfbp_tpu_torch.serving.model import ServingModel, committed_sharded_steps
from mgwfbp_tpu_torch.serving.plane import ServePlane
from mgwfbp_tpu_torch.serving.service import PredictService
from mgwfbp_tpu_torch.telemetry.serve import MetricsAggregator, TelemetryServer
from mgwfbp_tpu_torch.utils.device import resolve_device

TINY = dict(d_model=16, num_heads=2, num_layers=2, d_ff=32, max_len=64,
            dropout=0.0)
VOCAB = 10000  # the synthetic ptb stream's vocabulary
SLOT = 4
TOL = 1e-5


def _jax_tiny(nc):
    nc = nc or VOCAB
    return (
        JaxLM(vocab_size=nc, **TINY),
        jax_models.ModelMeta(
            name="transformer", dataset="ptb", num_classes=nc,
            input_shape=(35,), input_dtype=np.int32, task="lm",
            has_carry=False,
        ),
    )


def _port_model(attn_impl: str = "flash") -> ServingModel:
    module = TransformerLM(vocab_size=VOCAB, attn_impl=attn_impl, **TINY)
    meta = models.ModelMeta(
        name="transformer", dataset="ptb", num_classes=VOCAB,
        input_shape=(35,), input_dtype=np.int32, task="lm",
    )
    return ServingModel(module, meta, device="cpu", max_batch=SLOT)


def _jax_model() -> jax_serving.ServingModel:
    module, meta = _jax_tiny(None)
    mesh = make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
    return jax_serving.ServingModel(module, meta, mesh=mesh, max_batch=SLOT)


def _tokens(n: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, VOCAB, (n, 35)).astype(np.int32)


def _post(port: int, body: bytes, timeout_s: float = 30.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=body,
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "null")


def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10
        ) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture(scope="module")
def jax_ckpts(tmp_path_factory):
    """comm_op -> the JAX trainer's checkpoint directory (two steps of a
    2-way data-parallel run, committed shard-native)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_models._REGISTRY, "transformer", _jax_tiny)
        for op in ("rs_fwd_ag", "all_reduce"):
            root = tmp_path_factory.mktemp(f"ckpt_{op}")
            cfg = make_config(
                "transformer", batch_size=2, max_epochs=1, logdir="",
                checkpoint_dir=os.path.join(str(root), "ckpt"), seed=3,
                num_batches_per_epoch=2, ckpt_every_steps=2, comm_op=op,
            )
            t = Trainer(cfg, synthetic_data=True, profile_backward=False,
                        mesh=make_mesh(MeshSpec(data=2),
                                       devices=jax.devices()[:2]))
            t.fit(1)
            t.close()
            tag = os.path.join(cfg.checkpoint_dir, cfg.tag())
            assert committed_sharded_steps(tag), op
            out[op] = tag
    return out


@pytest.mark.parametrize("op,kind", [("rs_fwd_ag", "sharded"),
                                     ("all_reduce", "replicated")])
def test_port_serves_jax_checkpoint_like_jax(jax_ckpts, op, kind):
    tag = jax_ckpts[op]
    step = committed_sharded_steps(tag)[-1]
    assert committed_sharded_steps(tag) == jax_serving.committed_sharded_steps(tag)
    src, _ = jax_serving.open_committed_step(tag, step)
    assert src.section_kind("params") == kind
    jm, pm = _jax_model(), _port_model()
    jm.load_step(tag, step)
    snap = pm.load_step(tag, step)
    assert snap.step == step and not snap.module.training
    for n, seed in ((SLOT, 1), (1, 2)):
        x = _tokens(n, seed)
        want, jstep = jm.run_padded(x)
        got, pstep = pm.run_padded(x)
        assert pstep == jstep == step
        assert got.shape == (n, 35, VOCAB)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_predict_over_http_matches_jax(jax_ckpts):
    tag = jax_ckpts["rs_fwd_ag"]
    step = committed_sharded_steps(tag)[-1]
    jm = _jax_model()
    jm.load_step(tag, step)
    jservice = JaxService(jm)
    jserver = jax_telemetry.TelemetryServer(jax_telemetry.MetricsAggregator(), 0)
    jserver.attach_predict(jservice)
    agg = MetricsAggregator(run={"role": "serve"})
    server = TelemetryServer(agg, 0)
    plane = ServePlane(_port_model(), tag, emit=agg.observe, server=server,
                       poll_s=60.0)
    jservice.start()
    plane.start()
    try:
        assert plane.poll_now() == step
        x = _tokens(2, seed=5)
        body = json.dumps({"inputs": x.tolist()}).encode()
        jcode, jdoc = _post(jserver.port, body)
        code, doc = _post(server.port, body)
        assert code == jcode == 200
        assert doc["served_step"] == jdoc["served_step"] == step
        np.testing.assert_allclose(
            np.asarray(doc["outputs"], np.float32),
            np.asarray(jdoc["outputs"], np.float32), rtol=TOL, atol=TOL,
        )
        # a single example rides as a batch of one on both planes
        one = json.dumps({"inputs": x[0].tolist()}).encode()
        (c1, d1), (c2, d2) = _post(jserver.port, one), _post(server.port, one)
        assert c1 == c2 == 200 and len(d1["outputs"]) == len(d2["outputs"]) == 1
        # malformed bodies and unknown routes answer alike
        for bad in (b"not json", b"[1, 2]", json.dumps({"x": 1}).encode()):
            assert _post(server.port, bad)[0] == _post(jserver.port, bad)[0] == 400
        assert _get(server.port, "/nope")[0] == _get(jserver.port, "/nope")[0] == 404
        code, text = _get(server.port, "/healthz")
        assert code == 200 and text.strip() == "ok"
        code, text = _get(server.port, "/status")
        serving = json.loads(text)["serving"]
        assert code == 200 and serving["step"] == step and serving["reloads"] == 1
        assert serving["stats"]["requests"] >= 1
        # detached, the route exists but answers 503 on both planes
        plane.close()
        jserver.attach_predict(None)
        assert _post(server.port, body)[0] == _post(jserver.port, body)[0] == 503
    finally:
        plane.close()
        jservice.close()
        server.close()
        jserver.close()


def _hold_queue(service) -> threading.Thread:
    """Park one request on an un-started service (its queue of one is then
    full); the parked request is answered when the service closes."""
    th = threading.Thread(target=service.handle, args=(_tokens(1),),
                          daemon=True)
    th.start()
    deadline = time.time() + 10
    while service._queue.qsize() < 1 and time.time() < deadline:
        time.sleep(0.01)
    assert service._queue.qsize() == 1
    return th


def test_predict_service_validation_matches_jax(jax_ckpts):
    """The cases of tests/test_serving.py::test_predict_service_validation,
    asked of both services: 503 before a step is served, 400 for inputs
    that are not a batch or not the model's shape or over the slot, 429
    when the queue is full, 200 for a single example."""
    tag = jax_ckpts["all_reduce"]
    step = committed_sharded_steps(tag)[-1]
    jm, pm = _jax_model(), _port_model()
    services = [JaxService(jm, queue_limit=1), PredictService(pm, queue_limit=1)]
    for s in services:
        assert s.handle(_tokens(1).tolist())[0] == 503
    jm.load_step(tag, step)
    pm.load_step(tag, step)
    cases = [
        ("garbage", "coercible"),
        (np.zeros((SLOT + 1, 35), np.int32), "slot"),
        (np.zeros((2, 34), np.int32), "inputs must be"),
        (np.zeros((2, 35, 1), np.int32), "inputs must be"),
    ]
    for inputs, words in cases:
        for s in services:
            code, doc = s.handle(inputs)
            assert code == 400 and words in doc["error"], (s, doc)
    for s in services:
        parked = _hold_queue(s)
        code, doc = s.handle(_tokens(1))
        assert code == 429 and doc["queue_limit"] == 1
        s.close()
        parked.join(timeout=10)
        assert not parked.is_alive()
    # token ids outside the vocabulary: XLA clamps the gather and answers,
    # the port refuses them (on the card such an index is a device fault
    # that would fail every later flush)
    port = PredictService(pm)
    code, doc = port.handle(np.full((1, 35), VOCAB, np.int32))
    assert code == 400 and "token ids" in doc["error"]
    port.start()
    try:
        code, doc = port.handle(_tokens(1)[0])
        assert code == 200 and len(doc["outputs"]) == 1
        assert doc["served_step"] == step
    finally:
        port.close()


def test_jax_reads_port_checkpoint(tmp_path):
    module = init_weights(
        TransformerLM(vocab_size=VOCAB, **TINY), torch.Generator().manual_seed(7)
    )
    save_replicated_step(str(tmp_path), 3, params_to_flax(module))
    assert jax_serving.committed_sharded_steps(str(tmp_path)) == [3]
    src, _ = jax_serving.open_committed_step(str(tmp_path), 3)
    assert src.section_kind("params") == "replicated" and src.world == 1
    jm, pm = _jax_model(), _port_model()
    jm.load_step(str(tmp_path), 3)
    pm.load_step(str(tmp_path), 3)
    x = _tokens(3, seed=8)
    (want, js), (got, ps) = jm.run_padded(x), pm.run_padded(x)
    assert js == ps == 3
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    with torch.inference_mode():
        direct = module.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, direct, rtol=TOL, atol=TOL)


def test_bfloat16_leaf_reads_back_as_bfloat16(tmp_path):
    """A bfloat16 leaf saved by the JAX side (an ml_dtypes array) comes
    back, without ml_dtypes in the port, as a torch bfloat16 tensor."""
    import ml_dtypes

    vals = [1.0, -2.5, 3.140625, 0.0]
    np.save(tmp_path / "leaf.npy", np.asarray(vals, ml_dtypes.bfloat16))
    raw = _viewed(np.load(tmp_path / "leaf.npy"), _np_dtype("bfloat16"))
    t = leaf_to_tensor(raw, "bfloat16")
    assert t.dtype == torch.bfloat16 and t.float().tolist() == vals


def test_hot_reload_swaps_steps_and_refuses_other_models(tmp_path):
    d = str(tmp_path)
    gen = torch.Generator().manual_seed(3)
    make = lambda **kw: init_weights(
        TransformerLM(vocab_size=VOCAB, **dict(TINY, **kw)), gen
    )
    m1, m2 = make(), make()
    pm = _port_model()
    plane = ServePlane(pm, d, poll_s=60.0)
    try:
        assert plane.poll_now() is None and pm.served_step() is None
        save_replicated_step(d, 1, params_to_flax(m1))
        assert plane.poll_now() == 1 and plane.poll_now() is None
        old = pm.snapshot()
        save_replicated_step(d, 2, params_to_flax(m2))
        assert plane.poll_now() == 2
        x = _tokens(1, seed=4)
        got, step = pm.run_padded(x)
        with torch.inference_mode():
            want = m2.eval()(torch.from_numpy(x)).numpy()
        assert step == 2
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        # a request that grabbed the old snapshot still computes on it
        assert old.step == 1 and pm.snapshot() is not old
        # a checkpoint of another model (d_ff 48) never replaces step 2
        save_replicated_step(d, 3, params_to_flax(make(d_ff=48)))
        for _ in range(3):
            assert plane.poll_now() is None
        assert pm.served_step() == 2
        with pytest.raises(CheckpointRestoreError, match="shape"):
            pm.load_step(d, 3)
    finally:
        plane.close()
    with pytest.raises(CheckpointRestoreError, match="expects"):
        other = ServingModel(
            TransformerLM(vocab_size=VOCAB, **dict(TINY, num_layers=1)),
            pm.meta, device="cpu",
        )
        other.load_step(d, 2)


def test_entry_points_refuse_a_missing_card():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device resolves")
    module, meta = models.create_model("transformer")
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingModel(module, meta, device=device)


def test_standalone_cli_serves_predict(tmp_path, monkeypatch):
    """``python -m mgwfbp_tpu_torch.serving`` on the CPU, for the registered
    transformer retargeted to a 29-token vocabulary (``--dataset an4``)."""
    from mgwfbp_tpu_torch.serving.__main__ import main

    module, meta = models.create_model("transformer", dataset="an4")
    assert meta.num_classes == 29 and module.d_model == 256
    init_weights(module, torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "ckpt")
    save_replicated_step(ckpt, 5, params_to_flax(module))
    port_file = tmp_path / "serve_port.json"
    monkeypatch.setenv("MGWFBP_METRICS_PORT_FILE", str(port_file))
    rc_box: dict = {}
    th = threading.Thread(
        target=lambda: rc_box.update(rc=main([
            "--dnn", "transformer", "--dataset", "an4", "--device", "cpu",
            "--checkpoint-dir", ckpt, "--metrics-port", "0",
            "--poll-s", "0.05", "--max-batch", "2", "--max-seconds", "10",
        ])),
        daemon=True,
    )
    th.start()
    deadline = time.time() + 10
    port = None
    while time.time() < deadline and port is None:
        try:
            doc = json.loads(port_file.read_text())
            assert doc["role"] == "serve", doc
            port = int(doc["port"])
        except (OSError, ValueError, KeyError):
            time.sleep(0.05)
    assert port, "replica never wrote its role-aware port file"
    x = np.random.RandomState(0).randint(0, 29, (2, 35)).tolist()
    resp = None
    while time.time() < deadline and resp is None:
        code, doc = _post(port, json.dumps({"inputs": x}).encode())
        if code == 200:
            resp = doc
        else:
            time.sleep(0.1)
    assert resp is not None, "standalone replica never answered /predict"
    assert resp["served_step"] == 5
    out = np.asarray(resp["outputs"], np.float32)
    with torch.inference_mode():
        want = module.eval()(torch.tensor(x)).numpy()
    assert out.shape == (2, 35, 29)
    np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)
    th.join(timeout=60)
    assert rc_box.get("rc") == 0
