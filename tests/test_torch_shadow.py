"""The port's shadow scorer (``serving/shadow.py``) against the JAX
package's, and the places that run it: ``ServePlane(shadow=True)``,
``python -m mgwfbp_tpu_torch.serving --shadow`` and the trainer's
in-process plane (``train_cli --serve-shadow``).

  * the held-out batches are the JAX scorer's, array for array (numpy from
    one seed), and the shadow loss of one committed step equals the JAX
    scorer's on the JAX ``ServingModel`` of the same checkpoint within
    1e-5 absolute, for lenet and ResNet-20 (with batch statistics); both
    emit one ``shadow_eval`` record with the served step;
  * the scorer is dark for the transformer (no score, no record), as in
    JAX;
  * ``ServePlane(shadow=True)`` scores every reload and the aggregator
    renders the ``mgwfbp_shadow_*`` gauges; the standalone replica with
    ``--shadow --telemetry-dir`` writes ``reload`` and ``shadow_eval``
    records the JAX reader accepts;
  * a CPU lenet ``Trainer`` with ``serve_shadow`` and a checkpoint
    directory scores its own commits mid-run, ``train_loss`` riding along
    from the health stream; without a checkpoint directory it refuses
    (no plane) as the JAX trainer does, and ``--serve-shadow`` implies the
    event stream.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from mgwfbp_tpu.models import create_model as jax_create_model
from mgwfbp_tpu.parallel.mesh import MeshSpec, make_mesh
from mgwfbp_tpu.serving import model as jax_serving
from mgwfbp_tpu.serving.shadow import ShadowScorer as JaxScorer
from mgwfbp_tpu.telemetry import events as jax_events
from mgwfbp_tpu_torch import models, train_cli
from mgwfbp_tpu_torch.checkpoint import save_replicated_step
from mgwfbp_tpu_torch.config import make_config
from mgwfbp_tpu_torch.convert import flatten_flax, variables_to_flax
from mgwfbp_tpu_torch.models.common import init_weights
from mgwfbp_tpu_torch.serving.model import ServingModel
from mgwfbp_tpu_torch.serving.plane import ServePlane
from mgwfbp_tpu_torch.serving.shadow import ShadowScorer
from mgwfbp_tpu_torch.telemetry import events, export
from mgwfbp_tpu_torch.telemetry.serve import MetricsAggregator
from mgwfbp_tpu_torch.train import Trainer

SLOT = 4
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _checkpoint(tmp_path, name: str, step: int = 4) -> str:
    """A committed step of ``name`` at a seeded init, batch statistics moved
    off their init (so eval mode reads them)."""
    module, _ = models.create_model(name)
    init_weights(module, torch.Generator().manual_seed(5))
    params, bstats = variables_to_flax(module)
    rs = np.random.RandomState(11)
    bstats = {k: (v + np.float32(0.1) * rs.randn(*v.shape).astype(np.float32)
                  if k.endswith("mean") else v * np.float32(1.3))
              for k, v in flatten_flax(bstats).items()}
    d = str(tmp_path / name)
    save_replicated_step(d, step, params, batch_stats=bstats or None)
    return d


@pytest.mark.parametrize("name", ["lenet", "resnet20"])
def test_shadow_loss_matches_jax(tmp_path, name):
    d = _checkpoint(tmp_path, name)
    module, meta = models.create_model(name)
    pm = ServingModel(module, meta, device="cpu", max_batch=SLOT)
    snap = pm.load_step(d, 4)
    got: list = []
    ours = ShadowScorer(pm, emit=lambda ev, f: got.append((ev, f)))
    jmod, jmeta = jax_create_model(name)
    jm = jax_serving.ServingModel(
        jmod, jmeta, mesh=make_mesh(MeshSpec(data=1),
                                    devices=jax.devices()[:1]),
        max_batch=SLOT)
    jsnap = jm.load_step(d, 4)
    want: list = []
    theirs = JaxScorer(jm, emit=lambda ev, f: want.append((ev, f)))
    assert ours.supported and theirs.supported
    assert len(ours._data) == len(theirs._data) == 2
    for (x, y), (jx, jy) in zip(ours._data, theirs._data):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    loss = ours.score(snap)
    jloss = theirs.score(jsnap)
    assert np.isfinite(loss) and abs(loss - jloss) <= TOL
    assert [ev for ev, _ in got] == [ev for ev, _ in want] == ["shadow_eval"]
    assert got[0][1]["step"] == want[0][1]["step"] == 4
    assert abs(got[0][1]["loss"] - want[0][1]["loss"]) <= TOL


def test_shadow_is_dark_for_the_transformer(tmp_path):
    module, meta = models.create_model("transformer")
    pm = ServingModel(module, meta, device="cpu", max_batch=2)
    got: list = []
    scorer = ShadowScorer(pm, emit=lambda ev, f: got.append(ev))
    assert not scorer.supported and scorer._data == []
    assert scorer.score(None) is None and got == []


def test_serve_plane_scores_every_reload(tmp_path):
    d = _checkpoint(tmp_path, "lenet", step=2)
    module, meta = models.create_model("lenet")
    agg = MetricsAggregator(run={"role": "serve"})
    plane = ServePlane(ServingModel(module, meta, device="cpu",
                                    max_batch=SLOT),
                       d, emit=agg.observe, shadow=True, poll_s=60.0,
                       train_loss_fn=lambda: 2.0)
    plane.start()
    try:
        assert plane.scorer is not None
        assert plane.poll_now() == 2
        st = agg.status()["serving"]
        assert st["step"] == 2 and st["shadow"]["step"] == 2
        assert st["shadow"]["train_loss"] == 2.0
        values = export.parse_metrics_text(
            export.render_metrics(agg.values()))
        assert values["mgwfbp_shadow_evals_total"] == 1
        assert values["mgwfbp_shadow_eval_delta"] == pytest.approx(
            values["mgwfbp_shadow_eval_loss"] - 2.0, abs=1e-5)
    finally:
        plane.close()
    plane = ServePlane(ServingModel(module, meta, device="cpu",
                                    max_batch=SLOT), d, shadow=False)
    assert plane.scorer is None
    plane.close()


def test_standalone_replica_with_shadow(tmp_path):
    from mgwfbp_tpu_torch.serving.__main__ import main

    d = _checkpoint(tmp_path, "lenet", step=3)
    tel = tmp_path / "tel"
    rc: dict = {}
    th = threading.Thread(target=lambda: rc.update(rc=main([
        "--dnn", "lenet", "--device", "cpu", "--checkpoint-dir", d,
        "--shadow", "--telemetry-dir", str(tel), "--poll-s", "0.05",
        "--max-batch", str(SLOT), "--max-seconds", "4"])), daemon=True)
    th.start()
    th.join(60)
    assert rc.get("rc") == 0
    path = str(tel / "telemetry.jsonl")
    rows = events.read_event_set(path)
    assert [r["step"] for r in events.events_of(rows, "reload")] == [3]
    shadow = events.events_of(rows, "shadow_eval")
    assert [r["step"] for r in shadow] == [3] and np.isfinite(
        shadow[0]["loss"])
    assert jax_events.read_event_set(path) == rows


def _lenet_cfg(tmp_path, **kw):
    base = dict(batch_size=4, num_batches_per_epoch=8, max_epochs=1,
                logdir=str(tmp_path), seed=5, augment=False,
                serve_shadow=True, telemetry=True, metrics_port=0,
                checkpoint_dir=str(tmp_path / "ckpt"), ckpt_every_steps=3,
                ckpt_async=False)
    base.update(kw)
    return make_config("lenet", **base)


def test_trainer_scores_its_own_commits(tmp_path, monkeypatch):
    monkeypatch.setenv("MGWFBP_FAULT_PLAN", "stall@secs=1,step=7")
    t = Trainer(_lenet_cfg(tmp_path), device="cpu", synthetic_data=True,
                profile_backward=False)
    try:
        t.fit(1)
        assert t._serve_plane is not None
        # the boundary commit (step 8) may land after the loop: poll it
        t._serve_plane.poll_now()
        path = t.telemetry.path
    finally:
        t.close()
    assert t._serve_plane is None
    rows = events.read_event_set(path)
    shadow = events.events_of(rows, "shadow_eval")
    assert shadow and {r["step"] for r in shadow} <= {3, 6, 8}
    assert all(np.isfinite(r["loss"]) and "train_loss" in r for r in shadow)
    assert events.events_of(rows, "reload")
    assert jax_events.read_event_set(path) == rows
    for r in rows:
        assert all(k in r for k in jax_events.EVENT_TYPES[r["event"]]), r


def test_serve_shadow_refusals_and_flag(tmp_path):
    t = Trainer(_lenet_cfg(tmp_path, checkpoint_dir=None), device="cpu",
                synthetic_data=True, profile_backward=False)
    try:
        t._start_serve_plane()
        assert t._serve_plane is None  # needs --checkpoint-dir
    finally:
        t.close()
    cfg = train_cli.config_from_args(train_cli.build_parser().parse_args(
        ["--dnn", "lenet", "--serve-shadow"]))
    assert cfg.serve_shadow and cfg.telemetry
