"""The port's flight recorder (``telemetry/recorder.py``) against the JAX
package's, and its wiring in the port's trainer.

  * fed one seeded event sequence, the port's and the JAX ``FlightRecorder``
    write the same bundles (the manifests but their walls and paths, the
    ring events, the status and schedule documents), deferring each
    ``postmortem`` record past its trigger's, with the same debounce and
    cap; ``list_bundles`` lists them alike and each package's
    ``read_bundle`` reads the other's;
  * a CPU lenet ``Trainer`` under ``nan@step=2`` writes a bundle that the
    JAX ``read_bundle`` reads (trigger ``bad_step`` at step 2, the ring
    holding the step records before it, the live /status and the
    schedule), its ``postmortem`` record lands in the stream, and
    ``/postmortems`` equals the JAX aggregator's for the same events;
  * ``MGWFBP_POSTMORTEM_PROFILE=1`` arms a /profile window on the trigger,
    and its result lands in the bundle as ``profile.json``;
  * ``MGWFBP_POSTMORTEM=0`` writes no bundle.
"""

import json
import os
import urllib.request

import pytest
import torch

from mgwfbp_tpu.telemetry import events as jax_events
from mgwfbp_tpu.telemetry import recorder as jax_recorder
from mgwfbp_tpu.telemetry.serve import MetricsAggregator as JaxAggregator
from mgwfbp_tpu_torch.config import make_config
from mgwfbp_tpu_torch.telemetry import events, recorder
from mgwfbp_tpu_torch.telemetry.serve import MetricsAggregator
from mgwfbp_tpu_torch.train import Trainer

from test_torch_metrics import seeded_events


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _feed(mod, agg_cls, directory, seq) -> tuple:
    """A writer teed into an aggregator and a recorder, as the trainer
    wires them; returns (recorder, stream path, aggregator)."""
    path = os.path.join(directory, "telemetry.jsonl")
    w = mod[0].EventWriter(path, run={"model": "lenet"})
    agg = agg_cls()
    agg.enable_profile()
    rec = mod[1].FlightRecorder(
        directory, ring_size=16, debounce_s=0.0, max_bundles=4,
        status_provider=lambda: {"step": 7},
        schedule_provider=lambda: {"iteration": 7, "schedule": None},
        event_sink=w.emit)
    w.observer = mod[1].tee_observers(agg.observe, rec.observe)
    for ev, fields in seq:
        w.emit(ev, **fields)
    rec.flush_events()
    w.close()
    return rec, path, agg


def _strip(manifest: dict) -> dict:
    out = {k: v for k, v in manifest.items() if k not in ("wall", "path")}
    out["trigger_record"] = {k: v for k, v in out["trigger_record"].items()
                             if k != "wall"}
    return out


def _bundle_view(doc: dict) -> dict:
    return {
        "manifest": _strip(doc["manifest"]),
        "status": doc["status"], "schedule": doc["schedule"],
        "events": [{k: v for k, v in r.items() if k not in ("wall", "path")}
                   for r in doc["events"]],
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_recorders_write_the_same_bundles(seed, tmp_path):
    seq = [e for e in seeded_events(seed, n=80)[1:]
           if e[0] not in ("postmortem", "watchdog_stall")]
    ours, our_path, our_agg = _feed((events, recorder), MetricsAggregator,
                                    str(tmp_path / "port"), seq)
    theirs, their_path, their_agg = _feed(
        (jax_events, jax_recorder), JaxAggregator, str(tmp_path / "jax"),
        seq)
    assert ours.suppressed == theirs.suppressed
    assert [_strip(b) for b in ours.bundles()] == [
        _strip(b) for b in theirs.bundles()]
    assert ours.bundles(), "the sequence triggers at least one bundle"
    mine = recorder.list_bundles(str(tmp_path / "port"))
    jax_listed = jax_recorder.list_bundles(str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in mine] == [
        os.path.basename(p) for p in jax_listed]
    assert recorder.list_bundles(str(tmp_path / "port")) == (
        jax_recorder.list_bundles(str(tmp_path / "port")))
    for a, b in zip(mine, jax_listed):
        # each package reads the other's bundle as its own
        assert _bundle_view(jax_recorder.read_bundle(a)) == _bundle_view(
            recorder.read_bundle(a))
        assert _bundle_view(recorder.read_bundle(b)) == _bundle_view(
            recorder.read_bundle(a))
    # the postmortem records land after their triggers, in both streams
    strip = [{k: v for k, v in r.items() if k not in ("wall", "path")}
             for r in events.read_events(our_path)]
    assert strip == [{k: v for k, v in r.items() if k not in ("wall", "path")}
                     for r in jax_events.read_events(their_path)]
    pm = our_agg.postmortems()
    want = their_agg.postmortems()
    assert pm["total"] == want["total"] == len(ours.bundles())


def test_suffix_and_continued_sequence_match(tmp_path):
    for mod in (recorder, jax_recorder):
        d = str(tmp_path / mod.__name__)
        for _ in range(2):  # a relaunch continues the sequence
            r = mod.FlightRecorder(d, debounce_s=0.0, suffix=".p1")
            r.observe("bad_step", {"step": 3, "epoch": 0, "nonfinite": 1.0})
    names = sorted(os.listdir(tmp_path / recorder.__name__ / "postmortems"))
    assert names == ["0000.p1", "0001.p1"] == sorted(os.listdir(
        tmp_path / jax_recorder.__name__ / "postmortems"))


def _lenet_cfg(tmp_path, **kw):
    base = dict(batch_size=4, num_batches_per_epoch=6, max_epochs=1,
                logdir=str(tmp_path), checkpoint_dir=None, seed=5,
                augment=False, metrics_port=0)
    base.update(kw)
    return make_config("lenet", **base)


def _get(port: int, path: str) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.read().decode()


def test_trainer_bundle_reads_in_jax_and_postmortems_match(
        tmp_path, monkeypatch):
    monkeypatch.setenv("MGWFBP_FAULT_PLAN", "nan@step=2")
    monkeypatch.setenv("MGWFBP_POSTMORTEM_PROFILE", "1")
    monkeypatch.setenv("MGWFBP_POSTMORTEM_PROFILE_STEPS", "2")
    t = Trainer(_lenet_cfg(tmp_path), device="cpu", synthetic_data=True,
                profile_backward=False)
    try:
        t.fit(1)
        port = t._metrics_server.port
        live = json.loads(_get(port, "/postmortems"))
        tag_dir = os.path.join(str(tmp_path), t.config.tag())
        path = t.telemetry.path
    finally:
        t.close()
    bundles = recorder.list_bundles(tag_dir)
    assert bundles == jax_recorder.list_bundles(tag_dir)
    assert len(bundles) == 1
    doc = jax_recorder.read_bundle(bundles[0])
    assert doc["manifest"]["trigger"] == "bad_step"
    assert doc["manifest"]["step"] == 2
    # the guard reads step 2's flag one step late, after step 3 was
    # launched (the JAX trainer's late read): the ring holds step 3's span
    assert [r["step"] for r in doc["events"] if r["event"] == "step"] == [
        1, 2, 3]
    assert doc["status"]["run"]["model"] == "lenet"
    assert doc["schedule"]["iteration"] == 3
    # the trigger armed a window; its result is in the bundle
    assert doc["profile"]["attribution"] == "none"
    assert doc["profile"]["steps"] == 2
    assert doc == json.loads(json.dumps(recorder.read_bundle(bundles[0])))
    rows = events.read_event_set(path)
    pms = events.events_of(rows, "postmortem")
    assert [(r["trigger"], r["step"]) for r in pms] == [("bad_step", 2)]
    assert events.events_of(rows, "profile")[0]["steps"] == 2
    jagg = JaxAggregator()
    for r in jax_events.read_event_set(path):
        jagg.observe(r["event"], {k: v for k, v in r.items()
                                  if k not in ("event", "wall")})
    assert live == jagg.postmortems()
    assert live["recent"][0]["path"] == bundles[0]


def test_a_late_read_bad_steps_bundle_is_listed_at_its_drain(
        tmp_path, monkeypatch):
    """The guard reads step 2's flag late, in the drain of step 3's queue;
    the bundle's ``postmortem`` record goes out at the end of that drain,
    so the live /postmortems lists it while the loop goes on (a stall
    before the next record would otherwise hide it)."""
    monkeypatch.setenv("MGWFBP_FAULT_PLAN", "nan@step=2")
    t = Trainer(_lenet_cfg(tmp_path), device="cpu", synthetic_data=True,
                profile_backward=False)
    seen = []
    drain = t._drain_items

    def spy(items):
        drain(items)
        seen.append(([it for it, *_ in items],
                     t._metrics_agg.postmortems()["total"]))

    monkeypatch.setattr(t, "_drain_items", spy)
    try:
        t.fit(1)
    finally:
        t.close()
    (at,) = [total for steps, total in seen if 2 in steps]
    assert at == 1


def test_postmortem_off_writes_no_bundle(tmp_path, monkeypatch):
    monkeypatch.setenv("MGWFBP_FAULT_PLAN", "nan@step=2")
    monkeypatch.setenv("MGWFBP_POSTMORTEM", "0")
    t = Trainer(_lenet_cfg(tmp_path, metrics_port=None, telemetry=True),
                device="cpu", synthetic_data=True, profile_backward=False)
    try:
        assert t._recorder is None
        t.fit(1)
        rows = events.read_event_set(t.telemetry.path)
    finally:
        t.close()
    assert events.events_of(rows, "bad_step")
    assert not events.events_of(rows, "postmortem")
    assert recorder.list_bundles(os.path.join(str(tmp_path),
                                              t.config.tag())) == []
