"""Port vs reference: the telemetry event stream and the trainer's records
(mgwfbp_tpu_torch.telemetry.events / train vs mgwfbp_tpu.telemetry.events).

  * the port's schema, file names and reader are the JAX package's: each
    package reads the other's stream (rotated or not) to equal records;
  * ``EventWriter.emit`` rejects a ``torch.Tensor`` field with TypeError,
    and unknown events or missing fields with ValueError;
  * two gloo processes of ``train_cli --telemetry --comm-profile`` (a
    family profile, ``MGWFBP_TELEMETRY_TRACE=1``) write one stream per
    rank that the JAX ``read_events`` accepts and ``tools/
    telemetry_report.py`` renders, with per epoch one ``epoch``, one
    ``overlap`` and ``num_groups`` ``comm_group`` records on the cost
    model (a CPU trace attributes no device time); both ranks resolve the
    same model and write the same accounting; ``tb_profile.json`` loads in
    the JAX ``load_layer_profile``;
  * a one-worker trainer writes step spans and epoch records and no
    overlap (no reducer, no communication);
  * a startup trace (``MGWFBP_TELEMETRY_TRACE=1``) that raises is logged
    with the JAX trainer's wording and training goes on, on the cost
    model.
"""

import importlib.util
import logging
import os
import types
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mgwfbp_tpu.profiling import load_layer_profile as jax_load_layer_profile
from mgwfbp_tpu.telemetry import events as jev
from mgwfbp_tpu_torch.config import make_config
from mgwfbp_tpu_torch.parallel.costmodel import (
    AlphaBeta,
    ProfileFamily,
    save_profile,
)
from mgwfbp_tpu_torch.telemetry import events as tev
from mgwfbp_tpu_torch.train import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _fill(writer) -> None:
    writer.emit("step", step=1, epoch=0, start_s=0.5, dur_s=0.01)
    writer.emit("epoch", epoch=0, steps=1, dur_s=0.02)
    writer.emit("overlap", step=1, epoch=0, step_s=0.02, tb_total_s=0.01,
                comm_s=0.003, hidden_s=0.002, exposed_s=0.001,
                efficiency=2 / 3, attribution="cost-model", num_groups=1)
    writer.emit("comm_group", step=1, group=0, nbytes=1024, comm_s=0.003,
                start_s=0.008, hidden_s=0.002, exposed_s=0.001,
                attribution="cost-model")


def test_schema_and_names_are_the_jax_packages(tmp_path):
    assert tev.EVENT_SCHEMA_VERSION == jev.EVENT_SCHEMA_VERSION
    assert tev.EVENT_TYPES == jev.EVENT_TYPES
    for idx, count in ((0, 1), (0, 2), (3, 4)):
        assert tev.stream_filename(idx, count) == jev.stream_filename(idx, count)
    for name in ("telemetry.jsonl", "telemetry.p0.jsonl", "telemetry.p1.jsonl",
                 "telemetry.p1.jsonl.0000", "other.jsonl"):
        (tmp_path / name).write_text("")
    assert tev.find_stream_paths(str(tmp_path)) == jev.find_stream_paths(
        str(tmp_path))


@pytest.mark.parametrize("writer_pkg", ["port", "jax"])
def test_each_package_reads_the_others_stream(tmp_path, writer_pkg):
    path = str(tmp_path / "telemetry.jsonl")
    w = (tev if writer_pkg == "port" else jev).EventWriter(
        path, run={"model": "resnet20"})
    _fill(w)
    w.close()
    ours, theirs = tev.read_events(path), jev.read_events(path)
    assert ours == theirs and len(ours) == 5
    assert ours[0]["schema_version"] == 2 and ours[0]["run"]["model"] == "resnet20"
    assert [r["event"] for r in tev.events_of(ours, "overlap", "comm_group")] \
        == ["overlap", "comm_group"]


def test_a_reopened_port_stream_keeps_one_header(tmp_path):
    path = str(tmp_path / "telemetry.jsonl")
    w = tev.EventWriter(path, run={"model": "resnet20"})
    _fill(w)
    w.close()
    w = tev.EventWriter(path, run={"model": "ignored"})
    assert w._run == {"model": "resnet20"} and w.now() >= 0.0
    _fill(w)
    w.close()
    ours, theirs = tev.read_events(path), jev.read_events(path)
    assert ours == theirs
    assert len(tev.events_of(ours, "header")) == 1
    assert len(tev.events_of(ours, "comm_group")) == 2


def test_emit_rejects_tensors_and_unknown_records(tmp_path):
    w = tev.EventWriter(str(tmp_path / "telemetry.jsonl"))
    try:
        with pytest.raises(TypeError, match="Tensor"):
            w.emit("step", step=1, epoch=0, start_s=0.0,
                   dur_s=torch.tensor(0.5))
        with pytest.raises(TypeError, match="Tensor"):
            w.emit("epoch", epoch=0, steps=1, dur_s=0.1,
                   extra=[1.0, {"x": torch.ones(2)}])
        with pytest.raises(ValueError, match="unknown telemetry event"):
            w.emit("no_such_event")
        with pytest.raises(ValueError, match="missing required"):
            w.emit("step", step=1)
    finally:
        w.close()


def test_one_worker_writes_spans_and_no_overlap(tmp_path):
    cfg = make_config("resnet20", batch_size=4, num_batches_per_epoch=2,
                      logdir=str(tmp_path), telemetry=True)
    tr = Trainer(cfg, device="cpu", synthetic_data=True)
    try:
        tr.train_epoch(0)
    finally:
        tr.close()
    (path,) = jev.find_stream_paths(os.path.join(str(tmp_path), cfg.tag()))
    assert os.path.basename(path) == "telemetry.jsonl"
    recs = jev.read_events(path)
    steps = jev.events_of(recs, "step")
    assert [r["step"] for r in steps] == [1, 2]
    assert all(r["dur_s"] > 0 for r in steps)
    assert jev.events_of(recs, "epoch")[0]["steps"] == 2
    assert not jev.events_of(recs, "overlap", "comm_group")


def test_a_failing_startup_trace_leaves_training_running(tmp_path,
                                                         monkeypatch):
    from mgwfbp_tpu_torch.train import trainer as trainer_mod

    def boom(*args, **kwargs):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(trainer_mod, "trace_group_times", boom)
    monkeypatch.setenv("MGWFBP_TELEMETRY_TRACE", "1")
    cfg = make_config("resnet20", batch_size=4, num_batches_per_epoch=2,
                      logdir=str(tmp_path), telemetry=True)
    tr = Trainer(cfg, device="cpu", synthetic_data=True)
    lines: list[str] = []
    handler = logging.Handler()
    handler.emit = lambda rec: lines.append(rec.getMessage())
    tr.log.addHandler(handler)
    try:
        # one worker builds no reducer; a stand-in makes fit trace
        tr.reducer = types.SimpleNamespace(num_groups=1, detach=lambda: None)
        metrics = tr.fit(1)
    finally:
        tr.log.removeHandler(handler)
        tr.close()
    assert "telemetry group trace failed (profiler unavailable)" in lines
    assert tr._measured_group_times is None
    assert len(tr.losses) == 2 and tr.iteration == 2
    assert np.isfinite(metrics["train"]["loss"])


def _report_module():
    spec = importlib.util.spec_from_file_location(
        "telemetry_report", os.path.join(ROOT, "tools", "telemetry_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_two_process_cli_writes_the_overlap_stream(tmp_path):
    profile = str(tmp_path / "family.json")
    save_profile(profile, ProfileFamily(entries={
        1: AlphaBeta(alpha=1e-5, beta=1e-10, gamma=2e-6, overlap=0.5,
                     pack_beta=1e-11),
        4: AlphaBeta(alpha=3e-5, beta=2e-10, gamma=2e-6, overlap=0.5,
                     pack_beta=1e-11),
    }), meta={"device_kind": "test"})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    logdir = tmp_path / "logs"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               MGWFBP_TELEMETRY_TRACE="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "mgwfbp_tpu_torch.train_cli", "--dnn",
             "resnet20", "--synthetic", "--device", "cpu", "--epochs", "2",
             "--num-batches-per-epoch", "2", "--batch-size", "8",
             "--policy", "mgwfbp", "--comm-profile", profile, "--telemetry",
             "--logdir", str(logdir), "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(r)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=str(tmp_path), env=env,
        )
        for r in range(2)
    ]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    # both ranks resolve the same model from the family (world 2 lies
    # between its entries) and find no device time to trace on the CPU
    resolved = [
        [ln.split("cost model: ", 1)[1] for ln in e.splitlines()
         if "cost model: " in ln] for e in errs
    ]
    assert resolved[0] == resolved[1] and len(resolved[0]) == 1
    assert "resolved at world 2" in resolved[0][0]
    for e in errs:
        assert "telemetry trace: no device time" in e
    (tag,) = os.listdir(logdir)
    run_dir = logdir / tag
    paths = jev.find_stream_paths(str(run_dir))
    assert [os.path.basename(p) for p in paths] == [
        "telemetry.p0.jsonl", "telemetry.p1.jsonl"]
    per_rank = []
    for path in paths:
        recs = jev.read_events(path)
        epochs = jev.events_of(recs, "epoch")
        overlaps = jev.events_of(recs, "overlap")
        groups = jev.events_of(recs, "comm_group")
        assert [r["epoch"] for r in epochs] == [0, 1]
        assert [r["epoch"] for r in overlaps] == [0, 1]
        g = overlaps[0]["num_groups"]
        assert 1 <= g <= 65 and len(groups) == 2 * g
        assert all(r["attribution"] == "cost-model" for r in overlaps + groups)
        assert [r["group"] for r in groups] == list(range(g)) * 2
        for o in overlaps:
            assert o["comm_s"] == pytest.approx(o["hidden_s"] + o["exposed_s"])
            assert 0.0 <= o["efficiency"] <= 1.0
        # the two traced steps come first, then the epochs' steps
        assert [r["step"] for r in jev.events_of(recs, "step")] == [3, 4, 5, 6]
        per_rank.append([{k: v for k, v in r.items() if k not in (
            "wall", "step_s")} for r in overlaps + groups])
        report = _report_module().format_report(recs)
        assert "efficiency" in report and "cost-model" in report
    assert per_rank[0] == per_rank[1]
    doc = jax_load_layer_profile(str(run_dir / "tb_profile.json"))
    assert doc["schema_version"] == 2 and doc["source"] == "hooks"
    assert len(doc["tb_s"]) == 65 and np.isfinite(doc["tb_s"]).all()
    # the comm bytes of the accounting are the model's: 65 leaves of float32
    total = sum(r["nbytes"] for r in jev.events_of(
        jev.read_events(paths[0]), "comm_group")) // 2
    assert total == 4 * 272_474
