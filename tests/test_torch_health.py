"""The port's in-step health statistics (``TrainStep(health_stats=True)``),
its health detector (``telemetry/health.py``) and their wiring in the
trainer, held against the JAX package.

  * ``health/grad_norm`` and ``health/update_ratio`` of two port steps
    equal ``make_train_step(health_stats=True)``'s on a one-device JAX mesh
    for lenet and a narrow ResNet-20 (depth 20, widths 4/8/16) at one
    worker, both in float64 (the JAX side in a subprocess with x64 on: the
    JAX package's float32 CPU gradients are the inexact side, ROADMAP
    Queue 3). Tolerance rtol 1e-5: each side accumulates the norms in
    float32, and the port's loss is taken in float32 (``cross_entropy``),
    so the two agree to float32 rounding, not to float64's;
  * with a reducer (a one-rank gloo group, the threshold policy at 2000
    elements: several merge groups), the port's global norm, the per-group
    norms in the reducer's arrival permutation and the update ratio equal
    the JAX step's own ``_health_stat_entries`` on the same gradients and
    parameters (rtol 1e-6);
  * ``HealthDetector`` gives the JAX detector's alarm edges on seeded loss
    and norm series, and ``HealthConfig.from_env`` the same thresholds;
  * the statistics add no host read: a counting patch on ``Tensor.item``,
    ``tolist`` and ``cpu`` sees the same reads per step with them on and
    off (one: the metrics read-back, which carries the previous step's);
  * a CPU lenet ``Trainer`` writes one ``health`` record per step, one step
    late and in order, a NaN fault raises a ``health_alarm`` and a
    postmortem, the JAX reader and schema accept the stream, and
    ``--no-health-stats`` turns it all off.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mgwfbp_tpu.parallel.allreduce import make_merged_allreduce as jax_reducer
from mgwfbp_tpu.parallel.costmodel import lookup_alpha_beta as jax_lookup
from mgwfbp_tpu.telemetry import events as jax_events
from mgwfbp_tpu.telemetry import health as jax_health
from mgwfbp_tpu.train.step import _health_stat_entries
from mgwfbp_tpu_torch import models, train_cli
from mgwfbp_tpu_torch.config import make_config
from mgwfbp_tpu_torch.convert import (
    flatten_flax,
    flax_leaves,
    variables_to_flax,
)
from mgwfbp_tpu_torch.models.common import init_weights
from mgwfbp_tpu_torch.models.resnet_cifar import CifarResNet
from mgwfbp_tpu_torch.optim import make_optimizer
from mgwfbp_tpu_torch.parallel.allreduce import make_merged_allreduce
from mgwfbp_tpu_torch.parallel.costmodel import lookup_alpha_beta
from mgwfbp_tpu_torch.telemetry import events, health
from mgwfbp_tpu_torch.train import Trainer, TrainStep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(depth=20, widths=(4, 8, 16))
OPT = dict(lr=0.05, momentum=0.9, weight_decay=1e-4, lr_schedule="const",
           max_epochs=10, num_batches_per_epoch=4)
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _model(name: str) -> torch.nn.Module:
    m = (CifarResNet(**NARROW) if name == "resnet20n"
         else models.create_model(name)[0])
    return init_weights(m, torch.Generator().manual_seed(3))


def _batches(name: str, steps: int = 2, b: int = 4):
    """(steps, 1, b, H, W, C) NHWC images and (steps, 1, b) labels."""
    hw, c = ((32, 3) if name == "resnet20n" else (28, 1))
    rng = np.random.RandomState(7)
    x = rng.randn(steps, 1, b, hw, hw, c).astype(np.float64)
    y = rng.randint(0, 10, (steps, 1, b)).astype(np.int32)
    return x, y


_JAX_HEALTH = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from mgwfbp_tpu.models import ModelMeta, create_model
from mgwfbp_tpu.models.resnet_cifar import CifarResNet
from mgwfbp_tpu.optim import make_optimizer
from mgwfbp_tpu.parallel.mesh import MeshSpec, make_mesh
from mgwfbp_tpu.train.step import TrainState, make_train_step
name, src, opt = sys.argv[1], np.load(sys.argv[2]), json.loads(sys.argv[3])
def nest(prefix):
    out = {}
    for k in src.files:
        if not k.startswith(prefix):
            continue
        *mods, leaf = k[len(prefix):].split(".")
        node = out
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = src[k].astype(np.float64)
    return out
if name == "resnet20n":
    jm = CifarResNet(depth=20, widths=(4, 8, 16))
    meta = ModelMeta("resnet20", "cifar10", 10, (32, 32, 3))
else:
    jm, meta = create_model(name)
tx, _ = make_optimizer(opt["lr"], momentum=opt["momentum"],
                       weight_decay=opt["weight_decay"],
                       lr_schedule=opt["lr_schedule"], dataset=meta.dataset,
                       max_epochs=opt["max_epochs"],
                       num_batches_per_epoch=opt["num_batches_per_epoch"])
mesh = make_mesh(MeshSpec(data=1), devices=jax.devices()[:1])
step = make_train_step(jm, meta, tx, mesh, None, donate=False,
                       health_stats=True)
params = nest("params/")
state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                   batch_stats=nest("bstats/"), opt_state=tx.init(params),
                   rng=jax.random.PRNGKey(0))
out = []
for k in range(src["x"].shape[0]):
    state, m = step(state, {"x": src["x"][k], "y": src["y"][k]})
    out.append({key: float(v) for key, v in m.items()})
print(json.dumps(out))
"""


@pytest.mark.parametrize("name", ["lenet", "resnet20n"])
def test_health_values_match_jax_step_in_float64(name, tmp_path):
    model = _model(name)
    params, bstats = variables_to_flax(model)
    x, y = _batches(name)
    arrays = {f"params/{k}": v for k, v in flatten_flax(params).items()}
    arrays.update({f"bstats/{k}": v for k, v in flatten_flax(bstats).items()})
    np.savez(tmp_path / "in.npz", x=x, y=y, **arrays)
    res = subprocess.run(
        [sys.executable, "-c", _JAX_HEALTH, name, str(tmp_path / "in.npz"),
         json.dumps(OPT)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu"),
    )
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])

    model = model.double()
    opt, lr_fn, _ = make_optimizer(
        model.parameters(), OPT["lr"], momentum=OPT["momentum"],
        weight_decay=OPT["weight_decay"], lr_schedule=OPT["lr_schedule"],
        dataset="mnist" if name == "lenet" else "cifar10",
        max_epochs=OPT["max_epochs"],
        num_batches_per_epoch=OPT["num_batches_per_epoch"])
    step = TrainStep(model, opt, lr_fn, health_stats=True)
    assert step.health_keys == ["health/grad_norm", "health/update_ratio"]
    got = []
    for k in range(x.shape[0]):
        xt = torch.from_numpy(x[k]).permute(0, 1, 4, 2, 3).contiguous()
        m = step(xt, torch.from_numpy(y[k]).long())
        # each step's statistics come with its own metrics, as the JAX
        # step's do
        got.append({key: float(v) for key, v in m.items()
                    if key.startswith("health/")})
        np.testing.assert_allclose(float(m["loss"]), want[k]["loss"],
                                   rtol=RTOL)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert set(g) == {key for key in w if key.startswith("health/")}
        for key, v in g.items():
            np.testing.assert_allclose(v, w[key], rtol=RTOL,
                                       err_msg=f"step {k + 1} {key}")


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _tree(flat: dict) -> dict:
    out: dict = {}
    for path, a in flat.items():
        *mods, leaf = path.split(".")
        node = out
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = a
    return out


def test_group_norms_follow_the_arrival_permutation(one_rank_group):
    model = _model("resnet20n")
    reducer = make_merged_allreduce(
        model, policy="threshold", threshold=2000,
        cost_model=lookup_alpha_beta("10GbE", 16))
    try:
        shapes = _tree({k: np.zeros(v.shape, np.float32)
                        for k, v in flatten_flax(
                            variables_to_flax(model)[0]).items()})
        want_red = jax_reducer(shapes, axis_name="data", policy="threshold",
                               threshold=2000,
                               cost_model=jax_lookup("10GbE", 16))
        assert reducer.perm == want_red.perm
        assert reducer.layout.groups == want_red.layout.groups
        assert 1 < reducer.num_groups < 65
        opt, lr_fn, _ = make_optimizer(
            model.parameters(), OPT["lr"], momentum=0.9, weight_decay=1e-4,
            lr_schedule="const", dataset="cifar10", max_epochs=10,
            num_batches_per_epoch=4)
        step = TrainStep(model, opt, lr_fn, reducer=reducer,
                         health_stats=True)
        old = variables_to_flax(model)[0]
        captured = {}

        def keep_grads():
            captured.update({path: p.grad.detach().clone()
                             for path, p in flax_leaves(model)})

        real_sync = reducer.synchronize

        def sync():
            out = real_sync()
            keep_grads()
            return out

        reducer.synchronize = sync
        x, y = _batches("resnet20n", steps=1)
        m = step(torch.from_numpy(x[0]).float().permute(0, 1, 4, 2, 3)
                 .contiguous(), torch.from_numpy(y[0]).long())
        got = {k: float(v) for k, v in m.items() if k.startswith("health/")}
        new = variables_to_flax(model)[0]
        # the port's gradients and parameters in the JAX step's function
        rules = {"kernel": lambda g: g.permute(2, 3, 1, 0) if g.dim() == 4
                 else g.t()}
        grads = _tree({
            path: rules.get(path.rsplit(".", 1)[-1], lambda g: g)(g).numpy()
            for path, g in captured.items()})
        want = {k: float(v) for k, v in _health_stat_entries(
            grads, want_red, old, new).items()}
        assert list(got) == step.health_keys
        assert set(got) == set(want)
        assert len([k for k in got if "gnorm_g" in k]) == reducer.num_groups
        for key, v in got.items():
            np.testing.assert_allclose(v, want[key], rtol=1e-6, err_msg=key)
    finally:
        reducer.detach()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_health_detector_edges_match(seed):
    rng = np.random.default_rng(seed)
    kw = dict(spike_band=1.5, explosion_band=4.0, plateau_window=15,
              plateau_delta=1e-3, baseline_window=5, ewma_alpha=0.2,
              hysteresis=2)
    ours = health.HealthDetector(health.HealthConfig(**kw))
    theirs = jax_health.HealthDetector(jax_health.HealthConfig(**kw))
    got, want = [], []
    loss = 2.5
    for i in range(150):
        loss *= float(rng.uniform(0.97, 1.0)) if i < 60 else 1.0
        spike = 4.0 if 70 <= i < 74 else 1.0
        norm = float(rng.uniform(1.0, 1.5)) * (8.0 if 90 <= i < 95 else 1.0)
        value = float("nan") if i == 110 else loss * spike
        got += [dataclasses.asdict(a) for a in
                ours.observe(loss=value, grad_norm=norm)]
        want += [dataclasses.asdict(a) for a in
                 theirs.observe(loss=value, grad_norm=norm)]
    got += [dataclasses.asdict(a) for a in ours.clear_alarms()]
    want += [dataclasses.asdict(a) for a in theirs.clear_alarms()]
    assert json.dumps(got) == json.dumps(want)  # NaN values compare as text
    kinds = {(a["kind"], a["active"]) for a in got}
    assert {("loss_spike", True), ("grad_explosion", True),
            ("plateau", True)} <= kinds


def test_health_config_from_env_matches(monkeypatch):
    for name, value in (
        ("MGWFBP_HEALTH_SPIKE_BAND", "3"),
        ("MGWFBP_HEALTH_EXPLOSION_BAND", "7"),
        ("MGWFBP_HEALTH_PLATEAU_WINDOW", "50"),
        ("MGWFBP_HEALTH_PLATEAU_DELTA", "0.01"),
        ("MGWFBP_HEALTH_WINDOW", "4"), ("MGWFBP_HEALTH_EWMA_ALPHA", "0.3"),
        ("MGWFBP_HEALTH_HYSTERESIS", "1"),
        ("MGWFBP_HEALTH_COMPRESSION_BAND", "2"),
    ):
        monkeypatch.setenv(name, value)
    assert dataclasses.asdict(health.HealthConfig.from_env()) == (
        dataclasses.asdict(jax_health.HealthConfig.from_env()))
    monkeypatch.setenv("MGWFBP_HEALTH", "0")
    assert not health.health_enabled() and not jax_health.health_enabled()


def _count_host_reads(monkeypatch) -> dict:
    counts = {"item": 0, "tolist": 0, "cpu": 0}
    for name in counts:
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _real=real, _name=name, **kw):
            counts[_name] += 1
            return _real(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, counted)
    return counts


@pytest.mark.parametrize("on", [False, True])
def test_health_adds_no_host_read_per_step(on, monkeypatch):
    model = _model("lenet")
    opt, lr_fn, _ = make_optimizer(model.parameters(), 0.05, momentum=0.9,
                                   lr_schedule="const", dataset="mnist",
                                   max_epochs=10, num_batches_per_epoch=4)
    step = TrainStep(model, opt, lr_fn, health_stats=on)
    x, y = _batches("lenet", steps=5)
    xs = torch.from_numpy(x).float().permute(0, 1, 2, 5, 3, 4).contiguous()
    ys = torch.from_numpy(y).long()
    step(xs[0], ys[0])  # the first step allocates the snapshot
    counts = _count_host_reads(monkeypatch)
    for k in range(1, 5):
        m = step(xs[k], ys[k])
        assert bool([key for key in m if key.startswith("health/")]) == on
    # the step reads nothing back, with the statistics or without
    assert counts == {"item": 0, "tolist": 0, "cpu": 0}


def _lenet_cfg(tmp_path, **kw):
    base = dict(batch_size=4, num_batches_per_epoch=8, max_epochs=1,
                logdir=str(tmp_path), checkpoint_dir=None, seed=5,
                augment=False, telemetry=True)
    base.update(kw)
    return make_config("lenet", **base)


def test_trainer_streams_health_and_alarms_on_a_nan(tmp_path, monkeypatch):
    monkeypatch.setenv("MGWFBP_FAULT_PLAN", "nan@step=5,count=2")
    monkeypatch.setenv("MGWFBP_HEALTH_WINDOW", "2")
    t = Trainer(_lenet_cfg(tmp_path), device="cpu", synthetic_data=True,
                profile_backward=False)
    try:
        t.fit(1)
        path = t.telemetry.path
    finally:
        t.close()
    rows = events.read_event_set(path)
    recs = events.events_of(rows, "health")
    assert [r["step"] for r in recs] == list(range(1, 9))
    assert len(events.events_of(rows, "step")) == 8
    assert all("group_norms" not in r for r in recs)  # one worker: no groups
    assert all(np.isnan(r["grad_norm"]) for r in recs[4:6])
    assert all(np.isnan(r["update_ratio"]) for r in recs[4:6])
    assert all(np.isfinite(r["grad_norm"]) and r["update_ratio"] > 0
               for r in recs[:4] + recs[6:])
    alarms = events.events_of(rows, "health_alarm")
    assert alarms and alarms[0]["active"] and alarms[0]["step"] == 6
    assert {r["trigger"] for r in events.events_of(rows, "postmortem")} >= {
        "bad_step"}
    assert jax_events.read_event_set(path) == json.loads(json.dumps(rows))
    for r in rows:
        assert all(k in r for k in jax_events.EVENT_TYPES[r["event"]]), r


def test_no_health_stats_flag_turns_the_statistics_off(tmp_path):
    args = train_cli.build_parser().parse_args(
        ["--dnn", "lenet", "--no-health-stats", "--telemetry"])
    cfg = train_cli.config_from_args(args)
    assert cfg.health_stats is False and cfg.telemetry
    assert train_cli.config_from_args(train_cli.build_parser().parse_args(
        ["--dnn", "lenet"])).health_stats is True
    t = Trainer(_lenet_cfg(tmp_path, health_stats=False), device="cpu",
                synthetic_data=True, profile_backward=False)
    try:
        assert not t.train_step.health_stats
        t.fit(1)
        rows = events.read_event_set(t.telemetry.path)
    finally:
        t.close()
    assert not events.events_of(rows, "health")
    # telemetry off: no statistics either, whatever health_stats says
    t = Trainer(_lenet_cfg(tmp_path, telemetry=False), device="cpu",
                synthetic_data=True, profile_backward=False)
    try:
        assert not t.train_step.health_stats
    finally:
        t.close()
