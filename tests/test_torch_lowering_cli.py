"""``train_cli`` with the lowering flags (``--comm-op``, ``--compressor``,
``--density``), on the CPU: ResNet-20 trains at 2 gloo ranks (one process
each) with each of ``--comm-op rs_ag``, ``--comm-op rs_opt_ag``,
``--compressor topk --density 0.01`` and ``--density 0`` (the cost
model's choice, which on this link keeps the dense all-reduce); the ranks
print the same metrics. The combinations the JAX trainer rejects fail with
its message. ``rs_fwd_ag`` trains at 2 ranks and ``hier --dcn-slices 2``
at 4 (2 slices of 2); ``hier`` without ``--dcn-slices`` exits with the JAX
trainer's message.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import pytest

from mgwfbp_tpu.config import make_config as jax_make_config
from mgwfbp_tpu.parallel.mesh import MeshSpec, make_mesh
from mgwfbp_tpu.train.trainer import Trainer as JaxTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = {"MGWFBP_SYNTH_TRAIN_N": "64", "MGWFBP_SYNTH_VAL_N": "32"}


def _two_ranks(tmp_path, *flags, dnn="resnet20", timeout=240, world=2):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", **SYNTH)
    env.pop("MGWFBP_FAULT_PLAN", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "mgwfbp_tpu_torch.train_cli", "--dnn", dnn,
             "--synthetic", "--device", "cpu", "--epochs", "1",
             "--num-batches-per-epoch", "3", "--batch-size", "8",
             "--policy", "wfbp", "--connection", "10GbE",
             "--no-profile-backward", "--logdir", str(tmp_path / f"l{r}"),
             *flags, "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", str(world), "--process-id", str(r)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=str(tmp_path), env=env)
        for r in range(world)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    return outs


@pytest.mark.parametrize("flags,log", [
    (("--comm-op", "rs_ag"), "merge schedule:"),
    (("--comm-op", "rs_opt_ag"),
     "B replicated (2.00x reduction over 2 workers)"),
    (("--compressor", "topk", "--density", "0.01"),
     "gradient compression: topk density=0.01"),
    (("--compressor", "topk", "--density", "0"),
     "auto density: dense all-reduce predicted cheaper"),
])
def test_resnet20_trains_at_two_ranks_with_each_flag(tmp_path, flags, log):
    outs = _two_ranks(tmp_path, *flags)
    docs = []
    for rc, out, err in outs:
        assert rc == 0, err[-3000:]
        assert log in err
        docs.append(json.loads(out.strip().splitlines()[-1]))
    assert docs[0] == docs[1]
    train = docs[0]["train"]
    assert all(v == v for v in train.values())  # finite, no NaN
    assert docs[0]["eval"]["count"] == 32.0  # the shrunk validation split


@pytest.mark.parametrize("op", ["hier", "rs_fwd_ag"])
def test_unported_comm_ops_exit_naming_item_7b(tmp_path, op):
    """The cross-step and two-level lowerings train from the CLI:
    rs_fwd_ag at 2 ranks, hier at 4 as 2 slices of 2 (the ranks print the
    same metrics); hier without --dcn-slices > 1 exits with the JAX
    trainer's message."""
    flags, world, log = {
        "rs_fwd_ag": (("--comm-op", "rs_fwd_ag"), 2,
                      "cross-step pipelining (rs_fwd_ag)"),
        "hier": (("--comm-op", "hier", "--dcn-slices", "2"), 4,
                 "two-level groups: 2 slice(s) of 2 rank(s)"),
    }[op]
    if op == "hier":
        res = subprocess.run(
            [sys.executable, "-m", "mgwfbp_tpu_torch.train_cli", "--dnn",
             "resnet20", "--synthetic", "--device", "cpu", "--comm-op", op],
            capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
            env=dict(os.environ, PYTHONPATH=ROOT))
        assert res.returncode == 2
        assert ("--comm-op hier needs a multi-slice mesh (--dcn-slices > 1) "
                "and no sequence parallelism; got dcn=1, seq=1") in res.stderr
    outs = _two_ranks(tmp_path, *flags, world=world)
    docs = []
    for rc, out, err in outs:
        assert rc == 0, err[-3000:]
        assert log in err
        docs.append(json.loads(out.strip().splitlines()[-1]))
    assert all(d == docs[0] for d in docs)
    assert all(v == v for v in docs[0]["train"].values())
    assert docs[0]["eval"]["count"] == 32.0


def _jax_error(**kw) -> str:
    cfg = jax_make_config("lenet", logdir="", checkpoint_dir="", **kw)
    with pytest.raises(ValueError) as e:
        JaxTrainer(cfg, synthetic_data=True, profile_backward=False,
                   mesh=make_mesh(MeshSpec(data=2),
                                  devices=jax.devices()[:2]))
    return str(e.value)


@pytest.mark.parametrize("flags,kw", [
    (("--comm-op", "rs_opt_ag", "--compressor", "topk", "--density", "0.01"),
     dict(comm_op="rs_opt_ag", compressor="topk", density=0.01)),
    (("--comm-op", "rs_opt_ag", "--policy", "none"),
     dict(comm_op="rs_opt_ag", policy="none")),
])
def test_rejected_combinations_fail_as_in_jax(tmp_path, monkeypatch, flags,
                                              kw):
    for k, v in SYNTH.items():
        monkeypatch.setenv(k, v)
    want = _jax_error(**kw)
    outs = _two_ranks(tmp_path, *flags, dnn="lenet")
    for rc, _, err in outs:
        assert rc != 0
        assert want in err
