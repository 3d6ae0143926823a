"""Port vs reference: the calibrated cost model and the calibrate CLI
(mgwfbp_tpu_torch.parallel.costmodel / solver / profiling / calibrate vs
their mgwfbp_tpu counterparts).

  * ``fit_alpha_beta``, ``ProfileFamily.at`` (exact, interpolated and
    extrapolated extents), ``resolve_profile`` and
    ``committed_profile_or_prior`` equal the JAX functions within 1e-12 on
    seeded samples; the JAX package's committed profiles load in the port
    with equal fields, and a family the port writes loads and resolves
    equal in the JAX package; a JAX two-level profile loads in the port
    with equal predictions (tests/test_torch_two_level.py holds the rest);
  * ``effective_cost_fn`` equals the JAX function for every lowering;
  * the row-to-group trace arithmetic equals ``_group_times_from_scopes``,
    the None for a missing group included, and a group is charged only
    when its range holds a collective kernel (copies alone give None);
  * the CLI, as tests/test_calibrate_cli.py holds the JAX one: usage
    errors, a clean exit for --world-sizes beyond the world, a sampled
    profile from the default mode, a family over two gloo processes,
    --prior-extend's measured and prior fields, --two-level's usage
    errors (its run is in tests/test_torch_two_level.py), and
    --forward's schema-2 layer profile read by the JAX reader, for
    ResNet-20 and for the full-width PTB LSTM at batch 1 (integer tokens,
    a zero carry); --forward for a model still to port names it and the
    ROADMAP.md queue.

Sweeps are tiny (payloads of 2^8..2^10 elements, 2 timed calls).
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgwfbp_tpu.models import create_model as jax_create_model
from mgwfbp_tpu.parallel import costmodel as jcm
from mgwfbp_tpu.parallel.allreduce import arrival_order as jax_arrival_order
from mgwfbp_tpu.parallel.solver import effective_cost_fn as jax_effective_cost
from mgwfbp_tpu.profiling import _group_times_from_scopes
from mgwfbp_tpu.profiling import load_layer_profile as jax_load_layer_profile
from mgwfbp_tpu_torch import calibrate
from mgwfbp_tpu_torch.parallel import costmodel as tcm
from mgwfbp_tpu_torch.parallel.solver import effective_cost_fn
from mgwfbp_tpu_torch.profiling import (
    collective_group_times,
    group_times_from_rows,
    is_collective_kernel,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-12
TINY = ["--min-log2", "8", "--max-log2", "10", "--iters", "2", "--warmup", "1",
        "--device", "cpu"]
FIELDS = ("alpha", "beta", "gamma", "overlap", "pack_beta", "update_beta",
          "ag_fraction")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs beside other test workers: two intra-op threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _samples(seed: int, n: int = 8):
    rs = np.random.RandomState(seed)
    sizes = np.sort(rs.uniform(1e3, 1e8, n))
    return sizes.tolist(), rs.uniform(1e-6, 1e-3, n).tolist(), rs


def _close(a, b) -> None:
    for f in FIELDS:
        assert abs(getattr(a, f) - getattr(b, f)) <= TOL, f


# -- cost model ---------------------------------------------------------


@pytest.mark.parametrize("case", ["noisy", "linear", "falling", "origin"])
def test_fit_alpha_beta_equals_jax(case):
    sizes, times, rs = _samples(len(case))
    if case == "linear":
        times = [2e-5 + 3e-10 * s + rs.normal(0, 1e-7) for s in sizes]
    elif case == "falling":  # negative slope: the constant model
        times = sorted(times, reverse=True)
    elif case == "origin":  # negative intercept: refit through the origin
        times = [-1e-4 + 5e-10 * s for s in sizes]
    _close(tcm.fit_alpha_beta(sizes, times), jcm.fit_alpha_beta(sizes, times))


def _families(seed: int):
    """The same family in both packages: a sampled entry at 2 and flat
    entries at 4 and 8, from seeded constants."""
    rs = np.random.RandomState(seed)
    sizes, times, _ = _samples(seed, 5)
    out = []
    for m in (tcm, jcm):
        ab = m.fit_alpha_beta(sizes, times)
        flat = {n: m.AlphaBeta(*rs.uniform(1e-6, 1e-3, 2) * [1, 1e-6],
                               gamma=1e-5 * n, overlap=0.5 + 0.05 * n,
                               pack_beta=1e-11 * n, update_beta=0.0,
                               ag_fraction=0.4)
                for n in (4, 8)}
        rs = np.random.RandomState(seed)
        out.append(m.ProfileFamily(entries={
            2: m.SampledCost(sizes_bytes=tuple(sizes), times_s=tuple(times),
                             ab=ab, gamma=3e-6, overlap=0.7,
                             pack_beta=2e-11),
            **flat,
        }))
    return out


@pytest.mark.parametrize("nworkers", [1, 2, 3, 4, 6, 8, 16, 64])
def test_family_at_equals_jax(nworkers):
    ours, theirs = _families(nworkers)
    got, want = ours.at(nworkers), theirs.at(nworkers)
    assert type(got).__name__ == type(want).__name__
    _close(got, want)
    _close(tcm.resolve_profile(ours, nworkers),
           jcm.resolve_profile(theirs, nworkers))
    for nbytes in (10.0, 3e4, 5e6, 2e8):
        assert abs(got.predict(nbytes) - want.predict(nbytes)) <= TOL


def test_committed_profile_or_prior_equals_jax(tmp_path):
    ours, theirs = _families(3)
    path = str(tmp_path / "fam.json")
    tcm.save_profile(path, ours)
    for p, src in ((path, path), (str(tmp_path / "absent.json"), None)):
        got, got_src = tcm.committed_profile_or_prior(p, "10GbE", 6)
        want, want_src = jcm.committed_profile_or_prior(p, "10GbE", 6)
        assert got_src == want_src == src
        _close(got, want)


@pytest.mark.parametrize("name", ["cpu_family.json", "tpu_v5e_1chip.json"])
def test_committed_jax_profiles_load_in_the_port(name):
    path = os.path.join(ROOT, "profiles", name)
    ours, theirs = tcm.load_profile(path), jcm.load_profile(path)
    assert type(ours).__name__ == type(theirs).__name__
    for n in (1, 2, 3, 4, 8, 16):
        got = tcm.resolve_profile(ours, n)
        want = jcm.resolve_profile(theirs, n)
        _close(got, want)
        for nbytes in (100.0, 1e6, 1e9):
            assert got.predict(nbytes) == want.predict(nbytes)


def test_a_family_the_port_writes_resolves_equal_in_jax(tmp_path):
    ours, _ = _families(5)
    path = str(tmp_path / "fam.json")
    tcm.save_profile(path, ours, meta={"device_kind": "test"})
    theirs = jcm.load_profile(path)
    assert isinstance(theirs, jcm.ProfileFamily)
    for n in (2, 3, 4, 8, 32):
        got, want = tcm.resolve_profile(ours, n), jcm.resolve_profile(theirs, n)
        _close(got, want)
        assert got.predict(7e5) == want.predict(7e5)


def test_two_level_profiles_are_refused_naming_the_roadmap(tmp_path):
    """A JAX two-level profile loads (item 7b ported it): the same kind,
    sizes and predictions."""
    path = str(tmp_path / "two.json")
    theirs = jcm.TwoLevelAlphaBeta(
        ici=jcm.AlphaBeta(1e-5, 1e-11), dcn=jcm.AlphaBeta(1e-4, 1e-10),
        ici_size=4, dcn_size=2,
    )
    jcm.save_profile(path, theirs)
    ours = tcm.load_profile(path)
    assert isinstance(ours, tcm.TwoLevelAlphaBeta)
    assert (ours.ici_size, ours.dcn_size) == (4, 2)
    for nbytes in (1.0, 4e3, 1e7):
        assert ours.predict(nbytes) == theirs.predict(nbytes)


def test_effective_cost_fn_equals_jax():
    """Every lowering prices as the JAX package prices it (rs_opt_ag and
    rs_fwd_ag add update_beta per bucket byte, so both update_beta 0 and a
    measured one are held)."""
    import dataclasses

    ours, theirs = _families(7)
    for n in (2, 4):
        for ub in (0.0, 3e-12):
            mo = dataclasses.replace(ours.at(n), update_beta=ub)
            mt = dataclasses.replace(theirs.at(n), update_beta=ub)
            for op in ("all_reduce", "rs_ag", "rs_opt_ag", "rs_fwd_ag",
                       "hier"):
                got = effective_cost_fn(mo, op)
                want = jax_effective_cost(mt, op)
                for nbytes in (1.0, 4e3, 1e7):
                    assert got(nbytes) == want(nbytes), (n, ub, op, nbytes)
    assert effective_cost_fn(
        dataclasses.replace(ours.at(4), update_beta=3e-12), "rs_opt_ag"
    )(1e7) > effective_cost_fn(ours.at(4), "rs_opt_ag")(1e7)


@pytest.mark.parametrize("missing", [None, 0, 2])
def test_group_times_from_rows_equals_jax(missing):
    rs = np.random.RandomState(11)
    rows = []
    for gi in range(3):
        if gi == missing:
            continue
        for kernel in ("ncclDevKernel_AllReduce_Sum_f32", "CatArrayBatchedCopy"):
            rows.append((f"mgwfbp_group{gi:04d} {kernel}",
                         float(rs.uniform(1, 50))))
    rows.append(("aten::add unrelated", 9.0))
    got = group_times_from_rows(rows, 3, iters=2)
    want = _group_times_from_scopes(rows, 3, 2)
    assert got == want
    assert (got is None) == (missing is not None)


@pytest.mark.parametrize("bare", [None, 0, 2])
def test_collective_group_times_needs_a_collective_in_every_range(bare):
    """A range of copies alone (one rank over NCCL) measured the pack, not
    the all-reduce: no group times, though every range holds device time."""
    rs = np.random.RandomState(12)
    rows = []
    for gi in range(3):
        kernels = ["Memcpy DtoD (Device -> Device)", "CatArrayBatchedCopy"]
        if gi != bare:
            kernels.append("ncclDevKernel_AllReduce_Sum_f32_RING_LL")
        rows += [(f"mgwfbp_group{gi:04d} {k}", float(rs.uniform(1, 50)))
                 for k in kernels]
    got = collective_group_times(rows, 3, iters=2)
    if bare is None:
        assert got == group_times_from_rows(rows, 3, iters=2)
    else:
        assert got is None
        assert group_times_from_rows(rows, 3, iters=2) is not None
    copies_only = [r for r in rows if "nccl" not in r[0]]
    assert collective_group_times(copies_only, 3, iters=2) is None
    assert not is_collective_kernel("CatArrayBatchedCopy")


# -- the CLI ------------------------------------------------------------


def test_prior_extend_and_world_sizes_mutually_exclusive(tmp_path, capsys):
    with pytest.raises(SystemExit) as ei:
        calibrate.main(["--out", str(tmp_path / "p.json"), "--prior-extend",
                        "ici", "--world-sizes", "2,4", *TINY])
    assert ei.value.code == 2
    assert "mutually exclusive" in capsys.readouterr().err


def test_two_level_is_refused_naming_the_roadmap(tmp_path, capsys):
    """--two-level is its own mode (the JAX CLI's usage error), needs more
    than one slice, and a split that does not make the world exits before
    it measures."""
    out = tmp_path / "p.json"
    with pytest.raises(SystemExit) as ei:
        calibrate.main(["--out", str(out), "--two-level", "--forward",
                        "--model", "lenet", *TINY])
    assert ei.value.code == 2
    assert "its own calibration mode" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="needs --dcn > 1"):
        calibrate.main(["--out", str(out), "--two-level", "--dcn", "1",
                        *TINY])
    with pytest.raises(SystemExit, match="does not make the world of 1"):
        calibrate.main(["--out", str(out), "--two-level", "--dcn", "2",
                        *TINY])
    assert not out.exists()


def test_world_sizes_beyond_the_world_exits_cleanly(tmp_path):
    out = tmp_path / "p.json"
    with pytest.raises(SystemExit) as ei:
        calibrate.main(["--out", str(out), "--world-sizes", "64",
                        "--no-gamma", "--no-overlap", *TINY])
    assert "devices available" in str(ei.value)
    assert not out.exists()


def test_the_card_is_the_default_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate.main(["--out", str(tmp_path / "p.json"), "--no-gamma",
                        "--no-overlap", "--min-log2", "8", "--max-log2", "9"])


def test_default_mode_round_trips_a_sampled_profile(tmp_path, capsys):
    out = tmp_path / "prof.json"
    assert calibrate.main(["--out", str(out), "--gamma-total-log2", "12",
                           *TINY]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["samples"] == 3 and report["out"] == str(out)
    for m in (tcm.load_profile(str(out)), jcm.load_profile(str(out))):
        assert type(m).__name__ == "SampledCost"
        assert m.alpha == pytest.approx(report["alpha_s"])
        assert m.beta == pytest.approx(report["beta_s_per_byte"])
        assert m.gamma >= 0.0 and m.pack_beta >= 0.0
        assert 0.0 <= m.overlap <= 1.0
        # measured (profile_update_beta), not written as a placeholder
        assert m.update_beta == pytest.approx(
            report["update_beta_s_per_byte"]) and m.update_beta >= 0.0
    doc = json.load(open(out))
    assert doc["schema_version"] == tcm.PROFILE_SCHEMA_VERSION
    meta = doc["meta"]
    assert meta["n_devices"] == 1 and meta["backend"] == "gloo"
    assert meta["device_kind"].startswith("cpu")
    assert "update_beta" not in meta.get("not_measured", {})
    assert [k for k, _ in meta["gamma_samples_s"]] == [1, 2, 4, 8, 16, 32, 64]


def test_allgather_fits_a_clamped_phase_split(tmp_path, capsys):
    out = tmp_path / "ag.json"
    assert calibrate.main(["--out", str(out), "--allgather", "--no-gamma",
                           "--no-overlap", *TINY]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    m = jcm.load_profile(str(out))
    assert 0.05 <= m.ag_fraction <= 0.95
    assert m.ag_fraction == report["ag_fraction"]


def test_prior_extend_writes_measured_and_prior_fields(tmp_path, capsys):
    out = tmp_path / "fam.json"
    assert calibrate.main(["--out", str(out), "--prior-extend", "56GbIB",
                           "--no-gamma", "--no-overlap", *TINY]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["measured_world"] == 1
    assert report["prior_extended"] == [2, 4, 8, 16]
    meta = json.load(open(out))["meta"]
    assert sorted(meta["measured_fields"]) == ["1", "16", "2", "4", "8"]
    assert sorted(meta["prior_fields"]) == ["16", "2", "4", "8"]
    assert all("56GbIB" in v for v in meta["prior_fields"].values())
    fam = jcm.load_profile(str(out))
    measured = fam.at(1)
    assert type(measured).__name__ == "SampledCost"
    for n in (2, 4, 8, 16):
        prior = jcm.lookup_alpha_beta("56GbIB", n)
        entry = fam.at(n)
        assert (entry.alpha, entry.beta) == (prior.alpha, prior.beta)
        assert (entry.gamma, entry.overlap, entry.pack_beta) == (
            measured.gamma, measured.overlap, measured.pack_beta)


def test_world_sizes_over_two_gloo_processes_round_trip_a_family(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tmp_path / "fam.json"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "mgwfbp_tpu_torch.calibrate", "--out",
             str(out), "--world-sizes", "1,2", "--gamma-total-log2", "10",
             *TINY],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=str(tmp_path),
            env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                     MGWFBP_COORDINATOR=f"127.0.0.1:{port}",
                     MGWFBP_NUM_PROCESSES="2", MGWFBP_PROCESS_ID=str(r)),
        )
        for r in range(2)
    ]
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=120)
            assert p.returncode == 0, e[-3000:]
            outs.append(o)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    assert outs[1].strip() == ""  # rank 0 alone reports and writes
    report = json.loads(outs[0].strip().splitlines()[-1])
    assert sorted(report["family"]) == ["1", "2"]
    ours, theirs = tcm.load_profile(str(out)), jcm.load_profile(str(out))
    for n in (1, 2, 3):
        _close(tcm.resolve_profile(ours, n), jcm.resolve_profile(theirs, n))
    assert ours.at(2).alpha == pytest.approx(report["family"]["2"]["alpha_s"])
    meta = json.load(open(out))["meta"]
    assert meta["world_sizes"] == [1, 2] and meta["n_devices"] == 2


def test_forward_writes_a_layer_profile_the_jax_reader_reads(tmp_path, capsys):
    out = tmp_path / "layers.json"
    assert calibrate.main(["--out", str(out), "--forward", "--model",
                           "resnet20", "--batch-size", "2", *TINY]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    doc = jax_load_layer_profile(str(out))
    assert doc["schema_version"] == 2 and report["layers"] == 65
    assert doc["source"] == doc["tf_source"] == "hooks"
    assert len(doc["tb_s"]) == len(doc["tf_s"]) == 65
    assert np.isfinite(doc["tb_s"] + doc["tf_s"]).all()
    assert sum(doc["tf_s"]) == pytest.approx(doc["tf_total_s"])
    # the arrival order of the JAX package's gradient tree
    jm, _ = jax_create_model("resnet20")
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                        train=False)
    )["params"]
    names = [jax.tree_util.keystr(kp) for kp, _ in
             jax.tree_util.tree_flatten_with_path(shapes)[0]]
    perm = jax_arrival_order(len(names), names=names)
    assert doc["arrival_names"] == [names[j] for j in perm]


def test_forward_profiles_the_lstm_from_tokens_and_a_carry(tmp_path, capsys):
    out = tmp_path / "lstm.json"
    assert calibrate.main(["--out", str(out), "--forward", "--model", "lstm",
                           "--batch-size", "1", *TINY]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    doc = jax_load_layer_profile(str(out))
    assert report["layers"] == 27 and doc["meta"]["model"] == "lstm"
    assert doc["source"] == doc["tf_source"] == "hooks"
    assert np.isfinite(doc["tb_s"] + doc["tf_s"]).all()
    jm, _ = jax_create_model("lstm")
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 35), jnp.int32),
                        train=False)
    )["params"]
    names = [jax.tree_util.keystr(kp) for kp, _ in
             jax.tree_util.tree_flatten_with_path(shapes)[0]]
    perm = jax_arrival_order(len(names), names=names)
    assert doc["arrival_names"] == [names[j] for j in perm]


@pytest.mark.parametrize("model", ["lstman4"])
def test_forward_refuses_a_model_still_to_port(tmp_path, model):
    """The last model to port, the speech model, profiles at full width
    (78 leaves, a ctc batch), and an unknown name is refused."""
    out = tmp_path / "x.json"
    assert calibrate.main(["--out", str(out), "--forward", "--model", model,
                           "--device", "cpu", "--batch-size", "1",
                           "--iters", "1", "--warmup", "0"]) == 0
    doc = json.loads(out.read_text())
    assert len(doc["tb_s"]) == len(doc["tf_s"]) == 78
    assert doc["source"] == "hooks" and doc["meta"]["model"] == model
    assert all(np.isfinite(doc["tb_s"])) and all(np.isfinite(doc["tf_s"]))
    with pytest.raises(SystemExit, match="--model no_such: unknown model"):
        calibrate.main(["--out", str(tmp_path / "y.json"), "--forward",
                        "--model", "no_such", "--device", "cpu"])
