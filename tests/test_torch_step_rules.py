"""The schedule rules the port holds one OBSERVED step to on the host side
(``analysis.schedule_check``): SCH005 (host synchronisation outside the
declared metrics read-back), SCH006 (state not updated in place), SCH008
(the guard present exactly when configured) and SCH010 (the health
statistics add no collective and no synchronisation).

At two gloo ranks, through one spawned group (tests/
torch_step_rules_worker.py), LeNet steps built by the step pass: the clean
step of each lowering gives no finding, and each mutation gives its rule
and no other: a gradient hook's ``.item()``, ``.tolist()`` and branch on a
tensor; a parameter rebound by the update; the sharded lowerings' state
rebound as the reducer did before it updated it in place (the repair this
rule asked for); the guard's count outside its range, and a guard-off
build that still counts; a health-statistics build with an extra
all-reduce or an extra read-back. The JAX suite's own tests of these
rules do not all pass on the CPU, so the port's rules are held by their
own mutations, both ways. Then the pieces in-process: the synchronising-op
classifier, the observer's window, the one declared read-back."""

from __future__ import annotations

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_step_rules_worker as worker  # noqa: E402

EXPECTED = {
    "clean/all_reduce": set(),
    "clean/rs_opt_ag": set(),
    "clean/rs_fwd_ag": set(),
    "clean/guard_off": set(),
    "clean/health_all_reduce": set(),
    "clean/health_rs_opt_ag": set(),
    "sch005/hook_item": {"SCH005"},
    "sch005/hook_tolist": {"SCH005"},
    "sch005/branch_on_tensor": {"SCH005"},
    "sch006/param_rebound": {"SCH006"},
    "sch006/parent_rs_opt_ag": {"SCH006"},
    "sch006/parent_rs_fwd_ag": {"SCH006"},
    "sch008/guard_without_range": {"SCH008"},
    "sch008/guard_off_with_count": {"SCH008"},
    "sch010/extra_all_reduce": {"SCH010"},
    "sch010/extra_read_back": {"SCH010"},
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return worker.run_ranks(2, str(tmp_path_factory.mktemp("step_rules")))


@pytest.mark.parametrize("case", sorted(EXPECTED))
def test_case_gives_its_rule_and_no_other(ranks, case):
    for rank, out in enumerate(ranks):
        got = {rule for rule, _ in out[case]}
        assert got == EXPECTED[case], (rank, out[case])
    assert set(ranks[0]) == set(EXPECTED)


def test_sharded_state_rebinding_names_the_state(ranks):
    opt_ag = " ".join(m for _, m in ranks[0]["sch006/parent_rs_opt_ag"])
    assert "sharded optimizer slot 0 group 0" in opt_ag
    fwd = " ".join(m for _, m in ranks[0]["sch006/parent_rs_fwd_ag"])
    assert "carried parameter shard group 0" in fwd
    assert "sharded optimizer slot 0 group 0" in fwd


def test_hook_read_is_reported_outside_the_read_back(ranks):
    msg = ranks[0]["sch005/hook_item"][0][1]
    assert "aten._local_scalar_dense" in msg and "metrics_readback" in msg
    assert "Tensor.tolist" in ranks[0]["sch005/hook_tolist"][0][1]


# -- in-process pieces -----------------------------------------------------------


def test_sync_classifier():
    from mgwfbp_tpu_torch.analysis.schedule_check import _sync_op

    aten = torch.ops.aten
    card = torch.empty(2, device="meta")  # stands in for a card tensor
    host = torch.empty(2)
    assert _sync_op(aten._local_scalar_dense.default, (host,), {}) == (
        "aten._local_scalar_dense")
    assert _sync_op(aten._to_copy.default, (card,),
                    {"device": torch.device("cpu")}) == "aten._to_copy"
    assert _sync_op(aten._to_copy.default, (card,),
                    {"device": torch.device("cpu"),
                     "non_blocking": True}) is None
    assert _sync_op(aten._to_copy.default, (host,),
                    {"dtype": torch.float64}) is None
    assert _sync_op(aten.copy_.default, (host, card), {}) == "aten.copy_"
    assert _sync_op(aten.copy_.default, (host, card, True), {}) is None
    assert _sync_op(aten.copy_.default, (card, host), {}) is None
    assert _sync_op(aten.add.Tensor, (host, host), {}) is None


def test_observer_window_restores_what_it_wraps():
    from mgwfbp_tpu_torch.analysis.schedule_check import HostObserver

    before = (torch.Tensor.__dict__.get("tolist"),
              torch.Tensor.__dict__.get("isfinite"), torch.isfinite)
    t = torch.tensor([1.0, float("nan")])
    with HostObserver() as obs:
        t.tolist()
        torch.isfinite(t)
        t.isfinite()
        float(t[0])
        with pytest.raises(RuntimeError):
            with HostObserver():
                pass
    assert [s.op for s in obs.syncs] == ["Tensor.tolist",
                                         "aten._local_scalar_dense"]
    assert len(obs.guard_calls) == 2
    assert (torch.Tensor.__dict__.get("tolist"),
            torch.Tensor.__dict__.get("isfinite"), torch.isfinite) == before
    t.tolist()
    assert len(obs.syncs) == 2


def test_one_process_step_has_one_declared_read_back():
    from mgwfbp_tpu_torch import models as zoo
    from mgwfbp_tpu_torch.analysis import step_pass
    from mgwfbp_tpu_torch.analysis.schedule_check import verify_observed_step
    from mgwfbp_tpu_torch.optim import make_optimizer
    from mgwfbp_tpu_torch.train.step import READBACK_SCOPE, TrainStep

    model, meta = zoo.create_model("lenet")
    opt, lr_fn = make_optimizer(model.parameters(), 0.1, momentum=0.9,
                                weight_decay=0.0)[:2]
    step = TrainStep(model, opt, lr_fn, norm_clip=1.0)
    data = step_pass.batches(meta, "cpu", 0)
    step(*next(data))
    obs = verify_observed_step(lambda: step(*next(data)), step)
    assert obs.findings == []
    assert [(s.op, s.scopes) for s in obs.syncs] == [
        ("Tensor.tolist", (READBACK_SCOPE,))]
    assert obs.guard_calls == [("finite_check",)]
