"""The measured launch sequence of the port's merged collectives
(``mgwfbp_tpu_torch.parallel.allreduce.MergedAllreduce``).

The first armed backward of a newly attached reducer launches its groups
in group-index order; rank 0 takes from its hooks the order the groups
completed in (and, on rs_fwd_ag, the forward's first use of each group)
and publishes it in the rendezvous store; every rank then launches along
it. ResNet-20 at its published widths, batch 2 a rank, 5 steps, in 2 gloo
processes (hier: 4, 2 slices of 2; ``tests/torch_launch_order_worker.py``):

  * from step 2 no group is held back (``held_groups`` on the launch
    sequence) under wfbp and mgwfbp, where group-index order holds back
    all but a few on the same hook order;
  * on all_reduce, rs_ag, rs_opt_ag, rs_fwd_ag, hier and top-k the
    gradients and parameters after 5 steps equal, bit for bit, those of
    the same run with the sequence pinned to group-index order, with the
    same collectives a step;
  * every rank launches the same sequence, rank 0's, also a rank whose
    hooks are delivered in another order (which finishes: each run is
    killed after 240 s);
  * a disarmed micro-step does not measure, and a reducer attached again
    measures again;
  * rs_fwd_ag gathers the stem's group first from step 2.

The overlap replay takes the launch sequence: by default (group-index
order) it is the JAX package's replay, and the trainer passes the
reducer's sequence.
"""

import json
import os
import sys

import numpy as np
import pytest

from mgwfbp_tpu_torch.parallel.allreduce import completion_order, held_groups
from mgwfbp_tpu_torch.telemetry import overlap as tov
from torch_xstep_worker import run_children

STEPS = 5
OPS = ("all_reduce", "rs_ag", "rs_opt_ag", "rs_fwd_ag", "topk")
CLIP = {"rs_opt_ag": 1.0, "rs_fwd_ag": 1.0}


def _ranks(tmp_path, world: int, spec: dict) -> list[dict]:
    worker = os.path.join(os.path.dirname(__file__),
                          "torch_launch_order_worker.py")
    with open(tmp_path / "spec.json", "w") as f:
        json.dump(spec, f)
    rdv = str(tmp_path / "rendezvous")
    run_children([[sys.executable, worker, str(r), str(world), rdv,
                   str(tmp_path)] for r in range(world)],
                 timeout_s=240.0, cwd=str(tmp_path))
    out = []
    for r in range(world):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            out.append({k: z[k] for k in z.files})
    return out


def _run(label, op, mode, **kw) -> dict:
    return {"label": label, "op": op, "mode": mode, **kw}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    runs = []
    for op in OPS:
        for mode in ("measured", "pinned"):
            runs.append(_run(f"{op}/{mode}", op, mode, clip=CLIP.get(op)))
    runs += [
        _run("mgwfbp/measured", "all_reduce", "measured", policy="mgwfbp"),
        _run("forced", "all_reduce", "forced"),
        _run("accumulate", "all_reduce", "accumulate"),
        _run("reattach", "all_reduce", "reattach"),
    ]
    return _ranks(tmp_path_factory.mktemp("order2"), 2,
                  {"batch": 2, "steps": STEPS, "seed": 3, "runs": runs})


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    runs = [_run(f"hier/{mode}", "hier", mode)
            for mode in ("measured", "pinned")]
    return _ranks(tmp_path_factory.mktemp("order4"), 4,
                  {"batch": 2, "steps": STEPS, "seed": 3, "dcn": 2,
                   "runs": runs})


def _ranks_of(op, two_ranks, four_ranks):
    return four_ranks if op == "hier" else two_ranks


def _groups(r, label) -> list:
    return json.loads(str(r[f"{label}/groups"]))


def _log(r, label, k) -> list:
    return r[f"{label}/launch_log{k}"].tolist()


@pytest.mark.parametrize("policy", ["wfbp", "mgwfbp"])
def test_no_group_is_held_from_step_2(two_ranks, policy):
    label = f"{'all_reduce' if policy == 'wfbp' else policy}/measured"
    for r in two_ranks:
        groups = _groups(r, label)
        g = len(groups)
        assert _log(r, label, 1) == list(range(g))
        for k in range(2, STEPS + 1):
            arrivals = r[f"{label}/arrivals{k}"].tolist()
            log = _log(r, label, k)
            assert held_groups(groups, arrivals, log) == 0, (k, log)
            # the witness: group-index order on the same hooks
            witness = held_groups(groups, arrivals)
            if policy == "wfbp":
                assert g == 65 and witness >= 60, witness
            else:
                assert 1 < g < 65 and witness >= g - 2, (g, witness)


@pytest.mark.parametrize("op", OPS + ("hier",))
def test_values_equal_the_index_order_run_bitwise(two_ranks, four_ranks, op):
    for r in _ranks_of(op, two_ranks, four_ranks):
        got, want = f"{op}/measured", f"{op}/pinned"
        for key in ("grads", "params"):
            assert np.array_equal(r[f"{got}/{key}"], r[f"{want}/{key}"]), key
        g = len(_groups(r, got))
        for k in range(1, STEPS + 1):
            assert int(r[f"{got}/launches{k}"]) == int(
                r[f"{want}/launches{k}"])
            assert _log(r, want, k) == list(range(g))
        # the measured run did launch out of index order
        assert _log(r, got, STEPS) != list(range(g))


@pytest.mark.parametrize("op", OPS + ("hier",))
def test_every_rank_launches_rank_0s_sequence(two_ranks, four_ranks, op):
    ranks = _ranks_of(op, two_ranks, four_ranks)
    label = f"{op}/measured"
    g = len(_groups(ranks[0], label))
    for k in range(1, STEPS + 1):
        logs = [_log(r, label, k) for r in ranks]
        assert all(log == logs[0] for log in logs), (k, logs)
        assert sorted(logs[0]) == list(range(g))
        assert logs[0] == ranks[0][f"{label}/sequence{k}"].tolist()
        if k > 1:
            assert logs[0] == completion_order(
                _groups(ranks[0], label),
                ranks[0][f"{label}/arrivals1"].tolist())


def test_a_rank_with_another_hook_order_follows_rank_0(two_ranks):
    first, last = two_ranks[0], two_ranks[-1]
    for k in range(1, STEPS + 1):
        assert (first[f"forced/arrivals{k}"].tolist()
                != last[f"forced/arrivals{k}"].tolist())
        assert _log(last, "forced", k) == _log(first, "forced", k)
    assert _log(first, "forced", STEPS) == _log(
        first, "all_reduce/measured", STEPS)
    for r in two_ranks:
        for key in ("grads", "params"):
            assert np.array_equal(r[f"forced/{key}"],
                                  r[f"all_reduce/measured/{key}"]), key


def test_a_disarmed_micro_step_does_not_measure(two_ranks):
    for r in two_ranks:
        g = len(_groups(r, "accumulate"))
        assert _log(r, "accumulate", 1) == list(range(g))
        seq = r["accumulate/sequence2"].tolist()
        assert seq != list(range(g))
        assert _log(r, "accumulate", 2) == seq
        assert seq == completion_order(_groups(r, "accumulate"),
                                       r["accumulate/arrivals1"].tolist())


def test_a_reattached_reducer_measures_again(two_ranks):
    for r in two_ranks:
        g = len(_groups(r, "reattach"))
        measured = _log(r, "reattach", 2)
        assert r["reattach/sequence_after_detach"].tolist() == measured
        assert _log(r, "reattach", STEPS + 1) == list(range(g))
        assert _log(r, "reattach", STEPS + 2) == measured != list(range(g))


def test_rs_fwd_ag_gathers_the_stem_group_first(two_ranks):
    for r in two_ranks:
        g = len(_groups(r, "rs_fwd_ag/measured"))
        group_of = r["rs_fwd_ag/measured/group_of"].tolist()
        stem = {group_of[k] for k in r["rs_fwd_ag/measured/stem"].tolist()}
        assert r["rs_fwd_ag/measured/gathered1"].tolist() == []
        seq = r["rs_fwd_ag/measured/gather_sequence"].tolist()
        assert sorted(seq) == list(range(g)) and seq[0] in stem
        for k in range(2, STEPS + 1):
            assert r[f"rs_fwd_ag/measured/gathered{k}"].tolist() == seq
            # reverse group order gathered the stem's groups among the
            # last five (after the head's two)
            pinned = r[f"rs_fwd_ag/pinned/gathered{k}"].tolist()
            assert pinned == list(reversed(range(g)))
            assert stem <= set(pinned[-5:])
        assert (two_ranks[0]["rs_fwd_ag/measured/gather_sequence"].tolist()
                == seq)


# -- host arithmetic ----------------------------------------------------------


def test_completion_order_and_held_groups():
    groups = [[0, 1], [2], [3, 4]]
    arrivals = [2, 3, 4, 0, 1]  # the first group completes last
    assert completion_order(groups, arrivals) == [1, 2, 0]
    assert held_groups(groups, arrivals) == 2
    assert held_groups(groups, arrivals, [1, 2, 0]) == 0
    assert held_groups(groups, arrivals, [2, 1, 0]) == 1


def _replay_inputs(seed: int = 0, n_leaves: int = 12):
    rs = np.random.RandomState(seed)
    tb = rs.uniform(1e-4, 1e-3, n_leaves).tolist()
    cuts = sorted(rs.choice(range(1, n_leaves), 4, replace=False).tolist())
    bounds = [0] + cuts + [n_leaves]
    groups = [list(range(a, b)) for a, b in zip(bounds, bounds[1:])]
    comm = rs.uniform(1e-4, 2e-3, len(groups)).tolist()
    nbytes = [4 * len(g) for g in groups]
    return tb, groups, comm, nbytes


def _same_rows(got, want, tol=1e-12):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.group == b.group and a.nbytes == b.nbytes
        for f in ("start_s", "comm_s", "hidden_s", "exposed_s", "ag_start_s",
                  "ag_s", "ici_s", "dcn_s"):
            assert abs(getattr(a, f) - getattr(b, f)) <= tol, f


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replay_along_index_order_is_the_default_replay(seed):
    tb, groups, comm, nbytes = _replay_inputs(seed)
    n = len(groups)
    index = list(range(n))
    _same_rows(tov.attribute_overlap(groups, tb, comm, nbytes, order=index),
               tov.attribute_overlap(groups, tb, comm, nbytes))
    rs_s, ag_s = comm, [0.5 * c for c in comm]
    tf = [0.5 * t for t in tb]
    got, fwd_got = tov.attribute_overlap_cross_step(
        groups, tb, tf, rs_s, ag_s, nbytes, order=index,
        gather_order=list(reversed(index)))
    want, fwd_want = tov.attribute_overlap_cross_step(
        groups, tb, tf, rs_s, ag_s, nbytes)
    assert fwd_got == fwd_want
    _same_rows(got, want)
    dcn = [[0, 1], list(range(2, n))]
    dcn_s = [1e-3, 2e-3]
    _same_rows(tov.attribute_overlap_two_level(
        groups, dcn, tb, rs_s, dcn_s, ag_s, nbytes, order=index),
        tov.attribute_overlap_two_level(groups, dcn, tb, rs_s, dcn_s, ag_s,
                                        nbytes))


def test_replay_along_a_sequence_serves_its_first_group_first():
    tb, groups, comm, nbytes = _replay_inputs(4)
    n = len(groups)
    order = list(range(1, n)) + [0]  # the first group completes last
    rows = tov.attribute_overlap(groups, tb, comm, nbytes, order=order)
    assert [r.group for r in rows] == list(range(n))
    starts = [rows[gi].start_s for gi in order]
    assert starts == sorted(starts)
    # group 0 is ready only when the whole backward is
    assert rows[0].start_s >= sum(tb) * (1 - 1e-12)
    # the cross-step replay gathers in the order given
    rows, _ = tov.attribute_overlap_cross_step(
        groups, tb, [0.5 * t for t in tb], comm, comm, nbytes, order=order,
        gather_order=list(range(n)))
    assert [rows[gi].ag_start_s for gi in range(n)] == sorted(
        rows[gi].ag_start_s for gi in range(n))
    with pytest.raises(ValueError, match="permutation"):
        tov.attribute_overlap(groups, tb, comm, nbytes, order=[0] * n)
