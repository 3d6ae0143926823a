"""The port's schedule verifier (``mgwfbp_tpu_torch/analysis``), the gate
of the autotuner's race, against the JAX package's rules.

  * the registry's ids equal the JAX registry's, the severities and
    summaries of the collective rules (SCH001-SCH004, SCH007, SCH009)
    equal it, and ``Finding`` formats as the JAX one does;
  * ``layout_problems`` equals the JAX ``BucketLayout.validate`` on the
    same layouts, sound and broken (a dropped leaf, a duplicated one, a
    wrong offset), message for message;
  * at two gloo ranks (``tests/torch_autotune_worker.py``'s ``gate``
    task), one observed step of the narrow ResNet-20 under each lowering
    (all_reduce, rs_ag, rs_opt_ag and rs_fwd_ag with the clip, hier over
    two slices, top-k) gives no ERROR finding, and its collectives are the
    lowering's contract (the JAX verifier's branches): per group one
    all-reduce; one reduce-scatter and one all-gather; rs_fwd_ag's
    reduce-scatter in the step and its all-gather in the next forward;
    hier's inner legs and one cross-slice all-reduce per DCN group; top-k's
    two gathers of values and int32 indices; plus the step's own
    ``metrics_reduce`` and ``bstats_reduce`` (and the clip's all-reduce on
    the sharded lowerings);
  * each mutation gives its rule id: a dropped group collective SCH001, a
    wrong wire dtype SCH002, a layout that misses a leaf SCH003, an extra
    collective outside the ranges SCH004, a wrong payload size SCH007.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from mgwfbp_tpu.analysis import rules as jax_rules
from mgwfbp_tpu.parallel import buckets as jax_buckets
from mgwfbp_tpu_torch.analysis import rules
from mgwfbp_tpu_torch.analysis.schedule_check import (
    Collective,
    check_collectives,
    classify,
    layout_problems,
)
from mgwfbp_tpu_torch.parallel import buckets

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_autotune_worker as worker  # noqa: E402

PORTED = ("SCH001", "SCH002", "SCH003", "SCH004", "SCH007", "SCH009")


def test_ported_rules_equal_jax_registry():
    # the whole registry is ported since the static analysis; the
    # collective rules keep the JAX summaries word for word
    assert sorted(rules.RULES) == sorted(jax_rules.RULES)
    for rid in PORTED:
        assert rules.RULES[rid].severity == jax_rules.RULES[rid].severity
        assert rules.RULES[rid].summary == jax_rules.RULES[rid].summary
    f = rules.Finding("<step>", 0, "SCH004", "m")
    j = jax_rules.Finding("<step>", 0, "SCH004", "m")
    assert f.format() == j.format() and f.severity == j.severity


class _Leaf:
    def __init__(self, shape, dtype):
        self.shape = shape
        self.dtype = dtype


def _layouts(seed: int):
    """(port layout, port leaves, JAX layout, JAX leaves) of one seeded
    problem, float32 with a bfloat16 run in the middle."""
    import jax.numpy as jnp

    rs = np.random.RandomState(seed)
    n = 9
    shapes = [tuple(int(d) for d in rs.randint(1, 6, rs.randint(1, 3)))
              for _ in range(n)]
    half = set(rs.choice(n, 2, replace=False).tolist())
    tl = [torch.empty(s, dtype=torch.bfloat16 if i in half else torch.float32,
                      device="meta") for i, s in enumerate(shapes)]
    jl = [_Leaf(s, jnp.bfloat16 if i in half else jnp.float32)
          for i, s in enumerate(shapes)]
    groups = [[0, 1, 2], [3, 4], [5, 6, 7, 8]]
    return (buckets.build_layout(tl, groups), tl,
            jax_buckets.build_layout(jl, groups), jl)


def _mutate(layout, kind: str):
    import dataclasses

    g, o, s, d = (list(layout.groups), list(layout.offsets),
                  list(layout.group_sizes), list(layout.dtypes))
    if kind == "drop":
        g[0], o[0] = g[0][:-1], o[0][:-1]
    elif kind == "dup":
        g[1] = g[1] + (g[0][0],)
        o[1] = o[1] + (s[1],)
    elif kind == "offset":
        o[-1] = o[-1][:-1] + (o[-1][-1] + 1,)
    return dataclasses.replace(layout, groups=tuple(g), offsets=tuple(o),
                               group_sizes=tuple(s), dtypes=tuple(d))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["sound", "drop", "dup", "offset"])
def test_layout_problems_equal_jax_validate(seed, kind):
    tl, tleaves, jl, jleaves = _layouts(seed)
    got = layout_problems(_mutate(tl, kind), tleaves)
    want = _mutate(jl, kind).validate(jleaves)
    assert got == want
    assert bool(got) == (kind != "sound")


def test_classify_attributes_by_innermost_range():
    recs = [
        Collective("all_reduce", 4, torch.float32, (0, 1),
                   ("mgwfbp_group0002",)),
        Collective("all_reduce", 2, torch.float32, (0, 1),
                   ("mgwfbp_group0001", "mgwfbp_dcngroup0000")),
        Collective("all_reduce", 3, torch.float32, (0, 1),
                   ("metrics_reduce",)),
        Collective("all_reduce", 1, torch.float32, (0, 1),
                   ("extra_metrics_reduce_v2",)),
    ]
    info = classify(recs)
    assert list(info["groups"]) == [2] and list(info["dcn_groups"]) == [0]
    assert info["allowed"] == [recs[2]] and info["stray"] == [recs[3]]


@pytest.fixture(scope="module")
def gate(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("gate"))
    return worker.run_ranks(2, tmp, {"tasks": ["gate"],
                                     "gate": {"seed": 3, "threshold": 3000}})


def _records(out, name):
    return json.loads(str(out[f"{name}/records"]))


LOWERINGS = ["all_reduce", "rs_ag", "rs_opt_ag", "rs_fwd_ag", "hier", "topk"]


@pytest.mark.parametrize("name", LOWERINGS)
def test_clean_schedule_has_no_error_finding(gate, name):
    for out in gate:
        assert json.loads(str(out[f"clean/{name}/rules"])) == [], \
            str(out[f"clean/{name}/messages"])


@pytest.mark.parametrize("name", LOWERINGS)
def test_observed_collectives_are_the_lowering_contract(gate, name):
    """What each lowering issues in one observed step, by range and kind
    (two merge groups; the narrow ResNet-20 has batch statistics)."""
    per_group = {
        "all_reduce": ["all_reduce"],
        "rs_ag": ["reduce_scatter", "all_gather"],
        "rs_opt_ag": ["reduce_scatter", "all_gather"],
        "rs_fwd_ag": ["reduce_scatter", "all_gather"],
        "hier": ["reduce_scatter", "all_gather"],
        "topk": ["all_gather", "all_gather"],
    }[name]
    for out in gate:
        recs = _records(out, f"clean/{name}")
        g = int(out[f"clean/{name}/groups"])
        assert g == 2
        for gi in range(g):
            scope = f"mgwfbp_group{gi:04d}"
            assert [r[0] for r in recs if scope in r[3]] == per_group
        own = sorted(r[3][-1] for r in recs
                     if not any(s.startswith("mgwfbp_") for s in r[3]))
        want = ["bstats_reduce", "metrics_reduce"]
        if name in ("rs_opt_ag", "rs_fwd_ag"):
            want = ["bstats_reduce", "metrics_reduce", "sharded_clip_norm"]
        assert own == want
        dcn = [r for r in recs if any("dcngroup" in s for s in r[3])]
        if name == "hier":
            assert [r[0] for r in dcn] == ["all_reduce"] * int(
                out["clean/hier/dcn_groups"])
        else:
            assert dcn == []
        if name == "rs_fwd_ag":
            # the all-gathers of this step's update are the next forward's
            assert [r[4] for r in recs if r[0] == "all_gather"] == \
                ["next"] * g
        if name == "topk":
            idx = [r for r in recs if r[2] == "torch.int32"]
            assert len(idx) == g


@pytest.mark.parametrize("mutation,rule", [
    ("dropped", "SCH001"), ("wire_dtype", "SCH002"), ("layout", "SCH003"),
    ("extra", "SCH004"), ("payload", "SCH007"),
])
def test_mutation_gives_its_rule(gate, mutation, rule):
    for out in gate:
        assert rule in json.loads(str(out[f"mut/{mutation}/rules"]))
    if mutation != "layout":
        for out in gate:
            assert json.loads(str(out[f"mut/{mutation}/rules"])) == [rule]


def test_check_collectives_flags_a_dcn_range_off_hier(gate):
    """SCH009: the DCN range belongs to hier alone (a synthetic record
    beside the all_reduce reducer's real ones)."""
    import types

    layout = buckets.build_layout(
        [torch.empty(4, device="meta"), torch.empty(3, device="meta")],
        [[0, 1]])
    red = types.SimpleNamespace(
        layout=layout, comm_op="all_reduce", comm_dtype=None, world=2,
        sparse=False, schedule=types.SimpleNamespace(num_groups=1))
    ok = [Collective("all_reduce", 7, torch.float32, (0, 1),
                     ("mgwfbp_group0000",))]
    leaves = [torch.empty(4, device="meta"), torch.empty(3, device="meta")]
    assert check_collectives(ok, red, leaves) == []
    bad = ok + [Collective("all_reduce", 7, torch.float32, (0, 1),
                           ("mgwfbp_dcngroup0000",))]
    assert [f.rule_id for f in check_collectives(bad, red, leaves)] == \
        ["SCH009"]
