"""The port's SPMD lockstep checker (``mgwfbp_tpu_torch.analysis.spmd_check``)
against the JAX package's (``mgwfbp_tpu.analysis.spmd_check``).

Twins of tests/test_spmd_check.py: every marker-free snippet goes through
both checkers and the (rule id, line) sets must be equal, and equal to the
rule the JAX suite expects; every marker test runs with the port's
``# mgwfbp:`` prefix through the port's checker; static discovery equals
``coordination.GROUP_OPS`` at runtime; the shipped port tree is clean and
fast. Then the port's own retargeting (a world-size attribute, the
``dist.is_initialized()`` guard, the torch identity variables) and the
repairs the port's protocol needed, each shown on a snippet cut from the
code before it."""

from __future__ import annotations

import time

import pytest

from mgwfbp_tpu.analysis import spmd_check as jax_spmd
from mgwfbp_tpu_torch.analysis import spmd_check as port_spmd
from mgwfbp_tpu_torch.analysis.rules import SuppressionTracker

IMPORT = "from mgwfbp_tpu_torch.runtime import coordination as coord\n"


def _ids(findings):
    return [f.rule_id for f in findings]


def _check(src: str, serving: dict | None = None, tracker=None):
    return port_spmd.check_sources(
        {"mod.py": IMPORT + src}, serving_sources=serving, tracker=tracker)


def _both(src: str, serving: dict | None = None):
    """(JAX, port) (rule id, line) sets of one snippet."""
    sources = {"mod.py": IMPORT + src}
    j = jax_spmd.check_sources(sources, serving_sources=serving)
    p = port_spmd.check_sources(sources, serving_sources=serving)
    return ({(f.rule_id, f.line) for f in j},
            {(f.rule_id, f.line) for f in p})


_SERVING_SHARED = {"serve.py": (
    "class Handler:\n"
    "    def do_GET(self):\n"
    "        with self._state_lock:\n"
    "            x = 1\n"
)}
_SERVING_OTHER = {"serve.py": (
    "class Handler:\n"
    "    def do_GET(self):\n"
    "        with self._other_lock:\n"
    "            x = 1\n"
)}

# name -> (source, the rule ids the JAX suite expects, serving sources)
SNIPPETS = {
    "run001_op_control_dependent_on_local": (
        "def f():\n"
        "    if coord.is_primary():\n"
        "        coord.barrier('x')\n", ["RUN001"], None),
    "run001_process_index_comparison_and_local_var": (
        "def f():\n"
        "    primary = coord.process_index() == 0\n"
        "    if primary:\n"
        "        coord.agree_any(True)\n", ["RUN001"], None),
    "run001_clean_when_local_is_data_not_control": (
        "def f(local_flag):\n"
        "    agreed = coord.agree_any(local_flag)\n"
        "    if agreed:\n"
        "        coord.barrier('drain')\n", [], None),
    "run002_arm_sequence_mismatch": (
        "def f(mode):\n"
        "    if mode:\n"
        "        coord.agree_any(True)\n"
        "    else:\n"
        "        coord.agree_all(True)\n", ["RUN002"], None),
    "run002_clean_when_arms_match": (
        "def f(mode):\n"
        "    if mode:\n"
        "        x = 1\n"
        "        coord.agree_any(True)\n"
        "    else:\n"
        "        x = 2\n"
        "        coord.agree_any(False)\n"
        "    return x\n", [], None),
    "run003_early_return_skips_barrier": (
        "def f(ready):\n"
        "    if not ready:\n"
        "        return None\n"
        "    coord.barrier('commit')\n", ["RUN003"], None),
    "run003_continue_skips_op_in_loop": (
        "def f(items):\n"
        "    for it in items:\n"
        "        if it is None:\n"
        "            continue\n"
        "        coord.gather_values(1.0)\n", ["RUN003"], None),
    "run003_clean_when_exit_is_balanced": (
        "def f(ready):\n"
        "    if not ready:\n"
        "        coord.barrier('commit')\n"
        "        return None\n"
        "    coord.barrier('commit')\n"
        "    return 1\n", [], None),
    "run004_primary_write_without_commit_barrier": (
        "import json, os\n"
        "def f(doc, path):\n"
        "    if coord.is_primary():\n"
        "        with open(path, 'w') as fh:\n"
        "            json.dump(doc, fh)\n", ["RUN004"], None),
    "run004_clean_with_commit_barrier": (
        "import json, os\n"
        "def f(doc, path):\n"
        "    if coord.is_primary():\n"
        "        with open(path, 'w') as fh:\n"
        "            json.dump(doc, fh)\n"
        "    coord.barrier('commit')\n", [], None),
    "run004_exonerated_when_every_caller_commits": (
        "import json\n"
        "def write_sidecar(doc):\n"
        "    if not coord.is_primary():\n"
        "        return\n"
        "    with open('idx', 'w') as fh:\n"
        "        json.dump(doc, fh)\n"
        "def save(doc):\n"
        "    write_sidecar(doc)\n"
        "    coord.barrier('commit')\n", [], None),
    "run005_swallowed_group_op_failure": (
        "def f():\n"
        "    try:\n"
        "        coord.barrier('sync')\n"
        "    except Exception:\n"
        "        pass\n", ["RUN005"], None),
    "run005_clean_when_handler_reraises": (
        "def f():\n"
        "    try:\n"
        "        coord.barrier('sync')\n"
        "    except Exception as e:\n"
        "        raise RuntimeError('group broken') from e\n", [], None),
    "run005_clean_when_no_op_in_try": (
        "import json\n"
        "def f(path):\n"
        "    try:\n"
        "        with open(path) as fh:\n"
        "            return json.load(fh)\n"
        "    except Exception:\n"
        "        return None\n", [], None),
    "run006_op_under_serving_lock": (
        "def f(self):\n"
        "    with self._state_lock:\n"
        "        coord.barrier('sync')\n", ["RUN006"], _SERVING_SHARED),
    "run006_clean_for_unshared_lock": (
        "def f(self):\n"
        "    with self._step_lock:\n"
        "        coord.barrier('sync')\n", [], _SERVING_OTHER),
    "non_uniform_result_op_does_not_sanitize": (
        "def f():\n"
        "    x = coord.barrier('a')\n"
        "    if x:\n"
        "        coord.agree_all(True)\n", ["RUN002"], None),
    "multihost_short_circuit_is_resolved": (
        "def f():\n"
        "    if coord.process_count() == 1:\n"
        "        return True\n"
        "    return coord.agree_any(True)\n", [], None),
    "trainer_snippet_divergent_drain": (
        "class Trainer:\n"
        "    def __init__(self):\n"
        "        self._preempt_signal = None\n"
        "    def step_loop(self, epoch):\n"
        "        if self._preempt_signal is not None:\n"
        "            coord.barrier('drain')\n"
        "            raise SystemExit(75)\n", ["RUN001"], None),
    "trainer_snippet_agreed_drain_is_clean": (
        "class Trainer:\n"
        "    def __init__(self):\n"
        "        self._preempt_signal = None\n"
        "    def _agreed_preempt(self):\n"
        "        local = self._preempt_signal is not None\n"
        "        if coord.process_count() == 1:\n"
        "            return local\n"
        "        return coord.agree_any(local)\n"
        "    def step_loop(self, epoch):\n"
        "        if self._agreed_preempt():\n"
        "            coord.barrier('drain')\n"
        "            raise SystemExit(75)\n", [], None),
    "checkpoint_snippet_skipped_commit_barrier": (
        "import os\n"
        "class Ckpt:\n"
        "    def _commit_barrier(self, step):\n"
        "        if coord.process_count() > 1:\n"
        "            coord.barrier('commit')\n"
        "    def save(self, step, files):\n"
        "        if os.path.exists(f'steps/{step}'):\n"
        "            return\n"
        "        coord.barrier('payload')\n"
        "        self._commit_barrier(step)\n", ["RUN001"], None),
    "checkpoint_snippet_agreed_dedup_is_clean": (
        "import os\n"
        "class Ckpt:\n"
        "    def _commit_barrier(self, step):\n"
        "        if coord.process_count() > 1:\n"
        "            coord.barrier('commit')\n"
        "    def save(self, step, files):\n"
        "        already = os.path.exists(f'steps/{step}')\n"
        "        if coord.process_count() > 1:\n"
        "            already = coord.agree_all(already)\n"
        "        if already:\n"
        "            self._commit_barrier(step)\n"
        "            return\n"
        "        coord.barrier('payload')\n"
        "        self._commit_barrier(step)\n", [], None),
    "checkpoint_snippet_swallowed_commit_barrier": (
        "class Ckpt:\n"
        "    def save(self, step):\n"
        "        try:\n"
        "            coord.barrier(f'ckpt_commit_{step}')\n"
        "        except RuntimeError:\n"
        "            self.log = 'commit barrier failed; continuing'\n",
        ["RUN005"], None),
}


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_marker_free_snippet_parity(name):
    src, expected, serving = SNIPPETS[name]
    jax_set, port_set = _both(src, serving)
    assert port_set == jax_set, (port_set, jax_set)
    assert sorted(r for r, _ in port_set) == sorted(expected)


# -- @group_op discovery / registry round-trip --------------------------------


def test_group_ops_discovered_from_decorations():
    ops = port_spmd.discover_group_ops()
    assert set(ops) == set(jax_spmd.discover_group_ops()) == {
        "agree_any", "agree_all", "agree_uniform", "broadcast_flag",
        "gather_values", "gather_vectors", "all_argmin", "barrier",
    }
    assert ops["barrier"].uniform_result is False
    assert ops["agree_any"].uniform_result is True
    assert all(op.blocking for op in ops.values())


def test_static_discovery_matches_runtime_registry():
    from mgwfbp_tpu_torch.runtime import coordination

    ops = port_spmd.discover_group_ops()
    assert set(ops) == set(coordination.GROUP_OPS)
    for name, meta in coordination.GROUP_OPS.items():
        assert ops[name].blocking == meta["blocking"], name
        assert ops[name].uniform_result == meta["uniform_result"], name


def test_new_primitive_round_trip(tmp_path):
    transport = tmp_path / "coordination.py"
    transport.write_text(
        "GROUP_OPS = {}\n"
        "def group_op(fn=None, *, blocking=True, uniform_result=True):\n"
        "    def reg(f):\n"
        "        GROUP_OPS[f.__name__] = {}\n"
        "        return f\n"
        "    return reg(fn) if fn is not None else reg\n"
        "@group_op\n"
        "def agree_sum(x):\n"
        "    return x\n"
    )
    assert "agree_sum" in port_spmd.discover_group_ops(str(transport))
    src = {"mod.py": IMPORT + (
        "def f():\n"
        "    if coord.is_primary():\n"
        "        coord.agree_sum(1.0)\n"
    )}
    port = port_spmd.check_sources(src, transport_path=str(transport))
    jax = jax_spmd.check_sources(src, transport_path=str(transport))
    assert _ids(port) == _ids(jax) == ["RUN001"]
    assert "agree_sum" in port[0].message


# -- markers, with the port's prefix ----------------------------------------


def test_run003_group_uniform_annotation_clears_and_is_consumed():
    tracker = SuppressionTracker()
    findings = _check(
        "def f(ready):\n"
        "    if not ready:  # mgwfbp: group-uniform -- derived from config\n"
        "        return None\n"
        "    coord.barrier('commit')\n",
        tracker=tracker,
    )
    assert findings == []
    assert tracker.uniform_used
    assert tracker.unused_findings() == []


@pytest.mark.parametrize("src,expect", [
    ("def f():\n"
     "    x = 1  # mgwfbp: noqa[RUN003] -- stale\n"
     "    return x\n", "RUN003"),
    ("def f(ready):\n"
     "    if not ready:\n"
     "        return None  # mgwfbp: noqa[RUN003,RUN006] -- only 003 fires\n"
     "    coord.barrier('commit')\n", "RUN006"),
    ("def f(ready):\n"
     "    if not ready:\n"
     "        return None  # mgwfbp: noqa[RUN003]\n"
     "    coord.barrier('commit')\n", "without a reason"),
    ("def f():\n"
     "    x = 1  # mgwfbp: group-uniform -- nothing consults this\n"
     "    return x\n", "never consulted"),
], ids=["dead_noqa", "partially_dead_noqa", "reasonless_run_noqa",
        "unconsumed_group_uniform"])
def test_ana001_accounting(src, expect):
    tracker = SuppressionTracker()
    assert _check(src, tracker=tracker) == []
    dead = tracker.unused_findings()
    assert _ids(dead) == ["ANA001"], [f.format() for f in dead]
    assert expect in dead[0].message


def test_ana001_docstring_grammar_mentions_do_not_register():
    tracker = SuppressionTracker()
    findings = _check(
        'def f():\n'
        '    """Docs quoting `# mgwfbp: noqa[RUN003]` and\n'
        '    `# mgwfbp: group-uniform -- reason` are not markers."""\n'
        '    return 1\n',
        tracker=tracker,
    )
    assert findings == []
    assert tracker.unused_findings() == []


# -- the shipped port tree -------------------------------------------------------


def test_shipped_tree_is_clean_and_fast():
    tracker = SuppressionTracker()
    t0 = time.perf_counter()
    findings = port_spmd.check_paths(tracker=tracker)
    dt = time.perf_counter() - t0
    assert findings == [], [f.format() for f in findings]
    assert dt < 30.0, f"RUN pass took {dt:.1f}s"
    dead = [f for f in tracker.unused_findings()
            if "thread-safe" not in f.message]
    assert dead == [], [f.format() for f in dead]
    # the port's protocol carries its facts as group-uniform markers
    assert tracker.uniform_used


def test_default_targets_resolve_against_the_port():
    import os

    root = port_spmd._PKG_ROOT
    assert root.endswith("mgwfbp_tpu_torch")
    assert port_spmd.TRANSPORT_PATH == os.path.join(
        root, "runtime", "coordination.py")
    for rel in port_spmd.DEFAULT_TARGETS + port_spmd.DEFAULT_SERVING:
        assert os.path.exists(os.path.join(root, rel)), rel


# -- the port's retargeting ------------------------------------------------------


@pytest.mark.parametrize("src", [
    # the trainer's world attribute (``self.world = world_size()``)
    "class T:\n"
    "    def __init__(self):\n"
    "        self.world = world_size()\n"
    "    def probe(self):\n"
    "        if self.world == 1:\n"
    "            return\n"
    "        coord.gather_values(1.0)\n",
    # the torch world size
    "import torch.distributed as dist\n"
    "def probe():\n"
    "    if dist.get_world_size() == 1:\n"
    "        return\n"
    "    coord.gather_values(1.0)\n",
    # the guard on an initialized group
    "import torch.distributed as dist\n"
    "def probe():\n"
    "    if not dist.is_initialized():\n"
    "        return\n"
    "    coord.barrier('x')\n",
], ids=["world_attribute", "get_world_size", "is_initialized"])
def test_single_process_paths_resolve_to_the_multi_process_arm(src):
    assert _check(src) == []


def test_world_attribute_assigned_elsewhere_stays_unknown():
    # an attribute that is ever assigned something other than a process
    # count is not resolved: the early return is still RUN003
    assert _ids(_check(
        "class T:\n"
        "    def __init__(self, n):\n"
        "        self.world = world_size()\n"
        "    def set(self, n):\n"
        "        self.world = n\n"
        "    def probe(self):\n"
        "        if self.world == 1:\n"
        "            return\n"
        "        coord.gather_values(1.0)\n")) == ["RUN003"]


@pytest.mark.parametrize("src", [
    "import os\n"
    "def f():\n"
    "    if os.environ.get('LOCAL_RANK') == '0':\n"
    "        coord.barrier('x')\n",
    "import os\n"
    "def f():\n"
    "    if os.environ.get('OMPI_COMM_WORLD_LOCAL_RANK') == '0':\n"
    "        coord.barrier('x')\n",
    "import torch.distributed as dist\n"
    "def f():\n"
    "    if dist.get_rank() == 0:\n"
    "        coord.barrier('x')\n",
], ids=["LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK", "get_rank"])
def test_torch_identity_sources_are_local(src):
    assert _ids(_check(src)) == ["RUN001"]


# -- repairs, each on a snippet cut from the code before it ---------------------

# the parent's agree cadence: read through a helper whose env key is a
# parameter, so the checker could not see that MGWFBP_AGREE_INTERVAL is
# group-uniform, and every cadence-gated early return was RUN003
_CADENCE_BEFORE = (
    "import os\n"
    "def _env_interval(name, default):\n"
    "    raw = (os.environ.get(name) or '').strip()\n"
    "    return max(int(raw or default), 1)\n"
    "class Trainer:\n"
    "    def __init__(self):\n"
    "        self.iteration = 0  # mgwfbp: group-uniform -- lockstep counter\n"
    "        self._agree_interval = _env_interval('MGWFBP_AGREE_INTERVAL', '1')\n"
    "    def _maybe_straggler_probe(self):\n"
    "        if self.iteration % self._agree_interval != 0:\n"
    "            return\n"
    "        coord.gather_values(1.0)\n"
)
_CADENCE_AFTER = _CADENCE_BEFORE.replace(
    "        self._agree_interval = _env_interval('MGWFBP_AGREE_INTERVAL', '1')\n",
    "        raw_interval = (\n"
    "            os.environ.get('MGWFBP_AGREE_INTERVAL') or '').strip()\n"
    "        self._agree_interval = max(int(raw_interval or '1'), 1)\n",
)


def test_repair_agree_cadence_read_inline():
    before = _check(_CADENCE_BEFORE)
    assert _ids(before) == ["RUN003"]
    assert before[0].line == 1 + (IMPORT + _CADENCE_BEFORE).splitlines(
    ).index("            return")
    assert _check(_CADENCE_AFTER) == []
    # the shipped trainer reads the cadence inline
    import inspect

    from mgwfbp_tpu_torch.train import trainer

    assert "_env_interval" not in inspect.getsource(trainer)
