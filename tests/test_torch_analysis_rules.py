"""The port's rule registry and annotation grammar
(``mgwfbp_tpu_torch.analysis.rules``) against the JAX package's.

Ids, severities and family bits must equal the JAX registry's; summaries
too, except the rules whose meaning moves to torch (``TORCH_SUMMARIES``,
each with its reason) and ANA001, which names the port's marker prefix.
Exit-code composition must equal the JAX ``exit_code`` on the same finding
lists, and the marker grammar must parse each ``# mgwfbp:`` line as the
JAX grammar parses its prefix-swapped twin (the JAX prefix is read from
the JAX module's own pattern)."""

from __future__ import annotations

import re

import pytest

from mgwfbp_tpu.analysis import rules as jax_rules
from mgwfbp_tpu_torch.analysis import rules as port_rules

JAX_PREFIX = re.search(r"#\\s\*(\w+):", jax_rules._NOQA.pattern).group(1)


def _jax_twin(line: str) -> str:
    return line.replace("mgwfbp:", f"{JAX_PREFIX}:")


def test_registry_ids_severities_and_families_equal_jax():
    assert list(port_rules.RULES) == list(jax_rules.RULES)
    for rid, rule in jax_rules.RULES.items():
        assert port_rules.RULES[rid].severity == rule.severity, rid
        assert (port_rules.family(rid) == jax_rules.family(rid)), rid
    assert port_rules.FAMILY_BITS == jax_rules.FAMILY_BITS == {
        "JIT": 1, "SCH": 2, "RUN": 4, "ANA": 8, "TRC": 16, "THR": 32}
    assert {port_rules.family(r) for r in port_rules.RULES} == set(
        port_rules.FAMILY_BITS)


def test_summaries_equal_jax_except_the_listed_set():
    moved = port_rules.TORCH_SUMMARIES
    assert set(moved) == {"JIT002", "JIT004", "SCH005", "SCH006", "TRC000"}
    assert all(reason.strip() for reason in moved.values())
    for rid, rule in jax_rules.RULES.items():
        port = port_rules.RULES[rid].summary
        if rid in moved:
            assert port != rule.summary, rid
        elif rid == "ANA001":
            assert port != rule.summary
            assert port == rule.summary.replace(f"# {JAX_PREFIX}:",
                                                "# mgwfbp:")
        else:
            assert port == rule.summary, rid
    assert port_rules.RULES["SCH005"].summary == (
        "host synchronisation in the hot path")
    assert port_rules.RULES["SCH006"].summary == "state not updated in place"


_LISTS = [
    [],
    [("JIT001",), ("RUN003",)],
    [("SCH004",)],
    [("ANA001",)],
    [("TRC000",)],
    [("THR002",), ("RUN001",)],
    [("JIT004",)],
    [("JIT004",), ("SCH010",), ("THR005",), ("ANA001",), ("TRC000",)],
    [(rid,) for rid in jax_rules.RULES],
]


@pytest.mark.parametrize("ids", _LISTS, ids=[
    "empty", "jit_run", "sch", "ana", "trc", "thr_run", "warning_only",
    "mixed", "every_rule"])
@pytest.mark.parametrize("warnings_as_errors", [False, True])
def test_exit_code_composition_equals_jax(ids, warnings_as_errors):
    port = [port_rules.Finding("a.py", i, rid, "m")
            for i, (rid,) in enumerate(ids)]
    jax = [jax_rules.Finding("a.py", i, rid, "m")
           for i, (rid,) in enumerate(ids)]
    assert port_rules.exit_code(port, warnings_as_errors) == (
        jax_rules.exit_code(jax, warnings_as_errors))
    assert port_rules.has_errors(port) == jax_rules.has_errors(jax)


def test_family_exit_codes_compose():
    F = port_rules.Finding
    assert port_rules.exit_code([F("a.py", 1, "JIT001", "m"),
                                 F("a.py", 2, "RUN003", "m")]) == 5
    assert port_rules.exit_code([F("a.py", 1, "SCH004", "m")]) == 2
    assert port_rules.exit_code([F("a.py", 1, "ANA001", "m")]) == 8
    assert port_rules.exit_code([F("<step>", 0, "TRC000", "m")]) == 16
    assert port_rules.exit_code([F("a.py", 1, "THR001", "m")]) == 32
    assert port_rules.exit_code([F("a.py", 1, "JIT004", "m")]) == 0
    assert port_rules.exit_code([F("a.py", 1, "JIT004", "m")],
                                warnings_as_errors=True) == 1


_LINES = [
    "x = 1",
    "x = 1  # mgwfbp: noqa",
    "x = 1  # mgwfbp: noqa[RUN004]",
    "x = 1  # mgwfbp: noqa[RUN004] -- the cache is best-effort",
    "x = 1  #mgwfbp:noqa[JIT001,SCH004]",
    "x = 1  # mgwfbp: noqa[ RUN003 , RUN006 ] -- both",
    "x = 1  # mgwfbp: noqa -- bare with a reason",
    "if ready:  # mgwfbp: group-uniform -- derived from config",
    "if ready:  # mgwfbp: group-uniform",
    "# mgwfbp: group-uniform -- own-line form",
    "self.x = 1  # mgwfbp: thread-safe -- GIL-atomic store",
    "self.x = 1  # mgwfbp: thread-safe",
    "# mgwfbp: thread-safe-ish -- not the marker word",
    "x = 1  # noqa: F401",
    "x = 1  # mgwfbp: noqa[RUN003]--tight",
]


@pytest.mark.parametrize("line", _LINES)
def test_marker_grammar_parses_as_the_jax_twin(line):
    twin = _jax_twin(line)
    assert port_rules.suppressed_ids(line) == jax_rules.suppressed_ids(twin)
    assert port_rules.has_reason(line) == jax_rules.has_reason(twin)
    assert port_rules.has_group_uniform_marker(line) == (
        jax_rules.has_group_uniform_marker(twin))
    assert port_rules.has_thread_safe_marker(line) == (
        jax_rules.has_thread_safe_marker(twin))
    # the JAX grammar does not read the port's prefix, nor the port the JAX
    assert port_rules.suppressed_ids(twin) is None
    if "mgwfbp:" in line:
        assert jax_rules.suppressed_ids(line) is None


def test_comment_lines_and_filter_suppressed_equal_jax():
    src = (
        "def f():\n"
        '    """quotes `# mgwfbp: noqa[RUN003]` in a docstring"""\n'
        "    x = 1  # mgwfbp: noqa[JIT001]\n"
        "    return x  # mgwfbp: noqa\n"
    )
    twin = _jax_twin(src)
    assert {k: _jax_twin(v) for k, v in
            port_rules.comment_lines(src).items()} == (
        jax_rules.comment_lines(twin))
    port = [port_rules.Finding("m.py", ln, rid, "m")
            for ln, rid in ((3, "JIT001"), (3, "JIT003"), (4, "RUN001"),
                            (2, "RUN003"))]
    jax = [jax_rules.Finding(f.file, f.line, f.rule_id, f.message)
           for f in port]
    tr, jtr = port_rules.SuppressionTracker(), jax_rules.SuppressionTracker()
    kept = port_rules.filter_suppressed(port, src.splitlines(), tr)
    jkept = jax_rules.filter_suppressed(jax, twin.splitlines(), jtr)
    assert [(f.line, f.rule_id) for f in kept] == [
        (f.line, f.rule_id) for f in jkept]
    assert tr.used == jtr.used
