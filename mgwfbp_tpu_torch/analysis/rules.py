"""Rule registry and findings of the port's schedule verifier (a copy of
the schedule part of ``mgwfbp_tpu/analysis/rules.py``).

The rule ids, severities and summaries are the JAX package's, for the
rules ``analysis.schedule_check`` checks on one observed torch step:
SCH001-SCH004, SCH007 and SCH009. SCH005 (host callbacks), SCH006
(donated buffers), SCH008 (the guard's traced form) and SCH010 (the
health statistics' traced footprint) are properties of a traced program
with no counterpart on one eager step; they, the AST rule families and the
suppression syntax stay with ROADMAP.md Queue 1 item 9. Findings print as
``file:line RULE message``; a step's findings carry line 0 (the whole
step).
"""

from __future__ import annotations

import dataclasses

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    severity: str  # ERROR | WARNING
    summary: str


@dataclasses.dataclass(frozen=True)
class Finding:
    file: str
    line: int  # 1-based; 0 = whole-step finding
    rule_id: str
    message: str

    @property
    def rule(self) -> Rule:
        return RULES[self.rule_id]

    @property
    def severity(self) -> str:
        return self.rule.severity

    def format(self) -> str:
        return f"{self.file}:{self.line} {self.rule_id} {self.message}"


RULES: dict[str, Rule] = {}


def _register(id: str, severity: str, summary: str) -> Rule:
    if id in RULES:
        raise ValueError(f"duplicate rule id {id!r}")
    r = Rule(id, severity, summary)
    RULES[id] = r
    return r


_register("SCH001", ERROR,
          "merged-collective count differs from MergeSchedule.num_groups")
_register("SCH002", ERROR,
          "bucket collective dtype differs from the layout's bucket dtype")
_register("SCH003", ERROR,
          "bucket layout does not cover every gradient leaf exactly once")
_register("SCH004", ERROR,
          "unexpected collective in the hot path")
_register("SCH007", ERROR,
          "bucket collective payload size differs from the layout's group size")
_register("SCH009", ERROR,
          "hierarchical (hier) nested-schedule contract violated: inner "
          "RS/AG leg shape, DCN-group collective count/payload/dtype, or "
          "a cross-pod collective outside its declared scope")
