"""Schedule verification of the port (counterpart of the
``mgwfbp_tpu.analysis`` package's schedule rules): ``schedule_check``
observes one real step of a live reducer at the process-group level and
checks its collectives against the merge schedule, under the JAX package's
rule ids (``rules``). The autotuner gates every raced candidate on it.
The JAX package's AST passes (JIT, RUN, THR, ANA) and the rules that check
traced-program properties (SCH005, SCH006, SCH008, SCH010) are ROADMAP.md
Queue 1 item 9."""

from mgwfbp_tpu_torch.analysis.rules import (  # noqa: F401
    ERROR,
    RULES,
    WARNING,
    Finding,
    Rule,
)
