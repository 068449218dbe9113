"""skylint: AST-based static analysis for the repo's load-bearing invariants.

Run it over the tree::

    python -m repro_torch.analysis check src tests benchmarks examples
    python -m repro_torch.analysis check src --format=json

The engine (``engine.py``) is rule-agnostic: it loads files, indexes
``# skylint: disable=RULE`` pragmas (standalone comment = whole file,
trailing comment = that line; every pragma is audited, unknown ids are
findings), and hands each parsed module to every registered rule. The
repo-specific rules live in ``rules.py``; importing this package registers
them. Stdlib-only by design — CI runs it before installing anything.

This is the port's copy of ``repro/analysis``: the same rules, path scopes
and messages, so its report on any tree equals the reference's.
"""

from . import rules as _rules  # noqa: F401  (importing registers the rules)
from .engine import (
    CheckReport,
    Context,
    Finding,
    Pragma,
    Rule,
    active_rule_ids,
    active_rules,
    check,
    register,
)

__all__ = [
    "CheckReport",
    "Context",
    "Finding",
    "Pragma",
    "Rule",
    "active_rule_ids",
    "active_rules",
    "check",
    "register",
]
