"""Datalog rules: premises, negation-as-failure premises, filters, multi-head
conclusions, and the rule-safety check for negation.

Parity: ``shared/src/rule.rs:14-57`` (``Rule``, ``FilterCondition``,
``check_rule_safety``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Set

from kolibrie_tpu_torch.core.terms import TriplePattern


@dataclass
class FilterCondition:
    """Numeric/ID comparison on a rule variable: ``variable <op> value``.

    ``value`` may be a dictionary ID (term equality) or a float (numeric
    comparison after literal decode).
    """

    variable: str
    operator: str  # "=", "!=", "<", "<=", ">", ">="
    value: object  # int term-id or float

    def evaluate(self, binding_id: int, decode=None) -> bool:
        op = self.operator
        if op == "=" and isinstance(self.value, int):
            return binding_id == self.value
        if op == "!=" and isinstance(self.value, int):
            return binding_id != self.value
        # ordering (or float-valued) comparison: requires a numeric literal;
        # non-numeric bindings are rejected, never compared by raw intern ID
        if decode is None:
            return False
        num = _literal_to_float(decode(binding_id))
        if num is None:
            return False
        try:
            v = float(self.value)  # type: ignore[arg-type]
        except (TypeError, ValueError):
            return False
        return _cmp(num, op, v)


def _cmp(a, op, b) -> bool:
    if op == "=":
        return a == b
    if op == "!=":
        return a != b
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    if op == ">=":
        return a >= b
    raise ValueError(f"unknown operator {op!r}")


def _literal_to_float(s: Optional[str]) -> Optional[float]:
    if s is None:
        return None
    if s.startswith('"'):
        end = s.rfind('"')
        if end > 0:
            s = s[1:end]
    try:
        return float(s)
    except ValueError:
        return None


@dataclass
class Rule:
    """A datalog rule: ``conclusion :- premise, not negative_premise, filters``.

    Multi-head: ``conclusion`` is a list of patterns all derived per match.
    """

    premise: List[TriplePattern] = field(default_factory=list)
    negative_premise: List[TriplePattern] = field(default_factory=list)
    filters: List[FilterCondition] = field(default_factory=list)
    conclusion: List[TriplePattern] = field(default_factory=list)

    def head_variables(self) -> Set[str]:
        out: Set[str] = set()
        for c in self.conclusion:
            out |= c.variables()
        return out

    def positive_variables(self) -> Set[str]:
        out: Set[str] = set()
        for p in self.premise:
            out |= p.variables()
        return out

    def negative_variables(self) -> Set[str]:
        out: Set[str] = set()
        for p in self.negative_premise:
            out |= p.variables()
        return out


def check_rule_safety(rule: Rule) -> bool:
    """A rule is safe iff every variable in the head and every variable in a
    negated premise also occurs in a positive premise
    (``shared/src/rule.rs`` ``check_rule_safety``)."""
    pos = rule.positive_variables()
    if not rule.head_variables() <= pos:
        return False
    if not rule.negative_variables() <= pos:
        return False
    return True
