"""Rule index: maps (wildcarded) premise patterns to rule IDs for delta-driven
rule matching in the parallel semi-naive strategy.

Parity: ``shared/src/rule_index.rs:19-227`` — six-permutation wildcard index
with ``WILDCARD = u32::MAX``; ``query_candidate_rules(triple)`` returns the
rules having a premise that could match the triple.

Rebuild note: rather than six permutations of nested maps we key a flat dict on
the 8 wildcard masks of each premise (constant positions keep their ID,
variable positions become WILDCARD); candidate lookup probes the 8 masked
variants of the delta triple — same asymptotics, one dict.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from kolibrie_tpu_torch.core.rule import Rule
from kolibrie_tpu_torch.core.terms import Term

WILDCARD = 0xFFFF_FFFF


def _premise_key(pattern) -> Tuple[int, int, int]:
    def pos(term: Term) -> int:
        if term.is_constant:
            return term.value
        return WILDCARD  # variables and quoted patterns match by wildcard

    return (pos(pattern.subject), pos(pattern.predicate), pos(pattern.object))


class RuleIndex:
    __slots__ = ("_by_key", "_rules")

    def __init__(self) -> None:
        self._by_key: Dict[Tuple[int, int, int], Set[int]] = {}
        self._rules: List[Rule] = []

    def __len__(self) -> int:
        return len(self._rules)

    @property
    def rules(self) -> List[Rule]:
        return self._rules

    def add_rule(self, rule: Rule) -> int:
        rid = len(self._rules)
        self._rules.append(rule)
        for prem in rule.premise:
            key = _premise_key(prem)
            self._by_key.setdefault(key, set()).add(rid)
        return rid

    def query_candidate_rules(self, s: int, p: int, o: int) -> List[int]:
        """Rule IDs with a premise whose wildcard pattern admits (s, p, o)."""
        w = WILDCARD
        out: Set[int] = set()
        get = self._by_key.get
        for key in (
            (s, p, o),
            (s, p, w),
            (s, w, o),
            (w, p, o),
            (s, w, w),
            (w, p, w),
            (w, w, o),
            (w, w, w),
        ):
            hit = get(key)
            if hit:
                out |= hit
        return sorted(out)
