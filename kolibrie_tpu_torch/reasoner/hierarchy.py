"""Hierarchical (multi-level) reasoning — experimental, mirrors the reference.

Port of ``kolibrie_tpu/reasoner/hierarchy.py`` (a copy, the imports rewritten; the
hierarchy takes a ``device`` for its reasoners).

Parity: ``datalog/src/reasoning_experimental.rs:17-306`` — four reasoning
levels (Base/Deductive/Abductive/MetaReasoning), each backed by its own
Reasoner; cross-level rules carry a priority and a list of dependency levels
whose combined fact sets seed the rule application; per-level certainty
scores for ``get_fact_certainty``.

Levels share one Dictionary so fact IDs are comparable across levels (the
reference uses per-level dictionaries and re-encodes strings on every call;
a shared dictionary is the columnar-store-friendly equivalent).
"""

from __future__ import annotations

import enum
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kolibrie_tpu_torch.backend import DeviceLike
from kolibrie_tpu_torch.core.dictionary import Dictionary
from kolibrie_tpu_torch.core.rule import Rule
from kolibrie_tpu_torch.core.terms import Term, TriplePattern
from kolibrie_tpu_torch.core.triple import Triple
from kolibrie_tpu_torch.reasoner.reasoner import Reasoner


class ReasoningLevel(enum.IntEnum):
    """reasoning_experimental.rs:18-23."""

    BASE = 0
    DEDUCTIVE = 1
    ABDUCTIVE = 2
    META_REASONING = 3


#: reasoning_experimental.rs:288-304 — certainty of the first (lowest) level
#: holding the fact; Base facts are most certain.
LEVEL_CERTAINTY = {
    ReasoningLevel.BASE: 1.0,
    ReasoningLevel.DEDUCTIVE: 0.9,
    ReasoningLevel.ABDUCTIVE: 0.6,
    ReasoningLevel.META_REASONING: 0.4,
}


@dataclass
class HierarchicalRule:
    """reasoning_experimental.rs:26-31."""

    rule: Rule
    level: ReasoningLevel
    priority: int = 0
    dependencies: List[ReasoningLevel] = field(default_factory=list)


class ReasoningHierarchy:
    """Four stacked knowledge graphs with cross-level rule propagation.
    Every level's reasoner runs on ``device`` (the CUDA card unless the
    caller passes another)."""

    def __init__(self, device: DeviceLike = None) -> None:
        self.dictionary = Dictionary()
        self.levels: Dict[ReasoningLevel, Reasoner] = {
            level: Reasoner(self.dictionary, device=device)
            for level in ReasoningLevel
        }
        self.cross_level_rules: List[HierarchicalRule] = []
        self.propagation_rules: List[HierarchicalRule] = []

    # ------------------------------------------------------------ build API

    def add_fact_at_level(
        self, level: ReasoningLevel, subject: str, predicate: str, object: str
    ) -> Triple:
        return self.levels[level].add_abox_triple(subject, predicate, object)

    def add_rule_at_level(
        self, level: ReasoningLevel, rule: Rule, priority: int = 0
    ) -> None:
        """Registers the rule both within the level's own reasoner and as a
        cross-level rule depending on Base (+ its own level)
        (reasoning_experimental.rs:61-80)."""
        self.levels[level].add_rule(rule)
        dependencies = [ReasoningLevel.BASE]
        if level != ReasoningLevel.BASE:
            dependencies.append(level)
        self.cross_level_rules.append(
            HierarchicalRule(rule, level, priority, dependencies)
        )

    def add_cross_level_rule(self, rule: HierarchicalRule) -> None:
        self.cross_level_rules.append(rule)

    # ------------------------------------------------------------ inference

    def hierarchical_inference(self) -> Dict[ReasoningLevel, List[Triple]]:
        """Per level in dependency order: in-level semi-naive closure, then
        cross-level rules targeting that level over the union of their
        dependency levels' facts (reasoning_experimental.rs:86-115)."""
        all_inferred: Dict[ReasoningLevel, List[Triple]] = {}
        for level in ReasoningLevel:
            kg = self.levels[level]
            before = kg.facts.triples_set()
            kg.infer_new_facts_semi_naive()
            inferred = [
                Triple(*t) for t in kg.facts.triples_set() - before
            ]
            inferred.extend(self._apply_cross_level_rules(level))
            all_inferred[level] = inferred
        return all_inferred

    def _apply_cross_level_rules(self, target: ReasoningLevel) -> List[Triple]:
        new_facts: List[Triple] = []
        applicable = sorted(
            (r for r in self.cross_level_rules if r.level == target),
            key=lambda r: -r.priority,
        )
        target_kg = self.levels[target]
        for hrule in applicable:
            available: List[Triple] = []
            for dep in hrule.dependencies:
                available.extend(self.levels[dep].facts)
            for fact in self._apply_rule_to_facts(hrule.rule, available):
                if not target_kg.facts.contains(*fact):
                    target_kg.insert_ground_triple(fact)
                    new_facts.append(fact)
        return new_facts

    def _apply_rule_to_facts(
        self, rule: Rule, facts: List[Triple]
    ) -> List[Triple]:
        """Direct 1- and 2-premise rule application over an explicit fact list
        (reasoning_experimental.rs:161-208), honoring NAF premises and
        filters against the same fact set."""
        out: List[Triple] = []
        seen = set()
        fact_set = {tuple(f) for f in facts}

        def emit(bindings: Dict[str, int]) -> None:
            if not self._guards_pass(rule, bindings, fact_set):
                return
            for conclusion in rule.conclusion:
                t = _construct(conclusion, bindings)
                if t is not None and tuple(t) not in seen:
                    seen.add(tuple(t))
                    out.append(t)

        if len(rule.premise) == 1:
            for fact in facts:
                bindings: Dict[str, int] = {}
                if _match_pattern(rule.premise[0], fact, bindings):
                    emit(bindings)
        elif len(rule.premise) == 2:
            for i, f1 in enumerate(facts):
                b1: Dict[str, int] = {}
                if not _match_pattern(rule.premise[0], f1, b1):
                    continue
                for j, f2 in enumerate(facts):
                    if i == j:
                        continue
                    bindings = dict(b1)
                    if _match_pattern(rule.premise[1], f2, bindings):
                        emit(bindings)
        else:
            warnings.warn(
                "cross-level rule application supports 1- and 2-premise "
                f"rules only; skipping rule with {len(rule.premise)} premises"
            )
        return out

    def _guards_pass(
        self, rule: Rule, bindings: Dict[str, int], fact_set
    ) -> bool:
        for neg in rule.negative_premise:
            t = _construct(neg, bindings)
            if t is not None and tuple(t) in fact_set:
                return False
        for f in rule.filters:
            if f.variable not in bindings:
                return False
            if not f.evaluate(bindings[f.variable], self.dictionary.decode):
                return False
        return True

    # ------------------------------------------------------------ query API

    def query_hierarchy(
        self,
        level: Optional[ReasoningLevel] = None,
        subject: Optional[str] = None,
        predicate: Optional[str] = None,
        object: Optional[str] = None,
    ) -> List[Tuple[ReasoningLevel, Triple]]:
        levels = [level] if level is not None else list(self.levels)
        results: List[Tuple[ReasoningLevel, Triple]] = []
        for lv in levels:
            for t in self.levels[lv].query_abox(subject, predicate, object):
                results.append((lv, t))
        return results

    def get_fact_certainty(self, fact: Triple) -> float:
        for level in ReasoningLevel:
            if self.levels[level].facts.contains(*fact):
                return LEVEL_CERTAINTY[level]
        return 0.0


def _match_pattern(
    pattern: TriplePattern, fact: Triple, bindings: Dict[str, int]
) -> bool:
    for term, fact_id in zip(pattern.terms(), fact):
        if term.is_variable:
            bound = bindings.get(term.value)
            if bound is None:
                bindings[term.value] = int(fact_id)
            elif bound != int(fact_id):
                return False
        elif term.is_constant:
            if int(term.value) != int(fact_id):
                return False
        else:  # quoted-triple premise terms unsupported here, as in the ref
            return False
    return True


def _construct(
    pattern: TriplePattern, bindings: Dict[str, int]
) -> Optional[Triple]:
    ids = []
    for term in pattern.terms():
        if term.is_variable:
            if term.value not in bindings:
                return None
            ids.append(bindings[term.value])
        elif term.is_constant:
            ids.append(int(term.value))
        else:
            return None
    return Triple(*ids)
