"""Backward chaining: depth-limited SLD-style resolution with unification.

Port of ``kolibrie_tpu/reasoner/backward.py`` (a copy, the imports rewritten).

Parity: ``datalog/src/reasoning/backward_chaining.rs`` — unification incl.
quoted-triple unification (:27-55), substitution, rule-variable renaming,
MAX_DEPTH=10 goal resolution (:148-206).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from kolibrie_tpu_torch.core.rule import Rule
from kolibrie_tpu_torch.core.terms import Term, TriplePattern
from kolibrie_tpu_torch.core.triple import Triple

MAX_DEPTH = 10

Subst = Dict[str, object]  # var name -> int id | Term (quoted)


def _walk(term: Term, subst: Subst) -> Term:
    while term.is_variable and term.value in subst:
        v = subst[term.value]
        term = v if isinstance(v, Term) else Term.constant(v)
    return term


def unify_terms(a: Term, b: Term, subst: Subst, quoted=None) -> Optional[Subst]:
    """Unify two terms under a substitution; supports nested quoted-triple
    unification (backward_chaining.rs:27-55): a constant quoted-triple ID can
    unify against a structural quoted pattern."""
    a = _walk(a, subst)
    b = _walk(b, subst)
    if a.is_variable:
        s = dict(subst)
        s[a.value] = b if b.is_quoted else (b.value if b.is_constant else Term.variable(b.value))
        if b.is_variable and b.value == a.value:
            return subst
        return s
    if b.is_variable:
        return unify_terms(b, a, subst, quoted)
    if a.is_constant and b.is_constant:
        return subst if a.value == b.value else None
    # structural quoted unification; resolve constant ids via the quoted store
    if a.is_quoted and b.is_constant and quoted is not None:
        inner = quoted.get(b.value)
        if inner is None:
            return None
        b = Term.quoted(
            TriplePattern(
                Term.constant(inner[0]), Term.constant(inner[1]), Term.constant(inner[2])
            )
        )
    if b.is_quoted and a.is_constant and quoted is not None:
        return unify_terms(b, a, subst, quoted)
    if a.is_quoted and b.is_quoted:
        s: Optional[Subst] = subst
        for ta, tb in zip(a.value.terms(), b.value.terms()):
            s = unify_terms(ta, tb, s, quoted)
            if s is None:
                return None
        return s
    return None


def unify_pattern_triple(
    pattern: TriplePattern, triple: Triple, subst: Subst, quoted=None
) -> Optional[Subst]:
    s: Optional[Subst] = subst
    for pt, tid in zip(pattern.terms(), triple):
        s = unify_terms(pt, Term.constant(tid), s, quoted)
        if s is None:
            return None
    return s


def _rename_rule(rule: Rule, counter: int) -> Rule:
    """Fresh variable names per resolution step (standardizing apart)."""

    def rn(term: Term) -> Term:
        if term.is_variable:
            return Term.variable(f"{term.value}__r{counter}")
        if term.is_quoted:
            return Term.quoted(TriplePattern(*(rn(t) for t in term.value.terms())))
        return term

    def rp(p: TriplePattern) -> TriplePattern:
        return TriplePattern(rn(p.subject), rn(p.predicate), rn(p.object))

    return Rule(
        premise=[rp(p) for p in rule.premise],
        negative_premise=[rp(p) for p in rule.negative_premise],
        filters=rule.filters,
        conclusion=[rp(c) for c in rule.conclusion],
    )


def _apply_subst(pattern: TriplePattern, subst: Subst) -> TriplePattern:
    def ap(term: Term) -> Term:
        t = _walk(term, subst)
        if t.is_quoted:
            return Term.quoted(TriplePattern(*(ap(x) for x in t.value.terms())))
        return t

    return TriplePattern(ap(pattern.subject), ap(pattern.predicate), ap(pattern.object))


def backward_chaining(
    reasoner, goal: TriplePattern, max_depth: int = MAX_DEPTH
) -> List[Subst]:
    """All substitutions proving ``goal`` from facts and rules."""
    counter = [0]

    def solve(goals: List[TriplePattern], subst: Subst, depth: int) -> List[Subst]:
        if not goals:
            return [subst]
        if depth > max_depth:
            return []
        goal, rest = goals[0], goals[1:]
        goal = _apply_subst(goal, subst)
        results: List[Subst] = []
        # fact resolution (indexed scan on bound positions)
        consts = [
            t.value if t.is_constant else None for t in goal.terms()
        ]
        s, p, o = reasoner.facts.match(
            s=consts[0] if not goal.subject.is_quoted else None,
            p=consts[1] if not goal.predicate.is_quoted else None,
            o=consts[2] if not goal.object.is_quoted else None,
        )
        for i in range(len(s)):
            t = Triple(int(s[i]), int(p[i]), int(o[i]))
            s2 = unify_pattern_triple(goal, t, subst, reasoner.quoted)
            if s2 is not None:
                results.extend(solve(rest, s2, depth))
        # rule resolution
        for rule in reasoner.rules:
            renamed = _rename_rule(rule, counter[0])
            counter[0] += 1
            for concl in renamed.conclusion:
                s2: Optional[Subst] = dict(subst)
                ok = True
                for gt, ct in zip(goal.terms(), concl.terms()):
                    s2 = unify_terms(gt, ct, s2, reasoner.quoted)
                    if s2 is None:
                        ok = False
                        break
                if not ok:
                    continue
                results.extend(solve(renamed.premise + rest, s2, depth + 1))
        return results

    raw = solve([goal], {}, 0)
    # project to the goal's own variables, dedup
    goal_vars = goal.variables()
    out: List[Subst] = []
    seen = set()
    for s in raw:
        proj = {}
        for v in goal_vars:
            val = _walk(Term.variable(v), s)
            proj[v] = val.value if val.is_constant else None
        key = tuple(sorted(proj.items(), key=lambda kv: kv[0]))
        if key not in seen:
            seen.add(key)
            out.append(proj)
    return out
