"""The port's host reasoner API against the JAX package, on the CPU:
backward chaining, constraints and repairs (IAR queries, the repair-
guarded closure), hierarchical reasoning and the DOT export
(``tests/test_reasoner.py`` :474-506 and ``tests/test_hierarchy_dot_errors.py``),
each run by both packages on the same state."""

from __future__ import annotations

import warnings

import pytest

from kolibrie_tpu.core.terms import Term as JTerm
from kolibrie_tpu.core.terms import TriplePattern as JPattern
from kolibrie_tpu.reasoner import HierarchicalRule as JHRule
from kolibrie_tpu.reasoner import ReasoningHierarchy as JHierarchy
from kolibrie_tpu.reasoner import ReasoningLevel as JLevel
from kolibrie_tpu.reasoner import to_dot as j_to_dot
from kolibrie_tpu.reasoner.reasoner import Reasoner as JaxReasoner
from kolibrie_tpu_torch.reasoner import (
    HierarchicalRule,
    ReasoningHierarchy,
    ReasoningLevel,
    to_dot,
)
from test_torch_device_provenance import carry
from test_torch_reasoner import port_pattern, port_rule
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)


def _family():
    r = JaxReasoner()
    for a, b in ((":alice", ":bob"), (":bob", ":carol"), (":carol", ":dave"),
                 (":erin", ":bob")):
        r.add_abox_triple(a, ":parentOf", b)
    r.add_rule(r.rule_from_strings([("?x", ":parentOf", "?y")], [("?x", ":ancestorOf", "?y")]))
    r.add_rule(r.rule_from_strings(
        [("?x", ":parentOf", "?y"), ("?y", ":ancestorOf", "?z")], [("?x", ":ancestorOf", "?z")]))
    return r


def _goal(r, s, p, o):
    def term(x):
        return JTerm.variable(x[1:]) if x.startswith("?") else JTerm.constant(
            r.dictionary.encode(x))
    return JPattern(term(s), term(p), term(o))


@pytest.mark.parametrize("goal", [("?a", ":ancestorOf", ":dave"), (":alice", ":ancestorOf", "?d"),
                                  (":erin", ":parentOf", "?c"), ("?x", ":ancestorOf", "?y"),
                                  (":dave", ":ancestorOf", "?n")])
@pytest.mark.parametrize("depth", [1, 10])
def test_backward_chaining_matches_jax(goal, depth):
    jr = _family()
    pr = carry(jr)
    g = _goal(jr, *goal)
    want = jr.backward_chaining(g, depth)
    got = pr.backward_chaining(port_pattern(g), depth)
    assert got == want


def _statuses():
    r = JaxReasoner()
    r.add_abox_triple(":x", ":status", ":active")
    r.add_abox_triple(":x", ":status", ":inactive")
    r.add_abox_triple(":x", ":name", ":thing")
    r.add_abox_triple(":y", ":status", ":active")
    return r, r.rule_from_strings(
        [("?s", ":status", ":active"), ("?s", ":status", ":inactive")], [])


@pytest.mark.parametrize("query", [(":x", ":name", None), (":x", ":status", None),
                                   (None, ":status", ":active"), (None, None, None)])
def test_repairs_and_iar_match_jax(query):
    jr, c = _statuses()
    pr = carry(jr)
    jr.add_constraint(c)
    pr.add_constraint(port_rule(c))
    assert pr.violates_constraints() == jr.violates_constraints() is True
    assert sorted(map(sorted, pr.compute_repairs())) == sorted(map(sorted, jr.compute_repairs()))
    assert pr.query_with_repairs(*query) == jr.query_with_repairs(*query)


def test_infer_with_repairs_matches_jax():
    jr = JaxReasoner()
    jr.add_abox_triple(":a", ":p", ":b")
    jr.add_abox_triple(":c", ":p", ":d")
    jr.add_abox_triple(":c", ":forbidden", ":d")
    jr.add_abox_triple(":e", ":status", ":active")
    jr.add_abox_triple(":e", ":status", ":inactive")
    jr.add_rule(jr.rule_from_strings([("?x", ":p", "?y")], [("?x", ":q", "?y")]))
    pr = carry(jr)
    for c in (jr.rule_from_strings([("?x", ":q", "?y"), ("?x", ":forbidden", "?y")], []),
              jr.rule_from_strings(
                  [("?s", ":status", ":active"), ("?s", ":status", ":inactive")], [])):
        jr.add_constraint(c)
        pr.add_constraint(port_rule(c))
    assert pr.infer_new_facts_with_repairs() == jr.infer_new_facts_with_repairs()
    assert pr.facts.triples_set() == jr.facts.triples_set()
    assert (":a", ":q", ":b") in {pr.decode_triple(t) for t in pr.facts}


def _hierarchy_pair():
    pair = (JHierarchy(), ReasoningHierarchy(device="cpu"))
    for h, level in zip(pair, (JLevel, ReasoningLevel)):
        h.add_fact_at_level(level.BASE, ":alice", ":parentOf", ":bob")
        h.add_fact_at_level(level.BASE, ":bob", ":parentOf", ":carol")
        h.add_fact_at_level(level.BASE, ":alice", ":excluded", ":bob")
        h.add_fact_at_level(level.ABDUCTIVE, ":hyp", ":explains", ":obs")
    return pair


HIERARCHY_RULES = {
    "in_level": ("BASE", [("?x", ":parentOf", "?y"), ("?y", ":parentOf", "?z")],
                 [("?x", ":grandparentOf", "?z")], None, None),
    "cross_level": ("DEDUCTIVE", [("?x", ":parentOf", "?y")], [("?x", ":ancestorOf", "?y")],
                    None, None),
    "naf": ("DEDUCTIVE", [("?x", ":parentOf", "?y")], [("?x", ":candidate", "?y")],
            [("?x", ":excluded", "?y")], None),
    "two_premise_meta": ("META_REASONING",
                         [("?x", ":parentOf", "?y"), ("?y", ":parentOf", "?z")],
                         [("?x", ":grandparentOf", "?z")], None, 5),
    "three_premise_warns": ("BASE", [("?x", ":parentOf", "?y"), ("?y", ":parentOf", "?z"),
                                     ("?z", ":parentOf", "?w")],
                            [("?x", ":greatGrandparentOf", "?w")], None, 0),
}


@pytest.mark.parametrize("case", sorted(HIERARCHY_RULES))
def test_hierarchy_matches_jax(case):
    """Per-level inference, cross-level rules (priorities, NAF, the
    premise-count warning), queries and certainties equal the JAX
    hierarchy's."""
    level_name, prem, concl, neg, priority = HIERARCHY_RULES[case]
    out = []
    for h, level, hrule in zip(_hierarchy_pair(), (JLevel, ReasoningLevel), (JHRule, HierarchicalRule)):
        lv = getattr(level, level_name)
        kg = h.levels[lv]
        rule = kg.rule_from_strings(prem, concl, negative=neg)
        if priority is None:
            h.add_rule_at_level(lv, rule)
        else:
            h.add_cross_level_rule(hrule(rule, lv, priority, [level.BASE]))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            inferred = h.hierarchical_inference()
        decoded = {int(k): sorted(kg.decode_triple(t) for t in v) for k, v in inferred.items()}
        queried = sorted((int(lv_), kg.decode_triple(t)) for lv_, t in h.query_hierarchy())
        certainty = sorted(
            (kg.decode_triple(t), h.get_fact_certainty(t))
            for lv_ in level for t in h.levels[lv_].facts)
        out.append((decoded, queried, certainty, [str(w.message) for w in caught]))
    assert out[1] == out[0]
    assert out[0][0][int(getattr(JLevel, level_name))] or case == "three_premise_warns"


@pytest.mark.parametrize("facts,rule", [
    ([(":a", ":knows", ":b")], ([("?x", ":knows", "?y")], [("?y", ":knownBy", "?x")])),
    ([(":a", ":age", '"25"'), (":a", ":knows", ":b")], None),
    ([], None),
])
def test_to_dot_matches_jax(facts, rule):
    jr = JaxReasoner()
    for f in facts:
        jr.add_abox_triple(*f)
    if rule:
        jr.add_rule(jr.rule_from_strings(*rule))
    assert to_dot(carry(jr)) == j_to_dot(jr)


def test_entry_points_need_a_device():
    """Without a card and without a device the new entry points raise."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReasoningHierarchy()
