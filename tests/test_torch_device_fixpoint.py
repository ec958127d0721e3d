"""The port's device fixpoint, whose rounds compact each rule's candidate
block to its live rows before the dedup, against the port's host
semi-naive strategy (the oracle) on the oracle cases of the reference's
agreement tests, through ``infer`` and ``infer_chunked``.
"""

from __future__ import annotations

import dataclasses

import pytest

from kolibrie_tpu_torch import Reasoner
from kolibrie_tpu_torch.core.rule import FilterCondition
from kolibrie_tpu_torch.obs import spans
from kolibrie_tpu_torch.reasoner import device_fixpoint as pfx
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)


def _reasoner():
    return Reasoner(device="cpu")


def _transitive(n=30):
    r = _reasoner()
    for i in range(n):
        r.add_abox_triple(f"n{i}", "next", f"n{i + 1}")
    r.add_rule(
        r.rule_from_strings(
            [("?x", "next", "?y"), ("?y", "next", "?z")],
            [("?x", "next", "?z")],
        )
    )
    return r


def _cascade():
    r = _reasoner()
    for i in range(20):
        r.add_abox_triple(f"p{i}", "worksAt", f"org{i % 4}")
        r.add_abox_triple(f"org{i % 4}", "partOf", "corp")
    r.add_abox_triple("corp", "locatedIn", "city")
    r.add_rule(
        r.rule_from_strings(
            [("?x", "worksAt", "?o"), ("?o", "partOf", "?c")],
            [("?x", "memberOf", "?c")],
        )
    )
    r.add_rule(
        r.rule_from_strings(
            [("?x", "memberOf", "?c"), ("?c", "locatedIn", "?l")],
            [("?x", "basedIn", "?l")],
        )
    )
    return r


def _three_premise():
    r = _reasoner()
    for i in range(12):
        r.add_abox_triple(f"a{i}", "p", f"b{i % 5}")
        r.add_abox_triple(f"b{i % 5}", "q", f"c{i % 3}")
        r.add_abox_triple(f"c{i % 3}", "r", f"d{i % 2}")
    r.add_rule(
        r.rule_from_strings(
            [("?x", "p", "?y"), ("?y", "q", "?z"), ("?z", "r", "?w")],
            [("?x", "reach", "?w")],
        )
    )
    return r


def _naf():
    r = _reasoner()
    for i in range(10):
        r.add_abox_triple(f"s{i}", "hasPart", f"t{i}")
    r.add_abox_triple("t3", "broken", "yes")
    r.add_abox_triple("t7", "broken", "yes")
    r.add_rule(
        r.rule_from_strings(
            [("?x", "hasPart", "?y")],
            [("?x", "works", "?y")],
            negative=[("?y", "broken", "yes")],
        )
    )
    return r


def _numeric_filter():
    r = _reasoner()
    for i in range(12):
        r.add_abox_triple(f"item{i}", "price", f'"{i * 10}"')
    r.add_rule(
        r.rule_from_strings(
            [("?x", "price", "?v")],
            [("?x", "expensive", "yes")],
            filters=[FilterCondition("v", ">", 60.0)],
        )
    )
    return r


def _multi_head_constants():
    r = _reasoner()
    for i in range(8):
        r.add_abox_triple(f"x{i}", "type", "Widget")
    r.add_rule(
        r.rule_from_strings(
            [("?x", "type", "Widget")],
            [("?x", "category", "product"), ("?x", "taxed", "yes")],
        )
    )
    return r


def _diamond():
    r = _reasoner()
    r.add_abox_triple("a", "e", "b1")
    r.add_abox_triple("a", "e", "b2")
    r.add_abox_triple("b1", "e", "c")
    r.add_abox_triple("b2", "e", "c")
    r.add_rule(
        r.rule_from_strings([("?x", "e", "?y"), ("?y", "e", "?z")], [("?x", "e", "?z")])
    )
    return r


def _three_shared_vars():
    r = _reasoner()
    for i in range(15):
        r.add_abox_triple(f"a{i}", "sym", f"b{i}")
        r.add_abox_triple(f"b{i}", "sym", f"a{i}")
    for i in range(25):
        r.add_abox_triple(f"a{i}", "asym", f"c{i}")
    r.add_rule(
        r.rule_from_strings(
            [("?x", "?p", "?y"), ("?y", "?p", "?x")],
            [("?x", "mutual", "?y")],
        )
    )
    return r


def _naf_filter():
    r = _reasoner()
    for i in range(24):
        r.add_abox_triple(f"s{i}", "hasPart", f"t{i}")
        r.add_abox_triple(f"t{i}", "weight", f'"{i * 5}"')
    r.add_abox_triple("t3", "broken", "yes")
    r.add_abox_triple("t11", "broken", "yes")
    r.add_rule(
        r.rule_from_strings(
            [("?x", "hasPart", "?y"), ("?y", "weight", "?w")],
            [("?x", "carries", "?y")],
            negative=[("?y", "broken", "yes")],
            filters=[FilterCondition("w", ">", 20.0)],
        )
    )
    return r


CASES = {
    "transitive": _transitive,
    "cascade": _cascade,
    "three_premise": _three_premise,
    "naf": _naf,
    "numeric_filter": _numeric_filter,
    "multi_head_constants": _multi_head_constants,
    "diamond": _diamond,
    "three_shared_vars": _three_shared_vars,
    "naf_filter": _naf_filter,
}

# the chunked entry in chunks of 8 delta rows, so rounds run several chunks
ENTRIES = {"infer": {}, "infer_chunked": {"chunk_rows": 8}}


def _closure(case, entry, fx_setup=None, **kw):
    """The host oracle and the device fixpoint through ``entry`` (``infer``
    or ``infer_chunked``): fact sets, derived count, the fixpoint and the
    attributes of its ``fixpoint.round`` spans."""
    host = CASES[case]()
    host.infer_new_facts_semi_naive()
    r = CASES[case]()
    fx = pfx.DeviceFixpoint(r)
    if fx_setup is not None:
        fx_setup(fx)
    spans.clear()
    derived = getattr(fx, entry)(**kw)
    rounds = [s["attrs"] for s in spans.spans_snapshot() if s["name"] == "fixpoint.round"]
    return host.facts.triples_set(), r.facts.triples_set(), derived, fx, rounds


@pytest.mark.parametrize("entry", list(ENTRIES))
@pytest.mark.parametrize("case", list(CASES))
def test_compacted_fixpoint_matches_host_oracle(case, entry):
    host, dev, derived, fx, rounds = _closure(case, entry, **ENTRIES[entry])
    assert dev == host
    assert derived == len(host) - len(CASES[case]().facts)
    # a committed round's dedup took the compacted candidates: every new
    # fact is a live row, and the live rows fit the capacity
    committed = [a for a in rounds if a["code"] == 0]
    assert committed
    for a in committed:
        assert a["new_facts"] <= a["candidate_valid"] <= a["candidate_rows"]
        assert a["candidate_valid"] <= a["block_rows"]


@pytest.mark.parametrize("entry", list(ENTRIES))
@pytest.mark.parametrize("case", list(CASES))
def test_candidate_overflow_retries_to_the_same_closure(case, entry):
    """A compacted candidate capacity below a round's live candidates
    overflows (bit4, 16): the round does not commit, the capacity doubles
    and the closure is the oracle's.  The one-run entry takes half the
    most live rows a round of the default run had; the chunked entry one
    row a chunk (its candidate capacity starts at the join capacity)."""
    if entry == "infer":
        *_, rounds = _closure(case, entry)
        most = max(a["candidate_valid"] for a in rounds if a["code"] == 0)

        def small(fx):
            sized = fx._caps
            fx._caps = lambda n: dataclasses.replace(sized(n), cand=max(1, most // 2))

        host, dev, _d, fx, rounds = _closure(case, entry, small)
    else:
        host, dev, _d, fx, rounds = _closure(case, entry, join_cap=1, **ENTRIES[entry])
    assert dev == host
    failed = [a for a in rounds if a["code"] & 16]
    assert failed, "no round overflowed the candidate capacity"
    if entry == "infer":
        # a round that does not commit has a span of its own
        assert all(a["candidate_valid"] > a["candidate_rows"] for a in failed)
        assert all(a["candidate_valid"] <= a["candidate_rows"] for a in rounds if not a["code"])
    assert fx.converged_caps.cand > (1 if entry == "infer_chunked" else most // 2)
