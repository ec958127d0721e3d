"""The port's provenance semirings, host provenance loop, TagStore and
RDF-star tag export against the JAX package, on the CPU (the closures of
``tests/test_reasoner.py`` :195-366, each run by both packages on the same
reasoner state)."""

from __future__ import annotations

import pytest

from kolibrie_tpu.reasoner import provenance as jprov
from kolibrie_tpu.reasoner.provenance_seminaive import infer_with_provenance as j_infer
from kolibrie_tpu.reasoner.reasoner import Reasoner as JaxReasoner
from kolibrie_tpu_torch.reasoner import provenance as tprov
from kolibrie_tpu_torch.reasoner.provenance_seminaive import infer_with_provenance as t_infer
from kolibrie_tpu_torch.reasoner.tag_store import TagStore
from test_torch_device_provenance import carry
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

SCALAR = ("minmax", "addmult", "boolean", "expiration")
ALL = SCALAR + ("topk", "wmc")


def _prov_kg():
    r = JaxReasoner()
    r.add_tagged_triple(":a", ":related", ":b", 0.8)
    r.add_tagged_triple(":b", ":related", ":c", 0.5)
    r.add_rule(r.rule_from_strings(
        [("?x", ":related", "?y"), ("?y", ":related", "?z")], [("?x", ":related", "?z")]))
    return r


def _two_paths(p1=0.5, p2=0.5):
    r = JaxReasoner()
    r.add_tagged_triple(":s", ":p1", ":m1", p1)
    r.add_tagged_triple(":s", ":p2", ":m2", p2)
    r.add_rule(r.rule_from_strings([("?x", ":p1", "?y")], [("?x", ":goal", '"t"')]))
    r.add_rule(r.rule_from_strings([("?x", ":p2", "?y")], [("?x", ":goal", '"t"')]))
    return r


def _naf(tagged_block):
    r = JaxReasoner()
    r.add_abox_triple(":a", ":type", ":P")
    r.add_abox_triple(":b", ":type", ":P")
    if tagged_block:
        r.add_tagged_triple(":a", ":blocked", '"y"', 0.3)
    else:
        r.add_abox_triple(":b", ":blocked", '"y"')
    r.add_rule(r.rule_from_strings(
        [("?x", ":type", ":P")], [("?x", ":ok", '"y"')], negative=[("?x", ":blocked", '"y"')]))
    return r


PROGRAMS = {"chain": _prov_kg, "two_paths": _two_paths,
            "two_paths_skewed": lambda: _two_paths(0.6, 0.7),
            "naf_certain": lambda: _naf(False), "naf_tagged": lambda: _naf(True)}


@pytest.mark.parametrize("program", sorted(PROGRAMS))
@pytest.mark.parametrize("name", ALL)
def test_host_loop_and_rdf_star_match_jax(program, name):
    """The host provenance loop gives the JAX package's TagStore, tag for
    tag (proof sets included), and ``materialize_tags_as_rdf_star`` the
    same ``<< s p o >> prob:value`` facts."""
    jr = PROGRAMS[program]()
    pr = carry(jr)
    jp, tp = jprov.make_provenance(name), tprov.make_provenance(name)
    jstore, tstore = j_infer(jr, jp), t_infer(pr, tp)
    assert pr.facts.triples_set() == jr.facts.triples_set()
    assert dict(tstore.tags) == dict(jstore.tags)
    for k, tag in jstore.tags.items():
        assert tp.recover_probability(tstore.tags[k]) == jp.recover_probability(tag)
    assert pr.materialize_tags_as_rdf_star(tstore) == jr.materialize_tags_as_rdf_star(jstore)
    assert {pr.decode_triple(t) for t in pr.facts} == {jr.decode_triple(t) for t in jr.facts}


@pytest.mark.parametrize("name", ("wmc", "topk"))
def test_explain_proofs_match_jax(name):
    jr = _two_paths()
    pr = carry(jr)
    jstore = j_infer(jr, jprov.make_provenance(name))
    tstore = t_infer(pr, tprov.make_provenance(name))
    for k in jstore.tags:
        want = {jr.decode_triple(t) for t in jstore.explain_proofs(jr, k)}
        assert {pr.decode_triple(t) for t in tstore.explain_proofs(pr, k)} == want


def test_known_values():
    """The reference's closed-form checks on the port: min 0.5, product
    0.4, inclusion-exclusion 0.75 and 0.88, NAF 0.7."""
    goal = (":s", ":goal", '"t"')
    for build, name, fact, want in (
        (_prov_kg, "minmax", (":a", ":related", ":c"), 0.5),
        (_prov_kg, "addmult", (":a", ":related", ":c"), 0.4),
        (_prov_kg, "boolean", (":a", ":related", ":c"), 1.0),
        (_two_paths, "wmc", goal, 0.75),
        (lambda: _two_paths(0.6, 0.7), "topk", goal, 0.6 + 0.7 - 0.6 * 0.7),
        (lambda: _naf(True), "wmc", (":a", ":ok", '"y"'), 0.7),
    ):
        pr = carry(build())
        prov = tprov.make_provenance(name)
        store = t_infer(pr, prov)
        key = tuple(pr.dictionary.encode(x) for x in fact)
        assert abs(prov.recover_probability(store.get(key)) - want) < 1e-9


@pytest.mark.parametrize("name", SCALAR)
def test_semiring_laws_match_jax(name):
    """Identities, commutativity and associativity (provenance.rs:481-689)
    hold in the port, with the JAX semiring's values."""
    js, ts = jprov.make_provenance(name), tprov.make_provenance(name)
    probs = (0.2, 0.3, 0.4, 0.5, 0.6, 0.9)
    jt = [js.tag_from_probability(p) for p in probs] + [js.one(), js.zero()]
    tt = [ts.tag_from_probability(p) for p in probs] + [ts.one(), ts.zero()]
    assert tt == jt
    for a in tt:
        assert ts.tag_eq(ts.disjunction(a, ts.zero()), a)
        assert ts.tag_eq(ts.conjunction(a, ts.one()), a)
        assert ts.tag_eq(ts.conjunction(a, ts.zero()), ts.zero())
        assert ts.negate(a) == js.negate(a)
        assert ts.recover_probability(a) == js.recover_probability(a)
        assert ts.is_saturated(a) == js.is_saturated(a)
        for b in tt:
            assert ts.disjunction(a, b) == js.disjunction(a, b)
            assert ts.conjunction(a, b) == js.conjunction(a, b)
            assert ts.tag_eq(ts.disjunction(a, b), ts.disjunction(b, a))
            assert ts.tag_eq(ts.conjunction(a, b), ts.conjunction(b, a))
            for c in tt[:3]:
                assert ts.tag_eq(ts.disjunction(a, ts.disjunction(b, c)),
                                 ts.disjunction(ts.disjunction(a, b), c))
                assert ts.tag_eq(ts.conjunction(a, ts.conjunction(b, c)),
                                 ts.conjunction(ts.conjunction(a, b), c))


def test_tag_store_from_items_and_update():
    """``TagStore.from_items`` carries a JAX store's scalar tags; the
    update_disjunction protocol (insert, saturate, ⊕-merge) matches."""
    from kolibrie_tpu.reasoner.tag_store import TagStore as JaxTagStore

    for name in SCALAR:
        js, ts = JaxTagStore(jprov.make_provenance(name)), None
        steps = [((1, 2, 3), 0.4), ((1, 2, 3), 0.7), ((4, 5, 6), 1.0), ((4, 5, 6), 0.2)]
        jchanged = []
        for k, p in steps:
            jchanged.append(js.update_disjunction(k, js.provenance.tag_from_probability(p)))
        ts = TagStore.from_items(tprov.make_provenance(name), js.tags.items())
        assert dict(ts.tags) == dict(js.tags)
        fresh = TagStore(tprov.make_provenance(name))
        tchanged = [fresh.update_disjunction(k, fresh.provenance.tag_from_probability(p))
                    for k, p in steps]
        assert tchanged == jchanged and dict(fresh.tags) == dict(js.tags)
