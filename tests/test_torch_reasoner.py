"""The PyTorch port's reasoner and device fixpoint against the JAX package,
on the CPU.

Each corpus is built as a JAX ``Reasoner`` and carried into the port with
``Reasoner.from_arrays`` (same dictionary IDs, fact columns and quoted
triples); its rules are converted term by term.  Both device fixpoints then
run on the same state — the JAX one jitted on the CPU, the port's with its
kernels' plain versions — and must agree exactly: derived counts, the
padded output columns row for row (input rows first, derived rows appended
in the reference's sorted order), rounds, overflow codes and converged
capacities.  The port's host strategy is checked against its device
fixpoint on the same corpora.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kolibrie_tpu.core.rule import FilterCondition, Rule
from kolibrie_tpu.core.terms import Term, TriplePattern
from kolibrie_tpu.reasoner import device_fixpoint as jfx
from kolibrie_tpu.reasoner.reasoner import Reasoner as JaxReasoner
from kolibrie_tpu_torch import Reasoner
from kolibrie_tpu_torch.core import rule as prule
from kolibrie_tpu_torch.core import terms as pterms
from kolibrie_tpu_torch.reasoner import device_fixpoint as tfx

# ------------------------------------------------------------------ helpers


def port_term(t: Term) -> pterms.Term:
    if t.is_variable:
        return pterms.Term.variable(t.value)
    if t.is_constant:
        return pterms.Term.constant(int(t.value))
    return pterms.Term.quoted(port_pattern(t.value))


def port_pattern(p: TriplePattern) -> pterms.TriplePattern:
    return pterms.TriplePattern(*(port_term(t) for t in p.terms()))


def port_rule(r: Rule) -> prule.Rule:
    return prule.Rule(
        premise=[port_pattern(p) for p in r.premise],
        negative_premise=[port_pattern(p) for p in r.negative_premise],
        filters=[prule.FilterCondition(f.variable, f.operator, f.value) for f in r.filters],
        conclusion=[port_pattern(c) for c in r.conclusion],
    )


def carry(jr: JaxReasoner) -> Reasoner:
    """The port's reasoner on the CPU holding ``jr``'s state and rules."""
    pr = Reasoner.from_arrays(
        jr.dictionary.id_to_str,
        *jr.facts.columns(),
        quoted=jr.quoted.id_to_triple,
        device="cpu",
    )
    for r in jr.rules:
        pr.add_rule(port_rule(r))
    return pr


def assert_columns(jcols, tcols, n):
    for j, t in zip(jcols, tcols):
        np.testing.assert_array_equal(t[:n].numpy(), np.asarray(j[:n]).astype(np.int64))


def assert_same_facts(a, b):
    for x, y in zip(a.facts.columns(), b.facts.columns()):
        np.testing.assert_array_equal(x, y)


def caps_tuple(c):
    return (c.fact, c.delta, c.join)


# ------------------------------------------------------------------ corpora


def _chain(n, pred="next"):
    r = JaxReasoner()
    for i in range(n):
        r.add_abox_triple(f"n{i}", pred, f"n{i + 1}")
    r.add_rule(
        r.rule_from_strings(
            [("?x", pred, "?y"), ("?y", pred, "?z")], [("?x", pred, "?z")]
        )
    )
    return r


def c_transitive():
    return _chain(30)


def c_cascade():
    r = JaxReasoner()
    for i in range(20):
        r.add_abox_triple(f"p{i}", "worksAt", f"org{i % 4}")
        r.add_abox_triple(f"org{i % 4}", "partOf", "corp")
    r.add_abox_triple("corp", "locatedIn", "city")
    r.add_rule(
        r.rule_from_strings(
            [("?x", "worksAt", "?o"), ("?o", "partOf", "?c")], [("?x", "memberOf", "?c")]
        )
    )
    r.add_rule(
        r.rule_from_strings(
            [("?x", "memberOf", "?c"), ("?c", "locatedIn", "?l")], [("?x", "basedIn", "?l")]
        )
    )
    return r


def c_three_premise():
    r = JaxReasoner()
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


def c_naf():
    r = JaxReasoner()
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


def c_numeric_filter():
    r = JaxReasoner()
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


def c_multi_head_constants():
    r = JaxReasoner()
    for i in range(8):
        r.add_abox_triple(f"x{i}", "type", "Widget")
    r.add_rule(
        r.rule_from_strings(
            [("?x", "type", "Widget")],
            [("?x", "category", "product"), ("?x", "taxed", "yes")],
        )
    )
    return r


def c_diamond():
    r = JaxReasoner()
    r.add_abox_triple("a", "e", "b1")
    r.add_abox_triple("a", "e", "b2")
    r.add_abox_triple("b1", "e", "c")
    r.add_abox_triple("b2", "e", "c")
    r.add_rule(
        r.rule_from_strings([("?x", "e", "?y"), ("?y", "e", "?z")], [("?x", "e", "?z")])
    )
    return r


def c_three_shared_vars():
    r = JaxReasoner()
    for i in range(15):
        r.add_abox_triple(f"a{i}", "sym", f"b{i}")
        r.add_abox_triple(f"b{i}", "sym", f"a{i}")
    for i in range(25):
        r.add_abox_triple(f"a{i}", "asym", f"c{i}")
    r.add_rule(
        r.rule_from_strings(
            [("?x", "?p", "?y"), ("?y", "?p", "?x")], [("?x", "mutual", "?y")]
        )
    )
    return r


def c_ground_quoted():
    r = JaxReasoner()
    d = r.dictionary
    C, V = Term.constant, Term.variable
    a, p, b = d.encode(":a"), d.encode(":p"), d.encode(":b")
    cert, high = d.encode(":certainty"), d.encode(":high")
    ok, yes = d.encode(":ok"), d.encode(":yes")
    r.facts.add(r.quoted.intern(a, p, b), cert, high)
    for i in range(6):
        r.add_abox_triple(f"s{i}", ":edge", f"s{i + 1}")
    ground_q = Term.quoted(TriplePattern(C(a), C(p), C(b)))
    ghost = Term.quoted(
        TriplePattern(C(d.encode(":never")), C(d.encode(":was")), C(d.encode(":here")))
    )
    r.add_rule(
        Rule(
            premise=[
                TriplePattern(ground_q, C(cert), C(high)),
                TriplePattern(V("x"), C(d.encode(":edge")), V("y")),
            ],
            conclusion=[
                TriplePattern(V("x"), C(ok), C(yes)),
                TriplePattern(ground_q, C(ok), C(yes)),
            ],
        )
    )
    # a never-interned quoted premise matches nothing
    r.add_rule(
        Rule(
            premise=[
                TriplePattern(ghost, C(cert), V("c")),
                TriplePattern(V("x"), C(d.encode(":edge")), V("c")),
            ],
            conclusion=[TriplePattern(V("x"), C(d.encode(":bad")), V("c"))],
        )
    )
    return r


def c_ground_guard():
    r = JaxReasoner()
    d = r.dictionary
    C, V = Term.constant, Term.variable
    for i in range(5):
        r.add_abox_triple(f"n{i}", ":edge", f"n{i + 1}")
    r.add_abox_triple(":mode", ":is", ":strict")

    def gated(obj, head):
        return Rule(
            premise=[
                TriplePattern(C(d.encode(":mode")), C(d.encode(":is")), C(d.encode(obj))),
                TriplePattern(V("x"), C(d.encode(":edge")), V("y")),
            ],
            conclusion=[TriplePattern(V("x"), C(d.encode(head)), V("y"))],
        )

    r.add_rule(gated(":strict", ":checked"))  # satisfied guard: fires
    r.add_rule(gated(":loose", ":skipped"))  # absent guard: statically dead
    return r


CORPORA = {
    "transitive": c_transitive,
    "cascade": c_cascade,
    "three_premise": c_three_premise,
    "naf": c_naf,
    "numeric_filter": c_numeric_filter,
    "multi_head_constants": c_multi_head_constants,
    "diamond": c_diamond,
    "three_shared_vars": c_three_shared_vars,
    "ground_quoted": c_ground_quoted,
    "ground_guard": c_ground_guard,
}


# -------------------------------------------------------------------- tests


@pytest.mark.parametrize("name", list(CORPORA))
def test_fixpoint_matches_jax(name):
    jr = CORPORA[name]()
    pr = carry(jr)
    jf, tf = jfx.DeviceFixpoint(jr), tfx.DeviceFixpoint(pr)

    # one run at the default capacities: columns, count, rounds, code
    jout = [np.asarray(x) for x in jf.run_raw()]
    tout = tf.run_raw()
    assert tout[3:] == (int(jout[3]), int(jout[4]), int(jout[5]))
    assert_columns(jout[:3], tout[:3], tout[3])

    # the capacity-retry entry: padded outputs and converged capacities
    s, p, o = jr.facts.columns()
    n0 = len(s)
    caps = jf._caps(n0)
    jpad = jf.infer_padded(*(jnp.asarray(c) for c in (s, p, o)), jnp.int32(n0), caps)
    tpad = tf.infer_padded(*(torch.from_numpy(c.astype(np.int64)) for c in (s, p, o)), n0,
                           tfx._Caps(*caps_tuple(caps)))
    assert tpad[3] == int(jpad[3])
    assert caps_tuple(tpad[4]) == caps_tuple(jpad[4])
    assert_columns(jpad[:3], tpad[:3], tpad[3])

    # write-back and the host oracle
    jd, td = jf.infer(), tf.infer()
    assert td == jd
    assert caps_tuple(tf.converged_caps) == caps_tuple(jf.converged_caps)
    host = carry(CORPORA[name]())
    host.infer_new_facts_semi_naive()
    assert_same_facts(pr, host)


def test_capacity_doubling_matches_jax():
    """Tiny initial capacities converge through overflow-driven doubling of
    all three capacities, restarting from the committed state."""
    jr = _chain(24)
    pr = carry(jr)
    s, p, o = jr.facts.columns()
    caps = jfx._Caps(fact=128, delta=128, join=128)
    jpad = jfx.DeviceFixpoint(jr).infer_padded(
        *(jnp.asarray(c) for c in (s, p, o)), jnp.int32(len(s)), caps
    )
    tpad = tfx.DeviceFixpoint(pr).infer_padded(
        *(torch.from_numpy(c.astype(np.int64)) for c in (s, p, o)), len(s),
        tfx._Caps(128, 128, 128),
    )
    assert tpad[3] == int(jpad[3]) == 24 * 25 // 2
    assert caps_tuple(tpad[4]) == caps_tuple(jpad[4])
    assert_columns(jpad[:3], tpad[:3], tpad[3])


def _naf_filter_chunks():
    r = JaxReasoner()
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


CHUNKED = {
    # multi-chunk rounds, accumulator growth, join-cap doubling, fact growth
    "rounds": (lambda: _chain(40), dict(chunk_rows=16, join_cap=64, delta_cap=32)),
    # NAF + numeric filter see the same frozen snapshot in every chunk
    "naf_filter": (_naf_filter_chunks, dict(chunk_rows=8, join_cap=32)),
    "cascade": (c_cascade, dict(chunk_rows=8)),
}


@pytest.mark.parametrize("name", list(CHUNKED))
def test_chunked_matches_jax(name):
    build, kw = CHUNKED[name]
    jr = build()
    pr = carry(jr)
    jf, tf = jfx.DeviceFixpoint(jr), tfx.DeviceFixpoint(pr)
    jd, td = jf.infer_chunked(**kw), tf.infer_chunked(**kw)
    assert td == jd
    assert tf.last_rounds == jf.last_rounds
    assert caps_tuple(tf.converged_caps) == caps_tuple(jf.converged_caps)
    jfs, jfp, jfo, jn, _ = jf._last_state
    tfs, tfp, tfo, tn, _ = tf._last_state
    assert tn == int(jn)
    assert_columns((jfs, jfp, jfo), (tfs, tfp, tfo), tn)
    # chunked and one-run entries reach the same closure
    one = carry(build())
    tfx.DeviceFixpoint(one).infer()
    assert_same_facts(pr, one)


def _cartesian(r):
    r.add_abox_triple("a", "p", "b")
    r.add_rule(
        r.rule_from_strings([("?x", "p", "?y"), ("?u", "q", "?v")], [("?x", "r", "?u")])
    )


def _inner_variable_quoted(r):
    d = r.dictionary
    C, V = Term.constant, Term.variable
    qid = r.quoted.intern(d.encode(":a"), d.encode(":p"), d.encode(":b"))
    r.facts.add(qid, d.encode(":certainty"), d.encode(":high"))
    r.add_rule(
        Rule(
            premise=[
                TriplePattern(
                    Term.quoted(TriplePattern(V("s"), V("pp"), V("o"))),
                    C(d.encode(":certainty")),
                    V("c"),
                )
            ],
            conclusion=[TriplePattern(V("s"), V("pp"), V("o"))],
        )
    )


def _derivable_guard(r):
    d = r.dictionary
    C, V = Term.constant, Term.variable
    r.add_abox_triple("n0", ":edge", "n1")
    guard = TriplePattern(C(d.encode(":mode")), C(d.encode(":is")), C(d.encode(":strict")))
    r.add_rule(
        Rule(premise=[TriplePattern(V("x"), C(d.encode(":edge")), V("y"))], conclusion=[guard])
    )
    r.add_rule(
        Rule(
            premise=[guard, TriplePattern(V("x"), C(d.encode(":edge")), V("y"))],
            conclusion=[TriplePattern(V("x"), C(d.encode(":gated")), V("y"))],
        )
    )


@pytest.mark.parametrize("make", [_cartesian, _inner_variable_quoted, _derivable_guard])
def test_unsupported_rule_sets_match_jax(make):
    jr = JaxReasoner()
    make(jr)
    pr = carry(jr)
    with pytest.raises(jfx.Unsupported):
        jfx.DeviceFixpoint(jr)
    with pytest.raises(tfx.Unsupported):
        tfx.DeviceFixpoint(pr)
    assert jfx.infer_semi_naive_device(jr) is None
    assert tfx.infer_semi_naive_device(pr) is None


def test_idempotent_on_closed_set():
    pr = carry(_chain(1))
    assert pr.infer_new_facts_device() == 0


# ------------------------------------------------------------ reasoner API


def test_from_arrays_keeps_ids_and_clone_is_independent():
    jr = c_ground_quoted()
    pr = carry(jr)
    assert pr.dictionary.id_to_str == jr.dictionary.id_to_str
    assert pr.quoted.id_to_triple == jr.quoted.id_to_triple
    assert_same_facts(pr, jr)
    twin = pr.clone()
    twin.add_abox_triple("extra", "p", "o")
    assert len(twin) == len(pr) + 1
    assert pr.dictionary.lookup("extra") is None


def test_parallel_strategy_routes_by_size(monkeypatch):
    """Below the 50,000-fact threshold the host strategy runs; above it the
    device fixpoint, which falls back to the host only for Unsupported."""
    calls = []
    orig = tfx.infer_semi_naive_device

    def spy(r):
        calls.append(len(r.facts))
        return orig(r)

    monkeypatch.setattr(tfx, "infer_semi_naive_device", spy)
    small = carry(c_cascade())
    n_small = small.infer_new_facts_semi_naive_parallel()
    assert calls == []
    monkeypatch.setattr(Reasoner, "_DEVICE_AUTO_MIN_FACTS", 10)
    big = carry(c_cascade())
    assert big.infer_new_facts_semi_naive_parallel() == n_small
    assert len(calls) == 1
    assert_same_facts(small, big)


def test_unported_surfaces_raise():
    r = Reasoner(device="cpu")
    for call in (
        lambda: r.infer_new_facts_with_provenance(None),
        lambda: r.infer_new_facts_with_repairs(),
        lambda: r.backward_chaining(None),
        lambda: r.add_constraint(None),
    ):
        with pytest.raises(NotImplementedError):
            call()
