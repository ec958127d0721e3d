"""The statements beside SELECT on the PyTorch port against the JAX package:
INSERT DATA, DELETE DATA, DELETE … WHERE, RULE definitions (filters, NOT
blocks, each R2S stream type), RULE … PROB with its tag triples, a MODEL declaration, what still
raises, and the package's exports.

Both packages hold the same database (the port's ``from_arrays`` takes the
reference's dictionary, quoted table and columns, so every ID matches), run
the same statement text, and must then hold the same store, compared as
sets of decoded triples, and answer the same SELECT.  Both run the device
program (``execution_mode = "device"``); the port on ``device="cpu"``.  No tolerance is
used.
"""

from __future__ import annotations

import pytest

import kolibrie_tpu_torch as port
from kolibrie_tpu.query import ast as ref_ast
from kolibrie_tpu.query.executor import execute_query as ref_execute_query
from kolibrie_tpu.query.executor import execute_query_volcano as ref_execute
from kolibrie_tpu.query.parser import parse_rule_definition as ref_parse_rule
from kolibrie_tpu.query.sparql_database import SparqlDatabase as RefDatabase
from kolibrie_tpu.reasoner import rule_runtime as ref_rules
from kolibrie_tpu_torch.query import ast as port_ast
from kolibrie_tpu_torch.query.parser import parse_rule_definition as port_parse_rule
from kolibrie_tpu_torch.reasoner import rule_runtime as port_rules
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

EX = "PREFIX ex: <http://ex.org/>\n"

TURTLE = """@prefix ex: <http://ex.org/> .
ex:ann ex:knows ex:bob . ex:bob ex:knows ex:cat . ex:cat ex:knows ex:dan .
ex:dan ex:knows ex:ann . ex:eve ex:knows ex:bob . ex:bob ex:knows ex:eve .
ex:ann ex:age "34" . ex:bob ex:age "27" . ex:cat ex:age "41" . ex:dan ex:age "19" .
ex:eve ex:age "52" .
ex:ann ex:parentOf ex:dan . ex:cat ex:parentOf ex:eve .
ex:ann a ex:Person . ex:bob a ex:Person . ex:cat a ex:Person . ex:dan a ex:Person .
ex:eve a ex:Robot .
ex:ann ex:label "Ann A." . ex:cat ex:label "Cat C." .
<< ex:ann ex:knows ex:bob >> ex:since "2015" .
<< ex:bob ex:knows ex:cat >> ex:since "2019" .
<< ex:cat ex:knows ex:dan >> ex:since "2021" .
"""


def pair():
    """Both packages' databases on the device program: the store is far
    under the 100,000-triple floor below which "auto" takes the host
    engine."""
    ref = RefDatabase()
    ref.parse_turtle(TURTLE)
    ref.execution_mode = "device"
    tdb = port.SparqlDatabase.from_arrays(
        ref.dictionary.id_to_str, *ref.store.columns(), quoted=dict(ref.quoted.items()),
        device="cpu",
    )
    tdb.execution_mode = "device"
    tdb.prefixes.update(ref.prefixes)
    return ref, tdb


def decoded(db) -> set:
    s, p, o = db.store.columns()
    dec = db.decode_term
    return {(dec(int(a)), dec(int(b)), dec(int(c))) for a, b, c in zip(s, p, o)}


def assert_same_store(ref, tdb):
    want = decoded(ref)
    assert decoded(tdb) == want
    return want


PROBES = [
    "SELECT ?x ?y WHERE { ?x ex:knows ?y }",
    "SELECT ?x ?y ?t WHERE { << ?x ex:knows ?y >> ex:since ?t }",
    "SELECT ?s ?p ?o WHERE { ?s ?p ?o . FILTER(?p != ex:knows) }",
]


def assert_same_answers(ref, tdb):
    for q in PROBES:
        assert port.execute_query_volcano(EX + q, tdb) == ref_execute(EX + q, ref), q


STATEMENTS = {
    "insert_data": "INSERT DATA { ex:fay ex:knows ex:ann . ex:fay ex:age \"23\" . "
                   "ex:ann ex:knows ex:bob }",
    "insert_quoted": "INSERT DATA { << ex:dan ex:knows ex:ann >> ex:since \"2024\" . "
                     "<< ex:fay ex:knows ex:gus >> ex:since \"2025\" }",
    "delete_data": "DELETE DATA { ex:ann ex:knows ex:bob . ex:eve ex:age \"52\" . "
                   "ex:nobody ex:knows ex:ann }",
    "delete_quoted": "DELETE DATA { << ex:bob ex:knows ex:cat >> ex:since \"2019\" }",
    "delete_where": "DELETE { ?x ex:knows ?y } WHERE { ?x ex:knows ?y . ?y ex:age ?a "
                    "FILTER(?a > 30) }",
    "delete_where_quoted": "DELETE { ?q ex:since ?t } "
                           "WHERE { ?q ex:since ?t . << ?x ex:knows ?y >> ex:since ?t "
                           "FILTER(?t < 2020) }",
    # a quoted template term is encoded as written, variables and all, so
    # this deletes nothing in either package
    "delete_where_quoted_template": "DELETE { << ?x ex:knows ?y >> ex:since ?t } "
                                    "WHERE { << ?x ex:knows ?y >> ex:since ?t FILTER(?t < 2020) }",
    "delete_where_two_templates": "DELETE { ?x ex:age ?a . ?x a ex:Person } "
                                  "WHERE { ?x ex:age ?a . ?x ex:parentOf ?c }",
    "delete_where_cartesian": "DELETE { ?x ex:label ?l } WHERE { ?x ex:label ?l . "
                              "?r a ex:Robot }",
    "delete_where_unbound": "DELETE { ?x ex:knows ?nothing } WHERE { ?x ex:age ?a }",
    "delete_where_string_filter": "DELETE { ?x ex:label ?l } WHERE { ?x ex:label ?l "
                                  "FILTER(REGEX(STR(?l), \"^Ann\")) }",
}


UNCHANGED = {"delete_where_quoted_template", "delete_where_unbound"}


@pytest.mark.parametrize("name", sorted(STATEMENTS))
@pytest.mark.parametrize("entry", ["volcano", "execute_query"])
def test_update_statements_match_reference(name, entry):
    ref, tdb = pair()
    before = decoded(ref)
    q = EX + STATEMENTS[name]
    run = {"volcano": (port.execute_query_volcano, ref_execute),
           "execute_query": (port.execute_query, ref_execute_query)}[entry]
    assert run[0](q, tdb) == run[1](q, ref) == []
    changed = assert_same_store(ref, tdb) != before
    assert changed == (name not in UNCHANGED)
    assert_same_answers(ref, tdb)


RULES = {
    "join": "RULE :Fof :- CONSTRUCT { ?x ex:fof ?z . } WHERE { ?x ex:knows ?y . ?y ex:knows ?z . }",
    "filter": "RULE :Senior :- CONSTRUCT { ?x ex:senior \"yes\" . } "
              "WHERE { ?x ex:age ?a FILTER(?a >= 34) }",
    "flipped_filter": "RULE :Young :- CONSTRUCT { ?x a ex:Young . } "
                      "WHERE { ?x ex:age ?a FILTER(30 > ?a) }",
    "iri_filter": "RULE :NotBob :- CONSTRUCT { ?x ex:friendOf ?y . } "
                  "WHERE { ?x ex:knows ?y FILTER(?y != ex:bob) }",
    "not_block": "RULE :Orphan :- CONSTRUCT { ?x ex:orphan \"true\" . } "
                 "WHERE { ?x a ex:Person . NOT { ?p ex:parentOf ?x } }",
    "not_block_bound": "RULE :Distant :- CONSTRUCT { ?x ex:distant \"true\" . } "
                       "WHERE { ?x a ex:Person . NOT { ?x ex:knows ex:bob } }",
    "quoted_body": "RULE :Old :- CONSTRUCT { ?x ex:oldFriend ?y . } "
                   "WHERE { << ?x ex:knows ?y >> ex:since ?t FILTER(?t < 2020) }",
    "recursive": "RULE :Reach :- CONSTRUCT { ?x ex:knows ?z . } "
                 "WHERE { ?x ex:knows ?y . ?y ex:knows ?z . }",
}


@pytest.mark.parametrize("name", sorted(RULES))
def test_rule_statements_match_reference(name):
    ref, tdb = pair()
    q = EX + RULES[name]
    assert port.execute_query_volcano(q, tdb) == ref_execute(q, ref) == []
    assert sorted(tdb.rule_map) == sorted(ref.rule_map) and len(tdb.rule_map) == 1
    (key,) = ref.rule_map
    assert repr(tdb.rule_map[key]) == repr(ref.rule_map[key])
    assert_same_store(ref, tdb)
    assert_same_answers(ref, tdb)


@pytest.mark.parametrize("stream", ["RSTREAM", "ISTREAM", "DSTREAM"])
@pytest.mark.parametrize("name", ["join", "not_block"])
def test_rule_stream_types_match_reference(name, stream):
    """``process_combined_rule`` with each R2S operator at definition
    time: the same emitted facts and the same store."""
    ref, tdb = pair()
    text = RULES[name]
    results = []
    for db, parse, ast, runtime in ((ref, ref_parse_rule, ref_ast, ref_rules),
                                    (tdb, port_parse_rule, port_ast, port_rules)):
        rule = parse(text, db.prefixes)
        rule.stream_type = getattr(ast.StreamType, stream)
        _rule, emitted = runtime.process_combined_rule(db, rule)
        dec = db.decode_term
        results.append({tuple(dec(int(x)) for x in t) for t in emitted})
    assert results[0] == results[1]
    assert (len(results[0]) == 0) == (stream == "DSTREAM")
    assert_same_store(ref, tdb)


@pytest.mark.parametrize("name", ["join", "filter", "iri_filter", "not_block_bound", "recursive"])
def test_rule_closure_on_the_device_fixpoint(name, monkeypatch):
    """With the device threshold at 0 the RULE's closure takes the device
    fixpoint: the reference's store."""
    from kolibrie_tpu_torch.reasoner import device_fixpoint as FX
    from kolibrie_tpu_torch.reasoner.reasoner import Reasoner

    monkeypatch.setattr(Reasoner, "_DEVICE_AUTO_MIN_FACTS", 0)
    ran = []
    infer = FX.DeviceFixpoint.infer
    monkeypatch.setattr(FX.DeviceFixpoint, "infer", lambda self: ran.append(1) or infer(self))
    ref, tdb = pair()
    q = EX + RULES[name]
    port.execute_query_volcano(q, tdb)
    ref_execute(q, ref)
    assert ran
    assert_same_store(ref, tdb)


def test_rule_filter_the_fixpoint_declines_takes_the_host_strategy(monkeypatch):
    """An ordered comparison against a term ID: the device lowering raises
    ``Unsupported`` and the closure runs the host strategy."""
    from kolibrie_tpu_torch.reasoner import device_fixpoint as FX
    from kolibrie_tpu_torch.reasoner.reasoner import Reasoner

    monkeypatch.setattr(Reasoner, "_DEVICE_AUTO_MIN_FACTS", 0)
    declined = []
    orig = FX.infer_semi_naive_device
    monkeypatch.setattr(FX, "infer_semi_naive_device",
                        lambda r: (lambda out: declined.append(out is None) or out)(orig(r)))
    ref, tdb = pair()
    q = EX + "RULE :Later :- CONSTRUCT { ?x ex:after ?y . } WHERE { ?x ex:knows ?y FILTER(?y > ex:cat) }"
    port.execute_query_volcano(q, tdb)
    ref_execute(q, ref)
    assert declined == [True]
    assert_same_store(ref, tdb)


def test_rule_with_prob_raises():
    """RULE … PROB, formerly a pinned raise: each combination closes the
    rule under its semiring over the probability seeds (the host loop on
    the CPU, as the reference off the TPU) and writes the derived facts and
    the ``<< s p o >> prob:value`` tag triples (plus proof explanations for
    wmc / sdd); the port's store and answers equal the reference's."""
    for comb in ("min", "independent", "boolean", "wmc", "sdd", "topk"):
        ref, tdb = pair()
        enc = ref.dictionary.encode
        knows = enc("http://ex.org/knows")
        s, p, o = ref.store.columns()
        for i, (a, b, c) in enumerate(zip(s.tolist(), p.tolist(), o.tolist())):
            if b == knows:
                ref.probability_seeds[(a, b, c)] = 0.5 + 0.07 * i
        tdb.probability_seeds = dict(ref.probability_seeds)
        q = EX + (f"RULE :T PROB(combination={comb}, threshold=0.5) :- CONSTRUCT "
                  "{ ?x ex:fof ?z . } WHERE { ?x ex:knows ?y . ?y ex:knows ?z . }")
        want = ref_execute(q, ref)
        assert port.execute_query_volcano(q, tdb) == want, comb
        assert_same_store(ref, tdb)
        assert_same_answers(ref, tdb)
        star = EX + ("SELECT ?x ?z ?v WHERE { << ?x ex:fof ?z >> "
                     "<http://kolibrie.tpu/prob#value> ?v }")
        rows = ref_execute(star, ref)
        assert port.execute_query_volcano(star, tdb) == rows, comb
        # topk reads k from the threshold: k = 0 keeps no proof, no tag
        assert bool(rows) == (comb != "topk"), comb


@pytest.mark.parametrize(
    "q,construct",
    [
        ('MODEL "m" { ARCH MLP { HIDDEN [4] } OUTPUT EXCLUSIVE { "0", "1" } }', "MODEL"),
        ("REGISTER RSTREAM <http://o> AS SELECT ?a FROM NAMED WINDOW <http://ex.org/w> "
         "ON <http://ex.org/s> [RANGE 4 STEP 2] WHERE { WINDOW <http://ex.org/w> "
         "{ ?a ex:knows ?b } }", None),
        ("SELECT ?a FROM NAMED WINDOW <http://ex.org/w> ON <http://ex.org/s> [RANGE 4 STEP 2] "
         "WHERE { WINDOW <http://ex.org/w> { ?a ex:knows ?b } }", "WINDOW"),
    ],
)
def test_what_still_raises(q, construct):
    """WINDOW blocks raise ``Unsupported`` by name; REGISTER carries
    nothing to run, and a MODEL declaration registers the model, as in the
    reference."""
    ref, tdb = pair()
    if construct is None:
        assert port.execute_query_volcano(EX + q, tdb) == ref_execute(EX + q, ref) == []
        return
    if construct == "MODEL":
        assert port.execute_query_volcano(EX + q, tdb) == ref_execute(EX + q, ref) == []
        assert tdb.model_registry.keys() == ref.model_registry.keys() == {"m"}
        assert tdb.model_registry["m"].arch.hidden == ref.model_registry["m"].arch.hidden == [4]
        assert decoded(tdb) == decoded(ref)
        return
    with pytest.raises(port.Unsupported, match=construct):
        port.execute_query_volcano(EX + q, tdb)


def test_package_exports_match_reference():
    import kolibrie_tpu as ref_pkg

    for name in ("execute_query", "Dictionary", "Triple", "Term", "TriplePattern", "Rule",
                 "FilterCondition", "SparqlDatabase", "Reasoner", "execute_query_volcano"):
        assert name in port.__all__ and name in ref_pkg.__all__, name
        assert getattr(port, name).__module__.startswith("kolibrie_tpu_torch."), name
        assert getattr(port, name).__name__ == getattr(ref_pkg, name).__name__
    d = port.Dictionary()
    t = port.Triple(d.encode("a"), d.encode("p"), d.encode("b"))
    assert tuple(t) == (1, 2, 3)
    rule = port.Rule(
        premise=[port.TriplePattern(port.Term.variable("x"), port.Term.constant(2),
                                    port.Term.variable("y"))],
        negative_premise=[],
        filters=[port.FilterCondition("y", "!=", 1)],
        conclusion=[port.TriplePattern(port.Term.variable("y"), port.Term.constant(2),
                                       port.Term.variable("x"))],
    )
    r = port.Reasoner(d, device="cpu")
    r.facts.add_triple(t)
    r.add_rule(rule)
    assert r.infer_new_facts_semi_naive() == 1
