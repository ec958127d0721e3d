"""The plain reference against the port on the CPU at LUBM(1): the same
closure over the rule file, and the same rows for every query file, over
the closure and over the plain store.  (The
tests may import both; the reference imports nothing of the port.)"""

from collections import Counter

import pytest

from conftest import tiny_cell
from portbench import lubm_gen, spec
from portbench.check import Reference
from portbench.harness import FixpointRounds, add_rules

QUERIES = ["q2", "q9"]


@pytest.fixture(scope="module")
def rdfs():
    """LUBM(1) under the univ-bench rules: the port's closure (device
    fixpoint on CPU tensors), its database, and the reference."""
    from kolibrie_tpu_torch import Reasoner, SparqlDatabase

    c = tiny_cell("lubm100-rdfs.materialize", 1)
    g = lubm_gen.generate(c["config"], 21, extra_terms=spec.constants(c["config"], QUERIES))
    r = Reasoner.from_arrays(g.terms, g.s, g.p, g.o, device="cpu")
    add_rules(r, spec.rules(c["config"]))
    with FixpointRounds() as fr:
        r.infer_new_facts_semi_naive_parallel()
    assert fr.rounds, "the port's closure took the host strategy"
    db = SparqlDatabase.from_arrays(r.dictionary.id_to_str, *r.facts.columns(), device="cpu")
    db.execution_mode = "device"
    return {"g": g, "reasoner": r, "db": db, "ref": Reference(c["config"], g), "config": c["config"]}


def test_closure_equals_the_ports(rdfs):
    ref = rdfs["ref"]
    assert ref.fact_mismatch(rdfs["reasoner"].facts.columns()) == 0
    assert len(ref.keys) == len(rdfs["reasoner"].facts)
    assert len(ref.keys) > len(rdfs["g"])


def test_one_round_is_not_the_closure(rdfs):
    weak = Reference(rdfs["config"], rdfs["g"], rounds=1)
    assert rdfs["ref"].fact_mismatch(weak.codec.decode(weak.keys)) > 0


@pytest.mark.parametrize("query", QUERIES)
def test_query_rows_equal_the_ports(rdfs, query):
    from kolibrie_tpu_torch import execute_query_volcano

    text = spec.query_text(query)
    want = rdfs["ref"].answer(text)
    got = Counter(map(tuple, execute_query_volcano(text, rdfs["db"])))
    assert got == want
    assert want, f"{query}: the answer is empty"


def test_plain_store_rows_equal_the_ports():
    from kolibrie_tpu_torch import SparqlDatabase, execute_query_volcano

    c = tiny_cell("lubm100.analytic", 2)
    g = lubm_gen.generate(c["config"], 4, extra_terms=spec.constants(c["config"], ["q2", "q9"]))
    db = SparqlDatabase.from_arrays(g.terms, g.s, g.p, g.o, device="cpu")
    db.execution_mode = "device"
    ref = Reference(c["config"], g)
    for q in ("q2", "q9"):
        text = spec.query_text(q)
        assert Counter(map(tuple, execute_query_volcano(text, db))) == ref.answer(text)
    assert sum(ref.answer(spec.query_text("q2")).values()) > 0
    assert sum(ref.answer(spec.query_text("q9")).values()) > 100
