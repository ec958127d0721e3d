"""The port's distributed SPARQL plans against the JAX package's, on an
8-shard CPU mesh.

``execute_query_distributed`` over the port's ``make_mesh(8,
devices=[cpu] * 8)`` must return the reference's rows in its order on the
surfaces the reference's mesh executor takes: BGP + FILTER (numeric, term
equality, string functions), DISTINCT, ORDER BY + LIMIT / OFFSET (numeric,
string and mixed keys), BIND, VALUES, UNION, OPTIONAL, MINUS, NOT, GROUP
BY aggregates and a sub-SELECT, plus LUBM-2's Q2 and Q9.  LUBM Q2 / Q9
and four surfaces run through the reference's own distributed executor,
per-shard outputs and converged capacities compared too; the rest compare
with the reference's host executor, which the reference's own tests hold
its distributed executor to (``tests/test_dist_query.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import kolibrie_tpu_torch as port
import kolibrie_tpu_torch.parallel as P
from benches.lubm import LUBM_Q2, LUBM_Q9, generate_fast
from kolibrie_tpu.parallel.dist_query import DistQueryExecutor as RefExecutor
from kolibrie_tpu.parallel.dist_query import execute_query_distributed as ref_distributed
from kolibrie_tpu.query.executor import execute_query_volcano as ref_execute
from kolibrie_tpu.query.sparql_database import SparqlDatabase as RefDatabase
from kolibrie_tpu_torch.parallel.dist_query import DistQueryExecutor, Unsupported
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

EX = "PREFIX ex: <http://example.org/>\n"


def twin(ref: RefDatabase):
    db = port.SparqlDatabase.from_arrays(
        ref.dictionary.id_to_str, *ref.store.columns(), quoted=dict(ref.quoted.items()),
        device="cpu",
    )
    db.execution_mode = ref.execution_mode = "host"
    return db


def corpus_ntriples(n: int = 240) -> str:
    names = ["Alice Smith", "Bob Stone", "Carol Quinn", "Dan Smithers"]
    words = ["apple", "banana", "cherry", "date", "elder"]
    lines = []
    for i in range(n):
        e = f"<http://example.org/e{i}>"
        lines += [
            f"{e} <http://example.org/worksAt> <http://example.org/org{i % 9}> .",
            f'{e} <http://example.org/salary> "{30000 + (i % 40) * 1000}" .',
            f"{e} <http://example.org/dept> <http://example.org/d{i % 6}> .",
            f'{e} <http://example.org/name> "{names[i % 4]} {i}" .',
            f'{e} <http://example.org/grade> "g{i % 4}" .',
            f'{e} <http://example.org/tag> "{words[i % 5]}_{i:03d}" .',
        ]
        if i % 3 == 0:
            lines.append(f"{e} <http://example.org/knows> <http://example.org/e{(i + 1) % n}> .")
        if i % 5 == 0:
            lines.append(f'{e} <http://example.org/nick> "n{i}" .')
    for k in range(9):
        lines.append(f'<http://example.org/org{k}> <http://example.org/budget> "{k * 1000 + 500}" .')
    # the one non-numeric value of ?v: most shards never see it
    lines.append('<http://example.org/e7> <http://example.org/v> "apple" .')
    for i in range(1, 25):
        lines.append(f'<http://example.org/e{i + 7}> <http://example.org/v> "{i}" .')
    # ?w: the same, but one shard holds more rows than the top-k keeps
    lines.append('<http://example.org/e7> <http://example.org/w> "apple" .')
    for i in range(1, 41):
        lines.append(f'<http://example.org/e{i + 7}> <http://example.org/w> "{i}" .')
    return "\n".join(lines)


@pytest.fixture(scope="module")
def mesh():
    return P.make_mesh(8, devices=[torch.device("cpu")] * 8)


@pytest.fixture(scope="module")
def corpus():
    ref = RefDatabase()
    ref.parse_ntriples(corpus_ntriples())
    return ref, twin(ref)


@pytest.fixture(scope="module")
def lubm2():
    ref = RefDatabase()
    ref.store.add_batch(*generate_fast(2, ref.dictionary))
    return ref, twin(ref)


SURFACE = {
    "filter_distinct": "SELECT DISTINCT ?o WHERE { ?e ex:worksAt ?o . ?e ex:salary ?s . "
                       "FILTER(?s > 55000) }",
    "term_equality": "SELECT ?e ?s WHERE { ?e ex:worksAt ?o . ?e ex:salary ?s . "
                     "FILTER(?o = ex:org3) }",
    "string_functions": 'SELECT ?e ?n WHERE { ?e ex:worksAt ?o . ?e ex:name ?n . '
                        'FILTER(STRENDS(?n, "7") && CONTAINS(?n, "o")) }',
    "regex": 'SELECT ?e ?n WHERE { ?e ex:worksAt ?o . ?e ex:name ?n . '
             'FILTER(REGEX(?n, "S(mith|tone)")) }',
    "topk_desc": "SELECT ?e ?s WHERE { ?e ex:worksAt ?o . ?e ex:salary ?s } "
                 "ORDER BY DESC(?s) ?e LIMIT 7",
    "distinct_topk_offset": "SELECT DISTINCT ?o ?b WHERE { ?e ex:worksAt ?o . ?o ex:budget ?b } "
                            "ORDER BY DESC(?b) LIMIT 4 OFFSET 2",
    "string_topk": "SELECT ?e ?t WHERE { ?e ex:worksAt ?o . ?e ex:tag ?t } ORDER BY ?t LIMIT 7",
    "mixed_key_topk": "SELECT ?e ?v WHERE { ?e ex:worksAt ?o . ?e ex:v ?v } ORDER BY ?v LIMIT 8",
    "bind": "SELECT ?e ?total WHERE { ?e ex:worksAt ?o . ?e ex:salary ?s . "
            "BIND(?s * 1.1 AS ?total) FILTER(?total > 60000) }",
    "values": 'SELECT ?e ?o WHERE { ?e ex:worksAt ?o . ?e ex:grade ?g . VALUES ?g { "g1" "g3" } }',
    "union": "SELECT ?e ?x WHERE { ?e ex:worksAt ?o . { ?e ex:knows ?x } UNION { ?e ex:nick ?x } }",
    "optional": "SELECT ?e ?s ?k WHERE { ?e ex:salary ?s . OPTIONAL { ?e ex:knows ?k } }",
    "minus": "SELECT ?e ?s WHERE { ?e ex:salary ?s MINUS { ?e ex:knows ?y } }",
    "not_block": "SELECT ?e ?o WHERE { ?e ex:worksAt ?o . NOT { ?e ex:knows ?y } }",
    "minus_multikey": "SELECT ?e ?y WHERE { ?e ex:knows ?y "
                      "MINUS { ?e ex:worksAt ?o . ?y ex:worksAt ?o } }",
    "union_optional_minus": "SELECT ?e ?x ?k WHERE { ?e ex:worksAt ?o . "
                            "{ ?e ex:knows ?x } UNION { ?e ex:nick ?x } "
                            "OPTIONAL { ?e ex:grade ?k } MINUS { ?e ex:dept ex:d0 } }",
    "group_by": "SELECT ?d (COUNT(?e) AS ?n) (AVG(?s) AS ?avg) (MAX(?s) AS ?mx) WHERE { "
                "?e ex:dept ?d . ?e ex:salary ?s } GROUP BY ?d",
    "count_distinct": "SELECT ?d (COUNT(DISTINCT ?s) AS ?k) WHERE { ?e ex:dept ?d . "
                      "?e ex:salary ?s . FILTER(?s > 40000) } GROUP BY ?d",
    "subselect": "SELECT ?e ?s WHERE { ?e ex:salary ?s . "
                 "{ SELECT ?e WHERE { ?e ex:worksAt ex:org4 } } }",
    "repeated_variable": "SELECT ?x WHERE { ?x ex:knows ?x }",
}

# the surfaces also run through the reference's distributed executor
THROUGH_REF_MESH = ("filter_distinct", "mixed_key_topk", "union", "group_by")


@pytest.mark.parametrize("name", sorted(SURFACE))
def test_surface_rows_match_reference(mesh, mesh8, corpus, name):
    ref, db = corpus
    q = EX + SURFACE[name]
    want = ref_execute(q, ref)
    got = P.execute_query_distributed(q, db, mesh)
    assert got == want
    if name != "repeated_variable":
        assert want, name
    if name in THROUGH_REF_MESH:
        assert ref_distributed(q, ref, mesh8) == got


@pytest.mark.parametrize("query", [LUBM_Q2, LUBM_Q9], ids=["q2", "q9"])
def test_lubm_per_shard_outputs_match_reference(mesh, mesh8, lubm2, query):
    ref, db = lubm2
    rex = RefExecutor(mesh8, ref, query)
    ex = DistQueryExecutor(mesh, db, query)
    assert (ex.join_cap, ex.bucket_cap) == (rex.join_cap, rex.bucket_cap)
    fields = lambda ps: [(p.consts, p.vars, p.eq_pairs) for p in ps]  # noqa: E731
    assert (ex.seed, ex.steps, fields(ex.premises)) == (rex.seed, rex.steps, fields(rex.premises))
    routs, rvalid, rtotal, _ = rex.run_device()
    outs, valid, total, _ = ex.run_device()
    assert int(total) == int(np.asarray(rtotal)[0]) > 0
    np.testing.assert_array_equal(np.stack([v.numpy() for v in valid]), np.asarray(rvalid))
    for k in range(len(ex.out_vars)):
        np.testing.assert_array_equal(np.stack([o[k].numpy() for o in outs]), np.asarray(routs[k]))
    rows = ex.run()
    assert rows == rex.run() == ref_execute(query, ref)


def test_string_key_cut_from_every_top_k_matches_reference_mesh(mesh, mesh8, corpus):
    """When the one non-numeric sort value falls outside every shard's
    top-k, the host re-order of the gathered union sorts it numerically:
    the reference's mesh executor answers so, and the port answers as it
    does (its host executor, seeing every row, sorts by string)."""
    ref, db = corpus
    q = EX + "SELECT ?e ?w WHERE { ?e ex:worksAt ?o . ?e ex:w ?w } ORDER BY ?w LIMIT 8"
    assert P.execute_query_distributed(q, db, mesh) == ref_distributed(q, ref, mesh8)


def test_distinct_bucket_overflow_retry(mesh, corpus):
    ref, db = corpus
    q = EX + "SELECT DISTINCT ?o WHERE { ?e ex:worksAt ?o }"
    ex = DistQueryExecutor(mesh, db, q, join_cap=512, bucket_cap=8)
    assert ex.run() == ref_execute(q, ref)
    assert ex.bucket_cap > 8  # the overflow protocol doubled the caps


def test_unsupported_shapes_raise(mesh, corpus):
    _ref, db = corpus
    for q in (
        'SELECT ?e WHERE { ?e ex:grade ?g . VALUES ?g { "g1" "g1" } }',  # bag multiplicity
        "SELECT ?e ?d WHERE { ?e ex:worksAt ?o . ?d ex:budget ?b }",  # cartesian
        "SELECT ?e WHERE { ?e ex:worksAt ?o . FILTER(BOUND(?o)) }",  # filter function
        "SELECT ?e (CONCAT(?o, ?o) AS ?c) WHERE { ?e ex:worksAt ?o }",  # expression
    ):
        with pytest.raises(Unsupported):
            DistQueryExecutor(mesh, db, EX + q)


def test_executor_reuses_a_prebuilt_store(mesh, lubm2):
    ref, db = lubm2
    s, p, o = db.store.columns()
    store = P.ShardedTripleStore.from_columns(mesh, s, p, o)
    for q in (LUBM_Q2, LUBM_Q9):
        ex = DistQueryExecutor(mesh, db, q, store=store)
        assert ex.run() == ex.run() == ref_execute(q, ref)
        assert ex.store is store
