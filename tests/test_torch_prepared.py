"""The port's host twin and prepared queries against the JAX package.

``LoweredPlan.host_execute`` (the numpy evaluation of the whole spec tree)
must give the reference's table, exact per-join counts and per-operator
row counts for every spec kind the port lowers: Scan, Values, Join,
Filter, QuotedExpand, AntiJoin, Union, LeftOuter and Wcoj, on stores with
a delta segment and tombstones.  ``PreparedQuery`` must fetch the
reference's rows, ``run_amortized`` must give its per-iteration row
counts and checksums (exact modulo 2^64: the port sums int64 carriers,
the reference uint64), ``run`` / ``run_amortized`` must read nothing back
(``fetch_counters`` unchanged), and the host twin's counts must equal the
converged device counts, so a calibrated first run never overflows.  No
tolerance is used: rows, counts, stats and checksums are exact.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

import kolibrie_tpu_torch as port
from kolibrie_tpu.query.sparql_database import SparqlDatabase as RefDatabase
from test_torch_clauses import PREFIXES, employee_db, pair, rdf_star_db
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

MOD64 = 1 << 64


def lower_both(pkg: str, db, q: str):
    """``q``'s group planned and lowered by package ``pkg`` with its clause
    branches fused (the executor's device path)."""
    parser = importlib.import_module(f"{pkg}.query.parser")
    engine = importlib.import_module(f"{pkg}.optimizer.engine")
    planner_m = importlib.import_module(f"{pkg}.optimizer.planner")
    de = importlib.import_module(f"{pkg}.optimizer.device_engine")
    ex = importlib.import_module(f"{pkg}.query.executor")
    ast = importlib.import_module(f"{pkg}.query.ast")
    db.register_prefixes_from_query(q)
    w = parser.parse_combined_query(q, db.prefixes).select.where
    planner = planner_m.Streamertail(db.get_or_build_stats())
    resolved = [engine.resolve_pattern(db, p) for p in w.patterns]
    logical = planner_m.build_logical_plan(resolved, list(w.filters), [], w.values)
    plan = planner.find_best_plan(logical)
    unions = tuple(tuple(ex._branch_plan(db, planner, b) for b in g) for g in w.unions)
    optionals = tuple(ex._branch_plan(db, planner, b) for b in w.optionals)
    antis = tuple(
        ex._branch_plan(db, planner, b)
        for b in list(w.minus) + [ast.WhereClause(patterns=nb.patterns) for nb in w.not_blocks]
    )
    return de.lower_plan(db, plan, antis, unions, optionals)


GRAPH_MUTATIONS = (
    "INSERT DATA { " + " ".join(f"ex:n{i} ex:knows ex:n{(i + 3) % 60} ." for i in range(0, 60, 7))
    + " }",
    "DELETE DATA { ex:n1 ex:knows ex:n2 . ex:n4 ex:knows ex:n5 . ex:n2 ex:type ex:T2 }",
)


def graph_pair():
    """A small cyclic graph (triangles for the WCOJ node) with typed nodes,
    then the same delta under the threshold in both packages — inserts and
    deletes, so scans and WCOJ levels see base rows, delta rows and
    tombstones."""
    from kolibrie_tpu.query.executor import execute_query_volcano as ref_execute

    db = RefDatabase()
    lines = []
    for i in range(60):
        for j in (1, 2, 57, 59):
            lines.append(f"<http://example.org/n{i}> <http://example.org/knows> "
                         f"<http://example.org/n{(i + j) % 60}> .")
        lines.append(f"<http://example.org/n{i}> <http://example.org/type> "
                     f"<http://example.org/T{i % 4}> .")
        lines.append(f'<http://example.org/n{i}> <http://example.org/age> "{20 + i % 30}" .')
    db.parse_ntriples("\n".join(lines))
    ref, tdb = pair(db)
    for stmt in GRAPH_MUTATIONS:
        ref_execute(PREFIXES + stmt, ref)
        port.execute_query_volcano(PREFIXES + stmt, tdb)
    assert tdb.store.delta_epoch > 0 and tdb.store.version_key()[0] == tdb.store.base_version
    return ref, tdb


HOST_CORPUS = {
    # (database, query)
    "scan_join_filter": ("emp", 'SELECT ?e ?s WHERE { ?e ex:dept "dept1" . ?e ex:salary ?s . '
                                "FILTER(?s > 60000) }"),
    "filter_or_not": ("emp", "SELECT ?e ?s WHERE { ?e ex:salary ?s . "
                             "FILTER(?s < 35000 || !(?s != 70000)) }"),
    "string_mask": ("emp", 'SELECT ?e ?d WHERE { ?e ex:dept ?d . FILTER(CONTAINS(?d, "3")) }'),
    "values": ("emp", 'SELECT ?e ?d ?w WHERE { ?e ex:dept ?d . ?e foaf:workplaceHomepage ?w . '
                      'VALUES (?d ?w) { ("dept1" <http://company2.example/>) '
                      '("dept4" <http://company0.example/>) } }'),
    "union": ("emp", 'SELECT ?e ?x WHERE { ?e ex:salary ?x { ?e ex:dept "dept0" } UNION '
                     '{ ?e ex:knows ?y } }'),
    "optional": ("emp", "SELECT ?e ?s ?y WHERE { ?e ex:salary ?s . OPTIONAL { ?e ex:knows ?y } }"),
    "minus_not": ("emp", 'SELECT ?e ?s WHERE { ?e ex:salary ?s MINUS { ?e ex:dept "dept1" } '
                         "NOT { ?e ex:knows ?y } }"),
    "quoted": ("star", "SELECT ?s ?o ?c WHERE { ?s ex:knows ?o . << ?s ex:age ?v >> ex:certainty ?c }"),
    "quoted_repeat": ("star", "SELECT ?x ?c WHERE { << ?x ex:likes ?x >> ex:certainty ?c }"),
    "wcoj_triangle": ("graph", "SELECT ?a ?b ?c WHERE { ?a ex:knows ?b . ?b ex:knows ?c . "
                               "?c ex:knows ?a }"),
    "wcoj_typed": ("graph", "SELECT ?a ?b ?c WHERE { ?a ex:knows ?b . ?b ex:knows ?c . "
                            "?a ex:knows ?c . ?a ex:type ex:T1 }"),
    "chain_delta": ("graph", "SELECT ?a ?c ?g WHERE { ?a ex:knows ?b . ?b ex:knows ?c . "
                             "?c ex:age ?g . FILTER(?g >= 40) }"),
}


@pytest.fixture(scope="module")
def dbs():
    return {"emp": pair(employee_db(300)), "star": pair(rdf_star_db()), "graph": graph_pair()}


def as_rows(table, out_vars):
    return list(zip(*[np.asarray(table[v]).astype(np.int64).tolist() for v in out_vars]))


@pytest.mark.parametrize("name", sorted(HOST_CORPUS))
def test_host_execute_matches_reference(dbs, name):
    key, q = HOST_CORPUS[name]
    ref, tdb = dbs[key]
    r = lower_both("kolibrie_tpu", ref, PREFIXES + q)
    t = lower_both("kolibrie_tpu_torch", tdb, PREFIXES + q)
    assert t.out_vars == r.out_vars
    rtab, rcounts = r.host_execute()
    ttab, tcounts = t.host_execute()
    assert tcounts == rcounts
    assert as_rows(ttab, t.out_vars) == as_rows(rtab, r.out_vars)
    assert t.last_host_stats == r.last_host_stats
    assert t.describe(tcounts) == r.describe(rcounts)


@pytest.mark.parametrize("name", sorted(HOST_CORPUS))
def test_twin_counts_equal_converged_counts(dbs, name):
    """calibrate_host's exact counts are the counts a device run converges
    to, so a calibrated first run never overflows."""
    key, q = HOST_CORPUS[name]
    _ref, tdb = dbs[key]
    low = lower_both("kolibrie_tpu_torch", tdb, PREFIXES + q)
    counts = low.calibrate_host()
    caps = list(low._join_caps)
    table = low.execute()
    assert low._last_counts == counts
    assert low._join_caps == caps  # no overflow retry
    twin, _ = low.host_execute()
    assert sorted(as_rows(table, low.out_vars)) == sorted(as_rows(twin, low.out_vars))


PREPARED = {
    "emp_join": ("emp", 'SELECT ?e ?s WHERE { ?e ex:dept "dept2" . ?e ex:salary ?s . '
                        "FILTER(?s >= 50000) }"),
    "triangle": ("graph", "SELECT ?a ?b ?c WHERE { ?a ex:knows ?b . ?b ex:knows ?c . ?c ex:knows ?a }"),
    "chain": ("graph", "SELECT ?a ?c WHERE { ?a ex:knows ?b . ?b ex:knows ?c . ?c ex:type ex:T3 }"),
}


@pytest.mark.parametrize("name", sorted(PREPARED))
def test_prepared_query_matches_reference(dbs, name):
    from kolibrie_tpu.optimizer.device_engine import PreparedQuery as RefPrepared
    from kolibrie_tpu_torch.optimizer import device_engine as tde

    key, q = PREPARED[name]
    ref, tdb = dbs[key]
    rp = RefPrepared(ref, PREFIXES + q)
    tp = tde.PreparedQuery(tdb, PREFIXES + q)
    rp.calibrate()
    tp.calibrate()
    assert tp.lowered._join_caps == rp.lowered._join_caps
    before = tde.fetch_counters()
    outs = [tp.run() for _ in range(3)]
    sums, nrows = tp.run_amortized(4)
    assert tde.fetch_counters() == before, "run()/run_amortized() read back"
    want = rp.fetch(rp.run())
    assert tp.fetch(outs[-1]) == want
    assert want
    rsums, rrows = rp.run_amortized(4)
    assert nrows.tolist() == [int(x) for x in np.asarray(rrows)]
    assert [int(x) % MOD64 for x in sums.tolist()] == [int(x) % MOD64 for x in np.asarray(rsums)]
    assert len(set(sums.tolist())) == 1


def test_prepared_query_declines_like_reference(dbs):
    from kolibrie_tpu.optimizer.device_engine import PreparedQuery as RefPrepared
    from kolibrie_tpu.optimizer.device_engine import Unsupported as RefUnsupported
    from kolibrie_tpu_torch.optimizer import device_engine as tde

    ref, tdb = dbs["emp"]
    for q in ("SELECT ?e WHERE { ?e ex:dept ?d . BIND(?d AS ?x) }",
              "INSERT DATA { ex:a ex:b ex:c }",
              'SELECT ?e WHERE { ?e ex:dept "dept1" . ex:e1 ex:dept "dept1" }'):
        with pytest.raises(RefUnsupported):
            RefPrepared(ref, PREFIXES + q)
        with pytest.raises(tde.Unsupported):
            tde.PreparedQuery(tdb, PREFIXES + q)


def test_chip_smoke_phase13_rehearsal():
    """``chip_smoke.py`` phase 13 end to end on the CPU at LUBM-2, 600
    employees and a fleet of 700 subjects (the card runs LUBM-1000,
    employee-100K and 50,000): every check of the phase holds but the
    compile cache's counters, which count kernel libraries (none load on
    the CPU)."""
    import torch

    import chip_smoke as CS
    from benches.lubm import LUBM_Q2, LUBM_Q9, generate_fast

    lubm = port.SparqlDatabase(device="cpu")
    s, p, o = generate_fast(2, lubm.dictionary)
    lubm.store.add_batch(s, p, o)
    emp = port.SparqlDatabase(device="cpu")
    emp.parse_ntriples(CS.employee_ntriples(600))
    # the device program, as LUBM-1000 and employee-100K take it on the card
    lubm.execution_mode = emp.execution_mode = "device"
    rows = {"employee": port.execute_query_volcano(CS.EMPLOYEE_QUERY, emp),
            "q2": port.execute_query_volcano(LUBM_Q2, lubm),
            "q9": port.execute_query_volcano(LUBM_Q9, lubm)}
    out = CS.run_repeated_phase(torch.device("cpu"), {"rows": rows}, lubm, emp, universities=2,
                                variants=8, fleet_rows=700, fleet_queries=8, runs=3, k=2)
    rep = out["report"]
    assert rep["13a_q9"]["rows"] == len(rows["q9"]) > 0
    assert rep["13c"]["source"] == "interp" and rep["13c"]["q9_source"] == "compiled"
    assert rep["13d"]["prefix"]["shared_evals"] == 1 and rep["13d"]["prefix_on_card"]
    assert set(rep["13b_employee"]["count_reads"]) == {"solo", "uncached", "solo_again"}
    assert rep["13f"]["sources"] and rep["13f"]["child"] == {"hits": 0, "misses": 0}
    assert out["captured"]["merge_path_join"][0] > 0
