"""The PyTorch port's host engine (the plans the device lowering declines)
against the JAX package's host engine, and the legacy textual join order.

Both packages hold the same database: the reference loads it and the port's
``SparqlDatabase.from_arrays`` takes its dictionary, quoted table and
columns, so every ID matches; mutations are replayed on both stores.  The
reference runs with its own default routes (at these sizes its host engine
answers everything); the port runs on ``device="cpu"``, where the kernel
wrappers take their plain versions.

Compared exactly, with no tolerance: the table ``execute_with_ids`` returns
for a plan, column by column and row by row (the port reads the store's
device mirror and joins on the merge-path kernel, in the reference's row
order), rows of whole queries (in order under ORDER BY, ties included), and
``chip_smoke.py`` phase 8's routes and launch table at LUBM-3.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

import chip_smoke as CS
import kolibrie_tpu_torch as port
from benches.lubm import generate_fast
from kolibrie_tpu.query.executor import execute_query as ref_execute_query
from kolibrie_tpu.query.executor import execute_query_volcano as ref_execute
from kolibrie_tpu.query.sparql_database import SparqlDatabase as RefDatabase
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

H = "PREFIX h: <http://h.e/>\n"


def port_twin(ref: RefDatabase):
    db = port.SparqlDatabase.from_arrays(
        ref.dictionary.id_to_str, *ref.store.columns(), quoted=dict(ref.quoted.items()),
        device="cpu",
    )
    db.execution_mode = ref.execution_mode  # routed as the reference is
    return db


def random_graph(seed: int = 11) -> RefDatabase:
    """IRIs, numeric and string literals over four predicates, and an
    ``h:since`` annotation on some ``h:p0`` facts (quoted subjects)."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(260):
        s = f"<http://h.e/n{rng.integers(30)}>"
        p = f"<http://h.e/p{rng.integers(4)}>"
        r = rng.random()
        if r < 0.5:
            o = f"<http://h.e/n{rng.integers(30)}>"
        elif r < 0.8:
            o = f'"{rng.integers(0, 300)}"'
        else:
            o = f'"word{rng.integers(12)} tail"'
        lines.append(f"{s} {p} {o} .")
    ref = RefDatabase()
    ref.parse_ntriples("\n".join(lines))
    enc = ref.dictionary.encode
    s, p, o = ref.store.columns()
    p0 = np.flatnonzero(p == enc("http://h.e/p0"))[::3]
    qids = [ref.quoted.intern(int(s[i]), int(p[i]), int(o[i])) for i in p0]
    years = [enc(f'"{2000 + k % 7}"') for k in range(len(qids))]
    ref.store.add_batch(
        np.array(qids, np.uint32), np.full(len(qids), enc("http://h.e/since"), np.uint32),
        np.array(years, np.uint32),
    )
    return ref


def mutate(ref: RefDatabase, tdb) -> None:
    """The same adds and removes on both stores: a delta and tombstones."""
    enc = ref.dictionary.encode
    s, p, o = ref.store.columns()
    adds = [(enc(f"http://h.e/n{i}"), enc(f"http://h.e/p{i % 4}"), enc(f"http://h.e/n{i + 3}"))
            for i in range(0, 24, 2)]
    removes = list(zip(s[5::17].tolist(), p[5::17].tolist(), o[5::17].tolist()))
    for db in (ref, tdb):
        len(db.store)  # compacted: the mutations land in the delta
        for t in adds:
            db.store.add(*t)
        for t in removes:
            db.store.remove(*t)
    # the port's mirror holds delta rows and tombstones beside its base
    assert tdb.store.delta_epoch > 0
    sig = tdb.store.segment_signature()
    assert sig[2] > 0 and sig[3] > 0, sig


@pytest.fixture(scope="module", params=["base", "delta"])
def graph(request):
    ref = random_graph()
    # the device program as on the card's full-width stores ("auto" routes
    # a store this small to the host engine)
    ref.execution_mode = "device"
    tdb = port_twin(ref)
    if request.param == "delta":
        mutate(ref, tdb)
    return ref, tdb


def plan_table(pkg: str, db, q: str, build=None):
    """Plan ``q``'s group with package ``pkg`` (``build`` may wrap the
    plan) and run it through that package's ``execute_with_ids``."""
    parser = importlib.import_module(f"{pkg}.query.parser")
    engine = importlib.import_module(f"{pkg}.optimizer.engine")
    planner = importlib.import_module(f"{pkg}.optimizer.planner")
    executor = importlib.import_module(f"{pkg}.query.executor")
    plan_mod = importlib.import_module(f"{pkg}.optimizer.plan")
    db.register_prefixes_from_query(q)
    select = parser.parse_combined_query(q, db.prefixes).select
    where = select.where
    resolved = [engine.resolve_pattern(db, p) for p in where.patterns]
    logical = planner.build_logical_plan(resolved, list(where.filters), [], where.values)
    plan = planner.Streamertail(db.get_or_build_stats()).find_best_plan(logical)
    if build is not None:
        plan = build(plan_mod, plan, where)
    eng = engine.ExecutionEngine(
        db, subquery_eval=lambda sq: executor.eval_select_to_table(db, sq.query)
    )
    return plan, eng.execute_with_ids(plan)


def assert_same_table(want, got):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.uint32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def with_bind(P, plan, where):
    return P.PhysBind(where.binds[0], plan)


def with_projection(P, plan, where):
    return P.PhysProjection(["a", "v"], plan)


def with_subquery(P, plan, where):
    return P.PhysHashJoin(plan, P.PhysSubquery(where.subqueries[0]), ["a"], optimized=True)


PLANS = {
    "table_scan": ("SELECT * WHERE { ?s ?p ?o }", None),
    "scan_s": ("SELECT * WHERE { <http://h.e/n3> ?p ?o }", None),
    "scan_p": ("SELECT * WHERE { ?s h:p1 ?o }", None),
    "scan_o": ("SELECT * WHERE { ?s ?p <http://h.e/n4> }", None),
    "scan_sp": ("SELECT * WHERE { <http://h.e/n3> h:p0 ?o }", None),
    "scan_so": ("SELECT * WHERE { <http://h.e/n3> ?p <http://h.e/n7> }", None),
    "scan_po": ("SELECT * WHERE { ?s h:p2 <http://h.e/n5> }", None),
    "scan_const": ("SELECT * WHERE { <http://h.e/n3> h:p0 <http://h.e/n7> }", None),
    "repeated_var": ("SELECT * WHERE { ?x ?p ?x }", None),
    "join": ("SELECT * WHERE { ?a h:p0 ?b . ?b h:p1 ?c }", None),
    "three_key_join": ("SELECT * WHERE { ?s ?p ?o . ?o ?p ?s }", None),
    "star": ("SELECT * WHERE { ?a h:p0 ?b . ?a h:p1 ?c . ?a h:p2 ?d }", None),
    "cartesian": ("SELECT * WHERE { ?a h:p0 <http://h.e/n2> . ?c h:p3 ?d }", None),
    "cartesian_join": ("SELECT * WHERE { ?a h:p0 ?b . ?b h:p1 ?c . ?x h:p3 <http://h.e/n1> }", None),
    "unknown_constant": ("SELECT * WHERE { ?a h:nothing ?b . ?a h:p0 ?c }", None),
    "values": ("SELECT * WHERE { VALUES ?a { <http://h.e/n1> <http://h.e/n2> <http://h.e/zz> } "
               "?a h:p0 ?b }", None),
    "values_only": ("SELECT * WHERE { VALUES (?a ?b) { (<http://h.e/n1> UNDEF) "
                    "(<http://h.e/n2> \"7\") } }", None),
    "quoted": ("SELECT * WHERE { << ?a h:p0 ?b >> h:since ?y }", None),
    "quoted_inner_const": ("SELECT * WHERE { << ?a h:p0 <http://h.e/n3> >> h:since ?y }", None),
    "quoted_unknown_inner": ("SELECT * WHERE { << ?a h:nothing ?b >> h:since ?y }", None),
    "filter_numeric": ("SELECT * WHERE { ?a h:p1 ?v FILTER(?v > 100 && ?v <= 250) }", None),
    "filter_arith": ("SELECT * WHERE { ?a h:p1 ?v . ?a h:p2 ?w FILTER(?v * 2 - 10 >= ?w) }", None),
    "filter_var_var": ("SELECT * WHERE { ?a h:p1 ?v . ?a h:p3 ?w FILTER(?v != ?w) }", None),
    "filter_iri": ("SELECT * WHERE { ?a h:p0 ?b FILTER(?b = <http://h.e/n5> || "
                   "?b != <http://h.e/none>) }", None),
    "filter_string_lit": ('SELECT * WHERE { ?a ?p ?v FILTER(?v = "word3 tail" || ?v < "3") }', None),
    "filter_regex_str": ('SELECT * WHERE { ?a ?p ?v FILTER(REGEX(STR(?v), "^word[1-3]")) }', None),
    "filter_strlen": ("SELECT * WHERE { ?a h:p2 ?v FILTER(STRLEN(?v) > 2 && ?v > 20) }", None),
    "filter_mixed": ('SELECT * WHERE { ?a h:p1 ?v FILTER(!(CONTAINS(?v, "tail")) || '
                     "(BOUND(?a) && ABS(?v - 150) < 60)) }", None),
    "filter_istriple": ("SELECT * WHERE { ?q h:since ?y FILTER(ISTRIPLE(?q) && !BOUND(?zz)) }", None),
    "bind": ("SELECT * WHERE { ?a h:p1 ?v BIND(?v + 1 AS ?w) }", with_bind),
    "projection": ("SELECT * WHERE { ?a h:p1 ?v . ?a h:p0 ?b }", with_projection),
    "subquery": ("SELECT * WHERE { ?a h:p0 ?b . { SELECT ?a WHERE { ?a h:p1 ?c } } }",
                 with_subquery),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_execute_with_ids_matches_reference(graph, name):
    """Every operator case of ``execute_with_ids``: the same table, row for
    row, over the base store and over a store with a delta and tombstones."""
    ref, tdb = graph
    q, build = PLANS[name]
    ref_plan, want = plan_table("kolibrie_tpu", ref, H + q, build)
    plan, got = plan_table("kolibrie_tpu_torch", tdb, H + q, build)
    assert type(plan).__name__ == type(ref_plan).__name__
    assert_same_table(want, got)


def test_wcoj_node_runs_as_binary_joins(graph, monkeypatch):
    ref, tdb = graph
    monkeypatch.setenv("KOLIBRIE_WCOJ", "force")
    q = H + "SELECT * WHERE { ?x h:p0 ?y . ?y h:p0 ?z . ?z h:p1 ?x }"
    _ref_plan, want = plan_table("kolibrie_tpu", ref, q)
    plan, got = plan_table("kolibrie_tpu_torch", tdb, q)
    assert type(plan).__name__ == "WcojNode"
    assert_same_table(want, got)


def test_wcoj_node_joins_connected_scans_first(graph, monkeypatch):
    """A cyclic pattern listed with two unconnected scans first: the
    reference's host engine joins them as a cartesian product, the port's
    takes a connected scan first (no join without a shared variable); the
    same rows."""
    from kolibrie_tpu_torch.optimizer import engine as E

    ref, tdb = graph
    monkeypatch.setenv("KOLIBRIE_WCOJ", "force")
    q = H + "SELECT * WHERE { ?x h:p0 ?y . ?z h:p0 ?w . ?y h:p0 ?z . ?w h:p0 ?x }"
    shared = []
    join = E.equi_join_device

    def spy(left, right):
        shared.append(bool(set(left) & set(right)))
        return join(left, right)

    monkeypatch.setattr(E, "equi_join_device", spy)
    _ref_plan, want = plan_table("kolibrie_tpu", ref, q)
    plan, got = plan_table("kolibrie_tpu_torch", tdb, q)
    assert type(plan).__name__ == "WcojNode" and len(plan.scans) == 4
    assert shared == [True, True, True]
    keys = sorted(want)
    assert sorted(got) == keys
    rows = lambda t: sorted(zip(*(t[k].tolist() for k in keys)))  # noqa: E731
    assert rows(got) == rows(want) and len(rows(want)) > 0


# ------------------------------------------------------- whole queries

DECLINED = {
    # the device lowering's four declines: cartesian join, filter function,
    # constant-only query, group of clauses only
    "cartesian": "SELECT ?a ?d WHERE { ?a h:p0 <http://h.e/n2> . ?c h:p3 ?d }",
    "cartesian_count": "SELECT (COUNT(?a) AS ?n) WHERE { ?a h:p0 ?b . ?c h:p3 ?d }",
    "filter_function": 'SELECT ?a ?v WHERE { ?a ?p ?v FILTER(REGEX(STR(?v), "^word[1-3]")) }',
    "filter_udf_arg": 'SELECT ?a WHERE { ?a h:p2 ?v FILTER(CONTAINS(LCASE(?v), "TAIL") '
                      "|| STRLEN(?v) = 2) }",
    "constant_true": "SELECT (COUNT(*) AS ?n) WHERE { <http://h.e/n3> h:p0 <http://h.e/n7> }",
    "constant_false": "SELECT * WHERE { <http://h.e/n3> h:p0 <http://h.e/n3> }",
    "clauses_only": "SELECT ?a ?b WHERE { { ?a h:p0 ?b } UNION { ?a h:p1 ?b } FILTER(BOUND(?a)) }",
    "clauses_only_minus": "SELECT ?a WHERE { { ?a h:p2 ?b } UNION { ?a h:p3 ?b } "
                          "MINUS { ?a h:p0 ?c } FILTER(?b != \"5\") }",
    # ORDER BY ties over host-engine joins: rows in the reference's order
    "order_ties_cartesian": "SELECT ?a ?d WHERE { ?a h:p0 <http://h.e/n2> . ?c h:p3 ?d } "
                            "ORDER BY ?d",
    "order_ties_join": 'SELECT ?a ?b ?v WHERE { ?a h:p0 ?b . ?b ?p ?v FILTER(REGEX(STR(?v), "1")) } '
                       "ORDER BY DESC(?b)",
    "order_ties_limit": "SELECT ?a ?d WHERE { ?a h:p0 ?b . ?c h:p3 ?d } ORDER BY ?a LIMIT 25",
}


@pytest.mark.parametrize("name", sorted(DECLINED))
def test_declined_shapes_match_reference(graph, name):
    ref, tdb = graph
    q = H + DECLINED[name]
    with CS.RouteSpy() as spy:
        got = port.execute_query_volcano(q, tdb)
    assert got == ref_execute(q, ref)
    assert spy.route() == "host"


NAIVE = {
    "bgp": "SELECT ?a ?b ?c WHERE { ?a h:p0 ?b . ?b h:p1 ?c }",
    "filters": "SELECT ?a ?v WHERE { ?a h:p1 ?v . ?a h:p0 ?b FILTER(?v > 50 && BOUND(?b)) }",
    "values": "SELECT ?a ?b WHERE { ?a h:p0 ?b VALUES ?a { <http://h.e/n1> <http://h.e/n4> } }",
    "order_ties": "SELECT ?a ?b WHERE { ?a h:p0 ?b . ?c h:p3 ?b } ORDER BY ?b",
    "order_limit": "SELECT ?a ?b WHERE { ?a h:p0 ?b . ?b h:p0 ?c } ORDER BY DESC(?a) LIMIT 9",
    "aggregate": "SELECT ?a (COUNT(?b) AS ?n) WHERE { ?a h:p0 ?b . ?b ?p ?c } GROUP BY ?a",
    "clauses": "SELECT ?a ?b ?y WHERE { ?a h:p0 ?b { ?b h:p1 ?x } UNION { ?b h:p2 ?x } "
               "OPTIONAL { ?a h:p3 ?y } MINUS { ?a h:p1 \"5\" } }",
    "quoted": "SELECT ?a ?y WHERE { << ?a h:p0 ?b >> h:since ?y . ?a h:p1 ?v }",
    "empty": "SELECT ?a WHERE { ?a h:nothing ?b . ?a h:p0 ?c }",
}


@pytest.mark.parametrize("name", sorted(NAIVE))
def test_execute_query_matches_reference(graph, name):
    """``use_optimizer=False``: the patterns joined in textual order."""
    ref, tdb = graph
    q = H + NAIVE[name]
    with CS.RouteSpy() as spy:
        got = port.execute_query(q, tdb)
    assert got == ref_execute_query(q, ref)
    assert spy.route() == "naive"


def test_host_engine_needs_a_lowering_decline(graph):
    """A plan the device engine lowers never reaches the host engine."""
    _ref, tdb = graph
    with CS.RouteSpy() as spy:
        port.execute_query_volcano(H + "SELECT ?a ?c WHERE { ?a h:p0 ?b . ?b h:p1 ?c }", tdb)
    assert spy.route() == "device" and "host" not in spy.routes


def test_failures_propagate(graph, monkeypatch):
    """A kernel or run failure is not a decline: it reaches the caller."""
    from kolibrie_tpu_torch.ops import join as J
    from kolibrie_tpu_torch.optimizer import device_engine as DE

    _ref, tdb = graph

    def broken(*a, **k):
        raise RuntimeError("forced kernel failure")

    with monkeypatch.context() as m:
        m.setattr(J, "ranked_merge_join_indices", broken)
        with pytest.raises(RuntimeError, match="forced kernel failure"):
            port.execute_query_volcano(H + DECLINED["order_ties_join"], tdb)
    with monkeypatch.context() as m:
        m.setattr(DE.LoweredPlan, "execute", broken)
        with pytest.raises(RuntimeError, match="forced kernel failure"):
            port.execute_query_volcano(H + "SELECT ?a ?c WHERE { ?a h:p0 ?b . ?b h:p1 ?c }", tdb)


def test_host_engine_reads_the_device_mirror_and_joins_on_the_kernel(graph, monkeypatch):
    """No host scan of the store: its ``match`` is never called; the join
    goes through the merge-path kernel's wrapper."""
    from kolibrie_tpu_torch.core.store import ColumnarTripleStore

    ref, tdb = graph
    q = H + DECLINED["order_ties_join"]
    want = ref_execute(q, ref)

    def no_host_scan(*a, **k):
        raise AssertionError("host scan")

    monkeypatch.setattr(ColumnarTripleStore, "match", no_host_scan)
    with CS.KernelCalls() as calls:
        assert port.execute_query_volcano(q, tdb) == want
    assert calls.counts == {"merge_path_join": 1, "ranked_merge_join_indices": 1}


def test_equi_join_device_matches_reference():
    """Natural join and cartesian product of device tables: the host
    join's rows in its order, for one, two and three shared keys."""
    import torch

    from kolibrie_tpu.ops.join import equi_join_tables as ref_join
    from kolibrie_tpu_torch.ops.join import equi_join_device, table_to_device, table_to_host

    rng = np.random.default_rng(5)
    for trial in range(16):
        n_l, n_r = int(rng.integers(0, 50)), int(rng.integers(0, 50))
        left = {"a": rng.integers(0, 7, n_l).astype(np.uint32),
                "b": rng.integers(0, 4, n_l).astype(np.uint32)}
        right = {"c": rng.integers(0, 5, n_r).astype(np.uint32)}
        shared = trial % 4
        for k in ("a", "b", "c")[:shared]:
            right[k] = rng.integers(0, 4, n_r).astype(np.uint32)
        if shared == 3:
            left["c"] = rng.integers(0, 5, n_l).astype(np.uint32)
        got = table_to_host(equi_join_device(table_to_device(left, torch.device("cpu")),
                                             table_to_device(right, torch.device("cpu"))))
        assert_same_table(ref_join(left, right), got)


# ------------------------------------------------- chip_smoke phase 8

UNIVERSITIES = 3


@pytest.fixture(scope="module")
def lubm3():
    ref = RefDatabase()
    ref.store.add_batch(*generate_fast(UNIVERSITIES, ref.dictionary))
    ref.execution_mode = "device"  # LUBM-1000 is device-routed on the card
    return ref, port_twin(ref)


@pytest.mark.parametrize("name", sorted([*CS.HOST_QUERIES, "naive"]))
def test_phase8_host_shapes_at_lubm3(lubm3, name):
    """Phase 8's host-engine shapes: the reference's rows, the expected
    counts scaled to three universities, the route, and the warm run's
    launches as ``HOST_LAUNCHES`` tables them."""
    ref, tdb = lubm3
    if name == "naive":
        q = CS.SURFACE_PREFIXES + CS.NAIVE_QUERY
        run, want, route = port.execute_query, ref_execute_query(q, ref), "naive"
    else:
        q = CS.SURFACE_PREFIXES + CS.HOST_QUERIES[name]
        run, want, route = port.execute_query_volcano, ref_execute(q, ref), "host"
    run(q, tdb)  # cold
    with CS.RouteSpy() as spy, CS.KernelCalls() as calls:
        got = run(q, tdb)
    assert got == want
    expected = CS.host_expected(UNIVERSITIES)[name]
    assert (got if isinstance(expected, list) else len(got)) == expected
    assert spy.route() == route
    assert calls.counts == CS.HOST_LAUNCHES[name]
