"""The PyTorch port's group patterns against the JAX package's device
engine: UNION / OPTIONAL / MINUS / NOT fused into the device program (and
as host post-passes where the reference puts them), VALUES, RDF-star
quoted patterns, and sub-SELECTs (inlined, or joined on the host).

The reference loads each database and runs with ``execution_mode =
"device"``; the port's ``SparqlDatabase.from_arrays`` takes its dictionary,
quoted table and columns, so every ID matches, and runs on
``device="cpu"`` (the kernels' plain versions).  Compared exactly: sorted
result rows; and for the lowered programs themselves the rows in plan
order, the converged per-join counts, the per-operator stats (``union{i}``,
``optional{j}``, ``anti{i}``, ``values{i}``, ``quoted{i}`` beside the
scans, joins and filters) and ``fused_clauses``.  No tolerance is used.
"""

from __future__ import annotations

import importlib
import random

import numpy as np
import pytest

import chip_smoke as CS
import kolibrie_tpu_torch as port
from kolibrie_tpu.query.executor import execute_query_volcano as ref_execute
from kolibrie_tpu.query.sparql_database import SparqlDatabase as RefDatabase

PREFIXES = """PREFIX ex: <http://example.org/>
PREFIX foaf: <http://xmlns.com/foaf/0.1/>
"""


def port_twin(ref: RefDatabase):
    """The port's database holding the reference database's state."""
    return port.SparqlDatabase.from_arrays(
        ref.dictionary.id_to_str, *ref.store.columns(), quoted=dict(ref.quoted.items()),
        device="cpu",
    )


def pair(ref: RefDatabase):
    ref.execution_mode = "device"
    return ref, port_twin(ref)


def rows(execute, db, q):
    return sorted(map(tuple, execute(q, db)))


def assert_same(ref, tdb, q):
    want = rows(ref_execute, ref, q)
    assert rows(port.execute_query_volcano, tdb, q) == want, q
    return want


def clause_run(pkg: str, db, q: str, clause_only: bool = False):
    """Plan ``q``'s group with package ``pkg``, lower it WITH its clause
    branches and run the lowered program: returns (fused_clauses, out
    vars, rows in plan order, converged counts, stats)."""
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
    plan = None
    if not clause_only:
        logical = planner_m.build_logical_plan(resolved, list(w.filters), [], w.values)
        plan = planner.find_best_plan(logical)
    unions = tuple(tuple(ex._branch_plan(db, planner, b) for b in g) for g in w.unions)
    optionals = tuple(ex._branch_plan(db, planner, b) for b in w.optionals)
    antis = tuple(
        ex._branch_plan(db, planner, b)
        for b in list(w.minus) + [ast.WhereClause(patterns=nb.patterns) for nb in w.not_blocks]
    )
    low = de.lower_plan(db, plan, antis, unions, optionals)
    table = low.execute()
    cols = [np.asarray(table[v]).tolist() for v in low.out_vars]
    return (
        low.fused_clauses,
        tuple(low.out_vars),
        list(zip(*cols)),
        list(getattr(low, "_last_counts", [])),
        low.fetch_stats(),
    )


def assert_same_program(ref, tdb, q, clause_only=False):
    r = clause_run("kolibrie_tpu", ref, q, clause_only)
    t = clause_run("kolibrie_tpu_torch", tdb, q, clause_only)
    assert t[0] is True and r[0] is True
    assert t[1] == r[1], "output variables differ"
    assert t[2] == r[2], "rows in plan order differ"
    assert t[3] == r[3], "converged counts differ"
    assert t[4] == r[4], "operator stats differ"
    return t


def employee_db(n=500) -> RefDatabase:
    """The corpus of the reference's ``tests/test_device_engine.py``."""
    db = RefDatabase()
    lines = []
    for i in range(n):
        e = f"<http://example.org/e{i}>"
        lines.append(
            f"{e} <http://xmlns.com/foaf/0.1/workplaceHomepage> "
            f"<http://company{i % 7}.example/> ."
        )
        lines.append(f'{e} <http://example.org/salary> "{30000 + (i % 50) * 1000}" .')
        lines.append(f'{e} <http://example.org/dept> "dept{i % 5}" .')
        if i % 3 == 0:
            lines.append(f"{e} <http://example.org/knows> <http://example.org/e{(i + 1) % n}> .")
    db.parse_ntriples("\n".join(lines))
    return db


@pytest.fixture(scope="module")
def employees():
    return pair(employee_db())


# ------------------------------------------------------------------ VALUES

VALUES_QUERIES = {
    "values_join": 'SELECT ?e ?d WHERE { ?e ex:dept ?d . VALUES ?d { "dept1" "dept3" } }',
    "values_two_vars": 'SELECT ?e ?d ?w WHERE { ?e ex:dept ?d . ?e foaf:workplaceHomepage ?w . '
    'VALUES (?d ?w) { ("dept1" <http://company2.example/>) ("dept4" <http://company0.example/>) } }',
    "values_only": 'SELECT ?d WHERE { VALUES ?d { "dept1" "dept9" } }',
    "values_new_term": 'SELECT ?e ?d WHERE { ?e ex:dept ?d . VALUES ?d { "dept2" "no-such" } }',
}


@pytest.mark.parametrize("name", sorted(VALUES_QUERIES))
def test_values_match_reference(employees, name):
    ref, tdb = employees
    got = assert_same(ref, tdb, PREFIXES + VALUES_QUERIES[name])
    assert got
    # VALUES interns its terms in both dictionaries alike
    assert ref.dictionary.id_to_str == tdb.dictionary.id_to_str


def test_values_clause_count(employees):
    ref, tdb = employees
    q = PREFIXES + VALUES_QUERIES["values_join"]
    assert len(assert_same(ref, tdb, q)) == 200


# -------------------------------------------------- clauses (fused program)

CLAUSE_QUERIES = {
    "minus": 'SELECT ?e ?s WHERE { ?e ex:salary ?s MINUS { ?e ex:dept "dept0" } }',
    "minus_branch_filter": "SELECT ?e ?w WHERE { ?e foaf:workplaceHomepage ?w "
    "MINUS { ?e ex:salary ?s . FILTER(?s > 60000) } }",
    "not_block": "SELECT ?e ?s WHERE { ?e ex:salary ?s . NOT { ?e ex:knows ?y } }",
    "minus_disjoint": 'SELECT ?e ?s WHERE { ?e ex:salary ?s MINUS { ?a ex:dept "dept0" } }',
    "minus_and_not": 'SELECT ?e ?s WHERE { ?e ex:salary ?s MINUS { ?e ex:dept "dept1" } '
    "NOT { ?e ex:knows ?y } }",
    "union": 'SELECT ?e ?x WHERE { ?e ex:salary ?x { ?e ex:dept "dept0" } UNION '
    '{ ?e ex:dept "dept1" } }',
    "union_unbound_fill": 'SELECT ?e ?s WHERE { ?e ex:salary ?s { ?e ex:dept "dept2" } '
    "UNION { ?e ex:knows ?y } }",
    "optional": "SELECT ?e ?s ?y WHERE { ?e ex:salary ?s . OPTIONAL { ?e ex:knows ?y } }",
    "optional_branch_filter": "SELECT ?e ?w ?s WHERE { ?e foaf:workplaceHomepage ?w . "
    "OPTIONAL { ?e ex:salary ?s . FILTER(?s > 70000) } }",
    "compose": 'SELECT ?e ?s ?y WHERE { ?e ex:salary ?s { ?e ex:dept "dept0" } UNION '
    '{ ?e ex:dept "dept3" } OPTIONAL { ?e ex:knows ?y } '
    "MINUS { ?e foaf:workplaceHomepage <http://company0.example/> } }",
    "values_and_clauses": 'SELECT ?e ?d ?y WHERE { ?e ex:dept ?d . VALUES ?d { "dept1" "dept2" } '
    'OPTIONAL { ?e ex:knows ?y } MINUS { ?e ex:salary "30000" } }',
    "empty_minus_branch": "SELECT ?e ?s WHERE { ?e ex:salary ?s MINUS { ?e ex:no_such_predicate ?y } }",
    "empty_union": 'SELECT ?e ?s WHERE { ?e ex:salary ?s { ?e ex:no_such_a "x" } UNION '
    '{ ?e ex:no_such_b "y" } }',
    "some_empty_union": 'SELECT ?e ?s WHERE { ?e ex:salary ?s { ?e ex:no_such_a "x" } UNION '
    '{ ?e ex:dept "dept0" } }',
    "star_some_empty_union": "SELECT * WHERE { ?e ex:salary ?s { ?e ex:dept ?d } UNION "
    "{ ?e ex:no_such_c ?z } }",
    "star_empty_quoted_union": "SELECT * WHERE { ?e ex:salary ?s { ?e ex:dept ?d } UNION "
    "{ << ?x ex:no_such_r ?y >> ex:no_such_p ?c } }",
}


@pytest.mark.parametrize("name", sorted(CLAUSE_QUERIES))
def test_clause_queries_match_reference(employees, name):
    ref, tdb = employees
    q = PREFIXES + CLAUSE_QUERIES[name]
    want = assert_same(ref, tdb, q)
    if name != "empty_union":
        assert want
    if name.startswith("star_"):
        assert len(want[0]) == {"star_some_empty_union": 4, "star_empty_quoted_union": 6}[name]


@pytest.mark.parametrize("name", sorted(CLAUSE_QUERIES))
def test_fused_programs_match_reference(employees, name):
    """The lowered program with its clauses inside: rows in plan order,
    converged counts and every operator's stats."""
    ref, tdb = employees
    assert_same_program(ref, tdb, PREFIXES + CLAUSE_QUERIES[name])


@pytest.mark.parametrize(
    "q,clause_only,n",
    [
        ('SELECT ?e WHERE { { ?e ex:dept "dept0" } UNION { ?e ex:dept "dept1" } }', True, 200),
        ("SELECT ?e ?y WHERE { OPTIONAL { ?e ex:knows ?y } }", True, 167),
        ('SELECT ?e ?y WHERE { { ?e ex:dept "dept0" } UNION { ?e ex:dept "dept2" } '
         "OPTIONAL { ?e ex:knows ?y } }", True, 200),
    ],
)
def test_clause_only_groups(employees, q, clause_only, n):
    ref, tdb = employees
    assert len(assert_same(ref, tdb, PREFIXES + q)) == n
    assert_same_program(ref, tdb, PREFIXES + q, clause_only=clause_only)


HOST_PASS_QUERIES = {
    # OPTIONAL over an unknown predicate: the fused lowering declines; the
    # device BGP + host left-outer join keeps every left row
    "optional_unknown": "SELECT ?e ?s ?y WHERE { ?e ex:salary ?s OPTIONAL { ?e ex:no_such ?y } }",
    # a branch with a BIND is not a plain BGP: every clause goes to the host
    "union_with_bind": 'SELECT ?e ?s ?t WHERE { ?e ex:salary ?s { ?e ex:dept "dept0" } UNION '
    "{ ?e ex:knows ?k . BIND(?k AS ?t) } }",
    "optional_no_shared_var": 'SELECT ?e ?k WHERE { ?e ex:dept "dept4" OPTIONAL { ?k ex:dept "dept3" } '
    "MINUS { ?e ex:knows ?z } }",
    "nested_optional": "SELECT ?e ?y ?w WHERE { ?e ex:salary ?s OPTIONAL { ?e ex:knows ?y "
    "OPTIONAL { ?y foaf:workplaceHomepage ?w } } }",
}


@pytest.mark.parametrize("name", sorted(HOST_PASS_QUERIES))
def test_host_post_pass_routes_match_reference(employees, name):
    ref, tdb = employees
    q = PREFIXES + HOST_PASS_QUERIES[name]
    with CS.RouteSpy() as spy:
        got = rows(port.execute_query_volcano, tdb, q)
    assert got == rows(ref_execute, ref, q)
    assert got
    assert spy.route() == "host post-pass"


def test_fused_route_taken(employees):
    """A clause query runs as ONE fused device program, no post-pass."""
    _ref, tdb = employees
    with CS.RouteSpy() as spy:
        port.execute_query_volcano(PREFIXES + CLAUSE_QUERIES["compose"], tdb)
    assert spy.route() == "fused" and spy.post_passes == 0
    assert len({root for root, _f in spy.runs}) == 1


def test_left_outer_join_tables_matches_reference():
    from kolibrie_tpu.ops.join import left_outer_join_tables as ref_loj
    from kolibrie_tpu_torch.ops.join import left_outer_join_tables as port_loj

    rng = np.random.default_rng(3)
    for trial in range(12):
        n_l, n_r = int(rng.integers(0, 40)), int(rng.integers(0, 40))
        left = {"a": rng.integers(1, 9, n_l).astype(np.uint32),
                "b": rng.integers(1, 5, n_l).astype(np.uint32)}
        right = {"a": rng.integers(1, 9, n_r).astype(np.uint32),
                 "c": rng.integers(1, 5, n_r).astype(np.uint32)}
        if trial % 3 == 1:
            right["b"] = rng.integers(1, 5, n_r).astype(np.uint32)  # two shared vars
        if trial % 4 == 3:
            right = {"z": rng.integers(1, 5, n_r).astype(np.uint32)}  # none shared
        want, got = ref_loj(left, right), port_loj(left, right)
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------------------- RDF-star patterns


def rdf_star_db() -> RefDatabase:
    db = RefDatabase()
    db.parse_turtle(
        """
    @prefix ex: <http://example.org/> .
    << ex:alice ex:age 30 >> ex:certainty "0.9" .
    << ex:bob ex:age 41 >> ex:certainty "0.5" .
    << ex:carol ex:likes ex:dave >> ex:certainty "0.8" .
    << ex:eve ex:likes ex:eve >> ex:certainty "0.7" .
    ex:alice ex:knows ex:bob .
    ex:dave ex:knows ex:carol .
    """
    )
    return db


QUOTED_QUERIES = {
    "inner_vars": "SELECT ?s ?v ?c WHERE { << ?s ex:age ?v >> ex:certainty ?c }",
    "inner_constant": "SELECT ?p ?c WHERE { << ex:alice ?p 30 >> ex:certainty ?c }",
    "join_outer": "SELECT ?s ?o ?c WHERE { ?s ex:knows ?o . << ?s ex:age ?v >> ex:certainty ?c }",
    "repeated_inner": "SELECT ?x ?c WHERE { << ?x ex:likes ?x >> ex:certainty ?c }",
    "unknown_inner": "SELECT ?x ?c WHERE { << ?x ex:hates ?y >> ex:certainty ?c }",
    "quoted_var": "SELECT ?t ?c WHERE { ?t ex:certainty ?c . FILTER(ISTRIPLE(?t)) }",
}


@pytest.mark.parametrize("name", sorted(QUOTED_QUERIES))
def test_quoted_patterns_match_reference(name):
    ref, tdb = pair(rdf_star_db())
    q = PREFIXES + QUOTED_QUERIES[name]
    want = assert_same(ref, tdb, q)
    assert (len(want) == 0) == (name == "unknown_inner")
    r = plain_run("kolibrie_tpu", ref, q)
    t = plain_run("kolibrie_tpu_torch", tdb, q)
    assert t == r


def plain_run(pkg, db, q):
    """Plain lowering of ``q`` run directly: (need_quoted, out vars, rows in
    plan order, counts, stats)."""
    parser = importlib.import_module(f"{pkg}.query.parser")
    engine = importlib.import_module(f"{pkg}.optimizer.engine")
    planner_m = importlib.import_module(f"{pkg}.optimizer.planner")
    de = importlib.import_module(f"{pkg}.optimizer.device_engine")
    db.register_prefixes_from_query(q)
    w = parser.parse_combined_query(q, db.prefixes).select.where
    resolved = [engine.resolve_pattern(db, p) for p in w.patterns]
    logical = planner_m.build_logical_plan(resolved, list(w.filters), [], w.values)
    plan = planner_m.Streamertail(db.get_or_build_stats()).find_best_plan(logical)
    low = de.lower_plan(db, plan)
    table = low.execute()
    cols = [np.asarray(table[v]).tolist() for v in low.out_vars]
    return (low.need_quoted, tuple(low.out_vars), list(zip(*cols)),
            list(getattr(low, "_last_counts", [])), low.fetch_stats())


def test_quoted_tables_match_reference():
    from kolibrie_tpu.optimizer import device_engine as rde
    from kolibrie_tpu_torch.optimizer import device_engine as tde

    ref, tdb = pair(rdf_star_db())
    for a, b in zip(rde.host_quoted_table(ref), tde.host_quoted_table(tdb)):
        np.testing.assert_array_equal(np.asarray(a, np.int64), b)
    for a, b in zip(rde.device_quoted(ref), tde.device_quoted(tdb)):
        np.testing.assert_array_equal(np.asarray(a, np.int64), b.numpy())


def test_quoted_query_fuzz():
    """The reference's randomized RDF-star corpus and queries."""
    rng = random.Random(20260804)
    lines = ["@prefix f: <http://f.e/> ."]
    n_subj, n_pred = 30, 3
    for _i in range(120):
        s = f"f:s{rng.randrange(n_subj)}"
        p = f"f:p{rng.randrange(n_pred)}"
        o = f"f:s{rng.randrange(n_subj)}"
        ann = rng.choice(["f:certainty", "f:saidBy"])
        val = (
            f'"{rng.randrange(1, 100) / 100}"' if ann == "f:certainty"
            else f"f:src{rng.randrange(4)}"
        )
        lines.append(f"<< {s} {p} {o} >> {ann} {val} .")
        if rng.random() < 0.5:
            lines.append(f"{s} f:knows {o} .")
    ref = RefDatabase()
    ref.parse_turtle("\n".join(lines))
    ref, tdb = pair(ref)
    checked = 0
    for _trial in range(20):
        p = f"f:p{rng.randrange(n_pred)}"
        shape = rng.randrange(4)
        if shape == 0:
            body, sel = f"<< ?x {p} ?y >> f:certainty ?c .", "?x ?y ?c"
        elif shape == 1:
            body, sel = f"<< f:s{rng.randrange(n_subj)} ?p ?y >> f:saidBy ?w .", "?p ?y ?w"
        elif shape == 2:
            body, sel = f"<< ?x {p} ?y >> f:certainty ?c . ?x f:knows ?y .", "?x ?y ?c"
        else:
            body, sel = f"<< ?x {p} ?x >> f:certainty ?c .", "?x ?c"
        q = f"PREFIX f: <http://f.e/> SELECT {sel} WHERE {{ {body} }}"
        assert_same(ref, tdb, q)
        checked += 1
    assert checked == 20


# ---------------------------------------------------------------- subqueries

EMPLOYEE_TTL = """
@prefix ex: <http://example.org/> .
ex:alice a ex:Employee ; ex:name "Alice" ; ex:age 30 ; ex:dept ex:Sales ; ex:salary 50000 .
ex:bob a ex:Employee ; ex:name "Bob" ; ex:age 25 ; ex:dept ex:Sales ; ex:salary 40000 .
ex:carol a ex:Employee ; ex:name "Carol" ; ex:age 35 ; ex:dept ex:Engineering ; ex:salary 70000 .
ex:dave a ex:Employee ; ex:name "Dave" ; ex:age 28 ; ex:dept ex:Engineering ; ex:salary 60000 .
ex:eve a ex:Manager ; ex:name "Eve" ; ex:age 45 ; ex:dept ex:Engineering ; ex:salary 90000 .
ex:Sales ex:label "Sales Department" .
ex:Engineering ex:label "Engineering Department" .
"""

SUBQUERY_QUERIES = {
    "plain": "SELECT ?n WHERE { ?x ex:name ?n . { SELECT ?x WHERE { ?x ex:dept ex:Sales } } }",
    "scoped_var": "SELECT ?n ?d WHERE { ?x ex:name ?n . ?x ex:dept ?d . "
    "{ SELECT ?x WHERE { ?x ex:salary ?d } } }",
    "only_subquery": "SELECT ?n WHERE { { SELECT ?n ?x WHERE { ?x ex:name ?n . ?x ex:dept ex:Sales } } }",
    "nested": "SELECT ?n WHERE { ?x ex:name ?n . { SELECT ?x WHERE { ?x ex:age ?a . "
    "{ SELECT ?x WHERE { ?x ex:dept ex:Engineering } } } } }",
    "with_filter": "SELECT ?n ?s WHERE { ?x ex:name ?n . ?x ex:salary ?s . "
    "{ SELECT ?x WHERE { ?x ex:age ?a . FILTER(?a > 27) } } }",
    "distinct_not_inlined": "SELECT ?n WHERE { ?x ex:name ?n . "
    "{ SELECT DISTINCT ?x WHERE { ?x ex:dept ?d } } }",
    "limit_not_inlined": "SELECT ?n WHERE { ?x ex:name ?n . "
    "{ SELECT ?x WHERE { ?x ex:dept ex:Engineering } ORDER BY ?x LIMIT 2 } }",
    "star_hides_scoped": "SELECT DISTINCT * WHERE { ?x ex:dept ?d . "
    "{ SELECT ?d WHERE { ?y ex:dept ?d } } }",
}


@pytest.mark.parametrize("name", sorted(SUBQUERY_QUERIES))
def test_subqueries_match_reference(name):
    ref = RefDatabase()
    ref.parse_turtle(EMPLOYEE_TTL)
    ref, tdb = pair(ref)
    assert assert_same(ref, tdb, "PREFIX ex: <http://example.org/>\n" + SUBQUERY_QUERIES[name])


def test_inline_subqueries_matches_reference():
    from kolibrie_tpu.query.parser import parse_sparql_query as ref_parse
    from kolibrie_tpu.query.subquery_inline import inline_subqueries as ref_inline
    from kolibrie_tpu_torch.query.parser import parse_sparql_query as port_parse
    from kolibrie_tpu_torch.query.subquery_inline import inline_subqueries as port_inline

    ref = RefDatabase()
    ref.parse_turtle(EMPLOYEE_TTL)
    for q in SUBQUERY_QUERIES.values():
        q = "PREFIX ex: <http://example.org/>\n" + q
        ref.register_prefixes_from_query(q)
        want = ref_inline(ref_parse(q, ref.prefixes).where)
        got = port_inline(port_parse(q, ref.prefixes).where)
        assert repr(got) == repr(want)
