"""The PyTorch port's SELECT path against the JAX package's device engine.

Both packages hold the same database: the reference loads it, and the
port's ``SparqlDatabase.from_arrays`` takes its dictionary terms and
columns, so dictionary IDs and sort orders are identical.  Mutations are
replayed on both stores, so their base/delta split is identical too.  The
reference runs with ``execution_mode = "device"``; the port runs on
``device="cpu"``, where every kernel wrapper takes its plain version.

Compared exactly: sorted result rows; and, for the engine itself, the
converged per-join / per-WCOJ-level match counts and the per-operator
stats (``scan{i}``, ``join{i}``, ``filter{i}``, ``wcoj{i}:cand/dedup/live``).
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

import kolibrie_tpu_torch as port
from benches.lubm import LUBM_Q2, LUBM_Q9, generate_fast
from kolibrie_tpu.query.executor import execute_query_volcano as ref_execute
from kolibrie_tpu.query.sparql_database import SparqlDatabase as RefDatabase
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

PREFIXES = """PREFIX ex: <http://example.org/>
PREFIX foaf: <http://xmlns.com/foaf/0.1/>
"""


def port_twin(ref: RefDatabase):
    """The port's database holding the reference database's state, routed
    as the reference is (its ``execution_mode``)."""
    db = port.SparqlDatabase.from_arrays(
        ref.dictionary.id_to_str, *ref.store.columns(), device="cpu"
    )
    db.execution_mode = ref.execution_mode
    return db


def ntriples_pair(lines):
    ref = RefDatabase()
    ref.parse_ntriples("\n".join(lines))
    ref.execution_mode = "device"
    return ref, port_twin(ref)


def rows(execute, db, q):
    return sorted(map(tuple, execute(q, db)))


def engine_run(pkg: str, db, q: str):
    """Parse, plan and lower ``q`` with package ``pkg`` and execute the
    lowered plan directly: returns (converged counts, stats, sorted rows)."""
    parser = importlib.import_module(f"{pkg}.query.parser")
    engine = importlib.import_module(f"{pkg}.optimizer.engine")
    planner = importlib.import_module(f"{pkg}.optimizer.planner")
    de = importlib.import_module(f"{pkg}.optimizer.device_engine")
    db.register_prefixes_from_query(q)
    where = parser.parse_combined_query(q, db.prefixes).select.where
    resolved = [engine.resolve_pattern(db, p) for p in where.patterns]
    logical = planner.build_logical_plan(resolved, list(where.filters), [], None)
    plan = planner.Streamertail(db.get_or_build_stats()).find_best_plan(logical)
    low = de.lower_plan(db, plan)
    table = low.execute()
    keys = sorted(table)
    got = sorted(zip(*(np.asarray(table[k]).tolist() for k in keys)))
    return list(low._last_counts), low.fetch_stats(), (keys, got)


def assert_same(ref, tdb, q, engine=True):
    want = rows(ref_execute, ref, q)
    assert rows(port.execute_query_volcano, tdb, q) == want
    if engine:
        r = engine_run("kolibrie_tpu", ref, q)
        t = engine_run("kolibrie_tpu_torch", tdb, q)
        assert t[0] == r[0], "converged counts differ"
        assert t[1] == r[1], "operator stats differ"
        assert t[2] == r[2], "engine tables differ"
    return want


# --------------------------------------------------------------- employees


def employee_lines():
    lines = []
    n = 300
    for i in range(n):
        e = f"<http://example.org/e{i}>"
        lines.append(
            f"{e} <http://xmlns.com/foaf/0.1/workplaceHomepage> "
            f"<http://company{i % 7}.example/> ."
        )
        lines.append(f'{e} <http://example.org/salary> "{30000 + (i % 50) * 1000}" .')
        lines.append(f'{e} <http://example.org/dept> "dept{i % 5}" .')
        lines.append(f'{e} <http://example.org/name> "Name {i % 13} Smith{i % 3}" .')
        if i % 3 == 0:
            lines.append(f"{e} <http://example.org/knows> <http://example.org/e{(i + 1) % n}> .")
        if i % 4 == 0:
            lines.append(f"{e} <http://example.org/knows> <http://example.org/e{(i + 5) % n}> .")
    return lines


@pytest.fixture(scope="module")
def employees():
    return ntriples_pair(employee_lines())


EMPLOYEE_QUERIES = {
    "two_pattern": "SELECT ?e ?w ?s WHERE { ?e foaf:workplaceHomepage ?w . ?e ex:salary ?s }",
    "star": "SELECT ?e ?w ?s ?d WHERE { ?e foaf:workplaceHomepage ?w . "
    "?e ex:salary ?s . ?e ex:dept ?d }",
    "numeric_filter": "SELECT ?e ?s WHERE { ?e ex:salary ?s . FILTER(?s > 50000) }",
    "numeric_filter_flipped": "SELECT ?e ?s WHERE { ?e ex:salary ?s . FILTER(45000 >= ?s) }",
    "compound_filter": "SELECT ?e ?s ?d WHERE { ?e ex:salary ?s . ?e ex:dept ?d . "
    'FILTER(?s >= 40000 && (?s < 70000 || ?d = "dept1")) }',
    "not_filter": 'SELECT ?e ?d WHERE { ?e ex:dept ?d . FILTER(!(?d = "dept2")) }',
    "iri_equality": "SELECT ?e ?w WHERE { ?e foaf:workplaceHomepage ?w . "
    "FILTER(?w = <http://company3.example/>) }",
    "iri_inequality_unknown": "SELECT ?e ?w WHERE { ?e foaf:workplaceHomepage ?w . "
    "FILTER(?w != <http://nowhere.example/>) }",
    "var_var_filter": "SELECT ?a ?b ?sa ?sb WHERE { ?a ex:knows ?b . ?a ex:salary ?sa . "
    "?b ex:salary ?sb . FILTER(?sa < ?sb) }",
    "var_var_equality": "SELECT ?a ?b WHERE { ?a ex:knows ?b . ?a ex:dept ?da . "
    "?b ex:dept ?db . FILTER(?da = ?db) }",
    "two_var_key": "SELECT ?a ?b ?w WHERE { ?a ex:knows ?b . ?a foaf:workplaceHomepage ?w . "
    "?b foaf:workplaceHomepage ?w }",
    "string_filters": 'SELECT ?e ?n WHERE { ?e ex:name ?n . FILTER(CONTAINS(?n, "Smith1") '
    '&& (STRSTARTS(?n, "Name 1") || REGEX(?n, "^Name [2-4] ")) && !STRENDS(?n, "h2")) }',
    "bound_filter": "SELECT ?e ?d WHERE { ?e ex:dept ?d . FILTER(BOUND(?d)) }",
    "const_subject": "SELECT ?w ?e WHERE { <http://example.org/e7> foaf:workplaceHomepage ?w . "
    "?e foaf:workplaceHomepage ?w }",
    "const_pattern_present": "SELECT ?e ?s WHERE { ?e ex:salary ?s . "
    "<http://example.org/e3> ex:knows <http://example.org/e4> }",
    "const_pattern_absent": "SELECT ?e ?s WHERE { ?e ex:salary ?s . "
    "<http://example.org/e4> ex:knows <http://example.org/e3> }",
    "unknown_constant": "SELECT ?e WHERE { ?e ex:missing ?x . ?e ex:salary ?s }",
}


@pytest.mark.parametrize("name", sorted(EMPLOYEE_QUERIES))
def test_employee_queries_match_reference(employees, name):
    ref, tdb = employees
    q = PREFIXES + EMPLOYEE_QUERIES[name]
    assert_same(ref, tdb, q, engine=name != "const_pattern_absent")


HOST_PASS_QUERIES = {
    "distinct": "SELECT DISTINCT ?w WHERE { ?e foaf:workplaceHomepage ?w . ?e ex:salary ?s }",
    "order_limit_offset": "SELECT ?e ?s WHERE { ?e ex:salary ?s . FILTER(?s > 60000) } "
    "ORDER BY ?e LIMIT 7 OFFSET 3",
    "order_desc_numeric": "SELECT ?e ?s WHERE { ?e ex:salary ?s . ?e ex:dept \"dept3\" } "
    "ORDER BY DESC(?s) ?e",
    "bind_and_filter": "SELECT ?e ?double WHERE { ?e ex:salary ?s . "
    "BIND(?s * 2 AS ?double) FILTER(?double > 150000) }",
    "select_star": "SELECT * WHERE { ?e ex:knows ?b . ?b ex:dept ?d }",
}


@pytest.mark.parametrize("name", sorted(HOST_PASS_QUERIES))
def test_host_post_passes_match_reference(employees, name):
    ref, tdb = employees
    q = PREFIXES + HOST_PASS_QUERIES[name]
    want = ref_execute(q, ref)
    got = port.execute_query_volcano(q, tdb)
    if "ORDER BY" in q:
        assert got == want
    else:
        assert sorted(got) == sorted(want)
    assert len(got) > 0


def decoded_store(db) -> set:
    s, p, o = db.store.columns()
    dec = db.decode_term
    return {(dec(int(a)), dec(int(b)), dec(int(c))) for a, b, c in zip(s, p, o)}


@pytest.mark.parametrize(
    "q,construct",
    [
        # shapes the device lowering declines, which the port answers on its
        # host engine as the reference does (the name is the one these
        # cases had while the port raised on them)
        ("INSERT DATA { ex:a ex:knows ex:b }", "INSERT"),
        ("SELECT (COUNT(?e) AS ?n) WHERE { ?e ex:salary ?s . ?b ex:dept ?d }", "cartesian"),
        ('SELECT ?e WHERE { { ?e ex:dept "dept1" } UNION { ?e ex:dept "dept2" } '
         "FILTER(BOUND(?e)) }", "group of clauses only"),
        ("SELECT ?e ?b WHERE { ?e ex:salary ?s . ?b ex:dept ?d }", "cartesian"),
        ('SELECT ?e ?n WHERE { ?e ex:name ?n . FILTER(STRSTARTS(LCASE(?n), "name 1")) }',
         "filter function"),
        ("SELECT (COUNT(*) AS ?n) WHERE { <http://example.org/e3> ex:knows "
         "<http://example.org/e4> }", "constant-only query"),
    ],
)
def test_unsupported_shapes_raise(q, construct):
    """Each shape the port used to reject with ``Unsupported`` now returns
    the reference's rows, and leaves the reference's store."""
    ref, tdb = ntriples_pair(employee_lines())
    want = rows(ref_execute, ref, PREFIXES + q)
    assert rows(port.execute_query_volcano, tdb, PREFIXES + q) == want
    assert decoded_store(tdb) == decoded_store(ref)
    if construct == "INSERT":
        assert ("http://example.org/a", "http://example.org/knows",
                "http://example.org/b") in decoded_store(tdb)
    else:
        assert want


@pytest.mark.parametrize(
    "q,construct",
    [
        ('MODEL "m" { ARCH MLP { HIDDEN [4] } OUTPUT EXCLUSIVE { "0", "1" } }', "MODEL"),
        ("SELECT ?e FROM NAMED WINDOW <http://example.org/w> ON <http://example.org/s> "
         "[RANGE 4 STEP 2] WHERE { WINDOW <http://example.org/w> { ?e ex:knows ?b } }", "WINDOW"),
    ],
)
def test_still_unsupported_shapes_raise(employees, q, construct):
    """WINDOW blocks raise ``Unsupported`` by name; a MODEL declaration,
    formerly a pinned raise, registers the model as the reference does
    (on fresh copies of the employee data)."""
    ref, tdb = employees
    if construct == "MODEL":
        ref, tdb = ntriples_pair(employee_lines())
        assert port.execute_query_volcano(PREFIXES + q, tdb) == ref_execute(
            PREFIXES + q, ref) == []
        got, want = tdb.model_registry["m"], ref.model_registry["m"]
        assert (got.arch.hidden, got.output.kind, got.output.labels) == (
            want.arch.hidden, want.output.kind, want.output.labels) == ([4], "exclusive", ["0", "1"])
        assert decoded_store(tdb) == decoded_store(ref)
        return
    with pytest.raises(port.Unsupported, match=construct):
        port.execute_query_volcano(PREFIXES + q, tdb)


def test_prob_rule_raises(employees, monkeypatch):
    """RULE … PROB through ``execute_query_volcano``, formerly a pinned
    raise, on a fresh copy of the employee data with a probability seed on
    every ``knows`` fact: the port's closure runs the DEVICE tagged
    fixpoint (on torch's CPU, the kernels' plain versions), the reference
    its host loop.  Derived facts equal; the ``prob:value`` tag triples
    equal exactly for min and within 1e-9 for independent (noisy-OR)."""
    from kolibrie_tpu_torch.reasoner import device_provenance as tdp
    from kolibrie_tpu_torch.reasoner import rule_runtime as port_rules
    from kolibrie_tpu_torch.reasoner.provenance_seminaive import seed_tag_store

    routed = []

    def on_device(kg, prov):
        store = seed_tag_store(kg, prov)
        routed.append(tdp.infer_provenance_device(kg, prov, store) is not None)
        return store

    monkeypatch.setattr(port_rules, "infer_with_provenance", on_device)
    value = "http://kolibrie.tpu/prob#value"
    for comb in ("min", "independent"):
        ref, tdb = ntriples_pair(employee_lines())
        knows = ref.dictionary.encode("http://example.org/knows")
        s, p, o = ref.store.columns()
        for i, (a, b, c) in enumerate(zip(s.tolist(), p.tolist(), o.tolist())):
            if b == knows:
                ref.probability_seeds[(a, b, c)] = 0.3 + 0.6 * ((i * 37) % 101) / 101
        tdb.probability_seeds = dict(ref.probability_seeds)
        q = PREFIXES + (f"RULE :R PROB(combination={comb}, threshold=0.5) :- CONSTRUCT "
                        "{ ?a ex:k2 ?c . } WHERE { ?a ex:knows ?b . ?b ex:knows ?c . }")
        assert port.execute_query_volcano(q, tdb) == ref_execute(q, ref)
        for k2 in ("SELECT ?a ?c WHERE { ?a ex:k2 ?c }",
                   "SELECT ?a ?b WHERE { ?a ex:knows ?b }"):
            assert rows(port.execute_query_volcano, tdb, PREFIXES + k2) == rows(
                ref_execute, ref, PREFIXES + k2)
        star = PREFIXES + f"SELECT ?a ?c ?v WHERE {{ << ?a ex:k2 ?c >> <{value}> ?v }}"
        want = {(a, c): float(v) for a, c, v in ref_execute(star, ref)}
        got = {(a, c): float(v)
               for a, c, v in port.execute_query_volcano(star, tdb)}
        assert want and set(got) == set(want)
        for k, v in want.items():
            assert abs(got[k] - v) <= (1e-9 if comb == "independent" else 0.0), (comb, k)
    assert routed == [True, True]


def test_fuzz_matches_reference():
    """Seeded random BGP + FILTER queries over random data."""
    import random

    rng = random.Random(20261016)
    lines = []
    preds = [f"<http://f.e/p{k}>" for k in range(4)]
    for _ in range(300):
        s = f"<http://f.e/s{rng.randrange(60)}>"
        o = (
            f"<http://f.e/s{rng.randrange(60)}>"
            if rng.random() < 0.5
            else f'"{rng.randrange(0, 5000)}"'
        )
        lines.append(f"{s} {rng.choice(preds)} {o} .")
    ref, tdb = ntriples_pair(lines)
    pool = ["?a", "?b", "?c", "?d"]
    checked = 0
    for _trial in range(14):
        used, pats = [], []
        for _ in range(rng.randrange(1, 4)):
            s = rng.choice(used) if used and rng.random() < 0.8 else rng.choice(pool)
            o = rng.choice(pool + [f"<http://f.e/s{rng.randrange(60)}>"])
            pats.append(f"{s} {rng.choice(preds)} {o} .")
            used += [t for t in (s, o) if t.startswith("?") and t not in used]
        filt = ""
        if rng.random() < 0.5:
            op = rng.choice([">", "<", ">=", "<=", "=", "!="])
            filt = f"FILTER({rng.choice(used)} {op} {rng.randrange(0, 5000)})"
        q = f"SELECT {' '.join(used)} WHERE {{ {' '.join(pats)} {filt} }}"
        want = rows(ref_execute, ref, q)
        got = rows(port.execute_query_volcano, tdb, q)  # cartesian trials: the host engine
        assert got == want, q
        checked += 1
    assert checked == 14


def test_repeated_variable_pattern():
    ref, tdb = ntriples_pair(
        [
            "<http://e/a> <http://e/p> <http://e/a> .",
            "<http://e/a> <http://e/p> <http://e/b> .",
            "<http://e/b> <http://e/p> <http://e/b> .",
            "<http://e/c> <http://e/q> <http://e/c> .",
        ]
    )
    got = assert_same(ref, tdb, "SELECT ?x WHERE { ?x <http://e/p> ?x }")
    assert len(got) == 2


def test_three_var_join_key():
    lines = []
    for i in range(40):
        lines.append(f"<http://g/a{i}> <http://g/sym> <http://g/b{i}> .")
        lines.append(f"<http://g/b{i}> <http://g/sym> <http://g/a{i}> .")
    for i in range(120):
        lines.append(f"<http://g/a{i}> <http://g/asym> <http://g/c{i}> .")
    ref, tdb = ntriples_pair(lines)
    got = assert_same(ref, tdb, "SELECT ?s ?p ?o WHERE { ?s ?p ?o . ?o ?p ?s }")
    assert len(got) == 80


# -------------------------------------------------------------------- WCOJ

TRIANGLE = PREFIXES + "SELECT ?x ?y ?z WHERE { ?x ex:p1 ?y . ?y ex:p2 ?z . ?z ex:p3 ?x }"
CHAIN = PREFIXES + "SELECT ?x ?y ?z WHERE { ?x ex:p1 ?y . ?y ex:p2 ?z }"


def test_wcoj_triangle_across_store_states(monkeypatch):
    """Base, delta, tombstone and reinsert states: both stores replay the
    same mutations, so the WCOJ levels probe identical base/delta/tombstone
    segments."""
    rng = np.random.default_rng(7)
    lines, edges = [], []
    for _ in range(400):
        a, b = rng.integers(0, 25, 2)
        p = f"p{int(rng.integers(1, 4))}"
        edges.append((int(a), p, int(b)))
        lines.append(f"<http://example.org/n{a}> <http://example.org/{p}> <http://example.org/n{b}> .")
    ref, tdb = ntriples_pair(lines)

    def tid(term):
        return ref.dictionary.lookup(f"http://example.org/{term}")

    def mutate(op, a, p, b):
        for db in (ref, tdb):
            getattr(db.store, op)(tid(f"n{a}"), tid(p), tid(f"n{b}"))

    monkeypatch.setenv("KOLIBRIE_WCOJ", "auto")
    seen = [assert_same(ref, tdb, TRIANGLE)]
    # delta: fresh edges closing new triangles
    for a, b, c in ((1, 2, 3), (4, 5, 6), (2, 9, 11)):
        mutate("add", a, "p1", b)
        mutate("add", b, "p2", c)
        mutate("add", c, "p3", a)
    assert ref.store.delta_epoch == tdb.store.delta_epoch > 0
    seen.append(assert_same(ref, tdb, TRIANGLE))
    # tombstones over base rows
    removed = [e for e in edges if e[1] != "p1"][:12]
    for a, p, b in removed:
        mutate("remove", a, p, b)
    assert ref.store.segment_signature()[3] == tdb.store.segment_signature()[3] > 0
    seen.append(assert_same(ref, tdb, TRIANGLE))
    # reinsert some tombstoned rows
    for a, p, b in removed[:5]:
        mutate("add", a, p, b)
    seen.append(assert_same(ref, tdb, TRIANGLE))
    assert len({len(s) for s in seen}) > 1  # the states really differ
    monkeypatch.setenv("KOLIBRIE_WCOJ", "force")
    assert_same(ref, tdb, CHAIN)


# -------------------------------------------------------------------- LUBM


@pytest.fixture(scope="module")
def lubm2():
    ref = RefDatabase()
    ref.store.add_batch(*generate_fast(2, ref.dictionary))
    ref.execution_mode = "device"
    return ref, port_twin(ref)


@pytest.mark.parametrize("wcoj", ["auto", "off"])
@pytest.mark.parametrize("query", ["q2", "q9"])
def test_lubm_queries_match_reference(lubm2, monkeypatch, query, wcoj):
    ref, tdb = lubm2
    monkeypatch.setenv("KOLIBRIE_WCOJ", wcoj)
    got = assert_same(ref, tdb, {"q2": LUBM_Q2, "q9": LUBM_Q9}[query])
    assert len(got) > 0


def test_reference_through_its_pallas_kernels(lubm2, monkeypatch):
    """The reference with KOLIBRIE_PALLAS=force (its merge-join and
    lex-probe kernels in interpret mode) gives the port's rows."""
    ref, tdb = lubm2
    monkeypatch.setenv("KOLIBRIE_PALLAS", "force")
    monkeypatch.setenv("KOLIBRIE_WCOJ", "auto")
    assert rows(port.execute_query_volcano, tdb, LUBM_Q9) == rows(ref_execute, ref, LUBM_Q9)
    q = PREFIXES + "SELECT ?x ?c WHERE { ?x <http://swat.cse.lehigh.edu/onto/univ-bench.owl#advisor> ?y . " \
        "?x <http://swat.cse.lehigh.edu/onto/univ-bench.owl#takesCourse> ?c }"
    assert rows(port.execute_query_volcano, tdb, q) == rows(ref_execute, ref, q)


@pytest.mark.parametrize("op", ["=", "!=", "<", "<=", ">", ">="])
def test_filter_masks_and_scan_caps_match_reference(employees, op):
    from kolibrie_tpu.optimizer import device_engine as rde
    from kolibrie_tpu_torch.optimizer import device_engine as tde

    ref, tdb = employees
    vals = ref.numeric_values()
    np.testing.assert_array_equal(
        tde.numeric_filter_mask(tdb.numeric_values(), op, 45000.0),
        rde.numeric_filter_mask(vals, op, 45000.0),
    )
    name = ["REGEX", "CONTAINS", "STRSTARTS", "STRENDS", "CONTAINS", "REGEX"][
        ["=", "!=", "<", "<=", ">", ">="].index(op)
    ]
    np.testing.assert_array_equal(
        tde.string_filter_mask(tdb, name, "Smith1", "dict"),
        rde.string_filter_mask(ref, name, "Smith1", "dict"),
    )
    for order in ("spo", "pos", "osp", "pso", "ops", "sop"):
        for n_bound in (0, 1, 2):
            assert tde.template_scan_cap(tdb, order, n_bound) == rde.template_scan_cap(
                ref, order, n_bound
            )
