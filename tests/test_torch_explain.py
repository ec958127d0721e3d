"""The port's EXPLAIN and stats advisor against the JAX package's.

``LoweredPlan.describe`` and ``QueryEngine.explain_device`` (plain, and
``analyze=True`` with its ``actual=`` rows, cap occupancies, ``mqo:`` and
``advisor:`` lines) must render the reference's text once the wall-time
lines of the analyze run are masked.  Under
``KOLIBRIE_STATS_ADVISOR=auto`` the same query sequence must leave the
same advisor reports, views and plan-cache replans in both packages
(LUBM Q9's drift replan included), and advisor state exported by either
package must import into the other with equal views.  All exact.
"""

from __future__ import annotations

import pytest

import kolibrie_tpu_torch as port
from benches import lubm
from kolibrie_tpu.optimizer import mqo as ref_mqo
from kolibrie_tpu.optimizer import stats_advisor as ref_sa
from kolibrie_tpu.query.engine import QueryEngine as RefEngine
from kolibrie_tpu.query.executor import execute_query_volcano as ref_execute
from kolibrie_tpu.query.executor import plan_cache_info as ref_info
from kolibrie_tpu.query.sparql_database import SparqlDatabase as RefDatabase
from kolibrie_tpu_torch.optimizer import mqo as port_mqo
from kolibrie_tpu_torch.optimizer import stats_advisor as port_sa
from kolibrie_tpu_torch.query.engine import QueryEngine as PortEngine
from kolibrie_tpu_torch.query.executor import plan_cache_info as port_info
from jax_compile_cache import fresh_jax_compile_cache
from test_torch_clauses import PREFIXES, employee_db, pair, rdf_star_db
from test_torch_prepared import graph_pair

UB = "PREFIX ub: <http://swat.cse.lehigh.edu/onto/univ-bench.owl#>\n"
JOIN_Q = UB + "SELECT ?x ?c WHERE { ?x ub:worksFor ?d . ?x ub:teacherOf ?c . }"


@pytest.fixture(autouse=True)
def _reference_compile_cache(tmp_path):
    """``source: compiled`` in the reference's EXPLAIN must not depend on
    which modules ran before this one in the process."""
    with fresh_jax_compile_cache(tmp_path / "jax_cache"):
        yield


@pytest.fixture(autouse=True)
def _fresh_advisors():
    for sa in (ref_sa, port_sa):
        sa.stats_advisor.reset()
    yield
    for sa in (ref_sa, port_sa):
        sa.stats_advisor.reset()


def lubm_pair(universities: int):
    ref = RefDatabase()
    s, p, o = lubm.generate_fast(universities, ref.dictionary)
    ref.store.add_batch(s, p, o)
    ref.store.compact()
    return pair(ref)


def masked(text: str) -> str:
    """The explain text without the analyze run's wall-time lines."""
    keep = []
    for line in text.splitlines():
        if line == "device time:" or line.startswith(("  device.", "  interp.")):
            continue
        keep.append(line)
    return "\n".join(keep)


EXPLAIN_CORPUS = {
    "join_filter": ("emp", 'SELECT ?e ?s WHERE { ?e ex:dept "dept1" . ?e ex:salary ?s . '
                           "FILTER(?s > 60000) }"),
    "string_mask": ("emp", 'SELECT ?e ?d WHERE { ?e ex:dept ?d . FILTER(CONTAINS(?d, "3")) }'),
    "values": ("emp", 'SELECT ?e ?d WHERE { ?e ex:dept ?d . VALUES ?d { "dept1" "dept3" } }'),
    "clauses": ("emp", 'SELECT ?e ?s ?y WHERE { ?e ex:salary ?s { ?e ex:dept "dept0" } UNION '
                       '{ ?e ex:dept "dept3" } OPTIONAL { ?e ex:knows ?y } '
                       "MINUS { ?e foaf:workplaceHomepage <http://company0.example/> } }"),
    "quoted": ("star", "SELECT ?s ?o ?c WHERE { ?s ex:knows ?o . << ?s ex:age ?v >> ex:certainty ?c }"),
    "wcoj": ("graph", "SELECT ?a ?b ?c WHERE { ?a ex:knows ?b . ?b ex:knows ?c . ?c ex:knows ?a }"),
    "const_guard": ("emp", 'SELECT ?e WHERE { ?e ex:dept "dept1" . ex:e1 ex:dept "dept1" }'),
    "cartesian": ("emp", 'SELECT ?e ?f WHERE { ?e ex:dept "dept1" . ?f ex:dept "dept2" }'),
}


@pytest.fixture(scope="module")
def dbs():
    return {"emp": pair(employee_db(200)), "star": pair(rdf_star_db()), "graph": graph_pair()}


@pytest.mark.parametrize("analyze", [False, True])
@pytest.mark.parametrize("name", sorted(EXPLAIN_CORPUS))
def test_explain_device_matches_reference(dbs, name, analyze):
    key, q = EXPLAIN_CORPUS[name]
    ref, tdb = dbs[key]
    want = RefEngine(ref).explain_device(PREFIXES + q, analyze=analyze)
    got = PortEngine(tdb).explain_device(PREFIXES + q, analyze=analyze)
    assert masked(got) == masked(want)
    if analyze and not want.startswith("host path"):
        assert ("actual=" in got or "cand=" in got) and "advisor: off" in got
        assert "source: compiled" in got
    if name == "cartesian":
        assert got.startswith("host path:")


def test_explain_mqo_line_matches_reference(dbs, monkeypatch):
    ref, tdb = dbs["emp"]
    q = PREFIXES + EXPLAIN_CORPUS["join_filter"][1]
    monkeypatch.setenv("KOLIBRIE_MQO", "force")
    for m, db in ((ref_mqo, ref), (port_mqo, tdb)):
        m.register_standing(db, "w")
    with ref_mqo.standing_scope(ref, "w"):
        want = RefEngine(ref).explain_device(q, analyze=True)
    with port_mqo.standing_scope(tdb, "w"):
        got = PortEngine(tdb).explain_device(q, analyze=True)
    assert masked(got) == masked(want)
    assert "\nmqo: shared prefix=" in got


def test_advisor_sequence_matches_reference():
    ref, tdb = lubm_pair(1)
    with ref_sa.override_mode("auto"), port_sa.override_mode("auto"):
        for step in range(3):
            assert port.execute_query_volcano(JOIN_Q, tdb) == ref_execute(JOIN_Q, ref)
            if step == 1:
                for db, execute in ((ref, ref_execute), (tdb, port.execute_query_volcano)):
                    execute(UB + "INSERT DATA { <http://churn/p> ub:worksFor "
                            "<http://www.Department0.University0.edu> . "
                            "<http://churn/p> ub:teacherOf <http://churn/c> }", db)
        first = RefEngine(ref).explain_device(JOIN_Q, analyze=True)
        again = PortEngine(tdb).explain_device(JOIN_Q, analyze=True)
        assert masked(again) == masked(first)
        assert "est=" in again and "advisor: source=learned" in again
        fp = next(iter(port_info(tdb)["per_template"]))
        assert port_sa.stats_advisor.report(fp) == ref_sa.stats_advisor.report(fp)
        assert port_sa.stats_advisor.view(fp) == ref_sa.stats_advisor.view(fp)
        assert port_sa.stats_advisor.stats() == ref_sa.stats_advisor.stats()
        assert port_info(tdb)["advisor_replans"] == ref_info(ref)["advisor_replans"]


def test_q9_drift_replan_matches_reference():
    ref, tdb = lubm_pair(4)
    with ref_sa.override_mode("auto"), port_sa.override_mode("auto"):
        rows = None
        for _ in range(3):
            want = ref_execute(lubm.LUBM_Q9, ref)
            got = port.execute_query_volcano(lubm.LUBM_Q9, tdb)
            assert got == want
            rows = rows or got
            assert got == rows
        assert port_info(tdb)["advisor_replans"] == ref_info(ref)["advisor_replans"] >= 1
        assert port_sa.stats_advisor.stats() == ref_sa.stats_advisor.stats()
        exp = PortEngine(tdb).explain_device(lubm.LUBM_Q9)
        assert exp == RefEngine(ref).explain_device(lubm.LUBM_Q9)
        assert "wcoj elim=" not in exp
    with port_sa.override_mode("off"):
        assert "wcoj elim=" in PortEngine(tdb).explain_device(lubm.LUBM_Q9)


def test_advisor_state_crosses_packages():
    ref, tdb = lubm_pair(1)
    with ref_sa.override_mode("auto"), port_sa.override_mode("auto"):
        ref_execute(JOIN_Q, ref)
        port.execute_query_volcano(lubm.LUBM_Q2, tdb)
        ref_doc = ref_sa.stats_advisor.export_state()
        port_doc = port_sa.stats_advisor.export_state()
        ref_fps, port_fps = set(ref_doc["templates"]), set(port_doc["templates"])
        assert ref_fps and port_fps and not ref_fps & port_fps
        assert port_sa.stats_advisor.import_state(ref_doc) == 1
        assert ref_sa.stats_advisor.import_state(port_doc) == 1
        for fp in ref_fps | port_fps:
            assert port_sa.stats_advisor.view(fp) == ref_sa.stats_advisor.view(fp)
            assert port_sa.stats_advisor.view(fp)
