"""The port's plan-bytecode interpreter against the JAX package's.

``compile_bytecode`` must emit the reference's int32 op table
(``np.array_equal``), size class and slot map for the same lowered plan;
``interp_execute`` must return the reference interpreter's table (rows in
order, exact) and converge to the same counts; both must decline the same
shapes (string masks, VALUES, clause branches, quoted patterns, WCOJ,
repeated-variable patterns); ``KOLIBRIE_PLAN_INTERP=force`` routes a
query through the interpreter (``last_source == "interp"``) with the rows
of the specialized path, and a declined shape runs specialized.
"""

from __future__ import annotations


import numpy as np
import pytest

import kolibrie_tpu_torch as port
from kolibrie_tpu.optimizer import plan_interp as ref_pi
from kolibrie_tpu_torch.optimizer import device_engine as tde
from kolibrie_tpu_torch.optimizer import plan_interp as port_pi
from kolibrie_tpu_torch.query import executor as tex
from test_torch_clauses import PREFIXES, employee_db, pair, rdf_star_db
from test_torch_prepared import graph_pair, lower_both
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

ELIGIBLE = {
    "scan": ("emp", 'SELECT ?e WHERE { ?e ex:dept "dept2" }'),
    "join_filter": ("emp", 'SELECT ?e ?s WHERE { ?e ex:dept "dept1" . ?e ex:salary ?s . '
                           "FILTER(?s > 60000) }"),
    "and_chain": ("emp", "SELECT ?e ?s ?w WHERE { ?e ex:salary ?s . ?e foaf:workplaceHomepage ?w . "
                         "FILTER(?s >= 40000 && ?s < 70000 && ?w != <http://company1.example/>) }"),
    "numv": ("emp", "SELECT ?a ?b WHERE { ?a ex:knows ?b . ?a ex:salary ?x . ?b ex:salary ?y . "
                    "FILTER(?x < ?y) }"),
    "two_key": ("graph", "SELECT ?a ?b ?g WHERE { ?a ex:knows ?b . ?b ex:knows ?a . ?a ex:age ?g . "
                         "FILTER(?g > 30) }"),
    "chain_delta": ("graph", "SELECT ?a ?c WHERE { ?a ex:knows ?b . ?b ex:knows ?c . "
                             "?c ex:type ex:T3 }"),
}
DECLINED = {
    "string_mask": ("emp", 'SELECT ?e ?d WHERE { ?e ex:dept ?d . FILTER(CONTAINS(?d, "3")) }'),
    "values": ("emp", 'SELECT ?e ?d WHERE { ?e ex:dept ?d . VALUES ?d { "dept1" "dept3" } }'),
    "optional": ("emp", "SELECT ?e ?s ?y WHERE { ?e ex:salary ?s . OPTIONAL { ?e ex:knows ?y } }"),
    "minus": ("emp", 'SELECT ?e ?s WHERE { ?e ex:salary ?s MINUS { ?e ex:dept "dept1" } }'),
    "or_filter": ("emp", "SELECT ?e ?s WHERE { ?e ex:salary ?s . FILTER(?s < 35000 || ?s > 70000) }"),
    "quoted": ("star", "SELECT ?s ?v ?c WHERE { << ?s ex:age ?v >> ex:certainty ?c }"),
    "wcoj": ("graph", "SELECT ?a ?b ?c WHERE { ?a ex:knows ?b . ?b ex:knows ?c . ?c ex:knows ?a }"),
}


@pytest.fixture(scope="module")
def dbs():
    return {"emp": pair(employee_db(300)), "star": pair(rdf_star_db()), "graph": graph_pair()}


def program(pi, low):
    low.build()
    return pi.compile_bytecode(low)


@pytest.mark.parametrize("name", sorted(ELIGIBLE))
def test_bytecode_and_rows_match_reference(dbs, name):
    key, q = ELIGIBLE[name]
    ref, tdb = dbs[key]
    r = lower_both("kolibrie_tpu", ref, PREFIXES + q)
    t = lower_both("kolibrie_tpu_torch", tdb, PREFIXES + q)
    rp, tp = program(ref_pi, r), program(port_pi, t)
    assert np.array_equal(tp.code, rp.code)
    assert tp.code.dtype == np.int32
    assert (tp.n_ops, tp.cap, tp.n_slots, tp.out_reg, tp.n_real) == (
        rp.n_ops, rp.cap, rp.n_slots, rp.out_reg, rp.n_real)
    assert tp.var_slots == rp.var_slots and tp.stat_keys == rp.stat_keys
    if name == "two_key":
        assert any(row[0] == port_pi.JOIN and row[3] == 2 for row in tp.code)
    rt = ref_pi.interp_execute(r)
    tt = port_pi.interp_execute(t)
    for v in t.out_vars:
        assert np.array_equal(tt[v], rt[v]), v
    assert t._join_caps == r._join_caps
    # the interpreter's rows are the specialized path's
    spec = lower_both("kolibrie_tpu_torch", tdb, PREFIXES + q).execute()
    assert sorted(zip(*[spec[v].tolist() for v in t.out_vars])) == sorted(
        zip(*[tt[v].tolist() for v in t.out_vars]))


@pytest.mark.parametrize("name", sorted(DECLINED))
def test_declines_match_reference(dbs, name):
    key, q = DECLINED[name]
    ref, tdb = dbs[key]
    r = lower_both("kolibrie_tpu", ref, PREFIXES + q)
    t = lower_both("kolibrie_tpu_torch", tdb, PREFIXES + q)
    with pytest.raises(ref_pi.InterpUnsupported) as rexc:
        program(ref_pi, r)
    with pytest.raises(port_pi.InterpUnsupported) as texc:
        program(port_pi, t)
    assert str(texc.value) == str(rexc.value)
    assert port_pi.interp_execute(t) is None


def test_cell_budget_declines_like_reference(dbs, monkeypatch):
    ref, tdb = dbs["emp"]
    q = PREFIXES + ELIGIBLE["join_filter"][1]
    monkeypatch.setattr(ref_pi, "_MAX_CELLS", 64)
    monkeypatch.setattr(port_pi, "_MAX_CELLS", 64)
    for pi, pkg, db in ((ref_pi, "kolibrie_tpu", ref), (port_pi, "kolibrie_tpu_torch", tdb)):
        with pytest.raises(pi.InterpUnsupported, match="cell budget"):
            program(pi, lower_both(pkg, db, q))


def test_forced_routing(dbs):
    _ref, tdb = dbs["emp"]
    q = PREFIXES + ELIGIBLE["join_filter"][1]
    want = port.execute_query_volcano(q, tdb)
    before = tde.device_compile_stats()
    with port_pi.override_mode("force"):
        got = port.execute_query_volcano(q, tdb)
        fp = next(iter(tex.plan_cache_info(tdb)["per_template"]))
        low = lower_both("kolibrie_tpu_torch", tdb, q)
        low.execute()
        assert low.last_source == "interp"
        wcoj = lower_both("kolibrie_tpu_torch", dbs["graph"][1], PREFIXES + DECLINED["wcoj"][1])
        wcoj.execute()
        assert wcoj.last_source == "compiled"
    assert got == want
    after = tde.device_compile_stats()
    assert after["run_interp"] >= before["run_interp"]
    assert fp


def test_auto_mode_interprets_until_specialized_ran(dbs):
    _ref, tdb = dbs["emp"]
    q = PREFIXES + 'SELECT ?e ?s WHERE { ?e ex:dept "dept4" . ?e ex:salary ?s . FILTER(?s < 45000) }'
    with port_pi.override_mode("auto"):
        low = lower_both("kolibrie_tpu_torch", tdb, q)
        assert port_pi.should_interp(low)
        low.execute()
        assert low.last_source == "interp"
        with port_pi.override_mode("off"):
            low.execute()
        assert low.last_source == "compiled"
        assert not port_pi.should_interp(low)
