"""The port's multi-query optimizer against the JAX package's.

Templates that differ only in their trailing filters share one scan/join
prefix: under ``KOLIBRIE_MQO`` ``off`` / ``auto`` / ``force`` the rows
must equal each other and the reference's, through standing scopes, a
batch's transient beneficiaries, the host twin (an interpreter decline)
and after mutations; ``mqo.stats`` (less its port-only ``host_evals``
count, checked on its own) and ``describe_shared`` must equal the
reference's after the same sequence.  All exact.
"""

from __future__ import annotations

import pytest

import kolibrie_tpu_torch as port
from kolibrie_tpu.optimizer import mqo as ref_mqo
from kolibrie_tpu.optimizer import plan_interp as ref_pi
from kolibrie_tpu.query.executor import execute_queries_batched as ref_batched
from kolibrie_tpu.query.executor import execute_query_volcano as ref_execute
from kolibrie_tpu.query.sparql_database import SparqlDatabase as RefDatabase
from kolibrie_tpu_torch.optimizer import device_engine as port_de
from kolibrie_tpu_torch.optimizer import mqo as port_mqo
from kolibrie_tpu_torch.optimizer import plan_interp as port_pi
from kolibrie_tpu_torch.query import executor as tex
from test_torch_clauses import pair
from test_torch_prepared import lower_both
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

P = "PREFIX ex: <http://example.org/>\n"


def people_pair(n=240):
    db = RefDatabase()
    lines = []
    for i in range(n):
        e = f"<http://example.org/e{i}>"
        lines.append(f'{e} <http://example.org/dept> "dept{i % 5}" .')
        lines.append(f'{e} <http://example.org/salary> "{20 + (i % 50)}" .')
        lines.append(f'{e} <http://example.org/grade> "{i % 9}" .')
    db.parse_ntriples("\n".join(lines))
    return pair(db)


def q_filter(th: int, dept: int = 2, op: str = ">") -> str:
    return P + (f'SELECT ?e ?s WHERE {{ ?e ex:dept "dept{dept}" . '
                f"?e ex:salary ?s . FILTER(?s {op} {th}) }}")


def q_grade(th: int) -> str:
    return P + ('SELECT ?e ?s ?g WHERE { ?e ex:dept "dept2" . ?e ex:salary ?s . ?e ex:grade ?g . '
                f"FILTER(?g >= {th} && ?s < 60) }}")


def host_evals(stats: dict) -> dict:
    """Pop the port-only ``host_evals`` count out of each prefix of
    ``stats`` (in place) and return them by prefix."""
    return {fp: p.pop("host_evals") for fp, p in stats["prefixes"].items()}


def port_stats(db, host: dict = None) -> dict:
    """The port's ``mqo.stats`` in the reference's shape: its
    ``host_evals`` must equal ``host`` (0 for every prefix not named)."""
    stats = port_mqo.stats(db)
    got = host_evals(stats)
    assert got == {fp: (host or {}).get(fp, 0) for fp in got}
    return stats


def both(monkeypatch, mode, fn):
    monkeypatch.setenv("KOLIBRIE_MQO", mode)
    return fn()


@pytest.mark.parametrize("mode", ["auto", "force"])
def test_standing_rows_and_stats_match_reference(monkeypatch, mode):
    ref, tdb = people_pair()
    queries = [q_filter(30), q_filter(55), q_filter(30, op="<"), q_grade(4), q_filter(40, dept=1)]
    monkeypatch.setenv("KOLIBRIE_MQO", "off")
    off = [port.execute_query_volcano(q, tdb) for q in queries]
    assert off == [ref_execute(q, ref) for q in queries]
    monkeypatch.setenv("KOLIBRIE_MQO", mode)
    for m, db in ((ref_mqo, ref), (port_mqo, tdb)):
        m.register_standing(db, "w1")
        m.register_standing(db, "w2")
    for owner in ("w1", "w2"):
        for q in queries:
            with ref_mqo.standing_scope(ref, owner):
                want = ref_execute(q, ref)
            with port_mqo.standing_scope(tdb, owner):
                got = port.execute_query_volcano(q, tdb)
            assert got == want == off[queries.index(q)], q
    assert port_stats(tdb) == ref_mqo.stats(ref)
    prefixes = port_stats(tdb)["prefixes"]
    assert any(p["shared_evals"] == 1 and p["cache_hits"] > 0 for p in prefixes.values())
    for q in queries:
        r = ref_mqo.describe_shared(ref, lower_both("kolibrie_tpu", ref, q))
        t = port_mqo.describe_shared(tdb, lower_both("kolibrie_tpu_torch", tdb, q))
        assert t == r and t.startswith("mqo:")


def test_mutations_invalidate_the_prefix_cache(monkeypatch):
    ref, tdb = people_pair()
    monkeypatch.setenv("KOLIBRIE_MQO", "force")
    steps = [
        q_filter(30),
        'INSERT DATA { ex:new ex:dept "dept2" . ex:new ex:salary "77" }',
        q_filter(30),
        q_filter(60),
        'DELETE DATA { ex:e2 ex:salary "22" }',
        q_filter(20),
    ]
    for text in steps:
        want = ref_execute(P + text if not text.startswith(P) else text, ref)
        got = port.execute_query_volcano(P + text if not text.startswith(P) else text, tdb)
        assert got == want, text
        if text.startswith(P):
            monkeypatch.setenv("KOLIBRIE_MQO", "off")
            assert port.execute_query_volcano(text, tdb) == got
            monkeypatch.setenv("KOLIBRIE_MQO", "force")
    assert port_stats(tdb) == ref_mqo.stats(ref)


def test_batch_transient_beneficiaries(monkeypatch):
    ref, tdb = people_pair()
    monkeypatch.setenv("KOLIBRIE_MQO", "auto")
    batch = [q_filter(30), q_filter(45, op="<"), q_filter(20, op=">="), q_grade(3)]
    assert tex.execute_queries_batched(tdb, batch) == ref_batched(ref, batch)
    assert port_stats(tdb) == ref_mqo.stats(ref)
    monkeypatch.setenv("KOLIBRIE_MQO", "off")
    assert tex.execute_queries_batched(tdb, batch) == [port.execute_query_volcano(q, tdb)
                                                       for q in batch]


def test_host_twin_routes_match_reference(monkeypatch):
    ref, tdb = people_pair()
    monkeypatch.setenv("KOLIBRIE_MQO", "force")
    # a prefix over the interpreter's cell budget evaluates on the host twin
    monkeypatch.setattr(ref_pi, "_MAX_CELLS", 64)
    monkeypatch.setattr(port_pi, "_MAX_CELLS", 64)
    for q in (q_grade(2), q_filter(25), q_filter(50)):
        r = lower_both("kolibrie_tpu", ref, q)
        t = lower_both("kolibrie_tpu_torch", tdb, q)
        rt, tt = ref_mqo.try_shared_execute(r), port_mqo.try_shared_execute(t)
        assert {k: v.tolist() for k, v in tt.items()} == {k: v.tolist() for k, v in rt.items()}
    # q_filter(25) and q_filter(50) share one prefix: one host evaluation
    # each for the two prefixes, the second q_filter a cache hit
    stats = port_mqo.stats(tdb)
    assert sorted(host_evals(stats).values()) == [1, 1]
    assert stats == ref_mqo.stats(ref)


def test_device_prefix_is_counted_as_such(monkeypatch):
    """Within the interpreter's budget every prefix runs on the device:
    the interpreter's counts readback moves once per shared evaluation,
    and no prefix counts a host evaluation."""
    ref, tdb = people_pair()
    monkeypatch.setenv("KOLIBRIE_MQO", "force")
    before = port_de.fetch_counters().get("mqo.counts", 0)
    for q in (q_filter(33), q_grade(5), q_filter(33), q_filter(41)):
        r = lower_both("kolibrie_tpu", ref, q)
        t = lower_both("kolibrie_tpu_torch", tdb, q)
        rt, tt = ref_mqo.try_shared_execute(r), port_mqo.try_shared_execute(t)
        assert {k: v.tolist() for k, v in tt.items()} == {k: v.tolist() for k, v in rt.items()}
    stats = port_stats(tdb)
    assert stats == ref_mqo.stats(ref)
    evals = sum(p["shared_evals"] for p in stats["prefixes"].values())
    assert evals == 2
    assert port_de.fetch_counters().get("mqo.counts", 0) - before == evals


def test_off_is_inert(monkeypatch):
    _ref, tdb = people_pair(60)
    monkeypatch.setenv("KOLIBRIE_MQO", "off")
    port_mqo.register_standing(tdb, "w1")
    with port_mqo.standing_scope(tdb, "w1"):
        port.execute_query_volcano(q_filter(30), tdb)
    stats = port_stats(tdb)
    assert stats["mode"] == "off" and stats["prefixes"] == {} and stats["cache_entries"] == 0
    assert port_mqo.describe_shared(tdb, lower_both("kolibrie_tpu_torch", tdb, q_filter(30))) is None
