"""The port's mesh serving layer against the JAX package's, on an 8-shard
CPU mesh.

A LUBM-2 store with a ``ShardedDatabase`` attached (the reference's on the
8 virtual CPU devices of ``tests/conftest.py``, the port's on
``make_mesh(8, devices=[cpu] * 8)``): the mirrors per shard and against
the store, ``refresh`` idempotence, signature, occupancy and every
``stats()`` value; a batched template group and a solo ``execute`` equal
to the reference's rows and to the single-device oracle, with the same
counters and EXPLAIN ANALYZE records; the plan-cache state key carrying
the mesh signature; interleaved mutations against the oracle; mutation
batches under the delta threshold leaving ``sharded_compile_stats()`` and
the base probe index alone; recovery and checkpoint restore rebuilding the
mirrors; a mesh device fault degrading to the single-device path with the
breaker counting it; a deadline propagating; ``detach`` restoring the
single-device key; the ``shard.dispatch`` spans; a CPU server with the
mesh answering over HTTP with the reference's rows, its ``sharding`` keys
and every mesh metric family; and a rehearsal of ``chip_smoke.py`` phase
16.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch

import kolibrie_tpu_torch as port
import kolibrie_tpu_torch.parallel as P
from benches.lubm import LUBM_Q2, generate_fast
from kolibrie_tpu.parallel.sharded_serving import attach_sharded as ref_attach
from kolibrie_tpu.query.executor import execute_queries_batched as ref_batched
from kolibrie_tpu.query.executor import execute_query_volcano as ref_execute
from kolibrie_tpu.query.sparql_database import SparqlDatabase as RefDatabase
from kolibrie_tpu_torch.parallel.sharded_serving import (
    attach_sharded,
    detach_sharded,
    sharded_compile_stats,
)
from kolibrie_tpu_torch.query.executor import (
    _plan_caches,
    execute_queries_batched,
    execute_query_volcano,
)
from serving_pair import get, post, start

PREFIX = "PREFIX ub: <http://swat.cse.lehigh.edu/onto/univ-bench.owl#>\n"
TEMPLATE = PREFIX + "SELECT ?x ?c WHERE {{ ?x ub:worksFor <{dept}> . ?x ub:teacherOf ?c . }}"
DEPTS_Q = PREFIX + "SELECT DISTINCT ?d WHERE { ?x ub:worksFor ?d . }"
WORKS_Q = PREFIX + "SELECT ?x ?d WHERE { ?x ub:worksFor ?d . }"
WORKS = "http://swat.cse.lehigh.edu/onto/univ-bench.owl#worksFor"
MESH_FAMILIES = (
    "kolibrie_shard_dispatch_total", "kolibrie_shard_queries_total",
    "kolibrie_shard_rows_scanned_total", "kolibrie_shard_exchanged_bytes_total",
    "kolibrie_shard_h2d_bytes_total", "kolibrie_shard_imbalance", "kolibrie_shard_rows",
    "kolibrie_shard_exchange_cap_hits_total", "kolibrie_shard_fallback_total",
    "kolibrie_shard_dispatch_seconds", "kolibrie_shard_attach_errors_total",
    "kolibrie_store_shards", "kolibrie_store_shard_imbalance",
)


def cpu_mesh():
    return P.make_mesh(8, devices=[torch.device("cpu")] * 8)


def lubm_pair(universities: int):
    ref = RefDatabase()
    ref.store.add_batch(*generate_fast(universities, ref.dictionary))
    ref.execution_mode = "host"
    db = port.SparqlDatabase.from_arrays(ref.dictionary.id_to_str, *ref.store.columns(),
                                         device="cpu")
    db.execution_mode = "host"
    return ref, db


def lubm_db(universities: int = 1):
    return lubm_pair(universities)[1]


def template_group(db, k):
    deps = execute_query_volcano(DEPTS_Q, db)
    assert len(deps) >= k
    return [TEMPLATE.format(dept=d[0]) for d in deps[:k]]


def host(sharded) -> np.ndarray:
    return np.stack([t.numpy() for t in sharded])


@pytest.fixture(scope="module")
def pair(mesh8):
    ref, db = lubm_pair(2)
    rsh, sh = ref_attach(ref, mesh8), attach_sharded(db, cpu_mesh())
    rsh.refresh()
    sh.refresh()
    return ref, db, rsh, sh


def comparable(stats: dict) -> dict:
    """``stats()`` less what is process-wide or a wall-clock time."""
    return {k: v for k, v in stats.items() if k not in ("compile_surfaces", "last_cap_hit")}


# ------------------------------------------------------------------ mirrors


def test_mirror_matches_reference_and_store(pair):
    ref, db, rsh, sh = pair
    for name in ("by_subj", "by_obj"):
        for k in range(3):
            np.testing.assert_array_equal(host(getattr(sh.view, name)[k]),
                                          np.asarray(getattr(rsh.view, name)[k]))
        np.testing.assert_array_equal(host(getattr(sh.view, name + "_valid")),
                                      np.asarray(getattr(rsh.view, name + "_valid")))
    st = db.store
    bs, bp, bo = st.base_rows("spo")
    keep = np.ones(len(bs), dtype=bool)
    keep[st.delta_del_positions("spo")] = False
    expect = set(zip(bs[keep].tolist(), bp[keep].tolist(), bo[keep].tolist()))
    ds, dp, do = st.delta_rows("spo")
    expect |= set(zip(ds.tolist(), dp.tolist(), do.tolist()))
    s, p, o = sh.view.gather_host()
    assert set(zip(s.tolist(), p.tolist(), o.tolist())) == expect


def test_refresh_is_idempotent_and_stats_match_reference(pair):
    ref, db, rsh, sh = pair
    rebuilds = sh.stats_counters["base_rebuilds"]
    assert sh.refresh() is False
    assert sh.stats_counters["base_rebuilds"] == rebuilds
    stats = sh.stats()
    assert set(stats) == set(rsh.stats())
    assert comparable(stats) == comparable(rsh.stats())
    assert stats["shards"] == 8 and sum(stats["occupancy"]) == len(db.store)
    assert stats["imbalance"] >= 1.0 and sh.signature == ("shards", 8, sh.axis)
    assert set(stats["compile_surfaces"]) == {"batched_programs", "assemble_shapes"}


# ------------------------------------------------------- batched execution


def test_batched_group_and_solo_match_reference(pair):
    from kolibrie_tpu.obs import analyze as ref_analyze
    from kolibrie_tpu_torch.obs import analyze

    ref, db, rsh, sh = pair
    texts = template_group(db, 4)
    oracle = [execute_query_volcano(t, db) for t in texts]
    assert all(oracle)
    with ref_analyze.capture() as rcap:
        want = ref_batched(ref, texts)
    with analyze.capture() as cap:
        got = execute_queries_batched(db, texts)
    assert got == want == oracle
    assert comparable(sh.stats()) == comparable(rsh.stats())
    recs, rrecs = ([r for r in c.records if r["kind"] == "sharded"] for c in (cap, rcap))
    assert len(recs) == len(texts)
    for r, w in zip(recs, rrecs):
        assert {k: r[k] for k in ("member", "shards", "stat_names", "per_shard", "operators",
                                  "caps")} == {k: w[k] for k in ("member", "shards", "stat_names",
                                                                  "per_shard", "operators", "caps")}
    assert sh.execute(LUBM_Q2) == rsh.execute(LUBM_Q2) == ref_execute(LUBM_Q2, ref)
    _, templates, _ = _plan_caches(db)
    keys = [k for t in templates.values() for k in t["by_state"]]
    assert keys and all(k[-1] == sh.signature for k in keys)


def test_divergent_members_fall_back_to_oracle(mesh8):
    ref, db = lubm_pair(1)
    rsh, sh = ref_attach(ref, mesh8), attach_sharded(db, cpu_mesh())
    deps = execute_query_volcano(DEPTS_Q, db)
    texts = [PREFIX + "SELECT ?x ?c WHERE { ?x ub:worksFor <%s> . ?x ub:teacherOf ?c . "
             "FILTER(?x != <%s>) }" % (d[0], d[0]) for d in deps[:2]]
    oracle = [execute_query_volcano(t, db) for t in texts]
    assert execute_queries_batched(db, texts) == ref_batched(ref, texts) == oracle
    assert sh.stats_counters["fallbacks"] == rsh.stats_counters["fallbacks"] == 1


# ------------------------------------------------ mutation: O(delta), fuzz


@pytest.mark.parametrize("seed", [8, 21])
def test_interleaved_mutation_fuzz_vs_oracle(seed):
    db = lubm_db(1)
    sh = attach_sharded(db, cpu_mesh())
    sh.refresh()
    texts = template_group(db, 3)
    rng = np.random.default_rng(seed)
    d = db.dictionary
    pred = d.encode("http://fuzz/p")
    works = d.encode(WORKS)
    churn, uid = [], 0
    for rnd in range(5):
        n_add = int(rng.integers(1, 30))
        s = np.array([d.encode(f"http://fuzz/s{uid + k}") for k in range(n_add)], dtype=np.uint32)
        o = np.array([d.encode(f"http://fuzz/o{uid + k}") for k in range(n_add)], dtype=np.uint32)
        uid += n_add
        db.store.add_batch(s, np.full(n_add, pred, dtype=np.uint32), o)
        churn.extend(zip(s.tolist(), o.tolist()))
        for _ in range(min(len(churn), int(rng.integers(0, 8)))):
            ts, to = churn.pop(int(rng.integers(0, len(churn))))
            db.store.remove(ts, pred, to)
        # delete a LIVE LUBM edge so the oracle's answer moves too
        rows = execute_query_volcano(WORKS_Q, db)
        vx, vd = rows[int(rng.integers(0, len(rows)))]
        db.store.remove(d.encode(vx), works, d.encode(vd))
        assert execute_queries_batched(db, texts) == [
            execute_query_volcano(t, db) for t in texts], rnd
        assert len(sh.view.gather_host()[0]) == len(db.store)


def test_mutation_batches_cause_zero_recompiles():
    db = lubm_db(1)
    sh = attach_sharded(db, cpu_mesh())
    sh.refresh()
    texts = template_group(db, 3)
    execute_queries_batched(db, texts)
    before = sharded_compile_stats()
    base_builds = sh.view.subj_index_base_builds
    d = db.dictionary
    for r in range(4):
        s = np.array([d.encode(f"http://zr/{r}-{k}") for k in range(6)], dtype=np.uint32)
        p = np.full(6, d.encode("http://zr/p"), dtype=np.uint32)
        o = np.array([d.encode(f"http://zr/o{r}-{k}") for k in range(6)], dtype=np.uint32)
        db.store.add_batch(s, p, o)
        assert execute_queries_batched(db, texts) == [execute_query_volcano(t, db) for t in texts]
    assert sharded_compile_stats() == before
    assert sh.view.subj_index_base_builds == base_builds
    assert sh.view.subj_index_delta_builds >= 4
    assert sh.stats_counters["base_rebuilds"] == 1


# --------------------------------------------------- durability / recovery


def test_recovery_rebuilds_sharded_mirrors(tmp_path):
    from kolibrie_tpu_torch.durability.manager import DurabilityManager

    data = str(tmp_path / "data")
    m = DurabilityManager(data, fsync_policy="always", device="cpu")
    m.start()
    db = port.SparqlDatabase(device="cpu")
    db.execution_mode = "host"
    m.attach("s1", db)
    db.parse_ntriples("\n".join(
        f"<http://r/e{i}> <http://r/p> <http://r/o{i % 7}> ." for i in range(60)))
    m.snapshot({"s1": db})
    db.parse_ntriples("<http://r/extra> <http://r/p> <http://r/o1> .")  # WAL only
    q = "SELECT ?s WHERE { ?s <http://r/p> <http://r/o1> . }"
    oracle = execute_query_volcano(q, db)
    m.close()
    m2 = DurabilityManager(data, fsync_policy="always", device="cpu")
    rebuilt = {}

    def hook(sid, rdb):
        sh = attach_sharded(rdb, cpu_mesh())
        sh.refresh()
        rebuilt[sid] = sh

    m2.on_store_recovered = hook
    res = m2.recover()
    m2.close()
    rdb = res.stores["s1"]
    assert len(rdb.store) == len(db.store)
    assert len(rebuilt["s1"].view.gather_host()[0]) == len(rdb.store)
    assert sorted(rebuilt["s1"].execute(q)) == sorted(oracle)


def test_checkpoint_restore_then_refresh(tmp_path):
    db = lubm_db(1)
    attach_sharded(db, cpu_mesh()).refresh()
    path = str(tmp_path / "ck.bin")
    db.checkpoint(path)
    db2 = port.SparqlDatabase.from_checkpoint(path, device="cpu")
    db2.execution_mode = "host"
    sh2 = attach_sharded(db2, cpu_mesh())
    sh2.refresh()
    q = template_group(db, 1)[0]
    assert sh2.execute(q) == execute_query_volcano(q, db)
    # restore() swaps the base arrays at an equal signature: refresh sees it
    snap = db2.store.snapshot()
    db2.store.add(1, 2, 3)
    len(db2.store)
    sh2.refresh()
    db2.store.restore(snap)
    assert sh2.refresh() is True
    assert len(sh2.view.gather_host()[0]) == len(db2.store)


# ------------------------------------------------------------- resilience


def test_mesh_fault_degrades_to_single_device():
    from kolibrie_tpu_torch.resilience.breaker import breaker_board
    from kolibrie_tpu_torch.resilience.faultinject import FaultPlan, InjectedDeviceOOM

    db = lubm_db(1)
    attach_sharded(db, cpu_mesh()).refresh()
    texts = template_group(db, 3)
    oracle = [execute_query_volcano(t, db) for t in texts]
    plan = FaultPlan(seed=3)
    plan.add("shard.dispatch", error=InjectedDeviceOOM, rate=1.0)
    with plan.installed():
        got = execute_queries_batched(db, texts)
    assert got == oracle
    assert any(rec["total_failures"] >= 1 for rec in breaker_board(db).snapshot().values())


def test_mesh_deadline_propagates():
    from kolibrie_tpu_torch.resilience.deadline import Deadline, deadline_scope
    from kolibrie_tpu_torch.resilience.errors import DeadlineExceeded

    db = lubm_db(1)
    sh = attach_sharded(db, cpu_mesh())
    sh.refresh()
    with pytest.raises(DeadlineExceeded):
        with deadline_scope(Deadline(0.0)):
            sh.execute(template_group(db, 1)[0])
    with pytest.raises(DeadlineExceeded):
        with deadline_scope(Deadline(0.0)):
            sh.execute_batch("fp", [(0, template_group(db, 1)[0])])


def test_detach_restores_single_device_key():
    db = lubm_db(1)
    sh = attach_sharded(db, cpu_mesh())
    assert attach_sharded(db) is sh  # attaching again returns the same layer
    texts = template_group(db, 2)
    execute_queries_batched(db, texts)
    detach_sharded(db)
    assert P.active_sharded(db) is None
    assert execute_queries_batched(db, texts) == [execute_query_volcano(t, db) for t in texts]
    _, templates, _ = _plan_caches(db)
    keys = [k for t in templates.values() for k in t["by_state"]]
    assert any(k[-1] is None for k in keys) and any(k[-1] == sh.signature for k in keys)
    # a one-device runtime attaches nothing without an explicit mesh
    assert attach_sharded(db) is None


def test_dispatch_emits_shard_spans(pair):
    from kolibrie_tpu_torch.obs.spans import spans_snapshot, trace_scope

    _ref, db, _rsh, _sh = pair
    with trace_scope("trace-shard") as tid:
        execute_queries_batched(db, template_group(db, 3))
    spans = spans_snapshot(tid)
    names = [s["name"] for s in spans]
    assert "executor.sharded" in names and "shard.dispatch" in names
    kids = [s for s in spans if s["name"] == "shard.partition"]
    assert len(kids) == 8 and all("rows" in k["attrs"] for k in kids)


# ----------------------------------------------------------- HTTP serving


def test_http_server_with_a_mesh_serves_sharded(pair):
    from kolibrie_tpu_torch.frontends import http_server as hs

    _ref, _db, rsh, _sh = pair
    httpd = hs.make_server("127.0.0.1", 0, quiet=True, device="cpu", mesh=cpu_mesh())
    base = start(httpd)
    try:
        ref, db = lubm_pair(1)
        st, out, _ = post(base, "/store/load",
                          {"rdf": db.to_ntriples(), "format": "ntriples", "mode": "host"})
        assert st == 200 and out["triples"] == len(db.store)
        sid = out["store_id"]
        texts = template_group(db, 4)
        answers, errors = {}, []

        def client(i):
            try:
                answers[i] = post(base, "/store/query", {"store_id": sid, "sparql": texts[i]})[1]
            except Exception as e:  # reported below
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(texts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert not errors
        for i, t in enumerate(texts):
            assert sorted(map(tuple, answers[i]["data"])) == sorted(map(tuple, ref_execute(t, ref)))
        got = post(base, "/store/query", {"store_id": sid, "sparql": LUBM_Q2})[1]["data"]
        assert sorted(map(tuple, got)) == sorted(map(tuple, ref_execute(LUBM_Q2, ref)))
        stats = json.loads(get(base, "/stats")[1])
        sharding = stats["stores"][sid]["sharding"]
        assert set(sharding) == set(rsh.stats())
        assert sharding["shards"] == 8 and len(sharding["occupancy"]) == 8
        metrics = get(base, "/metrics")[1].decode()
        assert [f for f in MESH_FAMILIES if f"# TYPE {f} " not in metrics] == []
    finally:
        httpd.shutdown()


def test_chip_smoke_phase16_rehearsal(monkeypatch):
    """``chip_smoke.py`` phase 16 on the CPU at LUBM-2 (16 variants, an
    insert of 200 triples: a batch under a sixteenth of the store keeps
    the base), against the single-device rows and the host closure."""
    import chip_smoke as CS
    from benches.lubm import LUBM_Q9

    db = lubm_db(2)
    db.execution_mode = "auto"
    rows = {"q2": execute_query_volcano(LUBM_Q2, db), "q9": execute_query_volcano(LUBM_Q9, db)}
    r = port.Reasoner(db.dictionary, device="cpu")
    r.facts.add_batch(*db.store.columns())
    CS.add_lubm_closure_rules(r)
    seeded = len(r.facts)
    r.infer_new_facts_semi_naive()
    monkeypatch.setattr(CS, "CLOSURE_DERIVED", len(r.facts) - seeded)
    monkeypatch.setattr(CS, "MESH_VARIANTS", 16)
    monkeypatch.setattr(CS, "MESH_INSERT", 200)
    out = CS.run_mesh_phase(torch.device("cpu"),
                            {"queries": [("q2", db, LUBM_Q2, "auto")], "rows": rows},
                            {"facts": r.facts.columns()})
    rep = out["report"]
    assert rep["16b"]["q9"]["rows"] == len(rows["q9"]) > 0
    assert rep["16c"]["derived"] == CS.CLOSURE_DERIVED > 0
    assert rep["16d"]["stats"]["batched_queries"] >= 2 * 16
    assert {"merge_path_join", "filter_mask"} <= set(out["captured"])
