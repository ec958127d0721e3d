"""The port's WAL-shipping replication and template-affinity router against
the JAX package's, on the CPU.

- The wire frames are byte-identical across packages.
- A port follower bootstraps from, and catches up to, a reference primary's
  ship server (and the other way round), and its stores equal the
  primary's: the packages write the same WAL segments and snapshots.
- The router keys templates and orders replicas as the reference's does.
- A port fleet — primary, follower and router in this process, on
  ephemeral ports, stores on ``device="cpu"`` — serves a write, a
  read-your-writes read on the follower, fleet metrics and a promotion
  driven in-process (the primary shut down, then ``/admin/promote``).
"""

from __future__ import annotations

import json
import socket
import threading

import pytest

from kolibrie_tpu.durability.manager import DurabilityManager as RefManager
from kolibrie_tpu.query.sparql_database import SparqlDatabase as RefDatabase
from kolibrie_tpu.replication import protocol as ref_protocol
from kolibrie_tpu.replication.follower import ReplicationFollower as RefFollower
from kolibrie_tpu.replication.primary import ShipServer as RefShip
from kolibrie_tpu.replication.router import RouterCore as RefCore
from kolibrie_tpu.replication.router import template_affinity_key as ref_key
from kolibrie_tpu_torch.durability.manager import DurabilityManager as PortManager
from kolibrie_tpu_torch.obs import log as port_log
from kolibrie_tpu_torch.query.sparql_database import SparqlDatabase as PortDatabase
from kolibrie_tpu_torch.replication import protocol as port_protocol
from kolibrie_tpu_torch.replication.follower import ReplicationFollower as PortFollower
from kolibrie_tpu_torch.replication.primary import ShipServer as PortShip
from kolibrie_tpu_torch.replication.router import RouterCore as PortCore
from kolibrie_tpu_torch.replication.router import make_router
from kolibrie_tpu_torch.replication.router import template_affinity_key as port_key
from serving_pair import free_port, get, post, start, wait_applied, wait_ready


@pytest.fixture(autouse=True)
def _quiet_logs():
    from kolibrie_tpu.obs import log as ref_log

    for lg in (ref_log, port_log):
        lg.set_quiet(True)
    yield
    for lg in (ref_log, port_log):
        lg.set_quiet(False)


def triples(db):
    return sorted(db.iter_decoded())


# ------------------------------------------------------------- the wire


@pytest.mark.parametrize("meta,tail", [
    ({"t": "manifest", "q": 1}, b""),
    ({"t": "poll", "q": 7, "after": 3}, b""),
    ({"t": "seg", "q": 9, "seg": 4, "crc": 123456}, bytes(range(256)) * 3),
    ({"t": "file", "gen": 2, "name": "store-1.npz", "q": 11}, b"\x00\xff" * 1000),
])
def test_wire_frames_are_byte_identical(meta, tail):
    frames = []
    for proto in (ref_protocol, port_protocol):
        a, b = socket.socketpair()
        with a, b:
            proto.send_msg(a, meta, tail)
            a.shutdown(socket.SHUT_WR)
            chunks = []
            while True:
                chunk = b.recv(65536)
                if not chunk:
                    break
                chunks.append(chunk)
        frames.append(b"".join(chunks))
    assert frames[1] == frames[0]
    import io

    for reader in (ref_protocol, port_protocol):
        got_meta, got_tail = reader.recv_msg(io.BytesIO(frames[0]))
        assert got_tail == tail and {k: got_meta[k] for k in meta} == meta


# --------------------------------------------- followers across packages

SIDES = {
    "ref": (RefManager, RefDatabase, RefShip, RefFollower, {}),
    "port": (PortManager, PortDatabase, PortShip, PortFollower, {"device": "cpu"}),
}


@pytest.mark.parametrize("primary,follower", [("ref", "port"), ("port", "ref")])
def test_follower_converges_on_the_other_package_primary(tmp_path, primary, follower):
    Manager, Database, Ship, _, dev = SIDES[primary]
    _, _, _, Follower, fdev = SIDES[follower]
    m = Manager(str(tmp_path / "primary"), fsync_policy="always", **dev)
    m.start()
    db = Database(**dev)
    m.attach("store-1", db)
    for i in range(15):
        db.add_triple_parts(f"<http://x/s{i}>", "<http://x/p>", f'"{i}"')
    ship = Ship(m, seal_interval_s=0.0)
    fol = Follower(str(tmp_path / "follower"), ship.host, ship.port, **fdev)
    late = None
    try:
        fol.bootstrap()
        fol.poll_once()
        assert triples(fol.res.stores["store-1"]) == triples(db)
        db.add_triple_parts("<http://x/new>", "<http://x/p>", '"late"')
        db.parse_ntriples("<http://x/a> <http://x/q> <http://x/b> .\n")
        fol.poll_once()
        assert triples(fol.res.stores["store-1"]) == triples(db)
        assert fol.lag_segments() == 0 and fol.watermark()["applied_segment"] >= 1
        # a follower joining after a snapshot bootstraps from the generation
        m.snapshot({"store-1": db})
        db.add_triple_parts("<http://x/post>", "<http://x/p>", '"snap"')
        late = Follower(str(tmp_path / "late"), ship.host, ship.port, **fdev)
        late.bootstrap()
        late.poll_once()
        assert triples(late.res.stores["store-1"]) == triples(db)
        assert late.stats()["bootstraps"] == 1
        if follower == "port":
            assert fol.res.stores["store-1"].device.type == "cpu"
    finally:
        for f in (fol, late):
            if f is not None:
                f.stop()
        ship.close()
        m.close()


def test_port_promotion_truncates_unapplied_and_journals(tmp_path):
    from kolibrie_tpu_torch.durability import wal

    m = RefManager(str(tmp_path / "primary"), fsync_policy="always")
    m.start()
    db = RefDatabase()
    m.attach("store-1", db)
    for i in range(10):
        db.add_triple_parts(f"<http://x/s{i}>", "<http://x/p>", f'"{i}"')
    ship = RefShip(m, seal_interval_s=0.0)
    fol = PortFollower(str(tmp_path / "follower"), ship.host, ship.port, device="cpu")
    try:
        fol.bootstrap()
        fol.poll_once()
        applied = fol.applied_segment
        stray = wal.segment_path(fol.manager.wal_dir, applied + 3)
        with open(stray, "wb") as fh:
            fh.write(wal.SEG_MAGIC)
            fh.write(wal.encode_record({"k": "mut", "st": "store-1", "ev": "clear"}))
        wm = fol.promote()
        assert wm["applied_segment"] == applied and fol.manager.wal.segment == applied + 1
        fdb = fol.res.stores["store-1"]
        fdb.add_triple_parts("<http://x/post>", "<http://x/p>", '"promo"')
        oracle = triples(fdb)
        fol.manager.close()
        for Manager, dev in ((PortManager, {"device": "cpu"}), (RefManager, {})):
            again = Manager(fol.data_dir, fsync_policy="always", **dev)
            assert triples(again.recover().stores["store-1"]) == oracle
            again.close()
    finally:
        ship.close()
        m.close()


# --------------------------------------------------------------- router

QUERIES = [
    'SELECT ?x WHERE { ?x <http://e/p> "alice" . ?x <http://e/q> 41 }',
    'SELECT ?x WHERE { ?x <http://e/p> "bob" .   ?x <http://e/q> 99 }',
    "SELECT ?y WHERE { ?y <http://e/r> ?z }",
    "PREFIX ub: <http://u#> SELECT ?x ?y WHERE { ?x ub:memberOf ?y . FILTER(?y > 3.5) }",
] + [f"SELECT ?s{i} WHERE {{ ?s{i} <http://e/p> ?o }}" for i in range(40)]


def test_router_keys_and_replica_order_match_reference():
    assert [port_key(q) for q in QUERIES] == [ref_key(q) for q in QUERIES]
    assert port_key(QUERIES[0]) == port_key(QUERIES[1]) != port_key(QUERIES[2])
    reps = [(f"r{i}", f"http://127.0.0.1:{9000 + i}") for i in range(5)]
    cores = [Core(reps, auto_promote=False) for Core in (RefCore, PortCore)]
    for core in cores:
        for rep in core.replicas.values():
            rep.healthy = True

    def orders():
        return [[[r.name for r in core.read_order(port_key(q))] for q in QUERIES]
                for core in cores]

    full = orders()
    assert full[1] == full[0]
    for core in cores:
        core.replicas["r2"].healthy = False
    evicted = orders()
    assert evicted[1] == evicted[0]
    # evicting a replica moves only the templates homed on it
    assert all(a[0] == b[0] or a[0] == "r2" for a, b in zip(full[1], evicted[1]))


def test_router_promotes_highest_durable_watermark(monkeypatch):
    from kolibrie_tpu_torch.replication import router as router_mod

    core = PortCore([("a", "http://127.0.0.1:1"), ("b", "http://127.0.0.1:2")],
                    auto_promote=False)
    for name, seg in (("a", 3), ("b", 5)):
        rep = core.replicas[name]
        rep.role, rep.healthy = "follower", True
        rep.watermark = {"applied_segment": seg, "applied_records": 10}
    asked = []

    class _Resp:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def read(self):
            return b'{"promoted": true}'

    def fake_urlopen(req, timeout=None):
        asked.append(req.full_url)
        return _Resp()

    monkeypatch.setattr(router_mod.urllib.request, "urlopen", fake_urlopen)
    winner = core.promote(list(core.replicas.values()))
    assert winner.name == "b" and asked == ["http://127.0.0.1:2/admin/promote"]
    assert core.replicas["b"].role == "primary" and core.promotions == 1


# ------------------------------------------------ a port fleet in process

NT = "".join(f'<http://e/m{i}> <http://e/knows> <http://e/m{(i * 7) % 30}> .\n' for i in range(30))
Q = "SELECT ?a ?c WHERE { ?a <http://e/knows> ?b . ?b <http://e/knows> ?c }"


def test_port_fleet_serves_replicates_and_promotes(tmp_path):
    from kolibrie_tpu_torch.frontends import http_server as hs
    from kolibrie_tpu_torch.obs import spans

    repl_port = free_port()
    prim = hs.make_server("127.0.0.1", 0, quiet=True, data_dir=str(tmp_path / "prim"),
                          recover_async=False, repl_port=repl_port, device="cpu")
    fol = hs.make_server("127.0.0.1", 0, quiet=True, data_dir=str(tmp_path / "fol"),
                         repl_source=f"127.0.0.1:{repl_port}", device="cpu")
    prim_base, fol_base = start(prim), start(fol)
    router, core = make_router([("prim", prim_base), ("fol", fol_base)],
                               probe_interval_s=3600.0, auto_promote=False)
    router_base = start(router)
    try:
        wait_ready(prim_base)
        wait_ready(fol_base)
        core.probe_once()
        assert core.primary().name == "prim"
        # a follower refuses writes with the primary's hint
        st, body, _ = post(fol_base, "/store/load", {"rdf": NT})
        assert st == 409 and body["code"] == "not_primary"
        spans.clear()
        st, load, headers = post(router_base, "/store/load",
                                 {"store_id": "kg", "rdf": NT, "mode": "device"},
                                 headers={"X-Kolibrie-Trace-Id": "fleet-trace-1"})
        assert st == 200 and headers["X-Kolibrie-Replica"] == "prim"
        assert headers["X-Kolibrie-Trace-Id"] == "fleet-trace-1"
        wait_applied(fol_base, load["watermark"]["segment"])
        want = post(prim_base, "/store/query", {"store_id": "kg", "sparql": Q})[1]["data"]
        st, got, _ = post(fol_base, "/store/query",
                          {"store_id": "kg", "sparql": Q, "min_watermark": load["watermark"]})
        assert st == 200 and got["data"] == want and len(want) == 30
        st, got, headers = post(router_base, "/store/query", {"store_id": "kg", "sparql": Q})
        assert st == 200 and got["data"] == want
        st, body, _ = post(fol_base, "/store/query", {"store_id": "kg", "sparql": Q,
                                                      "min_watermark": {"segment": 10_000}})
        assert st == 503 and body["phase"] == "catching_up"
        # a follower warms nothing until it is promoted
        warm = json.loads(get(fol_base, "/stats")[1])["compile_tail"]["prewarm"]
        assert warm["startup_replayed"] == 0 and warm["last_sweep"] == 0
        names = {s["name"] for s in spans.spans_snapshot("fleet-trace-1")}
        assert {"router.request", "router.forward", "http.request"} <= names
        _, text, _ = get(router_base, "/fleet/metrics")
        text = text.decode()
        for label in ('node="prim"', 'node="fol"', f'node="{core.node_id}"'):
            assert label in text
        assert "kolibrie_repl_applied_records" in text
        _, status, _ = get(router_base, "/fleet/status")
        nodes = json.loads(status)["nodes"]
        assert nodes["prim"]["role"] == "primary" and nodes["fol"]["role"] == "follower"
        # promotion, driven in process: the primary goes away, the
        # follower finalizes, and the promoted node takes writes
        hs.shutdown_gracefully(prim, timeout_s=5.0)
        st, promo, _ = post(fol_base, "/admin/promote", {})
        assert st == 200 and promo["promoted"] is True
        st, body, _ = post(fol_base, "/store/load", {
            "store_id": "kg", "rdf": "<http://e/m0> <http://e/knows> <http://e/new> .\n"})
        assert st == 200 and body["triples"] == 31 and body["watermark"]["segment"] >= 1
        st, got, _ = post(fol_base, "/store/query", {"store_id": "kg", "sparql": Q})
        assert st == 200 and len(got["data"]) == 31
        assert json.loads(get(fol_base, "/healthz")[1])["role"] == "primary"
    finally:
        core.stop()
        router.shutdown()
        hs.shutdown_gracefully(fol, timeout_s=5.0)
        for httpd in (prim, fol):
            httpd.server_close()


def test_healthz_watermark_single_process(tmp_path):
    from kolibrie_tpu_torch.frontends import http_server as hs

    httpd = hs.make_server("127.0.0.1", 0, quiet=True, data_dir=str(tmp_path / "data"),
                           recover_async=False, device="cpu")
    base = start(httpd)
    try:
        st, load, _ = post(base, "/store/load", {"store_id": "store-1", "mode": "host",
                                                 "rdf": '<http://e/a> <http://e/p> "1" .'})
        assert st == 200 and load["watermark"]["segment"] >= 1
        hz = json.loads(get(base, "/healthz")[1])
        assert hz["role"] == "primary" and list(hz["watermark"]["stores"]) == ["store-1"]
        assert hz["watermark"]["durable_wal"]["offset"] > 0
    finally:
        hs.shutdown_gracefully(httpd, timeout_s=5.0)
    # the data dir recovers in a fresh server, on the device it is given
    again = hs.make_server("127.0.0.1", 0, quiet=True, data_dir=str(tmp_path / "data"),
                           recover_async=False, device="cpu")
    base = start(again)
    try:
        st, got, _ = post(base, "/store/query", {"store_id": "store-1",
                                                 "sparql": "SELECT ?s ?o WHERE { ?s <http://e/p> ?o }"})
        assert st == 200 and got["data"] == [["http://e/a", "1"]]
    finally:
        hs.shutdown_gracefully(again, timeout_s=5.0)


def test_chip_smoke_phase15_rehearsal(monkeypatch):
    """``chip_smoke.py``'s phase 15 on the CPU at LUBM-2 and 600 employees:
    recovery behind a durable server, the HTTP rows against phase 4's, the
    template burst batched, the observability routes, a follower behind
    the router, and a child-process primary SIGKILLed mid-ingest with the
    follower promoted (the launch counters stay 0 off the card)."""
    import torch

    import chip_smoke as CS
    from benches.lubm import LUBM_Q2, LUBM_Q9, generate_fast

    monkeypatch.setattr(CS, "EMPLOYEES", 600)
    cpu = torch.device("cpu")
    lubm = PortDatabase(device=cpu)
    lubm.store.add_batch(*generate_fast(2, lubm.dictionary))
    emp = PortDatabase(device=cpu)
    emp.parse_ntriples(CS.employee_ntriples(600))
    queries = [("employee", emp, CS.EMPLOYEE_QUERY, "auto"), ("q2", lubm, LUBM_Q2, "auto"),
               ("q9", lubm, LUBM_Q9, "auto"), ("q9_wcoj_off", lubm, LUBM_Q9, "off")]
    for _name, db, _q, _w in queries:
        db.execution_mode = "device"  # the device program, as the full-size stores take
    main_path = CS.run_main_path(cpu, queries)
    out = CS.run_serving_phase(cpu, main_path)
    report = out["report"]
    assert report["15a"]["recovery"]["stores"] == ["emp", "lubm"]
    assert report["15b"]["q9"]["rows"] == 1280
    burst = report["15b"]["burst"]
    assert burst["dispatches"] < burst["requests"] == CS.SERVE_VARIANTS
    assert report["15c"]["trace_spans"] >= 9
    assert report["15d"]["q9_follower_ms"]["warm"] > 0
    kill = report["15e"]
    assert kill["child_returncode"] == -9 and kill["confirmed"] > CS.SERVE_WRITES_CONFIRMED
    assert kill["present"] >= kill["confirmed"]
    assert not any(out["launches"].values())


def test_prewarm_replays_reads_only(tmp_path):
    """The prewarm manifest records every statement the executor ran; the
    warmer replays only read-only SELECTs, so a store never takes a
    statement nobody sent it.  The reference's warmer replays the INSERT
    DATA below into the target store."""
    from kolibrie_tpu_torch import execute_query_volcano
    from kolibrie_tpu_torch.query.prewarm import PrewarmManager

    scratch = PortDatabase(device="cpu")
    scratch.parse_ntriples("<http://e/a> <http://e/p> <http://e/b> .\n")
    execute_query_volcano('INSERT DATA { <http://e/warm-insert> <http://e/p> "x" }', scratch)
    execute_query_volcano("SELECT ?warmRead WHERE { ?warmRead <http://e/p> ?o }", scratch)
    target = PortDatabase(device="cpu")
    target.parse_ntriples("<http://e/c> <http://e/p> <http://e/d> .\n")
    results = PrewarmManager(lambda: [("t", target, None)], root=str(tmp_path)).run_once(top_n=256)
    by_query = {r["fp"]: r["targets"]["t"] for r in results}
    assert any(t.get("skipped") == "not a read-only SELECT" for t in by_query.values())
    assert any(t.get("rows") == 1 for t in by_query.values())
    assert triples(target) == [("http://e/c", "http://e/p", "http://e/d")]


def test_follower_refuses_a_diverged_dictionary(tmp_path):
    """A read that interns on a follower (an aggregate's numbers) moves its
    dictionary off its primary's.  The reference's replay then decodes the
    next shipped write to other terms; the port's replay refuses it, and
    the follower keeps what it had."""
    from kolibrie_tpu_torch import execute_query_volcano
    from kolibrie_tpu_torch.resilience.errors import DurabilityError

    m = PortManager(str(tmp_path / "primary"), fsync_policy="always", device="cpu")
    m.start()
    db = PortDatabase(device="cpu")
    m.attach("s", db)
    db.parse_ntriples("<http://e/a> <http://e/p> <http://e/b> .\n")
    ship = PortShip(m, seal_interval_s=0.0)
    fol = PortFollower(str(tmp_path / "follower"), ship.host, ship.port, device="cpu")
    try:
        fol.bootstrap()
        fol.poll_once()
        fdb = fol.res.stores["s"]
        assert execute_query_volcano(
            "SELECT (COUNT(?x) AS ?n) WHERE { ?x <http://e/p> ?y }", fdb) == [["1"]]
        before = triples(fdb)
        db.parse_ntriples('<http://e/c> <http://e/q> "late" .\n')
        with pytest.raises(DurabilityError, match="divergence"):
            fol.poll_once()
        assert triples(fdb) == before
    finally:
        fol.stop()
        ship.close()
        m.close()
