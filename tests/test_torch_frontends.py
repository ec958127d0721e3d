"""The port's HTTP server and CLI against the JAX package's, on the CPU.

Both packages' servers run in this process on ephemeral ports; the port's
serves on ``device="cpu"``.  Every request goes to both, in the same order,
and the JSON that comes back must be equal — result tables string for
string, error bodies, session and store ids — with wall times and trace ids
masked (``serving_pair.masked``), and EXPLAIN ANALYZE's device-time lines
dropped.  The CLI prints the same output for the cases of
``tests/test_frontends.py``.
"""

from __future__ import annotations

import json

import pytest

from kolibrie_tpu.frontends import http_server as ref_hs
from kolibrie_tpu.frontends.cli import main as ref_cli
from kolibrie_tpu.obs import log as ref_log
from kolibrie_tpu_torch.frontends import http_server as port_hs
from kolibrie_tpu_torch.frontends.cli import main as port_cli
from kolibrie_tpu_torch.obs import log as port_log
from jax_compile_cache import fresh_jax_compile_cache
from serving_pair import (
    get, join_all, key_shape, masked, post, prom_families, sse_first, start,
)
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

TTL = """
@prefix ex: <http://example.org/> .
ex:alice ex:knows ex:bob .
ex:bob ex:knows ex:carol .
"""
EX = "PREFIX ex: <http://example.org/> "
N3_REACH = ("@prefix ex: <http://example.org/> .\n"
            "{ ?a ex:knows ?b . ?b ex:knows ?c } => { ?a ex:reach ?c } .")
RSP_QUERY = (
    "REGISTER RSTREAM <out> AS SELECT * "
    "FROM NAMED WINDOW <w> ON <stream1> [RANGE 10 STEP 2] "
    "WHERE { WINDOW <w> { ?s ?p ?o } }"
)
STORE_NT = "".join(
    f"<http://e/n{i}> <http://e/p> <http://e/n{i + 1}> .\n"
    f'<http://e/n{i}> <http://e/v> "{i % 5}" .\n'
    for i in range(40)
)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """Both servers, with both packages' process-wide compile-cache and
    advisor state as a process that ran nothing else has it: an earlier
    module may have enabled the reference's compile cache (its durability
    tests do), which changes ``/stats`` and EXPLAIN's ``source``."""
    from kolibrie_tpu.optimizer import stats_advisor as ref_sa
    from kolibrie_tpu.query import compile_cache as ref_cc
    from kolibrie_tpu_torch.optimizer import stats_advisor as port_sa
    from kolibrie_tpu_torch.query import compile_cache as port_cc

    for lg in (ref_log, port_log):
        lg.set_quiet(True)
    for sa in (ref_sa, port_sa):
        sa.stats_advisor.reset()
    saved_port_dir = port_cc._active_dir
    with fresh_jax_compile_cache(tmp_path_factory.mktemp("jax_cache")):
        ref_cc._active_dir = port_cc._active_dir = None
        ref = ref_hs.make_server("127.0.0.1", 0, quiet=True)
        port = port_hs.make_server("127.0.0.1", 0, quiet=True, device="cpu")
        yield start(ref), start(port)
        for httpd in (ref, port):
            httpd.shutdown()
    port_cc._active_dir = saved_port_dir
    for lg in (ref_log, port_log):
        lg.set_quiet(False)


def plan_masked(body):
    """``masked`` with an EXPLAIN ANALYZE plan's device-time lines dropped."""
    body = masked(body)
    if isinstance(body, dict) and isinstance(body.get("plan"), str):
        body["plan"] = "\n".join(
            ln for ln in body["plan"].splitlines()
            if ln != "device time:" and not ln.startswith(("  device.", "  interp."))
        )
    return body


def both(servers, path, payload=None, raw=None):
    """POST to both servers; assert equal status and masked JSON; the
    port's body."""
    ref, port = servers
    (rs, rb, _), (ps, pb, _) = (post(b, path, payload, raw=raw) for b in (ref, port))
    assert (ps, plan_masked(pb)) == (rs, plan_masked(rb))
    return pb


QUERY_CASES = {
    "turtle": {"rdf": TTL, "format": "turtle",
               "sparql": EX + "SELECT ?a ?b WHERE { ?a ex:knows ?b }"},
    "n3logic_and_queries": {
        "rdf": TTL, "format": "turtle", "n3logic": N3_REACH,
        "queries": [EX + "SELECT ?c WHERE { ex:alice ex:reach ?c }",
                    EX + "SELECT ?b WHERE { ex:alice ex:knows ?b }"]},
    "legacy": {"rdf": TTL, "format": "turtle", "legacy": True,
               "sparql": EX + "SELECT ?b WHERE { ex:alice ex:knows ?b }"},
    "sparql_rule": {
        "rdf": TTL, "format": "turtle",
        "rule": EX + "RULE :Reach :- CONSTRUCT { ?a ex:reach2 ?c . } "
                     "WHERE { ?a ex:knows ?b . ?b ex:knows ?c . }",
        "sparql": EX + "SELECT ?a ?c WHERE { ?a ex:reach2 ?c }"},
    "ntriples_filter": {"rdf": STORE_NT, "format": "ntriples",
                        "sparql": 'SELECT ?s ?v WHERE { ?s <http://e/v> ?v . FILTER(?v > "2") }'},
    "no_queries": {"rdf": TTL},
    "bad_rdf": {"rdf": "<not rdf", "format": "ntriples", "sparql": "SELECT ?s WHERE { ?s ?p ?o }"},
    "bad_query": {"rdf": TTL, "format": "turtle", "sparql": "SELECT WHERE {"},
}


@pytest.mark.parametrize("case", sorted(QUERY_CASES))
def test_query_route_matches_reference(servers, case):
    body = both(servers, "/query", QUERY_CASES[case])
    if case == "n3logic_and_queries":
        assert [r["data"] for r in body["results"]] == [
            [["http://example.org/carol"]], [["http://example.org/bob"]]]


@pytest.mark.parametrize("path,raw", [
    ("/query", b"[]"), ("/query", b"{not json"), ("/nope", b"{}"),
    ("/store/load", b"[1]"), ("/rsp/register", b"{}"),
])
def test_error_bodies_match_reference(servers, path, raw):
    body = both(servers, path, raw=raw)
    assert body["code"] in ("bad_request", "not_found")


def test_store_routes_match_reference(servers):
    body = both(servers, "/store/load", {"store_id": "kg", "rdf": STORE_NT, "mode": "device"})
    assert body["triples"] == 80
    two_hop = "SELECT ?x ?z WHERE { ?x <http://e/p> ?y . ?y <http://e/p> ?z }"
    rows = both(servers, "/store/query", {"store_id": "kg", "sparql": two_hop})["data"]
    assert len(rows) == 39
    both(servers, "/store/query", {"store_id": "kg",
                                   "sparql": 'SELECT ?s WHERE { ?s <http://e/v> "3" }'})
    analyzed = both(servers, "/store/query?explain=analyze", {"store_id": "kg", "sparql": two_hop})
    assert analyzed["explain"] and analyzed["data"] == rows
    both(servers, "/store/query?explain=bogus", {"store_id": "kg", "sparql": two_hop})
    both(servers, "/store/query", {"store_id": "missing", "sparql": two_hop})
    both(servers, "/store/query", {"store_id": "kg"})
    both(servers, "/debug/explain", {"store_id": "kg", "sparql": two_hop})
    both(servers, "/debug/explain", {"rdf": TTL, "format": "turtle",
                                     "sparql": EX + "SELECT ?a WHERE { ?a ex:knows ?b }"})
    both(servers, "/store/load", {"rdf": "<http://e/x> <http://e/p> <http://e/y> .\n"})
    ref, port = servers
    # a store's (base_version, delta_epoch) numbers count every store the
    # process built: equal keys, not equal numbers
    healthz = [key_shape(json.loads(get(b, "/healthz")[1])) for b in (ref, port)]
    assert healthz[1] == healthz[0] and "kg" in healthz[1]["watermark"]["stores"]


@pytest.mark.parametrize("sparql", [
    "SELECT ?a ?c WHERE { ?a ex:knows ?b . ?b ex:knows ?c }",
    "SELECT ?a ?b ?c WHERE { ?a ex:knows ?b OPTIONAL { ?b ex:knows ?c } "
    "MINUS { ?a ex:knows ex:carol } }",
])
def test_explain_route_matches_reference(servers, sparql):
    body = both(servers, "/explain", {"rdf": TTL, "format": "turtle", "sparql": EX + sparql})
    assert "scan[" in body["plan"]


def test_rsp_routes_match_reference(servers):
    ref, port = servers
    events = [
        {"stream": "stream1", "timestamp": ts,
         "ntriples": f"<http://e/s{ts}> <http://e/p> <http://e/o{ts}> ."}
        for ts in range(1, 7)
    ]
    replay = both(servers, "/rsp-query", {"query": RSP_QUERY, "events": events})
    assert replay["total_results"] >= 1
    both(servers, "/rsp-query", {"query": "REGISTER nonsense"})
    reg = both(servers, "/rsp/register", {"query": RSP_QUERY})
    sid = reg["session_id"]
    for ev in events[:2]:
        both(servers, "/rsp/push", dict(ev, session_id=sid))
    snap = both(servers, "/rsp/checkpoint", {"session_id": sid})
    for ev in events[2:]:
        both(servers, "/rsp/push", dict(ev, session_id=sid))
    assert sse_first(port, sid) == sse_first(ref, sid)
    results = [json.loads(get(b, f"/rsp/results/{sid}")[1]) for b in (ref, port)]
    assert results[1] == results[0] and results[1]["results"]
    restored = both(servers, "/rsp/restore", snap)
    assert restored["session_id"] != sid
    for ev in events[2:]:
        both(servers, "/rsp/push", dict(ev, session_id=restored["session_id"]))
    assert sse_first(port, restored["session_id"]) == sse_first(ref, restored["session_id"])
    both(servers, "/rsp/push", {"session_id": "999999", "stream": "s", "timestamp": 1,
                                "ntriples": ""})
    both(servers, "/rsp/restore", {"register": {"query": RSP_QUERY}, "state": "!!"})


def test_debug_and_admin_routes_match_reference(servers):
    both(servers, "/debug/bundle", {})          # no data_dir: a 400
    both(servers, "/debug/profile?seconds=0.01", {})
    both(servers, "/debug/profile?seconds=99", {})
    both(servers, "/admin/promote", {})         # a primary is not promoted
    ref, port = servers
    # the manifest is process-wide, so what else ran decides its templates;
    # and the reference's warmer replays statements too, changing its
    # stores (ROADMAP queue 3): the same shape, not the same rows
    (rs, rb, _), (ps, pb, _) = (post(b, "/debug/prewarm", {}) for b in (ref, port))
    assert ps == rs == 200 and key_shape(pb) == key_shape(rb)
    for w in pb["warmed"]:
        for t in w["targets"].values():
            assert t.get("skipped") == "not a read-only SELECT" or "rows" in t, t
    for path in ("/", "/debug/timeline?n=bogus", "/nope"):
        (rs, rb, _), (ps, pb, _) = get(ref, path), get(port, path)
        assert ps == rs
        assert (pb if path == "/" else masked(json.loads(pb))) == (
            rb if path == "/" else masked(json.loads(rb)))


def test_stats_keys_and_metric_families_match_reference(servers, mesh8, monkeypatch):
    ref, port = servers
    both(servers, "/store/load", {"store_id": "st", "rdf": STORE_NT})
    both(servers, "/store/query", {"store_id": "st",
                                   "sparql": "SELECT ?s ?o WHERE { ?s <http://e/v> ?o }"})
    stats = [json.loads(get(b, "/stats")[1]) for b in (ref, port)]
    assert key_shape(stats[1]) == key_shape(stats[0])
    # a store with the mesh serving layer: the reference attaches on its 8
    # devices under KOLIBRIE_SHARDED, the port to an 8-shard CPU mesh
    # given to its server
    import torch

    from kolibrie_tpu_torch.parallel import make_mesh

    monkeypatch.setattr(ref_hs, "SHARDED_SERVING", True)
    meshed = port_hs.make_server("127.0.0.1", 0, quiet=True, device="cpu",
                                 mesh=make_mesh(8, devices=[torch.device("cpu")] * 8))
    try:
        pair = (ref, start(meshed))
        for b in pair:
            post(b, "/store/load", {"store_id": "sh", "rdf": STORE_NT, "mode": "host"})
        stats = [json.loads(get(b, "/stats")[1])["stores"]["sh"] for b in pair]
        assert "sharding" in stats[0]
        assert key_shape(stats[1]) == key_shape(stats[0])
        for key in ("shards", "signature", "base_cap", "delta_cap", "occupancy", "imbalance",
                    "base_rebuilds", "delta_refreshes"):
            assert stats[1]["sharding"][key] == stats[0]["sharding"][key], key
        # other test modules in this process may have imported more of
        # either package, so both sides import their counterparts of what
        # the other has loaded first
        import importlib
        import sys

        for name in list(sys.modules):
            if name.startswith("kolibrie_tpu."):
                try:
                    importlib.import_module("kolibrie_tpu_torch" + name[len("kolibrie_tpu"):])
                except ImportError:
                    pass
        for name in list(sys.modules):
            if name.startswith("kolibrie_tpu_torch."):
                try:
                    importlib.import_module("kolibrie_tpu" + name[len("kolibrie_tpu_torch"):])
                except ImportError:
                    pass
        ref_fams, port_fams = (prom_families(get(b, "/metrics")[1].decode()) for b in pair)
        assert port_fams == ref_fams
        mesh = {f for f in ref_fams if f.startswith(("kolibrie_shard_", "kolibrie_store_shard"))}
        assert {"kolibrie_shard_dispatch_total", "kolibrie_shard_attach_errors_total",
                "kolibrie_store_shards", "kolibrie_store_shard_imbalance"} <= mesh
        assert "kolibrie_http_requests_total" in port_fams
    finally:
        meshed.shutdown()


def test_make_server_needs_a_device_and_refuses_sharded(monkeypatch):
    """No card and no device: it raises.  ``KOLIBRIE_SHARDED`` on a
    ``device="cpu"`` server is a one-device runtime, so the store stays
    single-device, as the reference's does on one device."""
    with pytest.raises(RuntimeError, match="CUDA"):
        port_hs.make_server("127.0.0.1", 0, quiet=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_hs.serve("127.0.0.1", 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_cli(["--serve", "--port", "0"])
    monkeypatch.setattr(port_hs, "SHARDED_SERVING", True)
    httpd = port_hs.make_server("127.0.0.1", 0, quiet=True, device="cpu")
    base = start(httpd)
    try:
        st, body, _ = post(base, "/store/load", {"store_id": "one", "rdf": STORE_NT})
        assert st == 200
        stats = json.loads(get(base, "/stats")[1])["stores"]["one"]
        assert "sharding" not in stats
        got = post(base, "/store/query", {"store_id": "one",
                                          "sparql": "SELECT ?s ?o WHERE { ?s <http://e/v> ?o }"})
        assert got[0] == 200 and len(got[1]["data"]) == 40
    finally:
        httpd.shutdown()


def test_make_server_with_a_mesh_serves_sharded():
    """A mesh given to the server attaches the sharded serving layer to
    every store it holds: a template group rides one mesh dispatch and
    answers as the single-device path does."""
    import threading

    import torch

    from kolibrie_tpu_torch.parallel import make_mesh

    httpd = port_hs.make_server("127.0.0.1", 0, quiet=True, device="cpu",
                                mesh=make_mesh(4, devices=[torch.device("cpu")] * 4))
    base = start(httpd)
    try:
        post(base, "/store/load", {"store_id": "m", "rdf": STORE_NT, "mode": "device"})
        texts = [f"SELECT ?o WHERE {{ <http://e/n{i}> <http://e/p> ?o }}" for i in range(8)]
        answers = {}
        threads = [threading.Thread(target=lambda i=i: answers.__setitem__(
            i, post(base, "/store/query", {"store_id": "m", "sparql": texts[i]})[1]))
            for i in range(len(texts))]
        for th in threads:
            th.start()
        join_all(threads)
        for i in range(len(texts)):
            assert answers[i]["data"] == [[f"http://e/n{i + 1}"]]
        sharding = json.loads(get(base, "/stats")[1])["stores"]["m"]["sharding"]
        assert sharding["shards"] == 4 and sum(sharding["occupancy"]) == 80
        assert sharding["fallbacks"] == 0
    finally:
        httpd.shutdown()


def cli_pair(tmp_path, capsys, args):
    data = tmp_path / "data.ttl"
    data.write_text(TTL)
    rules = tmp_path / "rules.n3"
    rules.write_text(N3_REACH)
    args = [a.replace("DATA", str(data)).replace("RULES", str(rules)) for a in args]
    assert ref_cli(args) == 0
    want = capsys.readouterr().out
    assert port_cli(args + ["--device", "cpu"]) == 0
    return want, capsys.readouterr().out


@pytest.mark.parametrize("args", [
    ["--file", "DATA", "--query", EX + "SELECT ?a WHERE { ?a ex:knows ex:bob }"],
    ["--file", "DATA", "--export", "rdfxml"],
    ["--file", "DATA", "--export", "ntriples"],
    ["--file", "DATA", "--n3logic", "RULES",
     "--query", EX + "SELECT ?c WHERE { ex:alice ex:reach ?c }"],
    ["--file", "DATA", "--explain",
     "--query", EX + "SELECT ?a ?c WHERE { ?a ex:knows ?b . ?b ex:knows ?c }"],
    ["--file", "DATA", "--legacy", "--query", EX + "SELECT ?a ?b WHERE { ?a ex:knows ?b }"],
])
def test_cli_prints_what_the_reference_prints(tmp_path, capsys, args):
    want, got = cli_pair(tmp_path, capsys, args)
    assert got == want and got


def test_server_takes_a_burst_of_clients():
    """64 clients connecting at once all get an answer: the port's listen
    backlog holds the burst (socketserver's default of 5 reset the
    connections past it on a loaded host)."""
    import threading

    from kolibrie_tpu_torch.replication.router import make_router

    httpd = port_hs.make_server("127.0.0.1", 0, quiet=True, device="cpu")
    base = start(httpd)
    router, core = make_router([("only", base)], quiet=True, probe_interval_s=3600.0,
                               auto_promote=False)
    router_base = start(router)
    try:
        core.probe_once()
        for target in (base, router_base):
            gate, codes, errors = threading.Barrier(64), [], []

            def client():
                gate.wait(timeout=60)
                try:
                    codes.append(post(target, "/store/query", {"store_id": "none",
                                                               "sparql": "SELECT * {}"})[0])
                except OSError as e:
                    errors.append(repr(e))

            threads = [threading.Thread(target=client) for _ in range(64)]
            for t in threads:
                t.start()
            join_all(threads)
            assert not errors and codes == [404] * 64, (target, errors[:2])
    finally:
        core.stop()
        router.shutdown()
        httpd.shutdown()
