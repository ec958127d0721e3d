"""The port's ``obs/`` (structured log, flight recorder, Prometheus text and
fleet merge, timeline ring, span export, collectors) and
``analysis/lockcheck.py`` against the JAX package's, on the CPU, plus the
port server's observability routes.

The unit cases of ``tests/test_fleet_obs.py`` run on both packages
(``pkg`` is "ref" or "port") and the two must agree.  The HTTP cases run
on a port server with ``device="cpu"``; each clears the span ring and uses
a store and query text of its own, so no case depends on which test
modules ran before it in the process.
"""

from __future__ import annotations

import importlib
import json
import os
import re
import threading

import pytest

from serving_pair import get, post, start

PKGS = {"ref": "kolibrie_tpu", "port": "kolibrie_tpu_torch"}


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


@pytest.fixture(autouse=True)
def _quiet_logs():
    logs = [mod(p, "obs.log") for p in PKGS]
    for lg in logs:
        lg.set_quiet(True)
        lg.clear()
    yield
    for lg in logs:
        lg.set_quiet(False)
        lg.clear()


both_packages = pytest.mark.parametrize("pkg", sorted(PKGS))


# ------------------------------------------------------- structured logging


def log_records(pkg):
    """A fixed sequence of log calls; the records without their times."""
    obslog, spans = mod(pkg, "obs.log"), mod(pkg, "obs.spans")
    role = obslog.get_role()  # process-wide: a server built earlier set it
    obslog.set_role("primary")
    try:
        return _log_sequence(obslog, spans)
    finally:
        obslog.set_role(role)


def _log_sequence(obslog, spans):
    lg = obslog.get_logger("unit")
    assert obslog.get_logger("unit") is lg
    lg.info("hello", key=7)
    with spans.trace_scope("t-1"):
        lg.warn("inside")
    obslog.set_min_level("warn")
    try:
        lg.info("dropped")
        lg.error("kept", n=[1, 2])
    finally:
        obslog.set_min_level("info")
    recs = [json.loads(ln) for ln in obslog.export_jsonl().splitlines() if ln.strip()]
    assert recs == obslog.tail()
    assert [r["msg"] for r in obslog.tail(level="error", component="unit")] == ["kept"]
    for r in recs:
        assert isinstance(r.pop("ts"), float)
    return recs


def test_log_records_match_reference():
    got, want = log_records("port"), log_records("ref")
    assert got == want
    assert [r["msg"] for r in got] == ["hello", "inside", "kept"]
    assert "trace_id" not in got[0] and got[1]["trace_id"] == "t-1"
    assert {r["role"] for r in got} == {"primary"}


# -------------------------------------------------------- flight recorder


@both_packages
def test_flightrec_dump_and_read_bundle_roundtrip(pkg, tmp_path):
    obslog, flightrec, spans = (mod(pkg, n) for n in ("obs.log", "obs.flightrec", "obs.spans"))
    obslog.get_logger("unit").info("pre-crash narrative")
    with spans.trace_scope(None):
        pass
    path = flightrec.dump(str(tmp_path), "manual", stats_fn=lambda: {"stores": {}})
    assert os.path.basename(os.path.dirname(path)) == "postmortem"
    bundle = flightrec.read_bundle(path)
    assert bundle["manifest"]["reason"] == "manual"
    assert bundle["manifest"]["pid"] == os.getpid()
    assert sorted(bundle["manifest"]["artifacts"]) == [
        "config.json", "log_tail.jsonl", "spans.jsonl", "stats.json", "timeline.json"]
    assert bundle["stats"] == {"stores": {}}
    assert any(r.get("msg") == "pre-crash narrative" for r in bundle["log_tail"])
    assert isinstance(bundle["config"]["argv"], list)
    assert not [n for n in os.listdir(flightrec.postmortem_dir(str(tmp_path)))
                if n.startswith(".")]


@both_packages
def test_flightrec_degrades_and_never_raises(pkg, tmp_path):
    obslog, flightrec = mod(pkg, "obs.log"), mod(pkg, "obs.flightrec")

    def broken():
        raise RuntimeError("stats surface is on fire")

    bundle = flightrec.read_bundle(flightrec.dump(str(tmp_path), "manual", stats_fn=broken))
    assert "RuntimeError" in bundle["stats"]["error"]
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("x")
    assert flightrec.try_dump(str(blocker / "sub"), "manual") is None
    errs = obslog.tail(level="error", component="flightrec")
    assert errs and errs[-1]["msg"] == "postmortem dump failed"


@both_packages
def test_flightrec_blackbox_and_recorder_thread(pkg, tmp_path):
    flightrec = mod(pkg, "obs.flightrec")
    rec = flightrec.FlightRecorder(str(tmp_path / "a"), interval_s=3600.0)
    box = rec.checkpoint()
    assert box == rec.blackbox_path
    assert flightrec.read_bundle(box)["manifest"]["reason"] == "checkpoint"
    rec.checkpoint()
    assert rec.checkpoints == 2
    terminal = flightrec.dump(str(tmp_path / "a"), "sigterm")
    paths = flightrec.list_bundles(str(tmp_path / "a"))
    assert paths[-1] == box and terminal in paths
    rolling = flightrec.FlightRecorder(str(tmp_path / "b"), interval_s=0.05)
    rolling.start()
    try:
        for _ in range(50):
            if rolling.checkpoints >= 2:
                break
            threading.Event().wait(0.05)
    finally:
        rolling.stop()
    assert rolling.checkpoints >= 2
    assert flightrec.read_bundle(rolling.blackbox_path)["manifest"]["pid"] == os.getpid()


def test_flightrec_config_keeps_the_reference_env_prefixes(monkeypatch):
    monkeypatch.setenv("KOLIBRIE_PROBE_VAR", "1")
    monkeypatch.setenv("JAX_PROBE_VAR", "2")
    snaps = [mod(p, "obs.flightrec")._config_snapshot()["env"] for p in ("ref", "port")]
    assert snaps[1] == snaps[0]
    assert snaps[1]["KOLIBRIE_PROBE_VAR"] == "1" and snaps[1]["JAX_PROBE_VAR"] == "2"


# -------------------------------------------- Prometheus text and fleet merge

NODE_A = "\n".join([
    "# HELP reqs_total requests", "# TYPE reqs_total counter",
    'reqs_total{route="/query"} 5', "# HELP up node liveness", "# TYPE up gauge", "up 1",
]) + "\n"
NODE_B = "\n".join([
    "# HELP reqs_total requests (other wording)", "# TYPE reqs_total counter",
    'reqs_total{shard="0",zone="z1"} 9', "# HELP only_b unique family",
    "# TYPE only_b gauge", "only_b 3",
]) + "\n"
HIST = "\n".join([
    "# HELP lat_seconds latency", "# TYPE lat_seconds histogram",
    'lat_seconds_bucket{le="0.1"} 2', 'lat_seconds_bucket{le="+Inf"} 3',
    "lat_seconds_sum 0.4", "lat_seconds_count 3",
]) + "\n"


@pytest.mark.parametrize("nodes", [
    {"a": NODE_A, "b": NODE_B}, {"n1": HIST}, {"n": "!!! not exposition\nok_total 1\n"},
])
def test_merge_prometheus_matches_reference(nodes):
    got, want = (mod(p, "obs.promtext").merge_prometheus(nodes) for p in ("port", "ref"))
    assert got == want
    lines = got.splitlines()
    assert "!!!" not in got
    type_lines = [ln for ln in lines if ln.startswith("# TYPE ")]
    assert len(type_lines) == len(set(type_lines))


def registry_story(pkg):
    """The same metric operations on a private registry of each package:
    its Prometheus text, snapshot, and timeline series."""
    metrics, promtext, timeseries = (
        mod(pkg, n) for n in ("obs.metrics", "obs.promtext", "obs.timeseries"))
    reg = metrics.Registry()
    c = reg.counter("t_requests_total", "requests", labels=("route",))
    g = reg.gauge("t_depth", "depth")
    h = reg.histogram("t_latency_seconds", "latency")
    seen = []
    reg.register_collector(lambda: seen.append(1))
    reg.register_collector(seen.clear)
    ring = timeseries.TimeSeriesRing(capacity=4, registry=reg)
    for step in range(6):
        c.labels("/q" if step % 2 else '/we"ird\\').inc(step + 1)
        g.set(step * 1.5)
        h.observe(0.001 * (step + 1) ** 3)
        ring.record(now=1000.0 + step)
    reg.run_collectors()
    text = promtext.render_prometheus(reg)
    return text, reg.snapshot(), ring.series(), ring.series(metric="t_depth", n=2), len(ring)


def test_registry_text_snapshot_and_timeline_match_reference():
    got, want = registry_story("port"), registry_story("ref")
    assert got == want
    text, _snap, series, narrowed, n = got
    assert n == 4 and series["samples"] == 4
    assert list(narrowed["metrics"]) == ["t_depth"] and narrowed["samples"] == 2
    for line in text.splitlines():
        assert line.startswith("# ") or re.fullmatch(
            r'[a-zA-Z_:][\w:]*(\{[^}]*\})? [-+0-9.eEInfa]+', line), line


@both_packages
def test_span_export_and_ring_capacity(pkg):
    spans = mod(pkg, "obs.spans")
    spans.clear()
    try:
        spans.set_ring_capacity(3)
        with spans.trace_scope("exp-1"):
            for i in range(5):
                with spans.span("unit.step", i=i):
                    pass
        lines = [json.loads(ln) for ln in spans.export_jsonl("exp-1").splitlines()]
        assert [s["attrs"]["i"] for s in lines] == [2, 3, 4]
        assert spans.export_jsonl("other") == ""
    finally:
        spans.set_ring_capacity(4096)
        spans.clear()


# ------------------------------------------------------- lock sanitizer


def test_lockcheck_reports_unlocked_access(monkeypatch):
    from kolibrie_tpu_torch.analysis import lockcheck

    assert lockcheck.selftest()
    lockcheck.reset()

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self.items = []  # guarded by: _lock (rw)
            self.n = 0  # guarded by: _lock

    monkeypatch.delenv("KOLIBRIE_DEBUG_LOCKS", raising=False)
    lockcheck.auto_instrument({"__name__": __name__, "Box": Box})
    assert not isinstance(Box.__dict__.get("n"), lockcheck.GuardedAttribute)
    monkeypatch.setenv("KOLIBRIE_DEBUG_LOCKS", "1")
    Box.__module__ = __name__
    lockcheck.auto_instrument({"__name__": __name__, "Box": Box})
    b = Box()
    with b._lock:
        b.n = 1
        b.items.append(1)
    assert lockcheck.reports() == []
    b.n = 2
    _ = b.items
    assert {(r["attr"], r["event"]) for r in lockcheck.reports()} == {("n", "write"),
                                                                      ("items", "read")}
    lockcheck.reset()


def test_lockcheck_is_installed_where_the_reference_installs_it(monkeypatch):
    """Under ``KOLIBRIE_DEBUG_LOCKS=1`` the annotated classes of the port's
    RSP engine, prewarm, timeline, flight recorder and replication modules
    are instrumented at import, as the reference's are."""
    import subprocess
    import sys

    code = (
        "import kolibrie_tpu_torch.rsp.engine as e, kolibrie_tpu_torch.query.prewarm as p\n"
        "import kolibrie_tpu_torch.obs.timeseries as t, kolibrie_tpu_torch.obs.flightrec as f\n"
        "import kolibrie_tpu_torch.replication.follower as fo, "
        "kolibrie_tpu_torch.replication.router as r\n"
        "from kolibrie_tpu_torch.analysis.lockcheck import GuardedAttribute as G\n"
        "for cls, attr in ((e.RSPEngine, '_fire_t0'), (p.PrewarmManager, 'last_results'),\n"
        "                  (t.TimeSeriesRing, '_samples'), (fo.ReplicationFollower, 'applied_segment')):\n"
        "    assert isinstance(cls.__dict__.get(attr), G), (cls, attr)\n"
        "print('instrumented')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, KOLIBRIE_DEBUG_LOCKS="1", PYTHONPATH=root, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env, cwd=root)
    assert out.returncode == 0 and "instrumented" in out.stdout, out.stderr


# ------------------------------------------- the port server's obs routes

NT = "\n".join(f'<http://e/{i}> <http://e/p> "{i}" .' for i in range(64))


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    from kolibrie_tpu_torch.frontends import http_server as hs
    from kolibrie_tpu_torch.obs import log as obslog

    obslog.set_quiet(True)
    httpd = hs.make_server("127.0.0.1", 0, quiet=True, device="cpu", recover_async=False,
                           data_dir=str(tmp_path_factory.mktemp("obs_server")))
    yield start(httpd)
    hs.shutdown_gracefully(httpd, timeout_s=5.0)
    obslog.set_quiet(False)


def test_trace_propagation_http_to_executor(server):
    from kolibrie_tpu_torch.obs import spans

    spans.clear()
    st, _, _ = post(server, "/store/load", {"store_id": "obs_chain", "rdf": NT,
                                            "format": "ntriples", "mode": "device"})
    assert st == 200
    st, out, headers = post(
        server, "/store/query",
        {"store_id": "obs_chain", "sparql": "SELECT ?chain_s ?chain_o WHERE { ?chain_s <http://e/p> ?chain_o }"},
        headers={"X-Kolibrie-Trace-Id": "trace-port-e2e"})
    assert st == 200 and headers.get("X-Kolibrie-Trace-Id") == "trace-port-e2e"
    assert len(out["data"]) == 64
    _, body, _ = get(server, "/debug/traces?trace_id=trace-port-e2e")
    recs = [json.loads(ln) for ln in body.decode().splitlines() if ln]
    assert recs and all(s["trace_id"] == "trace-port-e2e" for s in recs)
    assert {"http.request", "batcher.submit", "batcher.dispatch", "query.execute",
            "query.parse", "query.plan", "device.lower", "device.dispatch",
            "device.collect"} <= {s["name"] for s in recs}
    ids = {s["span_id"] for s in recs}
    assert all(s["parent_id"] in ids for s in recs if s["parent_id"] is not None)


def test_trace_ids_generated_and_carried_by_errors(server):
    _, _, headers = post(server, "/query", {"sparql": "SELECT ?s WHERE { ?s ?p ?o }", "rdf": "",
                                            "format": "ntriples"})
    assert re.fullmatch(r"[0-9a-f]{32}", headers.get("X-Kolibrie-Trace-Id", ""))
    st, body, _ = post(server, "/store/query", {"store_id": "missing", "sparql": "SELECT * {}"},
                       headers={"X-Kolibrie-Trace-Id": "trace-err-404"})
    assert st == 404 and body["trace_id"] == "trace-err-404"


def test_metrics_timeline_and_bundle_routes(server):
    from kolibrie_tpu_torch.obs import flightrec, timeseries

    ring = timeseries.default_ring()
    ring.record()
    post(server, "/store/load", {"store_id": "obs_m", "rdf": NT, "format": "ntriples"})
    post(server, "/store/query", {"store_id": "obs_m", "sparql": "SELECT ?s WHERE { ?s <http://e/p> ?o }"})
    ring.record()
    _, text, headers = get(server, "/metrics")
    text = text.decode()
    assert headers["Content-Type"].startswith("text/plain")
    assert 'kolibrie_batcher_queue_depth{store="obs_m"}' in text
    assert "kolibrie_device_compile_cache_entries" in text
    m = re.search(r'kolibrie_http_requests_total\{route="/store/query",code="200"\} (\d+)', text)
    assert m and int(m.group(1)) >= 1
    _, body, _ = get(server, "/debug/timeline?metric=kolibrie_http_requests_total&n=2")
    timeline = json.loads(body)
    assert list(timeline["metrics"]) == ["kolibrie_http_requests_total"]
    assert timeline["samples"] == 2 and timeline["capacity"] == ring.capacity
    st, out, _ = post(server, "/debug/bundle", {})
    assert st == 200
    bundle = flightrec.read_bundle(out["path"])
    assert bundle["manifest"]["reason"] == "manual" and "obs_m" in bundle["stats"]["stores"]


def test_debug_profile_forced_on_cpu(server, monkeypatch, tmp_path):
    st, out, _ = post(server, "/debug/profile?seconds=0.01", {})
    assert st == 200 and out["profiled"] is False and out["backend"] == "cpu"
    monkeypatch.setenv("KOLIBRIE_PROFILE_FORCE", "1")
    monkeypatch.setenv("KOLIBRIE_PROFILE_DIR", str(tmp_path))
    st, out, _ = post(server, "/debug/profile?seconds=0.05", {})
    assert st == 200 and out["profiled"] is True and out["forced"] is True
    assert out["backend"] == "cpu" and out["trace_files"] >= 1
    with open(os.path.join(out["trace_dir"], "trace.json")) as fh:
        assert "traceEvents" in json.load(fh)
