"""The PyTorch port stands alone: it imports neither ``jax`` nor any module
of the JAX package, and it never runs on the CPU unless asked to.

The checks run in fresh interpreters (this test process has JAX loaded by
``conftest.py``) with ``CUDA_VISIBLE_DEVICES`` emptied, so they behave the
same on a machine with a card.
"""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from test_torch_clauses import port_device_program  # noqa: F401  (a fixture)

REPO = Path(__file__).resolve().parent.parent

GUARD = r"""
import sys
import kolibrie_tpu_torch as port

db = port.SparqlDatabase(device="cpu")
db.parse_ntriples(
    "<http://e/a> <http://e/knows> <http://e/b> .\n"
    "<http://e/b> <http://e/knows> <http://e/c> .\n"
    "<http://e/a> <http://e/age> \"30\" .\n"
)
rows = port.execute_query_volcano(
    "SELECT ?x ?y ?g WHERE { ?x <http://e/knows> ?y . ?x <http://e/age> ?g }", db
)
assert rows == [["http://e/a", "http://e/b", "30"]], rows
rows = port.execute_query_volcano(
    "SELECT ?x ?y ?g ?h WHERE { ?x <http://e/knows> ?y "
    "{ ?x <http://e/age> ?g } UNION { ?x <http://e/knows> ?g } "
    "OPTIONAL { ?x <http://e/age> ?h } MINUS { ?y <http://e/knows> ?z } }", db
)
assert rows == [["http://e/b", "http://e/c", "http://e/c", ""]], rows
rows = port.execute_query_volcano(
    "SELECT ?x (COUNT(?y) AS ?n) WHERE { ?x <http://e/knows> ?y } GROUP BY ?x", db
)
assert rows == [["http://e/a", "1"], ["http://e/b", "1"]], rows
rows = port.execute_query_volcano(
    "SELECT ?x ?y WHERE { ?x <http://e/knows> ?y } ORDER BY DESC(?y) LIMIT 1", db
)
assert rows == [["http://e/b", "http://e/c"]], rows
rows = port.execute_query(
    "SELECT ?x ?y ?g WHERE { ?x <http://e/knows> ?y . ?z <http://e/age> ?g }", db
)
assert rows == [["http://e/a", "http://e/b", "30"], ["http://e/b", "http://e/c", "30"]], rows
assert port.execute_query_volcano(
    "INSERT DATA { <http://e/c> <http://e/knows> <http://e/d> }", db) == []
assert port.execute_query_volcano(
    "RULE :Reach :- CONSTRUCT { ?x <http://e/reach> ?z . } "
    "WHERE { ?x <http://e/knows> ?y . ?y <http://e/knows> ?z . }", db) == []
rows = port.execute_query_volcano("SELECT ?x ?z WHERE { ?x <http://e/reach> ?z }", db)
assert rows == [["http://e/a", "http://e/c"], ["http://e/b", "http://e/d"]], rows
r = port.Reasoner(device="cpu")
for i in range(6):
    r.add_abox_triple(f"n{i}", "next", f"n{i + 1}")
r.add_rule(r.rule_from_strings(
    [("?x", "next", "?y"), ("?y", "next", "?z")], [("?x", "next", "?z")]))
r.add_rule(r.rule_from_strings([("?x", "next", "?y")], [("?y", "prev", "?x")]))
assert r.infer_new_facts_device() == 15 + 21, len(r)
out = []
engine = (
    port.RSPBuilder(
        "PREFIX ex: <http://e/> REGISTER RSTREAM <http://o> AS SELECT ?a ?c "
        "FROM NAMED WINDOW <http://e/w> ON <http://e/s> [RANGE 4 STEP 2] "
        "WHERE { WINDOW <http://e/w> { ?a ex:reach ?c } }",
        device="cpu",
    )
    .add_rules("@prefix ex: <http://e/> . { ?a ex:knows ?b . ?b ex:knows ?c . } "
               "=> { ?a ex:reach ?c . } .")
    .with_consumer(out.append)
    .build()
)
for ts in range(1, 6):
    engine.add_to_stream("http://e/s", port.WindowTriple(
        f"<http://e/p{ts}>", "<http://e/knows>", f"<http://e/p{ts + 1}>"), ts)
assert out and engine.r2r._device_ok and not engine.dead_letters, out
import kolibrie_tpu_torch.native
import kolibrie_tpu_torch.native.sdd_native
from kolibrie_tpu_torch.reasoner import (
    ReasoningHierarchy, backward, device_provenance, diff_sdd, hierarchy, provenance,
    provenance_seminaive, repairs, sdd, sdd_seed, seed_spec, tag_store, to_dot,
)
t = port.Reasoner(device="cpu")
for i in range(6):
    t.add_tagged_triple(f"n{i}", "next", f"n{i + 1}", 0.9 - 0.1 * i)
t.add_rule(t.rule_from_strings(
    [("?x", "next", "?y"), ("?y", "next", "?z")], [("?x", "next", "?z")]))
for name in ("minmax", "addmult"):
    tt = t.clone()
    prov = provenance.make_provenance(name)
    store = provenance_seminaive.seed_tag_store(tt, prov)
    assert device_provenance.infer_provenance_device(tt, prov, store) == {}
    assert len(store) == 21, len(store)
assert len(t.clone().infer_new_facts_with_provenance(sdd.SddProvenance())) == 21
db.probability_seeds = {k: 0.5 for k in db.store.triples_set()}
assert port.execute_query_volcano(
    "RULE :P PROB(combination=independent) :- CONSTRUCT { ?x <http://e/r2> ?z . } "
    "WHERE { ?x <http://e/knows> ?y . ?y <http://e/knows> ?z . }", db) == []
rows = port.execute_query_volcano(
    "SELECT ?x ?v WHERE { << ?x <http://e/r2> ?z >> <http://kolibrie.tpu/prob#value> ?v }", db)
assert sorted(rows) == [["http://e/a", "0.25"], ["http://e/b", "0.25"]], rows
import kolibrie_tpu_torch.ml.handler
import kolibrie_tpu_torch.ml.mlschema
from kolibrie_tpu_torch.ml.mlp import MlpNeuralPredicate
from kolibrie_tpu_torch.parallel import train_step
ml = port.SparqlDatabase(device="cpu")
ml.parse_ntriples("".join(
    f'<http://e/m{i}> <http://e/t> "{50 + 30 * (i % 2)}" .\n'
    f'<http://e/m{i}> <http://e/hot> "{"true" if i % 2 else "false"}" .\n' for i in range(8)))
assert port.execute_query_volcano(
    'PREFIX e: <http://e/> MODEL "h" { ARCH MLP { HIDDEN [4] } OUTPUT BINARY } '
    'NEURAL RELATION e:isHot USING MODEL "h" { INPUT { ?m e:t ?t . } FEATURES { ?t } } '
    'TRAIN NEURAL RELATION e:isHot { DATA { ?m e:hot ?h . } LABEL ?h '
    'TARGET { ?m e:isHot ?l } LOSS bce EPOCHS 30 BATCH_SIZE 8 LEARNING_RATE 0.1 }', ml) == []
rows = port.execute_query_volcano("SELECT ?m WHERE { ?m <http://e/isHot> ?v }", ml)
assert sorted(rows) == [[f"http://e/m{i}"] for i in (1, 3, 5, 7)], rows
from kolibrie_tpu_torch.obs import analyze
from kolibrie_tpu_torch.optimizer import device_engine, mqo, plan_interp, stats_advisor
from kolibrie_tpu_torch.query import compile_cache, prewarm, template
from kolibrie_tpu_torch.query.engine import QueryEngine
from kolibrie_tpu_torch.query.executor import execute_queries_batched, plan_cache_info
rq = "SELECT ?x ?y WHERE { ?x <http://e/knows> ?y . ?y <http://e/knows> ?z }"
pq = device_engine.PreparedQuery(db, rq)
pq.calibrate()
before = device_engine.fetch_counters()
out = pq.run()
sums, nrows = pq.run_amortized(3)
assert device_engine.fetch_counters() == before
assert pq.fetch(out) == sorted(port.execute_query_volcano(rq, db)), pq.fetch(out)
assert execute_queries_batched(db, [rq, rq]) == [pq.fetch(out)] * 2
with plan_interp.override_mode("force"), mqo.override_mqo_mode("force"):
    assert port.execute_query_volcano(rq + " LIMIT 5", db) == pq.fetch(out)
with stats_advisor.override_mode("auto"), analyze.capture() as cap:
    text = QueryEngine(db).explain_device(rq, analyze=True)
assert "actual=" in text and "advisor: source=" in text, text
assert plan_cache_info(db)["templates"] >= 2 and template.fingerprint_query
assert compile_cache.manifest_snapshot() and prewarm.replay_manifest
import os, tempfile
import kolibrie_tpu_torch.durability
import kolibrie_tpu_torch.resilience
from kolibrie_tpu_torch.durability import fsio, manager as dmanager, wal
from kolibrie_tpu_torch.resilience import (
    FaultPlan, InjectedCompileError, admission, breaker, deadline, errors, faultinject,
    supervisor,
)
small = port.SparqlDatabase(device="cpu")
small.parse_ntriples("<http://e/a> <http://e/p> <http://e/b> .\n")
small.execution_mode = "device"
plan = FaultPlan(seed=0).add("device.lower", error=InjectedCompileError)
with plan.installed():
    assert port.execute_query_volcano("SELECT ?x WHERE { ?x <http://e/p> ?y }", small) == [
        ["http://e/a"]]
(snap,) = breaker.breaker_board(small).snapshot().values()
assert snap["failures"] == 1, snap
data = tempfile.mkdtemp()
m = dmanager.DurabilityManager(data, fsync_policy="always", device="cpu")
m.start()
w = port.SparqlDatabase(device="cpu")
m.attach("s", w)
w.parse_ntriples("<http://e/a> <http://e/p> <http://e/b> .\n")
m.close()
m = dmanager.DurabilityManager(data, device="cpu")
back = m.recover().stores["s"]
m.close()
assert sorted(back.iter_decoded()) == sorted(w.iter_decoded())
try:
    dmanager.DurabilityManager(tempfile.mkdtemp())
except RuntimeError as e:
    assert "CUDA" in str(e)
else:
    raise AssertionError("a durability manager without a device and no CUDA card must raise")
import kolibrie_tpu_torch.frontends
import kolibrie_tpu_torch.replication
from kolibrie_tpu_torch.analysis import lockcheck
from kolibrie_tpu_torch.frontends import cli, http_server, router_main, rules
from kolibrie_tpu_torch.obs import export, flightrec, log as obslog, promtext, timeseries
from kolibrie_tpu_torch.replication import follower, primary, protocol, router
assert lockcheck.selftest()
obslog.set_quiet(True)
httpd = http_server.make_server("127.0.0.1", 0, quiet=True, device="cpu")
httpd.server_close()
try:
    http_server.make_server("127.0.0.1", 0, quiet=True)
except RuntimeError as e:
    assert "CUDA" in str(e)
else:
    raise AssertionError("a server without a device and no CUDA card must raise")
try:
    cli.main(["--query", "SELECT ?s WHERE { ?s ?p ?o }"])
except RuntimeError as e:
    assert "CUDA" in str(e)
else:
    raise AssertionError("the CLI without --device and no CUDA card must raise")
leaked = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m.startswith("kolibrie_tpu.")
)
assert not leaked, leaked
try:
    port.SparqlDatabase()
except RuntimeError as e:
    assert "CUDA" in str(e)
else:
    raise AssertionError("no device and no CUDA card must raise")
try:
    port.Reasoner()
except RuntimeError as e:
    assert "CUDA" in str(e)
else:
    raise AssertionError("a reasoner without a device and no CUDA card must raise")
try:
    port.RSPBuilder("REGISTER RSTREAM <http://o> AS SELECT ?a FROM NAMED WINDOW <http://e/w> "
                    "ON <http://e/s> [RANGE 4 STEP 2] WHERE { WINDOW <http://e/w> "
                    "{ ?a <http://e/p> ?b } }").build()
except RuntimeError as e:
    assert "CUDA" in str(e)
else:
    raise AssertionError("an RSP engine without a device and no CUDA card must raise")
try:
    MlpNeuralPredicate(2)
except RuntimeError as e:
    assert "CUDA" in str(e)
else:
    raise AssertionError("a model without a device and no CUDA card must raise")
try:
    ReasoningHierarchy()
except RuntimeError as e:
    assert "CUDA" in str(e)
else:
    raise AssertionError("a hierarchy without a device and no CUDA card must raise")
print("guard-ok")
"""


def _env():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = str(REPO)
    return env


def test_port_imports_no_jax_and_needs_an_explicit_cpu():
    out = subprocess.run(
        [sys.executable, "-c", GUARD],
        capture_output=True,
        text=True,
        timeout=120,
        env=_env(),
        cwd=str(REPO),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("guard-ok")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_of_the_port_names_jax_or_the_jax_package():
    pkg = REPO / "kolibrie_tpu_torch"
    walked = {f.parent.name for f in pkg.rglob("*.py")}
    assert {"rsp", "obs", "resilience", "reasoner", "optimizer", "ops", "native", "ml",
            "parallel", "durability", "frontends", "replication", "analysis"} <= walked, walked
    for name in ("admission", "breaker", "deadline", "errors", "faultinject", "supervisor"):
        assert (pkg / "resilience" / f"{name}.py").exists(), name
    for name in ("fsio", "wal", "manager"):
        assert (pkg / "durability" / f"{name}.py").exists(), name
    for path in ("obs/log", "obs/export", "obs/flightrec", "obs/promtext", "obs/timeseries",
                 "analysis/lockcheck", "frontends/http_server", "frontends/cli",
                 "frontends/rules", "frontends/router_main", "replication/protocol",
                 "replication/primary", "replication/follower", "replication/router"):
        assert (pkg / f"{path}.py").exists(), path
    files = sorted(pkg.rglob("*.py")) + [
        REPO / "chip_smoke.py",
        REPO / "chip_profile.py",
    ]
    bad = [
        (f.name, m)
        for f in files
        for m in _imports(f)
        if m == "jax" or m.startswith("jax.") or m == "kolibrie_tpu"
        or m.startswith("kolibrie_tpu.")
    ]
    assert not bad, bad


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    # without a card, in the repo: non-zero, no result line
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, timeout=120, env=_env(), cwd=str(REPO),
    )
    assert out.returncode != 0 and out.stdout == ""
    # alone in a directory, without the rest of the repo
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _env()
    env.pop("PYTHONPATH")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(tmp_path),
    )
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.usefixtures("port_device_program")
def test_unported_rsp_and_mqo_paths_raise():
    """Shared-prefix MQO, cross-window SDS+ reasoning and the incremental
    R2R no longer raise: they answer as the JAX package does (in this
    process the JAX package is loaded too, which the port ignores).  MQO
    stays ``off`` unless asked for."""
    import kolibrie_tpu_torch as port
    from kolibrie_tpu_torch.optimizer import mqo

    db = port.SparqlDatabase(device="cpu")
    db.parse_ntriples("<http://e/a> <http://e/p> <http://e/b> .\n")
    mqo.register_standing(db, "http://e/w")
    for mode in ("auto", "force"):
        with mqo.override_mqo_mode(mode):
            assert mqo.mqo_mode() == mode
            with mqo.standing_scope(db, "http://e/w"):
                rows = port.execute_query_volcano("SELECT ?x WHERE { ?x <http://e/p> ?y }", db)
            assert rows == [["http://e/a"]]
    assert mqo.mqo_mode() == "off"
    assert mqo.stats(db)["standing"] == 1
    # cross-window SDS+ and the incremental R2R are ported: both packages'
    # engines derive the same rows on the same stream
    from kolibrie_tpu.rsp.builder import RSPBuilder as RefBuilder
    from kolibrie_tpu.rsp.s2r import WindowTriple as RefWT

    q = ("REGISTER RSTREAM <http://o> AS SELECT ?a ?b FROM NAMED WINDOW <http://e/w/> "
         "ON <http://e/s> [RANGE 4 STEP 2] WHERE { WINDOW <http://e/w/> { ?a <q> ?b } }")
    rules = "@prefix w: <http://e/w/> . { ?a w:p ?b . } => { ?a w:q ?b . } ."
    q2 = ("REGISTER RSTREAM <http://o> AS SELECT ?a ?c FROM NAMED WINDOW <http://e/w> "
          "ON <http://e/s> [RANGE 4 STEP 2] WHERE { WINDOW <http://e/w> { ?a <http://e/r> ?c } }")
    rules2 = ("@prefix e: <http://e/> . { ?a e:p ?b . ?b e:p ?c . } => { ?a e:r ?c . } .")
    runs = {}
    for name, builder, wt in (("ref", RefBuilder, RefWT),
                              ("port", lambda t: port.RSPBuilder(t, device="cpu"), port.WindowTriple)):
        out, out2 = [], []
        e = builder(q).set_cross_window_rules(rules).with_consumer(out.append).build()
        e2 = builder(q2).add_rules(rules2).set_r2r_mode("incremental").with_consumer(out2.append).build()
        for ts in range(1, 9):
            e.add_to_stream("http://e/s", wt(f"n{ts}", "p", f"n{ts + 1}"), ts)
            e2.add_to_stream("http://e/s", wt(f"<http://e/n{ts}>", "<http://e/p>",
                                              f"<http://e/n{ts + 1}>"), ts)
        e.process_single_thread_window_results()
        runs[name] = (sorted(out), sorted(out2), type(e2.r2r).__name__)
    assert runs["port"] == runs["ref"]
    assert runs["port"][0] and runs["port"][1] and runs["port"][2] == "IncrementalR2R"
    with pytest.raises(ValueError):
        port.RSPBuilder(q, device="cpu").set_r2r_mode("tpu").build()
