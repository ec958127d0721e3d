"""The port's compile cache and prewarm against the JAX package's.

The prewarm manifest keeps the reference's file format: a manifest (with
its stats-advisor section) saved by either package loads in the other
with equal entries and equal advisor views.  ``replay_manifest`` warms
every entry against a fresh database, after which the first foreground
run of a warmed template is a plan-cache hit; ``PrewarmManager`` runs the
same sweep from its thread.  ``enable`` points the kernel build at a
namespaced directory and counts each library loaded from it (hit) or
built into it (miss).
"""

from __future__ import annotations

import json
import os
import threading

import pytest

import kolibrie_tpu_torch as port
from kolibrie_tpu.optimizer import stats_advisor as ref_sa
from kolibrie_tpu.query import compile_cache as ref_cc
from kolibrie_tpu.query.executor import execute_query_volcano as ref_execute
from kolibrie_tpu_torch.ops import kernels as K
from kolibrie_tpu_torch.optimizer import device_engine as tde
from kolibrie_tpu_torch.optimizer import stats_advisor as port_sa
from kolibrie_tpu_torch.query import compile_cache as port_cc
from kolibrie_tpu_torch.query import prewarm
from kolibrie_tpu_torch.query.executor import plan_cache_info
from test_torch_clauses import PREFIXES, employee_db, pair
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)


def variant(dept, sal) -> str:
    return (PREFIXES + f'SELECT ?e ?s WHERE {{ ?e ex:dept "{dept}" . ?e ex:salary ?s . '
            f"FILTER(?s > {sal}) }}")


TEMPLATES = [
    variant("dept1", 40000),
    PREFIXES + "SELECT ?e ?w WHERE { ?e foaf:workplaceHomepage ?w }",
    PREFIXES + 'SELECT (COUNT(?e) AS ?n) WHERE { ?e ex:dept "dept2" }',
    PREFIXES + "SELECT ?e ?s WHERE { ?e ex:salary ?s } ORDER BY DESC(?s) LIMIT 5",
]


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    for cc in (ref_cc, port_cc):
        monkeypatch.setattr(cc, "_templates", {})
    for sa in (ref_sa, port_sa):
        sa.stats_advisor.reset()
    yield
    for sa in (ref_sa, port_sa):
        sa.stats_advisor.reset()


def run_templates(execute, db, extra_variants=True):
    for q in TEMPLATES:
        execute(q, db)
    if extra_variants:
        for s in (30000, 50000, 60000):
            execute(variant("dept3", s), db)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_manifest_crosses_packages(tmp_path, writer):
    ref, tdb = pair(employee_db(100))
    with ref_sa.override_mode("auto"), port_sa.override_mode("auto"):
        run_templates(ref_execute, ref)
        run_templates(port.execute_query_volcano, tdb)
        assert port_cc.manifest_snapshot() == ref_cc.manifest_snapshot()
        root = str(tmp_path)
        (port_cc if writer == "port" else ref_cc).save_manifest(root)
        doc = json.loads((tmp_path / "prewarm_manifest.json").read_text())
        assert doc["version"] == 1 and len(doc["templates"]) == len(TEMPLATES)
        assert port_cc.load_manifest(root) == ref_cc.load_manifest(root) == doc["templates"]
        writer_sa = ref_sa if writer == "ref" else port_sa
        views = {fp: writer_sa.stats_advisor.view(fp) for fp in doc["stats_advisor"]["templates"]}
        views = {fp: view for fp, view in views.items() if view}
        assert len(views) >= 2
        for sa, cc in ((ref_sa, ref_cc), (port_sa, port_cc)):
            sa.stats_advisor.reset()
            assert cc.load_advisor_state(root) == len(views)
            for fp, view in views.items():
                assert sa.stats_advisor.view(fp) == view and view
    top = doc["templates"][0]
    assert top["hits"] == 4 and "dept" in top["query"]


def test_corrupt_manifest_degrades(tmp_path):
    (tmp_path / "prewarm_manifest.json").write_text("{not json")
    assert port_cc.load_manifest(str(tmp_path)) == []
    assert port_cc.load_advisor_state(str(tmp_path)) == 0


def test_replay_manifest_warms_every_entry(tmp_path):
    _ref, tdb = pair(employee_db(100))
    run_templates(port.execute_query_volcano, tdb)
    root = str(tmp_path)
    assert port_cc.save_manifest(root) == os.path.join(root, "prewarm_manifest.json")
    _ref, fresh = pair(employee_db(100))
    results = prewarm.replay_manifest(fresh, root)
    assert len(results) == len(TEMPLATES)
    sources = []
    for res in results:
        got = res["targets"]["db"]
        assert "error" not in got and got["rows"] > 0, res
        sources.append(got["source"])
    # the ordered and aggregate routes run their lowering without execute()
    assert sources.count("compiled") >= 2 and set(sources) <= {"compiled", None}
    info = plan_cache_info(fresh)
    assert info["templates"] == len(TEMPLATES) and info["misses"] == len(TEMPLATES)
    # warming does not inflate the popularity ranking it replays
    assert port_cc.manifest_snapshot()[0]["hits"] == 4
    for q in TEMPLATES:
        port.execute_query_volcano(q, fresh)
    assert plan_cache_info(fresh)["hits"] == len(TEMPLATES)


def test_prewarm_manager_thread(tmp_path):
    _ref, tdb = pair(employee_db(60))
    run_templates(port.execute_query_volcano, tdb, extra_variants=False)
    root = str(tmp_path)
    port_cc.save_manifest(root)
    _ref, fresh = pair(employee_db(60))
    lock = threading.Lock()
    mgr = prewarm.PrewarmManager(lambda: [("db", fresh, lock)], root=root, save_interval_s=60)
    mgr.start()
    try:
        for _ in range(400):
            if mgr.stats()["startup_replayed"]:
                break
            threading.Event().wait(0.05)
    finally:
        mgr.stop(timeout_s=10)
    assert mgr._thread is not None and not mgr._thread.is_alive()
    assert mgr.stats()["startup_replayed"] == len(TEMPLATES)
    assert plan_cache_info(fresh)["templates"] == len(TEMPLATES)


def test_enable_points_the_kernel_build_at_the_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(port_cc, "_active_dir", None)
    monkeypatch.setattr(port_cc, "_event_counts", {"hits": 0, "misses": 0})
    monkeypatch.setattr(K, "_BUILD_DIR", [K._BUILD])
    assert port_cc.enable() is None and K._lib_path("merge_join").parent == K._BUILD
    target = port_cc.enable(explicit_dir=str(tmp_path))
    assert target == os.path.join(str(tmp_path), port_cc.cache_namespace())
    assert os.path.isdir(target) and port_cc.enabled_dir() == target
    assert K._lib_path("merge_join").parent == K._BUILD_DIR[0] == type(K._BUILD)(target)
    assert port_cc.manifest_path() == os.path.join(str(tmp_path), "prewarm_manifest.json")
    assert port_cc.cache_namespace().endswith("-" + K.TARGET_ARCH)
    # a build into the directory is a miss, a later load of it a hit
    K._cache_note(False)
    K._cache_note(True)
    K._cache_note(True)
    assert port_cc.counters() == {"hits": 2, "misses": 1}
    st = port_cc.stats()
    assert st["enabled"] and st["dir"] == target and st["entries"] == 0
    # a new spec whose libraries all came from the cache classifies "disk"
    monkeypatch.setattr(port_cc, "_event_counts", {"hits": 3, "misses": 0})
    specs = len(tde._SPECS_RUN["run_plan"])
    tde._note_spec("run_plan", ("a spec new to this process",))
    try:
        assert tde._classify_source(specs) == "disk"
        assert tde._classify_source(specs + 1) == "compiled"
    finally:
        tde._SPECS_RUN["run_plan"].discard(("a spec new to this process",))
