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
    assert {"rsp", "obs", "resilience", "reasoner", "optimizer", "ops"} <= walked, walked
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


def test_unported_rsp_and_mqo_paths_raise():
    """Shared-prefix MQO, cross-window SDS+ reasoning and the incremental
    R2R are later slices: asking for them raises NotImplementedError (in
    this process the JAX package is loaded too, which the port ignores)."""
    import pytest

    import kolibrie_tpu_torch as port
    from kolibrie_tpu_torch.optimizer import mqo

    db = port.SparqlDatabase(device="cpu")
    for mode in ("auto", "force"):
        with mqo.override_mqo_mode(mode):
            with pytest.raises(NotImplementedError, match="item 10"):
                mqo.mqo_mode()
            with pytest.raises(NotImplementedError, match="item 10"):
                with mqo.standing_scope(db, "http://e/w"):
                    pass
    assert mqo.mqo_mode() == "off"
    q = ("REGISTER RSTREAM <http://o> AS SELECT ?a FROM NAMED WINDOW <http://e/w/> "
         "ON <http://e/s> [RANGE 4 STEP 2] WHERE { WINDOW <http://e/w/> { ?a <http://e/p> ?b } }")
    with pytest.raises(NotImplementedError, match="provenance"):
        port.RSPBuilder(q, device="cpu").set_cross_window_rules(
            "@prefix w: <http://e/w/> . { ?a w:p ?b . } => { ?a w:q ?b . } ."
        ).build()
    with pytest.raises(NotImplementedError, match="provenance"):
        port.RSPBuilder(q, device="cpu").set_r2r_mode("incremental").build()
    with pytest.raises(ValueError):
        port.RSPBuilder(q, device="cpu").set_r2r_mode("tpu").build()
