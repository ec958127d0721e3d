"""The port's plan cache and batched dispatch against the JAX package's.

``execute_query_volcano`` goes through the plan cache in both packages.
Over the same sequence of SELECTs (plain, aggregate, ORDER BY … LIMIT)
interleaved with INSERT DATA / DELETE DATA under the delta threshold, a
term interned after a plan embedded it as unknown, a bulk load that
compacts the store into a new base, and a ``KOLIBRIE_WCOJ`` flip, the
port's ``plan_cache_info()`` counters must equal the reference's after
every step, and every replayed query's rows must equal the reference's and
a fresh, uncached lowering's.  ``execute_queries_batched`` must return the
reference's rows and the solo rows, with the same batch counters, and a
template's 16 constant-variants must run ONE spec tree
(``device_compile_stats()["run_plan"]`` grows by 1).  All exact.
"""

from __future__ import annotations

import pytest

import kolibrie_tpu_torch as port
from kolibrie_tpu.query.executor import execute_queries_batched as ref_batched
from kolibrie_tpu.query.executor import execute_query_volcano as ref_execute
from kolibrie_tpu.query.executor import plan_cache_info as ref_info
from kolibrie_tpu_torch.optimizer import device_engine as tde
from kolibrie_tpu_torch.query import executor as tex
from jax_compile_cache import fresh_jax_compile_cache
from test_torch_clauses import PREFIXES, employee_db, pair
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)


@pytest.fixture(autouse=True)
def _reference_compile_cache(tmp_path):
    with fresh_jax_compile_cache(tmp_path / "jax_cache"):
        yield


def variant(dept, sal) -> str:
    return (PREFIXES + f'SELECT ?e ?s WHERE {{ ?e ex:dept "{dept}" . ?e ex:salary ?s . '
            f"FILTER(?s > {sal}) }}")


def agg(dept) -> str:
    return PREFIXES + f'SELECT (COUNT(?e) AS ?n) WHERE {{ ?e ex:dept "{dept}" . ?e ex:salary ?s }}'


def ordered(dept) -> str:
    return (PREFIXES + f'SELECT ?e ?s WHERE {{ ?e ex:dept "{dept}" . ?e ex:salary ?s }} '
            "ORDER BY DESC(?s) LIMIT 3")


TRIANGLE = PREFIXES + "SELECT ?a ?b ?c WHERE { ?a ex:knows ?b . ?b ex:knows ?c . ?c ex:knows ?a }"
BULK = "\n".join(
    f'<http://example.org/b{i}> <http://example.org/dept> "deptZ" .' for i in range(5000)
)

SEQUENCE = [
    ("q", variant("dept0", 40000)),
    ("q", variant("dept0", 40000)),  # hit
    ("q", variant("dept1", 50000)),  # param rebind
    ("q", agg("dept1")),
    ("q", agg("dept2")),
    ("q", ordered("dept3")),
    ("q", ordered("dept3")),
    ("q", variant("deptZ", 0)),  # deptZ unknown: the plan embeds a never-match
    ("u", 'INSERT DATA { ex:z1 ex:dept "deptZ" . ex:z1 ex:salary "99000" }'),
    ("q", variant("deptZ", 0)),  # the term is interned now: rebind, one row
    ("u", 'DELETE DATA { ex:e5 ex:dept "dept0" }'),
    ("q", variant("dept0", 40000)),  # delta only: the slot replays
    ("q", agg("dept1")),
    ("u", "INSERT DATA { ex:e1 ex:knows ex:e2 . ex:e2 ex:knows ex:e3 . ex:e3 ex:knows ex:e1 }"),
    ("q", TRIANGLE),
    ("bulk", BULK),  # a new base version: fresh slots
    ("q", variant("deptZ", 0)),
    ("q", agg("deptZ")),
    ("q", ordered("dept3")),
    ("wcoj", "off"),
    ("q", TRIANGLE),  # a new fingerprint under the other join strategy
    ("q", variant("dept2", 45000)),
    ("wcoj", "auto"),
    ("q", TRIANGLE),  # the first fingerprint's slot again
]


def fresh_rows(db, text):
    """The port's rows from a fresh parse, plan and lowering (no cache)."""
    cq = port.query.parser.parse_combined_query(text, db.prefixes)
    return tex.execute_combined(db, cq)


def test_plan_cache_counters_match_reference(monkeypatch):
    ref, tdb = pair(employee_db(300))
    monkeypatch.setenv("KOLIBRIE_WCOJ", "auto")
    bases = set()
    for kind, arg in SEQUENCE:
        if kind == "wcoj":
            monkeypatch.setenv("KOLIBRIE_WCOJ", arg)
            continue
        if kind == "bulk":
            ref.parse_ntriples(arg)
            tdb.parse_ntriples(arg)
            continue
        want = ref_execute(arg, ref)
        got = port.execute_query_volcano(arg, tdb)
        assert got == want, arg
        if kind == "q":
            assert got == fresh_rows(tdb, arg), arg
            ri, ti = ref_info(ref), tex.plan_cache_info(tdb)
            assert ti == ri, arg
            bases.add(tdb.store.base_version)
    info = tex.plan_cache_info(tdb)
    assert info["hits"] > 0 and info["misses"] > 0 and info["param_rebinds"] > 0
    assert len(bases) == 2  # the bulk load compacted into a new base
    assert port.execute_query_volcano(variant("deptZ", 0), tdb)  # 5001 rows
    assert tdb.dictionary.id_to_str == ref.dictionary.id_to_str


def test_batched_execution_matches_reference():
    ref, tdb = pair(employee_db(300))
    batch = [variant(f"dept{d}", s) for d in range(5) for s in (35000, 60000)]
    batch.append(agg("dept0"))
    batch.append(batch[0])
    batch.append(PREFIXES + 'SELECT ?e WHERE { ?e ex:dept "dept1" }')
    want = ref_batched(ref, batch)
    got = tex.execute_queries_batched(tdb, batch)
    assert got == want
    assert got == [port.execute_query_volcano(q, tdb) for q in batch]
    ti, ri = tex.plan_cache_info(tdb), ref_info(ref)
    assert (ti["batched"], ti["batch_groups"]) == (ri["batched"], ri["batch_groups"]) == (11, 1)
    assert tex.execute_queries_batched(tdb, []) == []


def test_batch_reads_counts_once_per_attempt():
    _ref, tdb = pair(employee_db(200))
    batch = [variant(f"dept{d}", 30000 + 1000 * d) for d in range(5)]
    before = tde.fetch_counters()
    tex.execute_queries_batched(tdb, batch)
    after = tde.fetch_counters()
    assert after.get("batch.counts", 0) - before.get("batch.counts", 0) == 1
    assert after.get("batch.collect", 0) - before.get("batch.collect", 0) == 1
    assert after.get("converge.counts", 0) == before.get("converge.counts", 0)


def test_constant_variants_run_one_spec():
    ref, tdb = pair(employee_db(300))
    q = (PREFIXES + 'SELECT ?e ?w WHERE {{ ?e ex:dept "{}" . ?e foaf:workplaceHomepage ?w . '
         "?e ex:salary ?s . FILTER(?s < {}) }}")
    base = tde.device_compile_stats()["run_plan"]
    for i in range(16):
        text = q.format(f"dept{i % 5}", 35000 + 2000 * i)
        assert port.execute_query_volcano(text, tdb) == ref_execute(text, ref)
    assert tde.device_compile_stats()["run_plan"] == base + 1
    info = tex.plan_cache_info(tdb)
    assert (info["misses"], info["param_rebinds"], info["templates"]) == (1, 15, 1)
    port.execute_query_volcano(q.format("dept1", 70000), tdb)  # a rebind
    port.execute_query_volcano(q.format("dept1", 70000), tdb)  # a hit
    info = tex.plan_cache_info(tdb)
    assert (info["hits"], info["param_rebinds"]) == (1, 16)
    assert tde.device_compile_stats()["run_plan"] == base + 1


def test_template_cache_lru_bound(monkeypatch):
    monkeypatch.setattr(tex, "_TEMPLATE_CACHE_MAX", 2)
    _ref, tdb = pair(employee_db(60))
    queries = [
        PREFIXES + 'SELECT ?e WHERE { ?e ex:dept "dept0" }',
        PREFIXES + "SELECT ?e ?s WHERE { ?e ex:salary ?s }",
        PREFIXES + "SELECT ?e ?w WHERE { ?e foaf:workplaceHomepage ?w }",
    ]
    rows = [port.execute_query_volcano(q, tdb) for q in queries]
    info = tex.plan_cache_info(tdb)
    assert info["templates"] == 2 and info["evictions"] == 1
    assert port.execute_query_volcano(queries[0], tdb) == rows[0]


@pytest.mark.parametrize("failing", ["aggregate", "ordered"])
def test_failed_lowering_is_sticky(monkeypatch, failing):
    _ref, tdb = pair(employee_db(60))
    calls = {"n": 0}

    def refuse(*a, **k):
        calls["n"] += 1
        raise tde.Unsupported("refused for the test")

    monkeypatch.setattr(tex, "lower_plan", refuse)
    monkeypatch.setattr(tde, "lower_plan", refuse)
    make = agg if failing == "aggregate" else ordered
    first = port.execute_query_volcano(make("dept0"), tdb)
    n = calls["n"]
    assert n >= 1
    assert port.execute_query_volcano(make("dept0"), tdb) == first
    port.execute_query_volcano(make("dept1"), tdb)  # a rebind keeps the sentinel
    assert calls["n"] == n
