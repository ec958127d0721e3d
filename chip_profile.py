"""Where the PyTorch port's main-path queries spend their time, on one CUDA
card.

    python3 chip_profile.py

Builds the same data and queries as ``chip_smoke.py``: phase 4's
employee-100K join, LUBM-1000 Q2, Q9 and Q9 under ``KOLIBRIE_WCOJ=off``,
and phase 4b's SELECT-surface queries (``SURFACE_QUERIES``).  For each
query: one cold run (capacity convergence), one warm run with timers around
planning (``Streamertail.find_best_plan``), the device engine
(``LoweredPlan.execute``, synchronised: the plain and fused routes), the
device plan runs alone (``LoweredPlan.run``, synchronised: every route),
the device aggregate with its readback and number encoding
(``aggregate_table``; the encoding alone: ``_encode_numbers``), the device
top-k (``_order_limit``, synchronised),
the string ranks (``device_string_ranks``) and result decoding
(``format_results``), then a second warm run under ``torch.profiler`` for
the device's busy time (``busy_share`` is that over the timed run's wall)
and the operators whose kernels took the most of it.  Then the same for the reasoner's LUBM-1000 closure
(``chip_smoke.py`` phase 6): one cold run, one warm run with a timer
around every device round (``device_fixpoint._fixpoint_round``, which ends
in the round's one host read), then a warm run under ``torch.profiler``.
Then phase 7's RSP stream (``chip_smoke.run_rsp``, device R2R): per firing
the wall, the R2R's maintenance and fixpoint ms, the store's compaction ms
(``ColumnarTripleStore.compact``), the query ms, and the rest of the R2R
(host eviction and write-back of derived facts) and of the firing (the
engine's per-item window remove/add); one warm firing (the fourth) runs
under ``torch.profiler``, and its device busy ms over the median wall of
the other warm firings is the stream's busy share.
Then phase 8: each host-engine shape (``HOST_QUERIES``) and ``execute_query``
on ``agg_dept`` as the queries above, with timers around the host engine
(``ExecutionEngine.execute_with_ids``, synchronised: its device work and
the one readback), the textual-order join (``_naive_eval``) and the host
aggregate; and the statements (RULE, DELETE … WHERE, INSERT DATA, DELETE
DATA) on a database of their own: wall, closure, compaction and WHERE ms,
then a run under ``torch.profiler``.
Prints one JSON object per query, one for the closure, one for the RSP
stream and one per statement, the card's name and power limit, and last
one JSON object with every breakdown.  It checks nothing: ``chip_smoke.py``
does.
"""

from __future__ import annotations

import json
import os
import sys
import time


def profile_query(name: str, db, sparql: str, wcoj: str, entry=None) -> dict:
    import torch

    from kolibrie_tpu_torch import execute_query_volcano
    from kolibrie_tpu_torch.optimizer import device_engine as DE
    from kolibrie_tpu_torch.optimizer import planner as PL
    from kolibrie_tpu_torch.optimizer.engine import ExecutionEngine
    from kolibrie_tpu_torch.query import executor as EX

    execute_query_volcano = entry or execute_query_volcano

    spent = {}

    def timed(phase, fn):
        def wrapped(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                if phase in ("engine", "device_plan", "topk", "host_engine", "naive"):
                    torch.cuda.synchronize()
                spent[phase] = spent.get(phase, 0.0) + (time.perf_counter() - t) * 1e3

        return wrapped

    os.environ["KOLIBRIE_WCOJ"] = wcoj
    try:
        execute_query_volcano(sparql, db)  # cold: capacity convergence
        patched = [
            (PL.Streamertail, "find_best_plan", "plan"),
            (DE.LoweredPlan, "execute", "engine"),
            (DE.LoweredPlan, "run", "device_plan"),
            (DE, "aggregate_table", "aggregate"),
            (EX, "_encode_numbers", "encode_numbers"),
            (DE, "_order_limit", "topk"),
            (DE, "device_string_ranks", "string_ranks"),
            (EX, "format_results", "format"),
            (ExecutionEngine, "execute_with_ids", "host_engine"),
            (EX, "_naive_eval", "naive"),
            (EX, "_group_and_aggregate_table", "host_aggregate"),
        ]
        orig = [getattr(owner, attr) for owner, attr, _ph in patched]
        for (owner, attr, phase), fn in zip(patched, orig):
            setattr(owner, attr, timed(phase, fn))
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            rows = execute_query_volcano(sparql, db)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        finally:
            for (owner, attr, _ph), fn in zip(patched, orig):
                setattr(owner, attr, fn)
        prof = device_profile(lambda: execute_query_volcano(sparql, db))
    finally:
        os.environ.pop("KOLIBRIE_WCOJ", None)
    return {
        "query": name,
        "rows": len(rows),
        "wall_ms": wall_ms,
        "host_phases_ms": dict(spent),
        **prof,
        "busy_share": prof["device_busy_ms"] / wall_ms,
    }


def device_profile(fn) -> dict:
    """Device busy time, device op count and the operators whose kernels
    took the most of it, for one call of ``fn`` under ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    # device time by the operator that launched it (aten::sort, aten::index, ...)
    ops = [e for e in events if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "device_busy_ms": sum(e.self_device_time_total for e in dev) / 1e3,
        "device_ops": sum(e.count for e in dev),
        "top_device": [
            {"op": e.key, "device_ms": e.self_device_time_total / 1e3, "calls": e.count}
            for e in top
        ],
    }


def profile_closure(lubm) -> dict:
    import torch

    from chip_smoke import add_lubm_closure_rules
    from kolibrie_tpu_torch import Reasoner
    from kolibrie_tpu_torch.reasoner import device_fixpoint as FX

    s, p, o = lubm.store.columns()

    def fresh():
        r = Reasoner(lubm.dictionary, device=torch.device("cuda"))
        r.facts.add_batch(s, p, o)
        add_lubm_closure_rules(r)
        len(r.facts)  # compact on the host before the clock starts
        return r

    fresh().infer_new_facts_semi_naive_parallel()  # cold
    rounds_ms = []
    orig = FX._fixpoint_round

    def timed(*a, **k):
        t = time.perf_counter()
        out = orig(*a, **k)  # ends in the round's host read of its counts
        rounds_ms.append((time.perf_counter() - t) * 1e3)
        return out

    r = fresh()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    FX._fixpoint_round = timed
    try:
        t = time.perf_counter()
        derived = r.infer_new_facts_semi_naive_parallel()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    finally:
        FX._fixpoint_round = orig
    peak = torch.cuda.max_memory_allocated()
    r = fresh()
    prof = device_profile(r.infer_new_facts_semi_naive_parallel)
    return {
        "closure": "lubm1000",
        "derived": derived,
        "wall_ms": wall_ms,
        "rounds_ms": rounds_ms,
        "outside_rounds_ms": wall_ms - sum(rounds_ms),
        "peak_bytes": peak,
        **prof,
        "busy_share": prof["device_busy_ms"] / wall_ms,
    }


def profile_statements(dev, lubm) -> list:
    """Phase 8's statements on a database of their own: RULE and DELETE …
    WHERE cold, then warm with timers around the closure
    (``Reasoner.infer_new_facts_semi_naive_parallel``), the store's
    compaction and the DELETE's WHERE (``eval_where``), then once more under
    ``torch.profiler``; INSERT DATA and DELETE DATA likewise."""
    import torch

    from chip_smoke import (
        DATA_TRIPLES,
        DELETE_STATEMENT,
        RULE_STATEMENT,
        SURFACE_PREFIXES,
        StepTimer,
        data_statement,
    )
    from kolibrie_tpu_torch import Reasoner, SparqlDatabase, execute_query_volcano
    from kolibrie_tpu_torch.core.store import ColumnarTripleStore
    from kolibrie_tpu_torch.query import executor as EX

    db = SparqlDatabase.from_arrays(lubm.dictionary.id_to_str, *lubm.store.columns(), device=dev)
    texts = {
        "rule": RULE_STATEMENT,
        "delete_where": DELETE_STATEMENT,
        "insert_data": data_statement(DATA_TRIPLES, "INSERT DATA"),
        "delete_data": data_statement(DATA_TRIPLES, "DELETE DATA"),
    }

    def run(name):
        execute_query_volcano(SURFACE_PREFIXES + texts[name], db)
        len(db)  # the statement's compaction

    pairs = (("rule", "delete_where"), ("insert_data", "delete_data"))
    for pair in pairs:  # cold
        for name in pair:
            run(name)
    out = {}
    specs = [(Reasoner, "infer_new_facts_semi_naive_parallel", "closure_ms", None),
             (ColumnarTripleStore, "compact", "compaction_ms", db.store),
             (EX, "eval_where", "where_ms", None)]
    for pair in pairs:
        for name in pair:
            with StepTimer(dev, specs) as steps:
                torch.cuda.synchronize()
                t = time.perf_counter()
                run(name)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) * 1e3
            out[name] = {"statement": name, "wall_ms": wall, "host_phases_ms": dict(steps.ms)}
        for name in pair:
            prof = device_profile(lambda: run(name))
            out[name].update(prof, busy_share=prof["device_busy_ms"] / out[name]["wall_ms"])
    return list(out.values())


def profile_rsp(dev) -> dict:
    import statistics

    from chip_smoke import (
        RSP_EVENTS_PER_TICK,
        RSP_PERSONS,
        RSP_SEED,
        RSP_TICKS,
        rsp_stream,
        run_rsp,
    )
    from kolibrie_tpu_torch.core.store import ColumnarTripleStore

    profiled_firing = 3
    spent = {}
    compact = ColumnarTripleStore.compact

    def compact_timed(self):
        t = time.perf_counter()
        try:
            return compact(self)
        finally:
            spent["compact_ms"] = spent.get("compact_ms", 0.0) + (time.perf_counter() - t) * 1e3

    prof = {}

    def around(k, fn):
        spent.clear()
        if k == profiled_firing:
            prof.update(device_profile(fn))
        else:
            fn()
        compacts.append(spent.get("compact_ms", 0.0))

    compacts = []
    ColumnarTripleStore.compact = compact_timed
    try:
        stream = rsp_stream(RSP_PERSONS, RSP_EVENTS_PER_TICK, RSP_TICKS, RSP_SEED)
        run = run_rsp(dev, "device", stream, around_firing=around)
    finally:
        ColumnarTripleStore.compact = compact
    firings = []
    for rec, compact_ms in zip(run["firings"], compacts):
        r2r, query, wall = rec.get("r2r_ms", 0.0), rec.get("query_ms", 0.0), rec["wall_ms"]
        inside = rec.get("maintain_ms", 0.0) + rec.get("fixpoint_ms", 0.0)
        firings.append({
            "content": rec["content"], "derived": rec["derived"], "rows": len(rec["rows"]),
            "wall_ms": wall, "r2r_ms": r2r, "maintain_ms": rec.get("maintain_ms", 0.0),
            "fixpoint_ms": rec.get("fixpoint_ms", 0.0), "rounds": rec.get("rounds"),
            "caps": rec.get("caps"), "compact_ms": compact_ms, "query_ms": query,
            "r2r_host_rest_ms": r2r - inside, "outside_r2r_query_ms": wall - r2r - query,
        })
    warm = [f["wall_ms"] for k, f in enumerate(firings) if k not in (0, profiled_firing)]
    return {
        "rsp": "phase7",
        "events": len(stream),
        "events_per_s": run["events_per_s"],
        "peak_bytes": run["peak_bytes"],
        "firings": firings,
        "profiled_firing": profiled_firing,
        **prof,
        "busy_share": prof["device_busy_ms"] / statistics.median(warm),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chip_smoke import (
        HOST_QUERIES,
        NAIVE_QUERY,
        SURFACE_PREFIXES,
        SURFACE_QUERIES,
        build_queries,
        card_line,
        surface_databases,
    )
    from torch.profiler import ProfilerActivity, profile

    from kolibrie_tpu_torch import SparqlDatabase, execute_query
    from kolibrie_tpu_torch.ops import kernels as K

    card = card_line()
    K.build_kernels()
    dev = torch.device("cuda")
    with profile(activities=[ProfilerActivity.CUDA]):  # profiler start-up cost
        torch.zeros(1, device=dev).add_(1)
        torch.cuda.synchronize()
    out = []
    queries = build_queries(dev)
    for name, db, sparql, wcoj in queries:
        out.append(profile_query(name, db, sparql, wcoj))
        print(json.dumps(out[-1]), flush=True)
    dbs = surface_databases(dev, queries)
    for name, (which, sparql) in SURFACE_QUERIES.items():
        out.append(profile_query(name, dbs[which], SURFACE_PREFIXES + sparql, "auto"))
        print(json.dumps(out[-1]), flush=True)
    del dbs
    lubm = next(db for name, db, _q, _w in queries if name == "q2")
    closure = profile_closure(lubm)
    print(json.dumps(closure), flush=True)
    rsp = profile_rsp(dev)
    print(json.dumps(rsp), flush=True)
    # phase 8: the host engine's shapes (on a database of their own) and the statements
    host_db = SparqlDatabase.from_arrays(
        lubm.dictionary.id_to_str, *lubm.store.columns(), device=dev)
    for name, sparql in HOST_QUERIES.items():
        out.append(profile_query(name, host_db, SURFACE_PREFIXES + sparql, "auto"))
        print(json.dumps(out[-1]), flush=True)
    out.append(profile_query("naive", host_db, SURFACE_PREFIXES + NAIVE_QUERY, "auto",
                             entry=execute_query))
    print(json.dumps(out[-1]), flush=True)
    del host_db
    statements = profile_statements(dev, lubm)
    for rec in statements:
        print(json.dumps(rec), flush=True)
    print(card)
    print(json.dumps({"card": card, "queries": out, "closure": closure, "rsp": rsp,
                      "statements": statements}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
