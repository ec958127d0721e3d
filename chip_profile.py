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
Then phase 9: 9a's three tagged closures and 9b's ``RULE … PROB``
(independent), each cold, then warm with a timer around every device round
(host ms per round, and the rest of the wall outside them: seeding, tag
write-back, RDF-star export; seeding and write-back also timed alone),
then under ``torch.profiler``; and the device route's threshold
(``profile_prov_crossover``: 9a's graph at 437-51,860 facts, device
closure against host loop).
Then phase 10 (``profile_cross_window``): 10a's four update ratios (the
naive wall; the incremental wall split into the tagged fixpoint's
dispatches, its seeding, its write-back and the rest; one run under
``torch.profiler``) and 10b's incremental engine per cycle, one warm cycle
profiled; the AUTO threshold's sweep (``profile_churn_sweep``: naive
against incremental at update ratios 1-50%); and phase 11 (``profile_load``:
serialize, load, upload, queries, checkpoint, restore, round trips, peak
device memory).
Then phase 12 (``profile_ml``): each TRAIN and ML.PREDICT of 12b-12d split
into the training-table or INPUT SELECT, the feature build, the MLP's
forward, backward and update (synchronised), the per-sample closures, the
WMC gradients and the weight reassignment; three of them once more under
``torch.profiler`` (busy share: over the timed run's wall); and the SDD
path's per-sample closure over the premise facts against the whole store.
Then phase 13 (``profile_repeated``): a prepared query's ``run`` against
``execute_query_volcano`` (employee join, Q2, Q9), 13b's 64 employee
template variants solo (through the plan cache, every variant a rebind)
against the same variants uncached (``execute_combined`` of a fresh parse,
with the parse and the cache's bookkeeping of a rebind timed alone, and
the two in turns after a full collection each, ``rebind_turns``) and
one ``execute_queries_batched`` call, the
same variants through the plan-bytecode interpreter, and ``bench.py``'s MQO
fleet (256 standing queries) independent against shared: each a warm run
timed (wall, synchronised), then under ``torch.profiler`` (device busy ms,
busy share over the timed wall, device ops, top operators; Python's
garbage collections during the timed run).
``python3 chip_profile.py repeated`` runs phase 13's part alone.
``python3 chip_profile.py resilience`` runs phase 4 and then
``chip_smoke.py``'s phase 14 (14a-14d, its checks included) in a fresh
process: phase 14's walls and WAL overheads without phases 5-13's heap
ahead of them.
Prints one JSON object per query, one for the closure, one for the RSP
stream, one per statement, one per phase-9 run, one per crossover
point, one per phase-10 point, cycle list and sweep ratio, one for phase
11, one per phase-12 statement, the card's name and
power limit, and last
one JSON object with every breakdown.  It checks nothing: ``chip_smoke.py``
does.
"""

from __future__ import annotations

import json
import os
import sys
import time

from chip_smoke import device_profile


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


def profile_provenance(dev, lubm) -> list:
    """Phase 9: each of 9a's tagged closures (``chip_smoke.PROV_SEMIRINGS``
    at ``PROV_FACTS``) and 9b's ``RULE … PROB`` (independent) at LUBM-1000:
    one cold run, one warm run with a timer around every device dispatch
    (``device_provenance._prov_round`` / ``_prov_round_addmult``, each
    ending in its one host read), the tag seeding and the write-back, then
    a warm run under ``torch.profiler``."""
    import torch

    from chip_smoke import (
        PROB_RULE,
        PROV_FACTS,
        PROV_SEED,
        PROV_SEMIRINGS,
        SURFACE_PREFIXES,
        prov_reasoner,
        prov_seeds,
        prov_tag_store,
        prov_workload,
    )
    from kolibrie_tpu_torch import SparqlDatabase, execute_query_volcano
    from kolibrie_tpu_torch.reasoner import device_provenance as DP

    work = prov_workload(PROV_FACTS, PROV_SEED)
    seeds = prov_seeds(lubm, PROV_SEED)

    def closure(name):
        r, cols = prov_reasoner(dev, work)
        prov, store = prov_tag_store(name, cols, work)
        return lambda: r.infer_new_facts_with_provenance(prov, store)

    def rule():
        db = SparqlDatabase.from_arrays(lubm.dictionary.id_to_str, *lubm.store.columns(),
                                        device=dev, probability_seeds=seeds)
        q = SURFACE_PREFIXES + PROB_RULE.format(comb="independent")
        return lambda: (execute_query_volcano(q, db), len(db))

    out = []
    for label, make in [(f"9a_{n}", lambda n=n: closure(n)) for n in PROV_SEMIRINGS] + [
            ("9b_rule_independent", rule)]:
        make()()  # cold
        rounds_ms = []
        saved = (DP._prov_round, DP._prov_round_addmult)

        def timed(fn, into):
            def wrapped(*a, **k):
                t = time.perf_counter()
                res = fn(*a, **k)  # a dispatch ends in its host read
                into.append((time.perf_counter() - t) * 1e3)
                return res
            return wrapped

        fn = make()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        steps = (DP._seed_tag_arrays, DP._write_back)
        seed_ms, write_back_ms = [], []
        DP._prov_round, DP._prov_round_addmult = (timed(f, rounds_ms) for f in saved)
        DP._seed_tag_arrays = timed(steps[0], seed_ms)  # ends in its host read
        DP._write_back = timed(steps[1], write_back_ms)  # reads the tags to the host
        try:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        finally:
            DP._prov_round, DP._prov_round_addmult = saved
            DP._seed_tag_arrays, DP._write_back = steps
        peak = torch.cuda.max_memory_allocated()
        prof = device_profile(make())
        out.append({
            "provenance": label, "wall_ms": wall_ms, "rounds_ms": rounds_ms,
            "seed_ms": sum(seed_ms), "write_back_ms": sum(write_back_ms),
            "outside_rounds_ms": wall_ms - sum(rounds_ms), "caps": DP.LAST_RUN["caps"],
            "peak_bytes": peak, **prof, "busy_share": prof["device_busy_ms"] / wall_ms,
        })
        print(json.dumps(out[-1]), flush=True)
    return out


# 9a's graph at these drawn edges holds 437 / 841 / 1,304 / 1,723 / 2,145 / 5,204 /
# 10,406 / 20,770 / 51,860 facts
PROV_CROSSOVER_EDGES = (1_000, 2_000, 3_000, 4_000, 5_000, 12_000, 24_000, 48_000, 120_000)


def profile_prov_crossover(dev, repeats: int = 3) -> dict:
    """Where the device route starts to pay (``device_provenance.
    AUTO_MIN_FACTS``): 9a's graph (``chip_smoke.prov_workload``) at each of
    ``PROV_CROSSOVER_EDGES`` drawn edges under each of 9a's semirings, the device
    closure (``infer_provenance_device``) against the host loop
    (``infer_with_provenance_host``) on a fresh reasoner and seeded store
    each, synchronised; after one cold device run, the median of
    ``repeats`` runs of each."""
    import statistics

    import torch

    from chip_smoke import PROV_SEED, PROV_SEMIRINGS, prov_reasoner, prov_tag_store, prov_workload
    from kolibrie_tpu_torch.reasoner import device_provenance as DP
    from kolibrie_tpu_torch.reasoner.provenance_seminaive import infer_with_provenance_host

    def on_device(r, prov, store):
        if DP.infer_provenance_device(r, prov, store) is None:
            raise AssertionError("the device path declined 9a's program")

    rows = []
    for n in PROV_CROSSOVER_EDGES:
        work = prov_workload(n, PROV_SEED)
        for name in PROV_SEMIRINGS:
            def run(fn):
                r, cols = prov_reasoner(dev, work)
                prov, store = prov_tag_store(name, cols, work)
                n0 = len(r.facts)
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn(r, prov, store)
                torch.cuda.synchronize()
                return (time.perf_counter() - t) * 1e3, n0, len(r.facts)

            run(on_device)  # cold
            dev_runs = [run(on_device) for _ in range(repeats)]
            host_runs = [run(infer_with_provenance_host) for _ in range(repeats)]
            if {x[1:] for x in dev_runs} != {x[1:] for x in host_runs}:
                raise AssertionError(f"crossover {n} {name}: fact counts differ")
            rows.append({
                "edges": n, "facts": dev_runs[0][1], "closed_facts": dev_runs[0][2],
                "semiring": name,
                "device_ms": statistics.median(x[0] for x in dev_runs),
                "host_ms": statistics.median(x[0] for x in host_runs),
            })
            print(json.dumps({"prov_crossover": rows[-1]}), flush=True)
    return {"auto_min_facts": DP.AUTO_MIN_FACTS, "rows": rows}


class TaggedTimers:
    """Host ms inside the tagged fixpoint's dispatches (each ends in its one
    host read), its seeding and its write-back, accumulated until read."""

    def __enter__(self):
        from kolibrie_tpu_torch.reasoner import device_provenance as DP

        self.ms = {"rounds_ms": 0.0, "seed_ms": 0.0, "write_back_ms": 0.0, "dispatches": 0}
        self._saved = (DP._prov_round, DP._prov_round_addmult, DP._seed_tag_arrays,
                       DP._write_back)

        def timed(fn, key, count=False):
            def wrapped(*a, **k):
                t = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    self.ms[key] += (time.perf_counter() - t) * 1e3
                    self.ms["dispatches"] += count
            return wrapped

        r, ra, seed, wb = self._saved
        DP._prov_round, DP._prov_round_addmult = timed(r, "rounds_ms", True), timed(
            ra, "rounds_ms", True)
        DP._seed_tag_arrays, DP._write_back = timed(seed, "seed_ms"), timed(wb, "write_back_ms")
        return self

    def __exit__(self, *exc):
        from kolibrie_tpu_torch.reasoner import device_provenance as DP

        (DP._prov_round, DP._prov_round_addmult, DP._seed_tag_arrays, DP._write_back) = self._saved
        return False

    def take(self) -> dict:
        out = dict(self.ms)
        for k in out:
            self.ms[k] = 0.0 if k != "dispatches" else 0
        return out


def cw_setup(dev, n, ratio):
    """10a's inputs at ``n`` roads and ``ratio`` %: the dictionary, the
    rules, the SDS and the bench's prior (the ratio-0 SDS at time 0)."""
    from chip_smoke import CW_PARKING, CW_RULE, CW_TRAFFIC, cw_sds
    from kolibrie_tpu_torch import Dictionary
    from kolibrie_tpu_torch.reasoner.cross_window import incremental_sds_plus
    from kolibrie_tpu_torch.reasoner.n3_parser import parse_n3_rules_for_sds

    d = Dictionary()
    rules, _ = parse_n3_rules_for_sds(CW_RULE, d, [CW_TRAFFIC, CW_PARKING])
    prior = incremental_sds_plus(rules, cw_sds(n, 0), {}, d, 0, device=dev)
    return d, rules, cw_sds(n, ratio), prior


def profile_cross_window(dev) -> dict:
    """Phase 10: 10a at ``CW_ROADS`` and each of ``CW_RATIOS`` — the naive
    recomputation's wall, then the incremental cycle's wall with the tagged
    fixpoint's dispatches, seeding and write-back timed and the rest
    (translation, overlay, carry) outside them, then the incremental cycle
    under ``torch.profiler``; and 10b's incremental engine over
    ``CW_TICKS`` ticks, per cycle the same split, one warm cycle (the
    20th) under ``torch.profiler``."""
    import torch

    from chip_smoke import CW_RATIOS, CW_ROADS, CW_SEED, CW_TICKS, CW_TIME, cw_engine, cw_stream
    from kolibrie_tpu_torch.reasoner import device_provenance as DP
    from kolibrie_tpu_torch.reasoner.cross_window import incremental_sds_plus, naive_sds_plus

    points = []
    with TaggedTimers() as timers:
        for ratio in CW_RATIOS:
            d, rules, sds, prior = cw_setup(dev, CW_ROADS, ratio)
            incremental_sds_plus(rules, sds, prior, d, CW_TIME, device=dev)  # cold
            t = time.perf_counter()
            naive_sds_plus(rules, sds, d, CW_TIME, device=dev)
            naive_ms = (time.perf_counter() - t) * 1e3
            timers.take()
            torch.cuda.synchronize()
            t = time.perf_counter()
            incremental_sds_plus(rules, sds, prior, d, CW_TIME, device=dev)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
            split = timers.take()
            prof = device_profile(lambda: incremental_sds_plus(rules, sds, prior, d, CW_TIME,
                                                               device=dev))
            points.append({"ratio": ratio, "naive_ms": naive_ms, "incremental_ms": wall, **split,
                           "outside_rounds_ms": wall - split["rounds_ms"],
                           "rounds": DP.LAST_RUN["rounds"], "caps": DP.LAST_RUN["caps"],
                           **prof, "busy_share": prof["device_busy_ms"] / wall})
            print(json.dumps({"cross_window_10a": points[-1]}), flush=True)
        cycles: list = []
        engine = cw_engine(dev, "incremental", cycles)
        timed_cycle = engine._emit_cross_window
        splits, prof = [], {}

        def cycle(ts):
            timers.take()
            if len(cycles) == 19:
                prof.update(device_profile(lambda: timed_cycle(ts)))
            else:
                timed_cycle(ts)
            splits.append({**timers.take(), "rounds": DP.LAST_RUN["rounds"]})

        engine._emit_cross_window = cycle
        stream = cw_stream(CW_TICKS, CW_SEED)
        t = time.perf_counter()
        for ts, iri, item in stream:
            engine.add_to_stream(iri, item, ts)
        engine.process_single_thread_window_results()
        wall_s = time.perf_counter() - t
        engine.stop()
    per_cycle = [{"ts": c["ts"], "mode": c["mode"], "content": c["content"], "rows": len(c["rows"]),
                  "wall_ms": c["wall_ms"], **s, "outside_rounds_ms": c["wall_ms"] - s["rounds_ms"]}
                 for c, s in zip(cycles, splits)]
    out = {"cross_window": "phase10", "points": points,
           "engine": {"events": len(stream), "wall_s": wall_s, "events_per_s": len(stream) / wall_s,
                      "cycles": per_cycle, "profiled_cycle": 19, **prof,
                      "busy_share": prof.get("device_busy_ms", 0.0) / per_cycle[19]["wall_ms"]}}
    print(json.dumps({"cross_window_10b": out["engine"]}), flush=True)
    return out


# the AUTO threshold's sweep: update ratios (%) at 10a's width
CHURN_RATIOS = (1, 2, 5, 10, 20, 50)


def profile_churn_sweep(dev, repeats: int = 5) -> dict:
    """Where incremental SDS+ stops paying (``rsp/engine.py::
    _AUTO_MAX_CHURN``): 10a's SDS at ``CW_ROADS`` roads and each of
    ``CHURN_RATIOS``, ``naive_sds_plus`` against ``incremental_sds_plus``
    from the bench's prior; after one cold run of each, the median of
    ``repeats`` synchronised runs."""
    import statistics

    import torch

    from chip_smoke import CW_ROADS, CW_TIME
    from kolibrie_tpu_torch.reasoner.cross_window import incremental_sds_plus, naive_sds_plus

    rows = []
    for ratio in CHURN_RATIOS:
        d, rules, sds, prior = cw_setup(dev, CW_ROADS, ratio)

        def timed(fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3

        def naive():
            naive_sds_plus(rules, sds, d, CW_TIME, device=dev)

        def inc():
            incremental_sds_plus(rules, sds, prior, d, CW_TIME, device=dev)

        naive(), inc()  # cold
        n_ms = statistics.median(timed(naive) for _ in range(repeats))
        i_ms = statistics.median(timed(inc) for _ in range(repeats))
        rows.append({"ratio": ratio, "naive_ms": n_ms, "incremental_ms": i_ms,
                     "speedup": n_ms / i_ms})
        print(json.dumps({"churn_sweep": rows[-1]}), flush=True)
    from kolibrie_tpu_torch.rsp import engine as E

    return {"auto_max_churn": E._AUTO_MAX_CHURN, "rows": rows}


def profile_load(dev, lubm, emp) -> dict:
    """Phase 11 (``chip_smoke.run_load_phase``) once more, its steps timed
    there: serialize and write, parse and ingest (``load_file``), upload
    of the mirror, Q2 and Q9, checkpoint, restore, clone, union and the
    employee round trips; peak device memory."""
    from benches.lubm import LUBM_Q2, LUBM_Q9
    from chip_smoke import EMPLOYEE_QUERY, run_load_phase
    from kolibrie_tpu_torch import execute_query_volcano

    rows = {"q2": execute_query_volcano(LUBM_Q2, lubm), "q9": execute_query_volcano(LUBM_Q9, lubm),
            "employee": execute_query_volcano(EMPLOYEE_QUERY, emp)}
    out = run_load_phase(dev, {"rows": rows, "report": {"queries": {}}}, lubm, emp)
    rec = {"load": "phase11", "ms": out["ms"], "peak_bytes": out["peak_bytes"],
           "nt_bytes": out["nt_bytes"], "checkpoint_bytes": out["checkpoint_bytes"]}
    print(json.dumps(rec), flush=True)
    return rec


ML_WHOLE_STORE_SAMPLES = 200  # measurements of the whole-store closure comparison


class MlTimers:
    """Host-clock ms inside TRAIN's and ML.PREDICT's steps, ``{step: ms}``:
    the training-table or INPUT SELECT, the feature build, the MLP's
    forward, backward and update (synchronised on the card), the per-sample
    closures, the WMC gradients and the weight reassignment."""

    def __init__(self, sync):
        self.sync, self.ms, self.calls = sync, {}, {}

    def _add(self, key, t):
        self.ms[key] = self.ms.get(key, 0.0) + (time.perf_counter() - t) * 1e3
        self.calls[key] = self.calls.get(key, 0) + 1

    def timed(self, fn, key: str, synced: bool):
        def wrapped(*a, **k):
            if synced:
                self.sync()
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                if synced:
                    self.sync()
                self._add(key, t)

        return wrapped

    def __enter__(self):
        from kolibrie_tpu_torch.ml import runtime as R
        from kolibrie_tpu_torch.ml.mlp import MlpNeuralPredicate
        from kolibrie_tpu_torch.native.sdd_native import NativeSddManager
        from kolibrie_tpu_torch.reasoner.sdd import SddManager

        specs = [
            (R, "eval_select_to_table", "select", True),
            (R, "eval_where", "select", True),
            (R, "build_feature_vec", "features", False),
            (MlpNeuralPredicate, "predict", "forward", True),
            (MlpNeuralPredicate, "apply_gradients", "update", True),
            (R, "infer_new_facts_with_sdd_seed_specs", "closures", False),
            (R, "wmc_gradient_by_seed", "wmc_gradients", False),
            (SddManager, "set_weight", "reassign_weights", False),
            (NativeSddManager, "set_weight", "reassign_weights", False),
        ]
        self._saved = [(o, a, getattr(o, a)) for o, a, _k, _s in specs]
        self._saved.append((MlpNeuralPredicate, "forward_with_vjp",
                            MlpNeuralPredicate.forward_with_vjp))
        for (owner, attr, fn), (_o, _a, key, synced) in zip(self._saved, specs):
            setattr(owner, attr, self.timed(fn, key, synced))
        fwd = self._saved[-1][2]

        def forward_with_vjp(model, x):
            self.sync()
            t = time.perf_counter()
            probs, backward = fwd(model, x)
            self.sync()
            self._add("forward", t)
            return probs, self.timed(backward, "backward", True)

        MlpNeuralPredicate.forward_with_vjp = forward_with_vjp
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in self._saved:
            setattr(owner, attr, fn)
        return False


def profile_ml_statement(db, label: str, q: str) -> dict:
    """One statement under :class:`MlTimers`: its wall (synchronised), each
    step's ms and calls, and the rest of the wall outside them."""
    import torch

    from kolibrie_tpu_torch import execute_query_volcano

    with MlTimers(torch.cuda.synchronize) as timers:
        torch.cuda.synchronize()
        t = time.perf_counter()
        execute_query_volcano(q, db)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    rec = {"ml": label, "wall_ms": wall, "steps_ms": timers.ms, "calls": timers.calls,
           "rest_ms": wall - sum(timers.ms.values())}
    print(json.dumps(rec), flush=True)
    return rec


def profile_ml(dev, lubm) -> list:
    """Phase 12's statements (``chip_smoke.py`` 12b-12d) on clones of
    ``lubm``, each split by :class:`MlTimers`; the two TRAINs and the digit
    ML.PREDICT once more under ``torch.profiler`` (top device operations;
    busy share = device busy ms over the timed run's wall), each before the
    predictions that would make its seed facts pre-exist; then one epoch of
    the SDD TRAIN at ``ML_WHOLE_STORE_SAMPLES`` measurements with its
    reasoner over the premise facts and over the whole store (the
    reference's), for the per-sample closure's cost."""
    import tempfile

    import chip_smoke as CS
    from kolibrie_tpu_torch import execute_query_volcano
    from kolibrie_tpu_torch.ml import runtime as R
    from kolibrie_tpu_torch.ml.mlp import MlpNeuralPredicate

    def profiled(label, db, q, timed):
        rec = device_profile(lambda: execute_query_volcano(q, db))
        rec.update({"ml": label + " (profiled)",
                    "busy_share": rec["device_busy_ms"] / timed["wall_ms"]})
        print(json.dumps(rec), flush=True)
        return rec

    dbs = {"digit": lubm.clone(), "hot": lubm.clone()}
    dbs["digit"].parse_ntriples(CS.ml_digit_ntriples(CS.ML_SAMPLES, CS.ML_SEED))
    dbs["hot"].parse_ntriples(CS.ml_sensor_ntriples(CS.ML_MEASUREMENTS, CS.ML_SEED))
    for db in dbs.values():
        db.store.device_segment("spo")
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        digit = CS.ML_DIGIT_STATEMENT.replace("<save>", os.path.join(tmp, "digit.json"))
        dbs["digit"].trained_models["digit_model"] = MlpNeuralPredicate(
            2, [16], "exclusive", ["0", "1"], seed=CS.ML_SEED, device=dev)
        out.append(profile_ml_statement(dbs["digit"], "train_digit", digit))
        out.append(profiled("train_digit", dbs["digit"], digit, out[-1]))
        execute_query_volcano(CS.ML_ALERT_RULE, dbs["hot"])
        dbs["hot"].trained_models["hot2"] = MlpNeuralPredicate(
            1, [8], "binary", seed=CS.ML_SEED + 1, device=dev)
        out.append(profile_ml_statement(dbs["hot"], "train_hot", CS.ML_HOT_STATEMENT))
        out.append(profiled("train_hot", dbs["hot"], CS.ML_HOT_STATEMENT, out[-1]))
        for name in ("digit", "hot"):
            out.append(profile_ml_statement(dbs[name], f"ml_predict_{name}", CS.ML_PREDICT[name]))
        out.append(profiled("ml_predict_digit", dbs["digit"], CS.ML_PREDICT["digit"], out[-2]))
    del dbs
    small = lubm.clone()
    small.parse_ntriples(CS.ml_sensor_ntriples(ML_WHOLE_STORE_SAMPLES, CS.ML_SEED))
    execute_query_volcano(CS.ML_ALERT_RULE, small)
    one_epoch = CS.ML_HOT_STATEMENT.replace("EPOCHS 5", "EPOCHS 1")
    saved = R._premise_facts
    for label, premise in (("premise_facts", saved), ("whole_store", lambda store, rules: store)):
        small.trained_models["hot2"] = MlpNeuralPredicate(1, [8], "binary", seed=1, device=dev)
        R._premise_facts = premise
        try:
            rec = profile_ml_statement(small, f"sdd_one_epoch_{label}", one_epoch)
        finally:
            R._premise_facts = saved
        rec["closure_ms_per_sample"] = rec["steps_ms"]["closures"] / ML_WHOLE_STORE_SAMPLES
        print(json.dumps({"ml": label, "samples": ML_WHOLE_STORE_SAMPLES,
                          "closure_ms_per_sample": rec["closure_ms_per_sample"]}), flush=True)
        out.append(rec)
    return out

def rebind_turns(emp, texts, rounds: int = 4) -> dict:
    """13b's variants through the plan cache (every one a rebind) and
    uncached (``execute_combined`` of a fresh parse), in turns (cached,
    uncached, uncached, cached, ...), each pass after a full collection so
    that no pass inherits another's garbage; ms a query per pass and each
    pass's collections."""
    import gc

    import torch

    from chip_smoke import GcMeter
    from kolibrie_tpu_torch import execute_query_volcano
    from kolibrie_tpu_torch.query.executor import execute_combined
    from kolibrie_tpu_torch.query.parser import parse_combined_query

    passes = {
        "cached": lambda: [execute_query_volcano(t, emp) for t in texts],
        "uncached": lambda: [execute_combined(emp, parse_combined_query(t, emp.prefixes))
                             for t in texts],
    }
    rec = {"case": "13b_employee_rebind_turns", "cached_ms_per_query": [],
           "uncached_ms_per_query": [], "gc": {"cached": [], "uncached": []}}
    for r in range(rounds):
        for name in ("cached", "uncached") if r % 2 == 0 else ("uncached", "cached"):
            gc.collect()
            torch.cuda.synchronize()
            with GcMeter() as gcm:
                t = time.perf_counter()
                passes[name]()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) * 1e3
            rec[f"{name}_ms_per_query"].append(wall / len(texts))
            rec["gc"][name].append(gcm.summary())
    print(json.dumps(rec), flush=True)
    return rec


def profile_repeated(dev, lubm, emp) -> list:
    """Phase 13's layer on the card: per case, a warm run's wall
    (synchronised) and then its device profile."""
    import torch

    from benches.lubm import LUBM_Q2, LUBM_Q9
    from chip_smoke import (
        EMPLOYEE_QUERY,
        FLEET_QUERIES,
        FLEET_ROWS,
        TEMPLATE_VARIANTS,
        GcMeter,
        employee_template,
        fleet_ntriples,
        fleet_q,
    )
    from kolibrie_tpu_torch import SparqlDatabase, execute_query_volcano
    from kolibrie_tpu_torch.optimizer import mqo, plan_interp
    from kolibrie_tpu_torch.optimizer.device_engine import PreparedQuery
    from kolibrie_tpu_torch.query import executor as EX
    from kolibrie_tpu_torch.query.parser import parse_combined_query

    def measured(case: str, fn, queries: int = 1) -> dict:
        fn()  # warm: plan cache, capacities, kernel libraries
        torch.cuda.synchronize()
        with GcMeter() as gcm:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        prof = device_profile(fn)
        rec = {"case": case, "wall_ms": wall, "per_query_ms": wall / queries,
               "busy_share": prof["device_busy_ms"] / wall, "gc": gcm.summary(), **prof}
        print(json.dumps(rec), flush=True)
        return rec

    out = []
    for name, db, q in (("employee", emp, EMPLOYEE_QUERY), ("q2", lubm, LUBM_Q2),
                        ("q9", lubm, LUBM_Q9)):
        pq = PreparedQuery(db, q)
        pq.calibrate()
        out.append(measured(f"13a_{name}_prepared_run", pq.run))
        out.append(measured(f"13a_{name}_volcano", lambda: execute_query_volcano(q, db)))
    texts = [employee_template(i) for i in range(TEMPLATE_VARIANTS)]
    out.append(measured("13b_employee_solo", lambda: [execute_query_volcano(t, emp) for t in texts],
                        len(texts)))
    # the parent's path for the same variants (parse, plan, lower, run),
    # and what the cached path does instead of parsing: the plan cache's
    # bookkeeping of a rebind (host only)
    out.append(measured("13b_employee_uncached", lambda: [
        EX.execute_combined(emp, parse_combined_query(t, emp.prefixes)) for t in texts],
        len(texts)))
    out.append(rebind_turns(emp, texts))
    out.append(measured("13b_employee_parse", lambda: [
        parse_combined_query(t, emp.prefixes) for t in texts], len(texts)))
    out.append(measured("13b_employee_rebind_bookkeeping", lambda: [
        EX._plan_cache_entry(emp, t) for t in texts], len(texts)))
    out.append(measured("13b_employee_batched", lambda: EX.execute_queries_batched(emp, texts),
                        len(texts)))
    with plan_interp.override_mode("force"):
        out.append(measured("13c_employee_interp",
                            lambda: [execute_query_volcano(t, emp) for t in texts], len(texts)))
    fleet = SparqlDatabase(device=dev)
    fleet.parse_ntriples(fleet_ntriples(FLEET_ROWS))
    owners = [f"w{i}" for i in range(FLEET_QUERIES)]
    for o in owners:
        mqo.register_standing(fleet, o)

    def fire():
        for i, o in enumerate(owners):
            with mqo.standing_scope(fleet, o):
                execute_query_volcano(fleet_q(i), fleet)

    out.append(measured("13d_fleet_independent", fire, FLEET_QUERIES))
    with mqo.override_mqo_mode("force"):
        out.append(measured("13d_fleet_shared", fire, FLEET_QUERIES))
    return out


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
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
    if argv == ["resilience"]:
        from chip_smoke import breaker_counters, check_main_path, run_main_path, run_resilience_phase

        t = time.perf_counter()
        counters = breaker_counters()
        main_path = run_main_path(dev, queries)
        check_main_path(main_path["report"])
        setup_s = time.perf_counter() - t
        t = time.perf_counter()
        res = run_resilience_phase(dev, main_path, counters)
        print(card)
        print(json.dumps({"card": card, "setup_s": setup_s, "phase14_s": time.perf_counter() - t,
                          "launches": res["launches"], "resilience": res["report"]}, default=str))
        return 0
    if argv == ["repeated"]:
        lubm = next(db for name, db, _q, _w in queries if name == "q2")
        emp = next(db for name, db, _q, _w in queries if name == "employee")
        repeated = profile_repeated(dev, lubm, emp)
        print(card)
        print(json.dumps({"card": card, "repeated": repeated}))
        return 0
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
    provenance = profile_provenance(dev, lubm)
    crossover = profile_prov_crossover(dev)
    cross_window = profile_cross_window(dev)
    churn = profile_churn_sweep(dev)
    emp = next(db for name, db, _q, _w in queries if name == "employee")
    load = profile_load(dev, lubm, emp)
    ml = profile_ml(dev, lubm)
    repeated = profile_repeated(dev, lubm, emp)
    print(card)
    print(json.dumps({"card": card, "queries": out, "closure": closure, "rsp": rsp,
                      "statements": statements, "provenance": provenance,
                      "prov_crossover": crossover, "cross_window": cross_window,
                      "churn_sweep": churn, "load": load, "ml": ml, "repeated": repeated}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
