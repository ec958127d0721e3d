"""Where the PyTorch port's main-path queries spend their time, on one CUDA
card.

    python3 chip_profile.py

Builds the same data and queries as ``chip_smoke.py`` (employee-100K join,
LUBM-1000 Q2, Q9, Q9 under ``KOLIBRIE_WCOJ=off``).  For each query: one
cold run (capacity convergence), one warm run with timers around planning
(``Streamertail.find_best_plan``), the device engine (``LoweredPlan.execute``,
synchronised) and result decoding (``format_results``), then a second warm
run under ``torch.profiler`` for the device's busy time (``busy_share`` is
that over the timed run's wall) and the operators whose kernels took the
most of it.  Then the same for the reasoner's LUBM-1000 closure
(``chip_smoke.py`` phase 6): one cold run, one warm run with a timer
around every device round (``device_fixpoint._fixpoint_round``, which ends
in the round's one host read), then a warm run under ``torch.profiler``.
Prints one JSON object per query and one for the closure, the card's name
and power limit, and last one JSON object with every breakdown.  It checks
nothing: ``chip_smoke.py`` does.
"""

from __future__ import annotations

import json
import os
import sys
import time


def profile_query(name: str, db, sparql: str, wcoj: str) -> dict:
    import torch

    from kolibrie_tpu_torch import execute_query_volcano
    from kolibrie_tpu_torch.optimizer import device_engine as DE
    from kolibrie_tpu_torch.optimizer import planner as PL
    from kolibrie_tpu_torch.query import executor as EX

    spent = {}

    def timed(phase, fn):
        def wrapped(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                if phase == "engine":
                    torch.cuda.synchronize()
                spent[phase] = spent.get(phase, 0.0) + (time.perf_counter() - t) * 1e3

        return wrapped

    os.environ["KOLIBRIE_WCOJ"] = wcoj
    try:
        execute_query_volcano(sparql, db)  # cold: capacity convergence
        orig = (PL.Streamertail.find_best_plan, DE.LoweredPlan.execute, EX.format_results)
        PL.Streamertail.find_best_plan = timed("plan", orig[0])
        DE.LoweredPlan.execute = timed("engine", orig[1])
        EX.format_results = timed("format", orig[2])
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            rows = execute_query_volcano(sparql, db)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        finally:
            PL.Streamertail.find_best_plan, DE.LoweredPlan.execute, EX.format_results = orig
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from chip_smoke import build_queries, card_line
    from torch.profiler import ProfilerActivity, profile

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
    closure = profile_closure(next(db for name, db, _q, _w in queries if name == "q2"))
    print(json.dumps(closure), flush=True)
    print(card)
    print(json.dumps({"card": card, "queries": out, "closure": closure}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
