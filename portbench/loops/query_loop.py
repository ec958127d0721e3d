"""Traffic of one client in a closed loop: the mix's queries (``queries``)
in turn through ``execute_query_volcano``, each waiting on the last, over
a plain store of the generated graph.  ``queries_per_s`` is the queries
completed over the window, the last completion included.

``correct`` compares rows against the reference's rows for the same
text, as bags (``rows_mismatched``: rows in one and not the other, summed
over the answers compared): the first answer of each query and a share
(``keep_share``) of the others, drawn from the seed before the window
opens.  The control is the reference answering over the graph with every
100th triple lost, as a store that drops writes would."""

from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np

from portbench import spec
from portbench.check import Reference, bag_mismatch, verdict
from portbench.harness import Probe, graph, log, sync

LIMITS = {"rows_mismatched": 0}
CONTROL = ("the reference answering over the graph with every 100th triple lost, "
           "as a store that drops writes would")


def run(c: dict, seed: int, seconds: float, traced: bool, dev) -> dict:
    from kolibrie_tpu_torch import SparqlDatabase, execute_query_volcano

    config, traffic = c["config"], c["traffic"]
    names = traffic["queries"]
    g = graph(config, seed, names)
    t = time.perf_counter()
    db = SparqlDatabase.from_arrays(g.terms, g.s, g.p, g.o, device=dev)
    db.store.columns()
    db.store.device_segment("spo")
    sync(dev)
    load_s = time.perf_counter() - t
    log(f"store: {len(db)} triples loaded in {load_s:.2f} s")
    texts = [spec.query_text(q) for q in names]
    for name, text in zip(names, texts):
        for label in ("cold", "warm"):
            t = time.perf_counter()
            rows = execute_query_volcano(text, db)
            log(f"warm-up {name} {label}: {len(rows)} rows, {time.perf_counter() - t:.3f} s")
    # the answers the reference reads: the first of each query and a
    # share drawn from the seed; the others are dropped as they arrive
    keep = np.random.default_rng([int(seed) & ((1 << 64) - 1), 3]).random(1 << 16) < float(traffic["keep_share"])
    keep[: len(texts)] = True
    gc.collect()
    ready = time.perf_counter()
    done = []
    with Probe(traced, dev) as probe:
        t0 = time.perf_counter()
        i = 0
        while not done or time.perf_counter() - t0 < seconds:
            k = i % len(texts)
            ts = time.perf_counter()
            rows = execute_query_volcano(texts[k], db)
            done.append({"query": k, "n": len(rows), "rows": rows if keep[i % len(keep)] else None,
                         "latency_s": time.perf_counter() - ts})
            i += 1
        elapsed = time.perf_counter() - t0
    for k, name in enumerate(names):
        lat = [d["latency_s"] for d in done if d["query"] == k]
        if lat:
            log(f"{name}: {len(lat)} runs, median {np.median(lat):.3f} s")
    return {
        "graph": g,
        "ready": ready,
        "load_s": load_s,
        "attempted": len(done),
        "failed": 0,
        "e2e": {"queries_per_s": len(done) / elapsed},
        "texts": texts,
        "done": done,
        "probe": probe,
        "requests": len(done),
        "readings": {},
        "db": db,
    }


def judge(c: dict, out: dict, ref: Reference) -> Dict[str, dict]:
    return verdict({"rows_mismatched": sum(
        bag_mismatch(d["rows"], ref.answer(out["texts"][d["query"]]))
        for d in out["done"] if d["rows"] is not None)}, LIMITS)


def control(c: dict, out: dict) -> dict:
    """``out`` with the control's rows in place of every answer kept."""
    weak = Reference(c["config"], out["graph"], lose_every=100)
    rows = {k: weak.rows(t) for k, t in enumerate(out["texts"])}
    return dict(out, done=[dict(d, rows=rows[d["query"]]) if d["rows"] is not None else d
                           for d in out["done"]])
