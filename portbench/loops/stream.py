"""Traffic of sensor events in a closed loop through the RSP engine: the
configuration's REGISTER query with its cross-window rules
(``RSPBuilder(query).set_cross_window_rules(rules)
.set_cross_window_reasoning_mode(mode)``, single-thread), each tick's
events pushed through ``add_to_stream`` one after another, each as soon
as the last push returns.  A cycle completes when the consumer receives
its rows, in the push after the last window of the cycle has fired.

Set-up builds the engine and pushes ticks 1 to ``warmup_ticks``: both
windows at full width and at least one full-width cycle.  It then draws
the window's ticks ahead, as term strings (twice the ticks the warm-up's
last cycle would push in the window, and the widest RANGE besides), so
that the window times the pushes alone: each event's ``WindowTriple`` is
built as it is pushed, as a client builds what it sends.  The window
pushes on until ``--seconds`` have passed and the next cycle has emitted
(or, if none emits, the widest RANGE and one STEP more).
``queries_per_s`` is the cycles completed over the window, the last
completion included: each cycle answers the registered query once.  The
loop leaves the garbage collector's settings as the process has them,
and runs one full collection at the end of set-up.

``correct`` compares every cycle's rows, the warm-up's and the window's,
with the reference's rows for the same cycle as bags
(``rows_mismatched``: rows in one and not the other, summed over the
cycles; a cycle the engine did not emit counts all the reference's rows).
The control is the reference fed the stream with every 100th event lost."""

from __future__ import annotations

import gc
import math
import time
from collections import Counter
from types import SimpleNamespace
from typing import Dict, List

import numpy as np

from portbench import spec
from portbench.check import bag_mismatch, verdict
from portbench.harness import Probe, log, sync
from portbench.reference.rsp import Cycles
from portbench.stream_gen import CityStream

LIMITS = {"rows_mismatched": 0}
CONTROL = ("the reference fed the stream with every 100th event lost, "
           "as an engine that drops events would")

#: the harness's fixed ``check.Reference`` reads a graph; this cell has none
NO_GRAPH = SimpleNamespace(terms=[], s=np.empty(0, np.uint32), p=np.empty(0, np.uint32),
                           o=np.empty(0, np.uint32))


def run(c: dict, seed: int, seconds: float, traced: bool, dev) -> dict:
    from kolibrie_tpu_torch.reasoner import device_provenance
    from kolibrie_tpu_torch.rsp.builder import RSPBuilder
    from kolibrie_tpu_torch.rsp.s2r import WindowTriple

    config, traffic = c["config"], c["traffic"]
    stream = CityStream(config, seed)
    names = stream.terms()
    sink: list = []
    t = time.perf_counter()
    engine = (
        RSPBuilder(spec.query_text(config["query"]), device=dev)
        .set_cross_window_rules(config["cross_window_rules"])
        .set_cross_window_reasoning_mode(config["reasoning_mode"])
        .with_consumer(sink.append)
        .build()
    )
    load_s = time.perf_counter() - t
    step = max(w.slide for w in engine.window_configs)
    widest = max(w.width for w in engine.window_configs)
    batches: List[dict] = []
    last_run = [device_provenance.LAST_RUN["dispatches"]]

    def draw(tick: int) -> list:
        """``tick``'s events in push order, as ``(stream IRI, predicate,
        subjects, objects)`` with the terms as the stream carries them."""
        return [(iri, p, tuple(map(names.__getitem__, s.tolist())),
                 tuple(map(names.__getitem__, o.tolist())))
                for iri, (s, p, o) in stream.columns(tick).items()]

    def push(tick: int, events: list):
        """Pushes ``tick``'s events; the time the consumer got a cycle's
        rows during them, or None."""
        n = len(sink)
        done = None
        for iri, p, subjects, objects in events:
            for s, o in zip(subjects, objects):
                engine.add_to_stream(iri, WindowTriple(s, p, o), tick)
                if done is None and len(sink) != n:
                    done = time.perf_counter()
        if done is not None:
            # the device tagged fixpoint resets LAST_RUN each time it runs
            run_ = device_provenance.LAST_RUN
            on_device = run_["dispatches"] is not last_run[0] and run_["rounds"] > 0
            last_run[0] = run_["dispatches"]
            batches.append({
                "tick": tick, "rows": sink[n:], "n_rows": len(sink) - n, "done": done,
                "windows": {k: len(v) for k, v in engine._latest_contents.items()},
                "device": on_device, "rounds": run_["rounds"], "attempts": run_["attempts"],
            })
            del sink[:]
        return done

    warm = int(traffic["warmup_ticks"])
    for tick in range(1, warm + 1):
        if tick == warm - step + 1:
            t = time.perf_counter()
        push(tick, draw(tick))
    sync(dev)
    last_step_s = time.perf_counter() - t
    if not batches:
        raise RuntimeError("no cycle emitted during the warm-up")
    for b in batches:
        log(f"warm-up cycle at tick {b['tick']}: {b['n_rows']} rows, windows {b['windows']}, "
            f"device tagged fixpoint {b['device']} ({b['rounds']} rounds)")
    warm_batches = len(batches)
    ahead = 2 * math.ceil(seconds * step / last_step_s) + widest + step
    drawn = {t: draw(t) for t in range(warm + 1, warm + ahead + 1)}
    # every run starts its window from the same collector state, with the
    # set-up's garbage gone
    gc.collect()
    ready = time.perf_counter()
    events, late_draws = 0, 0
    with Probe(traced, dev) as probe:
        t0 = time.perf_counter()
        tick, late = warm, None
        while True:
            tick += 1
            tick_events = drawn.pop(tick, None)
            if tick_events is None:
                late_draws += 1
                tick_events = draw(tick)
            events += stream.count(tick)
            done = push(tick, tick_events)
            if time.perf_counter() - t0 >= seconds:
                if done is not None:
                    break
                late = tick if late is None else late
                if tick - late >= widest + step:
                    break
        window = batches[warm_batches:]
        elapsed = (window[-1]["done"] if window else time.perf_counter()) - t0
    engine.stop()
    log(f"window: {len(window)} cycles, {events} events in {elapsed:.3f} s, "
        f"{events / elapsed:.1f} events/s; {ahead} ticks drawn ahead, "
        f"{late_draws} drawn in the window")
    for b in window:
        log(f"cycle at tick {b['tick']}: {b['n_rows']} rows, windows {b['windows']}, "
            f"device tagged fixpoint {b['device']} ({b['rounds']} rounds, "
            f"{b['attempts']} retried)")
    # the cycles due in the window: those after the warm-up's last, to the
    # last tick (a cycle closing at the last tick may emit in the next)
    closes = Cycles(config, spec.query_text(config["query"]), seed).closes(tick)
    answered = {_close(closes, b["tick"]) for b in window}
    after = _close(closes, batches[warm_batches - 1]["tick"])
    due = [t for t in closes if t > after and (t < tick or t in answered)]
    return {
        "graph": NO_GRAPH,
        "ready": ready,
        "load_s": load_s,
        "attempted": len(due),
        "failed": len(set(due) - answered),
        "e2e": {"queries_per_s": len(window) / elapsed},
        "seed": seed,
        "last_tick": tick,
        "batches": batches,
        "probe": probe,
        "requests": len(window),
        "readings": {"window_s": elapsed, "events": events},
        "db": engine,
    }


def _close(closes: List[int], tick: int) -> int:
    """The cycle a batch that arrived at ``tick`` answers: the latest close
    at or before it (0 before the first)."""
    return max((c for c in closes if c <= tick), default=0)


def _by_cycle(batches: List[dict], closes: List[int]) -> Dict[int, Counter]:
    """Each batch's rows under the cycle it answers."""
    out: Dict[int, Counter] = {}
    for b in batches:
        out.setdefault(_close(closes, b["tick"]), Counter()).update(b["rows"])
    return out


def judge(c: dict, out: dict, ref) -> Dict[str, dict]:
    """``ref`` is the harness's graph reference, which this cell has no use
    for; the cycles' reference is built from the seed."""
    config = c["config"]
    cycles = Cycles(config, spec.query_text(config["query"]), out["seed"])
    last = out["last_tick"]
    closes = cycles.closes(last)
    got = _by_cycle(out["batches"], closes)
    # a cycle closing at the last tick may emit in the tick after it
    due = [t for t in closes if t < last or t in got]
    mismatched = sum(bag_mismatch(got.get(t, Counter()).elements(), cycles.answer(t))
                     for t in due)
    mismatched += sum(sum(rows.values()) for t, rows in got.items() if t not in due)
    return verdict({"rows_mismatched": mismatched}, LIMITS)


def control(c: dict, out: dict) -> dict:
    """``out`` with each batch's rows replaced by the control's answer for
    its cycle."""
    config = c["config"]
    weak = Cycles(config, spec.query_text(config["query"]), out["seed"], lose_every=100)
    closes = weak.closes(out["last_tick"])
    batches = []
    for b in out["batches"]:
        close = _close(closes, b["tick"])
        answer = list(weak.answer(close).elements()) if close else []
        batches.append(dict(b, rows=answer, n_rows=len(answer)))
    return dict(out, batches=batches)
