"""The port's RSP engine on the CityBench stream against the benchmark's plain
reference (``portbench/reference/rsp.py``), on the CPU.

The ``citybench`` configuration cut to 720 roads and 180 lots, at the
published windows (traffic RANGE 120, parking RANGE 180, STEP 60): every
cycle the engine emits, the warm-up's partial windows included, equals the
reference's rows for that cycle as a bag, in incremental and naive mode and
through the device tagged fixpoint (the route the CUDA card takes, patched
in here).  At 600 roads and 150 lots, ticks 150-179 (mod 180) carry no
parking event: the naive mode still equals the reference and both modes
equal the JAX package's engine, but a cycle's time is the newest event of
the window drained last (the parking window's, 29 ticks behind), so
incremental SDS+ keeps readings whose window has moved past them, in
both packages; that case is pinned as an expected failure.  Then a
ten-tick stream written out by hand pins the windows' firing trace, which
ticks fire with what content, and each cycle's rows.
Last, the spans a cycle records, their nesting and attributes, and the
cycle counter."""

from __future__ import annotations

import gc
import json
from collections import Counter

import numpy as np
import pytest
import torch

from kolibrie_tpu.rsp.builder import RSPBuilder as RefBuilder
from kolibrie_tpu.rsp.s2r import WindowTriple as RefWT
from kolibrie_tpu_torch.obs import spans
from kolibrie_tpu_torch.reasoner import device_provenance as DP
from kolibrie_tpu_torch.reasoner import provenance_seminaive as PS
from kolibrie_tpu_torch.rsp import engine as rsp_engine
from kolibrie_tpu_torch.rsp.builder import RSPBuilder
from kolibrie_tpu_torch.rsp.s2r import CSPARQLWindow, WindowTriple
from portbench import spec
from portbench.reference.rsp import Cycles
from portbench.stream_gen import CityStream
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

CPU = torch.device("cpu")
QUERY = spec.query_text("citybench")
SEEDS = (7, 2**31 + 11, 2**33 + 5)


def small_config(**over) -> dict:
    config = json.loads((spec.HERE / "configs" / "citybench.json").read_text())
    config.update({"roads": 720, "lots": 180, **over})
    return config


def _on_device(reasoner, provenance, tag_store=None, initial_delta=None, round1_old_store=None):
    """The route the CUDA card takes, on the CPU: the device tagged
    fixpoint, which must accept the program."""
    if tag_store is None:
        tag_store = PS.seed_tag_store(reasoner, provenance)
    assert DP.infer_provenance_device(reasoner, provenance, tag_store, initial_delta) is not None
    return tag_store


def drive(config, stream, ticks, mode, query=QUERY, package="port"):
    """The engine of ``package`` (``port``, or ``jax`` for the JAX
    package's) fed ``stream``'s ticks 1..``ticks``: ``[(tick, rows)]``, one
    entry a tick in which the consumer got rows."""
    builder, wt = ((RSPBuilder(query, device=CPU), WindowTriple) if package == "port"
                   else (RefBuilder(query), RefWT))
    sink = []
    engine = (builder.set_cross_window_rules(config["cross_window_rules"])
              .set_cross_window_reasoning_mode(mode).with_consumer(sink.append).build())
    out = []
    for tick in range(1, ticks + 1):
        n = len(sink)
        for iri, s, p, o in stream.events(tick):
            engine.add_to_stream(iri, wt(s, p, o), tick)
        if len(sink) > n:
            out.append((tick, sink[n:]))
    engine.stop()
    return out


@pytest.mark.parametrize("mode", ["incremental", "naive", "device"])
@pytest.mark.parametrize("seed", SEEDS)
def test_engine_matches_the_reference(monkeypatch, seed, mode):
    if mode == "device":
        monkeypatch.setattr(PS, "infer_with_provenance", _on_device)
    config = small_config()
    got = drive(config, CityStream(config, seed), 421,
                "incremental" if mode == "device" else mode)
    ref = Cycles(config, QUERY, seed)
    assert [t // 60 * 60 for t, _ in got] == ref.closes(421)
    for tick, rows in got:
        want = ref.answer(tick // 60 * 60)
        assert Counter(rows) == want, tick
    # full-width cycles hold every lot's road once
    assert len(got[-1][1]) == 180
    if mode == "device":
        assert DP.LAST_RUN["rounds"] >= 1


# ---------------------------------------------- quiet ticks on the parking stream

#: 150 lots over a parking period of 180 ticks: ticks 150-179 (mod 180) carry no parking event
QUIET = {"roads": 600, "lots": 150}


def _check_against_the_reference(config, seed, got):
    ref = Cycles(config, QUERY, seed)
    assert [t // 60 * 60 for t, _ in got] == ref.closes(421)
    for tick, rows in got:
        assert Counter(rows) == ref.answer(tick // 60 * 60), tick


@pytest.mark.parametrize("seed", SEEDS)
def test_quiet_parking_ticks_naive_matches_the_reference(seed):
    config = small_config(**QUIET)
    got = drive(config, CityStream(config, seed), 421, "naive")
    _check_against_the_reference(config, seed, got)
    # the first full parking window misses lot 0 (its tick 0 was never sent)
    assert [len(rows) for t, rows in got if t > 180] == [149, 150, 150, 150, 150]


@pytest.mark.parametrize("mode", ["incremental", "naive"])
def test_quiet_parking_ticks_match_the_jax_engine(mode):
    config = small_config(**QUIET)
    stream = CityStream(config, SEEDS[0])
    port, ref = (drive(config, stream, 421, mode, package=p) for p in ("port", "jax"))
    assert [(t, Counter(rows)) for t, rows in port] == [(t, Counter(rows)) for t, rows in ref]


@pytest.mark.xfail(strict=True, reason=(
    "a cycle's time is the newest event time of the windows drained in the push that "
    "completes it, here the parking window's (149 at the close of 180, 329 at 360), so "
    "incremental SDS+ keeps traffic readings older than their window (184 rows "
    "against naive's 149 and 150); the JAX package's engine gives the same rows "
    "(test_quiet_parking_ticks_match_the_jax_engine)"))
def test_quiet_parking_ticks_incremental_matches_naive():
    config = small_config(**QUIET)
    stream = CityStream(config, SEEDS[0])
    incremental, naive = (drive(config, stream, 421, m) for m in ("incremental", "naive"))
    assert [(t, Counter(rows)) for t, rows in incremental] == [
        (t, Counter(rows)) for t, rows in naive]


# ------------------------------------------------------- ten ticks by hand

TRAFFIC, PARKING = "http://city/traffic", "http://city/parking"
HAND = {
    1: [(TRAFFIC, "road_0", '"50"'), (PARKING, "lot_0", "road_0")],
    2: [(TRAFFIC, "road_1", '"30"'), (PARKING, "lot_1", "road_1")],
    3: [(TRAFFIC, "road_0", '"45"'), (TRAFFIC, "road_2", '"20"'), (PARKING, "lot_0", "road_0")],
    4: [(TRAFFIC, "road_1", '"30"'), (PARKING, "lot_2", "road_2")],
    5: [(TRAFFIC, "road_2", '"25"'), (PARKING, "lot_1", "road_1")],
    6: [(TRAFFIC, "road_0", '"60"'), (PARKING, "lot_3", "road_3")],
    7: [(TRAFFIC, "road_3", '"10"'), (PARKING, "lot_2", "road_2")],
    8: [(TRAFFIC, "road_1", '"35"'), (PARKING, "lot_0", "road_0")],
    9: [(TRAFFIC, "road_2", '"20"'), (PARKING, "lot_3", "road_3")],
    10: [(TRAFFIC, "road_3", '"15"'), (PARKING, "lot_1", "road_1"),
         (PARKING, "lot_2", "road_2")],
}
#: the published query's shape at RANGE 4 and 6, STEP 2
HAND_QUERY = QUERY.replace("RANGE 120 STEP 60", "RANGE 4 STEP 2").replace(
    "RANGE 180 STEP 60", "RANGE 6 STEP 2")
PRED = {TRAFFIC: "avgSpeed", PARKING: "nearRoad"}

#: each window's firings: the tick that fires it and its content, (subject,
#: object) -> newest timestamp
FIRINGS = {
    TRAFFIC: [
        (2, {("road_0", '"50"'): 1}),
        (4, {("road_0", '"50"'): 1, ("road_1", '"30"'): 2, ("road_0", '"45"'): 3,
             ("road_2", '"20"'): 3}),
        (6, {("road_1", '"30"'): 4, ("road_0", '"45"'): 3, ("road_2", '"20"'): 3,
             ("road_2", '"25"'): 5}),
        (8, {("road_1", '"30"'): 4, ("road_2", '"25"'): 5, ("road_0", '"60"'): 6,
             ("road_3", '"10"'): 7}),
        (10, {("road_0", '"60"'): 6, ("road_3", '"10"'): 7, ("road_1", '"35"'): 8,
              ("road_2", '"20"'): 9}),
    ],
    PARKING: [
        (2, {("lot_0", "road_0"): 1}),
        (4, {("lot_0", "road_0"): 3, ("lot_1", "road_1"): 2}),
        (6, {("lot_0", "road_0"): 3, ("lot_1", "road_1"): 5, ("lot_2", "road_2"): 4}),
        (8, {("lot_1", "road_1"): 5, ("lot_0", "road_0"): 3, ("lot_2", "road_2"): 7,
             ("lot_3", "road_3"): 6}),
        (10, {("lot_2", "road_2"): 7, ("lot_1", "road_1"): 5, ("lot_3", "road_3"): 9,
              ("lot_0", "road_0"): 8}),
    ],
}


class HandStream:
    """:data:`HAND` in the generator's interface (``columns``, ``count``,
    ``term``, ``events``)."""

    def __init__(self):
        self.terms = sorted({t for evs in HAND.values() for _, s, o in evs for t in (s, o)})
        self.ids = {t: i for i, t in enumerate(self.terms)}

    def events(self, tick):
        return [(st, s, PRED[st], o) for st, s, o in HAND.get(tick, ())]

    def count(self, tick):
        return len(HAND.get(tick, ()))

    def term(self, i):
        return self.terms[i]

    def columns(self, tick):
        out = {}
        for st in (TRAFFIC, PARKING):
            evs = [(self.ids[s], self.ids[o]) for x, s, o in HAND.get(tick, ()) if x == st]
            out[st] = (np.array([e[0] for e in evs], dtype=np.int64), PRED[st],
                       np.array([e[1] for e in evs], dtype=np.int64))
        return out


def test_the_firing_trace_of_ten_ticks():
    width = {TRAFFIC: (4, 2), PARKING: (6, 2)}
    for stream, want in FIRINGS.items():
        win = CSPARQLWindow(*width[stream])
        fired, now = [], [0]
        win.register_callback(lambda c: fired.append(
            (now[0], {(t.s, t.o): ts for t, ts in c.iter_with_timestamps()})))
        for tick in range(1, 11):
            now[0] = tick
            for st, s, p, o in HandStream().events(tick):
                if st == stream:
                    win.add_to_window(WindowTriple(s, p, o), tick)
        assert fired == want, stream
    # the reference's windows hold the same
    hand = HandStream()
    ref = Cycles(small_config(), HAND_QUERY, 0, stream=hand)
    for stream, want in FIRINGS.items():
        iri = "http://city/wT/" if stream == TRAFFIC else "http://city/wP/"
        for tick, content in want:
            c, _ = ref.content(tick, iri)
            got = {(hand.term(s), hand.term(o)): e
                   for s, o, e in zip(c.s.tolist(), c.o.tolist(), c.exp.tolist())}
            assert got == content, (stream, tick)


@pytest.mark.parametrize("mode", ["incremental", "naive"])
def test_the_cycles_of_ten_ticks(mode):
    hand = HandStream()
    got = drive(small_config(), hand, 10, mode, HAND_QUERY)
    ref = Cycles(small_config(), HAND_QUERY, 0, stream=hand)
    # a cycle emits in the push after its last window fired: the next
    # tick's first, or at tick 10 its second parking event
    assert [t for t, _ in got] == [3, 5, 7, 9, 10]
    for tick, rows in got:
        assert Counter(rows) == ref.answer(tick // 2 * 2), tick
    # the cycle at tick 8: each road's one reading in [4, 8) beside its lot
    assert sorted(got[3][1]) == sorted([
        (("lot", "lot_0"), ("road", "road_0"), ("speed", "60")),
        (("lot", "lot_1"), ("road", "road_1"), ("speed", "30")),
        (("lot", "lot_2"), ("road", "road_2"), ("speed", "25")),
        (("lot", "lot_3"), ("road", "road_3"), ("speed", "10")),
    ])


@pytest.mark.parametrize("enabled", [True, False])
def test_a_cycle_pauses_the_collector(enabled):
    """The collector is off while a cycle runs, the consumer's call
    included, and as the caller left it between cycles."""
    seen = []
    engine = (RSPBuilder(HAND_QUERY, device=CPU)
              .set_cross_window_rules(small_config()["cross_window_rules"])
              .with_consumer(lambda row: seen.append(gc.isenabled())).build())
    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        between = []
        for tick in range(1, 11):
            for iri, s, p, o in HandStream().events(tick):
                engine.add_to_stream(iri, WindowTriple(s, p, o), tick)
                between.append(gc.isenabled())
    finally:
        engine.stop()
        (gc.enable if was else gc.disable)()
    assert seen and not any(seen)
    assert set(between) == {enabled}


# --------------------------------------------------------------- the spans


def _kids(recs):
    out = {}
    for s in recs:
        out.setdefault(s["parent_id"], []).append(s)
    return out


@pytest.mark.parametrize("mode", ["incremental", "naive"])
def test_a_cycle_records_its_spans_and_counts(monkeypatch, mode):
    monkeypatch.setattr(PS, "infer_with_provenance", _on_device)
    spans.set_ring_capacity(1 << 16)
    spans.clear()
    before = rsp_engine._CW_CYCLES.labels(mode).value
    config = small_config()
    got = drive(config, CityStream(config, 3), 301, mode)
    recs = spans.spans_snapshot()
    spans.set_ring_capacity(spans.DEFAULT_RING_CAPACITY)
    assert rsp_engine._CW_CYCLES.labels(mode).value - before == len(got) == 5
    kids = _kids(recs)
    cycles = [s for s in recs if s["name"] == "rsp.cw.cycle"]
    assert len(cycles) == len(got)
    for cyc, (tick, rows) in zip(cycles, got):
        a = cyc["attrs"]
        assert a["mode"] == mode and a["rows"] == len(rows) and a["ts"] == tick // 60 * 60 - 1
        assert a["facts"] > 0
        names = [k["name"] for k in kids[cyc["span_id"]]]
        assert names == ["rsp.cw.sds", "sds.reason", "rsp.cw.query"]
        sds, reason, query = kids[cyc["span_id"]]
        assert sds["attrs"]["triples"] > 0 and 0 < sds["attrs"]["new"] <= sds["attrs"]["triples"]
        r = reason["attrs"]
        assert r["mode"] == mode and r["facts"] >= r["d_new"] > 0 and r["derived"] > 0
        assert query["attrs"]["rows"] > 0
        inner = kids.get(reason["span_id"], [])
        if mode == "naive":
            # the naive closure is the host strategy
            assert not inner
            assert r["facts"] == r["d_new"]
            continue
        assert [k["name"] for k in inner] == ["provenance.fixpoint"]
        fx = inner[0]
        rounds = kids[fx["span_id"]]
        assert {k["name"] for k in rounds} == {"provenance.round"}
        assert fx["attrs"]["rounds"] + fx["attrs"]["attempts"] == len(rounds)
        assert fx["attrs"]["semiring"] == "expiration"
        for rd in rounds:
            assert rd["attrs"]["kind"] == "round" and "code" in rd["attrs"]
            waits = kids[rd["span_id"]]
            assert [(w["name"], w["attrs"]["site"]) for w in waits] == [
                ("device.wait", "provenance.round")]
    # never a span an event: only the windows' firings besides the cycles
    per_event = {s["name"] for s in recs} - {
        "rsp.window.fire", "rsp.cw.cycle", "rsp.cw.sds", "sds.reason", "rsp.cw.query",
        "provenance.fixpoint", "provenance.round", "device.wait"}
    assert sum(1 for s in recs if s["name"] in per_event) <= 10 * len(got), per_event
