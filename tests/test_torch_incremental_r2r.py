"""The PyTorch port's ``IncrementalR2R`` against the JAX package's, on the
CPU.

``benches/bench_r2r_incremental.py``'s stream (a random ``knows`` window of
500 or 2,000 triples sliding by 50 a firing, 12 firings, the 2-hop
``reach`` rule) goes through both packages' ``IncrementalR2R`` and the
port's ``SimpleR2R``: the derived sets are equal at every firing, once with
the port's closure on the host loop (the CPU route) and once through
``infer_provenance_device`` (the route the CUDA card takes from
``AUTO_MIN_FACTS`` facts), patched in the test.  The window bookkeeping
(the buckets, the prune clock ``_now``, the carried expiries) must equal
the reference's after every firing.  Mirrors of ``tests/test_rsp.py``'s
incremental cases: a derived fact expiring with its premise, the legacy
add/remove surface, and a triple shared by two windows' buckets (:945);
and the engine's ``set_r2r_mode("incremental")``.
"""

from __future__ import annotations

import random

import pytest
import torch

import kolibrie_tpu_torch as port
from kolibrie_tpu.rsp.builder import RSPBuilder as RefBuilder
from kolibrie_tpu.rsp.r2r import IncrementalR2R as RefIncremental
from kolibrie_tpu.rsp.r2r import SimpleR2R as RefSimple
from kolibrie_tpu.rsp.s2r import WindowTriple as RefWT
from kolibrie_tpu_torch.reasoner import device_provenance as DP
from kolibrie_tpu_torch.reasoner import provenance_seminaive as PS
from kolibrie_tpu_torch.rsp.r2r import IncrementalR2R, SimpleR2R
from test_torch_clauses import port_device_program  # noqa: F401  (a fixture)
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

CPU = torch.device("cpu")
RULES = """@prefix s: <http://c/> .
{ ?a s:knows ?b . ?b s:knows ?c . } => { ?a s:reach ?c . } .
"""
STEP = 50
FIRINGS = 12


def _decode_set(r, triples):
    dec = r.db.dictionary.decode
    return sorted((dec(t.subject), dec(t.predicate), dec(t.object)) for t in triples)


def _stream(win_size: int, WT):
    """``benches/bench_r2r_incremental.py:45-85``: the first window and
    each firing's window content (``(item, event_ts)`` pairs)."""
    rng = random.Random(3)

    def mk():
        return WT(f"<http://c/p{rng.randrange(win_size)}>", "<http://c/knows>",
                  f"<http://c/p{rng.randrange(win_size)}>")

    win = [(mk(), i) for i in range(win_size)]
    deltas = [[(mk(), 0) for _ in range(STEP)] for _ in range(FIRINGS)]
    now, out = win_size, []
    for f in range(FIRINGS):
        fresh = [(it, now + j) for j, (it, _) in enumerate(deltas[f])]
        now += STEP
        win = win[STEP:] + fresh
        out.append(list(win))
    return out


def _bookkeeping(r) -> dict:
    dec = r.db.dictionary.decode

    def d(k):
        return tuple(dec(x) for x in k)

    return {
        "now": r._now,
        "buckets": {w: sorted((d(k), e) for k, e in b.items()) for w, b in r._buckets.items()},
        "tags": sorted((d(k), e) for k, e in r._tags.items()),
        "db": sorted(d(k) for k in r.db.store.triples_set()),
    }


def _drive(win_size: int) -> dict:
    ref, inc, host = RefIncremental(), IncrementalR2R(device=CPU), SimpleR2R(device=CPU)
    for r in (ref, inc, host):
        r.load_rules(RULES)
    ref_windows, port_windows = _stream(win_size, RefWT), _stream(win_size, port.WindowTriple)
    prev: list = []
    trace = []
    for wr, wp in zip(ref_windows, port_windows):
        ref.feed_window("w", win_size, iter(wr))
        want = _decode_set(ref, ref.materialize_incremental())
        inc.feed_window("w", win_size, iter(wp))
        got = _decode_set(inc, inc.materialize_incremental())
        for t in prev:
            host.remove(t)
        prev = [it for it, _ in wp]
        for it in prev:
            host.add(it)
        assert got == want == _decode_set(host, host.materialize())
        assert _bookkeeping(inc) == _bookkeeping(ref)
        trace.append(len(got))
    return trace


@pytest.mark.parametrize("win_size", [500, 2000])
def test_stream_matches_reference_on_the_host_loop(win_size):
    trace = _drive(win_size)
    assert min(trace) > 0


def _on_device(reasoner, provenance, tag_store=None, initial_delta=None, round1_old_store=None):
    if tag_store is None:
        tag_store = PS.seed_tag_store(reasoner, provenance)
    assert DP.infer_provenance_device(reasoner, provenance, tag_store, initial_delta) is not None
    return tag_store


@pytest.mark.parametrize("win_size", [500, 2000])
def test_stream_matches_reference_through_the_device_fixpoint(monkeypatch, win_size):
    monkeypatch.setattr(PS, "infer_with_provenance", _on_device)
    trace = _drive(win_size)
    assert min(trace) > 0


# ------------------------------------------------ tests/test_rsp.py mirrors

REACH = """@prefix ex: <http://e/> .
{ ?a ex:knows ?b . ?b ex:knows ?c . } => { ?a ex:reach ?c . } ."""


def _pair():
    ref, inc = RefIncremental(), IncrementalR2R(device=CPU)
    for r in (ref, inc):
        r.load_rules(REACH)
    return {"ref": (ref, RefWT), "port": (inc, port.WindowTriple)}


def test_derived_expires_with_premise():
    out = {}
    for pkg, (r, WT) in _pair().items():
        ab = WT("<http://e/a>", "<http://e/knows>", "<http://e/b>")
        bc = WT("<http://e/b>", "<http://e/knows>", "<http://e/c>")
        r.feed_window("w", 4, [(ab, 0), (bc, 3)])
        d1 = _decode_set(r, r.materialize_incremental())
        r.feed_window("w", 4, [(bc, 3)])
        d2 = _decode_set(r, r.materialize_incremental())
        out[pkg] = (d1, d2, _bookkeeping(r))
    assert out["port"] == out["ref"]
    assert len(out["port"][0]) == 1 and out["port"][1] == []
    assert out["port"][2]["db"] == [("http://e/b", "http://e/knows", "http://e/c")]


def test_legacy_surface_falls_back():
    out = {}
    for pkg, (r, WT) in _pair().items():
        host = RefSimple() if pkg == "ref" else SimpleR2R(device=CPU)
        host.load_rules(REACH)
        items = [WT("<http://e/a>", "<http://e/knows>", "<http://e/b>"),
                 WT("<http://e/b>", "<http://e/knows>", "<http://e/c>"),
                 WT("<http://e/c>", "<http://e/knows>", "<http://e/d>")]
        for x in (r, host):
            for it in items:
                x.add(it)
        first = _decode_set(r, r.materialize())
        assert first == _decode_set(host, host.materialize())
        r.remove(items[0])
        # the incremental entry now answers through the full recompute
        second = _decode_set(r, r.materialize_incremental())
        out[pkg] = (first, second, r._legacy)
    assert out["port"] == out["ref"]
    assert out["port"][2] is True and len(out["port"][0]) == 2


def test_shared_triple_across_buckets_survives_eviction():
    """``tests/test_rsp.py:945``: a triple held by two windows stays in the
    db while either bucket holds it; the prune clock and the buckets equal
    the reference's after every step."""
    out = {}
    for pkg, (r, WT) in _pair().items():
        shared = WT("<http://e/a>", "<http://e/knows>", "<http://e/b>")
        other = WT("<http://e/b>", "<http://e/knows>", "<http://e/c>")
        steps = []
        r.feed_window("wA", 2, [(shared, 0)])
        r.feed_window("wB", 10, [(shared, 0), (other, 1)])
        steps.append((_decode_set(r, r.materialize_incremental()), _bookkeeping(r)))
        r.feed_window("wA", 2, [])
        steps.append((_decode_set(r, r.materialize_incremental()), _bookkeeping(r)))
        r.feed_window("wB", 10, [(other, 1)])
        steps.append((_decode_set(r, r.materialize_incremental()), _bookkeeping(r)))
        out[pkg] = steps
    assert out["port"] == out["ref"]
    assert ("http://e/a", "http://e/knows", "http://e/b") in out["port"][1][1]["db"]
    assert ("http://e/a", "http://e/knows", "http://e/b") not in out["port"][2][1]["db"]


QUERY = """PREFIX s: <http://c/>
REGISTER RSTREAM <http://out/reach> AS SELECT ?a ?c
FROM NAMED WINDOW <http://c/w> ON <http://c/social> [RANGE 8 STEP 2]
WHERE { WINDOW <http://c/w> { ?a s:reach ?c } }"""


@pytest.mark.parametrize("mode", ["incremental", "device"])
@pytest.mark.usefixtures("port_device_program")
def test_engine_incremental_mode_matches_reference(mode):
    """``set_r2r_mode("incremental")`` on one window: the port's rows equal
    the JAX package's incremental engine push by push (and the port's
    device R2R's too)."""
    rng = random.Random(5)
    events = [(1 + k // 4, rng.randrange(12), rng.randrange(12)) for k in range(120)]
    out = {}
    for pkg in ("ref", "port"):
        rows: list = []
        if pkg == "ref":
            b, WT, m = RefBuilder(QUERY), RefWT, "incremental"
        else:
            b, WT, m = port.RSPBuilder(QUERY, device="cpu"), port.WindowTriple, mode
        engine = b.add_rules(RULES).set_r2r_mode(m).with_consumer(rows.append).build()
        batches = []
        for ts, a, c in events:
            engine.add_to_stream("http://c/social", WT(f"<http://c/p{a}>", "<http://c/knows>",
                                                       f"<http://c/p{c}>"), ts)
            batches.append(sorted(rows))
            rows.clear()
        out[pkg] = (batches, type(engine.r2r).__name__)
    assert out["port"][0] == out["ref"][0] and any(out["port"][0])
    assert out["port"][1] == ("IncrementalR2R" if mode == "incremental" else "DeviceR2R")
