"""The PyTorch port's cross-window SDS+ reasoning against the JAX package, on
the CPU.

The same SDS goes through both packages (``benches/bench_cross_window.py``'s
generator, copied here, at 100-1,000 roads and update ratios 1, 10, 50 and
100%): ``translate_sds_to_arrays`` exactly, ``naive_sds_plus`` and
``incremental_sds_plus`` (state maps, columnar mirror and
``sds_with_expiry_to_external``) decoded.  On the CPU the port's incremental
closure takes the host loop, as the JAX package's does; one run sends it
through ``infer_provenance_device`` instead (the route the CUDA card takes
from ``AUTO_MIN_FACTS`` facts), with the route patched in the test.

The overlay repair: the incremental SDS+ overlay's ``get`` falls back to
the prior windows' expiries, and the device fixpoint seeds its tags
through that ``get`` (``device_provenance._seed_tag_arrays``), writing back
only this cycle's entries.

Mirrors of ``tests/test_rsp.py`` (the cross-window cases at :275, :322,
:351, :409, :559 and :593) run through both packages' ``RSPBuilder`` with
the rows equal, and cross-window checkpoint blobs restore across packages.
Last, a small rehearsal of ``chip_smoke.py`` phase 10.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import kolibrie_tpu_torch as port
from kolibrie_tpu.core.dictionary import Dictionary as RefDictionary
from kolibrie_tpu.reasoner import cross_window as ref_cw
from kolibrie_tpu.reasoner.n3_parser import parse_n3_rules_for_sds as ref_parse_sds
from kolibrie_tpu.reasoner.provenance import ExpirationProvenance as RefExpiration
from kolibrie_tpu.reasoner.provenance_seminaive import (
    semi_naive_with_initial_tags_and_delta as ref_semi_naive_delta,
)
from kolibrie_tpu.reasoner.reasoner import Reasoner as RefReasoner
from kolibrie_tpu.reasoner.tag_store import TagStore as RefTagStore
from kolibrie_tpu.rsp.builder import RSPBuilder as RefBuilder
from kolibrie_tpu.rsp.engine import CrossWindowReasoningMode as RefMode
from kolibrie_tpu.rsp.s2r import WindowTriple as RefWT
from kolibrie_tpu_torch import Dictionary
from kolibrie_tpu_torch.reasoner import cross_window as cw
from kolibrie_tpu_torch.reasoner import device_provenance as DP
from kolibrie_tpu_torch.reasoner import provenance_seminaive as PS
from kolibrie_tpu_torch.reasoner.n3_parser import parse_n3_rules_for_sds
from kolibrie_tpu_torch.reasoner.provenance import ExpirationProvenance
from kolibrie_tpu_torch.reasoner.tag_store import TagStore
from test_torch_clauses import port_device_program  # noqa: F401  (a fixture)
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

CPU = torch.device("cpu")
PKGS = {
    "ref": (ref_cw, RefDictionary, ref_parse_sds),
    "port": (cw, Dictionary, parse_n3_rules_for_sds),
}

# ----------------------------------------------- the bench's generator

TRAFFIC = "http://traffic/"
PARKING = "http://parking/"
RESULT = "http://result/"
CURRENT_TIME = 60
RULE_N3 = """
@prefix wt: <http://traffic/> .
@prefix wp: <http://parking/> .
@prefix wr: <http://result/> .
{ ?road wt:avgSpeed ?s . ?lot wp:nearRoad ?road . ?lot wp:occupancy ?occ } => { ?road wr:congested <true> }
"""


def make_sds(mod, n: int, update_ratio_percent: int):
    """``benches/bench_cross_window.py:56-83`` on ``mod``'s SDS classes."""
    sds = mod.Sds()
    sds.output_iris.add(RESULT)
    update_count = n * update_ratio_percent // 100
    sds.windows[TRAFFIC] = mod.WindowData(alpha=60, triples=[
        mod.WindowedTriple(
            subject=f"road_{i}", predicate="avgSpeed", object=str(20 + i % 80),
            event_time=(CURRENT_TIME + i % 10) if i < update_count else 1 + i % 59,
        )
        for i in range(n)
    ])
    lots = max(n // 4, 1)
    p_update = lots * update_ratio_percent // 100
    parking = []
    for j in range(lots):
        et = (CURRENT_TIME + j % 10) if j < p_update else 1 + j % 119
        parking.append(mod.WindowedTriple(f"lot_{j}", "nearRoad", f"road_{(j * 4) % max(n, 1)}", et))
        parking.append(mod.WindowedTriple(f"lot_{j}", "occupancy", str(50 + j % 50), et))
    sds.windows[PARKING] = mod.WindowData(alpha=120, triples=parking)
    return sds


def _decoded(d, buckets) -> dict:
    dec = d.decode
    return {c: sorted((dec(t.subject), dec(t.predicate), dec(t.object)) for t in ts)
            for c, ts in buckets.items()}


def _run(pkg, n, ratio, device_route=False):
    mod, Dict, parse = PKGS[pkg]
    d = Dict()
    rules, _ = parse(RULE_N3, d, [TRAFFIC, PARKING])
    kw = {"device": CPU} if pkg == "port" else {}
    sds = make_sds(mod, n, ratio)
    arrays = mod.translate_sds_to_arrays(sds, d, CURRENT_TIME)
    naive = mod.naive_sds_plus(rules, sds, d, CURRENT_TIME, **kw)
    prior = mod.incremental_sds_plus(rules, make_sds(mod, n, 0), {}, d, 0, **kw)
    state = mod.incremental_sds_plus(rules, sds, prior, d, CURRENT_TIME, **kw)
    ext = mod.sds_with_expiry_to_external(state, d, [TRAFFIC, PARKING, RESULT])
    return {
        "arrays": arrays, "naive": _decoded(d, naive), "state": {k: dict(v) for k, v in state.items()},
        "mirror": state.arrays, "external": _decoded(d, ext), "terms": list(d.id_to_str),
    }


def _same(got: dict, want: dict) -> None:
    for a, b in zip(got["arrays"] + got["mirror"], want["arrays"] + want["mirror"]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    for key in ("naive", "state", "external", "terms"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("ratio", [1, 10, 50, 100])
@pytest.mark.parametrize("n", [100, 500, 1000])
def test_citybench_point_matches_reference(n, ratio):
    want = _run("ref", n, ratio)
    got = _run("port", n, ratio)
    _same(got, want)
    results = {tuple(t) for t in got["external"].get(RESULT, [])}
    assert results == {tuple(t) for t in got["naive"].get(RESULT, [])}
    assert len(results) == n // 4


def _on_device(reasoner, provenance, tag_store=None, initial_delta=None, round1_old_store=None):
    """The route the CUDA card takes, on the CPU: the device tagged
    fixpoint, which must accept the program."""
    if tag_store is None:
        tag_store = PS.seed_tag_store(reasoner, provenance)
    assert DP.infer_provenance_device(reasoner, provenance, tag_store, initial_delta) is not None
    return tag_store


@pytest.mark.parametrize("ratio", [1, 50])
def test_incremental_through_the_device_fixpoint(monkeypatch, ratio):
    want = _run("ref", 1000, ratio)
    monkeypatch.setattr(PS, "infer_with_provenance", _on_device)
    got = _run("port", 1000, ratio)
    _same(got, want)
    assert DP.LAST_RUN["rounds"] >= 2


# ------------------------------------------------------ the overlay repair

OVERLAY_RULES = [
    ([("?a", "p", "?b"), ("?b", "q", "?c")], [("?a", "r", "?c")]),
    ([("?a", "r", "?c"), ("?c", "q", "?d")], [("?a", "s", "?d")]),
    ([("g", "mode", "strict"), ("?a", "p", "?b")], [("?a", "valid", "?b")]),
]


def _overlay_case(Reasoner, Overlay, Store, Prov, seed, **kw):
    """A reasoner with old facts (tags in a prior map only), this cycle's
    delta (tags in the overlay's own entries) and the rules above; returns
    the reasoner, the store, the delta and the prior map."""
    rng = np.random.default_rng(seed)
    r = Reasoner(**kw)
    enc = r.dictionary.encode
    old, new = {}, {}
    for k in range(40):
        a, b = rng.integers(0, 12, 2)
        pred = "p" if k % 2 else "q"
        key = (enc(f"n{a}"), enc(pred), enc(f"n{b}"))
        (new if k % 5 == 0 else old)[key] = int(rng.integers(100, 1000))
    old[(enc("g"), enc("mode"), enc("strict"))] = 150  # a guard tagged in the prior only
    for key in list(old) + list(new):
        r.facts.add(*key)
    for prem, concl in OVERLAY_RULES:
        r.add_rule(r.rule_from_strings(prem, concl))
    overlay = Overlay([old])
    for key, e in new.items():
        overlay[key] = e
    store = Store(Prov())
    store.tags = overlay
    return r, store, set(new), old


@pytest.mark.parametrize("seed", range(4))
def test_device_seeding_reads_the_overlay(seed):
    """The device fixpoint's tags equal the reference's host loop when the
    older facts' expiries sit in the overlay's prior map: seeded through
    ``get`` (on the parent every carried fact seeded as "no entry", which
    is FOREVER, so derived facts outlived their premises), and only this
    cycle's entries written back."""
    ref_r, ref_store, ref_delta, _ = _overlay_case(
        RefReasoner, ref_cw._OverlayTags, RefTagStore, RefExpiration, seed)
    ref_semi_naive_delta(ref_r, RefExpiration(), ref_store, ref_delta)
    r, store, delta, old = _overlay_case(
        port.Reasoner, cw._OverlayTags, TagStore, ExpirationProvenance, seed, device=CPU)
    assert DP.infer_provenance_device(r, ExpirationProvenance(), store, delta) is not None
    assert r.facts.triples_set() == ref_r.facts.triples_set()
    assert dict(store.tags) == dict(ref_store.tags)  # the cycle's update set
    # every derived fact's expiry is bounded by a carried premise's
    assert any(v < 1000 and k not in old and k not in delta for k, v in dict(store.tags).items())
    assert all(k not in dict(store.tags) or store.tags[k] != old[k] for k in old)
    host, hstore, hdelta, _ = _overlay_case(
        port.Reasoner, cw._OverlayTags, TagStore, ExpirationProvenance, seed, device=CPU)
    PS.infer_with_provenance_host(host, ExpirationProvenance(), hstore, hdelta)
    assert dict(hstore.tags) == dict(store.tags)


def test_seeding_a_plain_store_is_unchanged():
    """A plain dict still seeds through the device lookup of its own keys."""
    r, store, delta, old = _overlay_case(
        port.Reasoner, cw._OverlayTags, TagStore, ExpirationProvenance, 0, device=CPU)
    plain = TagStore.from_items(ExpirationProvenance(), list(old.items()) + list(store.tags.items()))
    s, p, o = r.facts.columns()
    cols = [torch.from_numpy(c.astype(np.int64)) for c in (s, p, o)]
    got, _ = DP._seed_tag_arrays(ExpirationProvenance(), plain, cols)
    via_get, _ = DP._seed_tag_arrays(ExpirationProvenance(), store, cols)
    np.testing.assert_array_equal(got, via_get)
    assert not np.isnan(got).any()


# ------------------------------------------------ tests/test_rsp.py mirrors

CW_RULES = """
@prefix t: <http://e/wT/> .
@prefix h: <http://e/wH/> .
@prefix out: <http://e/out/> .
{ ?room t:hot ?v . ?room h:humid ?w . } => { ?room out:alert ?v . } .
"""
WT, WH = "http://e/wT/", "http://e/wH/"


def _small_sds(mod, t_events, h_events, alpha=10):
    sds = mod.Sds()
    sds.windows[WT] = mod.WindowData(alpha, [mod.WindowedTriple(*e) for e in t_events])
    sds.windows[WH] = mod.WindowData(alpha, [mod.WindowedTriple(*e) for e in h_events])
    sds.output_iris.add("http://e/out/")
    return sds


def test_shared_triple_across_windows_translates_per_window():
    """``test_rsp.py:275``."""
    out = {}
    for pkg, (mod, Dict, _parse) in PKGS.items():
        d = Dict()
        shared = mod.WindowedTriple("s1", "p", "o1", 5)
        sds = mod.Sds()
        sds.windows["http://e/w1/"] = mod.WindowData(10, [shared])
        sds.windows["http://e/w2/"] = mod.WindowData(10, [shared])
        arrays = mod.translate_sds_to_arrays(sds, d, 0)
        out[pkg] = ([a.tolist() for a in arrays], sorted(d.decode(int(x)) for x in np.unique(arrays[1])))
    assert out["port"] == out["ref"]
    assert out["port"][1] == ["http://e/w1/p", "http://e/w2/p"]


def test_translate_edges_match_reference():
    """Expiry filtering, the forever window and in-place event-time
    updates (``test_rsp.py`` :268, :290, :303)."""
    out = {}
    for pkg, (mod, Dict, _parse) in PKGS.items():
        d = Dict()
        sds = _small_sds(mod, [("r1", "hot", "1", 5), ("r2", "hot", "2", 9)], [])
        sds.windows["http://e/w1/"] = mod.WindowData(2**63, [mod.WindowedTriple("s", "p", "o", 5)])
        wt = sds.windows[WT].triples[1]
        seq = []
        for t in (14, 15, 18, 19):
            seq.append([a.tolist() for a in mod.translate_sds_to_arrays(sds, d, t)])
            seq.append([(tuple(x[0]), x[1]) for x in mod.translate_sds_to_datalog(sds, d, t)])
        wt.event_time = 100
        seq.append([a.tolist() for a in mod.translate_sds_to_arrays(sds, d, 19)])
        out[pkg] = seq
    assert out["port"] == out["ref"]
    assert out["port"][0][3][-1] == mod.U64_MAX


def test_incremental_state_arrays_mirror_dicts():
    """``test_rsp.py:322``: the columnar mirror holds exactly the dict
    state's facts, also with an unroutable conclusion."""
    text = CW_RULES + "\n{ ?room t:hot ?v . } => { ?room <urn:unrouted:x> ?v . } .\n"
    out = {}
    for pkg, (mod, Dict, parse) in PKGS.items():
        d = Dict()
        rules, _ = parse(text, d, [WT, WH])
        sds = _small_sds(mod, [("r1", "hot", "1", 5), ("r2", "hot", "2", 6)], [("r1", "humid", "3", 5)])
        kw = {"device": CPU} if pkg == "port" else {}
        state = mod.incremental_sds_plus(rules, sds, {}, d, 0, **kw)
        keys = {k for m in state.values() for k in m}
        s, p, o, _e = state.arrays
        assert set(zip(s.tolist(), p.tolist(), o.tolist())) == keys
        out[pkg] = ({k: dict(v) for k, v in state.items()}, [a.tolist() for a in state.arrays])
    assert out["port"] == out["ref"]


def test_naive_incremental_agree():
    """``test_rsp.py:351``: across six cycles the naive snapshot is a
    subset of the incremental state, and both equal the reference's."""
    out = {}
    for pkg, (mod, Dict, parse) in PKGS.items():
        dn, di = Dict(), Dict()
        rules_n, _ = parse(CW_RULES, dn, [WT, WH])
        rules_i, _ = parse(CW_RULES, di, [WT, WH])
        kw = {"device": CPU} if pkg == "port" else {}
        state, trace = {}, []
        for t in range(0, 30, 5):
            t_events = [(f"r{i}", "hot", str(i), max(0, t - 3)) for i in range(3)]
            h_events = [(f"r{i}", "humid", "x", max(0, t - 2)) for i in range(2)]
            naive = mod.naive_sds_plus(rules_n, _small_sds(mod, t_events, h_events), dn, t, **kw)
            sds_i = _small_sds(mod, t_events, h_events)
            state = mod.incremental_sds_plus(rules_i, sds_i, state, di, t, **kw)
            ext = mod.sds_with_expiry_to_external(state, di, mod.all_component_iris(sds_i))
            a, b = _decoded(dn, naive), _decoded(di, ext)
            for comp, rows in a.items():
                assert set(rows) <= set(b[comp])
            trace.append((a, b))
        out[pkg] = trace
    assert out["port"] == out["ref"]


QUERY = """PREFIX ex: <http://e/>
REGISTER RSTREAM <http://out/s> AS
SELECT ?room ?v
FROM NAMED WINDOW <http://e/wT/> ON <http://e/tempStream> [RANGE 10 STEP 2]
FROM NAMED WINDOW <http://e/wH/> ON <http://e/humStream> [RANGE 10 STEP 2]
WHERE {
  WINDOW <http://e/wT/> { ?room <alerted> ?v }
  WINDOW <http://e/wH/> { ?room <humid> ?w }
}"""
ENGINE_RULES = """@prefix t: <http://e/wT/> .
@prefix h: <http://e/wH/> .
{ ?room t:hot ?v . ?room h:humid ?w . } => { ?room t:alerted ?v . } ."""


def _engine(pkg, mode, sink):
    b = RefBuilder(QUERY) if pkg == "ref" else port.RSPBuilder(QUERY, device="cpu")
    return (b.set_cross_window_rules(ENGINE_RULES).set_cross_window_reasoning_mode(mode)
            .with_consumer(sink.append).build())


def _wt(pkg, *a):
    return (RefWT if pkg == "ref" else port.WindowTriple)(*a)


def _feed(pkg, engine, ticks, rooms=1):
    for ts in ticks:
        for k in range(rooms):
            engine.add_to_stream("http://e/tempStream", _wt(pkg, f"r{k}", "hot", f'"{40 + k}"'), ts)
            engine.add_to_stream("http://e/humStream", _wt(pkg, f"r{k}", "humid", '"x"'), ts)
    engine.process_single_thread_window_results()


@pytest.mark.parametrize("mode", ["naive", "incremental", "auto"])
@pytest.mark.usefixtures("port_device_program")
def test_engine_cross_window(mode):
    """``test_rsp.py:409`` in every mode."""
    out = {}
    for pkg in ("ref", "port"):
        rows: list = []
        engine = _engine(pkg, mode, rows)
        assert engine.cross_window_enabled
        _feed(pkg, engine, range(1, 12), rooms=3)
        out[pkg] = rows
    assert out["port"] == out["ref"]
    assert out["port"] and dict(out["port"][0])["v"] == "40"


@pytest.mark.parametrize("first,second", [("port", "port"), ("ref", "port"), ("port", "ref")])
@pytest.mark.usefixtures("port_device_program")
def test_cross_window_checkpoint_restore(first, second):
    """``test_rsp.py:559``: an incremental engine checkpointed after tick 2
    and restored into a fresh engine (either package's) derives the
    uninterrupted run's rows; the blobs are the reference's JSON."""
    ref: list = []
    _feed("ref", _engine("ref", RefMode.INCREMENTAL, ref), (1, 2, 3, 4, 5))
    part1: list = []
    e1 = _engine(first, "incremental", part1)
    _feed(first, e1, (1, 2))
    blob = e1.checkpoint_state()
    twin: list = []
    e_twin = _engine("ref" if first == "port" else "port", "incremental", twin)
    _feed("ref" if first == "port" else "port", e_twin, (1, 2))
    assert json.loads(blob) == json.loads(e_twin.checkpoint_state())
    e1.stop()
    part2: list = []
    e2 = _engine(second, "incremental", part2)
    e2.restore_state(blob)
    _feed(second, e2, (3, 4, 5))
    assert [dict(r).get("v") for r in part1 + part2] == [dict(r).get("v") for r in ref]
    assert ref


@pytest.mark.usefixtures("port_device_program")
def test_auto_agrees_with_naive():
    """``test_rsp.py:593``: AUTO picks incremental on the steady phase and
    naive on the burst, as the reference does, with the naive engine's
    rows."""
    def drive(pkg, engine):
        for ts in range(1, 7):
            engine.add_to_stream("http://e/tempStream", _wt(pkg, "r1", "hot", '"42"'), ts)
            engine.add_to_stream("http://e/humStream", _wt(pkg, "r1", "humid", '"x"'), ts)
            engine.process_single_thread_window_results()
        for ts in range(7, 10):
            for k in range(6):
                engine.add_to_stream("http://e/tempStream", _wt(pkg, f"r{k}", "hot", f'"{k}"'), ts)
                engine.add_to_stream("http://e/humStream", _wt(pkg, f"r{k}", "humid", '"x"'), ts)
            engine.process_single_thread_window_results()
        engine.process_single_thread_window_results()

    out = {}
    for pkg in ("ref", "port"):
        auto_rows, naive_rows, decisions = [], [], []
        e_auto = _engine(pkg, "auto", auto_rows)
        orig = e_auto._auto_mode
        e_auto._auto_mode = lambda sds, o=orig: decisions.append(o(sds)) or decisions[-1]
        drive(pkg, e_auto)
        drive(pkg, _engine(pkg, "naive", naive_rows))
        assert auto_rows and auto_rows == naive_rows
        assert "incremental" in decisions and "naive" in decisions
        out[pkg] = (auto_rows, decisions)
    assert out["port"] == out["ref"]


def test_auto_threshold_is_carried():
    from kolibrie_tpu.rsp import engine as ref_engine
    from kolibrie_tpu_torch.rsp import engine as port_engine

    assert port_engine._AUTO_MAX_CHURN == ref_engine._AUTO_MAX_CHURN


# ---------------------------------------------- chip_smoke phase 10 rehearsal


def test_chip_smoke_phase10_rehearsal(monkeypatch):
    """Phase 10 through the smoke's own functions and gates at 1,000 roads
    and a 2,000-person phase-7 stream, the incremental closures sent to
    ``infer_provenance_device`` on torch's CPU."""
    import chip_smoke as CS

    monkeypatch.setattr(PS, "infer_with_provenance", _on_device)
    monkeypatch.setattr(CS, "CW_ROADS", 1000)
    monkeypatch.setattr(CS, "CW_LOTS", 250)
    monkeypatch.setattr(CS, "CW_SPEED_PER_TICK", 17)
    monkeypatch.setattr(CS, "CW_LOTS_PER_TICK", 3)
    monkeypatch.setattr(CS, "RSP_PERSONS", 1000)
    monkeypatch.setattr(CS, "RSP_EVENTS_PER_TICK", 20)
    stream = CS.rsp_stream(CS.RSP_PERSONS, CS.RSP_EVENTS_PER_TICK, CS.RSP_TICKS, CS.RSP_SEED)
    rsp = CS.run_rsp(CPU, "device", stream)
    out = CS.run_cw_phase(CPU, rsp)
    assert [p["route"] for p in out["points"]] == [[True]] * len(CS.CW_RATIOS)
    assert all(p["launches"]["filter_mask"] >= 3 for p in out["points"])
    assert all(f["route"] == [True] for f in out["incremental_r2r"]["firings"])
    modes = {c["mode"] for c in out["engine"]["auto"]["cycles"]}
    assert modes == {"incremental", "naive"}
