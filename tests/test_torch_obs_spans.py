"""The port's spans inside a query and inside the device fixpoint, on the CPU.

A query on the device program records ``query.decode`` (format_results) and
a ``device.wait`` for every readback the fetch audit counts, under
``query.execute``; the device fixpoint records ``fixpoint.lower`` (the
constructor's lowering), then ``reasoner.fixpoint`` around one
``fixpoint.round`` a round (with its one ``device.wait``) and
``fixpoint.writeback``.  Span start times are Unix epoch seconds, the
clock ``torch.profiler`` stamps its events on, so the benchmark can name
the device's idle gaps by the span open in them."""

import time

import pytest
import torch

from kolibrie_tpu_torch import Reasoner, SparqlDatabase, execute_query_volcano
from kolibrie_tpu_torch.obs import runtime, spans
from kolibrie_tpu_torch.optimizer import device_engine as DE
from kolibrie_tpu_torch.reasoner import device_fixpoint as FX
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

ENGINE_SPANS = {"query.parse", "query.plan", "query.execute", "device.lower",
                "device.dispatch", "device.collect"}


_UB = "PREFIX ub: <http://swat.cse.lehigh.edu/onto/univ-bench.owl#>\n"
# a GROUP BY aggregate and an ORDER BY ... LIMIT, on the device's
# aggregate and top-k routes, whose readbacks sit under query.execute
AGG = _UB + ("SELECT ?z (COUNT(?x) AS ?n) WHERE { ?x ub:memberOf ?z . "
             "?z ub:subOrganizationOf ?y } GROUP BY ?z")
ORD = _UB + ("SELECT ?x ?z WHERE { ?x ub:memberOf ?z . ?z ub:subOrganizationOf ?y } "
             "ORDER BY ?x LIMIT 7")


@pytest.fixture(scope="module")
def lubm():
    from benches.lubm import LUBM_Q2, LUBM_Q9, generate_fast

    db = SparqlDatabase(device="cpu")
    db.store.add_batch(*generate_fast(1, db.dictionary))
    db.execution_mode = "device"
    return db, {"q2": LUBM_Q2, "q9": LUBM_Q9, "agg": AGG, "ord": ORD}


@pytest.fixture(autouse=True)
def spans_on():
    spans.clear()
    yield
    runtime.set_enabled(True)
    spans.clear()


def _children(recs):
    kids = {}
    for s in recs:
        kids.setdefault(s["parent_id"], []).append(s)
    return kids


def _descendants(kids, sid):
    out = []
    for k in kids.get(sid, ()):
        out.append(k)
        out.extend(_descendants(kids, k["span_id"]))
    return out


# per query: the readbacks the fetch audit counts, each wait's parent span,
# and the rows decoded (the top-k route decodes its LIMIT rounded up to 8)
_PLAN = {"converge.counts": "device.dispatch", "to_table": "device.collect"}
_READBACKS = {
    "q2": (_PLAN, None),
    "q9": (_PLAN, None),
    "agg": ({"converge.counts": "query.execute", "aggregate.groups": "query.execute",
             "aggregate.collect": "query.execute"}, None),
    "ord": ({"converge.counts": "query.execute", "ordered.nan": "query.execute",
             "ordered.collect": "query.execute"}, 8),
}


@pytest.mark.parametrize("name", ["q2", "q9", "agg", "ord"])
def test_query_spans_decode_and_readbacks(lubm, name):
    db, texts = lubm
    want_parent, decoded = _READBACKS[name]
    cold = execute_query_volcano(texts[name], db)
    before = DE.fetch_counters()
    warm = execute_query_volcano(texts[name], db)
    fetched = {k: v - before.get(k, 0) for k, v in DE.fetch_counters().items()}
    assert warm == cold and warm
    recs = spans.spans_snapshot()
    names = {s["name"] for s in recs}
    if name in ("q2", "q9"):
        assert ENGINE_SPANS <= names  # the cold run's parse, plan and lowering too
    kids = _children(recs)
    by_id = {s["span_id"]: s for s in recs}
    last = [s for s in recs if s["name"] == "query.execute"][-1]
    assert last["attrs"]["path"] == "device"
    inner = _descendants(kids, last["span_id"])
    decode = [s for s in inner if s["name"] == "query.decode"]
    assert len(decode) == 1
    assert decode[0]["attrs"] == {"rows": decoded or len(warm), "path": "display"}
    waits = [s for s in inner if s["name"] == "device.wait"]
    # one wait a readback the audit counts, at the same sites
    sites = {}
    for w in waits:
        sites[w["attrs"]["site"]] = sites.get(w["attrs"]["site"], 0) + 1
    assert sites == {k: v for k, v in fetched.items() if v} == dict.fromkeys(want_parent, 1)
    parent = {w["attrs"]["site"]: by_id[w["parent_id"]]["name"] for w in waits}
    assert parent == want_parent
    for w in waits:  # inside its parent on the wall clock
        p = by_id[w["parent_id"]]
        assert p["start_s"] <= w["start_s"] + 1e-6
        assert w["dur_ms"] <= p["dur_ms"] + 1e-3


def test_quoted_columns_decode_on_their_own_path():
    db = SparqlDatabase(device="cpu")
    db.parse_turtle("@prefix e: <http://e/> . << e:a e:p e:b >> e:says e:c . "
                    "<< e:b e:p e:c >> e:says e:d .")
    rows = execute_query_volcano("SELECT ?t ?w WHERE { ?t <http://e/says> ?w }", db)
    decode = [s for s in spans.spans_snapshot() if s["name"] == "query.decode"]
    assert len(rows) == 2 and decode[-1]["attrs"] == {"rows": 2, "path": "quoted"}


def _reasoner(n=40):
    """Typed chains and one join rule: four rounds at the default
    capacities with no capacity retry."""
    r = Reasoner(device="cpu")
    for i in range(n):
        r.add_abox_triple(f"p{i}", "type", "A")
        r.add_abox_triple(f"p{i}", "knows", f"p{(i + 1) % n}")
    r.add_rule(r.rule_from_strings([("?x", "type", "A")], [("?x", "type", "B")]))
    r.add_rule(r.rule_from_strings([("?x", "type", "B")], [("?x", "type", "C")]))
    r.add_rule(r.rule_from_strings([("?x", "knows", "?y"), ("?y", "type", "C")],
                                   [("?x", "type", "D")]))
    return r


def _block_rows(fx, caps):
    """The candidate blocks' static rows a round (``block_rows``): each
    plan's block is the delta's capacity for a one-premise rule and the
    join's for a join, once a conclusion."""
    return sum((caps.delta if len(order) == 1 else caps.join) * len(rule.concls)
               for rule in fx.rules for order, _keys in rule.plans)


def test_fixpoint_span_tree_and_candidate_rows():
    r, twin = _reasoner(), _reasoner()
    before = DE.fetch_counters()
    derived = r.infer_new_facts_device()
    assert DE.fetch_counters() == before
    fx = FX.DeviceFixpoint(twin)
    assert fx.infer() == derived > 0
    recs = spans.spans_snapshot()
    kids = _children(recs)
    roots = [s for s in recs if s["name"] == "reasoner.fixpoint"]
    assert len(roots) == 2
    entry, direct = roots
    assert entry["attrs"] == {"facts": 80, "rounds": fx.last_rounds, "derived": derived}
    assert direct["attrs"] == entry["attrs"]
    order = [k["name"] for k in sorted(kids[entry["span_id"]], key=lambda s: s["start_s"])]
    assert order == ["fixpoint.round"] * fx.last_rounds + ["fixpoint.writeback"]
    # the lowering ran in the constructor, just before the run's span
    top = [s["name"] for s in sorted(kids[None], key=lambda s: s["start_s"])]
    assert top == ["fixpoint.lower", "reasoner.fixpoint"] * 2
    rounds = [k for k in kids[entry["span_id"]] if k["name"] == "fixpoint.round"]
    per_round = _block_rows(fx, fx.converged_caps)
    assert [x["attrs"]["round"] for x in rounds] == list(range(fx.last_rounds))
    # the dedup takes the compacted candidates, not the blocks they came from
    assert fx.converged_caps.cand < per_round
    assert all(x["attrs"]["candidate_rows"] == fx.converged_caps.cand for x in rounds)
    assert all(x["attrs"]["block_rows"] == per_round for x in rounds)
    # every new fact is a live candidate; the last round derives nothing
    for x in rounds:
        a = x["attrs"]
        assert a["new_facts"] <= a["candidate_valid"] <= a["candidate_rows"]
    assert all(x["attrs"]["candidate_valid"] > 0 for x in rounds[:-1])
    assert all(x["attrs"]["code"] == 0 for x in rounds)
    assert sum(x["attrs"]["new_facts"] for x in rounds) == derived
    assert rounds[0]["attrs"]["delta_rows"] == 80
    assert [x["attrs"]["delta_rows"] for x in rounds[1:]] == [
        x["attrs"]["new_facts"] for x in rounds[:-1]]
    # exactly one host sync a round, and it is the round's wait
    for x in rounds:
        assert [(k["name"], k["attrs"]) for k in kids[x["span_id"]]] == [
            ("device.wait", {"site": "fixpoint.round"})]
    wb = [k for k in kids[entry["span_id"]] if k["name"] == "fixpoint.writeback"]
    assert wb[0]["attrs"] == {"rows": derived}


def test_fixpoint_rounds_read_the_candidate_blocks():
    calls = []
    orig = FX._gen_candidates

    def counted(*a, **k):
        out = orig(*a, **k)
        calls.append(out[0].shape[0])
        return out

    FX._gen_candidates = counted
    try:
        _reasoner().infer_new_facts_device()
    finally:
        FX._gen_candidates = orig
    rounds = [s for s in spans.spans_snapshot() if s["name"] == "fixpoint.round"]
    assert [s["attrs"]["candidate_rows"] for s in rounds] == calls


def test_a_capacity_retry_records_the_failed_round():
    r = Reasoner(device="cpu")
    for i in range(30):
        r.add_abox_triple(f"n{i}", "next", f"n{i + 1}")
    r.add_rule(r.rule_from_strings([("?x", "next", "?y"), ("?y", "next", "?z")],
                                   [("?x", "next", "?z")]))
    assert r.infer_new_facts_device() == 435
    rounds = [s["attrs"] for s in spans.spans_snapshot() if s["name"] == "fixpoint.round"]
    root = [s for s in spans.spans_snapshot() if s["name"] == "reasoner.fixpoint"][0]
    failed = [a for a in rounds if a["code"]]
    assert failed and len(rounds) == root["attrs"]["rounds"] + sum(
        a["round"] + 1 for a in failed)


def test_chunked_fixpoint_spans():
    r = _reasoner()
    fx = FX.DeviceFixpoint(r)
    spans.clear()
    derived = fx.infer_chunked(chunk_rows=16)
    recs = spans.spans_snapshot()
    kids = _children(recs)
    root = [s for s in recs if s["name"] == "reasoner.fixpoint"]
    assert len(root) == 1 and root[0]["attrs"] == {
        "facts": 80, "rounds": fx.last_rounds, "derived": derived}
    rounds = [k for k in kids[root[0]["span_id"]] if k["name"] == "fixpoint.round"]
    # the last round derives nothing and is not counted in last_rounds
    assert len(rounds) == fx.last_rounds + 1
    assert rounds[-1]["attrs"]["new_facts"] == 0
    for x in rounds:
        chunks = -(-x["attrs"]["delta_rows"] // 16)
        assert x["attrs"]["candidate_rows"] % chunks == 0
        assert {k["name"] for k in kids[x["span_id"]]} == {"device.wait"}


def test_span_clock_is_the_profilers(tmp_path):
    """Each span starts and ends within 1 ms of the profiler's range inside
    it, in the best of five pairs (a scheduler stall between the two clock
    reads can hold one pair apart); a span on another clock than the Unix
    epoch would be off by hours in all five."""
    import json

    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with spans.span(f"clock.probe.{i}"):
                with record_function(f"clock.range.{i}"):
                    torch.ones(4096).cumsum(0)
                    time.sleep(0.02)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    trace = json.loads((tmp_path / "trace.json").read_text())
    # the exported events' ts are microseconds after baseTimeNanoseconds
    base_s = trace.get("baseTimeNanoseconds", 0) / 1e9
    ranges = {e["name"]: e for e in trace["traceEvents"]
              if e.get("ph") == "X" and e.get("name", "").startswith("clock.range.")}
    probes = {s["name"]: s for s in spans.spans_snapshot() if s["name"].startswith("clock.probe.")}
    assert len(ranges) == len(probes) == 5
    errs = []
    for i in range(5):
        ev, sp = ranges[f"clock.range.{i}"], probes[f"clock.probe.{i}"]
        start_s = base_s + ev["ts"] / 1e6
        end_s = start_s + ev["dur"] / 1e6
        errs.append(max(abs(start_s - sp["start_s"]),
                        abs(end_s - (sp["start_s"] + sp["dur_ms"] / 1e3))))
    assert min(errs) < 1e-3, errs


def test_disabled_spans_record_nothing_and_change_nothing(lubm):
    db, texts = lubm
    on = [execute_query_volcano(texts[q], db) for q in ("q2", "q9")]
    r_on, r_off = _reasoner(), _reasoner()
    d_on = r_on.infer_new_facts_device()
    runtime.set_enabled(False)
    spans.clear()
    off = [execute_query_volcano(texts[q], db) for q in ("q2", "q9")]
    d_off = r_off.infer_new_facts_device()
    assert spans.spans_snapshot() == []
    runtime.set_enabled(True)
    assert off == on
    assert d_off == d_on
    assert [c.tolist() for c in r_off.facts.columns()] == [c.tolist() for c in r_on.facts.columns()]
