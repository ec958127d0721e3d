"""The PyTorch port's RSP engine against the JAX package, on the CPU.

The same seeded event streams go through the JAX package's ``RSPBuilder``
and the port's (``device="cpu"``); the consumer's rows are recorded per
``add_to_stream`` call (one batch per push, sorted within the batch: the
two engines answer a window query through different executors, whose row
order may differ) and the traces must be equal.  Covered: RSTREAM, ISTREAM
and DSTREAM; one window with rules (host and device R2R) and two joined
windows under the sync policies; a static query; single-thread and
multi-thread operation; checkpoints (the decoded JSON equal to the
reference's) and restores across the two packages, cross-window state
included; the dead-letter path;
and a CPU rehearsal of ``chip_smoke.py`` phase 7 at 2,000 persons.  The
replayed cases of ``tests/test_rsp.py`` (``TestS2R``, ``TestR2S``,
``TestEngineSingleWindow``, ``TestEngineMultiWindow``, ``TestPreemption``,
``TestMultiThreadMode``, ``TestDeviceR2R``) run on the port.
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

import kolibrie_tpu_torch as port
from kolibrie_tpu.query import ast as ref_ast
from kolibrie_tpu.resilience.faultinject import FaultPlan as RefFaultPlan
from kolibrie_tpu.resilience.faultinject import InjectedCompileError as RefInjected
from kolibrie_tpu.rsp import s2r as ref_s2r
from kolibrie_tpu.rsp.builder import RSPBuilder as RefBuilder
from kolibrie_tpu.rsp.r2s import Relation2StreamOperator as RefR2S
from kolibrie_tpu_torch.query import ast as port_ast
from kolibrie_tpu_torch.reasoner import device_fixpoint as tfx
from kolibrie_tpu_torch.resilience.faultinject import FaultPlan, InjectedCompileError
from kolibrie_tpu_torch.rsp import s2r
from kolibrie_tpu_torch.rsp.engine import OperationMode
from kolibrie_tpu_torch.rsp.r2s import Relation2StreamOperator, StreamOperator
from test_torch_clauses import port_device_program  # noqa: F401  (a fixture)
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

CPU = torch.device("cpu")

# ------------------------------------------------------------------- S2R


def _window(mod, width, slide, strategy="ON_WINDOW_CLOSE", period=1):
    report = mod.Report()
    report.add(mod.ReportStrategy.from_name(strategy, period))
    return mod.CSPARQLWindow(width, slide, report, mod.Tick.TIME_DRIVEN, "w")


def _fired(w):
    out = []
    w.register_callback(lambda c: out.append(sorted(c)))
    return out


def test_firing_trace_range3_step1():
    w = _window(s2r, 3, 1)
    fired = _fired(w)
    for i, ts in enumerate([1, 2, 3, 4], start=1):
        w.add_to_window(f"e{i}", ts)
    assert fired == [[], ["e1"], ["e1", "e2"], ["e1", "e2", "e3"]]


def test_non_empty_content_strategy():
    w = _window(s2r, 3, 1, "NON_EMPTY_CONTENT")
    fired = _fired(w)
    for i, ts in enumerate([1, 2, 3], start=1):
        w.add_to_window(f"e{i}", ts)
    assert fired[0] == ["e1"]


def test_tumbling_no_overlap():
    w = _window(s2r, 2, 2)
    fired = _fired(w)
    for i, ts in enumerate([1, 2, 3, 4, 5], start=1):
        w.add_to_window(f"e{i}", ts)
    assert [c for c in fired if c] == [["e1"], ["e2", "e3"]]


def test_content_container_dedup_max_ts():
    c = s2r.ContentContainer()
    c.add("x", 5)
    c.add("x", 3)
    assert len(c) == 1 and dict(c.iter_with_timestamps())["x"] == 5


def test_time_driven_tick_monotone():
    w = _window(s2r, 3, 1)
    fired = _fired(w)
    w.add_to_window("e1", 2)
    n = len(fired)
    w.add_to_window("e2", 2)
    assert len(fired) == n


def test_flush():
    w = _window(s2r, 10, 10)
    fired = _fired(w)
    w.add_to_window("e1", 1)
    w.add_to_window("e2", 2)
    w.flush()
    assert fired[-1] == ["e1", "e2"]


def _window_trace(mod, width, slide, strategy, events):
    """Every firing's content (items with timestamps) and the last-changed
    timestamp, then the open windows left at the end."""
    w = _window(mod, width, slide, strategy, period=2)
    fired = []
    w.register_callback(
        lambda c: fired.append((sorted(c.iter_with_timestamps()), c.last_timestamp_changed))
    )
    for item, ts in events:
        w.add_to_window(item, ts)
    state = sorted(
        ((k.open, k.close), sorted(c.iter_with_timestamps()), c.last_timestamp_changed)
        for k, c in w.active_windows.items()
    )
    return fired, state, w.app_time


@pytest.mark.parametrize(
    "strategy", ["ON_WINDOW_CLOSE", "NON_EMPTY_CONTENT", "ON_CONTENT_CHANGE", "PERIODIC"]
)
@pytest.mark.parametrize("width,slide", [(3, 1), (4, 2), (2, 2), (5, 3)])
def test_window_traces_match_reference(strategy, width, slide):
    """The port adds each event in place after the firing decision; the
    reference clones first.  Same firings, contents and state."""
    rng = np.random.default_rng(width * 10 + slide)
    ts = np.cumsum(rng.integers(0, 2, 60)).tolist()  # repeated timestamps
    events = [(f"e{int(rng.integers(0, 12))}", t) for t in ts]
    assert _window_trace(s2r, width, slide, strategy, events) == _window_trace(
        ref_s2r, width, slide, strategy, events
    )


# ------------------------------------------------------------------- R2S


def test_rstream():
    op = Relation2StreamOperator(StreamOperator.RSTREAM)
    assert op.eval(["a", "b"], 1) == ["a", "b"]
    assert op.eval(["a"], 2) == ["a"]


def test_istream():
    op = Relation2StreamOperator(StreamOperator.ISTREAM)
    assert op.eval(["a", "b"], 1) == ["a", "b"]
    assert op.eval(["a", "c"], 2) == ["c"]
    assert op.eval(["a", "c"], 3) == []


def test_dstream():
    op = Relation2StreamOperator(StreamOperator.DSTREAM)
    assert op.eval(["a", "b"], 1) == []
    assert sorted(op.eval(["a"], 2)) == ["b"]


@pytest.mark.parametrize("kind", ["RSTREAM", "ISTREAM", "DSTREAM"])
def test_r2s_matches_reference(kind):
    rng = np.random.default_rng(1)
    ours, ref = Relation2StreamOperator(kind), RefR2S(kind)
    for ts in range(20):
        rel = [f"r{int(x)}" for x in rng.integers(0, 8, int(rng.integers(0, 6)))]
        assert sorted(ours.eval(rel, ts)) == sorted(ref.eval(rel, ts))


# ---------------------------------------------------------------- engines


def _builder(pkg, query):
    if pkg == "ref":
        return RefBuilder(query)
    return port.RSPBuilder(query, device="cpu")


def _wt(pkg, s, p, o):
    return (ref_s2r.WindowTriple if pkg == "ref" else port.WindowTriple)(s, p, o)


def _policy(pkg, kind, timeout_ms=0):
    ast = ref_ast if pkg == "ref" else port_ast
    return ast.SyncPolicy(ast.SyncPolicyKind(kind), timeout_ms)


def build(pkg, query, *, rules="", mode="host", static="", policy=None, multi=False, sink=None):
    b = _builder(pkg, query).set_r2r_mode(mode).with_consumer(sink.append)
    if rules:
        b = b.add_rules(rules)
    if static:
        b = b.add_static_data(static)
    if policy is not None:
        b = b.set_sync_policy(_policy(pkg, policy))
    if multi:
        b = b.set_operation_mode(OperationMode.MULTI_THREAD)
    return b.build()


def trace(pkg, query, events, **kw):
    """Rows emitted per push (sorted within the push) and the engine."""
    sink: list = []
    engine = build(pkg, query, sink=sink, **kw)
    batches = []
    for stream, (s, p, o), ts in events:
        engine.add_to_stream(stream, _wt(pkg, s, p, o), ts)
        batches.append(sorted(sink))
        sink.clear()
    engine.process_single_thread_window_results()
    batches.append(sorted(sink))
    return batches, engine


def knows_stream(n, people, seed, per_tick=3, stream=":stream"):
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, people, (2, n)).tolist()
    return [
        (stream, (f"<http://e/p{x}>", "<http://e/knows>", f"<http://e/p{y}>"), i // per_tick)
        for i, (x, y) in enumerate(zip(a, b))
    ]


KNOWS_RULES = """@prefix ex: <http://e/> .
{ ?a ex:knows ?b . ?b ex:knows ?c . } => { ?a ex:reach ?c . } .
"""


def reach_query(kind, width=4, step=2):
    return f"""PREFIX ex: <http://e/>
REGISTER {kind} <http://out/s> AS SELECT ?a ?c
FROM NAMED WINDOW <http://e/w> ON ?stream [RANGE {width} STEP {step}]
WHERE {{ WINDOW <http://e/w> {{ ?a ex:reach ?c . ?c ex:knows ?a }} }}"""


@pytest.mark.parametrize("kind", ["RSTREAM", "ISTREAM", "DSTREAM"])
@pytest.mark.usefixtures("port_device_program")
def test_single_window_rules_trace_matches_reference(kind):
    events = knows_stream(150, 6, seed=11)
    want, _ = trace("ref", reach_query(kind), events, rules=KNOWS_RULES, mode="host")
    assert any(want)
    for mode in ("host", "device"):
        got, engine = trace("port", reach_query(kind), events, rules=KNOWS_RULES, mode=mode)
        assert got == want, mode
        assert not engine.dead_letters
    assert engine.r2r._device_ok


@pytest.mark.usefixtures("port_device_program")
def test_device_r2r_engine_trace_matches_jax_device_r2r():
    events = knows_stream(120, 7, seed=4)
    q = reach_query("ISTREAM", 6, 3)
    want, ref = trace("ref", q, events, rules=KNOWS_RULES, mode="device")
    got, eng = trace("port", q, events, rules=KNOWS_RULES, mode="device")
    assert got == want and any(want)
    assert ref.r2r._device_ok and eng.r2r._device_ok


MULTI_QUERY = """
PREFIX ex: <http://e/>
REGISTER RSTREAM <http://out/s> AS
SELECT ?room ?temp ?hum
FROM NAMED WINDOW <http://e/wT> ON <http://e/tempStream> [RANGE 10 STEP 2]
FROM NAMED WINDOW <http://e/wH> ON <http://e/humStream> [RANGE 10 STEP 2]
WHERE {
  WINDOW <http://e/wT> { ?room ex:temp ?temp }
  WINDOW <http://e/wH> { ?room ex:hum ?hum }
}
"""


def room_stream(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        room = f"<http://e/room{int(rng.integers(0, 3))}>"
        if rng.random() < 0.5:
            out.append(("http://e/tempStream", (room, "<http://e/temp>", f'"{int(rng.integers(18, 22))}"'), i // 2))
        else:
            out.append(("http://e/humStream", (room, "<http://e/hum>", f'"{int(rng.integers(50, 53))}"'), i // 2))
    return out


@pytest.mark.parametrize("policy", ["steal", "wait"])
@pytest.mark.usefixtures("port_device_program")
def test_two_windows_trace_matches_reference(policy):
    events = room_stream(60, seed=2)
    want, _ = trace("ref", MULTI_QUERY, events, policy=policy)
    assert any(want)
    for mode in ("host", "device"):
        got, _ = trace("port", MULTI_QUERY, events, policy=policy, mode=mode)
        assert got == want, mode


STATIC_QUERY = """PREFIX ex: <http://e/>
REGISTER ISTREAM <http://out/s> AS
SELECT ?room ?temp ?label
FROM NAMED WINDOW <http://e/w> ON ?s [RANGE 5 STEP 1]
WHERE {
  ?room ex:label ?label
  WINDOW <http://e/w> { ?room ex:temp ?temp }
}"""
STATIC_DATA = '@prefix ex: <http://e/> . ex:room0 ex:label "Kitchen" . ex:room1 ex:label "Hall" .'


@pytest.mark.usefixtures("port_device_program")
def test_static_query_trace_matches_reference():
    events = [(":s", (f"<http://e/room{i % 3}>", "<http://e/temp>", f'"{20 + i % 4}"'), i)
              for i in range(1, 14)]
    want, _ = trace("ref", STATIC_QUERY, events, static=STATIC_DATA)
    got, _ = trace("port", STATIC_QUERY, events, static=STATIC_DATA, mode="device")
    assert got == want and any(want)
    assert all(dict(r)["room"] != "http://e/room2" for b in got for r in b)


def _drain(engine, timeout=20.0):
    """Stop a multi-thread engine and wait for its worker threads."""
    engine.stop()
    for t in engine._window_threads:
        t.join(timeout)


@pytest.mark.usefixtures("port_device_program")
def test_multi_thread_single_window_matches_reference():
    events = knows_stream(90, 5, seed=8)
    q = reach_query("RSTREAM")
    want, _ = trace("ref", q, events, rules=KNOWS_RULES)
    sink: list = []
    engine = build("port", q, rules=KNOWS_RULES, mode="device", multi=True, sink=sink)
    for stream, (s, p, o), ts in events:
        engine.add_to_stream(stream, port.WindowTriple(s, p, o), ts)
    _drain(engine)
    assert sorted(sink) == sorted(r for b in want for r in b) and sink


@pytest.mark.usefixtures("port_device_program")
def test_two_window_join_multi_thread():
    """``TestMultiThreadMode.test_two_window_join_multi_thread``."""
    rows: list = []
    engine = build("port", MULTI_QUERY, policy="steal", multi=True, sink=rows)
    try:
        for ts in range(1, 6):
            engine.add_to_stream("http://e/tempStream",
                                 port.WindowTriple("<http://e/room1>", "<http://e/temp>", '"21"'), ts)
            engine.add_to_stream("http://e/humStream",
                                 port.WindowTriple("<http://e/room1>", "<http://e/hum>", '"60"'), ts)
        deadline = time.time() + 10
        while not rows and time.time() < deadline:
            time.sleep(0.05)
    finally:
        engine.stop()
    assert rows
    row = dict(rows[0])
    assert row == {"room": "http://e/room1", "temp": "21", "hum": "60"}


QUERY_SINGLE = """
PREFIX ex: <http://e/>
REGISTER ISTREAM <http://out/stream> AS
SELECT ?s ?o
FROM NAMED WINDOW <http://e/w> ON ?stream [RANGE 3 STEP 1]
WHERE { WINDOW <http://e/w> { ?s ex:val ?o } }
"""


def _val(i, ts):
    return (":stream", (f"<http://e/s{i}>", "<http://e/val>", f'"{i}"'), ts)


@pytest.mark.usefixtures("port_device_program")
def test_istream_range3_step1():
    batches, _ = trace("port", QUERY_SINGLE, [_val(i, ts) for i, ts in enumerate([1, 2, 3, 4], 1)],
                       mode="device")
    assert [dict(r)["o"] for b in batches for r in b] == ["1", "2", "3"]


@pytest.mark.usefixtures("port_device_program")
def test_window_eviction():
    q = """PREFIX ex: <http://e/>
    REGISTER RSTREAM <http://out/s> AS SELECT ?s ?o
    FROM NAMED WINDOW <http://e/w> ON ?stream [RANGE 2 STEP 2]
    WHERE { WINDOW <http://e/w> { ?s ex:val ?o } }"""
    batches, _ = trace("port", q, [_val(i, ts) for i, ts in enumerate([1, 3, 5], 1)])
    assert [dict(r)["o"] for b in batches for r in b] == ["1", "2"]


@pytest.mark.usefixtures("port_device_program")
def test_two_window_join_single_thread():
    ev = [("http://e/tempStream", ("<http://e/room1>", "<http://e/temp>", '"21"'), ts)
          for ts in (1, 2, 3, 4)]
    ev2 = [("http://e/humStream", ("<http://e/room1>", "<http://e/hum>", '"60"'), ts)
           for ts in (1, 2, 3, 4)]
    events = [e for pair in zip(ev, ev2) for e in pair]
    batches, _ = trace("port", MULTI_QUERY, events, policy="steal")
    rows = [dict(r) for b in batches for r in b]
    assert rows and rows[0] == {"room": "http://e/room1", "temp": "21", "hum": "60"}


@pytest.mark.usefixtures("port_device_program")
def test_static_join():
    q = """PREFIX ex: <http://e/>
    REGISTER RSTREAM <http://out/s> AS
    SELECT ?room ?temp ?label
    FROM NAMED WINDOW <http://e/w> ON ?s [RANGE 5 STEP 1]
    WHERE {
      ?room ex:label ?label
      WINDOW <http://e/w> { ?room ex:temp ?temp }
    }"""
    events = [(":s", ("<http://e/room1>", "<http://e/temp>", '"25"'), ts) for ts in range(1, 7)]
    batches, _ = trace("port", q, events, static='@prefix ex: <http://e/> . ex:room1 ex:label "Kitchen" .')
    row = dict(next(r for b in batches for r in b))
    assert row["label"] == "Kitchen" and row["temp"] == "25"


@pytest.mark.usefixtures("port_device_program")
def test_engine_device_mode_exact_trace():
    """``TestDeviceR2R.test_engine_device_mode_exact_trace``."""
    rules = """@prefix ex: <http://e/> .
{ ?s ex:val ?o . } => { ?s ex:seen ?o . } .
"""
    q = """PREFIX ex: <http://e/>
REGISTER ISTREAM <http://out/s> AS SELECT ?s ?o
FROM NAMED WINDOW <http://e/w> ON ?stream [RANGE 3 STEP 1]
WHERE { WINDOW <http://e/w> { ?s ex:seen ?o } }"""
    events = [_val(i, ts) for i, ts in enumerate([1, 2, 3, 4], 1)]
    host, _ = trace("port", q, events, rules=rules, mode="host")
    dev, eng = trace("port", q, events, rules=rules, mode="device")
    assert host == dev and any(host) and eng.r2r._device_ok


# ------------------------------------------------------------ checkpoints


def _decoded(blob: bytes) -> dict:
    """The checkpoint JSON with the R2S memory (a set) in sorted order."""
    state = json.loads(blob.decode("utf-8"))
    state["r2s_last"] = sorted(json.dumps(x) for x in state["r2s_last"])
    return state


def _feed(pkg, engine, events):
    for stream, (s, p, o), ts in events:
        engine.add_to_stream(stream, _wt(pkg, s, p, o), ts)


@pytest.mark.usefixtures("port_device_program")
def test_checkpoint_json_matches_reference():
    events = knows_stream(80, 5, seed=3)
    q = reach_query("ISTREAM")
    engines = {}
    for pkg in ("ref", "port"):
        sink: list = []
        engines[pkg] = build(pkg, q, rules=KNOWS_RULES, sink=sink, mode="host" if pkg == "ref" else "device")
        _feed(pkg, engines[pkg], events)
    want = engines["ref"].checkpoint_state()
    got = engines["port"].checkpoint_state()
    assert _decoded(got) == _decoded(want)
    assert _decoded(got)["r2s_last"], "the ISTREAM memory must be non-empty"


@pytest.mark.parametrize("first,second", [("port", "port"), ("ref", "port"), ("port", "ref")])
@pytest.mark.usefixtures("port_device_program")
def test_restore_continues_the_stream(first, second):
    """Checkpoint mid-stream in one package, restore into a fresh engine of
    the other (or the same): the rows after the restore equal an
    uninterrupted run's."""
    events = knows_stream(120, 5, seed=6)
    q = reach_query("ISTREAM")
    cut = 55
    full, _ = trace("port", q, events, rules=KNOWS_RULES, mode="device")
    sink1: list = []
    e1 = build(first, q, rules=KNOWS_RULES, sink=sink1)
    _feed(first, e1, events[:cut])
    blob = e1.checkpoint_state()
    e1.stop()
    sink2: list = []
    e2 = build(second, q, rules=KNOWS_RULES, sink=sink2)
    e2.restore_state(blob)
    batches = []
    for stream, (s, p, o), ts in events[cut:]:
        e2.add_to_stream(stream, _wt(second, s, p, o), ts)
        batches.append(sorted(sink2))
        sink2.clear()
    e2.process_single_thread_window_results()
    batches.append(sorted(sink2))
    assert batches == full[cut:]
    assert any(batches)


@pytest.mark.usefixtures("port_device_program")
def test_checkpoint_restore_mid_stream():
    """``TestPreemption.test_checkpoint_restore_mid_stream``."""
    events = [_val(i, ts) for i, ts in enumerate([1, 2, 3, 4, 5], 1)]
    ref, _ = trace("port", QUERY_SINGLE, events)
    part1: list = []
    e1 = build("port", QUERY_SINGLE, sink=part1)
    _feed("port", e1, events[:2])
    blob = e1.checkpoint_state()
    e1.stop()
    part2: list = []
    e2 = build("port", QUERY_SINGLE, sink=part2)
    e2.restore_state(blob)
    _feed("port", e2, events[2:])
    assert [dict(r)["o"] for r in part1 + part2] == [dict(r)["o"] for b in ref for r in b]


CW_QUERY = """PREFIX ex: <http://e/>
REGISTER RSTREAM <http://out/s> AS
SELECT ?room ?v
FROM NAMED WINDOW <http://e/wT/> ON <http://e/tempStream> [RANGE 10 STEP 2]
FROM NAMED WINDOW <http://e/wH/> ON <http://e/humStream> [RANGE 10 STEP 2]
WHERE {
  WINDOW <http://e/wT/> { ?room <alerted> ?v }
  WINDOW <http://e/wH/> { ?room <humid> ?w }
}"""
CW_RULES = """@prefix t: <http://e/wT/> .
@prefix h: <http://e/wH/> .
{ ?room t:hot ?v . ?room h:humid ?w . } => { ?room t:alerted ?v . } ."""


@pytest.mark.usefixtures("port_device_program")
def test_restore_rejects_cross_window_state():
    """A checkpoint carrying cross-window state (the SDS+ expiry map and the
    latest raw window contents) is no longer rejected: the reference's blob
    restores into the port's engine and the port's into the reference's,
    and each continues with the uninterrupted run's rows."""
    def cw_engine(pkg, sink):
        return (_builder(pkg, CW_QUERY).set_cross_window_rules(CW_RULES)
                .set_cross_window_reasoning_mode("incremental").with_consumer(sink.append).build())

    def feed(pkg, engine, ticks):
        for ts in ticks:
            engine.add_to_stream("http://e/tempStream", _wt(pkg, "r1", "hot", '"42"'), ts)
            engine.add_to_stream("http://e/humStream", _wt(pkg, "r1", "humid", '"x"'), ts)
        engine.process_single_thread_window_results()

    full: list = []
    feed("ref", cw_engine("ref", full), range(1, 6))
    assert full
    for first, second in (("ref", "port"), ("port", "ref")):
        part1: list = []
        e1 = cw_engine(first, part1)
        feed(first, e1, (1, 2))
        state = json.loads(e1.checkpoint_state())
        assert state["sds_plus"] and state["latest_contents"]
        part2: list = []
        e2 = cw_engine(second, part2)
        e2.restore_state(e1.checkpoint_state())
        feed(second, e2, (3, 4, 5))
        assert [dict(r)["v"] for r in part1 + part2] == [dict(r)["v"] for r in full]


# ------------------------------------------------------------ supervision


@pytest.mark.usefixtures("port_device_program")
def test_dead_letters_match_reference():
    """A firing that fails twice (first try and the retry) is dead-lettered
    and the stream goes on, in both packages alike."""
    events = knows_stream(60, 5, seed=9)
    q = reach_query("RSTREAM")
    runs = {}
    for pkg, plan in (("ref", RefFaultPlan(seed=1).add("rsp.window", error=RefInjected, at_calls=[3, 4])),
                      ("port", FaultPlan(seed=1).add("rsp.window", error=InjectedCompileError, at_calls=[3, 4]))):
        with plan.installed():
            batches, engine = trace(pkg, q, events, rules=KNOWS_RULES)
        runs[pkg] = (batches, [(d.window_iri, d.ordinal) for d in engine.dead_letters],
                     engine.resilience_stats())
    assert runs["port"] == runs["ref"]
    assert runs["port"][1] == [("http://e/w", 3)]


def test_device_failure_is_dead_lettered_not_rerun(monkeypatch):
    """No hidden fallback: a failing fixpoint raises inside the firing, the
    supervisor retries and dead-letters it, nothing runs on the host and
    the device route stays on."""
    def boom(*a, **k):
        raise RuntimeError("device fixpoint capacities failed to converge")

    monkeypatch.setattr(tfx.DeviceFixpoint, "infer_padded", boom)
    batches, engine = trace("port", reach_query("RSTREAM"), knows_stream(40, 4, seed=1),
                            rules=KNOWS_RULES, mode="device")
    assert not any(batches)
    assert engine.dead_letters and all("converge" in d.error for d in engine.dead_letters)
    assert engine.r2r._device_ok


@pytest.mark.usefixtures("port_device_program")
def test_device_failure_after_a_good_firing_emits_nothing(monkeypatch):
    """A fixpoint that fails from the second device run on: every later
    firing is dead-lettered and emits no row, rather than answering over the
    previous firing's closure; the firings before it equal the clean run."""
    events = knows_stream(60, 4, seed=1)
    q = reach_query("RSTREAM")
    want, _ = trace("port", q, events, rules=KNOWS_RULES, mode="device")
    real, runs = tfx.DeviceFixpoint.infer_padded, []

    def first_only(self, *a, **k):
        runs.append(1)
        if len(runs) > 1:
            raise RuntimeError("device lost")
        return real(self, *a, **k)

    monkeypatch.setattr(tfx.DeviceFixpoint, "infer_padded", first_only)
    sink: list = []
    engine = build("port", q, rules=KNOWS_RULES, mode="device", sink=sink)
    got, dead = [], []
    for stream, (s, p, o), ts in events:
        engine.add_to_stream(stream, _wt("port", s, p, o), ts)
        got.append(sorted(sink))
        sink.clear()
        dead.append(len(engine.dead_letters))
    k = next(i for i, d in enumerate(dead) if d)
    assert any(got[:k]) and got[:k] == want[:k]
    assert not any(got[k:])
    assert len(runs) > 2 and all("device lost" in d.error for d in engine.dead_letters)


def test_mqo_stats_match_reference():
    engines = [build(pkg, MULTI_QUERY, sink=[]) for pkg in ("ref", "port")]
    assert engines[1].mqo_stats() == engines[0].mqo_stats()
    assert engines[1].mqo_stats()["standing"] == 2
    for e in engines:
        e.stop()
    assert engines[1].mqo_stats() == engines[0].mqo_stats()
    assert engines[1].mqo_stats()["standing"] == 0


# ------------------------------------------------------ phase 7 rehearsal


def test_chip_smoke_phase7_rehearsal(monkeypatch):
    """``chip_smoke.py`` phase 7 on the CPU at 2,000 persons and 50 events
    a tick (the same out-degree, 3 a window): rows and derived counts equal
    the host R2R's firing by firing and the first three equal the host R2R's
    over the oracle's prefix of the stream, five full-width firings, and every
    warm firing calls the fused filter and the merge path (counted at the
    wrappers: the CPU launches no kernel)."""
    import chip_smoke as CS
    from kolibrie_tpu_torch.ops import kernels as K

    merge_path, filter_mask = K.merge_path, tfx.filter_mask

    def count(name, fn):
        def wrapped(*a):
            K.count_launch(name)
            return fn(*a)

        return wrapped

    monkeypatch.setattr(K, "merge_path", count("merge_path_join", merge_path))
    monkeypatch.setattr(tfx, "filter_mask", count("filter_mask", filter_mask))
    stream = CS.rsp_stream(2000, 50, CS.RSP_TICKS, CS.RSP_SEED)
    card = CS.run_rsp(CPU, "device", stream)
    host = CS.run_rsp(CPU, "host", stream)
    prefix = CS.run_rsp(CPU, "host", CS.rsp_prefix(stream, CS.RSP_CPU_TICKS))
    CS.check_rsp(card, host, CS.RSP_WIDTH * 50, CS.RSP_LAUNCHES, prefix)
    assert len(prefix["firings"]) == 3
    assert len(card["firings"]) == 4
    assert all(f["derived"] > 10_000 for f in card["firings"][1:])
    assert card["captured"]["filter_mask"][0] > 0 and card["captured"]["merge_path_join"][1]
    K.reset_launches()


@pytest.mark.parametrize("fault", ["none", "rows", "derived", "short", "dead_letter"])
def test_phase7_gate_holds_the_card_to_the_cpu_prefix(fault):
    """``check_rsp`` fails when the card's firing differs from the CPU run's
    over the prefix, or when that run is too short or dead-lettered."""
    import chip_smoke as CS

    def run(n):
        firings = [{"content": 100, "rows": [(("a", str(k)),)], "derived": k, "launches": {}} for k in range(n)]
        return {"device_ok": True, "dead_letters": [], "firings": firings}

    card, host, cpu = run(6), run(6), run(3)
    if fault == "rows":
        cpu["firings"][1]["rows"] = []
    elif fault == "derived":
        cpu["firings"][2]["derived"] += 1
    elif fault == "short":
        cpu["firings"] = cpu["firings"][:1]
    elif fault == "dead_letter":
        cpu["dead_letters"] = ["firing 1"]
    if fault == "none":
        CS.check_rsp(card, host, 100, {}, cpu)
    else:
        with pytest.raises(AssertionError):
            CS.check_rsp(card, host, 100, {}, cpu)


@pytest.mark.usefixtures("port_device_program")
def test_firings_record_span_and_metrics():
    """Each firing records the ``rsp.window.fire`` span and observes the
    window's fire-latency and event-lag histograms."""
    from kolibrie_tpu_torch.obs import metrics, spans
    from kolibrie_tpu_torch.rsp import engine as E

    spans.clear()
    before = E._WINDOW_FIRE_LAT.labels("http://e/w").count
    lag_before = E._EVENT_LAG.labels("http://e/w").count
    batches, engine = trace("port", QUERY_SINGLE, [_val(i, ts) for i, ts in enumerate([1, 2, 3, 4], 1)])
    fired = engine.supervisors[0].snapshot()["processed"]
    assert fired == 4
    assert [s["attrs"]["window"] for s in spans.spans_snapshot() if s["name"] == "rsp.window.fire"] == [
        "http://e/w"
    ] * fired
    assert E._WINDOW_FIRE_LAT.labels("http://e/w").count - before == fired
    assert E._EVENT_LAG.labels("http://e/w").count - lag_before == fired
    assert metrics.REGISTRY.get("kolibrie_rsp_window_fire_seconds") is not None
