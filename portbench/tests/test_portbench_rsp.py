"""The stream cell ``citybench.rsp`` on the CPU at a small size (720 roads,
180 lots, the published windows): its run, judge and control; the control
and three faults a cycle can have come out not correct; the generator is
seeded; and the readers of its spans, by hand, read nothing where the
program records no such span."""

import time
from collections import Counter

import pytest
import torch

from portbench import check, run, spec
from portbench.loops import stream as L
from portbench.stream_gen import CityStream

SEED = 2**31 + 23


def tiny() -> dict:
    c = spec.cell("citybench.rsp")
    c["config"].update(roads=720, lots=180)
    return c


@pytest.fixture(scope="module")
def ran():
    c = tiny()
    out = L.run(c, SEED, 0.2, False, torch.device("cpu"))
    out.pop("db")
    return c, out


def _judge(c, out):
    return L.judge(c, out, check.Reference(c["config"], out["graph"]))


def test_the_cell_is_correct_and_reports_its_rate(ran):
    c, out = ran
    checks = _judge(c, out)
    assert check.correct(checks), checks
    assert out["e2e"]["queries_per_s"] > 0 and out["requests"] >= 1
    assert out["attempted"] == out["requests"] and out["failed"] == 0
    # the warm-up's four cycles, then the window's, each a close of 60 ticks
    assert [b["tick"] // 60 for b in out["batches"]] == list(range(1, len(out["batches"]) + 1))
    # full width: every road once in the traffic window, every lot once
    full = out["batches"][-1]
    assert full["windows"] == {"http://city/wT/": 720, "http://city/wP/": 180}
    assert len(full["rows"]) == full["n_rows"] == 180


def test_the_control_is_not_correct(ran):
    c, out = ran
    assert not check.correct(_judge(c, L.control(c, out)))


def _fault(out, k, rows):
    batches = [dict(b) for b in out["batches"]]
    batches[k]["rows"] = rows([b["rows"] for b in batches])
    return dict(out, batches=batches)


@pytest.mark.parametrize("fault", ["previous answer", "half dropped", "one speed altered"])
def test_a_faulty_cycle_is_not_correct(ran, fault):
    c, out = ran
    k = len(out["batches"]) - 1

    def altered(bs):
        rows = list(bs[k])
        lot, road, (name, speed) = rows[0]
        rows[0] = (lot, road, (name, str(int(speed) + 1)))
        return rows

    bad = {
        "previous answer": lambda bs: bs[k - 1],
        "half dropped": lambda bs: bs[k][: len(bs[k]) // 2],
        "one speed altered": altered,
    }[fault]
    checks = _judge(c, _fault(out, k, bad))
    assert not check.correct(checks), checks


def test_a_cycle_missing_counts_its_rows(ran):
    c, out = ran
    checks = _judge(c, dict(out, batches=out["batches"][:-1]))
    assert checks["rows_mismatched"]["value"] == 180


def test_the_stream_is_seeded():
    config = tiny()["config"]
    a, b, other = CityStream(config, SEED), CityStream(config, SEED), CityStream(config, SEED + 1)
    assert a.events(7) == b.events(7) != other.events(7)
    assert [e[0] for e in a.events(7)].count("http://city/traffic") == 6
    # one tick's ids name the terms its events carry
    (s, p, o), = [v for k, v in a.columns(7).items() if k == "http://city/traffic"]
    assert [(a.term(x), p, a.term(y)) for x, y in zip(s.tolist(), o.tolist())] == [
        e[1:] for e in a.events(7) if e[0] == "http://city/traffic"]
    full = spec.cell("citybench.rsp")["config"]
    big = CityStream(full, SEED)
    # every road thrice and every lot twice in 360 ticks: 29,166.7 a STEP
    assert sum(big.count(t) for t in range(1, 361)) == 3 * 50_000 + 2 * 12_500


def test_a_traced_run_reads_its_spans_on_the_cpu():
    result = run.run(tiny(), SEED, 0.2, True, torch.device("cpu"), time.perf_counter())
    assert result["correct"]
    got = result["metrics"]
    # the device's readers read the profiler's trace, which a CPU run has not
    assert set(got) == {"load_s", "ingest_ms.rsp", "cw_reason_ms.rsp", "cw_query_ms.rsp"}
    assert all(v["value"] > 0 for v in got.values())


def _sp(name, sid, parent=None, dur_ms=1.0, **attrs):
    return {"name": name, "span_id": sid, "parent_id": parent, "dur_ms": dur_ms,
            "start_s": 0.0, "attrs": attrs}


SPANS = [
    _sp("rsp.window.fire", "f1", dur_ms=5.0),
    _sp("rsp.cw.cycle", "c1", dur_ms=900.0, ts=299, mode="incremental", facts=75000, rows=12500),
    _sp("rsp.cw.sds", "s1", "c1", 100.0, triples=62500, new=29000),
    _sp("sds.reason", "r1", "c1", 400.0, mode="incremental"),
    _sp("provenance.fixpoint", "x1", "r1", 50.0, rounds=2, attempts=0),
    _sp("rsp.cw.query", "q1", "c1", 300.0, rows=25000),
    _sp("rsp.cw.cycle", "c2", dur_ms=1100.0, ts=359, mode="incremental", facts=75000, rows=12500),
    _sp("sds.reason", "r2", "c2", 600.0, mode="incremental"),
    _sp("rsp.cw.query", "q2", "c2", 350.0, rows=25000),
]


def _read(name, spans, requests=2, window_s=5.0):
    return run.read_metric(name, {"spans": spans, "requests": requests, "window_s": window_s})


def test_the_readers_of_the_cycle_spans():
    assert _read("ingest_ms.rsp", SPANS) == pytest.approx((5000.0 - 2000.0) / 2)
    assert _read("cw_reason_ms.rsp", SPANS) == pytest.approx(500.0)
    assert _read("cw_query_ms.rsp", SPANS) == pytest.approx(325.0)


@pytest.mark.parametrize("name", ["ingest_ms.rsp", "cw_reason_ms.rsp", "cw_query_ms.rsp"])
def test_a_program_without_the_spans_reads_nothing(name):
    # the parent records the windows' firings alone
    assert _read(name, [_sp("rsp.window.fire", "f1")]) is None
    assert _read(name, []) is None
    assert run.read_metric(name, {}) is None


def test_the_readers_of_the_device_trace():
    timeline = {"window_s": 30.0, "busy_s": 0.06, "ops": 19040,
                "kernel_s": {"filter_mask": 2.8e-4, "merge_path_join": 1.9e-4}}
    kernels = {"filter_mask": (128, 5.16e7), "merge_path_join": (64, 6.83e6)}
    ctx = {"timeline": timeline, "kernels": kernels, "peaks": {"hbm_bytes_per_s": 3.35e12}}
    assert run.read_metric("device_idle_pct.rsp", ctx) == pytest.approx(99.8)
    bound_s = (5.16e7 + 6.83e6) / 3.35e12
    assert run.read_metric("kernel_roofline_pct.rsp", ctx) == pytest.approx(
        100 * bound_s / 4.7e-4)
    # a run with no device operation, or no port kernel, reads nothing
    assert run.read_metric("device_idle_pct.rsp", dict(ctx, timeline=dict(timeline, ops=0))) is None
    assert run.read_metric("kernel_roofline_pct.rsp", dict(ctx, kernels={})) is None
    assert run.read_metric("device_idle_pct.rsp", {}) is None


def test_bag_mismatch_counts_both_ways():
    want = Counter({("a",): 2, ("b",): 1})
    assert check.bag_mismatch([("a",), ("c",)], want) == 3
