"""The readers of the program's spans, by hand: result decoding and the
host's enqueue a query (a dispatch less the waits inside it), candidate
rows a materialisation job; each reads nothing where the program records
no such span, as a program without these spans does."""

import time

import pytest
import torch

from conftest import tiny_cell
from portbench import run


def _sp(name, sid, parent=None, dur_ms=1.0, start_s=0.0, **attrs):
    d = {"name": name, "span_id": sid, "parent_id": parent, "dur_ms": dur_ms, "start_s": start_s}
    if attrs:
        d["attrs"] = attrs
    return d


def _read(name, spans, requests=1):
    return run.read_metric(name, {"spans": spans, "requests": requests})


def test_decode_ms_is_the_decode_spans_a_query():
    spans = [_sp("query.execute", "e1", dur_ms=100.0), _sp("query.decode", "d1", "e1", 30.0),
             _sp("query.execute", "e2", dur_ms=50.0), _sp("query.decode", "d2", "e2", 6.0),
             _sp("device.collect", "c2", "e2", 9.0)]
    assert _read("decode_ms.analytic", spans, requests=2) == pytest.approx(18.0)


def test_enqueue_ms_subtracts_each_wait_from_its_own_dispatch_only():
    spans = [
        _sp("query.execute", "e1", dur_ms=400.0),
        _sp("device.dispatch", "x1", "e1", 300.0),
        _sp("device.wait", "w1", "x1", 40.0, site="converge.counts"),
        _sp("device.collect", "c1", "e1", 20.0),
        _sp("device.wait", "w2", "c1", 15.0, site="to_table"),     # not a dispatch's
        _sp("query.execute", "e2", dur_ms=200.0),
        _sp("device.dispatch", "x2", "e2", 100.0),
        _sp("interp.dispatch", "i2", "x2", 60.0),
        _sp("device.wait", "w3", "i2", 25.0, site="interp.counts"),  # a grandchild
        _sp("device.wait", "w4", None, 7.0, site="fixpoint.round"),  # under no dispatch
    ]
    # (300 - 40) + (100 - 25), over two queries
    assert _read("enqueue_ms.analytic", spans, requests=2) == pytest.approx(167.5)


def test_candidate_rows_is_the_rounds_candidates_a_job():
    spans = []
    for job in range(2):
        root = f"f{job}"
        spans.append(_sp("reasoner.fixpoint", root, facts=100, rounds=3, derived=40))
        spans.append(_sp("fixpoint.lower", f"l{job}", root))
        for k in range(3):
            spans.append(_sp("fixpoint.round", f"r{job}{k}", root, round=k, delta_rows=10,
                             candidate_rows=1000 + job, new_facts=5, code=0))
            spans.append(_sp("device.wait", f"w{job}{k}", f"r{job}{k}", site="fixpoint.round"))
        spans.append(_sp("fixpoint.writeback", f"b{job}", root, rows=40))
    assert _read("candidate_rows.materialize", spans, requests=2) == pytest.approx(3001.5)


@pytest.mark.parametrize("name", ["decode_ms.analytic", "enqueue_ms.analytic",
                                  "candidate_rows.materialize"])
def test_a_program_without_the_spans_reads_nothing(name):
    # the parent's spans: the engine's three and no others
    engine = [_sp("query.execute", "e"), _sp("device.lower", "l", "e"),
              _sp("device.dispatch", "x", "e"), _sp("device.collect", "c", "e")]
    for spans in ([], engine, [_sp("fixpoint.round", "r", round=0)]):
        assert _read(name, spans) is None
    assert _read(name, engine, requests=0) is None


def test_a_traced_run_reads_the_new_spans_on_the_cpu():
    c = tiny_cell("lubm100.analytic", 2)
    result = run.run(c, 2**31 + 61, 0.5, True, torch.device("cpu"), time.perf_counter())
    assert result["correct"]
    m = result["metrics"]
    assert {"decode_ms.analytic", "enqueue_ms.analytic", "engine_ms.analytic"} <= set(m)
    assert 0 < m["enqueue_ms.analytic"]["value"] <= m["engine_ms.analytic"]["value"]
    assert m["decode_ms.analytic"]["value"] > 0
