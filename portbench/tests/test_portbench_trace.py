"""The reduction of a profiler timeline to busy and idle time, by hand:
device intervals unioned inside the window or the work marks, gaps named
by the program span or host operation running at their middle."""

import pytest

from portbench.trace import Timeline, reduce_events

MS = 1_000_000


def _ev(name, start_ms, dur_ms, kind="cuda", note=False):
    return (name, int(start_ms * MS), int(dur_ms * MS), kind, note)


def test_busy_is_the_union_inside_the_window():
    events = [
        _ev(Timeline.MARK, 0, 100, "cpu", True),
        _ev(Timeline.MARK, 0, 100, "cuda", True),     # an annotation, not work
        _ev("sort", 10, 20), _ev("scan", 20, 20),     # overlap: 10-40 busy
        _ev("merge_path_join_kernel", 60, 10),
        _ev("late", 95, 20),                          # clipped at 100
        _ev("aten::index", 45, 10, "cpu"),
    ]
    r = reduce_events(events)
    assert r["window_s"] == pytest.approx(0.1)
    assert r["busy_s"] == pytest.approx(0.045)
    assert r["kernel_s"]["merge_path_join"] == pytest.approx(0.010)
    gaps = dict((round(s * 1e3), w) for w, s in r["idle_gaps"])
    assert set(gaps) == {10, 20, 25}
    assert gaps[20] == "aten::index"                  # 40-60: the host op at 50


def test_work_marks_leave_out_what_lies_between():
    events = [
        _ev(Timeline.MARK, 0, 1000, "cpu", True),
        _ev(Timeline.WORK, 0, 100, "cpu", True),
        _ev(Timeline.WORK, 500, 100, "cpu", True),
        _ev("a", 0, 80), _ev("b", 300, 100), _ev("c", 500, 100),
    ]
    r = reduce_events(events)
    assert r["window_s"] == pytest.approx(0.2)
    assert r["busy_s"] == pytest.approx(0.18)
    assert [round(s * 1e3) for _w, s in r["idle_gaps"]] == [20]


def test_a_program_span_names_the_gap():
    events = [_ev(Timeline.MARK, 0, 100, "cpu", True), _ev("a", 0, 10), _ev("b", 90, 10)]
    spans = [{"name": "query.execute", "start_s": 0.0, "dur_ms": 100.0},
             {"name": "device.collect", "start_s": 0.02, "dur_ms": 60.0}]
    r = reduce_events(events, spans)
    assert r["idle_gaps"] == [["device.collect", pytest.approx(0.08)]]


def test_no_device_work_reads_nothing():
    r = reduce_events([_ev(Timeline.MARK, 0, 100, "cpu", True)])
    assert r["ops"] == 0 and r["busy_s"] == 0.0
