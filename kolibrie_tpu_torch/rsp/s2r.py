"""Copy of ``kolibrie_tpu/rsp/s2r.py`` for the PyTorch port; the one change:
``add_to_window`` adds the event in place after the firing decision.

S2R: stream-to-relation windowing — C-SPARQL-style sliding/tumbling
windows.

Parity: ``kolibrie/src/rsp/s2r.rs`` — ``CSPARQLWindow{width, slide, t_0,
active_windows, report, tick}`` (:144-159), ``scope()`` opens every window
covering an event time (:239-271), ``add_to_window`` assigns to open windows,
evicts closed ones, and fires the report strategies on the max-closing window
(:179-238), Tick::TimeDriven gating on app-time progress, consumers via
queue or callback (:272-282), ``ContentContainer`` deduping items keeping the
max timestamp (:91-142), ``WindowTriple{s,p,o}`` (:352-357).

Faithful semantic details preserved from the reference:
- the firing decision AND the emitted content use the window state from
  BEFORE the current event is inserted;
- eviction happens on the same call, after the firing check;
- ``OnContentChange`` compares equal-to-last (reference behavior);
- multiple report strategies must ALL hold.
"""

from __future__ import annotations

import math
import queue
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple


class ReportStrategy:
    NON_EMPTY_CONTENT = "NON_EMPTY_CONTENT"
    ON_CONTENT_CHANGE = "ON_CONTENT_CHANGE"
    ON_WINDOW_CLOSE = "ON_WINDOW_CLOSE"
    PERIODIC = "PERIODIC"

    def __init__(self, kind: str, period: int = 1):
        self.kind = kind
        self.period = period

    @staticmethod
    def from_name(name: str, period: int = 1) -> "ReportStrategy":
        return ReportStrategy(name.upper(), period)


class Tick:
    TIME_DRIVEN = "TIME_DRIVEN"
    TUPLE_DRIVEN = "TUPLE_DRIVEN"
    BATCH_DRIVEN = "BATCH_DRIVEN"


@dataclass(frozen=True)
class Window:
    open: int
    close: int


@dataclass(frozen=True)
class WindowTriple:
    """String-term triple flowing through windows (s2r.rs:352-357)."""

    s: str
    p: str
    o: str


class ContentContainer:
    """Deduplicated window content: item -> max event timestamp."""

    def __init__(self, origin: str = ""):
        self.elements: Dict[object, int] = {}
        self.last_timestamp_changed = 0
        self.origin = origin

    def __len__(self) -> int:
        return len(self.elements)

    def add(self, item, ts: int) -> None:
        prev = self.elements.get(item)
        self.elements[item] = ts if prev is None else max(prev, ts)
        self.last_timestamp_changed = ts

    def get_last_timestamp_changed(self) -> int:
        return self.last_timestamp_changed

    def __iter__(self) -> Iterator:
        return iter(self.elements.keys())

    def iter_with_timestamps(self) -> Iterator[Tuple[object, int]]:
        return iter(self.elements.items())

    def clone(self) -> "ContentContainer":
        c = ContentContainer(self.origin)
        c.elements = dict(self.elements)
        c.last_timestamp_changed = self.last_timestamp_changed
        return c

    def __eq__(self, other):
        return (
            isinstance(other, ContentContainer)
            and self.elements == other.elements
            and self.last_timestamp_changed == other.last_timestamp_changed
            and self.origin == other.origin
        )


class Report:
    def __init__(self):
        self.strategies: List[ReportStrategy] = []
        self.last_change = ContentContainer()

    def add(self, strategy: ReportStrategy) -> None:
        self.strategies.append(strategy)

    def report(self, window: Window, content: ContentContainer, ts: int) -> bool:
        ok = True
        for strategy in self.strategies:
            if strategy.kind == ReportStrategy.NON_EMPTY_CONTENT:
                ok = ok and len(content) > 0
            elif strategy.kind == ReportStrategy.ON_CONTENT_CHANGE:
                # reference behavior: reports when content EQUALS last seen
                comp = content == self.last_change
                self.last_change = content.clone()
                ok = ok and comp
            elif strategy.kind == ReportStrategy.ON_WINDOW_CLOSE:
                ok = ok and window.close <= ts
            elif strategy.kind == ReportStrategy.PERIODIC:
                ok = ok and (ts % max(strategy.period, 1) == 0)
            if not ok:
                return False
        return ok


class CSPARQLWindow:
    """Time-based sliding window operator."""

    def __init__(
        self,
        width: int,
        slide: int,
        report: Optional[Report] = None,
        tick: str = Tick.TIME_DRIVEN,
        uri: str = "",
    ):
        self.width = width
        self.slide = slide
        self.t_0 = 0
        self.app_time = 0
        self.active_windows: Dict[Window, ContentContainer] = {}
        if report is None:
            report = Report()
            report.add(ReportStrategy(ReportStrategy.ON_WINDOW_CLOSE))
        self.report = report
        self.tick = tick
        self.uri = uri
        self.consumer: Optional[queue.Queue] = None
        self.call_back: Optional[Callable[[ContentContainer], None]] = None

    # ---------------------------------------------------------------- scope

    def scope(self, event_time: int) -> None:
        """Open every window [o_i, o_i + width) whose span can cover the
        event time (s2r.rs:239-271)."""
        c_sup = math.ceil(abs(event_time - self.t_0) / self.slide) * self.slide
        o_i = c_sup - self.width
        while True:
            # negative opens clamp to 0 (the reference casts f64 -> usize,
            # which saturates), so early windows are [0, c) prefixes
            w = Window(max(int(o_i), 0), max(int(o_i + self.width), 0))
            if w not in self.active_windows:
                self.active_windows[w] = ContentContainer(self.uri)
            o_i += self.slide
            if o_i > event_time:
                break

    # ----------------------------------------------------------------- add

    def add_to_window(self, event_item, ts: int) -> None:
        event_time = ts
        self.scope(event_time)

        # firing decision on the PRE-add state (reference order)
        candidates = [
            (w, c)
            for w, c in self.active_windows.items()
            if self.report.report(w, c, ts)
        ]
        if candidates:
            max_window = max(candidates, key=lambda wc: wc[0].close)
            if self.tick == Tick.TIME_DRIVEN:
                if ts > self.app_time:
                    self.app_time = ts
                    content = max_window[1].clone()
                    if self.consumer is not None:
                        self.consumer.put(content)
                    if self.call_back is not None:
                        self.call_back(content)

        # next state: windows still covering the event, with the item added
        # in place.  The reference builds it from clones BEFORE the firing
        # decision, which copies every covering window's content on every
        # event; the fired content and the report's memory are clones
        # already, so adding after the decision yields the same state.
        survivors: Dict[Window, ContentContainer] = {}
        for window, content in self.active_windows.items():
            if window.open <= event_time < window.close:
                content.add(event_item, ts)
                survivors[window] = content
        self.active_windows = survivors

    # ------------------------------------------------------------ consumers

    def register(self) -> queue.Queue:
        self.consumer = queue.Queue()
        return self.consumer

    def register_callback(self, fn: Callable[[ContentContainer], None]) -> None:
        self.call_back = fn

    def flush(self) -> None:
        """Emit the merged content of all active windows (s2r.rs flush)."""
        merged = ContentContainer(self.uri)
        for content in self.active_windows.values():
            for item, ts in content.iter_with_timestamps():
                merged.add(item, ts)
        if len(merged) > 0:
            if self.call_back is not None:
                self.call_back(merged)
            if self.consumer is not None:
                self.consumer.put(merged)

    def stop(self) -> None:
        self.consumer = None
        self.call_back = None
