"""EXPLAIN ANALYZE capture: a thread-local sink for per-operator
actuals harvested from a single dispatch.

The engine computes a device-resident stats dict alongside every
result (see ``device_engine._plan_body``); fetching it costs a host
sync, so the engine only does that fetch when a capture is *active*.
This module is that switch plus the bucket the fetched numbers land in.

Stdlib-only by design (same import discipline as :mod:`spans` /
:mod:`metrics`): the engine imports us, never the reverse.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

_tls = threading.local()


class Capture:
    """Accumulates analyze records for one dispatch.

    ``records`` is a list of dicts, each tagged with a ``kind``:

    - ``device``:  specialized-path per-operator stats (key -> rows)
    - ``interp``:  interpreter per-op rows + opcode dispatch counts
    - ``sharded``: per-member, per-shard row/exchange totals
    """

    __slots__ = ("records",)

    def __init__(self) -> None:
        self.records: List[Dict[str, Any]] = []

    def record(self, kind: str, **payload: Any) -> None:
        entry: Dict[str, Any] = {"kind": kind}
        entry.update(payload)
        self.records.append(entry)

    def last(self, kind: Optional[str] = None) -> Optional[Dict[str, Any]]:
        for entry in reversed(self.records):
            if kind is None or entry["kind"] == kind:
                return entry
        return None


def active() -> Optional[Capture]:
    """The capture currently open on this thread, or None.

    Hot paths must treat None as "skip the stats fetch entirely" so an
    uninstrumented dispatch pays nothing beyond computing the (fused,
    already-resident) stats vector.
    """
    return getattr(_tls, "capture", None)


@contextmanager
def capture() -> Iterator[Capture]:
    """Open an analyze capture on this thread.  Nested captures see
    only their own records; the outer capture resumes on exit."""
    prev = getattr(_tls, "capture", None)
    cap = Capture()
    _tls.capture = cap
    try:
        yield cap
    finally:
        _tls.capture = prev


def record(kind: str, **payload: Any) -> None:
    """Record into the active capture, if any.  Cheap no-op otherwise."""
    cap = active()
    if cap is not None:
        cap.record(kind, **payload)
