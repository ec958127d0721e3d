"""Lightweight span tracing with thread-local context propagation.

The model is deliberately small — a strict subset of OpenTelemetry's,
with zero dependencies and zero background threads:

- a **trace** is a string id (client-supplied via ``X-Kolibrie-Trace-Id``
  or a generated 128-bit hex string) carried in a thread-local;
- a **span** is a named timed section opened with the :func:`span`
  context manager; nesting builds the parent chain via the same
  thread-local stack :mod:`kolibrie_tpu_torch.resilience.deadline` uses for
  deadlines;
- finished spans land in one process-wide bounded ring buffer
  (``collections.deque(maxlen=…)``) exportable as JSONL — there is no
  exporter pipeline, a scrape of ``GET /debug/traces`` IS the export;
- **baggage** is a tiny k→v dict riding along with the trace so the
  executor can tell the device engine which template fingerprint it is
  lowering without threading an argument through six call frames.

Threads do not inherit context automatically.  Code that hops threads
(the batcher leader dispatching for its followers) captures
:func:`current_trace_id` at submit time and re-enters it with
:func:`trace_scope` on the other side — exactly how the deadline is
propagated today.

Everything is a no-op when :func:`kolibrie_tpu_torch.obs.runtime.enabled`
is False.

The clock: a span's ``start_s`` is Unix-epoch wall time
(``time.time()``), the clock ``torch.profiler`` stamps its events on
(Kineto's timestamps are Unix-epoch nanoseconds), so a span and a
profiled device interval compare directly; ``portbench/trace.py`` names
each idle gap of the card by the span open at its middle this way.
``dur_ms`` is measured on ``time.perf_counter()``.  Moving ``start_s``
to another clock would break that matching.

Spans the port records beyond the table of ``docs/OBSERVABILITY.md``
(which describes the reference), with their attributes:

- ``query.decode`` (query/executor): ``format_results``' ID→string
  decode and row sort; ``rows``, ``path`` (``quoted`` or ``display``).
- ``device.wait`` (optimizer/device_engine, plan_interp, mqo;
  reasoner/device_fixpoint, device_provenance): the host blocked on one
  device→host readback; ``site``, the fetch audit's site name, or
  ``fixpoint.round`` / ``provenance.round`` for a fixpoint round's one
  sync, which the audit does not count.
- ``reasoner.fixpoint`` (reasoner/device_fixpoint): as in the reference
  (``facts``), around ``infer`` and ``infer_chunked``, with ``rounds`` and
  ``derived`` on exit.
- ``fixpoint.lower``: ``lower_rules`` and the mask bank in
  ``DeviceFixpoint.__init__``.
- ``fixpoint.round``: one semi-naive round; ``round``, ``delta_rows``, and
  on exit ``candidate_rows`` (the compacted candidate rows the round puts
  through its dedup, the candidate capacity), ``block_rows`` (the
  candidate blocks' static lengths), ``candidate_valid`` (the live
  candidate rows among them, read in the round's one sync),
  ``new_facts``, ``code`` (the overflow bits; bit4, 16, the candidate
  capacity).  ``infer``'s round that overflows does not commit and is
  retried under a span of its own; ``infer_chunked`` retries a round
  inside its span, whose ``code`` holds the bits of every attempt and
  whose row counts sum them.
- ``fixpoint.writeback``: ``materialize_to_host``; ``rows``.
- ``rsp.cw.cycle`` (rsp/engine): one cross-window SDS+ cycle, from the
  SDS build to the consumer's last row; ``ts`` (the cycle's time), and
  ``mode`` (``incremental`` or ``naive``, what AUTO picked), ``facts``
  (the SDS+ facts in the windows' buckets) and ``rows`` (the rows R2S fed)
  on exit.  Each cycle also counts in
  ``kolibrie_rsp_cross_window_cycles_total{mode}``.
- ``rsp.cw.sds``: the SDS built from the latest window contents;
  ``triples`` (window triples) and ``new`` (those not in the last cycle's
  memo).
- ``sds.reason`` (reasoner/cross_window): ``incremental_sds_plus`` or
  ``naive_sds_plus`` whole; ``mode``, ``facts`` (the closure's input
  facts), ``d_new`` (its first delta: the facts new or with a later expiry,
  every fact in naive mode), ``derived``.
- ``rsp.cw.query`` (rsp/engine): the per-window buckets (in incremental
  mode, from the carried state), their databases, plans and decoding;
  ``rows`` (over every window's result).
- ``provenance.fixpoint`` (reasoner/device_provenance): the device tagged
  fixpoint once it takes the program (upload, rounds, write-back);
  ``facts``, ``semiring``, and ``rounds`` and ``attempts`` (the rounds that
  overflowed and were retried) on exit.
- ``provenance.round``: one dispatch of the tagged fixpoint; ``kind``
  (``round``, ``round_addmult``, ``naf``, ``naf_addmult``), ``delta_rows``,
  and ``code`` (the overflow bits) on exit.  Its one scalar readback is a
  ``device.wait`` with ``site=provenance.round``.

Copy of ``kolibrie_tpu/obs/spans.py`` for the PyTorch port, its imports
rewritten.
"""

from __future__ import annotations

import json
import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from kolibrie_tpu_torch.obs import runtime

DEFAULT_RING_CAPACITY = 4096

_tls = threading.local()

# ids only need uniqueness, not unpredictability; getrandbits is ~10x
# cheaper than uuid4 and atomic under the GIL (C-implemented method on a
# shared Mersenne twister seeded from os.urandom)
_rand = random.Random()

_ring_lock = threading.Lock()
_ring: deque = deque(maxlen=DEFAULT_RING_CAPACITY)  # guarded by: _ring_lock


class Span:
    __slots__ = (
        "trace_id",
        "span_id",
        "parent_id",
        "name",
        "start_s",
        "_t0",
        "dur_ms",
        "attrs",
        "error",
    )

    def __init__(self, trace_id: str, parent_id: Optional[str], name: str,
                 attrs: Dict[str, Any]):
        self.trace_id = trace_id
        self.span_id = f"{_rand.getrandbits(64):016x}"
        self.parent_id = parent_id
        self.name = name
        self.start_s = time.time()
        self._t0 = time.perf_counter()
        self.dur_ms: float = 0.0
        self.attrs = attrs
        self.error: Optional[str] = None

    def finish(self) -> None:
        self.dur_ms = (time.perf_counter() - self._t0) * 1000.0

    def to_dict(self) -> dict:
        d = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start_s": round(self.start_s, 6),
            "dur_ms": round(self.dur_ms, 4),
        }
        if self.attrs:
            d["attrs"] = self.attrs
        if self.error is not None:
            d["error"] = self.error
        return d


# ------------------------------------------------------------------ context


def _ctx():
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        ctx = _tls.ctx = {"trace_id": None, "stack": [], "baggage": {}}
    return ctx


def current_trace_id() -> Optional[str]:
    """The active trace id on this thread, or None."""
    return _ctx()["trace_id"]


def current_span_id() -> Optional[str]:
    stack = _ctx()["stack"]
    return stack[-1].span_id if stack else None


def new_trace_id() -> str:
    return f"{_rand.getrandbits(128):032x}"


@contextmanager
def trace_scope(trace_id: Optional[str] = None):
    """Install ``trace_id`` (or a fresh one) as this thread's active
    trace.  Saves and restores any enclosing context, including baggage,
    so scopes nest — the batcher leader can re-enter each follower's
    trace while holding its own."""
    ctx = _ctx()
    prior = (ctx["trace_id"], ctx["stack"], ctx["baggage"])
    ctx["trace_id"] = trace_id or new_trace_id()
    ctx["stack"] = []
    ctx["baggage"] = {}
    try:
        yield ctx["trace_id"]
    finally:
        ctx["trace_id"], ctx["stack"], ctx["baggage"] = prior


class _NoopScope:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP = _NoopScope()


class _SpanScope:
    """Hand-rolled context manager: the span enter/exit pair sits on the
    per-query hot path, where ``@contextmanager`` generator machinery is
    measurable (bench.py's obs overhead budget is 3%)."""

    __slots__ = ("name", "attrs", "ctx", "sp", "implicit")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> Span:
        ctx = self.ctx = _ctx()
        self.implicit = ctx["trace_id"] is None
        if self.implicit:
            # A span outside any trace_scope (library use, tests) still
            # gets recorded, under its own single-span trace.
            ctx["trace_id"] = new_trace_id()
        stack = ctx["stack"]
        parent = stack[-1].span_id if stack else None
        sp = self.sp = Span(ctx["trace_id"], parent, self.name, self.attrs)
        stack.append(sp)
        return sp

    def __exit__(self, exc_type, exc, tb):
        sp = self.sp
        if exc_type is not None:
            sp.error = f"{exc_type.__name__}: {exc}"
        sp.finish()
        ctx = self.ctx
        stack = ctx["stack"]
        if stack and stack[-1] is sp:
            stack.pop()
        if self.implicit:
            ctx["trace_id"] = None
            ctx["baggage"] = {}
        with _ring_lock:
            _ring.append(sp)
        return False


def span(name: str, **attrs):
    """Open a named timed section.  Records a finished span into the
    ring on exit; ``with span(...) as sp`` yields the :class:`Span` (or
    None when disabled) so callers can attach attrs discovered
    mid-flight."""
    if not runtime.enabled():
        return _NOOP
    return _SpanScope(name, attrs)


# ------------------------------------------------------------------ baggage


def set_baggage(key: str, value: Any) -> None:
    if runtime.enabled():
        _ctx()["baggage"][key] = value


def get_baggage(key: str, default: Any = None) -> Any:
    return _ctx()["baggage"].get(key, default)


# --------------------------------------------------------------------- ring


def set_ring_capacity(n: int) -> None:
    """Resize the span ring (drops existing spans).  Test hook."""
    global _ring
    with _ring_lock:
        _ring = deque(_ring, maxlen=int(n))


def clear() -> None:
    with _ring_lock:
        _ring.clear()


def spans_snapshot(trace_id: Optional[str] = None) -> List[dict]:
    with _ring_lock:
        spans = list(_ring)
    if trace_id is not None:
        spans = [s for s in spans if s.trace_id == trace_id]
    return [s.to_dict() for s in spans]


def export_jsonl(trace_id: Optional[str] = None) -> str:
    """The ring (optionally one trace), one JSON object per line."""
    return "\n".join(
        json.dumps(d, sort_keys=True) for d in spans_snapshot(trace_id)
    )
