"""Span tracing of ``kolibrie_tpu/obs/spans.py``, for the PyTorch port.

The model is deliberately small — a strict subset of OpenTelemetry's,
with zero dependencies and zero background threads:

- a **trace** is a generated 128-bit hex id carried in a thread-local;
- a **span** is a named timed section opened with the :func:`span`
  context manager; nesting builds the parent chain on a thread-local
  stack;
- finished spans land in one process-wide bounded ring buffer
  (``collections.deque(maxlen=…)``), read with :func:`spans_snapshot`;
- :func:`trace_scope` installs a trace id (EXPLAIN ANALYZE reads its
  spans back);
- **baggage** is a tiny k→v dict riding along with the trace so the
  executor can tell the device engine which template fingerprint it is
  lowering without threading an argument through six call frames.

The JSONL export comes with the serving slice, which reads it.
Everything is a no-op when
:func:`kolibrie_tpu_torch.obs.runtime.enabled` is False.
"""

from __future__ import annotations

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


def new_trace_id() -> str:
    return f"{_rand.getrandbits(128):032x}"


def current_trace_id() -> Optional[str]:
    """The active trace id on this thread, or None."""
    return _ctx()["trace_id"]


def current_span_id() -> Optional[str]:
    stack = _ctx()["stack"]
    return stack[-1].span_id if stack else None


@contextmanager
def trace_scope(trace_id: Optional[str] = None):
    """Install ``trace_id`` (or a fresh one) as this thread's active
    trace.  Saves and restores any enclosing context, including baggage,
    so scopes nest."""
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
    per-firing hot path, where ``@contextmanager`` generator machinery is
    measurable."""

    __slots__ = ("name", "attrs", "ctx", "sp", "implicit")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> Span:
        ctx = self.ctx = _ctx()
        self.implicit = ctx["trace_id"] is None
        if self.implicit:
            # An outermost span opens its own trace; nested spans join it.
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


def clear() -> None:
    with _ring_lock:
        _ring.clear()


def spans_snapshot(trace_id: Optional[str] = None) -> List[dict]:
    with _ring_lock:
        spans = list(_ring)
    if trace_id is not None:
        spans = [s for s in spans if s.trace_id == trace_id]
    return [s.to_dict() for s in spans]

