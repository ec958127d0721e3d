"""Structured JSON-lines logging for long-running components.

One record is one JSON object on one line: ``ts`` (unix seconds),
``level``, ``component``, ``msg``, the process-wide ``role`` (primary /
follower / router — set once at startup via :func:`set_role`), the
active ``trace_id`` auto-injected from the span context when one is
live, plus any caller-supplied fields.  A record therefore joins the
span ring on trace id — grep the log tail for a trace and you get the
narrative between its spans.

Two sinks, both cheap:

- an in-memory **tail ring** (bounded deque) that always records, so
  the flight recorder (:mod:`kolibrie_tpu_torch.obs.flightrec`) can dump the
  last N records postmortem without any file I/O on the logging path;
- **stderr**, for operators, gated by :func:`set_quiet` /
  ``KOLIBRIE_LOG_QUIET=1`` — stdout stays reserved for user-facing CLI
  output and the bench's JSON block.

Like :mod:`kolibrie_tpu_torch.obs.spans` this module is stdlib-only and
imports nothing from the engine, so any layer may log without cycles.

Copy of ``kolibrie_tpu/obs/log.py`` for the PyTorch port, its imports
rewritten.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from kolibrie_tpu_torch.obs import spans

DEFAULT_TAIL_CAPACITY = 1024

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}

_lock = threading.Lock()
_tail: deque = deque(maxlen=DEFAULT_TAIL_CAPACITY)  # guarded by: _lock

_role: Optional[str] = None
_node: Optional[str] = None
_quiet: bool = os.environ.get("KOLIBRIE_LOG_QUIET") == "1"
_min_level: int = _LEVELS.get(
    os.environ.get("KOLIBRIE_LOG_LEVEL", "info"), _LEVELS["info"]
)

_loggers: Dict[str, "Logger"] = {}
_loggers_lock = threading.Lock()


def set_role(role: Optional[str]) -> None:
    """Install the process-wide node role stamped on every record."""
    global _role
    _role = role


def get_role() -> Optional[str]:
    return _role


def set_identity(role: str, port: Optional[int] = None) -> None:
    """Role + port in one call: the ``role:port`` node identity is what
    fleet spans carry as their ``node`` attribute, so a stitched trace
    names which process each hop ran on."""
    global _node
    set_role(role)
    _node = f"{role}:{port}" if port is not None else role


def node() -> Optional[str]:
    """The ``role:port`` identity set by :func:`set_identity`, or None
    on processes that never declared one (library use, tests)."""
    return _node


def set_quiet(value: bool) -> None:
    """Suppress (or restore) the stderr sink.  The tail ring always
    records regardless — quiet mode only silences the console."""
    global _quiet
    _quiet = bool(value)


def set_min_level(level: str) -> None:
    global _min_level
    _min_level = _LEVELS[level]


class Logger:
    """One component's handle.  Stateless beyond the component name, so
    handles are free to cache at module scope."""

    __slots__ = ("component",)

    def __init__(self, component: str):
        self.component = component

    def _emit(self, level: str, msg: str, fields: Dict[str, Any]) -> None:
        if _LEVELS[level] < _min_level:
            return
        rec: Dict[str, Any] = {
            "ts": round(time.time(), 6),
            "level": level,
            "component": self.component,
            "msg": msg,
        }
        if _role is not None:
            rec["role"] = _role
        trace_id = spans.current_trace_id()
        if trace_id is not None:
            rec["trace_id"] = trace_id
        for k, v in fields.items():
            if k not in rec:
                rec[k] = v
        with _lock:
            _tail.append(rec)
        if not _quiet:
            try:
                sys.stderr.write(
                    json.dumps(rec, sort_keys=True, default=str) + "\n"
                )
            except (OSError, ValueError):
                pass  # closed/broken stderr must never take the server down

    def debug(self, msg: str, **fields: Any) -> None:
        self._emit("debug", msg, fields)

    def info(self, msg: str, **fields: Any) -> None:
        self._emit("info", msg, fields)

    def warn(self, msg: str, **fields: Any) -> None:
        self._emit("warn", msg, fields)

    def error(self, msg: str, **fields: Any) -> None:
        self._emit("error", msg, fields)


def get_logger(component: str) -> Logger:
    with _loggers_lock:
        lg = _loggers.get(component)
        if lg is None:
            lg = _loggers[component] = Logger(component)
        return lg


# --------------------------------------------------------------- tail ring


def tail(
    n: Optional[int] = None,
    level: Optional[str] = None,
    component: Optional[str] = None,
) -> List[dict]:
    """The most recent records, oldest first, optionally filtered."""
    with _lock:
        recs = list(_tail)
    if level is not None:
        floor = _LEVELS[level]
        recs = [r for r in recs if _LEVELS[r["level"]] >= floor]
    if component is not None:
        recs = [r for r in recs if r["component"] == component]
    if n is not None:
        recs = recs[-int(n):]
    return recs


def export_jsonl(n: Optional[int] = None) -> str:
    """The tail ring, one JSON object per line — the flight recorder's
    log artifact."""
    return "\n".join(
        json.dumps(r, sort_keys=True, default=str) for r in tail(n)
    )


def set_tail_capacity(n: int) -> None:
    """Resize the tail ring (keeps the newest records).  Test hook."""
    global _tail
    with _lock:
        _tail = deque(_tail, maxlen=int(n))


def clear() -> None:
    with _lock:
        _tail.clear()
