"""Runtime lock-discipline sanitizer — the dynamic half of KL301/KL31x.

The static rules prove lock discipline about the code they can SEE:
``# guarded by: <lock>`` annotations are enforced lexically (KL301) and
un-annotated shared state is race-checked against the thread model
(KL311/KL312).  Two escape hatches weaken those proofs on purpose —
``# kolint: holds[<lock>]`` (caller-holds contracts) and reasoned
suppressions.  This module turns the annotations into *checked claims*:
under ``KOLIBRIE_DEBUG_LOCKS=1`` every annotated attribute becomes a
data descriptor that asserts its declared lock is actually held at
access time, so a false ``holds[]`` claim or a refactor that moved an
access out of its ``with`` block shows up as a report in the chaos
suite instead of a heisenbug in production.

Zero-cost when off: :func:`auto_instrument` (called at the bottom of
modules that carry annotations) returns immediately unless the env var
is set, so production pays one dict lookup per import and nothing per
access.

Semantics:

- mode ``writes`` (annotation default): ``__set__``/``__delete__``
  check the lock; reads are free (the snapshot-read idiom).
- mode ``rw`` (``# guarded by: _lock (rw)``): reads check too — for
  state mutated in place through the reference (dicts of counters).
- ``__init__``-family frames are exempt: construction precedes sharing.
- Ownership test: ``RLock._is_owned()`` when available (exact), else
  ``Lock.locked()`` (held-by-someone — a thread-attribution false
  negative is possible, never a false positive report).
- Violations are RECORDED, not raised: :func:`reports` returns them and
  the chaos suite asserts emptiness (or, for the seeded
  ``lockcheck.bypass`` fault, non-emptiness).  Raising would change
  control flow and mask the very interleavings being hunted.

Caveat: instrumented attributes live in the instance ``__dict__`` under
a mangled slot, so code that inspects ``vars(obj)`` directly sees the
mangled names while the sanitizer is on.
"""

from __future__ import annotations

import os
import re
import sys
import threading
from typing import Any, Dict, List, Optional, Tuple, Type

from kolibrie_tpu_torch.analysis.project import _GUARDED_RE

_EXEMPT_FRAMES = {
    "__init__", "__new__", "__post_init__", "__setstate__", "__getstate__",
}
_MAX_REPORTS = 200

_ASSIGN_RE = re.compile(r"^\s*self\.([A-Za-z_]\w*)\s*(?::[^=]*)?=[^=]")

_reports: List[dict] = []
_reports_lock = threading.Lock()


def enabled() -> bool:
    return os.environ.get("KOLIBRIE_DEBUG_LOCKS") == "1"


def reports() -> List[dict]:
    """Violations recorded so far (bounded at _MAX_REPORTS)."""
    with _reports_lock:
        return list(_reports)


def reset() -> None:
    with _reports_lock:
        _reports.clear()


def _held(lock: Any) -> Optional[bool]:
    """True/False when determinable, None when the primitive is opaque
    (duck-typed fakes in tests) or absent."""
    if lock is None:
        return None
    is_owned = getattr(lock, "_is_owned", None)
    if callable(is_owned):  # RLock: exact per-thread ownership
        try:
            return bool(is_owned())
        # kolint: ignore[KL601] a sanitizer probe must never take down the probed code; an un-probeable lock degrades to "unknown", not a report
        except Exception:
            return None
    locked = getattr(lock, "locked", None)
    if callable(locked):  # Lock: held-by-someone approximation
        try:
            return bool(locked())
        # kolint: ignore[KL601] same degrade-to-unknown contract as above
        except Exception:
            return None
    return None


def _record(cls_name: str, attr: str, event: str, lock_name: str, frame) -> None:
    ent = {
        "class": cls_name,
        "attr": attr,
        "event": event,
        "lock": lock_name,
        "where": f"{frame.f_code.co_filename}:{frame.f_lineno}",
        "func": frame.f_code.co_name,
        "thread": threading.current_thread().name,
    }
    with _reports_lock:
        if len(_reports) < _MAX_REPORTS:
            _reports.append(ent)


class GuardedAttribute:
    """Data descriptor asserting the declared lock is held at access."""

    def __init__(self, name: str, lock_name: str, mode: str, cls_name: str):
        self.name = name
        self.lock_name = lock_name.split(".")[-1]
        self.mode = mode
        self.cls_name = cls_name
        self.slot = f"_lockcheck_{name}"

    def _check(self, obj, event: str) -> None:
        frame = sys._getframe(2)
        if frame.f_code.co_name in _EXEMPT_FRAMES:
            return
        held = _held(obj.__dict__.get(self.lock_name))
        if held is False:
            _record(self.cls_name, self.name, event, self.lock_name, frame)

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        if self.mode == "rw":
            self._check(obj, "read")
        try:
            return obj.__dict__[self.slot]
        except KeyError:
            raise AttributeError(
                f"{type(obj).__name__!r} object has no attribute "
                f"{self.name!r}"
            ) from None

    def __set__(self, obj, value) -> None:
        self._check(obj, "write")
        obj.__dict__[self.slot] = value

    def __delete__(self, obj) -> None:
        self._check(obj, "write")
        try:
            del obj.__dict__[self.slot]
        except KeyError:
            raise AttributeError(self.name) from None


def _parse_guarded(src: str) -> Dict[str, Tuple[str, str]]:
    """attr → (lock, mode) from ``self.X = … # guarded by: L`` lines."""
    out: Dict[str, Tuple[str, str]] = {}
    for line in src.splitlines():
        m = _GUARDED_RE.search(line)
        if m is None:
            continue
        am = _ASSIGN_RE.match(line)
        if am is None:
            continue  # module-global or non-attribute annotation
        out[am.group(1)] = (m.group(1), m.group(2) or "writes")
    return out


def instrument_class(cls: Type, force: bool = False) -> Type:
    """Replace ``cls``'s annotated attributes with checking descriptors.
    No-op unless the env gate is set (or ``force``), and for classes
    whose source is unavailable (REPL, exec)."""
    if not (force or enabled()):
        return cls
    import inspect

    try:
        src = inspect.getsource(cls)
    except (OSError, TypeError):
        return cls
    for attr, (lock, mode) in _parse_guarded(src).items():
        if lock.split(".")[-1] == attr:
            continue  # a lock guarding itself is an annotation typo
        setattr(cls, attr, GuardedAttribute(attr, lock, mode, cls.__name__))
    return cls


def auto_instrument(namespace: Dict[str, Any]) -> None:
    """Instrument every class defined in ``namespace`` (a module's
    ``globals()``) that carries guard annotations.  Call at module
    bottom; free unless ``KOLIBRIE_DEBUG_LOCKS=1``."""
    if not enabled():
        return
    mod = namespace.get("__name__")
    for val in list(namespace.values()):
        if isinstance(val, type) and getattr(val, "__module__", None) == mod:
            instrument_class(val)


# ------------------------------------------------------------- selftest


class _Probe:
    """Fixture for :func:`selftest` — one field per mode."""

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0  # guarded by: _lock
        self.tracked = 0  # guarded by: _lock (rw)


def selftest() -> bool:
    """Prove the sanitizer is silent on disciplined accesses and
    reports an unlocked write AND an unlocked rw-read.  Instruments
    unconditionally (``force=True``) so a check can run it without
    flipping the env for the whole process; probe reports are removed
    afterwards so they never pollute a real session's findings."""
    instrument_class(_Probe, force=True)
    start = len(reports())
    p = _Probe()
    with p._lock:
        p.value = 1  # kolint: ignore[KL301] selftest exercises the RUNTIME checker; the lock IS held here
        _ = p.tracked  # kolint: ignore[KL301] ditto — disciplined read under the lock
    quiet = len(reports()) == start
    p.value = 2  # kolint: ignore[KL301] deliberate violation the selftest asserts is caught
    _ = p.tracked  # kolint: ignore[KL301] deliberate rw-read violation
    mine = [r for r in reports()[start:] if r["class"] == "_Probe"]
    caught = {(r["attr"], r["event"]) for r in mine} >= {
        ("value", "write"),
        ("tracked", "read"),
    }
    with _reports_lock:
        _reports[:] = [r for r in _reports if r["class"] != "_Probe"]
    return quiet and caught
