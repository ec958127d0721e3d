"""Multi-query optimizer of the PyTorch port: the standing-query registry.

Port of the registry half of ``kolibrie_tpu/optimizer/mqo.py``: the RSP
engine registers every window as a standing owner of its store and fires
inside :class:`standing_scope`.  In the reference's default mode, ``off``,
these calls are bookkeeping only (``mqo.py:110-118``): no prefix is shared.

Shared-prefix evaluation (``try_shared_execute``, the prefix cache) splits
plans in the bytecode space of ``plan_interp``, which the port does not
have yet (ROADMAP queue 1 item 10).  ``off`` is the port's only mode: a
scope that asks for another (:class:`override_mqo_mode`) makes every read
of the mode raise :class:`NotImplementedError`.  The ``KOLIBRIE_MQO``
knob and the batch dispatch's transient scopes come with item 10.
"""

from __future__ import annotations

import threading
from typing import Dict

__all__ = [
    "mqo_mode",
    "override_mqo_mode",
    "register_standing",
    "unregister_standing",
    "standing_scope",
    "stats",
    "reset",
]

_tl = threading.local()


def mqo_mode() -> str:
    """Sharing mode: ``off``, unless a thread-local override asks for
    another, which raises: shared-prefix evaluation is not ported."""
    mode = getattr(_tl, "mode", None) or "off"
    if mode != "off":
        raise NotImplementedError(
            f"MQO mode {mode!r}: shared-prefix evaluation needs plan_interp, "
            "ROADMAP queue 1 item 10; the port runs MQO 'off' only"
        )
    return mode


class override_mqo_mode:
    """``with override_mqo_mode("off"): ...`` — scoped, per-thread."""

    def __init__(self, mode: str):
        self.mode = mode

    def __enter__(self):
        self.prev = getattr(_tl, "mode", None)
        _tl.mode = self.mode
        return self

    def __exit__(self, *exc):
        _tl.mode = self.prev
        return False


class _Registry:
    """Per-store MQO state: the standing owners (RSP window IRIs)."""

    __slots__ = ("lock", "standing")

    def __init__(self):
        self.lock = threading.RLock()
        self.standing: Dict[str, None] = {}


def _registry(db) -> _Registry:
    reg = db.__dict__.get("_mqo_registry")
    if reg is None:
        reg = db.__dict__.setdefault("_mqo_registry", _Registry())
    return reg


def register_standing(db, owner: str) -> None:
    """Create a standing-owner slot (RSP engine init)."""
    reg = _registry(db)
    with reg.lock:
        reg.standing.setdefault(owner, None)


def unregister_standing(db, owner: str) -> None:
    reg = db.__dict__.get("_mqo_registry")
    if reg is None:
        return
    with reg.lock:
        reg.standing.pop(owner, None)


class standing_scope:
    """``with standing_scope(db, owner): ...`` — marks evaluations on the
    current thread as fired by a standing query."""

    def __init__(self, db, owner: str):
        self.reg = _registry(db)
        self.owner = owner

    def __enter__(self):
        mqo_mode()
        stack = getattr(_tl, "owners", None)
        if stack is None:
            stack = _tl.owners = []
        stack.append((self.reg, self.owner))
        return self

    def __exit__(self, *exc):
        _tl.owners.pop()
        return False


def reset(db) -> None:
    """Drop all MQO state for a store (tests)."""
    db.__dict__.pop("_mqo_registry", None)


def stats(db) -> dict:
    """The reference's ``/stats`` ``mqo`` block: mode, standing
    registrations and per-prefix counts.  With sharing off nothing is
    evaluated or cached, so the cache and the prefixes stay empty."""
    out = {"mode": mqo_mode(), "standing": 0, "cache_entries": 0, "prefixes": {}}
    reg = db.__dict__.get("_mqo_registry")
    if reg is None:
        return out
    with reg.lock:
        out["standing"] = len(reg.standing)
    return out
