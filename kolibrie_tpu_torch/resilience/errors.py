"""Copy of ``kolibrie_tpu/resilience/errors.py`` for the PyTorch port, with
:func:`is_device_fault` counting CUDA's faults instead of XLA's.

Shared error taxonomy for the serving stack.

One hierarchy maps every failure the serving layer can surface to a
structured HTTP response: a status code, a stable machine-readable
``code`` string, and the human message.  The HTTP frontend used to hold
a dozen bare ``except Exception`` blocks each inventing its own message
shape; they now all route through :func:`error_response`.

Design rules:

- ``KeyboardInterrupt`` / ``SystemExit`` (and every other
  ``BaseException`` outside ``Exception``) are NEVER classified — they
  propagate.  :func:`error_response` refuses them loudly rather than
  swallowing an interpreter shutdown into a 500.
- Exceptions that are not :class:`KolibrieError` get a conservative
  default mapping (parse/value errors → 400, everything else → 500) so
  a new failure mode degrades to a structured response, not a stack
  trace over a half-written HTTP body.
"""

from __future__ import annotations

import os
import random
import threading
from typing import Dict, Optional, Tuple

# obs.spans is stdlib-only and imports nothing from resilience, so this
# is cycle-safe; it lets every structured error carry the trace id of
# the request it failed (a shed/504/429 correlates with its trace).
from kolibrie_tpu_torch.obs.spans import current_trace_id


class KolibrieError(Exception):
    """Base of the serving-layer taxonomy: carries the HTTP mapping."""

    http_status = 500
    code = "internal"

    def payload(self, context: str = "") -> Dict[str, object]:
        msg = str(self) or self.code
        out: Dict[str, object] = {"error": msg, "code": self.code}
        if context:
            out["context"] = context
        trace_id = current_trace_id()
        if trace_id:
            out["trace_id"] = trace_id
        return out


class BadRequest(KolibrieError):
    """Malformed client input (bad JSON, missing fields, parse errors)."""

    http_status = 400
    code = "bad_request"


class QueryError(BadRequest):
    """The query itself failed to parse or execute."""

    code = "query_failed"


class NotFound(KolibrieError):
    http_status = 404
    code = "not_found"


class RequestTooLarge(KolibrieError):
    http_status = 413
    code = "request_too_large"


class Overloaded(KolibrieError):
    """Admission control shed the request (queue depth / in-flight cap).

    ``retry_after_s`` is advisory; it lands in the payload so clients can
    back off without parsing prose."""

    http_status = 429
    code = "overloaded"

    def __init__(self, message: str = "server overloaded", retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s

    def payload(self, context: str = "") -> Dict[str, object]:
        out = super().payload(context)
        out["retry_after_s"] = self.retry_after_s
        return out


class DeadlineExceeded(KolibrieError):
    """The request's deadline budget ran out (shed, not served late)."""

    http_status = 504
    code = "deadline_exceeded"

    def __init__(self, message: str = "deadline exceeded", site: str = ""):
        super().__init__(message)
        self.site = site

    def payload(self, context: str = "") -> Dict[str, object]:
        out = super().payload(context)
        if self.site:
            out["site"] = self.site
        return out


class DeviceFault(KolibrieError):
    """Device-side failure (compile error, OOM, kernel fault) — the class
    the circuit breaker counts.  Serving layers should degrade to the
    host interpreter path instead of returning this to a client."""

    http_status = 500
    code = "device_fault"


class WindowCrash(KolibrieError):
    """A window processor thread died mid-event.  The supervisor restarts
    it (multi-thread mode) or the session restores from its last
    checkpoint (single-thread serving)."""

    http_status = 503
    code = "window_crashed"


# --------------------------------------------------------- retry jitter
#
# A restarted fleet answers every queued client with 503 + Retry-After
# at once; a FIXED value marches them all back in lockstep, so the
# thundering herd re-forms at every interval.  Spread the advice across
# ``[base, base * (1 + spread)]`` from a per-process stream, pid-seeded
# so the replicas of one fleet de-synchronise from each other too
# (``reset_retry_jitter`` freezes it for tests).

_jitter_lock = threading.Lock()
_jitter_rng = random.Random(os.getpid())


def jittered_retry_after(base_s: float = 1.0, spread: float = 0.5) -> float:
    """Retry-After advice drawn from the seeded jitter stream:
    uniform in ``[base_s, base_s * (1 + spread)]``."""
    with _jitter_lock:
        u = _jitter_rng.random()
    return base_s * (1.0 + spread * u)


def reset_retry_jitter(seed) -> None:
    """Re-seed the jitter stream — tests freeze the sequence with this."""
    global _jitter_rng
    with _jitter_lock:
        _jitter_rng = random.Random(seed)


class Unavailable(KolibrieError):
    """The server is up but not serving: replaying its WAL after a crash
    (``recovering``), draining in-flight work before a SIGTERM exit
    (``draining``), or a follower still behind a requested watermark
    (``catching_up``).  Clients should honor ``Retry-After`` — the HTTP
    layer emits the header from ``retry_after_s``.  When no explicit
    value is given the advice is jittered (see above) so a fleet's
    clients don't retry in lockstep."""

    http_status = 503
    code = "unavailable"

    def __init__(
        self,
        message: str = "server unavailable",
        phase: str = "recovering",
        retry_after_s: Optional[float] = None,
    ):
        super().__init__(message)
        self.phase = phase
        self.retry_after_s = (
            jittered_retry_after() if retry_after_s is None else retry_after_s
        )

    def payload(self, context: str = "") -> Dict[str, object]:
        out = super().payload(context)
        out["phase"] = self.phase
        out["retry_after_s"] = self.retry_after_s
        return out


class NotPrimary(KolibrieError):
    """A mutating request reached a read-only follower replica.  409 so
    routers/clients distinguish "wrong node" (re-aim at the primary, no
    backoff needed) from "node down" (503, retry with backoff).  The
    payload carries the follower's replication source as a hint."""

    http_status = 409
    code = "not_primary"

    def __init__(
        self,
        message: str = "this replica is a read-only follower",
        primary_hint: str = "",
    ):
        super().__init__(message)
        self.primary_hint = primary_hint

    def payload(self, context: str = "") -> Dict[str, object]:
        out = super().payload(context)
        if self.primary_hint:
            out["primary_hint"] = self.primary_hint
        return out


class DurabilityError(KolibrieError):
    """A WAL append, fsync, snapshot, or recovery step failed.  Surfaced
    as a 500 — the mutation's durability cannot be acknowledged — and the
    operator runbook (the reference's docs/DURABILITY.md) covers triage."""

    http_status = 500
    code = "durability_failed"


def is_device_fault(exc: BaseException) -> bool:
    """Does this exception count against a template's circuit breaker?

    Device faults: our taxonomy's :class:`DeviceFault` (fault injection
    lands here), ``MemoryError``, and the form a CUDA card produces when
    an allocation fails — ``torch.cuda.OutOfMemoryError``, or any error
    whose message says "CUDA out of memory".  Deliberately NOT
    ``Unsupported`` (a permanent template property, handled by the sticky
    lowering sentinel), NOT parse/semantic errors (the query is wrong on
    every engine), and NOT a kernel that fails to build or launch (``nvcc
    not found``, ``kernel build failed``, ``… launch failed: CUDA error``):
    a broken kernel must surface, never be served degraded around."""
    if isinstance(exc, DeviceFault):
        return True
    if isinstance(exc, MemoryError):
        return True
    import torch

    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    return "CUDA out of memory" in str(exc)


def error_response(
    exc: BaseException, context: str = ""
) -> Tuple[int, Dict[str, object]]:
    """Map an exception to ``(http_status, json_payload)``.

    Raises (never maps) anything outside ``Exception`` — swallowing a
    ``KeyboardInterrupt`` or ``SystemExit`` into a 500 would turn an
    operator's Ctrl-C into a hung worker."""
    if not isinstance(exc, Exception):
        raise exc
    if isinstance(exc, KolibrieError):
        return exc.http_status, exc.payload(context)
    if isinstance(exc, (ValueError, TypeError, KeyError, SyntaxError)):
        status, code = 400, "bad_request"
    else:
        status, code = 500, "internal"
    msg = str(exc) or type(exc).__name__
    out: Dict[str, object] = {"error": msg, "code": code}
    if context:
        out["context"] = context
    trace_id = current_trace_id()
    if trace_id:
        out["trace_id"] = trace_id
    return status, out
