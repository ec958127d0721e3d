"""Copy of ``kolibrie_tpu/resilience/breaker.py`` for the PyTorch port.

Per-template circuit breakers with exponential-backoff re-probe.

The executor's per-template failure sentinels are *sticky*: once device
lowering failed, the template never tries the device again.
That is the right policy for :class:`Unsupported` (a permanent property
of the template's shape) but wrong for TRANSIENT device faults — a
compile that hit an injected/real OOM, a dispatch that blew its
deadline.  Those need the classic breaker state machine:

- **closed**: requests run on the device; failures are counted.
- **open** (tripped after ``failure_threshold`` consecutive failures):
  requests skip the device program entirely and run on the host engine
  (graceful degradation — the client still gets rows; in the port that
  engine still runs on the database's card).
- **half-open** (after an exponentially growing backoff): exactly ONE
  probe request is allowed back onto the device.  Success closes the
  breaker; failure re-opens it with a doubled backoff (capped).

Keyed by template fingerprint — the same key the plan cache uses — so
one poisoned query shape cannot take healthy templates down with it.
The clock is injectable: every transition is testable without sleeping.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict

from kolibrie_tpu_torch.obs import metrics as _obs_metrics

_TRIPS = _obs_metrics.counter(
    "kolibrie_breaker_trips_total", "circuit breaker open transitions"
)
_DEGRADED = _obs_metrics.counter(
    "kolibrie_breaker_degraded_total",
    "requests routed to the host path by an open breaker",
)

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# The reference's defaults (its KOLIBRIE_BREAKER_* settings unset).
DEFAULT_FAILURE_THRESHOLD = 3
DEFAULT_BACKOFF_BASE_S = 0.5
DEFAULT_BACKOFF_FACTOR = 2.0
DEFAULT_BACKOFF_MAX_S = 60.0


class CircuitBreaker:
    def __init__(
        self,
        failure_threshold: int = DEFAULT_FAILURE_THRESHOLD,
        backoff_base_s: float = DEFAULT_BACKOFF_BASE_S,
        backoff_factor: float = DEFAULT_BACKOFF_FACTOR,
        backoff_max_s: float = DEFAULT_BACKOFF_MAX_S,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.failure_threshold = failure_threshold
        self.backoff_base_s = backoff_base_s
        self.backoff_factor = backoff_factor
        self.backoff_max_s = backoff_max_s
        self.clock = clock
        self._lock = threading.Lock()
        self.state = CLOSED
        self.failures = 0  # consecutive, resets on success
        self.total_failures = 0  # lifetime, never resets
        self.trips = 0  # lifetime trip count
        self.consecutive_trips = 0  # drives the backoff exponent
        self.retry_at = 0.0
        self._probe_inflight = False
        self.degraded_served = 0  # requests routed to the host path
        # bumped on every recovery (non-closed -> closed transition);
        # lets the plan cache expire a sticky failure sentinel exactly
        # when the fault that produced it has demonstrably healed.  An
        # always-closed breaker (the Unsupported case: host fallback
        # records success without ever tripping) never bumps, so shape
        # sentinels stay sticky.
        self.close_epoch = 0

    # ------------------------------------------------------------- decisions

    def allow(self) -> bool:
        """May this request take the device path?  False ⇒ degraded host
        path.  An open breaker past its backoff admits ONE half-open
        probe; concurrent requests during the probe stay degraded."""
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN and self.clock() >= self.retry_at:
                self.state = HALF_OPEN
                self._probe_inflight = False
            if self.state == HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                return True
            self.degraded_served += 1
            _DEGRADED.inc()
            return False

    def record_success(self) -> None:
        with self._lock:
            if self.state != CLOSED:
                self.close_epoch += 1
            self.failures = 0
            self.consecutive_trips = 0
            self.state = CLOSED
            self._probe_inflight = False

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            self.total_failures += 1
            if self.state == HALF_OPEN or self.failures >= self.failure_threshold:
                self._trip_locked()

    def _trip_locked(self) -> None:
        self.trips += 1
        _TRIPS.inc()
        self.consecutive_trips += 1
        backoff = min(
            self.backoff_base_s
            * (self.backoff_factor ** (self.consecutive_trips - 1)),
            self.backoff_max_s,
        )
        self.state = OPEN
        self.retry_at = self.clock() + backoff
        self._probe_inflight = False
        self.failures = 0

    # ----------------------------------------------------------------- stats

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "state": self.state,
                "failures": self.failures,
                "total_failures": self.total_failures,
                "trips": self.trips,
                "degraded_served": self.degraded_served,
                "close_epoch": self.close_epoch,
            }
            if self.state == OPEN:
                out["retry_in_s"] = round(max(0.0, self.retry_at - self.clock()), 3)
            return out


class BreakerBoard:
    """One breaker per template fingerprint, created on first sight.

    Bounded: past ``max_entries`` the oldest CLOSED breakers are evicted
    (an evicted healthy breaker loses nothing; open/half-open breakers —
    the ones carrying state that matters — are never dropped)."""

    def __init__(self, max_entries: int = 256, **breaker_kwargs):
        self._kwargs = breaker_kwargs
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}

    def get(self, fp: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(fp)
            if br is None:
                if len(self._breakers) >= self.max_entries:
                    for k in [
                        k
                        for k, b in self._breakers.items()
                        if b.state == CLOSED
                    ][: len(self._breakers) - self.max_entries + 1]:
                        self._breakers.pop(k)
                br = self._breakers[fp] = CircuitBreaker(**self._kwargs)
            return br

    def allow(self, fp: str) -> bool:
        return self.get(fp).allow()

    def record_success(self, fp: str) -> None:
        self.get(fp).record_success()

    def record_failure(self, fp: str) -> None:
        self.get(fp).record_failure()

    def close_epoch(self, fp: str) -> int:
        """Recovery counter for ``fp`` WITHOUT creating a breaker: a
        template that never failed reads epoch 0 at no board cost."""
        with self._lock:
            br = self._breakers.get(fp)
        return 0 if br is None else br.close_epoch

    def snapshot(self) -> dict:
        with self._lock:
            items = list(self._breakers.items())
        return {fp: br.snapshot() for fp, br in items}


def breaker_board(db, **breaker_kwargs) -> BreakerBoard:
    """The database's breaker board, lazily attached (same pattern as the
    plan caches): every executor entry point sharing a db shares its
    breakers."""
    board = db.__dict__.get("_breaker_board")
    if board is None:
        board = BreakerBoard(**breaker_kwargs)
        db.__dict__["_breaker_board"] = board
    return board
