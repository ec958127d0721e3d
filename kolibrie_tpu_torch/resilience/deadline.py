"""Copy of ``kolibrie_tpu/resilience/deadline.py`` for the PyTorch port.

Request deadlines: a monotonic budget that travels with the request.

An HTTP query arrives with a ``deadline_ms`` budget (field or
``X-Kolibrie-Deadline-Ms`` header, server default otherwise).  The
frontend opens a :func:`deadline_scope` for the handling thread; every
layer below — batcher queueing, the executor, device dispatch — calls
:func:`check_deadline(site)` at its expensive boundaries and raises
:class:`~kolibrie_tpu_torch.resilience.errors.DeadlineExceeded` (→ structured
504) the moment the budget is gone, instead of finishing work nobody is
waiting for.

Propagation is a thread-local stack, not a parameter threaded through
thirty signatures: the executor's call tree is synchronous within one
handler thread.  The one place a request's work runs on ANOTHER thread —
the template batcher's leader dispatching for its followers — re-enters
the scope explicitly with the batch's tightest member deadline
(:meth:`Deadline.merge`).

The clock is injectable for deterministic tests."""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional

from kolibrie_tpu_torch.resilience.errors import DeadlineExceeded


class Deadline:
    """An absolute expiry on a monotonic clock."""

    __slots__ = ("expires_at", "clock")

    def __init__(self, budget_s: float, clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.expires_at = clock() + budget_s

    @classmethod
    def from_ms(
        cls, budget_ms: float, clock: Callable[[], float] = time.monotonic
    ) -> "Deadline":
        return cls(budget_ms / 1000.0, clock)

    def remaining(self) -> float:
        """Seconds left; never negative."""
        return max(0.0, self.expires_at - self.clock())

    def expired(self) -> bool:
        return self.clock() >= self.expires_at

    def check(self, site: str = "") -> None:
        if self.expired():
            raise DeadlineExceeded(
                f"deadline exceeded at {site or 'unspecified site'}", site=site
            )

    def merge(self, other: Optional["Deadline"]) -> "Deadline":
        """The tighter of the two (for batch leaders serving followers)."""
        if other is None or self.expires_at <= other.expires_at:
            return self
        return other


_tls = threading.local()


def current_deadline() -> Optional[Deadline]:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


@contextmanager
def deadline_scope(deadline: Optional[Deadline]):
    """Make ``deadline`` the thread's current deadline for the dynamic
    extent.  ``None`` is pushed too: it explicitly MASKS any outer scope
    (a batch leader re-running a no-deadline follower's query must not
    subject it to the leader's own budget)."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(deadline)
    try:
        yield deadline
    finally:
        stack.pop()


def check_deadline(site: str = "") -> None:
    """Raise DeadlineExceeded if the current scope's budget is spent.
    No-op outside any scope (library callers without deadlines)."""
    dl = current_deadline()
    if dl is not None:
        dl.check(site)


def remaining_s(default: float = float("inf")) -> float:
    dl = current_deadline()
    return default if dl is None else dl.remaining()
