"""Copy of ``kolibrie_tpu/resilience/supervisor.py`` for the PyTorch port.

Window supervision: restart crashed processors, dead-letter poison.

The RSP engine runs one processor per window.  Before this module, an
exception inside a processor either killed its worker thread silently
(multi-thread mode: the window simply stopped firing forever) or
propagated into whatever thread pushed the event (single-thread mode:
an HTTP 500 with the window left mid-mutation).  The supervisor gives
both modes a defined failure story:

- **poisoned events**: a processor exception is retried
  ``max_event_retries`` times; still failing, the event's window firing
  is DEAD-LETTERED (recorded with its error, window, and ordinal) and
  the stream continues.  One bad event no longer stops the world.
- **crashes** (:class:`WindowCrash`, e.g. injected thread death): in
  multi-thread mode the supervised loop records the crash, waits an
  exponential backoff, restores the engine from its last checkpoint
  (``checkpoint_state``/``restore_state`` machinery) when one exists,
  and resumes — a bounded-retry restart.  After ``max_restarts`` the
  window is marked dead and the supervisor stops consuming (visible in
  ``snapshot()``; the rest of the engine keeps running).  In
  single-thread mode the crash propagates to the pusher, which owns
  recovery (the HTTP layer restores the session from its checkpoint).
- **checkpoint cadence**: with ``checkpoint_every=N``, the supervisor
  snapshots engine state every N successfully processed firings, so a
  later crash loses at most N firings.

Restoring ``RSPEngine`` state is engine-wide; on a multi-window engine a
restore rewinds sibling windows to the same snapshot.  That is the
documented at-least-once delivery contract (docs/PREEMPTION.md): a
firing in flight at snapshot time is re-emitted after restore.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from kolibrie_tpu_torch.obs import metrics as _obs_metrics
from kolibrie_tpu_torch.resilience.errors import WindowCrash
from kolibrie_tpu_torch.resilience.faultinject import fault_point

FAULT_SITE = "rsp.window"

_DEAD_LETTERS = _obs_metrics.counter(
    "kolibrie_rsp_dead_letters_total",
    "window firings dead-lettered after retry exhaustion",
    labels=("window",),
)
_RESTARTS = _obs_metrics.counter(
    "kolibrie_rsp_restarts_total",
    "supervised window processor restarts",
    labels=("window",),
)
_RETRIES = _obs_metrics.counter(
    "kolibrie_rsp_retries_total",
    "poisoned-event retries",
    labels=("window",),
)
_CKPT_FAILURES = _obs_metrics.counter(
    "kolibrie_rsp_checkpoint_failures_total",
    "supervisor checkpoint/restore attempts that failed",
    labels=("window", "op"),
)


@dataclass
class SupervisionConfig:
    max_event_retries: int = 1
    max_restarts: int = 5
    backoff_base_s: float = 0.01
    backoff_factor: float = 2.0
    backoff_max_s: float = 1.0
    checkpoint_every: int = 0  # 0 = supervisor takes no checkpoints
    sleep: Callable[[float], None] = time.sleep


@dataclass
class DeadLetter:
    window_iri: str
    ordinal: int  # nth firing seen by this window's supervisor
    error: str


class WindowSupervisor:
    """Supervises ONE window's processor (both operation modes)."""

    def __init__(
        self,
        window_iri: str,
        config: Optional[SupervisionConfig] = None,
        checkpoint_fn: Optional[Callable[[], bytes]] = None,
        restore_fn: Optional[Callable[[bytes], None]] = None,
    ):
        self.window_iri = window_iri
        self.config = config or SupervisionConfig()
        self.checkpoint_fn = checkpoint_fn
        self.restore_fn = restore_fn
        self._lock = threading.Lock()
        self.processed = 0
        self.retried = 0
        self.restarts = 0
        self.dead = False
        self.dead_letters: List[DeadLetter] = []
        self.last_checkpoint: Optional[bytes] = None

    # ------------------------------------------------------------ processing

    def process(self, processor: Callable, content) -> None:
        """One supervised firing: fault point → processor → bounded retry
        → dead-letter.  :class:`WindowCrash` is NOT absorbed — it models
        the thread dying, which the caller (supervised loop or pusher)
        recovers from."""
        with self._lock:
            self.processed += 1
            ordinal = self.processed
        attempts = 1 + max(0, self.config.max_event_retries)
        last_exc: Optional[Exception] = None
        for attempt in range(attempts):
            try:
                fault_point(FAULT_SITE)
                processor(content)
                self._maybe_checkpoint()
                return
            except WindowCrash:
                raise
            except Exception as e:  # noqa: BLE001 — supervisor boundary
                last_exc = e
                if attempt + 1 < attempts:
                    with self._lock:
                        self.retried += 1
                    _RETRIES.labels(self.window_iri).inc()
        with self._lock:
            self.dead_letters.append(
                DeadLetter(self.window_iri, ordinal, repr(last_exc))
            )
        _DEAD_LETTERS.labels(self.window_iri).inc()

    def _maybe_checkpoint(self) -> None:
        n = self.config.checkpoint_every
        if n <= 0 or self.checkpoint_fn is None:
            return
        with self._lock:
            due = self.processed % n == 0
        if due:
            try:
                blob = self.checkpoint_fn()
                with self._lock:
                    self.last_checkpoint = blob
            except Exception:  # a failed snapshot must not fail the
                # firing; the previous checkpoint stands — but count it,
                # or a permanently broken checkpoint_fn is invisible
                _CKPT_FAILURES.labels(self.window_iri, "checkpoint").inc()

    def wrap(self, processor: Callable) -> Callable:
        """Single-thread (callback) mode: the registered callback IS the
        supervised entry."""

        def supervised(content):
            self.process(processor, content)

        return supervised

    # ------------------------------------------------------- thread mode

    def spawn(self, receiver, processor: Callable) -> threading.Thread:
        """Multi-thread mode: consume ``receiver`` under supervision.
        ``None`` is the shutdown sentinel (engine.stop).  A crash restarts
        the processing loop after backoff (bounded), restoring from the
        last checkpoint when one exists."""

        def loop():
            while True:
                content = receiver.get()
                if content is None:
                    return
                try:
                    self.process(processor, content)
                except WindowCrash as e:
                    if not self._recover(e):
                        return

        t = threading.Thread(
            target=loop, daemon=True, name=f"rsp-window:{self.window_iri}"
        )
        t.start()
        return t

    def _recover(self, exc: WindowCrash) -> bool:
        """Crash bookkeeping + backoff + checkpoint restore.  False ⇒
        restart budget exhausted; the window is marked dead."""
        with self._lock:
            self.restarts += 1
            n = self.restarts
            if n > self.config.max_restarts:
                self.dead = True
                self.dead_letters.append(
                    DeadLetter(self.window_iri, self.processed, repr(exc))
                )
                _DEAD_LETTERS.labels(self.window_iri).inc()
                return False
        _RESTARTS.labels(self.window_iri).inc()
        backoff = min(
            self.config.backoff_base_s * (self.config.backoff_factor ** (n - 1)),
            self.config.backoff_max_s,
        )
        self.config.sleep(backoff)
        with self._lock:
            blob = self.last_checkpoint
        if blob is not None and self.restore_fn is not None:
            try:
                self.restore_fn(blob)
            except Exception:  # a failed restore degrades to restart-
                # without-rewind, never a dead window — counted so the
                # silent-degradation mode shows up on a dashboard
                _CKPT_FAILURES.labels(self.window_iri, "restore").inc()
        return True

    # ----------------------------------------------------------------- stats

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "window": self.window_iri,
                "processed": self.processed,
                "retried": self.retried,
                "restarts": self.restarts,
                "dead": self.dead,
                "dead_letters": len(self.dead_letters),
                "has_checkpoint": self.last_checkpoint is not None,
            }
