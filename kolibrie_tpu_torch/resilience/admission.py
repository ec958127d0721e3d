"""Copy of ``kolibrie_tpu/resilience/admission.py`` for the PyTorch port.

Admission control: shed load at the door instead of queueing forever.

Two bounds, both cheap and both returning a structured 429
(:class:`~kolibrie_tpu_torch.resilience.errors.Overloaded`) when exceeded:

- **in-flight cap** (:class:`AdmissionController`): the HTTP frontend
  admits at most ``max_inflight`` concurrently-executing query requests.
  ``ThreadingHTTPServer`` spawns a thread per connection, so without
  this a burst turns into unbounded threads all contending for the same
  engine locks and all eventually timing out.
- **queue-depth cap** (checked by ``TemplateBatcher.submit``): a request
  finding more than ``max_queue_depth`` requests already pending on its
  store is shed immediately — queue length is the best single predictor
  of blowing the deadline anyway.

Counters are exposed for ``/stats``; a shed request costs one lock
acquisition and an exception."""

from __future__ import annotations

import threading
from contextlib import contextmanager

from kolibrie_tpu_torch.obs import metrics as _obs_metrics
from kolibrie_tpu_torch.resilience.errors import Overloaded

_INFLIGHT = _obs_metrics.gauge(
    "kolibrie_admission_inflight", "query requests currently admitted"
)
_ADMITTED = _obs_metrics.counter(
    "kolibrie_admission_admitted_total", "requests admitted"
)
_SHED = _obs_metrics.counter(
    "kolibrie_admission_shed_total", "requests shed by the in-flight cap"
)


class AdmissionController:
    def __init__(self, max_inflight: int = 64, retry_after_s: float = 1.0):
        self.max_inflight = max_inflight
        self.retry_after_s = retry_after_s
        self._lock = threading.Lock()
        self.inflight = 0
        self.admitted = 0
        self.shed = 0
        self.peak_inflight = 0

    def try_acquire(self) -> None:
        """Admit or raise :class:`Overloaded`."""
        with self._lock:
            if self.inflight >= self.max_inflight:
                self.shed += 1
                _SHED.inc()
                raise Overloaded(
                    f"too many requests in flight ({self.inflight} >= "
                    f"{self.max_inflight})",
                    retry_after_s=self.retry_after_s,
                )
            self.inflight += 1
            self.admitted += 1
            if self.inflight > self.peak_inflight:
                self.peak_inflight = self.inflight
        _ADMITTED.inc()
        _INFLIGHT.inc()

    def release(self) -> None:
        with self._lock:
            self.inflight -= 1
        _INFLIGHT.dec()

    @contextmanager
    def admitted_scope(self):
        self.try_acquire()
        try:
            yield
        finally:
            self.release()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "max_inflight": self.max_inflight,
                "inflight": self.inflight,
                "peak_inflight": self.peak_inflight,
                "admitted": self.admitted,
                "shed": self.shed,
            }
