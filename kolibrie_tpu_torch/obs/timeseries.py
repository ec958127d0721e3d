"""A fixed-size ring of periodic metrics-registry snapshots.

Every counter the engine already maintains gets a history for the cost
of one ``Registry.snapshot()`` per sample interval: the ring stores raw
snapshots and derives counter *deltas*, gauge samples, and histogram
quantiles lazily at read time (``/debug/timeline`` or the bench gate),
so the sampling path does no math and no allocation beyond the dict
dump itself.

The ring is bounded (default 256 samples) and sampling is opt-in: the
HTTP server starts the background sampler thread; library use and tests
call :meth:`TimeSeriesRing.record` directly.  Like the rest of
:mod:`kolibrie_tpu_torch.obs`, this module is stdlib-only.

Copy of ``kolibrie_tpu/obs/timeseries.py`` for the PyTorch port, its imports
rewritten.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional

from kolibrie_tpu_torch.obs import metrics
from kolibrie_tpu_torch.resilience.faultinject import InjectedFault, fault_point

DEFAULT_CAPACITY = 256
DEFAULT_INTERVAL_S = 5.0


def bucket_quantile(cumulative: List[tuple], q: float) -> Optional[float]:
    """Interpolated quantile from ``HistogramChild.cumulative()`` pairs.

    Linear interpolation inside the target bucket, matching the usual
    Prometheus ``histogram_quantile`` semantics: the returned value is
    an upper-bound estimate, and a quantile landing in the +Inf bucket
    degrades to the largest finite bound.
    """
    if not cumulative:
        return None
    total = cumulative[-1][1]
    if total <= 0:
        return None
    rank = q * total
    prev_le, prev_cum = 0.0, 0
    for le, cum in cumulative:
        if cum >= rank:
            if math.isinf(le):
                return prev_le if prev_le > 0 else None
            if cum == prev_cum:
                return le
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_le + (le - prev_le) * frac
        prev_le, prev_cum = le, cum
    return prev_le if prev_le > 0 else None


class TimeSeriesRing:
    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 registry: Optional[metrics.Registry] = None):
        if capacity < 2:
            raise ValueError("ring needs >= 2 samples to form a delta")
        self.capacity = capacity
        self.registry = registry or metrics.REGISTRY
        self._lock = threading.Lock()
        self._samples: List[dict] = []  # guarded by: _lock
        self._seq = 0  # guarded by: _lock — monotonic, survives eviction

    def _append_sample(self, snap: dict, ts: float) -> int:  # kolint: holds[_lock]
        seq = self._seq
        self._seq += 1
        self._samples.append({"seq": seq, "ts": ts, "snap": snap})
        if len(self._samples) > self.capacity:
            del self._samples[: len(self._samples) - self.capacity]
        return seq

    def record(self, now: Optional[float] = None) -> int:
        """Take one snapshot.  Returns the sample's sequence number."""
        snap = self.registry.snapshot()
        ts = time.time() if now is None else now
        try:
            fault_point("lockcheck.bypass")
        except InjectedFault:
            # seeded guard violation: on injection the holds[_lock] claim
            # above is FALSE — the chaos suite asserts the
            # KOLIBRIE_DEBUG_LOCKS sanitizer reports this very access,
            # proving the checker checks (tests/test_chaos.py)
            return self._append_sample(snap, ts)
        with self._lock:
            return self._append_sample(snap, ts)

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def window(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            samples = list(self._samples)
        if n is not None and n > 0:
            samples = samples[-n:]
        return samples

    def series(self, metric: Optional[str] = None,
               n: Optional[int] = None,
               quantiles: tuple = (0.5, 0.99)) -> Dict[str, Any]:
        """Render the ring as per-metric time series.

        Counters become per-interval deltas (one fewer point than
        samples; a negative delta — process restart — clamps to the
        new absolute value).  Gauges are sampled verbatim.  Histograms
        yield count/sum deltas plus interpolated quantiles of the
        cumulative distribution at each sample.
        """
        samples = self.window(n)
        out: Dict[str, Any] = {
            "samples": len(samples),
            "first_seq": samples[0]["seq"] if samples else None,
            "last_seq": samples[-1]["seq"] if samples else None,
            "timestamps": [s["ts"] for s in samples],
            "metrics": {},
        }
        if not samples:
            return out
        names = set()
        for s in samples:
            names.update(s["snap"].keys())
        for name in sorted(names):
            if metric is not None and name != metric:
                continue
            latest = None
            for s in reversed(samples):
                if name in s["snap"]:
                    latest = s["snap"][name]
                    break
            kind = latest["kind"]
            child_keys = set()
            for s in samples:
                fam = s["snap"].get(name)
                if fam:
                    child_keys.update(fam["children"].keys())
            fam_out: Dict[str, Any] = {"kind": kind, "series": {}}
            for key in sorted(child_keys):
                label = ",".join(key) if key else ""
                points = [s["snap"].get(name, {}).get("children", {}).get(key)
                          for s in samples]
                if kind == "gauge":
                    fam_out["series"][label] = {"values": points}
                elif kind == "counter":
                    fam_out["series"][label] = {
                        "deltas": _deltas([p for p in points]),
                    }
                else:  # histogram
                    counts = [p["count"] if p else None for p in points]
                    sums = [p["sum"] if p else None for p in points]
                    qs = {
                        f"p{int(q * 100)}": [
                            bucket_quantile(p["cumulative"], q) if p else None
                            for p in points
                        ]
                        for q in quantiles
                    }
                    fam_out["series"][label] = {
                        "count_deltas": _deltas(counts),
                        "sum_deltas": _deltas(sums),
                        "quantiles": qs,
                    }
            out["metrics"][name] = fam_out
        return out


def _deltas(points: List[Optional[float]]) -> List[Optional[float]]:
    out: List[Optional[float]] = []
    for prev, cur in zip(points, points[1:]):
        if cur is None or prev is None:
            out.append(None)
        else:
            d = cur - prev
            out.append(cur if d < 0 else d)  # restart: clamp to new absolute
    return out


class Sampler:
    """Daemon thread feeding a ring at a fixed interval."""

    def __init__(self, ring: TimeSeriesRing,
                 interval_s: float = DEFAULT_INTERVAL_S):
        self.ring = ring
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="kolibrie-timeline-sampler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.ring.record()
            # kolint: ignore[KL601] sampler must survive any registry hiccup; a dropped sample is the correct degradation
            except Exception:
                pass


_DEFAULT_RING: Optional[TimeSeriesRing] = None
_DEFAULT_LOCK = threading.Lock()


def default_ring() -> TimeSeriesRing:
    global _DEFAULT_RING
    with _DEFAULT_LOCK:
        if _DEFAULT_RING is None:
            _DEFAULT_RING = TimeSeriesRing()
        return _DEFAULT_RING


# Debug-build runtime check of the # guarded by: annotations above
# (no-op unless KOLIBRIE_DEBUG_LOCKS=1 — see analysis/lockcheck.py)
from kolibrie_tpu_torch.analysis import lockcheck as _lockcheck

_lockcheck.auto_instrument(globals())
