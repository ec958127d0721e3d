"""The counters, gauges and histograms of ``kolibrie_tpu/obs/metrics.py``,
for the PyTorch port: a process-wide registry of counters, gauges and
fixed-bucket histograms.  No dependencies, no background threads,
lock-cheap.  Snapshots and scrape-time collectors come with the serving
slice, which reads them.

Families cache their label children (``labels()`` is get-or-create on a
dict keyed by the label-value tuple), so steady-state instrumented code
never allocates, and ``observe`` is a linear scan over ~14 floats, far
cheaper than the device work it measures.

A module-level :data:`REGISTRY` is the default sink; :func:`counter`,
:func:`gauge` and :func:`histogram` are what instrumented code uses.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

from kolibrie_tpu_torch.obs import runtime

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Latency buckets in seconds: 0.5 ms … 10 s.
DEFAULT_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# Count-shaped buckets (event lags, batch sizes, delta facts).
DEFAULT_COUNT_BUCKETS = (
    1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
    1024.0, 4096.0, 16384.0, 65536.0,
)


class CounterChild:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if not runtime.enabled():
            return
        with self._lock:
            self.value += amount


class GaugeChild:
    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, value: float) -> None:
        if not runtime.enabled():
            return
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not runtime.enabled():
            return
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class HistogramChild:
    __slots__ = ("_lock", "buckets", "counts", "sum", "count")

    def __init__(self, buckets: Tuple[float, ...]):
        self._lock = threading.Lock()
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # +1 for +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        if not runtime.enabled():
            return
        with self._lock:
            self.sum += value
            self.count += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    def cumulative(self) -> List[Tuple[float, int]]:
        """(le, cumulative count) pairs ending with (+Inf, count)."""
        with self._lock:
            out, acc = [], 0
            for b, c in zip(self.buckets, self.counts):
                acc += c
                out.append((b, acc))
            out.append((math.inf, acc + self.counts[-1]))
            return out


_Child = Union[CounterChild, GaugeChild, HistogramChild]


class Family:
    """One named metric with a fixed label schema and per-label-value
    children."""

    def __init__(self, name: str, help: str, kind: str,
                 label_names: Tuple[str, ...],
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.help = help
        self.kind = kind
        self.label_names = label_names
        self.buckets = buckets
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}  # guarded by: _lock
        self._default = self.labels() if not label_names else None

    def _make_child(self) -> _Child:
        if self.kind == "histogram":
            return HistogramChild(self.buckets)
        return GaugeChild() if self.kind == "gauge" else CounterChild()

    def labels(self, *values) -> _Child:
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {values!r}"
            )
        key = tuple(str(v) for v in values)
        # double-checked locking: the lock-free read is a fast path; a miss
        # falls through to the locked re-check below
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._children[key] = self._make_child()
        return child

    # Label-less families proxy straight to the single child.
    def inc(self, amount: float = 1.0) -> None:
        self._default.inc(amount)

    def observe(self, value: float) -> None:
        self._default.observe(value)

    def set(self, value: float) -> None:
        self._default.set(value)

    def dec(self, amount: float = 1.0) -> None:
        self._default.dec(amount)

    def children(self) -> List[Tuple[Tuple[str, ...], _Child]]:
        with self._lock:
            return sorted(self._children.items())


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, Family] = {}  # guarded by: _lock

    def _get_or_create(self, name: str, help: str, kind: str,
                       labels: Sequence[str],
                       buckets: Optional[Sequence[float]] = None) -> Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name: {name!r}")
        for ln in labels:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name: {ln!r}")
        label_names = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.label_names != label_names:
                    raise ValueError(
                        f"metric {name!r} re-registered with a different "
                        f"kind/labels ({fam.kind}{fam.label_names} vs "
                        f"{kind}{label_names})"
                    )
                return fam
            bt = tuple(sorted(buckets)) if buckets is not None else None
            fam = self._families[name] = Family(name, help, kind, label_names, bt)
            return fam

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Family:
        return self._get_or_create(name, help, "counter", labels)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Family:
        return self._get_or_create(name, help, "gauge", labels)

    def histogram(self, name: str, help: str = "", labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS) -> Family:
        return self._get_or_create(name, help, "histogram", labels, buckets)

    def families(self) -> List[Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def get(self, name: str) -> Optional[Family]:
        with self._lock:
            return self._families.get(name)


REGISTRY = Registry()


def counter(name: str, help: str = "", labels: Sequence[str] = ()) -> Family:
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Sequence[str] = ()) -> Family:
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: Sequence[str] = (),
              buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS) -> Family:
    return REGISTRY.histogram(name, help, labels, buckets)
