"""Process-wide metrics registry: counters, gauges, fixed-bucket
histograms.  No dependencies, no background threads, lock-cheap.

Design points, in order of importance:

- **Hot path cost**: one dict lookup + one small-lock increment.
  Families cache their label children (``labels()`` is get-or-create on
  a dict keyed by the label-value tuple), so steady-state instrumented
  code never allocates.  Histograms use fixed buckets chosen at
  creation — ``observe`` is a linear scan over ~14 floats, far cheaper
  than the device work it measures.
- **Cardinality discipline**: the only unbounded-ish label in the
  catalog is the template fingerprint, which is bounded by the plan
  template cache (~64 entries) upstream.  The registry enforces
  nothing; call sites must.
- **Collectors**: state that lives elsewhere (jit cache sizes, queue
  depth) is pulled at scrape time via ``register_collector`` callbacks
  rather than pushed on every mutation.

A module-level :data:`REGISTRY` is the default sink; the convenience
constructors (:func:`counter` …) are what instrumented code uses.
Tests that need isolation construct their own :class:`Registry`.

Copy of ``kolibrie_tpu/obs/metrics.py`` for the PyTorch port, its imports
rewritten.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from kolibrie_tpu_torch.obs import runtime

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Latency buckets in seconds: 0.5 ms … 10 s.  Wide because the same
# shape serves both a sub-ms plan-cache hit and a multi-second compile.
DEFAULT_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# Count-shaped buckets (batch sizes, fixpoint rounds, delta facts).
DEFAULT_COUNT_BUCKETS = (
    1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
    1024.0, 4096.0, 16384.0, 65536.0,
)


class _Child:
    __slots__ = ("_lock",)

    def __init__(self):
        self._lock = threading.Lock()


class CounterChild(_Child):
    __slots__ = ("value",)

    def __init__(self):
        super().__init__()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if not runtime.enabled():
            return
        with self._lock:
            self.value += amount


class GaugeChild(_Child):
    __slots__ = ("value",)

    def __init__(self):
        super().__init__()
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


class HistogramChild(_Child):
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Tuple[float, ...]):
        super().__init__()
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


_KINDS = {"counter": CounterChild, "gauge": GaugeChild, "histogram": HistogramChild}


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
        if not label_names:
            self._default = self._make_child()
            self._children[()] = self._default
        else:
            self._default = None

    def _make_child(self) -> _Child:
        if self.kind == "histogram":
            return HistogramChild(self.buckets)
        return _KINDS[self.kind]()

    def labels(self, *values) -> _Child:
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {values!r}"
            )
        key = tuple(str(v) for v in values)
        # kolint: ignore[KL301] double-checked locking: the lock-free read is a fast path; a miss falls through to the locked re-check below
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

    def set(self, value: float) -> None:
        self._default.set(value)

    def dec(self, amount: float = 1.0) -> None:
        self._default.dec(amount)

    def observe(self, value: float) -> None:
        self._default.observe(value)

    def children(self) -> List[Tuple[Tuple[str, ...], _Child]]:
        with self._lock:
            return sorted(self._children.items())


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, Family] = {}  # guarded by: _lock
        self._collectors: List[Callable[[], None]] = []  # guarded by: _lock

    def _get_or_create(self, name: str, help: str, kind: str,
                       labels: Sequence[str],
                       buckets: Optional[Sequence[float]] = None) -> Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name: {name!r}")
        for ln in labels:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name: {ln!r}")
        label_names = tuple(labels)
        bt = tuple(sorted(buckets)) if buckets is not None else None
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
            fam = Family(name, help, kind, label_names, bt)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Family:
        return self._get_or_create(name, help, "counter", labels)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Family:
        return self._get_or_create(name, help, "gauge", labels)

    def histogram(self, name: str, help: str = "", labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS) -> Family:
        return self._get_or_create(name, help, "histogram", labels, buckets)

    def register_collector(self, fn: Callable[[], None]) -> None:
        """``fn`` runs at each scrape, before rendering — use it to
        refresh gauges whose truth lives elsewhere.  Idempotent on the
        function object so module reloads don't stack duplicates."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def run_collectors(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            # kolint: ignore[KL601] a broken collector must never break the scrape, and counting it here would recurse into the registry being scraped
            except Exception:
                pass

    def families(self) -> List[Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def snapshot(self) -> Dict[str, dict]:
        """Point-in-time value dump for the timeline ring.

        Returns ``{name: {"kind", "label_names", "children": {labels:
        value}}}`` where a counter/gauge value is a float and a
        histogram value is ``{"count", "sum", "cumulative"}`` (the
        ``cumulative()`` (le, count) pairs).  Collectors are NOT run
        here — the ring samples raw state; scrape-time refresh belongs
        to the exporter.
        """
        out: Dict[str, dict] = {}
        for fam in self.families():
            kids: Dict[Tuple[str, ...], object] = {}
            for key, child in fam.children():
                if fam.kind == "histogram":
                    with child._lock:
                        cnt, tot = child.count, child.sum
                    kids[key] = {"count": cnt, "sum": tot,
                                 "cumulative": child.cumulative()}
                else:
                    kids[key] = child.value
            out[fam.name] = {"kind": fam.kind,
                             "label_names": fam.label_names,
                             "children": kids}
        return out

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


def register_collector(fn: Callable[[], None]) -> None:
    REGISTRY.register_collector(fn)
