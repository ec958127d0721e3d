"""Query → (template fingerprint, parameter tuple) canonicalization.

A *template* is the parsed AST with every constant leaf (IRIs, string and
numeric literals, pattern-position terms, VALUES cells) replaced by a typed
placeholder.  Two queries that differ only in those constants share one
fingerprint, and therefore one plan-cache entry and — because the lowered
plan carries the constants in a traced parameter vector
(:mod:`kolibrie_tpu_torch.optimizer.device_engine`) — one spec tree.

The constants themselves come back as an ordered tuple of ``params``; the
order is the deterministic AST traversal order, which is also the order the
lowering pass consumes them in, so equal fingerprints imply positionally
comparable parameter tuples.

Structure-relevant scalars stay in the fingerprint:

* variable / alias names, operators, DISTINCT, GROUP BY keys;
* whether a string literal parses as a number (the lowering pass branches
  on that when it sits on one side of a comparison);
* for ordered+limited queries, the power-of-two bucket of
  ``offset + limit`` (the top-k ``k`` is a static jit argument, quantized
  exactly like :func:`try_device_execute_ordered` quantizes it);
* the VALUES row/column shape and its UNDEF mask (the device VALUES table
  is shape-static; only the cell contents are parameters).
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from kolibrie_tpu_torch.obs import metrics
from kolibrie_tpu_torch.query.ast import (
    CombinedQuery,
    IriRef,
    NumberLit,
    PatternTerm,
    SelectQuery,
    StringLit,
    ValuesClause,
)

__all__ = [
    "fingerprint_query",
    "template_key",
    "CapAdvisor",
    "cap_advisor",
    "cap_advisor_enabled",
    "occupancy_pct",
]


def occupancy_pct(rows: int, cap: int) -> float:
    """How full a template-cap slot ran: ``rows / cap`` as a percentage.
    The EXPLAIN ANALYZE renderer and the cap advisor's telemetry share
    this so 'occupancy' means one thing everywhere.  A non-positive cap
    (degenerate/elided slot) reads as 0 rather than dividing by zero."""
    if cap <= 0:
        return 0.0
    return 100.0 * rows / cap


# the reference's KOLIBRIE_PALLAS value whose routing the port's kernels
# follow: kernels on the accelerator, plain versions elsewhere
_KERNEL_MODE = "auto"


def _as_number(text: str) -> bool:
    try:
        float(text.strip('"'))
        return True
    except (ValueError, AttributeError):
        return False


def _k_bucket(n: int, lo: int = 8) -> int:
    c = lo
    while c < n:
        c <<= 1
    return c


def _ser(node: Any, params: List[Any]) -> Any:
    """Serialize ``node`` into a hashable structure, appending constant
    leaves to ``params`` and emitting typed placeholders in their place."""
    if isinstance(node, NumberLit):
        params.append(node.value)
        return ("#num",)
    if isinstance(node, StringLit):
        params.append(node.value)
        # lowering treats numeric-looking strings as numeric comparands
        return ("#str", _as_number(node.value))
    if isinstance(node, IriRef):
        params.append(node.iri)
        return ("#iri",)
    if isinstance(node, PatternTerm):
        if node.kind == "var":
            return ("pv", node.value)
        if node.kind == "quoted":
            s, p, o = node.value  # type: ignore[misc]
            return ("pq", _ser(s, params), _ser(p, params), _ser(o, params))
        params.append(node.value)
        return ("#pt",)
    if isinstance(node, ValuesClause):
        rows = tuple(
            tuple("U" if c is None else "#vc" for c in row) for row in node.rows
        )
        for row in node.rows:
            for c in row:
                if c is not None:
                    params.append(c)
        return ("values", tuple(node.variables), rows)
    if isinstance(node, SelectQuery):
        body = tuple(
            (f.name, _ser(getattr(node, f.name), params))
            for f in dataclasses.fields(node)
            if f.name not in ("prefixes", "limit", "offset")
        )
        if node.order_by and node.limit is not None:
            # static top-k bucket: same quantization as the ordered device path
            lim = ("kbucket", _k_bucket((node.offset or 0) + node.limit))
        else:
            lim = ("lim", node.limit is None, node.offset is None)
        params.append(node.limit)
        params.append(node.offset)
        return ("SelectQuery", body, lim)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return (
            type(node).__name__,
            tuple(
                (f.name, _ser(getattr(node, f.name), params))
                for f in dataclasses.fields(node)
                if f.name != "prefixes"
            ),
        )
    if isinstance(node, enum.Enum):
        return ("enum", type(node).__name__, node.value)
    if isinstance(node, dict):
        return (
            "dict",
            tuple(sorted((str(k), _ser(v, params)) for k, v in node.items())),
        )
    if isinstance(node, (list, tuple)):
        return tuple(_ser(x, params) for x in node)
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    return ("repr", repr(node))  # unknown node kinds stay fully structural


def template_key(cq: CombinedQuery) -> Tuple[Any, Tuple[Any, ...]]:
    """Return ``(structure, params)`` for a parsed query: the hashable
    template skeleton and the ordered tuple of extracted constants.

    The join-strategy routing mode (``KOLIBRIE_WCOJ``) is folded into the
    skeleton: strategy selection happens at PLAN time, so a plan cached
    under one mode must never replay after the mode flips — distinct
    fingerprints give each strategy its own slot (and device executable).
    ``KOLIBRIE_PLAN_INTERP`` joins it for the same reason: the interpreter
    routing decision is sticky per cached slot (its source state, its
    learned caps), so a mode flip must land in a fresh fingerprint.
    The third member is the kernel routing mode, which the port does not
    let a caller choose (its kernels run on the card, their plain versions
    on the CPU: the reference's ``KOLIBRIE_PALLAS=auto``, its default), so
    it stays the constant ``"auto"`` and fingerprints equal the
    reference's string for string.  ``KOLIBRIE_MQO``
    is the fourth: shared-prefix routing changes which engine produces a
    template's rows, so a mode flip must land in a fresh fingerprint
    (``off`` reproduces pre-MQO behavior bit-for-bit, docs/MQO.md).
    ``KOLIBRIE_STATS_ADVISOR`` is the fifth: the feedback optimizer keys
    its learned cardinalities (and its plan-generation counter) on the
    fingerprint, so a mode flip must replan in a fresh slot where ``off``
    is bitwise-inert and ``auto`` re-learns from scratch
    (docs/OPTIMIZER.md)."""
    from kolibrie_tpu_torch.optimizer.planner import wcoj_mode  # lazy: avoids cycle
    from kolibrie_tpu_torch.optimizer.mqo import mqo_mode
    from kolibrie_tpu_torch.optimizer.plan_interp import plan_interp_mode
    from kolibrie_tpu_torch.optimizer.stats_advisor import stats_advisor_mode

    params: List[Any] = []
    structure = (
        "stats",
        stats_advisor_mode(),
        (
            "mqo",
            mqo_mode(),
            (
                "interp",
                plan_interp_mode(),
                (
                    "pallas",
                    _KERNEL_MODE,
                    ("wcoj", wcoj_mode(), _ser(cq, params)),
                ),
            ),
        ),
    )
    return structure, tuple(params)


def fingerprint_query(cq: CombinedQuery) -> Tuple[str, Tuple[Any, ...]]:
    """Return ``(fingerprint, params)``: a stable hex digest of the query's
    template skeleton plus the constants stripped from it."""
    structure, params = template_key(cq)
    digest = hashlib.sha1(repr(structure).encode("utf-8")).hexdigest()
    return digest, params


# ---------------------------------------------------------------------------
# capacity advisor
# ---------------------------------------------------------------------------

_CAP_RETRIES = metrics.counter(
    "kolibrie_cap_retries_total",
    "doubled-capacity retried dispatches (overflow → re-run); the cap "
    "advisor exists to hold this at zero in steady state",
    labels=("engine",),
)
# pre-create both engine series so a zero-retry steady state is visible
# in /metrics as an explicit 0, not an absent family
_CAP_RETRIES.labels("device")
_CAP_RETRIES.labels("sharded")


def cap_advisor_enabled() -> bool:
    """``KOLIBRIE_CAP_ADVISOR=off`` (or ``0``) disables advice — retries
    fall back to the pre-advisor heuristics.  Observation continues either
    way, so flipping the flag on after a warm-up period works."""
    return os.environ.get("KOLIBRIE_CAP_ADVISOR", "").strip().lower() not in (
        "off",
        "0",
        "false",
    )


class CapAdvisor:
    """Process-wide per-``(engine, template-fingerprint)`` capacity
    advisor: the feedback loop between the overflow-retry protocols and
    initial capacity choice.

    The engines' own capacity caches are deliberately narrow — the device
    engine's ``_device_cap_cache`` lives on one db object and its
    ``cap_key`` embeds scan-cap buckets that MOVE when store growth
    crosses a power-of-two key-group boundary, and the sharded server
    pins caps per ``(fingerprint, base_version)``, dropping them on every
    mutation.  Each of those invalidations used to restart the
    double-and-retry ladder from the static defaults.  This advisor keys
    only on the template fingerprint (which already folds the
    WCOJ/interp/Pallas routing modes), merges observations as a monotonic
    elementwise maximum, and survives db churn and base-version bumps —
    so a warm process re-dispatches at the high-water mark and retries
    stay at zero.

    ``caps`` tuples are engine-opaque: the device engine stores its
    per-join capacity vector, the sharded server ``(join_cap,
    bucket_cap)``.  Entries whose tuple length changes (a replan under a
    different mode lands on a different fingerprint, so this is
    defensive) are replaced rather than merged.  Thread-safe; bounded by
    the upstream plan-template caches (~64 fingerprints per engine).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, str], Dict[str, Any]] = {}

    def advise(self, engine: str, fp: str) -> Optional[Tuple[int, ...]]:
        """High-water-mark caps for a template, or ``None`` when cold or
        disabled (callers keep their heuristic defaults)."""
        if not cap_advisor_enabled():
            return None
        with self._lock:
            rec = self._entries.get((engine, fp))
            return None if rec is None else rec["caps"]

    def observe(
        self,
        engine: str,
        fp: str,
        caps: Tuple[int, ...],
        base_version: Optional[int] = None,
    ) -> None:
        """Record a successfully converged capacity vector (monotonic
        elementwise max merge)."""
        caps = tuple(int(c) for c in caps)
        with self._lock:
            rec = self._entries.get((engine, fp))
            if rec is None:
                rec = {"caps": caps, "retries": 0, "base_version": None}
                self._entries[(engine, fp)] = rec
            elif len(rec["caps"]) == len(caps):
                rec["caps"] = tuple(
                    max(a, b) for a, b in zip(rec["caps"], caps)
                )
            else:
                rec["caps"] = caps
            if base_version is not None:
                rec["base_version"] = int(base_version)

    def observe_retry(self, engine: str, fp: str, n: int = 1) -> None:
        """Count an overflow-driven doubled-cap re-dispatch (the waste the
        advisor is eliminating)."""
        _CAP_RETRIES.labels(engine).inc(n)
        with self._lock:
            rec = self._entries.setdefault(
                (engine, fp),
                {"caps": (), "retries": 0, "base_version": None},
            )
            rec["retries"] += n

    def retries(self, engine: Optional[str] = None) -> int:
        """Total observed retries (optionally for one engine) — the
        steady-state-zero signal the chaos suite asserts on."""
        with self._lock:
            return sum(
                rec["retries"]
                for (eng, _fp), rec in self._entries.items()
                if engine is None or eng == engine
            )

    def stats(self) -> dict:
        """The ``/stats`` block: per-template current caps, high-water
        mark and retry counts (bounded by the plan-template caches, so
        per-template detail belongs here, not in /metrics labels)."""
        with self._lock:
            return {
                "enabled": cap_advisor_enabled(),
                "templates": {
                    f"{eng}:{fp}": {
                        "caps": list(rec["caps"]),
                        "hwm": max(rec["caps"]) if rec["caps"] else 0,
                        "retries": rec["retries"],
                        "base_version": rec["base_version"],
                    }
                    for (eng, fp), rec in self._entries.items()
                },
                "retries_total": sum(
                    rec["retries"] for rec in self._entries.values()
                ),
            }

    def reset(self) -> None:
        """Drop all learned state (test isolation)."""
        with self._lock:
            self._entries.clear()


#: the process-wide singleton every engine feeds and consults
cap_advisor = CapAdvisor()
