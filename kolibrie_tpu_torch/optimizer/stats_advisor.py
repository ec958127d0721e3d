"""StatsAdvisor — feedback-driven cardinalities for the cost model.

The cost model (:mod:`kolibrie_tpu_torch.optimizer.cost`) plans from
``DatabaseStats`` guesses: per-pattern index counts, sampled join
selectivities, and the AGM-style ``sqrt(prod)`` bound for WCOJ groups.
Those guesses route join order, WCOJ-vs-Volcano strategy selection and
interpreter admission — and when they are far from the observed
cardinalities the router misroutes (LUBM q9 is the canonical case: the
uniform fractional-edge-cover bound says "triangle, route WCOJ" while
the measured intermediates say Volcano is cheaper).

Every device dispatch already host-reads its per-join match counts in
``converge()`` and computes its scan ranges host-side, so per-operator
*actuals* are free on the warm path; EXPLAIN ANALYZE captures add the
full operator map.  This module is the loop closure: a process-wide
:class:`StatsAdvisor` (same shape as
:class:`kolibrie_tpu_torch.query.template.CapAdvisor`) persists
estimated-vs-actual rows per ``(template fingerprint, operator key)``,
hands the learned values back to the planner/cost model, and bumps a
per-template *plan generation* when the actuals drift past the estimates
the current plan was built from — the executor's plan cache drops the
slot on a generation mismatch, so the next execution replans with tuned
stats (mirroring the breaker-epoch sentinel expiry machinery).

Operator keys are PLAN-SHAPE-INDEPENDENT so a replan under a different
join order still finds its learned rows:

- ``scan:<sig>`` — one triple pattern; ``sig`` renders each position as
  ``?var`` or ``#`` (constants are template parameters, so the sig is a
  pure function of the template).
- ``rows:<sig&sig&...>`` — output rows of any operator covering exactly
  that multiset of patterns.  Every candidate join tree covering the
  same patterns has the same true output cardinality, so this is the
  natural memo key; the full-group entry is shared by the Volcano root
  join and the WCOJ node.
- ``wcoj:?var`` — live rows after the WCOJ level eliminating ``var``
  (elimination-order- and capacity-independent).
- ``result`` — final result rows (post-filter), feeding interpreter
  admission and MQO worthiness.

Gating: ``KOLIBRIE_STATS_ADVISOR=off|auto`` (default ``off``).  The mode
participates in the template fingerprint and the executor's ``env_sig``
exactly like KOLIBRIE_WCOJ / PLAN_INTERP / PALLAS / MQO, so flips replan
cleanly in a fresh slot and ``off`` is bitwise-inert: no observation, no
advice, no replan — today's static routing, bit for bit.

Advisor state ships through the prewarm manifest
(:mod:`kolibrie_tpu_torch.query.compile_cache`, ``durability/fsio`` atomic
writes, corruption-tolerant import) so a restarted replica — or a
WAL-shipped follower bootstrapping from snapshot — starts with tuned
plans instead of re-learning them.  See docs/OPTIMIZER.md.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from kolibrie_tpu_torch.obs import metrics

__all__ = [
    "stats_advisor_mode",
    "override_mode",
    "current_fp",
    "set_current_fp",
    "pattern_sig",
    "phys_key",
    "StatsAdvisor",
    "stats_advisor",
]

_MODES = ("off", "auto")
_tl = threading.local()

# drift thresholds: a key drifts when max(actual,est)/min(actual,est)
# crosses the x-off threshold AND the larger side clears the row floor
# (tiny results produce huge ratios that change nothing)
_DRIFT_XOFF = 4.0
_DRIFT_MIN_ROWS = 64
_MAX_TEMPLATES = 256  # LRU bound, same order as the plan-template caches

_OBSERVATIONS = metrics.counter(
    "kolibrie_stats_advisor_observations_total",
    "per-operator cardinality observations fed to the stats advisor",
)
_REPLANS = metrics.counter(
    "kolibrie_stats_advisor_replans_total",
    "plan-cache slots invalidated by an advisor generation bump",
)
_DRIFT = metrics.counter(
    "kolibrie_stats_advisor_drift_total",
    "drift detections (actuals diverged past the planned estimates)",
)
_MANIFEST_LOADS = metrics.counter(
    "kolibrie_stats_advisor_manifest_loads_total",
    "advisor templates imported from a prewarm manifest",
)
_MANIFEST_SAVES = metrics.counter(
    "kolibrie_stats_advisor_manifest_saves_total",
    "advisor state exports into the prewarm manifest",
)


def stats_advisor_mode() -> str:
    """Feedback-optimizer mode (``KOLIBRIE_STATS_ADVISOR``): ``auto``
    feeds observed cardinalities back into planning and replans on
    drift; ``off`` (default) keeps the static AGM/stat router bit for
    bit.  Thread-local override first (tests and the bench's A/B
    sides)."""
    ov = getattr(_tl, "mode", None)
    if ov is not None:
        return ov
    mode = os.environ.get("KOLIBRIE_STATS_ADVISOR", "off").strip().lower()
    return mode if mode in _MODES else "off"


class override_mode:
    """``with override_mode("auto"): ...`` — scoped, per-thread."""

    def __init__(self, mode: str):
        self.mode = mode

    def __enter__(self):
        self.prev = getattr(_tl, "mode", None)
        _tl.mode = self.mode
        return self

    def __exit__(self, *exc):
        _tl.mode = self.prev
        return False


# ---------------------------------------------------------------------------
# Current-template plumbing: the planner and cost model run deep below the
# executor; the fingerprint rides a thread-local (set next to the obs
# baggage, but independent of it — routing state must not die with the
# observability kill switch).
# ---------------------------------------------------------------------------


def current_fp() -> Optional[str]:
    return getattr(_tl, "fp", None)


def set_current_fp(fp: Optional[str]) -> None:
    _tl.fp = fp


# ---------------------------------------------------------------------------
# Operator keys
# ---------------------------------------------------------------------------


def pattern_sig(pattern) -> str:
    """Canonical signature of one triple pattern: ``?var`` per variable
    position, ``#`` per constant/quoted position.  Constants are
    template parameters, so equal fingerprints imply equal sigs."""
    parts = []
    for t in (pattern.subject, pattern.predicate, pattern.object):
        parts.append(f"?{t.value}" if t.kind == "var" else "#")
    return "|".join(parts)


def subset_key(sigs: List[str]) -> str:
    """Key for the output rows of an operator covering exactly this
    multiset of patterns (any join tree over them has the same true
    cardinality)."""
    return "rows:" + "&".join(sorted(sigs))


def _phys_sigs(op) -> Optional[List[str]]:
    """Pattern sigs of a physical subtree's scan leaves; None when the
    subtree has non-pattern leaves (VALUES, subqueries) — those shapes
    keep their static estimates."""
    from kolibrie_tpu_torch.optimizer import plan as P

    if isinstance(op, (P.PhysIndexScan, P.PhysTableScan)):
        return [pattern_sig(op.pattern)]
    if isinstance(op, (P.PhysStarJoin, P.WcojNode)):
        out: List[str] = []
        for s in op.scans:
            sub = _phys_sigs(s)
            if sub is None:
                return None
            out.extend(sub)
        return out
    if isinstance(
        op, (P.PhysHashJoin, P.PhysMergeJoin, P.PhysParallelJoin,
             P.PhysNestedLoopJoin)
    ):
        left, right = _phys_sigs(op.left), _phys_sigs(op.right)
        if left is None or right is None:
            return None
        return left + right
    return None


def phys_key(op) -> Optional[str]:
    """Advisor operator key of a physical plan node, or None when the
    node has no plan-shape-independent key."""
    from kolibrie_tpu_torch.optimizer import plan as P

    if isinstance(op, (P.PhysIndexScan, P.PhysTableScan)):
        return "scan:" + pattern_sig(op.pattern)
    sigs = _phys_sigs(op)
    if sigs is None or len(sigs) < 2:
        return None
    return subset_key(sigs)


# ---------------------------------------------------------------------------
# The advisor
# ---------------------------------------------------------------------------


class StatsAdvisor:
    """Process-wide per-template estimated-vs-actual cardinality store.

    One entry per template fingerprint: per-operator-key records
    ``{"est": float|None, "actual": float|None, "n": int}``, a plan
    *generation* counter (bumped on drift; the executor invalidates a
    cached plan slot whose stamped generation is behind), and drift
    bookkeeping.  Estimates are (re)recorded by the planner on every
    plan build, so after a drift-triggered replan the estimates match
    the learned values and the loop converges — no replan ping-pong.

    Thread-safe; LRU-bounded at ``_MAX_TEMPLATES`` fingerprints.
    Fingerprints fold every routing mode (including this advisor's own),
    so learned state can never be served across an env flip.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._replans = 0
        self._drifts = 0
        self._observations = 0

    def _entry(self, fp: str) -> Dict[str, Any]:
        ent = self._entries.get(fp)
        if ent is None:
            ent = {
                "ops": {},          # key -> {"est", "actual", "n"}
                "gen": 0,           # plan generation; executor stamps slots
                "est_gen": None,    # generation the current estimates are for
                "source": "agm",    # what the last plan was built from
                "replans": 0,
                "drift": "cold",    # cold | stable | drifted
                "version": None,    # (base_version, delta_epoch) last drift eval
            }
            self._entries[fp] = ent
        self._entries.move_to_end(fp)
        while len(self._entries) > _MAX_TEMPLATES:
            self._entries.popitem(last=False)
        return ent

    # ------------------------------------------------------------- feeding

    def record_estimates(
        self, fp: str, ests: Dict[str, float], source: str
    ) -> None:
        """Planner hook: the per-operator estimates the plan that was
        just built is betting on.  ``source`` is ``learned`` when the
        estimator consulted this advisor, ``agm`` for the static model.
        Stamps ``est_gen`` so drift checks only ever compare actuals
        against CURRENT-generation estimates (a plan the executor has
        not yet rebuilt must not re-trigger the same drift)."""
        if stats_advisor_mode() == "off" or not fp:
            return
        with self._lock:
            ent = self._entry(fp)
            for key, est in ests.items():
                rec = ent["ops"].setdefault(
                    key, {"est": None, "actual": None, "n": 0}
                )
                rec["est"] = float(est)
            ent["est_gen"] = ent["gen"]
            ent["source"] = source

    def observe(
        self,
        fp: Optional[str],
        actuals: Dict[str, float],
        version: Optional[Tuple[int, int]] = None,
    ) -> None:
        """Feed per-operator actual rows from one execution (warm-path
        converge counts, interpreter counts, or an analyze capture) and
        run the drift check.

        Drift evaluation is gated twice: only against estimates recorded
        at the CURRENT generation (see :meth:`record_estimates`), and —
        once a template has learned — only when the store's
        ``(base_version, delta_epoch)`` moved since the last evaluation,
        i.e. on mutation-churn boundaries.  The cold→learned transition
        evaluates immediately: the first execution is exactly when the
        AGM guesses get contradicted and the replan pays off."""
        if stats_advisor_mode() == "off" or not fp or not actuals:
            return
        with self._lock:
            ent = self._entry(fp)
            self._observations += len(actuals)
            _OBSERVATIONS.inc(len(actuals))
            for key, val in actuals.items():
                rec = ent["ops"].setdefault(
                    key, {"est": None, "actual": None, "n": 0}
                )
                rec["actual"] = float(val)
                rec["n"] += 1
            if ent["est_gen"] != ent["gen"]:
                return  # plan predates the last bump; executor will replan
            first_learn = ent["drift"] == "cold"
            boundary = version is None or version != ent["version"]
            ent["version"] = version
            if not (first_learn or boundary):
                return
            if self._drifted(ent):
                ent["gen"] += 1
                ent["drift"] = "drifted"
                self._drifts += 1
                _DRIFT.inc()
            else:
                ent["drift"] = "stable"

    @staticmethod
    def _drifted(ent: Dict[str, Any]) -> bool:
        for rec in ent["ops"].values():
            est, actual = rec["est"], rec["actual"]
            if est is None or actual is None:
                continue
            if max(est, actual) < _DRIFT_MIN_ROWS:
                continue
            lo, hi = min(est, actual), max(est, actual)
            if hi >= max(lo, 1.0) * _DRIFT_XOFF:
                return True
        return False

    # ----------------------------------------------------------- consuming

    def view(self, fp: Optional[str]) -> Optional[Dict[str, float]]:
        """Learned actuals for one template: ``{operator_key: rows}`` —
        None when disabled, cold, or nothing measured yet.  A snapshot
        dict, safe to hold across a whole planning pass."""
        if stats_advisor_mode() == "off" or not fp:
            return None
        with self._lock:
            ent = self._entries.get(fp)
            if ent is None:
                return None
            out = {
                key: rec["actual"]
                for key, rec in ent["ops"].items()
                if rec["actual"] is not None
            }
            return out or None

    def plan_gen(self, fp: Optional[str]) -> int:
        """Current plan generation for a template (0 when off/cold).
        The executor stamps cached slots with this and drops the plan
        when the stamp falls behind — the replan trigger."""
        if stats_advisor_mode() == "off" or not fp:
            return 0
        with self._lock:
            ent = self._entries.get(fp)
            return 0 if ent is None else ent["gen"]

    def note_replan(self, fp: Optional[str]) -> None:
        """Executor hook: a plan slot was invalidated by a generation
        mismatch and will rebuild."""
        with self._lock:
            self._replans += 1
            _REPLANS.inc()
            if fp:
                ent = self._entries.get(fp)
                if ent is not None:
                    ent["replans"] += 1

    def peak_rows(self, fp: Optional[str]) -> Optional[float]:
        """Largest measured intermediate/result row count for a template
        — the interpreter-admission and MQO-worthiness signal."""
        if stats_advisor_mode() == "off" or not fp:
            return None
        with self._lock:
            ent = self._entries.get(fp)
            if ent is None:
                return None
            vals = [
                rec["actual"]
                for key, rec in ent["ops"].items()
                if rec["actual"] is not None
                and (key.startswith(("rows:", "wcoj:")) or key == "result")
            ]
            return max(vals) if vals else None

    def report(self, fp: Optional[str]) -> Optional[Dict[str, Any]]:
        """EXPLAIN's ``advisor:`` line payload plus the per-key est /
        actual pairs for the drift column."""
        if not fp:
            return None
        with self._lock:
            ent = self._entries.get(fp)
            if ent is None:
                return None
            return {
                "source": ent["source"],
                "replans": ent["replans"],
                "drift": ent["drift"],
                "gen": ent["gen"],
                "ops": {
                    key: (rec["est"], rec["actual"])
                    for key, rec in ent["ops"].items()
                },
            }

    # --------------------------------------------------------- persistence

    def export_state(self) -> Dict[str, Any]:
        """JSON-ready advisor section for the prewarm manifest."""
        with self._lock:
            templates = {
                fp: {
                    "ops": {
                        key: {
                            "est": rec["est"],
                            "actual": rec["actual"],
                            "n": rec["n"],
                        }
                        for key, rec in ent["ops"].items()
                    },
                    "gen": ent["gen"],
                    "replans": ent["replans"],
                    "drift": ent["drift"],
                }
                for fp, ent in self._entries.items()
            }
        _MANIFEST_SAVES.inc()
        return {"version": 1, "templates": templates}

    def import_state(self, doc: Any) -> int:
        """Merge a manifest advisor section; returns templates imported.
        Corruption-tolerant: anything that is not the expected shape is
        skipped entry by entry — a torn/garbled section degrades to the
        static AGM model, never to an exception (the manifest is
        advisory, exactly like the compile-cache warmth it rides with).
        Imported estimates are dropped: the restarted process replans
        from the learned actuals, re-recording its own estimates."""
        if not isinstance(doc, dict):
            return 0
        templates = doc.get("templates")
        if not isinstance(templates, dict):
            return 0
        imported = 0
        with self._lock:
            for fp, tent in templates.items():
                if not isinstance(fp, str) or not isinstance(tent, dict):
                    continue
                ops = tent.get("ops")
                if not isinstance(ops, dict):
                    continue
                recs: Dict[str, Dict[str, Any]] = {}
                for key, rec in ops.items():
                    if not isinstance(key, str) or not isinstance(rec, dict):
                        continue
                    actual = rec.get("actual")
                    if not isinstance(actual, (int, float)):
                        continue
                    n = rec.get("n")
                    recs[key] = {
                        "est": None,
                        "actual": float(actual),
                        "n": int(n) if isinstance(n, int) else 1,
                    }
                if not recs:
                    continue
                ent = self._entry(fp)
                ent["ops"].update(recs)
                # learned state is present but no plan was built from it
                # yet in THIS process: leave drift bookkeeping at the
                # cold→learned boundary so the first plan uses the tuned
                # values straight away (plan_gen stays comparable).
                if ent["drift"] == "cold":
                    ent["drift"] = "stable"
                imported += 1
        if imported:
            _MANIFEST_LOADS.inc(imported)
        return imported

    # -------------------------------------------------------------- surface

    def stats(self) -> dict:
        """The ``/stats`` block: per-template learned-key counts, plan
        generation, replans and drift state (bounded by the LRU cap, so
        per-template detail belongs here, not in /metrics labels)."""
        with self._lock:
            return {
                "mode": stats_advisor_mode(),
                "templates": {
                    fp: {
                        "keys": len(ent["ops"]),
                        "gen": ent["gen"],
                        "replans": ent["replans"],
                        "drift": ent["drift"],
                        "source": ent["source"],
                    }
                    for fp, ent in self._entries.items()
                },
                "observations": self._observations,
                "replans_total": self._replans,
                "drift_detections": self._drifts,
            }

    def reset(self) -> None:
        """Drop all learned state (test isolation)."""
        with self._lock:
            self._entries.clear()
            self._replans = 0
            self._drifts = 0
            self._observations = 0


#: the process-wide singleton every engine feeds and the planner consults
stats_advisor = StatsAdvisor()
