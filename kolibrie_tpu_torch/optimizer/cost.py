"""Cost model (copy of ``kolibrie_tpu/optimizer/cost.py``: the stats
advisor's measured cardinalities replace the guesses where it has them).

Parity: ``streamertail_optimizer/cost/estimator.rs:20-29`` constants —
table scan 100/row, index scan 1/row with a discount per bound position,
hash join 2/row, nested-loop 10/row — and cardinality estimation (:194+).
"""

from __future__ import annotations

from typing import Dict, Optional

from kolibrie_tpu_torch.optimizer import plan as P
from kolibrie_tpu_torch.optimizer.stats_advisor import phys_key

TABLE_SCAN_COST_PER_ROW = 100.0
INDEX_SCAN_COST_PER_ROW = 1.0
HASH_JOIN_COST_PER_ROW = 2.0
NESTED_LOOP_COST_PER_ROW = 10.0
BOUND_POSITION_DISCOUNT = 10.0  # 10x per bound position (index prefix)
PARALLEL_SPEEDUP = 4.0


class _NoPattern:
    """Variables-free stand-in for scan operands without a pattern."""

    @staticmethod
    def variables():
        return ()


_NO_PATTERN = _NoPattern()


class CostEstimator:
    """``learned`` is an optional advisor snapshot — operator-key →
    measured rows for the template being planned
    (:meth:`kolibrie_tpu_torch.optimizer.stats_advisor.StatsAdvisor.view`).
    When a node has a learned entry its MEASURED cardinality replaces the
    stat/AGM guess; everything without a measurement keeps the static
    model, so a cold (or advisor-off) plan is bit-identical to today."""

    def __init__(self, stats, learned: Optional[Dict[str, float]] = None):
        self.stats = stats
        self.learned = learned

    # -------------------------------------------------------- cardinalities

    def _learned_rows(self, op) -> Optional[float]:
        if not self.learned:
            return None
        key = phys_key(op)
        if key is None:
            return None
        rows = self.learned.get(key)
        return None if rows is None else max(float(rows), 1.0)

    def cardinality(self, op) -> float:
        rows = self._learned_rows(op)
        if rows is not None:
            return rows
        if isinstance(op, (P.PhysIndexScan, P.PhysTableScan)):
            return self.stats.pattern_cardinality(op.pattern)
        if isinstance(op, (P.PhysHashJoin, P.PhysMergeJoin, P.PhysParallelJoin)):
            cl = self.cardinality(op.left)
            cr = self.cardinality(op.right)
            if not op.join_vars:
                return cl * cr
            sel = self._join_selectivity(op.left, op.right)
            return max(cl * cr * sel, 1.0)
        if isinstance(op, P.PhysNestedLoopJoin):
            return self.cardinality(op.left) * self.cardinality(op.right)
        if isinstance(op, P.PhysStarJoin):
            cards = sorted(self.cardinality(s) for s in op.scans)
            est = cards[0] if cards else 1.0
            for c in cards[1:]:
                est = max(est * self.stats.join_selectivity(est, c) * c, 1.0)
            return est
        if isinstance(op, P.WcojNode):
            # AGM-style bound with the uniform fractional edge cover 1/2 per
            # pattern: sqrt(prod of pattern cardinalities) — exact exponent
            # for the triangle, a sound flavor for other cyclic shapes
            prod = 1.0
            for s in op.scans:
                prod *= max(self.cardinality(s), 1.0)
            return max(prod**0.5, 1.0)
        if isinstance(op, P.PhysFilter):
            return self.cardinality(op.child) * 0.5
        if isinstance(op, P.PhysBind):
            return self.cardinality(op.child)
        if isinstance(op, P.PhysValues):
            return float(len(op.values.rows))
        if isinstance(op, P.PhysProjection):
            return self.cardinality(op.child)
        if isinstance(op, P.PhysSubquery):
            return 1000.0
        return 1.0

    @staticmethod
    def _scan_predicate(op):
        """Constant predicate of a scan operand, else None
        (optimizer.rs:698-706 ``estimate_join_selectivity`` operand probe)."""
        pattern = getattr(op, "pattern", None)
        if pattern is not None and pattern.predicate.kind == "id":
            return pattern.predicate.value
        return None

    def _join_selectivity(self, left, right) -> float:
        """Per-predicate sampled selectivity when a join side scans a bound
        predicate (cached, ``database_stats.rs:129``); independence fallback
        otherwise."""
        pred = self._scan_predicate(left)
        if pred is None:
            pred = self._scan_predicate(right)
        if pred is not None:
            sel = self.stats.get_join_selectivity(pred)
            if sel > 0.0:
                return sel
        return self.stats.join_selectivity(
            self.cardinality(left), self.cardinality(right)
        )

    def _wcoj_level_cost(self, op) -> Optional[float]:
        """Measured WCOJ probe volume: each level's live intermediate
        rows pay one probe round against every pattern containing the
        level variable.  Requires a learned live count for EVERY level —
        a partial funnel would bias the strategy comparison."""
        if not self.learned or not op.elim_order:
            return None
        total = 0.0
        for var in op.elim_order:
            live = self.learned.get(f"wcoj:?{var}")
            if live is None:
                return None
            accessors = sum(
                1
                for s in op.scans
                if var in getattr(s, "pattern", _NO_PATTERN).variables()
            )
            total += max(float(live), 1.0) * HASH_JOIN_COST_PER_ROW * max(
                accessors, 1
            )
        return total

    # ---------------------------------------------------------------- costs

    def estimate_cost(self, op) -> float:
        if isinstance(op, P.PhysTableScan):
            return self.stats.total_triples * TABLE_SCAN_COST_PER_ROW
        if isinstance(op, P.PhysIndexScan):
            bound = sum(
                1
                for t in (op.pattern.subject, op.pattern.predicate, op.pattern.object)
                if t.kind == "id"
            )
            rows = self.stats.pattern_cardinality(op.pattern)
            return max(
                rows * INDEX_SCAN_COST_PER_ROW / (BOUND_POSITION_DISCOUNT**bound),
                0.1,
            )
        if isinstance(op, (P.PhysHashJoin, P.PhysMergeJoin)):
            cl, cr = self.cardinality(op.left), self.cardinality(op.right)
            child_cost = self.estimate_cost(op.left) + self.estimate_cost(op.right)
            return child_cost + (cl + cr) * HASH_JOIN_COST_PER_ROW
        if isinstance(op, P.PhysParallelJoin):
            cl, cr = self.cardinality(op.left), self.cardinality(op.right)
            child_cost = self.estimate_cost(op.left) + self.estimate_cost(op.right)
            return child_cost + (cl + cr) * HASH_JOIN_COST_PER_ROW / PARALLEL_SPEEDUP
        if isinstance(op, P.PhysNestedLoopJoin):
            cl, cr = self.cardinality(op.left), self.cardinality(op.right)
            child_cost = self.estimate_cost(op.left) + self.estimate_cost(op.right)
            return child_cost + cl * cr * NESTED_LOOP_COST_PER_ROW
        if isinstance(op, P.PhysStarJoin):
            total = sum(self.estimate_cost(s) for s in op.scans)
            return total + self.cardinality(op) * HASH_JOIN_COST_PER_ROW
        if isinstance(op, P.WcojNode):
            # scans feed sorted-range probes, then every level pays one
            # leapfrog probe round over at most output-bound intermediates
            total = sum(self.estimate_cost(s) for s in op.scans)
            measured = self._wcoj_level_cost(op)
            if measured is not None:
                return total + measured
            levels = max(len(op.elim_order), 1)
            return total + self.cardinality(op) * HASH_JOIN_COST_PER_ROW * levels
        if isinstance(op, (P.PhysFilter, P.PhysBind, P.PhysProjection)):
            return self.estimate_cost(op.child) + self.cardinality(op.child) * 0.1
        if isinstance(op, P.PhysValues):
            return float(len(op.values.rows))
        if isinstance(op, P.PhysSubquery):
            return 1000.0
        return 1.0
