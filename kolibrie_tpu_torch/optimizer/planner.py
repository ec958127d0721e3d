"""Streamertail — memoized top-down plan search (copy of
``kolibrie_tpu/optimizer/planner.py`` without the stats-advisor feedback:
plans come from the sampled statistics alone, as the reference's do with
its advisor off, its default).

Parity: ``streamertail_optimizer/optimizer.rs`` — ``find_best_plan``
(:186-225) with memoization, star-query detection (:84-152), join reordering
by estimated logical cost (cheaper side first, :252-262), and physical
candidate enumeration (hash / merge / nested-loop / parallel join; table vs
index scan via ``choose_best_scan``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from kolibrie_tpu_torch.optimizer import plan as P
from kolibrie_tpu_torch.optimizer.cost import CostEstimator
from kolibrie_tpu_torch.query.ast import (
    BindClause,
    FilterExpression,
    PatternTriple,
    ValuesClause,
)

STAR_MIN_PATTERNS = 3  # minimum patterns sharing a variable to form a star
WCOJ_MIN_PATTERNS = 3  # smallest cycle; 'force' mode relaxes to 2

def wcoj_mode() -> str:
    """Worst-case-optimal join routing mode (``KOLIBRIE_WCOJ``):
    ``auto`` (default) routes CYCLIC basic graph patterns to the WCOJ
    node and keeps acyclic chains on the Volcano binary-join path;
    ``off`` disables WCOJ; ``force`` routes every eligible connected
    group of >= 2 patterns (test/bench hook).  Read per planning call —
    the template fingerprint folds the mode in, so flipping it never
    replays a plan cached under the other strategy."""
    mode = os.environ.get("KOLIBRIE_WCOJ", "auto").strip().lower()
    return mode if mode in ("auto", "off", "force") else "auto"


def _gyo_cyclic(edge_sets: List[frozenset]) -> bool:
    """Hypergraph cyclicity via GYO reduction: repeatedly drop vertices
    that occur in exactly one edge and edges contained in another edge
    (duplicate-aware).  Alpha-acyclic hypergraphs reduce to nothing; a
    non-empty fixpoint (e.g. the triangle {xy, yz, zx}) is cyclic —
    exactly the shapes whose binary-join intermediates exceed the AGM
    output bound."""
    edges = [set(e) for e in edge_sets if e]
    changed = True
    while changed and edges:
        changed = False
        count: Dict[str, int] = {}
        for e in edges:
            for v in e:
                count[v] = count.get(v, 0) + 1
        for e in edges:
            lone = {v for v in e if count[v] == 1}
            if lone:
                e -= lone
                changed = True
        kept: List[set] = []
        for i, e in enumerate(edges):
            if not e:
                changed = True
                continue
            contained = any(
                f and i != j and (e < f or (e == f and i > j))
                for j, f in enumerate(edges)
            )
            if contained:
                changed = True
            else:
                kept.append(e)
        edges = kept
    return bool(edges)


def _connected(var_sets: List[frozenset]) -> bool:
    """True when the patterns form ONE join-connected component."""
    if not var_sets:
        return False
    pending = list(range(1, len(var_sets)))
    reached = set(var_sets[0])
    grew = True
    while pending and grew:
        grew = False
        for i in list(pending):
            if var_sets[i] & reached:
                reached |= var_sets[i]
                pending.remove(i)
                grew = True
    return not pending


def build_logical_plan(
    patterns: List[PatternTriple],
    filters: Optional[List[FilterExpression]] = None,
    binds: Optional[List[BindClause]] = None,
    values: Optional[ValuesClause] = None,
) -> object:
    """Logical plan: scans joined left-deep (order chosen by the optimizer),
    then filters, binds, values.  Parity: ``streamertail_optimizer/utils.rs:101``.
    """
    scans: List[object] = [P.LogicalScan(p) for p in patterns]
    if values is not None and values.rows:
        scans.append(P.LogicalValues(values))
    if not scans:
        root: object = P.LogicalValues(ValuesClause([], []))
    elif len(scans) == 1:
        root = scans[0]
    else:
        root = scans[0]
        for s in scans[1:]:
            root = P.LogicalJoin(root, s)
    for f in filters or []:
        root = P.LogicalFilter(f, root)
    for b in binds or []:
        root = P.LogicalBind(b, root)
    return root


class Streamertail:
    """Cost-based physical plan selection over a logical plan."""

    def __init__(self, stats):
        self.stats = stats
        self.estimator = CostEstimator(stats)
        self._memo: Dict[int, Tuple[object, float]] = {}

    # ----------------------------------------------------------- public API

    def find_best_plan(self, logical_root) -> object:
        # flatten join trees into a scan list; filters/binds applied on top
        scans, wrappers = self._flatten(logical_root)
        plan = self._plan_joins(scans)
        for kind, payload in wrappers:
            if kind == "filter":
                plan = P.PhysFilter(payload, plan)
            else:
                plan = P.PhysBind(payload, plan)
        return plan

    # ------------------------------------------------------------ internals

    def _flatten(self, op) -> Tuple[List[object], List[Tuple[str, object]]]:
        wrappers: List[Tuple[str, object]] = []
        while isinstance(op, (P.LogicalFilter, P.LogicalBind)):
            if isinstance(op, P.LogicalFilter):
                wrappers.append(("filter", op.expr))
            else:
                wrappers.append(("bind", op.bind))
            op = op.child
        wrappers.reverse()
        scans: List[object] = []

        def collect(node):
            if isinstance(node, P.LogicalJoin):
                collect(node.left)
                collect(node.right)
            else:
                scans.append(node)

        collect(op)
        return scans, wrappers

    def _scan_for(self, leaf) -> object:
        if isinstance(leaf, P.LogicalScan):
            return self._choose_best_scan(leaf.pattern)
        if isinstance(leaf, P.LogicalValues):
            return P.PhysValues(leaf.values)
        if isinstance(leaf, P.LogicalSubquery):
            return P.PhysSubquery(leaf.subquery)
        raise TypeError(f"unexpected logical leaf {leaf!r}")

    def _choose_best_scan(self, pattern: PatternTriple) -> object:
        """IndexScan when any position is bound; TableScan otherwise."""
        bound = sum(
            1
            for t in (pattern.subject, pattern.predicate, pattern.object)
            if t.kind != "var"
        )
        est = self.stats.pattern_cardinality(pattern)
        if bound > 0:
            return P.PhysIndexScan(pattern, est)
        return P.PhysTableScan(pattern, est)

    def _detect_star(self, scans: List[object]) -> Optional[Tuple[str, List[int]]]:
        """Greedy star detection: a variable appearing in >= STAR_MIN_PATTERNS
        scan patterns (optimizer.rs:84-152)."""
        var_positions: Dict[str, List[int]] = {}
        for i, s in enumerate(scans):
            if not isinstance(s, P.LogicalScan):
                continue
            for v in set(s.pattern.variables()):
                var_positions.setdefault(v, []).append(i)
        best: Optional[Tuple[str, List[int]]] = None
        for v, idxs in var_positions.items():
            if len(idxs) >= STAR_MIN_PATTERNS and (
                best is None or len(idxs) > len(best[1])
            ):
                best = (v, idxs)
        return best

    def _try_wcoj(self, scans: List[object]) -> Optional[P.WcojNode]:
        """Route eligible pattern groups to the worst-case-optimal multiway
        join: every leaf a plain triple scan (no quoted terms, no repeated
        variables, at least one variable each), the join graph connected,
        and — in ``auto`` mode — GYO-cyclic, the shapes where Volcano
        binary-join intermediates exceed the AGM output bound.  ``force``
        mode (tests/benches) relaxes to any connected group of >= 2."""
        mode = wcoj_mode()
        if mode == "off":
            return None
        min_patterns = 2 if mode == "force" else WCOJ_MIN_PATTERNS
        if len(scans) < min_patterns:
            return None
        var_sets: List[frozenset] = []
        for s in scans:
            if not isinstance(s, P.LogicalScan):
                return None
            terms = (s.pattern.subject, s.pattern.predicate, s.pattern.object)
            if any(t.kind == "quoted" for t in terms):
                return None  # quoted-triple terms stay on the scan machinery
            vs = [t.value for t in terms if t.kind == "var"]
            if not vs or len(set(vs)) != len(vs):
                return None  # const-only or repeated-variable patterns
            var_sets.append(frozenset(vs))
        if not _connected(var_sets):
            return None
        if mode != "force" and not _gyo_cyclic(var_sets):
            return None
        cards = [max(self.stats.pattern_cardinality(s.pattern), 1.0) for s in scans]
        node = P.WcojNode(
            scans=[self._scan_for(s) for s in scans],
            elim_order=self._elimination_order(var_sets, cards),
        )
        node.estimated_rows = self.estimator.cardinality(node)
        return node

    @staticmethod
    def _elimination_order(
        var_sets: List[frozenset], cards: List[float]
    ) -> List[str]:
        """Variable elimination order: start from the variable whose
        tightest covering pattern is smallest (fewest leapfrog candidates),
        then grow connected-first.  Ties break on the variable name so
        equal statistics always yield the same order — planning reruns per
        constant binding, and an order flip would change the lowered spec
        and recompile."""
        score: Dict[str, float] = {}
        for vs, c in zip(var_sets, cards):
            for v in vs:
                score[v] = min(score.get(v, float("inf")), c)
        remaining = set(score)
        chosen: set = set()
        order: List[str] = []
        while remaining:
            linked = {
                v
                for v in remaining
                if any(v in vs and (vs & chosen) for vs in var_sets)
            }
            pool = linked if linked else remaining
            nxt = min(pool, key=lambda v: (score[v], v))
            order.append(nxt)
            remaining.remove(nxt)
            chosen.add(nxt)
        return order

    def _plan_joins(self, scans: List[object]) -> object:
        if not scans:
            return P.PhysValues(ValuesClause([], []))
        if len(scans) == 1:
            return self._scan_for(scans[0])

        wcoj = self._try_wcoj(scans)
        if wcoj is not None:
            return wcoj
        return self._binary_join_plan(scans)

    def _binary_join_plan(self, scans: List[object]) -> object:
        """The binary-join strategies: star when every scan shares the
        center variable, else the greedy left-deep Volcano ordering."""
        star = self._detect_star(scans)
        if star is not None and len(star[1]) == len(scans):
            center, idxs = star
            return P.PhysStarJoin(
                center, [self._scan_for(scans[i]) for i in idxs]
            )

        # greedy cheapest-first left-deep join ordering with connectivity
        # preference (reference reorders by estimated logical cost; :252-262)
        remaining = list(range(len(scans)))
        phys = {i: self._scan_for(scans[i]) for i in remaining}
        vars_of = {
            i: (
                set(scans[i].pattern.variables())
                if isinstance(scans[i], P.LogicalScan)
                else (
                    set(scans[i].values.variables)
                    if isinstance(scans[i], P.LogicalValues)
                    else set()
                )
            )
            for i in remaining
        }
        costs = {i: self.estimator.estimate_cost(phys[i]) for i in remaining}
        start = min(remaining, key=lambda i: costs[i])
        remaining.remove(start)
        plan = phys[start]
        bound_vars = set(vars_of[start])
        while remaining:
            connected = [i for i in remaining if vars_of[i] & bound_vars]
            pool = connected if connected else remaining
            nxt = min(pool, key=lambda i: costs[i])
            remaining.remove(nxt)
            join_vars = sorted(vars_of[nxt] & bound_vars)
            plan = self._best_join(plan, phys[nxt], join_vars)
            bound_vars |= vars_of[nxt]
        return plan

    def _best_join(self, left, right, join_vars: List[str]) -> object:
        cl = self.estimator.cardinality(left)
        cr = self.estimator.cardinality(right)
        candidates: List[object] = [
            P.PhysHashJoin(left, right, join_vars, optimized=True),
            P.PhysHashJoin(left, right, join_vars, optimized=False),
            P.PhysMergeJoin(left, right, join_vars),
            P.PhysParallelJoin(left, right, join_vars),
        ]
        if cl * cr <= 10_000:  # NLJ only for tiny inputs (optimizer.rs)
            candidates.append(P.PhysNestedLoopJoin(left, right))
        return min(candidates, key=self.estimator.estimate_cost)
