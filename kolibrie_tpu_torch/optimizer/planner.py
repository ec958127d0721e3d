"""Streamertail — memoized top-down plan search (copy of
``kolibrie_tpu/optimizer/planner.py``, with the stats advisor's learned
cardinalities under ``KOLIBRIE_STATS_ADVISOR=auto``).

Parity: ``streamertail_optimizer/optimizer.rs`` — ``find_best_plan``
(:186-225) with memoization, star-query detection (:84-152), join reordering
by estimated logical cost (cheaper side first, :252-262), and physical
candidate enumeration (hash / merge / nested-loop / parallel join; table vs
index scan via ``choose_best_scan``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

from kolibrie_tpu_torch.obs import metrics as _obs_metrics
from kolibrie_tpu_torch.optimizer import plan as P
from kolibrie_tpu_torch.optimizer import stats_advisor as _sa
from kolibrie_tpu_torch.optimizer.cost import CostEstimator
from kolibrie_tpu_torch.query.ast import (
    BindClause,
    FilterExpression,
    PatternTriple,
    ValuesClause,
)

STAR_MIN_PATTERNS = 3  # minimum patterns sharing a variable to form a star
WCOJ_MIN_PATTERNS = 3  # smallest cycle; 'force' mode relaxes to 2

# join-strategy selection (bounded label set: three literal strategies)
_JOIN_STRATEGY = _obs_metrics.counter(
    "kolibrie_planner_join_strategy_total",
    "multi-pattern groups planned per join strategy",
    labels=("strategy",),
)


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


def estimated_prefix_rows(plan) -> Optional[float]:
    """Upper-bound row estimate for a physical plan's scan/join prefix:
    the largest leaf-scan cardinality estimate in the tree.  The MQO
    layer (optimizer/mqo.py) uses this as the pre-actuals worthiness
    signal — ``rows × beneficiaries`` decides whether a shared prefix is
    worth caching; once the prefix has actually run, the registry's
    observed row counts replace it.  None when the plan has no estimated
    scan leaves (VALUES-only shapes)."""
    est: Optional[float] = None

    def walk(node) -> None:
        nonlocal est
        if isinstance(node, (P.PhysIndexScan, P.PhysTableScan)):
            e = float(node.estimated_rows or 0.0)
            est = e if est is None else max(est, e)
            return
        for attr in ("left", "right", "child"):
            c = getattr(node, attr, None)
            if c is not None:
                walk(c)

    walk(plan)
    return est


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
        # measured cardinalities for the template being planned (None when
        # KOLIBRIE_STATS_ADVISOR=off, no fingerprint on this thread, or the
        # template is cold): a snapshot taken once per planner so one
        # planning pass never sees a half-updated view
        self.fp = _sa.current_fp()
        self.learned = _sa.stats_advisor.view(self.fp)
        self.estimator = CostEstimator(stats, self.learned)
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
        if self.fp is not None and _sa.stats_advisor_mode() != "off":
            # record what this plan is betting on: the advisor's drift
            # check compares the next execution's actuals against exactly
            # these numbers (docs/OPTIMIZER.md)
            _sa.stats_advisor.record_estimates(
                self.fp,
                self._advisor_estimates(plan),
                "learned" if self.learned else "agm",
            )
        return plan

    def _advisor_estimates(self, plan) -> Dict[str, float]:
        """Per-operator-key cardinality estimates of a finished plan."""
        ests: Dict[str, float] = {}

        def walk(node) -> None:
            key = _sa.phys_key(node)
            if key is not None:
                ests[key] = self.estimator.cardinality(node)
            for attr in ("left", "right", "child"):
                c = getattr(node, attr, None)
                if c is not None:
                    walk(c)
            for s in getattr(node, "scans", ()) or ():
                walk(s)

        walk(plan)
        ests["result"] = self.estimator.cardinality(plan)
        return ests

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
        # measured scan cardinalities refine the elimination order: the
        # leapfrog leader should be the variable whose covering pattern is
        # OBSERVED smallest, not guessed smallest
        cards = []
        for s in scans:
            c = max(self.stats.pattern_cardinality(s.pattern), 1.0)
            if self.learned:
                lv = self.learned.get("scan:" + _sa.pattern_sig(s.pattern))
                if lv is not None:
                    c = max(float(lv), 1.0)
            cards.append(c)
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
            # measured-cost reroute: once the stats advisor has actuals
            # for this template, WCOJ-vs-Volcano is a COST comparison,
            # not a shape rule — the AGM-misrouted cyclic queries (LUBM
            # q9) come back to the binary-join path when the measured
            # funnel volume says so.  Auto mode only; ``force`` stays a
            # test/bench override and cold templates keep the structural
            # routing (zero change vs the static router).
            if self.learned and wcoj_mode() == "auto":
                alt = self._binary_join_plan(scans)
                if self._explore_binary_alt(alt):
                    # fresh measurements: re-snapshot and re-order the
                    # alternative under its now-measured cardinalities
                    self.learned = (
                        _sa.stats_advisor.view(self.fp) or self.learned
                    )
                    self.estimator = CostEstimator(self.stats, self.learned)
                    alt = self._binary_join_plan(scans)
                if self.estimator.estimate_cost(
                    alt
                ) < self.estimator.estimate_cost(wcoj):
                    _JOIN_STRATEGY.labels(
                        "star" if isinstance(alt, P.PhysStarJoin)
                        else "volcano"
                    ).inc()
                    return alt
            _JOIN_STRATEGY.labels("wcoj").inc()
            return wcoj
        plan = self._binary_join_plan(scans)
        _JOIN_STRATEGY.labels(
            "star" if isinstance(plan, P.PhysStarJoin) else "volcano"
        ).inc()
        return plan

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

    def _explore_binary_alt(self, alt) -> bool:
        """One-time host-oracle exploration for the WCOJ-vs-Volcano cost
        comparison.  A template that always routed WCOJ never observes
        the binary alternative's intermediate cardinalities, so the
        comparison would forever pit a MEASURED funnel against a static
        guess (and the static pairwise-join estimates are exactly what
        misroute).  When the alternative has unmeasured join keys, lower
        it and run ONE host-numpy evaluation — the same pass every
        device template already pays at capacity calibration — whose
        exact join counts feed the advisor.  Self-extinguishing: the
        next planning pass finds the keys learned and skips this.
        Returns True when new measurements were fed."""
        if self.fp is None or not self.learned:
            return False
        missing = False

        def walk(node) -> None:
            nonlocal missing
            if isinstance(
                node,
                (P.PhysHashJoin, P.PhysMergeJoin, P.PhysParallelJoin,
                 P.PhysNestedLoopJoin, P.PhysStarJoin),
            ):
                key = _sa.phys_key(node)
                if key is not None and key not in self.learned:
                    missing = True
            for attr in ("left", "right", "child"):
                c = getattr(node, attr, None)
                if c is not None:
                    walk(c)

        walk(alt)
        if not missing:
            return False
        db = self.stats.database()
        if db is None:
            return False
        from kolibrie_tpu_torch.optimizer import device_engine as de

        try:
            lowered = de.lower_plan(db, alt)
            # host binary searches + numpy joins only (no device I/O);
            # calibrate_host feeds the advisor with the exact counts and
            # pre-seeds the alternative's capacity cache for a flip
            lowered.calibrate_host()
        # exploration is advisory: an unlowerable or failing alternative
        # just keeps the structural routing
        # kolint: ignore[KL601] exploration is advisory: an unlowerable or failing alternative just keeps the structural routing
        except Exception:
            return False
        return True

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
