"""Query entry points of the PyTorch port: parse → plan → device engine →
host post-passes → format, and the statements beside SELECT.

Port of ``kolibrie_tpu/query/executor.py`` (``execute_query_volcano``,
``execute_combined``, the legacy ``execute_query``), with the reference's
routing between the device program, the host engine and the host
post-passes:

- plain sub-SELECTs fold into the group (:mod:`.subquery_inline`); the
  group's BGP, FILTERs and VALUES run on the device engine
  (:mod:`kolibrie_tpu_torch.optimizer.device_engine`), and its UNION /
  OPTIONAL / MINUS / NOT clauses fuse into the same device program when
  every branch is a plain BGP (all or nothing);
- a plan the device lowering declines with :class:`Unsupported` (a
  cartesian join, a filter function it has no mask for, a constant-only
  group, the empty group of a clause-only WHERE) runs on the host engine,
  :meth:`ExecutionEngine.execute_with_ids`, which still runs on the
  database's device; ``use_optimizer=False`` (``execute_query``) joins
  the patterns in textual order (:func:`_naive_eval`), on the device too;
- otherwise the clauses run as host post-passes over device tables: each
  branch is its own :func:`eval_where`; a non-inlinable subquery joins on
  the host too;
- GROUP BY aggregates segment-reduce on the device
  (``try_device_execute_aggregated``) unless their shape needs the host
  aggregation; ORDER BY … LIMIT takes the device top-k
  (``try_device_execute_ordered``) where it applies;
- BIND, FILTERs over BIND outputs, projection and SELECT expressions,
  DISTINCT, host ORDER BY, formatting and LIMIT/OFFSET run on the host over
  the read-back table;
- INSERT DATA, DELETE DATA and DELETE … WHERE (its WHERE through
  :func:`eval_where`), RULE definitions
  (:mod:`kolibrie_tpu_torch.reasoner.rule_runtime`, the closure on the
  device fixpoint) and the ML statements (MODEL, NEURAL RELATION, TRAIN,
  ML.PREDICT: :mod:`kolibrie_tpu_torch.ml.runtime`, the MLP on the
  database's device) run through :func:`execute_combined`; a neural
  predicate that a SELECT names materialises first.

WINDOW blocks raise :class:`Unsupported` with the construct's name.

Routing and faults (the reference's): ``db.execution_mode`` "auto" runs
the device program from :data:`_DEVICE_AUTO_MIN` triples and the host
engine below, "device" / "host" force either; the host engine runs on the
database's device.  Device-routed statements run behind the template's
circuit breaker: a device fault serves the call degraded on the host
engine (:func:`_execute_degraded`), an open breaker serves the template
degraded until a half-open probe succeeds, and ``check_deadline`` sheds a
request whose deadline passed.

Repeated queries (the reference's plan cache and batching):

- :func:`execute_query_volcano` keys every statement on the parsed AST
  (query text + prefixes) and every SELECT on its constant-free template
  fingerprint (:mod:`kolibrie_tpu_torch.query.template`): a repeat replays
  the cached plan and lowered program (:func:`plan_cache_info` counts the
  hits, misses and parameter rebinds); the slots are per store base
  version, so mutations under the delta threshold keep them;
- :func:`execute_queries_batched` runs same-template plain SELECTs as one
  batched dispatch (``device_engine.execute_plan_batch``), the rest solo,
  with MQO's transient beneficiaries registered for the solo tail.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from kolibrie_tpu_torch.core.dictionary import QUOTED_BIT, display_form
from kolibrie_tpu_torch.core.triple import Triple
from kolibrie_tpu_torch.ops.join import (
    UNBOUND,
    BindingTable,
    anti_join_tables,
    concat_tables,
    equi_join_device,
    equi_join_tables,
    left_outer_join_tables,
    table_len,
    table_to_host,
)
from kolibrie_tpu_torch.ops.unique import unique_table
from kolibrie_tpu_torch.obs import metrics as obs_metrics
from kolibrie_tpu_torch.obs.spans import set_baggage, span
from kolibrie_tpu_torch.optimizer.device_engine import (
    Unsupported,
    clause_replayable,
    execute_plan_batch,
    lower_plan,
    try_device_execute,
    try_device_execute_aggregated,
    try_device_execute_ordered,
)
from kolibrie_tpu_torch.optimizer.stats_advisor import set_current_fp as _sa_set_current_fp
from kolibrie_tpu_torch.optimizer.engine import ExecutionEngine, resolve_pattern
from kolibrie_tpu_torch.optimizer.planner import Streamertail, build_logical_plan
from kolibrie_tpu_torch.query import ast as A
from kolibrie_tpu_torch.query.ast import (
    CombinedQuery,
    DeleteClause,
    InsertClause,
    OrderCondition,
    PatternTerm,
    SelectQuery,
    Var,
    WhereClause,
)
from kolibrie_tpu_torch.query.parser import parse_combined_query
from kolibrie_tpu_torch.query.subquery_inline import inline_subqueries
from kolibrie_tpu_torch.resilience.breaker import breaker_board
from kolibrie_tpu_torch.resilience.deadline import check_deadline
from kolibrie_tpu_torch.resilience.errors import DeadlineExceeded, is_device_fault

__all__ = [
    "Unsupported",
    "execute_query_volcano",
    "execute_queries_batched",
    "execute_query",
    "execute_combined",
    "eval_where",
    "format_results",
    "plan_cache_info",
]

Rows = List[List[str]]

_PARSE_LAT = obs_metrics.histogram(
    "kolibrie_query_parse_seconds", "SPARQL parse + template fingerprint time"
)
_PLAN_LAT = obs_metrics.histogram("kolibrie_query_plan_seconds", "Streamertail plan search time")
_QUERY_LAT = obs_metrics.histogram(
    "kolibrie_query_seconds",
    "end-to-end executor time by path (device/host/degraded)",
    labels=("path",),
)
_PLAN_CACHE_EVENTS = obs_metrics.counter(
    "kolibrie_plan_cache_events_total",
    "plan-cache lookups by outcome",
    labels=("event",),
)
_BATCHED_QUERIES = obs_metrics.counter(
    "kolibrie_query_batched_total",
    "queries served by a stacked-parameter batch dispatch",
)
# fixed-label children hoisted out of the per-query hot path
_QUERY_LAT_DEVICE = _QUERY_LAT.labels("device")
_QUERY_LAT_HOST = _QUERY_LAT.labels("host")
_QUERY_LAT_DEGRADED = _QUERY_LAT.labels("degraded")
_PLAN_CACHE_HIT = _PLAN_CACHE_EVENTS.labels("hit")
_PLAN_CACHE_MISS = _PLAN_CACHE_EVENTS.labels("miss")
_PLAN_CACHE_REBIND = _PLAN_CACHE_EVENTS.labels("param_rebind")
_PLAN_CACHE_EVICTION = _PLAN_CACHE_EVENTS.labels("eviction")

# "auto" execution mode switches to the device program at this store size;
# db.execution_mode = "device" / "host" forces either path.  The host
# engine runs on the database's device too.
_DEVICE_AUTO_MIN = 100_000


def _interp_mode() -> str:
    """Current ``KOLIBRIE_PLAN_INTERP`` routing mode (lazy import: the
    interpreter module pulls in the device engine)."""
    from kolibrie_tpu_torch.optimizer.plan_interp import plan_interp_mode

    return plan_interp_mode()


def _device_routed(db) -> bool:
    """THE routing rule for "does this query run the device program":
    explicit ``execution_mode == "device"``, or auto mode over a store big
    enough that the device program beats the host engine."""
    mode = getattr(db, "execution_mode", "auto")
    return mode == "device" or (mode == "auto" and len(db.store) >= _DEVICE_AUTO_MIN)


def _filter_vars(expr) -> List[str]:
    out: List[str] = []

    def walk(e):
        if isinstance(e, A.Var):
            out.append(e.name)
        elif isinstance(e, A.Comparison):
            walk(e.left)
            walk(e.right)
        elif isinstance(e, (A.LogicalAnd, A.LogicalOr)):
            walk(e.left)
            walk(e.right)
        elif isinstance(e, A.LogicalNot):
            walk(e.inner)
        elif isinstance(e, (A.FunctionCall, A.FuncExpr)):
            for a in e.args:
                walk(a)
        elif isinstance(e, A.ArithOp):
            walk(e.left)
            walk(e.right)

    walk(expr)
    return out


def _check_where(where: WhereClause) -> None:
    if where.window_blocks:
        raise Unsupported("WINDOW block")


def _clause_plans(db, planner, where: WhereClause):
    """Branch plans of the WHERE's UNION groups, OPTIONALs and MINUS / NOT
    blocks as ``(union_groups, optional_plans, anti_plans)``, or None when
    a branch needs the host post-pass (fusion is all or nothing)."""
    union_groups: List[tuple] = []
    optional_plans: List[object] = []
    anti_plans: List[object] = []
    for groups in where.unions:
        g = [_branch_plan(db, planner, bw) for bw in groups]
        if any(bp is None for bp in g):
            return None
        union_groups.append(tuple(g))
    for ow in where.optionals:
        bp = _branch_plan(db, planner, ow)
        if bp is None:
            return None
        optional_plans.append(bp)
    for bw in list(where.minus) + [WhereClause(patterns=nb.patterns) for nb in where.not_blocks]:
        bp = _branch_plan(db, planner, bw)
        if bp is None:
            return None
        anti_plans.append(bp)
    return tuple(union_groups), tuple(optional_plans), tuple(anti_plans)


def _has_clauses(where: WhereClause) -> bool:
    return bool(where.minus or where.not_blocks or where.unions or where.optionals)


def _lower_or_none(db, plan, anti_plans=(), union_groups=(), optional_plans=()):
    """The device lowering of ``plan``, or None where it declines with
    :class:`Unsupported`.  Only the lowering is inside the ``try``: a run
    failure (a CUDA error, a kernel build, a capacity that does not
    converge) propagates."""
    try:
        return lower_plan(db, plan, anti_plans, union_groups, optional_plans)
    except Unsupported:
        return None


def eval_where(
    db,
    where: WhereClause,
    use_optimizer: bool = True,
    prebuilt_plan=None,
    prebuilt_lowered=None,
    capture=None,
) -> BindingTable:
    """Evaluate a group graph pattern to a binding table (IDs).

    ``use_optimizer=False`` joins the patterns in textual order
    (:func:`_naive_eval`).  ``prebuilt_plan`` / ``prebuilt_lowered``: the
    physical plan and the device lowering already made for this WHERE (by
    the aggregate route, or replayed from the plan cache; the lowering
    ``False`` when it declined), so neither runs twice.  ``capture``:
    plan-cache entry dict — the plan and the lowered program (or ``False``
    for a failed lowering) are recorded into it for the next identical
    query."""
    # fold plain sub-SELECTs into the group before planning: one device
    # plan instead of materialize-then-join on the host
    where = inline_subqueries(where)
    _check_where(where)
    engine = ExecutionEngine(db, subquery_eval=lambda sq: eval_select_to_table(db, sq.query))
    resolved = [resolve_pattern(db, p) for p in where.patterns]
    # filters referencing BIND outputs can only run after the binds
    bind_vars = {b.var for b in where.binds}
    plan_filters = [f for f in where.filters if not (set(_filter_vars(f)) & bind_vars)]
    post_bind_filters = [f for f in where.filters if set(_filter_vars(f)) & bind_vars]
    fused_clauses = False
    if use_optimizer:
        planner = Streamertail(db.get_or_build_stats())
        plan = prebuilt_plan
        if plan is None:
            logical = build_logical_plan(resolved, plan_filters, [], where.values)
            with span("query.plan"):
                t0 = time.perf_counter()
                plan = planner.find_best_plan(logical)
                _PLAN_LAT.observe(time.perf_counter() - t0)
        if capture is not None:
            capture["plan"] = plan
        table = None
        if prebuilt_lowered is not None and prebuilt_lowered is not False:
            table = prebuilt_lowered.execute()
            fused_clauses = prebuilt_lowered.fused_clauses
        elif prebuilt_lowered is None and _device_routed(db):
            if not where.subqueries and _has_clauses(where):
                # UNION / OPTIONAL / MINUS / NOT fuse into the device program
                # in the order the host post-passes apply them.  All or
                # nothing: a single non-BGP branch keeps every clause on the
                # post-pass path.
                clauses = _clause_plans(db, planner, where)
                if clauses is not None:
                    union_groups, optional_plans, anti_plans = clauses
                    main_plan = plan
                    if not where.patterns and where.values is None:
                        # clause-only group: the first union/optional stands
                        # alone (plan None).  Filters attached to an empty
                        # plan never see clause columns on the host path, so
                        # only a filter-free group keeps exact parity.
                        if where.filters or not (union_groups or optional_plans):
                            main_plan = False
                        else:
                            main_plan = None
                    if main_plan is not False:
                        table = try_device_execute(
                            db, main_plan, anti_plans, union_groups, optional_plans,
                            capture=capture,
                        )
                        fused_clauses = table is not None
            if table is None:
                table = try_device_execute(db, plan, capture=capture)
        if table is None and not _device_routed(db):
            # host-routed stores reach the MQO layer here: the shared
            # prefix evaluates once and only the filter suffix runs per
            # query (optimizer/mqo.py)
            from kolibrie_tpu_torch.optimizer import mqo as _mqo

            table = _mqo.try_shared_host(db, plan)
        if table is None:
            # a host-routed store, or a plan the lowering declined: the
            # reference's host engine, run on the database's device
            from kolibrie_tpu_torch.obs import analyze as _obs_analyze

            cap_rec = _obs_analyze.active()
            if cap_rec is not None:
                # EXPLAIN ANALYZE honesty: say WHICH engine ran when the
                # query never reached a device program
                cap_rec.record(
                    "host",
                    reason=(
                        "device lowering unavailable"
                        if _device_routed(db)
                        else "host-routed store"
                    ),
                )
            table = engine.execute_with_ids(plan)
    else:
        table = _naive_eval(engine, resolved, where, plan_filters)
    # subqueries that did not inline join in on the host
    for sq in where.subqueries:
        table = equi_join_tables(table, eval_select_to_table(db, sq.query))
    if _has_clauses(where) and not fused_clauses:
        table = _clause_post_passes(db, table, where, use_optimizer)
    # BINDs after joins (may reference any bound variable)
    for b in where.binds:
        table = dict(table)
        table[b.var] = engine.eval_arith_to_ids(b.expr, table)
    for f in post_bind_filters:
        mask = engine.eval_filter(f, table)
        table = {k: v[mask] for k, v in table.items()}
    return table


def _naive_eval(engine: ExecutionEngine, patterns, where: WhereClause, filters) -> BindingTable:
    """Legacy sequential join path (``execute_query``): the patterns joined
    in textual order, then the VALUES, then the filters, on the device;
    the table is read back once."""
    table = None
    for pat in patterns:
        t = engine._scan(pat)
        table = t if table is None else equi_join_device(table, t)
    if table is None:
        table = {}
        if where.values is not None:
            table = engine._values_table(where.values)
    elif where.values is not None:
        table = equi_join_device(table, engine._values_table(where.values))
    for f in filters:
        table = engine.filter_device(f, table)
    return table_to_host(table)


def _clause_post_passes(
    db, table: BindingTable, where: WhereClause, use_optimizer: bool = True
) -> BindingTable:
    """UNION, OPTIONAL, MINUS and NOT over ``table`` on the host, each
    branch table from its own :func:`eval_where` (on the device)."""
    for groups in where.unions:
        parts = [eval_where(db, g, use_optimizer) for g in groups]
        keys = set()
        for t in parts:
            keys |= set(t)
        norm = []
        for t in parts:
            nt = dict(t)
            n = table_len(t)
            for k in keys:
                if k not in nt:
                    nt[k] = np.full(n, UNBOUND, dtype=np.uint32)
            norm.append(nt)
        union_table = concat_tables(norm) if norm else {}
        if table_len(table) or where.patterns:
            table = equi_join_tables(table, union_table)
        else:
            table = union_table
    for opt in where.optionals:
        opt_table = eval_where(db, opt, use_optimizer)
        if (
            not table
            and not where.patterns
            and where.values is None
            and not where.subqueries
            and not where.unions
        ):
            # OPTIONAL over the unit table keeps the optional's solutions
            table = opt_table
        else:
            table = left_outer_join_tables(table, opt_table)
    for m in where.minus:
        table = anti_join_tables(table, eval_where(db, m, use_optimizer))
    for nb in where.not_blocks:
        table = anti_join_tables(
            table, eval_where(db, WhereClause(patterns=nb.patterns), use_optimizer)
        )
    return table


def _branch_plan(db, planner, bw: WhereClause):
    """Physical plan of a clause branch (UNION / OPTIONAL / MINUS / NOT
    block) that may fuse into the device program; ``None`` when the branch
    needs the host post-pass (non-BGP content)."""
    bw = inline_subqueries(bw)
    if (
        not bw.patterns
        or bw.binds
        or bw.values is not None
        or bw.subqueries
        or bw.not_blocks
        or bw.window_blocks
        or bw.optionals
        or bw.unions
        or bw.minus
    ):
        return None
    bres = [resolve_pattern(db, p) for p in bw.patterns]
    return planner.find_best_plan(build_logical_plan(bres, list(bw.filters), [], None))


def _is_aggregate(q: SelectQuery) -> bool:
    return bool(q.group_by) or any(i.kind == "agg" for i in q.select)


def eval_select_to_table(
    db, q: SelectQuery, use_optimizer: bool = True, cache_entry=None
) -> BindingTable:
    """Run a SELECT down to a binding table projected to its variables
    (aggregates resolved).  ``cache_entry``: plan-cache slot (see
    :func:`_plan_cache_entry`) — a populated slot's plan and lowered
    program skip the planner and the lowering; a fresh one captures
    them."""
    prebuilt_plan = prebuilt_lowered = None
    if _is_aggregate(q) and use_optimizer:
        table, prebuilt_plan, prebuilt_lowered = _try_device_aggregate(db, q, cache_entry)
        if table is not None:
            return unique_table(table) if q.distinct else table
        cache_entry = None  # aggregate fallback: prebuilts already in hand
    if cache_entry is not None:
        if cache_entry["plan"] is not None:
            prebuilt_plan = cache_entry["plan"]
        if cache_entry["lowered"] is not None:
            prebuilt_lowered = cache_entry["lowered"]
    table = eval_where(
        db, q.where, use_optimizer, prebuilt_plan, prebuilt_lowered, capture=cache_entry
    )
    if _is_aggregate(q):
        table = _group_and_aggregate_table(db, table, q)
    elif not q.select_all():
        keep = [i.var for i in q.select if i.kind == "var" and i.var in table]
        engine = ExecutionEngine(db)
        out: BindingTable = {v: table[v] for v in keep}
        for item in q.select:
            if item.kind == "expr":
                out[item.alias] = engine.eval_arith_to_ids(item.expr, table)
        table = out
    elif any(k.startswith("__") for k in table):
        # internal columns (inlined subqueries' scoped variables) are not
        # part of ``*``: drop them BEFORE DISTINCT
        table = {k: v for k, v in table.items() if not k.startswith("__")}
    if q.distinct:
        table = unique_table(table)
    return table


def _try_device_aggregate(
    db, q: SelectQuery, cache_entry=None
) -> Tuple[Optional[BindingTable], Optional[object], Optional[object]]:
    """Aggregate query fused on the device (plan + GROUP BY segment-reduce;
    the host reads one row per group).  Returns ``(table, plan,
    lowered)``: table None → :func:`eval_where` + host aggregation, which
    reuses the returned plan and lowering (``False`` = lowering failed).
    ``cache_entry``: plan-cache slot — a populated slot replays its plan
    and lowered program; a fresh one captures them."""
    if not _device_routed(db):
        return None, None, None
    w = inline_subqueries(q.where)  # the fold eval_where applies
    if w.subqueries or w.binds or w.window_blocks or not w.patterns:
        return None, None, None
    if cache_entry is not None and cache_entry["lowered"] is False:
        # lowering known-failed for this template and state; the sentinel
        # survives parameter rebinds (lowerability is structural)
        return None, cache_entry["plan"], False
    if cache_entry is not None and cache_entry["plan"] is not None:
        cplan, clow = cache_entry["plan"], cache_entry["lowered"]
        if clow is not None:
            if not clause_replayable(clow, w):
                # plain-BGP lowering for a clause-carrying WHERE: replay that
                # route (device BGP + host clauses + host aggregation)
                return None, cplan, clow
            return try_device_execute_aggregated(db, cplan, q, lowered=clow), cplan, clow
    table, plan, lowered = _plan_device_aggregate(db, q, w)
    if cache_entry is not None:
        cache_entry["plan"] = plan
        cache_entry["lowered"] = lowered
    return table, plan, lowered


def _plan_device_aggregate(db, q: SelectQuery, w: WhereClause):
    """Plan and lower an aggregate query's WHERE (the fold ``w``) and run
    the device aggregate: ``(table, plan, lowered)`` as
    :func:`_try_device_aggregate` returns them."""
    resolved = [resolve_pattern(db, p) for p in w.patterns]
    planner = Streamertail(db.get_or_build_stats())
    plan = planner.find_best_plan(build_logical_plan(resolved, list(w.filters), [], w.values))
    # UNION/OPTIONAL/MINUS/NOT fuse under the aggregation as on the plain
    # path; an ineligible branch means host post-passes AND host
    # aggregation over the post-passed table
    clauses = _clause_plans(db, planner, w)
    if clauses is None:
        # eval_where runs the plain device BGP (or the host engine) + host
        # post-passes
        return None, plan, _lower_or_none(db, plan) or False
    union_groups, optional_plans, anti_plans = clauses
    lowered = _lower_or_none(db, plan, anti_plans, union_groups, optional_plans)
    if lowered is None:
        # the plain BGP may still lower even if a branch cannot; else the
        # host engine runs it
        if anti_plans or union_groups or optional_plans:
            return None, plan, _lower_or_none(db, plan) or False
        return None, plan, False
    return try_device_execute_aggregated(db, plan, q, lowered=lowered), plan, lowered


def _group_and_aggregate_table(db, table: BindingTable, q: SelectQuery) -> BindingTable:
    """GROUP BY + aggregates on the host via np.unique segment ids."""
    n = table_len(table)
    group_by = [g for g in q.group_by if g in table]
    if group_by:
        stacked = np.stack([table[g] for g in group_by], axis=1)
        uniq, inverse = np.unique(stacked, axis=0, return_inverse=True)
        inverse = inverse.reshape(-1)
        n_groups = len(uniq)
    else:
        # aggregate without GROUP BY: exactly one group (SPARQL semantics)
        uniq = None
        inverse = np.zeros(n, dtype=np.int64)
        n_groups = 1
    out: BindingTable = {}
    for j, g in enumerate(group_by):
        out[g] = uniq[:, j].astype(np.uint32)
    numeric = db.numeric_values()
    enc = db.dictionary.encode
    for item in q.select:
        if item.kind != "agg":
            continue
        agg = item.agg
        vals_col: Optional[np.ndarray] = None
        if agg.var is not None and agg.var in table:
            vals_col = table[agg.var]
        if agg.func == "COUNT":
            if vals_col is None:
                counts = (
                    np.bincount(inverse, minlength=n_groups)
                    if n
                    else np.zeros(n_groups, dtype=np.int64)
                )
            elif agg.distinct:
                counts = np.zeros(n_groups, dtype=np.int64)
                for g in range(n_groups):
                    seg = vals_col[inverse == g]
                    counts[g] = len(np.unique(seg[seg != UNBOUND]))
            else:
                counts = (
                    np.bincount(
                        inverse,
                        weights=(vals_col != UNBOUND).astype(float),
                        minlength=n_groups,
                    ).astype(np.int64)
                    if n
                    else np.zeros(n_groups, dtype=np.int64)
                )
            out[agg.alias] = _encode_numbers(enc, counts.astype(np.float64))
            continue
        if vals_col is None:
            out[agg.alias] = np.full(n_groups, UNBOUND, dtype=np.uint32)
            continue
        nums = numeric[np.minimum(vals_col, len(numeric) - 1)] if n else np.empty(0)
        if agg.func in ("SUM", "AVG", "MIN", "MAX"):
            res = np.zeros(n_groups, dtype=np.float64)
            for g in range(n_groups):
                seg = nums[inverse == g]
                seg = seg[~np.isnan(seg)]
                if len(seg) == 0:
                    res[g] = np.nan
                elif agg.func == "SUM":
                    res[g] = seg.sum()
                elif agg.func == "AVG":
                    res[g] = seg.mean()
                elif agg.func == "MIN":
                    res[g] = seg.min()
                else:
                    res[g] = seg.max()
            out[agg.alias] = _encode_numbers(enc, res)
        elif agg.func == "SAMPLE":
            res_ids = np.zeros(n_groups, dtype=np.uint32)
            for g in range(n_groups):
                seg = vals_col[inverse == g]
                res_ids[g] = seg[0] if len(seg) else UNBOUND
            out[agg.alias] = res_ids
        elif agg.func == "GROUP_CONCAT":
            dec = db.decode_term
            res_ids = np.zeros(n_groups, dtype=np.uint32)
            for g in range(n_groups):
                seg = vals_col[inverse == g]
                parts = [display_form(dec(int(i))) for i in seg]
                res_ids[g] = enc('"' + ", ".join(x or "" for x in parts) + '"')
            out[agg.alias] = res_ids
        else:
            raise ValueError(f"unsupported aggregate {agg.func}")
    return out


def _encode_numbers(enc, values: np.ndarray) -> np.ndarray:
    out = np.empty(len(values), dtype=np.uint32)
    for i, v in enumerate(values):
        if np.isnan(v):
            out[i] = UNBOUND
        else:
            # non-finite stays float-formatted ("inf"/"-inf"); int(inf) raises
            isint = np.isfinite(v) and float(v) == int(v)
            sv = str(int(v)) if isint else f"{v:g}"
            out[i] = enc(f'"{sv}"')
    return out


def _order_table(db, table: BindingTable, order_by: List[OrderCondition]) -> BindingTable:
    n = table_len(table)
    if n == 0 or not order_by:
        return table
    numeric = db.numeric_values()
    keys = []
    for cond in reversed(order_by):
        if isinstance(cond.expr, Var) and cond.expr.name in table:
            col = table[cond.expr.name]
            nums = numeric[np.minimum(col, len(numeric) - 1)]
            if np.isnan(nums).any():
                # non-numeric: rank the decoded strings so DESC can negate
                dec = db.decode_term
                strs = np.array([dec(int(i)) or "" for i in col])
                _, order_key = np.unique(strs, return_inverse=True)
                order_key = order_key.astype(np.float64)
            else:
                order_key = nums
        else:
            nums = ExecutionEngine(db)._try_numeric(cond.expr, table)
            order_key = nums if nums is not None else np.zeros(n)
        if cond.descending:
            order_key = -order_key
        keys.append(order_key)
    # stable lexsort over keys (last key = primary)
    idx = np.lexsort(tuple(keys))
    return {k: v[idx] for k, v in table.items()}


def table_header(table: BindingTable, q: SelectQuery) -> List[str]:
    """Output column names for a SELECT over a binding table (internal
    ``__``-prefixed columns excluded)."""
    if q.select_all():
        return sorted(k for k in table.keys() if not k.startswith("__"))
    header = []
    for item in q.select:
        if item.kind == "var":
            header.append(item.var)
        elif item.kind == "agg":
            header.append(item.agg.alias)
        else:
            header.append(item.alias)
    return header


_GLOBAL_RANK_MAX = 1 << 19  # dict sizes past this use per-column ranks


def _display_array(db):
    """(dict_len, display): ``display[id]`` is the human-facing form of
    every plain dictionary term (object array; ``display[0] == ""`` for
    UNBOUND), grown incrementally with the dictionary."""
    d = db.dictionary
    n = d._next_id
    cache = db.__dict__.get("_display_cache")
    if cache is not None and cache[0] == n:
        return cache
    forms = d.display_forms()
    if cache is not None and cache[0] < n:
        disp = np.concatenate([cache[1], np.array(forms[cache[0]:], dtype=object)])
    else:
        disp = np.array(forms, dtype=object)
    cache = (n, disp)
    db.__dict__["_display_cache"] = cache
    return cache


def _display_ranks(db, disp, result_rows: int = 1 << 62):
    """``ranks[id]`` = dense rank of ``display[id]`` in lexicographic
    order, or None when a dictionary-wide sort would not amortize (callers
    rank per column instead)."""
    n = len(disp)
    if n > _GLOBAL_RANK_MAX:
        return None
    cached = db.__dict__.get("_display_ranks")
    if (cached is None or cached[0] != n) and result_rows * 8 < n:
        return None
    if cached is not None and cached[0] == n:
        return cached[1]
    if n:
        _, ranks = np.unique(disp, return_inverse=True)
        ranks = ranks.astype(np.uint32)
    else:
        ranks = np.empty(0, dtype=np.uint32)
    db.__dict__["_display_ranks"] = (n, ranks)
    return ranks


def format_results(db, table: BindingTable, q: SelectQuery, sort_rows: bool = False) -> Rows:
    """Final ID→string decode.  ``sort_rows=True`` applies the canonical
    no-ORDER-BY row order (lexicographic by display string); columns
    holding quoted-triple IDs take the per-unique decode path."""
    header = table_header(table, q)
    n = table_len(table)
    if n == 0 or not header:
        return []
    # one span over the decode and the row sort, whichever path decodes
    with span("query.decode", rows=n) as sp:
        id_cols = []
        any_quoted = False
        for h in header:
            col = table.get(h)
            if col is None:
                id_cols.append(None)
                continue
            ids = np.asarray(col)
            if (ids & QUOTED_BIT).any():
                any_quoted = True
            id_cols.append(ids)
        if sp is not None:
            sp.attrs["path"] = "quoted" if any_quoted else "display"
        if any_quoted:
            dec = db.decode_term
            cols = []
            for ids in id_cols:
                if ids is None:
                    cols.append([""] * n)
                    continue
                uniq, inv = np.unique(ids, return_inverse=True)
                decoded = [
                    display_form(dec(int(i))) if i != UNBOUND else "" for i in uniq
                ]
                cols.append([decoded[j] for j in inv.tolist()])
            rows = [list(row) for row in zip(*cols)]
            if sort_rows:
                rows.sort()
            return rows
        dict_len, disp = _display_array(db)
        safe_cols = [
            None if ids is None else np.where(ids < dict_len, ids, 0) for ids in id_cols
        ]
        if sort_rows:
            ranks = _display_ranks(db, disp, result_rows=n)
            keys = []
            for ids in safe_cols:
                if ids is None:
                    keys.append(np.zeros(n, dtype=np.uint32))
                elif ranks is not None:
                    keys.append(ranks[ids])
                else:
                    # dense ranks over just this column's distinct display strings
                    u_ids, inv = np.unique(ids, return_inverse=True)
                    _, u_rank = np.unique(disp[u_ids], return_inverse=True)
                    keys.append(u_rank.astype(np.uint32)[inv])
            idx = np.lexsort(tuple(reversed(keys)))
            safe_cols = [None if c is None else c[idx] for c in safe_cols]
        out = np.empty((n, len(header)), dtype=object)
        for j, ids in enumerate(safe_cols):
            out[:, j] = "" if ids is None else disp[ids]
        return out.tolist()


def execute_select(db, q: SelectQuery, use_optimizer: bool = True, cache_entry=None) -> Rows:
    if (
        use_optimizer
        and q.order_by
        and q.limit is not None
        and not (cache_entry is not None and cache_entry.get("ordered_failed"))
    ):
        # ORDER BY + LIMIT on the device: top-k sort, O(limit) readback.
        # ``ordered_failed`` is the sticky per-template negative
        rows = try_device_execute_ordered(db, q, cache_entry=cache_entry)
        if rows is not None:
            return rows
    table = eval_select_to_table(db, q, use_optimizer, cache_entry=cache_entry)
    table = _order_table(db, table, q.order_by)
    rows = format_results(db, table, q, sort_rows=not q.order_by)
    start = q.offset or 0
    end = start + q.limit if q.limit is not None else None
    return rows[start:end]


# --------------------------------------------------------------------------
# Statements
# --------------------------------------------------------------------------


def process_insert_clause(db, insert: InsertClause) -> int:
    count = 0
    for pat in insert.triples:
        ids = []
        for t in (pat.subject, pat.predicate, pat.object):
            if t.is_var:
                raise ValueError("INSERT DATA cannot contain variables")
            ids.append(_encode_pattern_term(db, t))
        db.add_triple(Triple(*ids))
        count += 1
    return count


def _encode_pattern_term(db, t: PatternTerm) -> int:
    if t.kind == "quoted":
        s, p, o = t.value
        return db.quoted.intern(
            _encode_pattern_term(db, s),
            _encode_pattern_term(db, p),
            _encode_pattern_term(db, o),
        )
    return db.dictionary.encode(db.expand_term(t.value))


def process_delete_clause(db, delete: DeleteClause) -> int:
    """DELETE DATA, or DELETE … WHERE: the WHERE's bindings (through
    :func:`eval_where`, on the device) substituted into the templates, the
    rows removed as one batch.  Returns the count of templates applied."""
    if delete.where is None:
        count = 0
        for pat in delete.triples:
            ids = [_encode_pattern_term(db, t) for t in (pat.subject, pat.predicate, pat.object)]
            db.delete_triple(Triple(*ids))
            count += 1
        return count
    table = eval_where(db, delete.where)
    n = table_len(table)
    for pat in delete.triples:
        cols = []
        for t in (pat.subject, pat.predicate, pat.object):
            if t.is_var:
                col = table.get(t.value)
                if col is None:
                    col = np.full(n, UNBOUND, dtype=np.uint32)
                cols.append(col)
            else:
                cols.append(np.full(n, _encode_pattern_term(db, t), dtype=np.uint32))
        db.store.remove_batch(*cols)
    return n * len(delete.triples)


def collect_all_patterns(where: WhereClause) -> List[A.PatternTriple]:
    """Every triple pattern reachable from a group pattern — including
    OPTIONAL/UNION/MINUS branches, NOT blocks, subqueries, and WINDOW
    blocks (used for neural-relation materialization coverage)."""
    out: List[A.PatternTriple] = list(where.patterns)
    for nb in where.not_blocks:
        out.extend(nb.patterns)
    for wb in where.window_blocks:
        out.extend(wb.patterns)
    for opt in where.optionals:
        out.extend(collect_all_patterns(opt))
    for groups in where.unions:
        for g in groups:
            out.extend(collect_all_patterns(g))
    for m in where.minus:
        out.extend(collect_all_patterns(m))
    for sq in where.subqueries:
        out.extend(collect_all_patterns(sq.query.where))
    return out


def _materialize_neural_for_select(db, select: SelectQuery) -> None:
    if not db.neural_relations:
        return
    from kolibrie_tpu_torch.ml import runtime as ml_runtime

    ml_runtime.materialize_neural_relations_for_patterns(
        db, collect_all_patterns(select.where)
    )


def execute_combined(db, cq: CombinedQuery, cache_entry=None) -> Rows:
    """Run a parsed statement (the reference's ``execute_combined``): the
    MODEL and NEURAL RELATION declarations, TRAIN, ML.PREDICT, then RULE
    definitions, DELETE and INSERT, then the neural predicates the SELECT
    names and the SELECT.  REGISTER and RETRIEVE carry nothing to run here,
    as in the reference.  ``cache_entry``: the plan-cache slot a plain
    SELECT replays."""
    db.prefixes.update(cq.prefixes)
    if cache_entry is not None and (
        cq.register is not None
        or cq.rules
        or cq.insert is not None
        or cq.delete is not None
        or cq.models
        or cq.neural_relations
        or cq.train_decls
        or cq.ml_predict is not None
        or db.neural_relations
    ):
        # updates and declarations mutate the database (or registries the
        # slot's state key does not cover), and neural materialisation
        # inserts triples mid-execution: only plain SELECTs reuse plans
        cache_entry = None
    if cq.models or cq.neural_relations or cq.train_decls or cq.ml_predict:
        from kolibrie_tpu_torch.ml import runtime as ml_runtime

        ml_runtime.register_declarations(db, cq)
        for train in cq.train_decls:
            ml_runtime.execute_train_decl(db, train)
        if cq.ml_predict is not None:
            ml_runtime.execute_ml_predict(db, cq.ml_predict)
    from kolibrie_tpu_torch.reasoner import rule_runtime

    for rule in cq.rules:
        rule_runtime.process_combined_rule(db, rule)
    if cq.delete is not None:
        process_delete_clause(db, cq.delete)
    if cq.insert is not None:
        process_insert_clause(db, cq.insert)
    if cq.select is not None:
        # neural predicates referenced anywhere in the query materialize as
        # ordinary triples first (neural_relations.rs parity)
        _materialize_neural_for_select(db, cq.select)
        return execute_select(db, cq.select, cache_entry=cache_entry)
    return []


# --------------------------------------------------------------------------
# The plan cache
# --------------------------------------------------------------------------

_PLAN_CACHE_MAX = 128  # parsed-AST entries (query text → template key)

_TEMPLATE_CACHE_MAX = 64  # plan templates (fingerprint → per-state slots)

_PLAN_STATES_MAX = 4  # per-template (store version, udfs) slots kept


def _plan_caches(db):
    """The two cache levels + counters, lazily attached to the database."""
    from collections import OrderedDict

    parse = db.__dict__.get("_plan_cache")
    if parse is None:
        parse = db.__dict__["_plan_cache"] = OrderedDict()
    templates = db.__dict__.get("_template_cache")
    if templates is None:
        templates = db.__dict__["_template_cache"] = OrderedDict()
    stats = db.__dict__.get("_plan_cache_stats")
    if stats is None:
        stats = db.__dict__["_plan_cache_stats"] = {
            "hits": 0,
            "misses": 0,
            "param_rebinds": 0,
            "evictions": 0,
            "batched": 0,
            "batch_groups": 0,
        }
    return parse, templates, stats


def _unresolved_params(db, params) -> tuple:
    """The string constants among ``params`` with no dictionary id yet.  A
    plan built while any of these were unknown embeds a can-never-match
    sentinel for them, so it must be rebuilt once the term gets interned —
    mutation batches under the delta threshold do not move
    ``base_version``, so the slot key alone cannot notice."""
    dic = db.dictionary
    return tuple(
        p for p in params if isinstance(p, str) and dic.lookup(db.expand_term(p)) is None
    )


def _plan_cache_entry(db, sparql: str):
    """The database's plan cache.  Three granularities:

    - the parsed AST is keyed by (query text, prefix map): it survives
      store mutations, so INSERT/SELECT workloads never re-parse; parsing
      also yields the constant-free *template* fingerprint and its
      parameter tuple (:func:`kolibrie_tpu_torch.query.template.fingerprint_query`);
    - plan slots are keyed by the TEMPLATE fingerprint, not the text: the
      constant-variants of one query shape share one entry (and one spec
      tree: the lowered program carries its constants in the parameter
      vectors);
    - within a template, the physical plan + lowered program live in
      per-state slots keyed by (store BASE version, UDF registry,
      ``execution_mode``): since
      mutation batches under the delta threshold advance only
      ``delta_epoch``, plans survive insert/delete traffic, and each
      execution's scan ranges and device delta segment carry the fresh
      state.

    A slot replays its plan and lowered program only when its parameter
    binding matches the incoming one; on mismatch the plan is rebuilt
    (host-side) and counted as a ``param_rebind``.  Known-failure
    sentinels (``lowered is False``, ``ordered_failed``) are properties of
    the template and survive rebinds.  Both levels are LRU-bounded.
    Returns ``(entry, slot)``: ``entry`` carries the parsed ``cq``,
    ``slot`` has the ``plan`` / ``lowered`` keys ``eval_select_to_table``
    consumes."""
    from kolibrie_tpu_torch.optimizer.mqo import mqo_mode
    from kolibrie_tpu_torch.optimizer.planner import wcoj_mode
    from kolibrie_tpu_torch.optimizer.stats_advisor import stats_advisor, stats_advisor_mode
    from kolibrie_tpu_torch.query.compile_cache import record_template
    from kolibrie_tpu_torch.query.template import fingerprint_query

    parse, templates, stats = _plan_caches(db)
    prefix_sig = tuple(sorted(db.prefixes.items()))
    # the join-strategy, interpreter-routing, MQO sharing and
    # stats-advisor modes are part of the template fingerprint; a mode
    # flip after parse must refingerprint, not replay the old-mode plan
    env_sig = (wcoj_mode(), _interp_mode(), mqo_mode(), stats_advisor_mode())
    ent = parse.get(sparql)
    if ent is None or ent["prefix_sig"] != prefix_sig or ent["env_sig"] != env_sig:
        ent = {"prefix_sig": prefix_sig, "env_sig": env_sig, "cq": None, "fp": None, "params": ()}
        parse[sparql] = ent
    parse.move_to_end(sparql)
    while len(parse) > _PLAN_CACHE_MAX:
        parse.popitem(last=False)
    if ent["cq"] is None:
        with span("query.parse"):
            t0 = time.perf_counter()
            ent["cq"] = parse_combined_query(sparql, db.prefixes)
            ent["fp"], ent["params"] = fingerprint_query(ent["cq"])
            _PARSE_LAT.observe(time.perf_counter() - t0)
    fp, params = ent["fp"], ent["params"]
    # feed the prewarm manifest: per-template popularity + one
    # representative query text the warmer can replay
    record_template(fp, sparql)
    tent = templates.get(fp)
    if tent is None:
        tent = templates[fp] = {"by_state": {}, "hits": 0, "misses": 0}
    templates.move_to_end(fp)
    while len(templates) > _TEMPLATE_CACHE_MAX:
        templates.popitem(last=False)
        stats["evictions"] += 1
        _PLAN_CACHE_EVICTION.inc()
    version = db.store.base_version
    # the execution mode joins the state key: a degraded call (mode "host"
    # for that call) keeps its own warm host slot beside the device one;
    # so does the mesh signature: attaching/detaching the sharded serving
    # layer (or resizing its mesh) never replays a plan lowered for the
    # other topology
    _sh = db.__dict__.get("_sharded_serving")
    state = (
        version,
        db.__dict__.get("_udf_version", 0),
        db.execution_mode,
        None if _sh is None else _sh.signature,
    )
    slot = tent["by_state"].get(state)
    if slot is not None and slot["lowered"] is False:
        # sticky-failure expiry: a ``False`` sentinel from a TRANSIENT
        # device fault should not outlive the fault.  The template's
        # circuit breaker bumps ``close_epoch`` on every open→closed
        # recovery; when the epoch has advanced past the one captured
        # with the sentinel, the fault demonstrably healed — clear the
        # sentinel so the next execution retries device lowering.
        # Shape-level failures (Unsupported) stay sticky: their host
        # fallback records success on an always-closed breaker, which
        # never bumps the epoch.
        epoch = breaker_board(db).close_epoch(fp)
        if slot.get("breaker_epoch") is None:
            slot["breaker_epoch"] = epoch
        elif slot["breaker_epoch"] != epoch:
            slot["plan"] = None
            slot["lowered"] = None
            slot["ordered_failed"] = False
            slot["breaker_epoch"] = epoch
            stats["sentinel_expiries"] = stats.get("sentinel_expiries", 0) + 1
    if slot is None:
        # stale-base-version slots pin lowered programs over OLD store
        # orders: drop them, keeping only the live base's variants
        for k in [k for k in tent["by_state"] if k[0] != version]:
            tent["by_state"].pop(k)
        slot = {
            "plan": None,
            "lowered": None,
            "params": params,
            "ordered_failed": False,
            "unresolved": _unresolved_params(db, params),
            "quoted_n": len(db.quoted),
        }
        tent["by_state"][state] = slot
        while len(tent["by_state"]) > _PLAN_STATES_MAX:
            tent["by_state"].pop(next(iter(tent["by_state"])))
        stats["misses"] += 1
        tent["misses"] += 1
        _PLAN_CACHE_MISS.inc()
    elif slot["params"] != params:
        # same template, new constants: the cached plan and lowered program
        # embed the OLD binding — drop them and rebind.  The re-lowered
        # program runs the same spec tree.  Known-failure sentinels stay.
        failed = slot["lowered"] is False
        slot["plan"] = None
        slot["lowered"] = False if failed else None
        slot["params"] = params
        slot["unresolved"] = _unresolved_params(db, params)
        slot["quoted_n"] = len(db.quoted)
        stats["param_rebinds"] += 1
        tent["misses"] += 1
        _PLAN_CACHE_REBIND.inc()
    else:
        # same binding — but a constant UNKNOWN when the slot's plan was
        # built may have been interned since (only delta_epoch moved): the
        # embedded can-never-match sentinel is now wrong.  Rebind exactly
        # like a parameter change.
        rebind = False
        unres = slot.get("unresolved", ())
        if unres:
            still = _unresolved_params(db, unres)
            if len(still) != len(unres):
                slot["unresolved"] = still
                rebind = True
        if not rebind and slot.get("quoted_n") != len(db.quoted):
            # unknown quoted-triple ids resolve through db.quoted, not the
            # dictionary; only plans that embed one need a rebuild
            low = slot["lowered"]
            if low is not None and low is not False:
                checks = getattr(low, "const_checks", ()) or ()
                scans = getattr(low, "scan_descs", ()) or ()
                if any(t is None for cc in checks for t in cc) or any(
                    c is not None and c < 0 for _n, cs in scans for c in cs
                ):
                    rebind = True
            slot["quoted_n"] = len(db.quoted)
        if rebind:
            failed = slot["lowered"] is False
            slot["plan"] = None
            slot["lowered"] = False if failed else None
            stats["param_rebinds"] += 1
            tent["misses"] += 1
            _PLAN_CACHE_REBIND.inc()
        else:
            stats["hits"] += 1
            tent["hits"] += 1
            _PLAN_CACHE_HIT.inc()
    # drift-triggered replan: the stats advisor bumps a template's plan
    # generation when observed cardinalities drift past the estimates the
    # cached plan was built from; a stale stamp drops the plan and the
    # lowered program, and the rebuild replans with the tuned stats
    gen = stats_advisor.plan_gen(fp)
    if slot.get("advisor_gen") is None:
        slot["advisor_gen"] = gen
    elif slot["advisor_gen"] != gen:
        slot["plan"] = None
        slot["lowered"] = None
        slot["ordered_failed"] = False
        slot["advisor_gen"] = gen
        stats["advisor_replans"] = stats.get("advisor_replans", 0) + 1
        stats_advisor.note_replan(fp)
    return ent, slot


def plan_cache_info(db) -> dict:
    """Inspection snapshot of the two-level plan cache: occupancy,
    hit/miss/eviction/rebind counters, sticky-failure counts, and a
    per-template breakdown (keyed by fingerprint)."""
    parse, templates, stats = _plan_caches(db)
    per = {}
    sticky = 0
    for fp, tent in templates.items():
        failed = sum(1 for s in tent["by_state"].values() if s["lowered"] is False)
        sticky += failed
        # where the template's most recent device run came from: "mqo",
        # "interp", "compiled" or "disk" — None when nothing lowered ran
        source = None
        for s in tent["by_state"].values():
            low = s.get("lowered")
            if low is not None and low is not False:
                source = getattr(low, "last_source", None) or source
        per[fp] = {
            "states": len(tent["by_state"]),
            "hits": tent["hits"],
            "misses": tent["misses"],
            "failed_states": failed,
            "source": source,
        }
    return {
        "parse_entries": len(parse),
        "templates": len(templates),
        "hits": stats["hits"],
        "misses": stats["misses"],
        "param_rebinds": stats["param_rebinds"],
        "evictions": stats["evictions"],
        "batched": stats["batched"],
        "batch_groups": stats["batch_groups"],
        "sticky_failures": sticky,
        "sentinel_expiries": stats.get("sentinel_expiries", 0),
        "advisor_replans": stats.get("advisor_replans", 0),
        "per_template": per,
        "limits": {
            "parse": _PLAN_CACHE_MAX,
            "templates": _TEMPLATE_CACHE_MAX,
            "states": _PLAN_STATES_MAX,
        },
    }


# --------------------------------------------------------------------------
# Batched dispatch
# --------------------------------------------------------------------------


def _batchable_select(db, cq):
    """``(q, folded_where)`` when the query is a plain SELECT the batched
    dispatch can run — one BGP + filters, projection of variables only,
    all post-processing (DISTINCT, LIMIT/OFFSET, formatting) host-side per
    member.  ``None`` → run it solo."""
    if (
        cq.select is None
        or cq.register is not None
        or cq.rules
        or cq.insert is not None
        or cq.delete is not None
        or cq.models
        or cq.neural_relations
        or cq.train_decls
        or cq.ml_predict is not None
        or cq.retrieve is not None
    ):
        return None
    if db.neural_relations:
        return None
    q = cq.select
    if q.group_by or q.order_by or any(i.kind != "var" for i in q.select):
        return None
    w = inline_subqueries(q.where)
    if (
        w.subqueries
        or w.binds
        or w.window_blocks
        or w.unions
        or w.optionals
        or w.minus
        or w.not_blocks
        or w.values is not None
        or not w.patterns
    ):
        return None
    return q, w


def _finish_select_table(db, q: SelectQuery, table: BindingTable) -> Rows:
    """The host tail of a plain SELECT (projection → DISTINCT → format →
    LIMIT/OFFSET), as eval_select_to_table + execute_select apply it."""
    if not q.select_all():
        keep = [i.var for i in q.select if i.kind == "var" and i.var in table]
        table = {v: table[v] for v in keep}
    elif any(k.startswith("__") for k in table):
        table = {k: v for k, v in table.items() if not k.startswith("__")}
    if q.distinct:
        table = unique_table(table)
    rows = format_results(db, table, q, sort_rows=True)
    start = q.offset or 0
    end = start + q.limit if q.limit is not None else None
    return rows[start:end]


def _lower_bgp(db, w: WhereClause):
    """Plan and lower a batchable member's folded WHERE."""
    resolved = [resolve_pattern(db, p) for p in w.patterns]
    logical = build_logical_plan(resolved, list(w.filters), [], None)
    plan = Streamertail(db.get_or_build_stats()).find_best_plan(logical)
    return plan, lower_plan(db, plan)


def execute_queries_batched(db, queries: List[str]) -> List[Rows]:
    """Execute a batch of queries, dispatching same-template plain SELECTs
    as ONE batched run (``execute_plan_batch``: the members' plan bodies
    back to back, one readback of their counts per attempt) instead of
    one run per query.  Everything else — singleton templates, aggregates,
    ordered queries, updates — runs solo through
    :func:`execute_query_volcano`.  Results come back in input order;
    per-query host post-processing is the solo path's.  A group runs
    behind its template's circuit breaker as the solo path does: a device
    fault counts against it and hands the group to the solo path."""
    check_deadline("executor.batch")
    results: List[Optional[Rows]] = [None] * len(queries)
    for text in queries:
        db.register_prefixes_from_query(text)
    groups: Dict[str, List[int]] = {}
    members: List[Optional[tuple]] = [None] * len(queries)
    board = breaker_board(db)
    sharded = db.__dict__.get("_sharded_serving")
    if _device_routed(db) or sharded is not None:
        for i, text in enumerate(queries):
            ent, slot = _plan_cache_entry(db, text)
            if slot["lowered"] is False:
                continue  # template known un-lowerable: solo (host) path
            eligible = _batchable_select(db, ent["cq"])
            if eligible is None:
                continue
            q, w = eligible
            members[i] = (ent, slot, q, w)
            groups.setdefault(ent["fp"], []).append(i)
    _, _, stats = _plan_caches(db)
    for fp, idxs in groups.items():
        if len(idxs) < 2:
            continue  # solo dispatch is already optimal for singletons
        if not board.allow(fp):
            continue  # breaker open: members fall to the solo degraded path
        if _interp_mode() == "force":
            # forced interpreter routing: members run solo through the
            # interpreter instead of the specialized batch
            continue
        set_baggage("template", fp)
        _sa_set_current_fp(fp)
        if sharded is not None:
            # mesh-first: the whole template group rides one mesh dispatch
            # (parallel/sharded_serving.py); on Unsupported or a device
            # fault the group degrades to the single-device paths below,
            # the breaker counting mesh trips
            from kolibrie_tpu_torch.parallel.sharded_serving import (
                Unsupported as _MeshUnsupported,
            )

            try:
                with span("executor.sharded", template=fp, batch=len(idxs)):
                    got = sharded.execute_batch(fp, [(i, queries[i]) for i in idxs])
            except _MeshUnsupported:
                pass  # the group's shape stays single-device: fall through
            except DeadlineExceeded:
                board.record_failure(fp)
                raise
            except Exception as e:
                if not is_device_fault(e):
                    raise
                board.record_failure(fp)
            else:
                board.record_success(fp)
                stats["batched"] += len(idxs)
                stats["batch_groups"] += 1
                _BATCHED_QUERIES.inc(len(idxs))
                for i in idxs:
                    results[i] = got[i]
                continue
        if not _device_routed(db):
            continue  # the mesh declined and no single-device routing
        lowereds = []
        try:
            for i in idxs:
                ent, slot, q, w = members[i]
                plan, lowered = _lower_bgp(db, w)
                lowereds.append((i, q, plan, lowered))
            tables = execute_plan_batch([low for _, _, _, low in lowereds])
        except Unsupported:
            continue  # shape or plan divergence inside the group: solo path
        except DeadlineExceeded:
            board.record_failure(fp)
            raise
        except Exception as e:
            if not is_device_fault(e):
                raise
            # a device fault: count it, hand the whole group to the solo
            # path (which degrades per the breaker)
            board.record_failure(fp)
            continue
        board.record_success(fp)
        stats["batched"] += len(idxs)
        stats["batch_groups"] += 1
        _BATCHED_QUERIES.inc(len(idxs))
        for (i, q, plan, lowered), table in zip(lowereds, tables):
            ent, slot, _, _ = members[i]
            if slot["params"] == ent["params"] and slot["lowered"] is None:
                slot["plan"], slot["lowered"] = plan, lowered
            results[i] = _finish_select_table(db, q, table)
    # multi-query sharing for the solo tail: register every still-pending
    # member's prefix fingerprint as a transient beneficiary, so the MQO
    # layer sees the batch's full fan-out before the first member runs
    from kolibrie_tpu_torch.optimizer import mqo as _mqo

    transient_fps: List[str] = []
    pending = [i for i in range(len(queries)) if results[i] is None]
    if len(pending) >= 2 and _mqo.mqo_mode() != "off":
        for i in pending:
            fp = _solo_prefix_fp(db, queries[i])
            if fp is not None:
                transient_fps.append(fp)
    with _mqo.transient_scope(db, transient_fps):
        for i, text in enumerate(queries):
            if results[i] is None:
                results[i] = execute_query_volcano(text, db)
    return results


def _solo_prefix_fp(db, text: str) -> Optional[str]:
    """MQO prefix fingerprint for one batch member, or None when the query
    is outside the batchable/shareable shape.  A member whose shape
    declines here is simply not registered as a beneficiary; its own
    evaluation reports any real error in input order."""
    from kolibrie_tpu_torch.optimizer import mqo as _mqo

    ent, _slot = _plan_cache_entry(db, text)
    eligible = _batchable_select(db, ent["cq"])
    if eligible is None:
        return None
    _q, w = eligible

    def _lower():
        try:
            return _lower_bgp(db, w)[1]
        except Unsupported:
            return None

    return _mqo.prefix_fp_for(db, ent["fp"], _lower)


def _execute_degraded(db, sparql: str) -> Rows:
    """Degraded mode: run on the host engine by forcing host execution
    for this call — on the database's device, as every host-routed query
    runs in the port.  The plan-cache state key includes
    ``execution_mode``, so the host plan gets (and keeps) its own warm
    slot — repeat degraded queries don't re-plan.

    The mode flip is a plain attribute swap: callers that share a
    database across threads must serialize database access."""
    check_deadline("executor.degraded")
    prev = db.execution_mode
    db.execution_mode = "host"
    t0 = time.perf_counter()
    try:
        with span("query.degraded"):
            ent, slot = _plan_cache_entry(db, sparql)
            rows = execute_combined(db, ent["cq"], cache_entry=slot)
        _QUERY_LAT_DEGRADED.observe(time.perf_counter() - t0)
        return rows
    finally:
        db.execution_mode = prev


def execute_query_volcano(sparql: str, db) -> Rows:
    """Run one SPARQL statement on ``db``'s device and return the SELECT's
    rows as display strings (the reference's ``execute_query_volcano``),
    through the plan cache (:func:`_plan_cache_entry`).

    Device-routed queries run behind the template's circuit breaker
    (:mod:`kolibrie_tpu_torch.resilience.breaker`): device faults
    (injected compile failures, CUDA out-of-memory) and deadline blowups
    count against the breaker; a device fault degrades THIS call to the
    host engine and, once the breaker trips, the whole template is served
    degraded until a half-open probe succeeds.  ``Unsupported`` is not a
    fault — the sticky lowering sentinel already handles it — and neither
    is a kernel that fails to build or launch: it raises."""
    check_deadline("executor.enter")
    db.register_prefixes_from_query(sparql)
    ent, slot = _plan_cache_entry(db, sparql)
    fp = ent["fp"]
    # baggage lets device_engine label its timings and key the capacity
    # advisor with the template fingerprint without threading it through
    # eval_where; the stats advisor has its own channel
    set_baggage("template", fp)
    _sa_set_current_fp(fp)
    if not _device_routed(db):
        t0 = time.perf_counter()
        with span("query.execute", template=fp, path="host"):
            rows = execute_combined(db, ent["cq"], cache_entry=slot)
        _QUERY_LAT_HOST.observe(time.perf_counter() - t0)
        return rows
    board = breaker_board(db)
    if not board.allow(fp):
        return _execute_degraded(db, sparql)
    t0 = time.perf_counter()
    try:
        with span("query.execute", template=fp, path="device"):
            rows = execute_combined(db, ent["cq"], cache_entry=slot)
    except DeadlineExceeded:
        # still shed (the client's budget is gone either way), but a
        # template that repeatedly blows deadlines on the device trips its
        # breaker and future calls go straight to the host engine
        board.record_failure(fp)
        raise
    except Exception as e:
        if not is_device_fault(e):
            raise
        board.record_failure(fp)
        return _execute_degraded(db, sparql)
    board.record_success(fp)
    _QUERY_LAT_DEVICE.observe(time.perf_counter() - t0)
    return rows


def execute_query(sparql: str, db) -> Rows:
    """The legacy sequential path: the same semantics with the patterns
    joined in textual order and no cost-based planning (the reference's
    ``execute_query``)."""
    db.register_prefixes_from_query(sparql)
    cq = parse_combined_query(sparql, db.prefixes)
    if cq.select is None:
        return execute_combined(db, cq)
    # same pre-pass as the volcano path, so both agree on neural queries
    _materialize_neural_for_select(db, cq.select)
    return execute_select(db, cq.select, use_optimizer=False)
