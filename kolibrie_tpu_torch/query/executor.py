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
"""

from __future__ import annotations

from typing import List, Optional, Tuple

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
from kolibrie_tpu_torch.optimizer.device_engine import (
    Unsupported,
    lower_plan,
    try_device_execute_aggregated,
    try_device_execute_ordered,
)
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

__all__ = [
    "Unsupported",
    "execute_query_volcano",
    "execute_query",
    "execute_combined",
    "eval_where",
    "format_results",
]

Rows = List[List[str]]


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
    db, where: WhereClause, use_optimizer: bool = True, prebuilt_plan=None, prebuilt_lowered=None
) -> BindingTable:
    """Evaluate a group graph pattern to a binding table (IDs).

    ``use_optimizer=False`` joins the patterns in textual order
    (:func:`_naive_eval`).  ``prebuilt_plan`` / ``prebuilt_lowered``: the
    physical plan and the device lowering the aggregate route already made
    for this WHERE (the lowering ``False`` when it declined), so neither
    runs twice."""
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
            plan = planner.find_best_plan(
                build_logical_plan(resolved, plan_filters, [], where.values)
            )
        table = None
        if prebuilt_lowered is not None and prebuilt_lowered is not False:
            table = prebuilt_lowered.execute()
            fused_clauses = prebuilt_lowered.fused_clauses
        elif prebuilt_lowered is None:
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
                        lowered = _lower_or_none(
                            db, main_plan, anti_plans, union_groups, optional_plans
                        )
                        if lowered is not None:
                            table = lowered.execute()
                            fused_clauses = True
            if table is None:
                lowered = _lower_or_none(db, plan)
                if lowered is not None:
                    table = lowered.execute()
        if table is None:
            # the lowering declined this plan: the reference's host engine,
            # run on the database's device
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


def eval_select_to_table(db, q: SelectQuery, use_optimizer: bool = True) -> BindingTable:
    """Run a SELECT down to a binding table projected to its variables
    (aggregates resolved)."""
    prebuilt_plan = prebuilt_lowered = None
    if _is_aggregate(q) and use_optimizer:
        table, prebuilt_plan, prebuilt_lowered = _try_device_aggregate(db, q)
        if table is not None:
            return unique_table(table) if q.distinct else table
    table = eval_where(db, q.where, use_optimizer, prebuilt_plan, prebuilt_lowered)
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
    db, q: SelectQuery
) -> Tuple[Optional[BindingTable], Optional[object], Optional[object]]:
    """Aggregate query fused on the device (plan + GROUP BY segment-reduce;
    the host reads one row per group).  Returns ``(table, plan,
    lowered)``: table None → :func:`eval_where` + host aggregation, which
    reuses the returned plan and lowering (``False`` = lowering failed)."""
    w = inline_subqueries(q.where)  # the fold eval_where applies
    if w.subqueries or w.binds or w.window_blocks or not w.patterns:
        return None, None, None
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


def execute_select(db, q: SelectQuery, use_optimizer: bool = True) -> Rows:
    if use_optimizer and q.order_by and q.limit is not None:
        # ORDER BY + LIMIT on the device: top-k sort, O(limit) readback
        rows = try_device_execute_ordered(db, q)
        if rows is not None:
            return rows
    table = eval_select_to_table(db, q, use_optimizer)
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


def execute_combined(db, cq: CombinedQuery) -> Rows:
    """Run a parsed statement (the reference's ``execute_combined``): the
    MODEL and NEURAL RELATION declarations, TRAIN, ML.PREDICT, then RULE
    definitions, DELETE and INSERT, then the neural predicates the SELECT
    names and the SELECT.  REGISTER and RETRIEVE carry nothing to run here,
    as in the reference."""
    db.prefixes.update(cq.prefixes)
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
        return execute_select(db, cq.select)
    return []


def execute_query_volcano(sparql: str, db) -> Rows:
    """Run one SPARQL statement on ``db``'s device and return the SELECT's
    rows as display strings (the reference's ``execute_query_volcano``)."""
    db.register_prefixes_from_query(sparql)
    return execute_combined(db, parse_combined_query(sparql, db.prefixes))


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
