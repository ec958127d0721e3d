"""Query entry point of the PyTorch port: parse → plan → device engine → host
post-passes → format.

Port of the SELECT path of ``kolibrie_tpu/query/executor.py``
(``execute_query_volcano``): the group pattern's basic graph pattern and
its FILTERs run on the device engine
(:mod:`kolibrie_tpu_torch.optimizer.device_engine`), then BIND, FILTERs
over BIND outputs, projection and SELECT expressions, DISTINCT, ORDER BY,
formatting and LIMIT/OFFSET run on the host over the read-back table,
exactly as the reference applies them.

A construct this slice does not lower raises :class:`Unsupported` with its
name: updates and declarations, aggregates and GROUP BY, subqueries,
UNION, OPTIONAL, MINUS, NOT blocks, windows, VALUES.  Nothing falls back to
a host engine.
"""

from __future__ import annotations

from typing import List

import numpy as np

from kolibrie_tpu_torch.core.dictionary import QUOTED_BIT, display_form
from kolibrie_tpu_torch.ops.join import UNBOUND, BindingTable, table_len
from kolibrie_tpu_torch.ops.unique import unique_table
from kolibrie_tpu_torch.optimizer.device_engine import Unsupported, try_device_execute
from kolibrie_tpu_torch.optimizer.engine import ExecutionEngine, resolve_pattern
from kolibrie_tpu_torch.optimizer.planner import Streamertail, build_logical_plan
from kolibrie_tpu_torch.query import ast as A
from kolibrie_tpu_torch.query.ast import OrderCondition, SelectQuery, Var, WhereClause
from kolibrie_tpu_torch.query.parser import parse_combined_query

__all__ = ["Unsupported", "execute_query_volcano", "eval_where", "format_results"]

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
    for name, present in (
        ("subquery", where.subqueries),
        ("UNION", where.unions),
        ("OPTIONAL", where.optionals),
        ("MINUS", where.minus),
        ("NOT block", where.not_blocks),
        ("WINDOW block", where.window_blocks),
        ("VALUES", where.values is not None),
    ):
        if present:
            raise Unsupported(name)
    if not where.patterns:
        raise Unsupported("group pattern without triple patterns")


def eval_where(db, where: WhereClause) -> BindingTable:
    """Evaluate a group graph pattern to a binding table (IDs): the BGP and
    the FILTERs that need no BIND output on the device, then BINDs and the
    remaining FILTERs on the host."""
    _check_where(where)
    resolved = [resolve_pattern(db, p) for p in where.patterns]
    # filters referencing BIND outputs can only run after the binds
    bind_vars = {b.var for b in where.binds}
    plan_filters = [f for f in where.filters if not (set(_filter_vars(f)) & bind_vars)]
    post_bind_filters = [f for f in where.filters if set(_filter_vars(f)) & bind_vars]
    planner = Streamertail(db.get_or_build_stats())
    plan = planner.find_best_plan(build_logical_plan(resolved, plan_filters, [], None))
    table = try_device_execute(db, plan)
    engine = ExecutionEngine(db)
    for b in where.binds:
        table = dict(table)
        table[b.var] = engine.eval_arith_to_ids(b.expr, table)
    for f in post_bind_filters:
        mask = engine.eval_filter(f, table)
        table = {k: v[mask] for k, v in table.items()}
    return table


def eval_select_to_table(db, q: SelectQuery) -> BindingTable:
    """Run a SELECT down to a binding table projected to its variables."""
    if q.group_by or any(i.kind == "agg" for i in q.select):
        raise Unsupported("aggregate")
    table = eval_where(db, q.where)
    if not q.select_all():
        keep = [i.var for i in q.select if i.kind == "var" and i.var in table]
        engine = ExecutionEngine(db)
        out: BindingTable = {v: table[v] for v in keep}
        for item in q.select:
            if item.kind == "expr":
                out[item.alias] = engine.eval_arith_to_ids(item.expr, table)
        table = out
    if q.distinct:
        table = unique_table(table)
    return table


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
    """Output column names for a SELECT over a binding table."""
    if q.select_all():
        return sorted(k for k in table.keys() if not k.startswith("__"))
    header = []
    for item in q.select:
        if item.kind == "var":
            header.append(item.var)
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


def execute_select(db, q: SelectQuery) -> Rows:
    table = eval_select_to_table(db, q)
    table = _order_table(db, table, q.order_by)
    rows = format_results(db, table, q, sort_rows=not q.order_by)
    start = q.offset or 0
    end = start + q.limit if q.limit is not None else None
    return rows[start:end]


def execute_query_volcano(sparql: str, db) -> Rows:
    """Run one SPARQL SELECT on ``db``'s device and return its rows as
    display strings (the reference's ``execute_query_volcano``)."""
    db.register_prefixes_from_query(sparql)
    cq = parse_combined_query(sparql, db.prefixes)
    for name, present in (
        ("INSERT", cq.insert is not None),
        ("DELETE", cq.delete is not None),
        ("REGISTER", cq.register is not None),
        ("RULE", cq.rules),
        ("MODEL", cq.models),
        ("NEURAL RELATION", cq.neural_relations),
        ("TRAIN", cq.train_decls),
        ("ML.PREDICT", cq.ml_predict is not None),
        ("RETRIEVE", cq.retrieve is not None),
    ):
        if present:
            raise Unsupported(name)
    db.prefixes.update(cq.prefixes)
    if cq.select is None:
        return []
    return execute_select(db, cq.select)

