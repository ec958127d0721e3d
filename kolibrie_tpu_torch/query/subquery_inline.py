"""Inline eligible sub-SELECTs into the enclosing group graph pattern.

A sub-SELECT with no aggregation, no solution modifiers (DISTINCT / ORDER
BY / LIMIT / OFFSET), and a plain patterns+filters body is bag-equivalent
to joining its WHERE patterns directly into the outer group, provided the
variables NOT carried by its projection are first renamed to fresh names
(SPARQL scopes them to the subquery, so an outer variable with the same
name must not unify with them).  Rewriting before planning lets the
Streamertail optimizer order joins globally and lets the device engine run
outer patterns and subquery patterns as ONE plan.  Non-inlinable
subqueries are evaluated as a separate plan and equi-joined with the outer
table on the host.

Copy of ``kolibrie_tpu/query/subquery_inline.py``.  Parity: the
original Rust engine materializes every nested select and hash-joins it
into the outer solution (``kolibrie/src/sparql_database.rs`` nested-select
handling); its criterion "COMPLEX QUERY" benchmark
(``kolibrie/benches/my_benchmark.rs:55-113``) is exactly an inlinable
shape.  Multiplicity is preserved: projection without DISTINCT keeps one
row per inner solution, so the join of the projected table equals the
projection of the inlined join.
"""

from __future__ import annotations

from typing import Dict, List, Set

from kolibrie_tpu_torch.query.ast import (
    ArithOp,
    Comparison,
    FuncExpr,
    FunctionCall,
    LogicalAnd,
    LogicalNot,
    LogicalOr,
    PatternTerm,
    PatternTriple,
    QuotedPattern,
    SelectQuery,
    SubQuery,
    Var,
    WhereClause,
)

__all__ = ["inline_subqueries"]


# ----------------------------------------------------------------- renaming


def _rename_term(t: PatternTerm, ren: Dict[str, str]) -> PatternTerm:
    if t.kind == "var":
        new = ren.get(t.value)  # type: ignore[arg-type]
        return PatternTerm("var", new) if new is not None else t
    if t.kind == "quoted":
        s, p, o = t.value  # type: ignore[misc]
        return PatternTerm(
            "quoted",
            (_rename_term(s, ren), _rename_term(p, ren), _rename_term(o, ren)),
        )
    return t


def _rename_pattern(p: PatternTriple, ren: Dict[str, str]) -> PatternTriple:
    return PatternTriple(
        _rename_term(p.subject, ren),
        _rename_term(p.predicate, ren),
        _rename_term(p.object, ren),
    )


def _rename_arith(e, ren: Dict[str, str]):
    if isinstance(e, Var):
        new = ren.get(e.name)
        return Var(new) if new is not None else e
    if isinstance(e, ArithOp):
        return ArithOp(_rename_arith(e.left, ren), e.op, _rename_arith(e.right, ren))
    if isinstance(e, FuncExpr):
        return FuncExpr(e.name, [_rename_arith(a, ren) for a in e.args])
    if isinstance(e, QuotedPattern):
        return QuotedPattern(
            _rename_arith(e.subject, ren),
            _rename_arith(e.predicate, ren),
            _rename_arith(e.object, ren),
        )
    return e  # literals / IRIs


def _rename_filter(e, ren: Dict[str, str]):
    if isinstance(e, Comparison):
        return Comparison(_rename_arith(e.left, ren), e.op, _rename_arith(e.right, ren))
    if isinstance(e, LogicalAnd):
        return LogicalAnd(_rename_filter(e.left, ren), _rename_filter(e.right, ren))
    if isinstance(e, LogicalOr):
        return LogicalOr(_rename_filter(e.left, ren), _rename_filter(e.right, ren))
    if isinstance(e, LogicalNot):
        return LogicalNot(_rename_filter(e.inner, ren))
    if isinstance(e, FunctionCall):
        return FunctionCall(e.name, [_rename_arith(a, ren) for a in e.args])
    return e


# ------------------------------------------------------------- var harvest


def _arith_vars(e, out: Set[str]) -> None:
    if isinstance(e, Var):
        out.add(e.name)
    elif isinstance(e, (ArithOp, Comparison)):
        _arith_vars(e.left, out)
        _arith_vars(e.right, out)
    elif isinstance(e, (FuncExpr, FunctionCall)):
        for a in e.args:
            _arith_vars(a, out)
    elif isinstance(e, QuotedPattern):
        _arith_vars(e.subject, out)
        _arith_vars(e.predicate, out)
        _arith_vars(e.object, out)
    elif isinstance(e, (LogicalAnd, LogicalOr)):
        _arith_vars(e.left, out)
        _arith_vars(e.right, out)
    elif isinstance(e, LogicalNot):
        _arith_vars(e.inner, out)


def _where_vars(w: WhereClause, out: Set[str]) -> None:
    """Every variable name textually visible anywhere under ``w`` (used to
    keep generated names fresh; over-collecting is safe)."""
    for p in w.patterns:
        out.update(p.variables())
    for f in w.filters:
        _arith_vars(f, out)
    for b in w.binds:
        out.add(b.var)
        _arith_vars(b.expr, out)
    if w.values is not None:
        out.update(w.values.variables)
    for sq in w.subqueries:
        for item in sq.query.select:
            if item.var:
                out.add(item.var)
            if item.alias:
                out.add(item.alias)
        _where_vars(sq.query.where, out)
    for nb in w.not_blocks:
        for p in nb.patterns:
            out.update(p.variables())
    for wb in w.window_blocks:
        for p in wb.patterns:
            out.update(p.variables())
        for f in wb.filters:
            _arith_vars(f, out)
    for opt in w.optionals:
        _where_vars(opt, out)
    for groups in w.unions:
        for g in groups:
            _where_vars(g, out)
    for m in w.minus:
        _where_vars(m, out)


# ------------------------------------------------------------- eligibility


def _inlinable(q: SelectQuery) -> bool:
    if q.distinct or q.group_by or q.order_by:
        return False
    if q.limit is not None or q.offset is not None:
        return False
    if not q.select_all() and any(i.kind != "var" for i in q.select):
        return False  # aggregates / expression projections
    w = q.where
    if not w.patterns:
        return False
    return not (
        w.binds
        or w.values is not None
        or w.subqueries
        or w.not_blocks
        or w.window_blocks
        or w.optionals
        or w.unions
        or w.minus
    )


# ----------------------------------------------------------------- rewrite


def inline_subqueries(where: WhereClause) -> WhereClause:
    """Return ``where`` with every eligible sub-SELECT folded into the
    outer patterns+filters (fresh names for subquery-scoped variables);
    non-inlinable subqueries stay in ``.subqueries`` for the
    materialize-then-join path.  Input is never mutated; returns the input
    object unchanged when there is nothing to do."""
    if not where.subqueries:
        return where

    used: Set[str] = set()
    _where_vars(where, used)

    patterns: List[PatternTriple] = list(where.patterns)
    filters = list(where.filters)
    remaining: List[SubQuery] = []
    changed = False

    for sq in where.subqueries:
        q = sq.query
        # fold the subquery's own nested subqueries first (depth-first), so
        # a nest of plain selects flattens completely
        inner_where = inline_subqueries(q.where)
        if inner_where is not q.where:
            q = SelectQuery(
                select=q.select,
                where=inner_where,
                distinct=q.distinct,
                group_by=q.group_by,
                order_by=q.order_by,
                limit=q.limit,
                offset=q.offset,
                prefixes=q.prefixes,
            )
        if not _inlinable(q):
            remaining.append(SubQuery(q) if q is not sq.query else sq)
            continue

        inner_vars: Set[str] = set()
        for p in q.where.patterns:
            inner_vars.update(p.variables())
        for f in q.where.filters:
            _arith_vars(f, inner_vars)
        if q.select_all():
            projected = set(inner_vars)
        else:
            projected = {i.var for i in q.select if i.var}
        ren: Dict[str, str] = {}
        for name in sorted(inner_vars - projected):
            n = 0
            fresh = f"__sq{n}_{name}"
            while fresh in used:
                n += 1
                fresh = f"__sq{n}_{name}"
            used.add(fresh)
            ren[name] = fresh
        patterns.extend(_rename_pattern(p, ren) for p in q.where.patterns)
        filters.extend(_rename_filter(f, ren) for f in q.where.filters)
        changed = True

    if not changed:
        return where
    return WhereClause(
        patterns=patterns,
        filters=filters,
        binds=where.binds,
        values=where.values,
        subqueries=remaining,
        not_blocks=where.not_blocks,
        window_blocks=where.window_blocks,
        optionals=where.optionals,
        unions=where.unions,
        minus=where.minus,
    )
