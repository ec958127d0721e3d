"""The host engine behind the device lowering, host expression evaluation
over binding tables, and pattern resolution.

Port of ``kolibrie_tpu/optimizer/engine.py``: :func:`resolve_pattern`
(term strings to dictionary IDs before planning), :func:`strip_literal`,
and :class:`ExecutionEngine`, which

- interprets the physical plans the device lowering declines (cartesian
  joins, filter functions it has no mask for, constant-only groups, the
  empty group of a clause-only WHERE) with every operator case of the
  reference's ``execute_with_ids``.  It runs on the database's device over
  device binding tables: scans read the store's two-tier device mirror,
  equi-joins launch the merge-path kernel, cartesian products expand on
  the device, and FILTERs compare IDs and numbers there; only an
  expression that needs strings reads back the columns it names, runs
  the host evaluation below and sends the mask back.  The table is read
  back once, at the end;
- evaluates expressions over host tables: FILTERs that read BIND
  outputs, BIND and SELECT expressions, and ORDER BY keys.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from kolibrie_tpu_torch.backend import SENT
from kolibrie_tpu_torch.core.dictionary import QUOTED_BIT
from kolibrie_tpu_torch.ops.join import (
    UNBOUND,
    BindingTable,
    DeviceTable,
    device_table_len,
    equi_join_device,
    table_len,
    table_to_device,
    table_to_host,
    take_rows,
)
from kolibrie_tpu_torch.optimizer import plan as P
from kolibrie_tpu_torch.query.ast import (
    ArithOp,
    Comparison,
    FuncExpr,
    FunctionCall,
    IriRef,
    LogicalAnd,
    LogicalNot,
    LogicalOr,
    NumberLit,
    PatternTerm,
    PatternTriple,
    QuotedPattern,
    StringLit,
    Var,
)

def resolve_pattern(db, pattern: PatternTriple) -> PatternTriple:
    """Resolve term strings to dictionary IDs (kind 'term' -> kind 'id').

    Unknown constants resolve to id None — a scan that can never match.
    Quoted patterns with all-constant parts resolve to their quoted-triple ID;
    with variables they stay structural for the scan resolver.
    """

    def rt(t: PatternTerm) -> PatternTerm:
        if t.kind == "var":
            return t
        if t.kind == "id":
            return t
        if t.kind == "quoted":
            s, p, o = (rt(x) for x in t.value)  # type: ignore[misc]
            if all(x.kind == "id" for x in (s, p, o)):
                if any(x.value is None for x in (s, p, o)):
                    return PatternTerm("id", None)
                qid = db.quoted.lookup(s.value, p.value, o.value)
                return PatternTerm("id", qid)
            return PatternTerm("quoted", (s, p, o))
        expanded = db.expand_term(t.value)  # type: ignore[arg-type]
        return PatternTerm("id", db.dictionary.lookup(expanded))

    return PatternTriple(rt(pattern.subject), rt(pattern.predicate), rt(pattern.object))


def strip_literal(s: Optional[str]) -> Optional[str]:
    """Lexical form of a quoted literal (escaped-quote aware), raw term
    otherwise — THE string-function stripping rule, shared by the host
    engine and the device string-predicate masks."""
    if s is None:
        return None
    if s.startswith('"'):
        end = s.find('"', 1)
        while end != -1 and s[end - 1] == "\\":
            end = s.find('"', end + 1)
        if end > 0:
            return s[1:end]
    return s


def expr_vars(expr) -> List[str]:
    """The variables an expression reads, in order of appearance (quoted
    patterns and function arguments included)."""
    out: List[str] = []

    def walk(e):
        if isinstance(e, Var):
            out.append(e.name)
        elif dataclasses.is_dataclass(e) and not isinstance(e, type):
            for f in dataclasses.fields(e):
                walk(getattr(e, f.name))
        elif isinstance(e, (list, tuple)):
            for x in e:
                walk(x)

    walk(expr)
    return out


# an operand the device evaluation leaves to the host (it needs strings)
_HOST = object()

_CMP = {
    "=": torch.eq,
    "!=": torch.ne,
    "<": torch.lt,
    "<=": torch.le,
    ">": torch.gt,
    ">=": torch.ge,
}


class ExecutionEngine:
    """Plan interpretation on the database's device for the plans the device
    lowering declines, and vectorized expression evaluation over host
    binding tables.  ``subquery_eval``: the executor's callback SubQuery ->
    host binding table."""

    def __init__(self, db, subquery_eval: Optional[Callable] = None):
        self.db = db
        self.subquery_eval = subquery_eval
        self.device = db.device

    # ------------------------------------------------------------- dispatch

    def execute_with_ids(self, op) -> BindingTable:
        """Run the physical plan ``op`` on the device; the table is read
        back once, at the end."""
        return table_to_host(self._execute(op))

    def _execute(self, op) -> DeviceTable:
        if isinstance(op, (P.PhysIndexScan, P.PhysTableScan)):
            return self._scan(op.pattern)
        if isinstance(
            op,
            (P.PhysHashJoin, P.PhysMergeJoin, P.PhysParallelJoin, P.PhysNestedLoopJoin),
        ):
            return equi_join_device(self._execute(op.left), self._execute(op.right))
        if isinstance(op, (P.PhysStarJoin, P.WcojNode)):
            # a WCOJ node runs as binary joins: the same bindings (set
            # semantics); the worst-case-optimal evaluation is the device
            # lowering's
            out: Optional[DeviceTable] = None
            for scan in op.scans:
                t = self._execute(scan)
                out = t if out is None else equi_join_device(out, t)
            return out if out is not None else {}
        if isinstance(op, P.PhysFilter):
            return self.filter_device(op.expr, self._execute(op.child))
        if isinstance(op, P.PhysBind):
            table = self._execute(op.child)
            host = self._host_columns(table, expr_vars(op.bind.expr))
            col = self.eval_arith_to_ids(op.bind.expr, host)
            out = dict(table)
            out[op.bind.var] = torch.from_numpy(col.astype(np.int64)).to(self.device)
            return out
        if isinstance(op, P.PhysValues):
            return self._values_table(op.values)
        if isinstance(op, P.PhysSubquery):
            if self.subquery_eval is None:
                raise RuntimeError("subquery evaluation requires executor context")
            return table_to_device(self.subquery_eval(op.subquery), self.device)
        if isinstance(op, P.PhysProjection):
            table = self._execute(op.child)
            return {v: table[v] for v in op.variables if v in table}
        raise TypeError(f"unknown physical operator {op!r}")

    # ----------------------------------------------------------------- scans

    def _scan(self, pattern: PatternTriple) -> DeviceTable:
        """Triple-pattern scan over the store's device mirror, in the
        reference's ``store.match`` row order; handles repeated variables
        and quoted-pattern positions."""
        from kolibrie_tpu_torch.optimizer.device_engine import scan_rows

        terms = [pattern.subject, pattern.predicate, pattern.object]
        for t in terms:
            if t.kind == "id" and t.value is None:
                return self._empty_for(pattern)
        cols = scan_rows(self.db, [int(t.value) if t.kind == "id" else None for t in terms])
        out: DeviceTable = {}
        mask: Optional[torch.Tensor] = None
        for t, col in zip(terms, cols):
            if t.kind == "var":
                if t.value in out:  # repeated variable: rows must agree
                    m = out[t.value] == col
                    mask = m if mask is None else (mask & m)
                else:
                    out[t.value] = col
        quoted = [pos for pos, t in enumerate(terms) if t.kind == "quoted"]
        # quoted positions ride along as internal columns, so each stays
        # aligned with the rows the earlier quoted joins keep
        for pos in quoted:
            out[f"__qpos{pos}"] = cols[pos]
        if mask is not None:
            out = take_rows(out, mask)
        if not out:
            # fully-constant pattern: presence row so the match count survives
            n = min(int(cols[0].shape[0]), 1)
            out["__exists"] = torch.zeros(n, dtype=torch.int64, device=self.device)
        for pos in quoted:
            out = self._join_quoted(out, out.pop(f"__qpos{pos}"), terms[pos])
            if device_table_len(out) == 0:
                return {k: v for k, v in out.items() if not k.startswith("__qpos")}
        return out

    def _quoted_table(self):
        """The quoted-triple store as device columns ``(qid, s, p, o)``,
        sentinel padding rows removed."""
        from kolibrie_tpu_torch.optimizer.device_engine import device_quoted

        n = len(self.db.quoted)  # the qid-sorted rows come before the pads
        return dict(zip(("qid", "s", "p", "o"), (c[:n] for c in device_quoted(self.db))))

    def _join_quoted(
        self, table: DeviceTable, pos_col: torch.Tensor, qterm: PatternTerm
    ) -> DeviceTable:
        """Join scan rows whose position holds a quoted-triple ID against
        the quoted store, binding the inner variables."""
        qt = self._quoted_table()
        inner_s, inner_p, inner_o = qterm.value  # type: ignore[misc]
        keep = (pos_col & QUOTED_BIT) != 0
        sub = take_rows({**table, "__qid": pos_col}, keep)
        qtab: DeviceTable = {"__qid": qt["qid"]}
        m = torch.ones(qt["qid"].shape[0], dtype=torch.bool, device=self.device)
        for part, col in (("s", inner_s), ("p", inner_p), ("o", inner_o)):
            if col.kind == "id":
                # an unknown inner constant (None) never matches
                m &= qt[part] == (SENT if col.value is None else int(col.value))
        inner_seen = {}
        for part, col in (("s", inner_s), ("p", inner_p), ("o", inner_o)):
            if col.kind == "var":
                if col.value in inner_seen:
                    # repeated inner variable (<< ?x p ?x >>): rows must agree
                    m &= qt[part] == qt[inner_seen[col.value]]
                else:
                    inner_seen[col.value] = part
                    qtab[col.value] = qt[part]
            elif col.kind == "quoted":
                raise NotImplementedError("doubly-nested quoted variable patterns in scans")
        joined = equi_join_device(sub, take_rows(qtab, m))
        joined.pop("__qid", None)
        return joined

    def _empty_for(self, pattern: PatternTriple) -> DeviceTable:
        return {
            v: torch.empty(0, dtype=torch.int64, device=self.device)
            for v in pattern.variables()
        }

    def _values_table(self, values) -> DeviceTable:
        rows = values.rows
        out: BindingTable = {}
        n = len(rows)
        for j, var in enumerate(values.variables):
            col = np.empty(n, dtype=np.uint32)
            for i, row in enumerate(rows):
                term = row[j] if j < len(row) else None
                if term is None:
                    col[i] = UNBOUND
                else:
                    col[i] = self.db.dictionary.encode(self.db.expand_term(term))
            out[var] = col
        return table_to_device(out, self.device)

    # ------------------------------------------------------ device filters

    def filter_device(self, expr, table: DeviceTable) -> DeviceTable:
        """The rows of a device table that pass ``expr``, with the host
        evaluation's semantics."""
        return take_rows(table, self._device_mask(expr, table))

    def _device_mask(self, expr, table: DeviceTable) -> torch.Tensor:
        if isinstance(expr, LogicalAnd):
            return self._device_mask(expr.left, table) & self._device_mask(expr.right, table)
        if isinstance(expr, LogicalOr):
            return self._device_mask(expr.left, table) | self._device_mask(expr.right, table)
        if isinstance(expr, LogicalNot):
            return ~self._device_mask(expr.inner, table)
        if isinstance(expr, Comparison):
            mask = self._device_comparison(expr, table)
        elif isinstance(expr, (FunctionCall, FuncExpr)):
            mask = self._device_bool_function(expr, table)
        else:
            raise TypeError(f"unknown filter expression {expr!r}")
        if mask is None:
            mask = self._host_mask(expr, table)
        return mask

    def _host_mask(self, expr, table: DeviceTable) -> torch.Tensor:
        """Evaluate one filter expression on the host over the columns it
        names (read back), and send the mask to the device."""
        host = self._host_columns(table, expr_vars(expr))
        mask = np.asarray(self.eval_filter(expr, host), dtype=bool)
        return torch.from_numpy(mask).to(self.device)

    def _host_columns(self, table: DeviceTable, names) -> BindingTable:
        """Host copy of the named columns of ``table``, holding its row
        count even when it names none."""
        host = table_to_host({v: table[v] for v in dict.fromkeys(names) if v in table})
        n = device_table_len(table)
        if not host and n:
            host = {"__rows": np.zeros(n, dtype=np.uint32)}
        return host

    def _full(self, n: int, value, dtype) -> torch.Tensor:
        return torch.full((n,), value, dtype=dtype, device=self.device)

    def _device_numeric(self, expr, table: DeviceTable):
        """:meth:`_try_numeric` on the device: an f64 column, None where
        the host returns None, or ``_HOST``."""
        n = device_table_len(table)
        if isinstance(expr, NumberLit):
            return self._full(n, float(expr.value), torch.float64)
        if isinstance(expr, Var):
            col = table.get(expr.name)
            if col is None:
                return None
            from kolibrie_tpu_torch.optimizer.device_engine import device_numf

            top = len(self.db.numeric_values()) - 1
            return device_numf(self.db)[col.clamp(max=top)]
        if isinstance(expr, ArithOp):
            left = self._device_numeric(expr.left, table)
            right = self._device_numeric(expr.right, table)
            if left is _HOST or right is _HOST:
                return _HOST
            if left is None or right is None:
                return None
            if expr.op == "+":
                return left + right
            if expr.op == "-":
                return left - right
            if expr.op == "*":
                return left * right
            return left / right
        if isinstance(expr, StringLit):
            try:
                v = float(expr.value.strip('"').split('"')[0])
            except ValueError:
                return None
            return self._full(n, v, torch.float64)
        if isinstance(expr, FuncExpr):
            if expr.name == "ABS":
                inner = self._device_numeric(expr.args[0], table)
                return inner if inner is None or inner is _HOST else inner.abs()
            if expr.name == "STRLEN":
                return _HOST
        return None

    def _device_ids(self, expr, table: DeviceTable):
        """:meth:`_try_ids` on the device: an ID column, None, or
        ``_HOST``."""
        n = device_table_len(table)
        if isinstance(expr, Var):
            return table.get(expr.name)
        if isinstance(expr, IriRef):
            tid = self.db.dictionary.lookup(self.db.expand_term(expr.iri))
            return self._full(n, SENT if tid is None else tid, torch.int64)
        if isinstance(expr, StringLit):
            tid = self.db.dictionary.lookup(expr.value)
            return self._full(n, SENT if tid is None else tid, torch.int64)
        if isinstance(expr, QuotedPattern):
            return _HOST
        return None

    def _device_comparison(self, cmp: Comparison, table: DeviceTable):
        """:meth:`_eval_comparison` on the device for numeric and ID
        comparisons; None for a comparison of strings."""
        lnum = self._device_numeric(cmp.left, table)
        rnum = self._device_numeric(cmp.right, table)
        if lnum is _HOST or rnum is _HOST:
            return None
        f = _CMP[cmp.op]
        if lnum is not None and rnum is not None:
            valid = ~(torch.isnan(lnum) | torch.isnan(rnum))
            res = f(lnum, rnum)
            if cmp.op in ("=", "!="):
                # non-numeric rows compare by term identity
                lid = self._device_ids(cmp.left, table)
                rid = self._device_ids(cmp.right, table)
                if lid is _HOST or rid is _HOST:
                    return None
                if lid is not None and rid is not None:
                    return torch.where(valid, res, f(lid, rid))
            return res & valid
        lid = self._device_ids(cmp.left, table)
        rid = self._device_ids(cmp.right, table)
        if lid is _HOST or rid is _HOST:
            return None
        if lid is not None and rid is not None and cmp.op in ("=", "!="):
            return f(lid, rid)
        return None

    def _device_bool_function(self, expr, table: DeviceTable):
        """BOUND and ISTRIPLE on the device; None for the string functions
        and UDFs."""
        if expr.name not in ("BOUND", "ISTRIPLE"):
            return None
        col = self._device_ids(expr.args[0], table)
        if col is _HOST:
            return None
        if col is None:
            return torch.zeros(device_table_len(table), dtype=torch.bool, device=self.device)
        if expr.name == "BOUND":
            return col != UNBOUND
        return (col & QUOTED_BIT) != 0

    # -------------------------------------------------------------- filters

    def eval_filter(self, expr, table: BindingTable) -> np.ndarray:
        n = table_len(table)
        if isinstance(expr, LogicalAnd):
            return self.eval_filter(expr.left, table) & self.eval_filter(
                expr.right, table
            )
        if isinstance(expr, LogicalOr):
            return self.eval_filter(expr.left, table) | self.eval_filter(
                expr.right, table
            )
        if isinstance(expr, LogicalNot):
            return ~self.eval_filter(expr.inner, table)
        if isinstance(expr, Comparison):
            return self._eval_comparison(expr, table)
        if isinstance(expr, (FunctionCall, FuncExpr)):
            return self._eval_bool_function(expr, table)
        raise TypeError(f"unknown filter expression {expr!r}")

    def _eval_comparison(self, cmp: Comparison, table: BindingTable) -> np.ndarray:
        n = table_len(table)
        lnum = self._try_numeric(cmp.left, table)
        rnum = self._try_numeric(cmp.right, table)
        if lnum is not None and rnum is not None:
            valid = ~(np.isnan(lnum) | np.isnan(rnum))
            if cmp.op == "=":
                res = lnum == rnum
            elif cmp.op == "!=":
                res = lnum != rnum
            elif cmp.op == "<":
                res = lnum < rnum
            elif cmp.op == "<=":
                res = lnum <= rnum
            elif cmp.op == ">":
                res = lnum > rnum
            else:
                res = lnum >= rnum
            if cmp.op in ("=", "!=") and (np.isnan(lnum).any() or np.isnan(rnum).any()):
                # fall back to term identity for non-numeric rows
                lid = self._try_ids(cmp.left, table)
                rid = self._try_ids(cmp.right, table)
                if lid is not None and rid is not None:
                    id_res = (lid == rid) if cmp.op == "=" else (lid != rid)
                    return np.where(valid, res, id_res)
            return res & valid
        # identity / string comparison
        lid = self._try_ids(cmp.left, table)
        rid = self._try_ids(cmp.right, table)
        if lid is not None and rid is not None:
            if cmp.op == "=":
                return lid == rid
            if cmp.op == "!=":
                return lid != rid
        # compare on the stripped lexical forms so the quote character never
        # participates in the ordering
        lstr = [self._strip_literal(x) for x in self._eval_strings(cmp.left, table)]
        rstr = [self._strip_literal(x) for x in self._eval_strings(cmp.right, table)]
        ops = {
            "=": lambda a, b: a == b,
            "!=": lambda a, b: a != b,
            "<": lambda a, b: a < b,
            "<=": lambda a, b: a <= b,
            ">": lambda a, b: a > b,
            ">=": lambda a, b: a >= b,
        }
        f = ops[cmp.op]
        return np.fromiter(
            (
                a is not None and b is not None and f(a, b)
                for a, b in zip(lstr, rstr)
            ),
            dtype=bool,
            count=n,
        )

    def _try_numeric(self, expr, table: BindingTable) -> Optional[np.ndarray]:
        """Evaluate to an f64 column, or None if inherently non-numeric."""
        n = table_len(table)
        if isinstance(expr, NumberLit):
            return np.full(n, expr.value)
        if isinstance(expr, Var):
            col = table.get(expr.name)
            if col is None:
                return None
            return self.db.numeric_values()[np.minimum(col, len(self.db.numeric_values()) - 1)]
        if isinstance(expr, ArithOp):
            l = self._try_numeric(expr.left, table)
            r = self._try_numeric(expr.right, table)
            if l is None or r is None:
                return None
            if expr.op == "+":
                return l + r
            if expr.op == "-":
                return l - r
            if expr.op == "*":
                return l * r
            with np.errstate(divide="ignore", invalid="ignore"):
                return l / r
        if isinstance(expr, StringLit):
            try:
                v = float(expr.value.strip('"').split('"')[0])
                return np.full(n, v)
            except ValueError:
                return None
        if isinstance(expr, FuncExpr):
            if expr.name == "ABS":
                inner = self._try_numeric(expr.args[0], table)
                return None if inner is None else np.abs(inner)
            if expr.name == "STRLEN":
                s = self._eval_strings(expr.args[0], table)
                return np.array([len(x or "") for x in s], dtype=np.float64)
        return None

    def _try_ids(self, expr, table: BindingTable) -> Optional[np.ndarray]:
        n = table_len(table)
        if isinstance(expr, Var):
            return table.get(expr.name)
        if isinstance(expr, IriRef):
            tid = self.db.dictionary.lookup(self.db.expand_term(expr.iri))
            return np.full(n, 0xFFFFFFFF if tid is None else tid, dtype=np.uint32)
        if isinstance(expr, StringLit):
            tid = self.db.dictionary.lookup(expr.value)
            return np.full(n, 0xFFFFFFFF if tid is None else tid, dtype=np.uint32)
        if isinstance(expr, QuotedPattern):
            ids = []
            for part in (expr.subject, expr.predicate, expr.object):
                sub = self._try_ids(part, table)
                if sub is None or len(np.unique(sub)) > 1:
                    return None  # per-row quoted construction handled in TRIPLE()
                ids.append(int(sub[0]) if n else 0)
            qid = self.db.quoted.lookup(*ids) if n else None
            return np.full(n, 0xFFFFFFFF if qid is None else qid, dtype=np.uint32)
        return None

    def _eval_strings(self, expr, table: BindingTable) -> List[Optional[str]]:
        n = table_len(table)
        if isinstance(expr, Var):
            col = table.get(expr.name)
            if col is None:
                return [None] * n
            dec = self.db.decode_term
            return [dec(int(i)) for i in col]
        if isinstance(expr, StringLit):
            lex = expr.value
            if lex.startswith('"'):
                lex_plain = lex[1:].split('"')[0]
            else:
                lex_plain = lex
            return [lex_plain] * n
        if isinstance(expr, IriRef):
            return [self.db.expand_term(expr.iri)] * n
        if isinstance(expr, NumberLit):
            v = expr.value
            s = str(int(v)) if v == int(v) else str(v)
            return [s] * n
        if isinstance(expr, FuncExpr):
            return self._eval_string_function(expr, table)
        if isinstance(expr, ArithOp):
            num = self._try_numeric(expr, table)
            if num is not None:
                return [
                    (str(int(v)) if v == int(v) else str(v)) if not np.isnan(v) else None
                    for v in num
                ]
        return [None] * n

    def _strip_literal(self, s: Optional[str]) -> Optional[str]:
        return strip_literal(s)

    def _eval_string_function(self, expr: FuncExpr, table: BindingTable) -> List[Optional[str]]:
        name = expr.name
        n = table_len(table)
        if name == "CONCAT":
            parts = [self._eval_strings(a, table) for a in expr.args]
            parts = [[self._strip_literal(x) for x in p] for p in parts]
            return [
                "".join(x or "" for x in row) for row in zip(*parts)
            ] if parts else [""] * n
        if name in ("STR",):
            return [self._strip_literal(x) for x in self._eval_strings(expr.args[0], table)]
        if name == "UCASE":
            return [
                None if x is None else self._strip_literal(x).upper()
                for x in self._eval_strings(expr.args[0], table)
            ]
        if name == "LCASE":
            return [
                None if x is None else self._strip_literal(x).lower()
                for x in self._eval_strings(expr.args[0], table)
            ]
        if name in ("SUBJECT", "PREDICATE", "OBJECT"):
            col = self._try_ids(expr.args[0], table)
            out: List[Optional[str]] = []
            idx = {"SUBJECT": 0, "PREDICATE": 1, "OBJECT": 2}[name]
            for qid in col:
                inner = self.db.quoted.get(int(qid))
                out.append(None if inner is None else self.db.decode_term(inner[idx]))
            return out
        if name in self.db.udfs:
            fn = self.db.udfs[name]
            arg_strs = [
                [self._strip_literal(x) for x in self._eval_strings(a, table)]
                for a in expr.args
            ]
            return [fn(*row) for row in zip(*arg_strs)] if arg_strs else [fn()] * n
        raise ValueError(f"unknown function {name}")

    def _eval_bool_function(self, expr, table: BindingTable) -> np.ndarray:
        name = expr.name
        args = expr.args
        n = table_len(table)
        if name == "BOUND":
            col = self._try_ids(args[0], table)
            if col is None:
                return np.zeros(n, dtype=bool)
            return col != UNBOUND
        if name == "ISTRIPLE":
            col = self._try_ids(args[0], table)
            if col is None:
                return np.zeros(n, dtype=bool)
            return (col & QUOTED_BIT).astype(bool)
        if name == "REGEX":
            import re as _re

            strs = self._eval_strings(args[0], table)
            pat_l = self._eval_strings(args[1], table)
            pat = self._strip_literal(pat_l[0]) if pat_l else ""
            rx = _re.compile(pat or "")
            return np.array(
                [bool(rx.search(self._strip_literal(s) or "")) for s in strs],
                dtype=bool,
            )
        if name == "CONTAINS":
            strs = self._eval_strings(args[0], table)
            sub_l = self._eval_strings(args[1], table)
            return np.array(
                [
                    (self._strip_literal(s) or "").find(self._strip_literal(b) or "") >= 0
                    for s, b in zip(strs, sub_l)
                ],
                dtype=bool,
            )
        if name in ("STRSTARTS", "STRENDS"):
            strs = self._eval_strings(args[0], table)
            sub_l = self._eval_strings(args[1], table)
            if name == "STRSTARTS":
                return np.array(
                    [
                        (self._strip_literal(s) or "").startswith(self._strip_literal(b) or "")
                        for s, b in zip(strs, sub_l)
                    ],
                    dtype=bool,
                )
            return np.array(
                [
                    (self._strip_literal(s) or "").endswith(self._strip_literal(b) or "")
                    for s, b in zip(strs, sub_l)
                ],
                dtype=bool,
            )
        if name in self.db.udfs:
            fn = self.db.udfs[name]
            arg_strs = [
                [self._strip_literal(x) for x in self._eval_strings(a, table)]
                for a in args
            ]
            return np.array(
                [bool(fn(*row)) for row in zip(*arg_strs)] if arg_strs else [bool(fn())] * n,
                dtype=bool,
            )
        raise ValueError(f"unknown boolean function {name}")

    # ----------------------------------------------------------------- BIND

    def eval_arith_to_ids(self, expr, table: BindingTable) -> np.ndarray:
        """Evaluate an expression and encode results as dictionary IDs
        (numbers become plain literals; TRIPLE() builds quoted-triple IDs)."""
        n = table_len(table)
        if isinstance(expr, FuncExpr) and expr.name == "TRIPLE":
            s_ids = self._coerce_ids(expr.args[0], table)
            p_ids = self._coerce_ids(expr.args[1], table)
            o_ids = self._coerce_ids(expr.args[2], table)
            out = np.empty(n, dtype=np.uint32)
            for i in range(n):
                out[i] = self.db.quoted.intern(
                    int(s_ids[i]), int(p_ids[i]), int(o_ids[i])
                )
            return out
        if isinstance(expr, Var):
            col = table.get(expr.name)
            return col if col is not None else np.zeros(n, dtype=np.uint32)
        num = self._try_numeric(expr, table)
        if num is not None and not isinstance(expr, (StringLit, IriRef)):
            out = np.empty(n, dtype=np.uint32)
            enc = self.db.dictionary.encode
            for i, v in enumerate(num):
                if np.isnan(v):
                    out[i] = UNBOUND
                else:
                    sv = str(int(v)) if v == int(v) else f"{v:g}"
                    out[i] = enc(f'"{sv}"')
            return out
        strs = self._eval_strings(expr, table)
        out = np.empty(n, dtype=np.uint32)
        enc = self.db.dictionary.encode
        for i, sv in enumerate(strs):
            out[i] = UNBOUND if sv is None else enc(f'"{sv}"')
        return out

    def _coerce_ids(self, expr, table: BindingTable) -> np.ndarray:
        ids = self._try_ids(expr, table)
        if ids is not None:
            return ids
        return self.eval_arith_to_ids(expr, table)
