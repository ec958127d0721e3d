"""Host expression evaluation over binding tables, and pattern resolution.

Copy of the parts of ``kolibrie_tpu/optimizer/engine.py`` that the port's
SELECT path runs on the host: :func:`resolve_pattern` (term strings to
dictionary IDs before planning), :func:`strip_literal`, and the expression
half of :class:`ExecutionEngine` — FILTERs that read BIND outputs, BIND and
SELECT expressions, and ORDER BY keys.  Plan evaluation itself runs on the
device engine (``optimizer/device_engine.py``); the reference's numpy plan
interpreter is not ported.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from kolibrie_tpu_torch.core.dictionary import QUOTED_BIT
from kolibrie_tpu_torch.ops.join import UNBOUND, BindingTable, table_len
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


class ExecutionEngine:
    """Vectorized expression evaluation over a host binding table."""

    def __init__(self, db):
        self.db = db

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
