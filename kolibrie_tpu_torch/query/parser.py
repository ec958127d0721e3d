"""SPARQL++ parser: standard SPARQL SELECT/INSERT/DELETE plus the reference's
extensions — RULE (CONSTRUCT/WHERE), PROB annotations, RSP-QL REGISTER with
named windows and sync policies, WINDOW blocks, NOT blocks (NAF), RDF-star
quoted patterns and annotation syntax, MODEL / NEURAL RELATION / TRAIN
declarations, ML.PREDICT, and RETRIEVE.

Parity: ``kolibrie/src/parser.rs`` (nom combinators, 2.8k LoC) — rebuilt as a
tokenizer + recursive-descent parser.  Dispatcher parity:
``parse_combined_query`` (parser.rs:2146-2223).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from kolibrie_tpu_torch.query.ast import (
    Aggregate,
    ArithOp,
    BindClause,
    CombinedQuery,
    CombinedRule,
    Comparison,
    DeleteClause,
    FuncExpr,
    FunctionCall,
    InsertClause,
    IriRef,
    LogicalAnd,
    LogicalNot,
    LogicalOr,
    LossFn,
    MLPredictClause,
    ModelArch,
    ModelDecl,
    NeuralOutputKind,
    NeuralRelationDecl,
    NotBlock,
    NumberLit,
    OptimizerKind,
    OrderCondition,
    PatternTerm,
    PatternTriple,
    ProbAnnotation,
    QuotedPattern,
    RegisterClause,
    RetrieveClause,
    SelectItem,
    SelectQuery,
    StreamType,
    StringLit,
    SubQuery,
    SyncPolicy,
    SyncPolicyKind,
    TimeoutFallback,
    TrainNeuralRelationDecl,
    ValuesClause,
    Var,
    WhereClause,
    WindowBlock,
    WindowClause,
    WindowSpec,
    WindowType,
)

RDF_TYPE = "http://www.w3.org/1999/02/22-rdf-syntax-ns#type"
XSD = "http://www.w3.org/2001/XMLSchema#"


class SparqlParseError(ValueError):
    """Parse failure with position info (rendered by
    :mod:`kolibrie_tpu_torch.query.error_handler`)."""

    def __init__(self, message: str, line: int = 0, col: int = 0, hint: str = ""):
        loc = f" at line {line}:{col}" if line else ""
        super().__init__(f"{message}{loc}" + (f"  hint: {hint}" if hint else ""))
        self.message = message
        self.line = line
        self.col = col
        self.hint = hint


# --------------------------------------------------------------------------
# Tokenizer
# --------------------------------------------------------------------------

_TOK_RE = re.compile(
    r"""
      (?P<comment>\#[^\n]*)
    | (?P<qt_open><<)
    | (?P<qt_close>>>)
    | (?P<iri><[^<>\s{}|^`\\]*>)
    | (?P<literal>"(?:[^"\\]|\\.)*"(?:@[A-Za-z][A-Za-z0-9-]*|\^\^(?:<[^<>\s]*>|[A-Za-z_][\w.-]*:[\w.-]*))?)
    | (?P<var>[?$][A-Za-z_][\w]*)
    | (?P<blank>_:[\w-]+)
    | (?P<op>&&|\|\||!=|<=|>=|:-|[=<>!+\-*/])
    | (?P<punct>[{}()\[\],;.])
    | (?P<num>\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)
    | (?P<pname>[A-Za-z_][\w.-]*:(?:[\w%-](?:[\w.%-]*[\w%-])?)?|:[\w%-](?:[\w.%-]*[\w%-])?|[A-Za-z_]\w*(?:\.[A-Za-z_]\w*)*|:)
    """,
    re.VERBOSE,
)


class Token:
    __slots__ = ("kind", "text", "line", "col")

    def __init__(self, kind: str, text: str, line: int, col: int):
        self.kind = kind
        self.text = text
        self.line = line
        self.col = col

    def __repr__(self):
        return f"Token({self.kind},{self.text!r})"


def tokenize(text: str) -> List[Token]:
    tokens: List[Token] = []
    line, col = 1, 1
    pos, n = 0, len(text)
    while pos < n:
        ch = text[pos]
        if ch == "\n":
            line += 1
            col = 1
            pos += 1
            continue
        if ch in " \t\r":
            pos += 1
            col += 1
            continue
        m = _TOK_RE.match(text, pos)
        if m is None:
            raise SparqlParseError(f"unexpected character {ch!r}", line, col)
        kind = m.lastgroup or ""
        tok = m.group()
        if kind != "comment":
            tokens.append(Token(kind, tok, line, col))
        nl = tok.count("\n")
        if nl:
            line += nl
            col = len(tok) - tok.rfind("\n")
        else:
            col += len(tok)
        pos = m.end()
    return tokens


_KEYWORDS = {
    "select", "where", "prefix", "base", "filter", "bind", "values", "as",
    "group", "order", "by", "asc", "desc", "limit", "offset", "distinct",
    "insert", "delete", "data", "union", "optional", "minus", "not",
    "register", "from", "named", "window", "on", "range", "step", "sliding",
    "slide", "tumbling", "report", "tick", "with", "policy", "rule",
    "construct", "prob", "model", "neural", "relation", "using", "train",
    "retrieve", "some", "every", "active", "latent", "stream", "a",
    "rstream", "istream", "dstream", "arch", "mlp", "hidden", "output",
    "binary", "exclusive", "input", "features", "label", "target", "loss",
    "optimizer", "learning_rate", "epochs", "batch_size", "save_to", "query",
    "undef", "in",
}


class TokenStream:
    def __init__(self, tokens: List[Token], prefixes: Optional[Dict[str, str]] = None):
        self.tokens = tokens
        self.i = 0
        self.prefixes: Dict[str, str] = dict(prefixes or {})
        self.base = ""

    # -- primitives

    def peek(self, offset: int = 0) -> Optional[Token]:
        j = self.i + offset
        return self.tokens[j] if j < len(self.tokens) else None

    def next(self) -> Token:
        tok = self.peek()
        if tok is None:
            last = self.tokens[-1] if self.tokens else None
            raise SparqlParseError(
                "unexpected end of input",
                last.line if last else 0,
                last.col if last else 0,
            )
        self.i += 1
        return tok

    def at_end(self) -> bool:
        return self.i >= len(self.tokens)

    def error(self, message: str, hint: str = "") -> SparqlParseError:
        tok = self.peek() or (self.tokens[-1] if self.tokens else None)
        return SparqlParseError(
            message, tok.line if tok else 0, tok.col if tok else 0, hint
        )

    # -- keyword/punct helpers (keywords are case-insensitive)

    def is_kw(self, *kws: str, offset: int = 0) -> bool:
        tok = self.peek(offset)
        return (
            tok is not None
            and tok.kind == "pname"
            and ":" not in tok.text
            and tok.text.lower() in kws
        )

    def take_kw(self, *kws: str) -> bool:
        if self.is_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str):
        if not self.take_kw(kw):
            raise self.error(f"expected {kw.upper()}")

    def is_punct(self, p: str, offset: int = 0) -> bool:
        tok = self.peek(offset)
        return tok is not None and tok.kind == "punct" and tok.text == p

    def take_punct(self, p: str) -> bool:
        if self.is_punct(p):
            self.next()
            return True
        return False

    def expect_punct(self, p: str):
        if not self.take_punct(p):
            raise self.error(f"expected {p!r}")

    def is_op(self, o: str, offset: int = 0) -> bool:
        tok = self.peek(offset)
        return tok is not None and tok.kind == "op" and tok.text == o

    def take_op(self, o: str) -> bool:
        if self.is_op(o):
            self.next()
            return True
        return False

    # -- term helpers

    def expand_pname(self, text: str) -> str:
        pfx, local = text.split(":", 1)
        ns = self.prefixes.get(pfx)
        if ns is None:
            # leave unexpanded — databases may expand later with their prefixes
            return text
        return ns + local

    def literal_store_form(self, text: str) -> str:
        """Normalize a literal token to the stored-term form (datatype IRIs
        expanded, unbracketed)."""
        m = re.match(r'^("(?:[^"\\]|\\.)*")(.*)$', text, re.S)
        assert m
        lex, suffix = m.group(1), m.group(2)
        lex = '"' + _unescape(lex[1:-1]) + '"'
        if suffix.startswith("^^"):
            dt = suffix[2:]
            if dt.startswith("<"):
                dt = dt[1:-1]
            else:
                dt = self.expand_pname(dt)
            return f"{lex}^^{dt}"
        return lex + suffix


_ESCAPES = {"t": "\t", "n": "\n", "r": "\r", '"': '"', "'": "'", "\\": "\\"}


def _unescape(s: str) -> str:
    if "\\" not in s:
        return s
    out, i = [], 0
    while i < len(s):
        if s[i] == "\\" and i + 1 < len(s):
            out.append(_ESCAPES.get(s[i + 1], s[i + 1]))
            i += 2
        else:
            out.append(s[i])
            i += 1
    return "".join(out)


# --------------------------------------------------------------------------
# Parser
# --------------------------------------------------------------------------


class SparqlParser:
    def __init__(self, text: str, prefixes: Optional[Dict[str, str]] = None):
        self.ts = TokenStream(tokenize(text), prefixes)

    # ---------------------------------------------------------- prefix decls

    def parse_prologue(self):
        while True:
            if self.ts.is_kw("prefix"):
                self.ts.next()
                tok = self.ts.next()
                if tok.kind != "pname" or not tok.text.endswith(":"):
                    if tok.kind == "pname" and ":" in tok.text and tok.text.split(":", 1)[1] == "":
                        pass
                    else:
                        raise self.ts.error("expected prefix name in PREFIX")
                pfx = tok.text[:-1]
                iri_tok = self.ts.next()
                if iri_tok.kind != "iri":
                    raise self.ts.error("expected IRI in PREFIX")
                self.ts.prefixes[pfx] = iri_tok.text[1:-1]
            elif self.ts.is_kw("base"):
                self.ts.next()
                iri_tok = self.ts.next()
                if iri_tok.kind != "iri":
                    raise self.ts.error("expected IRI in BASE")
                self.ts.base = iri_tok.text[1:-1]
            else:
                return

    # ---------------------------------------------------------------- terms

    def parse_pattern_term(self, position: str = "any") -> PatternTerm:
        ts = self.ts
        tok = ts.peek()
        if tok is None:
            raise ts.error("expected term")
        if tok.kind == "var":
            ts.next()
            return PatternTerm.var(tok.text[1:])
        if tok.kind == "iri":
            ts.next()
            iri = tok.text[1:-1]
            if ts.base and not re.match(r"^[A-Za-z][\w+.-]*:", iri):
                iri = ts.base + iri
            return PatternTerm.term(iri)
        if tok.kind == "literal":
            ts.next()
            return PatternTerm.term(ts.literal_store_form(tok.text))
        if tok.kind == "num":
            ts.next()
            dt = "integer" if re.fullmatch(r"\d+", tok.text) else "decimal"
            if "e" in tok.text.lower():
                dt = "double"
            return PatternTerm.term(f'"{tok.text}"^^{XSD}{dt}')
        if tok.kind == "blank":
            ts.next()
            return PatternTerm.term(tok.text)
        if tok.kind == "qt_open":
            ts.next()
            s = self.parse_pattern_term("subject")
            p = self.parse_pattern_term("predicate")
            o = self.parse_pattern_term("object")
            if ts.peek() is None or ts.next().kind != "qt_close":
                raise ts.error("expected '>>' closing quoted triple")
            return PatternTerm("quoted", (s, p, o))
        if tok.kind == "pname":
            if tok.text.lower() == "a" and position == "predicate":
                ts.next()
                return PatternTerm.term(RDF_TYPE)
            if tok.text.lower() in ("true", "false"):
                ts.next()
                return PatternTerm.term(f'"{tok.text.lower()}"^^{XSD}boolean')
            if ":" in tok.text:
                ts.next()
                return PatternTerm.term(ts.expand_pname(tok.text))
        raise ts.error(f"unexpected token {tok.text!r} in triple {position}")

    # ------------------------------------------------------- triple patterns

    def parse_triple_block(self, patterns: List[PatternTriple]):
        """One subject with ``;``/``,`` predicate-object lists.  RDF-star
        annotation syntax ``{| p v |}`` is not in the reference; quoted
        subjects/objects are."""
        ts = self.ts
        subject = self.parse_pattern_term("subject")
        while True:
            pred = self.parse_pattern_term("predicate")
            while True:
                obj = self.parse_pattern_term("object")
                patterns.append(PatternTriple(subject, pred, obj))
                if ts.take_punct(","):
                    continue
                break
            if ts.take_punct(";"):
                nxt = ts.peek()
                if nxt is not None and (
                    nxt.kind in ("var", "iri", "literal", "qt_open")
                    or (nxt.kind == "pname" and (":" in nxt.text or nxt.text.lower() == "a"))
                ):
                    continue
            break

    # ----------------------------------------------------------- arithmetic

    def parse_arith_expr(self):
        left = self.parse_arith_term()
        while self.ts.is_op("+") or self.ts.is_op("-"):
            op = self.ts.next().text
            right = self.parse_arith_term()
            left = ArithOp(left, op, right)
        return left

    def parse_arith_term(self):
        left = self.parse_arith_factor()
        while self.ts.is_op("*") or self.ts.is_op("/"):
            op = self.ts.next().text
            right = self.parse_arith_factor()
            left = ArithOp(left, op, right)
        return left

    def parse_arith_factor(self):
        ts = self.ts
        tok = ts.peek()
        if tok is None:
            raise ts.error("expected expression")
        if tok.kind == "punct" and tok.text == "(":
            ts.next()
            e = self.parse_arith_expr()
            ts.expect_punct(")")
            return e
        if tok.kind == "var":
            ts.next()
            return Var(tok.text[1:])
        if tok.kind == "num":
            ts.next()
            return NumberLit(float(tok.text))
        if tok.kind == "op" and tok.text == "-":
            ts.next()
            inner = self.parse_arith_factor()
            return ArithOp(NumberLit(0.0), "-", inner)
        if tok.kind == "literal":
            ts.next()
            return StringLit(ts.literal_store_form(tok.text))
        if tok.kind == "iri":
            ts.next()
            return IriRef(tok.text[1:-1])
        if tok.kind == "qt_open":
            ts.next()
            s = self.parse_arith_factor()
            p = self.parse_arith_factor()
            o = self.parse_arith_factor()
            if ts.next().kind != "qt_close":
                raise ts.error("expected '>>'")
            return QuotedPattern(s, p, o)
        if tok.kind == "pname":
            # function call or pname constant
            if ts.is_punct("(", offset=1) and ":" not in tok.text:
                name = ts.next().text
                ts.expect_punct("(")
                args = []
                if not ts.is_punct(")"):
                    args.append(self.parse_arith_expr())
                    while ts.take_punct(","):
                        args.append(self.parse_arith_expr())
                ts.expect_punct(")")
                return FuncExpr(name.upper(), args)
            if ":" in tok.text:
                ts.next()
                return IriRef(ts.expand_pname(tok.text))
            if tok.text.lower() in ("true", "false"):
                ts.next()
                return StringLit(f'"{tok.text.lower()}"^^{XSD}boolean')
        raise ts.error(f"unexpected token {tok.text!r} in expression")

    # -------------------------------------------------------------- filters

    def parse_filter_expr(self):
        """Full precedence: OR < AND < NOT < comparison."""
        left = self.parse_filter_and()
        while self.ts.take_op("||"):
            right = self.parse_filter_and()
            left = LogicalOr(left, right)
        return left

    def parse_filter_and(self):
        left = self.parse_filter_not()
        while self.ts.take_op("&&"):
            right = self.parse_filter_not()
            left = LogicalAnd(left, right)
        return left

    def parse_filter_not(self):
        if self.ts.take_op("!"):
            return LogicalNot(self.parse_filter_not())
        return self.parse_filter_atom()

    def parse_filter_atom(self):
        ts = self.ts
        # parenthesized sub-expression — but "(expr) > 5" is a comparison whose
        # left side is parenthesized arithmetic; try filter first, backtrack.
        if ts.is_punct("("):
            save = ts.i
            ts.next()
            try:
                inner = self.parse_filter_expr()
                ts.expect_punct(")")
                # if a comparison operator follows, re-parse as arithmetic
                if not (ts.peek() is not None and ts.peek().kind == "op" and ts.peek().text in ("=", "!=", "<", "<=", ">", ">=")):
                    return inner
            except SparqlParseError:
                pass
            ts.i = save
        left = self.parse_arith_expr()
        tok = ts.peek()
        if tok is not None and tok.kind == "op" and tok.text in ("=", "!=", "<", "<=", ">", ">="):
            op = ts.next().text
            right = self.parse_arith_expr()
            return Comparison(left, op, right)
        if isinstance(left, FuncExpr):
            return FunctionCall(left.name, left.args)
        raise ts.error("expected comparison or boolean function in FILTER")

    # ------------------------------------------------------------ WHERE body

    def parse_group_graph_pattern(self, allow_windows: bool = True) -> WhereClause:
        ts = self.ts
        ts.expect_punct("{")
        wc = WhereClause()
        while not ts.is_punct("}"):
            if ts.at_end():
                raise ts.error("unterminated group pattern, expected '}'")
            if ts.is_kw("filter"):
                ts.next()
                paren = ts.take_punct("(")
                wc.filters.append(self.parse_filter_expr())
                if paren:
                    ts.expect_punct(")")
            elif ts.is_kw("bind"):
                ts.next()
                ts.expect_punct("(")
                expr = self.parse_arith_expr()
                ts.expect_kw("as")
                var_tok = ts.next()
                if var_tok.kind != "var":
                    raise ts.error("expected variable after AS")
                ts.expect_punct(")")
                wc.binds.append(BindClause(expr, var_tok.text[1:]))
            elif ts.is_kw("values"):
                ts.next()
                wc.values = self.parse_values_body()
            elif ts.is_kw("optional"):
                ts.next()
                wc.optionals.append(self.parse_group_graph_pattern(allow_windows))
            elif ts.is_kw("minus"):
                ts.next()
                wc.minus.append(self.parse_group_graph_pattern(allow_windows))
            elif ts.is_kw("not") and not ts.is_punct("(", offset=1):
                ts.next()
                inner: List[PatternTriple] = []
                ts.expect_punct("{")
                while not ts.is_punct("}"):
                    self.parse_triple_block(inner)
                    ts.take_punct(".")
                ts.expect_punct("}")
                wc.not_blocks.append(NotBlock(inner))
            elif allow_windows and ts.is_kw("window"):
                ts.next()
                wtok = ts.next()
                if wtok.kind == "iri":
                    wiri = wtok.text[1:-1]
                elif wtok.kind == "pname":
                    wiri = ts.expand_pname(wtok.text)
                else:
                    raise ts.error("expected window IRI after WINDOW")
                inner_wc = self.parse_group_graph_pattern(allow_windows=False)
                wc.window_blocks.append(
                    WindowBlock(wiri, inner_wc.patterns, inner_wc.filters)
                )
            elif ts.is_punct("{"):
                # subquery or nested group
                save = ts.i
                ts.next()
                if ts.is_kw("select"):
                    sub = self.parse_select_query(already_prologued=True)
                    ts.expect_punct("}")
                    wc.subqueries.append(SubQuery(sub))
                else:
                    ts.i = save
                    groups = [self.parse_group_graph_pattern(allow_windows)]
                    while ts.is_kw("union"):
                        ts.next()
                        groups.append(self.parse_group_graph_pattern(allow_windows))
                    if len(groups) == 1:
                        g = groups[0]
                        wc.patterns.extend(g.patterns)
                        wc.filters.extend(g.filters)
                        wc.binds.extend(g.binds)
                        wc.not_blocks.extend(g.not_blocks)
                        wc.subqueries.extend(g.subqueries)
                        wc.optionals.extend(g.optionals)
                        wc.minus.extend(g.minus)
                        wc.window_blocks.extend(g.window_blocks)
                        if g.values is not None:
                            wc.values = g.values
                    else:
                        wc.unions.append(groups)
            else:
                self.parse_triple_block(wc.patterns)
            ts.take_punct(".")
        ts.expect_punct("}")
        return wc

    def parse_values_body(self) -> ValuesClause:
        ts = self.ts
        variables: List[str] = []
        if ts.is_punct("("):
            ts.next()
            while not ts.is_punct(")"):
                vt = ts.next()
                if vt.kind != "var":
                    raise ts.error("expected variable in VALUES")
                variables.append(vt.text[1:])
            ts.next()
            ts.expect_punct("{")
            rows: List[List[Optional[str]]] = []
            while not ts.is_punct("}"):
                ts.expect_punct("(")
                row: List[Optional[str]] = []
                while not ts.is_punct(")"):
                    row.append(self._values_term())
                ts.next()
                rows.append(row)
            ts.next()
            return ValuesClause(variables, rows)
        vt = ts.next()
        if vt.kind != "var":
            raise ts.error("expected variable in VALUES")
        variables.append(vt.text[1:])
        ts.expect_punct("{")
        rows = []
        while not ts.is_punct("}"):
            rows.append([self._values_term()])
        ts.next()
        return ValuesClause(variables, rows)

    def _values_term(self) -> Optional[str]:
        ts = self.ts
        if ts.is_kw("undef"):
            ts.next()
            return None
        t = self.parse_pattern_term("object")
        if t.kind == "var":
            raise ts.error("variables not allowed in VALUES data")
        return t.value  # type: ignore[return-value]

    # ---------------------------------------------------------------- SELECT

    def parse_select_query(self, already_prologued: bool = False) -> SelectQuery:
        ts = self.ts
        if not already_prologued:
            self.parse_prologue()
        ts.expect_kw("select")
        distinct = ts.take_kw("distinct")
        items: List[SelectItem] = []
        while True:
            tok = ts.peek()
            if tok is None:
                break
            if tok.kind == "op" and tok.text == "*":
                ts.next()
                items.append(SelectItem("var", var="*"))
                continue
            if tok.kind == "var":
                ts.next()
                items.append(SelectItem("var", var=tok.text[1:]))
                continue
            if tok.kind == "punct" and tok.text == "(":
                ts.next()
                agg = self._try_parse_aggregate()
                if agg is not None:
                    items.append(SelectItem("agg", agg=agg))
                else:
                    expr = self.parse_arith_expr()
                    ts.expect_kw("as")
                    vt = ts.next()
                    if vt.kind != "var":
                        raise ts.error("expected variable after AS")
                    items.append(SelectItem("expr", expr=expr, alias=vt.text[1:]))
                ts.expect_punct(")")
                continue
            if tok.kind == "pname" and tok.text.upper() in (
                "COUNT", "SUM", "AVG", "MIN", "MAX", "GROUP_CONCAT", "SAMPLE",
            ):
                agg = self._try_parse_aggregate()
                if agg is not None:
                    items.append(SelectItem("agg", agg=agg))
                    continue
            break
        if not items:
            raise ts.error("SELECT requires at least one projection")
        # FROM NAMED WINDOW clauses (RSP-QL) are parsed by the caller when in
        # REGISTER context; plain FROM <g> is accepted and ignored (single graph).
        windows: List[WindowClause] = []
        while ts.is_kw("from"):
            ts.next()
            if ts.is_kw("named"):
                ts.next()
                ts.expect_kw("window")
                windows.append(self.parse_window_clause_body())
            else:
                ts.next()  # graph IRI — single-graph store, ignored
        where = None
        if ts.is_kw("where"):
            ts.next()
            where = self.parse_group_graph_pattern()
        else:
            where = WhereClause()
        q = SelectQuery(
            select=items, where=where, distinct=distinct, prefixes=dict(ts.prefixes)
        )
        q.window_clauses = windows  # type: ignore[attr-defined]
        while True:
            if ts.is_kw("group"):
                ts.next()
                ts.expect_kw("by")
                while ts.peek() is not None and ts.peek().kind == "var":
                    q.group_by.append(ts.next().text[1:])
            elif ts.is_kw("order"):
                ts.next()
                ts.expect_kw("by")
                while True:
                    if ts.is_kw("asc") or ts.is_kw("desc"):
                        desc = ts.next().text.lower() == "desc"
                        ts.expect_punct("(")
                        expr = self.parse_arith_expr()
                        ts.expect_punct(")")
                        q.order_by.append(OrderCondition(expr, desc))
                    elif ts.peek() is not None and ts.peek().kind == "var":
                        q.order_by.append(OrderCondition(Var(ts.next().text[1:]), False))
                    else:
                        break
            elif ts.is_kw("limit"):
                ts.next()
                q.limit = int(ts.next().text)
            elif ts.is_kw("offset"):
                ts.next()
                q.offset = int(ts.next().text)
            else:
                break
        return q

    def _try_parse_aggregate(self) -> Optional[Aggregate]:
        """Parse ``COUNT(?x) [AS ?alias]`` etc.  The caller may already have
        consumed an outer '(' (``(COUNT(?x) AS ?n)`` form); either way the
        next token here must be the aggregate function name."""
        ts = self.ts
        save = ts.i
        name_tok = ts.peek()
        if name_tok is None or name_tok.kind != "pname":
            return None
        fname = name_tok.text.upper()
        if fname not in ("COUNT", "SUM", "AVG", "MIN", "MAX", "GROUP_CONCAT", "SAMPLE"):
            return None
        ts.next()  # consume function name
        ts.expect_punct("(")
        distinct = ts.take_kw("distinct")
        if ts.is_op("*"):
            ts.next()
            arg = None
        else:
            vt = ts.next()
            if vt.kind != "var":
                ts.i = save
                return None
            arg = vt.text[1:]
        ts.expect_punct(")")
        if ts.take_kw("as"):
            vt = ts.next()
            alias = vt.text[1:]
        else:
            alias = f"{fname.lower()}_{arg or 'all'}"
        return Aggregate(fname, arg, alias, distinct)

    # ----------------------------------------------------- INSERT / DELETE

    def parse_insert(self) -> InsertClause:
        ts = self.ts
        ts.expect_kw("insert")
        ts.take_kw("data")
        ts.expect_punct("{")
        triples: List[PatternTriple] = []
        while not ts.is_punct("}"):
            self.parse_triple_block(triples)
            ts.take_punct(".")
        ts.next()
        return InsertClause(triples)

    def parse_delete(self) -> DeleteClause:
        ts = self.ts
        ts.expect_kw("delete")
        ts.take_kw("data")
        ts.expect_punct("{")
        triples: List[PatternTriple] = []
        while not ts.is_punct("}"):
            self.parse_triple_block(triples)
            ts.take_punct(".")
        ts.next()
        where = None
        if ts.is_kw("where"):
            ts.next()
            where = self.parse_group_graph_pattern()
        return DeleteClause(triples, where)

    # ------------------------------------------------------------- windows

    def parse_window_clause_body(self) -> WindowClause:
        """After ``FROM NAMED WINDOW``: ``:w ON :stream [SPEC] [WITH POLICY p]``."""
        ts = self.ts
        wiri = self._iri_or_pname("window IRI")
        ts.expect_kw("on")
        tok = ts.peek()
        if tok is not None and tok.kind == "var":
            ts.next()
            stream = "?" + tok.text[1:]
        else:
            stream = self._iri_or_pname("stream IRI")
        ts.expect_punct("[")
        spec = self._parse_window_spec()
        ts.expect_punct("]")
        policy = None
        if ts.is_kw("with"):
            ts.next()
            ts.expect_kw("policy")
            policy = self._parse_sync_policy()
        return WindowClause(wiri, stream, spec, policy)

    def _iri_or_pname(self, what: str) -> str:
        ts = self.ts
        tok = ts.next()
        if tok.kind == "iri":
            return tok.text[1:-1]
        if tok.kind == "pname":
            return ts.expand_pname(tok.text) if ":" in tok.text else tok.text
        raise ts.error(f"expected {what}")

    def _parse_duration(self) -> int:
        """Window size: bare int, ``PT10M``-style ISO-8601, ``5s``/``500ms``."""
        ts = self.ts
        tok = ts.next()
        if tok.kind == "num":
            val = int(float(tok.text))
            nxt = ts.peek()
            if nxt is not None and nxt.kind == "pname" and nxt.text in ("s", "ms"):
                ts.next()
                return val if nxt.text == "s" else max(1, val // 1000)
            return val
        if tok.kind == "pname":
            m = re.fullmatch(r"(?i)PT(\d+)([SMH])", tok.text)
            if m:
                n = int(m.group(1))
                unit = m.group(2).upper()
                return n * {"S": 1, "M": 60, "H": 3600}[unit]
            m = re.fullmatch(r"(\d+)(s|ms)", tok.text)
            if m:
                n = int(m.group(1))
                return n if m.group(2) == "s" else max(1, n // 1000)
        raise ts.error("expected window duration")

    def _parse_window_spec(self) -> WindowSpec:
        ts = self.ts
        if ts.take_kw("range"):
            width = self._parse_duration()
            slide = width
            wtype = WindowType.SLIDING
            if ts.take_kw("step"):
                slide = self._parse_duration()
        elif ts.take_kw("sliding"):
            width = self._parse_duration()
            slide = 1
            wtype = WindowType.SLIDING
            if ts.take_kw("slide"):
                slide = self._parse_duration()
        elif ts.take_kw("tumbling"):
            width = self._parse_duration()
            slide = width
            wtype = WindowType.TUMBLING
        else:
            raise ts.error("expected RANGE / SLIDING / TUMBLING")
        spec = WindowSpec(width, slide, wtype)
        while True:
            if ts.take_kw("report"):
                spec.report = ts.next().text.upper()
            elif ts.take_kw("tick"):
                spec.tick = ts.next().text.upper()
            else:
                break
        return spec

    def _parse_sync_policy(self) -> SyncPolicy:
        ts = self.ts
        if ts.take_kw("steal"):
            return SyncPolicy(SyncPolicyKind.STEAL)
        if ts.take_kw("wait"):
            return SyncPolicy(SyncPolicyKind.WAIT)
        ts.expect_punct("(")
        ts.expect_kw("timeout")
        if not ts.take_op("="):
            raise ts.error("expected '=' after timeout")
        dur_s = self._parse_policy_duration_ms()
        ts.expect_punct(",")
        ts.expect_kw("fallback")
        if not ts.take_op("="):
            raise ts.error("expected '=' after fallback")
        fb = ts.next().text.lower()
        ts.expect_punct(")")
        return SyncPolicy(
            SyncPolicyKind.TIMEOUT,
            timeout_ms=dur_s,
            fallback=TimeoutFallback.DROP if fb == "drop" else TimeoutFallback.STEAL,
        )

    def _parse_policy_duration_ms(self) -> int:
        ts = self.ts
        tok = ts.next()
        if tok.kind == "num":
            val = int(float(tok.text))
            nxt = ts.peek()
            if nxt is not None and nxt.kind == "pname" and nxt.text in ("s", "ms"):
                ts.next()
                return val * 1000 if nxt.text == "s" else val
            return val * 1000  # bare integer = seconds
        if tok.kind == "pname":
            m = re.fullmatch(r"(?i)PT(\d+)([SMH])", tok.text)
            if m:
                n = int(m.group(1))
                return n * {"S": 1, "M": 60, "H": 3600}[m.group(2).upper()] * 1000
            m = re.fullmatch(r"(\d+)(s|ms)", tok.text)
            if m:
                return int(m.group(1)) * (1000 if m.group(2) == "s" else 1)
        raise ts.error("expected duration")

    # ------------------------------------------------------------- REGISTER

    def parse_register(self) -> RegisterClause:
        ts = self.ts
        ts.expect_kw("register")
        st_tok = ts.next()
        st = st_tok.text.upper()
        if st not in ("RSTREAM", "ISTREAM", "DSTREAM"):
            raise ts.error("expected RSTREAM/ISTREAM/DSTREAM after REGISTER")
        out_iri = self._iri_or_pname("output stream IRI")
        ts.expect_kw("as")
        select = self.parse_select_query(already_prologued=True)
        windows = getattr(select, "window_clauses", [])
        return RegisterClause(StreamType[st], out_iri, select, windows)

    # ----------------------------------------------------------------- RULE

    def parse_rule(self) -> CombinedRule:
        """``RULE :Name [PROB(...)] :- CONSTRUCT { ... } WHERE { ... }``."""
        ts = self.ts
        ts.expect_kw("rule")
        name = self._iri_or_pname("rule name")
        params: List[str] = []
        if ts.take_punct("("):
            while not ts.is_punct(")"):
                vt = ts.next()
                if vt.kind == "var":
                    params.append(vt.text[1:])
                ts.take_punct(",")
            ts.next()
        prob = None
        if ts.is_kw("prob"):
            prob = self._parse_prob_annotation()
        if not ts.take_op(":-"):
            raise ts.error("expected ':-' after rule head")
        ml_predict = None
        if ts.is_kw("construct"):
            ts.next()
        conclusions: List[PatternTriple] = []
        ts.expect_punct("{")
        while not ts.is_punct("}"):
            self.parse_triple_block(conclusions)
            ts.take_punct(".")
        ts.next()
        body = WhereClause()
        if ts.is_kw("where"):
            ts.next()
            body = self.parse_group_graph_pattern()
        # trailing ML.PREDICT attached to the rule
        if ts.is_kw("ml") or (
            ts.peek() is not None and ts.peek().kind == "pname" and ts.peek().text.upper().startswith("ML.")
        ):
            ml_predict = self.parse_ml_predict()
        rule = CombinedRule(
            name=name,
            params=params,
            body=body,
            conclusions=conclusions,
            prob=prob,
            ml_predict=ml_predict,
        )
        return rule

    def _parse_prob_annotation(self) -> ProbAnnotation:
        ts = self.ts
        ts.expect_kw("prob")
        ts.expect_punct("(")
        ann = ProbAnnotation()
        explicit_k = None
        while not ts.is_punct(")"):
            key = ts.next().text.lower()
            if not ts.take_op("="):
                raise ts.error("expected '=' in PROB annotation")
            val_tok = ts.next()
            val = val_tok.text.strip('"')
            if key in ("combination", "provenance"):
                ann.combination = _normalize_combination(val)
            elif key == "threshold":
                ann.threshold = float(val)
            elif key == "confidence":
                ann.confidence = float(val)
            elif key == "k":
                explicit_k = int(float(val))
            ts.take_punct(",")
        ts.next()
        # topk reads k from the threshold field at use time, key-order
        # independent; default 5 (parser.rs:2679 unwrap_or(5))
        if explicit_k is not None:
            ann.k = explicit_k
        elif ann.combination == "topk":
            ann.k = int(ann.threshold) if ann.threshold is not None else 5
        return ann

    # ----------------------------------------------------- ML declarations

    def parse_ml_predict(self) -> MLPredictClause:
        """``ML.PREDICT(MODEL "m", INPUT { SELECT ... }, OUTPUT ?v)``."""
        ts = self.ts
        tok = ts.next()
        if tok.text.upper() not in ("ML.PREDICT", "ML"):
            raise ts.error("expected ML.PREDICT")
        if tok.text.upper() == "ML":
            # tokenized as ML . PREDICT
            ts.expect_punct(".")
            nt = ts.next()
            if nt.text.upper() != "PREDICT":
                raise ts.error("expected PREDICT after ML.")
        ts.expect_punct("(")
        ts.expect_kw("model")
        model_tok = ts.next()
        model = model_tok.text.strip('"') if model_tok.kind == "literal" else self.ts.expand_pname(model_tok.text) if ":" in model_tok.text else model_tok.text
        ts.expect_punct(",")
        ts.expect_kw("input")
        ts.expect_punct("{")
        select = self.parse_select_query(already_prologued=True)
        ts.expect_punct("}")
        ts.expect_punct(",")
        ts.expect_kw("output")
        vt = ts.next()
        if vt.kind != "var":
            raise ts.error("expected output variable")
        ts.expect_punct(")")
        return MLPredictClause(model, select, vt.text[1:])

    def parse_model_decl(self) -> ModelDecl:
        ts = self.ts
        ts.expect_kw("model")
        name = ts.next().text.strip('"')
        ts.expect_punct("{")
        arch = ModelArch()
        output = NeuralOutputKind("binary")
        while not ts.is_punct("}"):
            if ts.take_kw("arch"):
                ts.expect_kw("mlp")
                ts.expect_punct("{")
                ts.expect_kw("hidden")
                ts.expect_punct("[")
                hidden: List[int] = []
                while not ts.is_punct("]"):
                    hidden.append(int(ts.next().text))
                    ts.take_punct(",")
                ts.next()
                ts.expect_punct("}")
                arch = ModelArch(hidden)
            elif ts.take_kw("output"):
                if ts.take_kw("binary"):
                    output = NeuralOutputKind("binary")
                elif ts.take_kw("exclusive"):
                    ts.expect_punct("{")
                    labels: List[str] = []
                    while not ts.is_punct("}"):
                        labels.append(ts.next().text.strip('"'))
                        ts.take_punct(",")
                    ts.next()
                    output = NeuralOutputKind("exclusive", labels)
                else:
                    raise ts.error("expected BINARY or EXCLUSIVE")
            else:
                raise ts.error("unexpected token in MODEL declaration")
        ts.next()
        return ModelDecl(name, arch, output)

    def parse_neural_relation_decl(self) -> NeuralRelationDecl:
        ts = self.ts
        ts.expect_kw("neural")
        ts.expect_kw("relation")
        pred_tok = ts.next()
        predicate = (
            ts.expand_pname(pred_tok.text) if pred_tok.kind == "pname" and ":" in pred_tok.text
            else pred_tok.text[1:-1] if pred_tok.kind == "iri"
            else pred_tok.text
        )
        ts.expect_kw("using")
        ts.expect_kw("model")
        model = ts.next().text.strip('"')
        ts.expect_punct("{")
        patterns: List[PatternTriple] = []
        features: List[str] = []
        while not ts.is_punct("}"):
            if ts.take_kw("input"):
                ts.expect_punct("{")
                while not ts.is_punct("}"):
                    self.parse_triple_block(patterns)
                    ts.take_punct(".")
                ts.next()
            elif ts.take_kw("features"):
                ts.expect_punct("{")
                while not ts.is_punct("}"):
                    vt = ts.next()
                    if vt.kind == "var":
                        features.append(vt.text[1:])
                    ts.take_punct(",")
                ts.next()
            else:
                raise ts.error("expected INPUT or FEATURES")
        ts.next()
        anchor = ""
        if patterns and patterns[0].subject.is_var:
            anchor = patterns[0].subject.value  # type: ignore[assignment]
        return NeuralRelationDecl(predicate, model, patterns, anchor, features)

    def parse_train_decl(self) -> TrainNeuralRelationDecl:
        ts = self.ts
        ts.expect_kw("train")
        ts.expect_kw("neural")
        ts.expect_kw("relation")
        rel_tok = ts.next()
        relation = (
            ts.expand_pname(rel_tok.text) if rel_tok.kind == "pname" and ":" in rel_tok.text
            else rel_tok.text[1:-1] if rel_tok.kind == "iri"
            else rel_tok.text
        )
        decl = TrainNeuralRelationDecl(relation)
        ts.expect_punct("{")
        while not ts.is_punct("}"):
            if ts.take_kw("data"):
                ts.expect_punct("{")
                while not ts.is_punct("}"):
                    self.parse_triple_block(decl.data_patterns)
                    ts.take_punct(".")
                ts.next()
            elif ts.take_kw("query"):
                ts.expect_punct("{")
                sub = self.parse_select_query(already_prologued=True)
                decl.data_query = sub  # keep parsed form
                ts.expect_punct("}")
            elif ts.take_kw("label"):
                vt = ts.next()
                decl.label_var = vt.text[1:] if vt.kind == "var" else vt.text
            elif ts.take_kw("target"):
                ts.expect_punct("{")
                tgt: List[PatternTriple] = []
                self.parse_triple_block(tgt)
                ts.take_punct(".")
                ts.expect_punct("}")
                decl.target = tgt[0]
            elif ts.take_kw("loss"):
                name = ts.next().text.lower()
                decl.loss = {
                    "cross_entropy": LossFn.CROSS_ENTROPY,
                    "nll": LossFn.NLL,
                    "mse": LossFn.MSE,
                    "bce": LossFn.BCE,
                }.get(name, LossFn.BCE)
            elif ts.take_kw("optimizer"):
                decl.optimizer = (
                    OptimizerKind.SGD if ts.next().text.lower() == "sgd" else OptimizerKind.ADAM
                )
            elif ts.take_kw("learning_rate"):
                decl.learning_rate = float(ts.next().text)
            elif ts.take_kw("epochs"):
                decl.epochs = int(ts.next().text)
            elif ts.take_kw("batch_size"):
                decl.batch_size = int(ts.next().text)
            elif ts.take_kw("save_to"):
                decl.save_path = ts.next().text.strip('"')
            else:
                raise ts.error("unexpected token in TRAIN NEURAL RELATION")
        ts.next()
        return decl

    # ------------------------------------------------------------- RETRIEVE

    def parse_retrieve(self) -> RetrieveClause:
        ts = self.ts
        ts.expect_kw("retrieve")
        mode = "SOME" if ts.take_kw("some") else ("EVERY" if ts.take_kw("every") else None)
        if mode is None:
            raise ts.error("expected SOME or EVERY after RETRIEVE")
        state = "ACTIVE" if ts.take_kw("active") else ("LATENT" if ts.take_kw("latent") else None)
        if state is None:
            raise ts.error("expected ACTIVE or LATENT")
        ts.expect_kw("stream")
        vt = ts.next()
        if vt.kind != "var":
            raise ts.error("expected stream variable")
        ts.expect_kw("from")
        from_iri = self._iri_or_pname("catalog IRI")
        patterns: List[PatternTriple] = []
        if ts.take_kw("with"):
            ts.expect_punct("{")
            while not ts.is_punct("}"):
                self.parse_triple_block(patterns)
                ts.take_punct(".")
            ts.next()
        return RetrieveClause(mode, state, vt.text[1:], from_iri, patterns)

    # ------------------------------------------------------- combined query

    def parse_combined(self) -> CombinedQuery:
        """Top-level dispatcher. Parity: parser.rs:2146-2223."""
        ts = self.ts
        cq = CombinedQuery()
        self.parse_prologue()
        while not ts.at_end():
            if ts.is_kw("prefix") or ts.is_kw("base"):
                self.parse_prologue()
            elif ts.is_kw("model") and ts.peek(1) is not None and ts.peek(1).kind == "literal":
                cq.models.append(self.parse_model_decl())
            elif ts.is_kw("neural"):
                cq.neural_relations.append(self.parse_neural_relation_decl())
            elif ts.is_kw("train"):
                cq.train_decls.append(self.parse_train_decl())
            elif ts.is_kw("rule"):
                cq.rules.append(self.parse_rule())
            elif ts.is_kw("retrieve"):
                cq.retrieve = self.parse_retrieve()
            elif ts.is_kw("register"):
                cq.register = self.parse_register()
            elif ts.is_kw("select"):
                cq.select = self.parse_select_query(already_prologued=True)
            elif ts.is_kw("insert"):
                cq.insert = self.parse_insert()
            elif ts.is_kw("delete"):
                cq.delete = self.parse_delete()
            elif ts.peek() is not None and ts.peek().kind == "pname" and ts.peek().text.upper() in ("ML.PREDICT",):
                cq.ml_predict = self.parse_ml_predict()
            elif ts.is_kw("ml"):
                cq.ml_predict = self.parse_ml_predict()
            else:
                raise ts.error(
                    f"unexpected token {ts.peek().text!r} at top level",
                    hint="expected SELECT, INSERT, DELETE, RULE, REGISTER, MODEL, "
                    "NEURAL RELATION, TRAIN, ML.PREDICT, or RETRIEVE",
                )
        cq.prefixes = dict(ts.prefixes)
        return cq


def _normalize_combination(val: str) -> str:
    """PROB combination aliases (parser_test.rs cases): independent→addmult,
    min/minmax→minmax, plus topk / wmc / sdd / boolean."""
    v = val.lower()
    return {
        "independent": "addmult",
        "addmult": "addmult",
        "noisyor": "addmult",
        "min": "minmax",
        "minmax": "minmax",
        "fuzzy": "minmax",
        "boolean": "boolean",
        "topk": "topk",
        "wmc": "wmc",
        "dnf": "wmc",
        "sdd": "sdd",
    }.get(v, v)


# --------------------------------------------------------------------------
# Public entry points (parity: parse_sparql_query parser.rs:1036,
# parse_combined_query parser.rs:2146)
# --------------------------------------------------------------------------


def parse_sparql_query(text: str, prefixes: Optional[Dict[str, str]] = None) -> SelectQuery:
    p = SparqlParser(text, prefixes)
    q = p.parse_select_query()
    return q


def parse_combined_query(text: str, prefixes: Optional[Dict[str, str]] = None) -> CombinedQuery:
    p = SparqlParser(text, prefixes)
    return p.parse_combined()


def parse_rule_definition(text: str, prefixes: Optional[Dict[str, str]] = None) -> CombinedRule:
    p = SparqlParser(text, prefixes)
    p.parse_prologue()
    return p.parse_rule()
