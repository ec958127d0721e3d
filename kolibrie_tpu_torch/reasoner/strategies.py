"""Forward-chaining strategies: naive and semi-naive fixpoints over the
columnar fact store.

Parity: ``datalog/src/reasoning/materialisation/`` — the
``InferenceStrategy``/``infer_with_strategy`` generic loop
(infer_generic.rs:9-54), ``NaiveStrategy`` (my_naive.rs:16-37), semi-naive
delta seeding (semi_naive.rs:22-59), and the rayon-parallel variant
(semi_naive_parallel.rs) whose rebuild equivalent is full vectorization: each
round is a batch of columnar joins — on the card, the device fixpoint
(:mod:`kolibrie_tpu_torch.reasoner.device_fixpoint`).

Rule-body evaluation reuses the binding-table joins of
``kolibrie_tpu_torch.ops.join`` — the same unification the reference routes
through ``shared::join_algorithm`` (rules.rs:167-180).  Copy of
``kolibrie_tpu/reasoner/strategies.py``: host numpy, the oracle the device
fixpoint is checked against.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from kolibrie_tpu_torch.core.rule import Rule
from kolibrie_tpu_torch.core.store import ColumnarTripleStore
from kolibrie_tpu_torch.core.terms import Term, TriplePattern
from kolibrie_tpu_torch.ops.join import (
    BindingTable,
    anti_join_tables,
    concat_tables,
    equi_join_tables,
    table_len,
)
from kolibrie_tpu_torch.ops.unique import unique_rows

Cols = Tuple[np.ndarray, np.ndarray, np.ndarray]


# --------------------------------------------------------------------------
# Pattern / body evaluation over columnar facts
# --------------------------------------------------------------------------


def scan_pattern_store(
    store: ColumnarTripleStore, pattern: TriplePattern, quoted=None
) -> BindingTable:
    """Match one premise against the fact store via its sorted orders."""
    consts = [
        t.value if t.is_constant else None
        for t in (pattern.subject, pattern.predicate, pattern.object)
    ]
    s, p, o = store.match(s=consts[0], p=consts[1], o=consts[2])
    return _bind_columns(pattern, s, p, o, quoted)


def scan_pattern_cols(cols: Cols, pattern: TriplePattern, quoted=None) -> BindingTable:
    """Match one premise against an explicit delta (s, p, o) column set."""
    s, p, o = cols
    mask = np.ones(len(s), dtype=bool)
    for t, c in zip((pattern.subject, pattern.predicate, pattern.object), (s, p, o)):
        if t.is_constant:
            mask &= c == t.value
    return _bind_columns(pattern, s[mask], p[mask], o[mask], quoted)


def _bind_columns(pattern: TriplePattern, s, p, o, quoted=None) -> BindingTable:
    terms = (pattern.subject, pattern.predicate, pattern.object)
    cols = [s, p, o]
    out: BindingTable = {}
    mask: Optional[np.ndarray] = None
    for t, c in zip(terms, cols):
        if t.is_variable:
            if t.value in out:  # repeated variable must agree
                m = out[t.value] == c
                mask = m if mask is None else (mask & m)
            else:
                out[t.value] = c
    if mask is not None:
        out = {k: v[mask] for k, v in out.items()}
        cols = [c[mask] for c in cols]
    # RDF-star premise positions: join against the quoted-triple store,
    # binding inner variables (mirrors engine.rs:1159 resolve_quoted_scan).
    # The qid columns ride inside the table so row alignment survives joins.
    quoted_positions = [i for i, t in enumerate(terms) if t.is_quoted]
    if quoted_positions:
        if quoted is None:
            raise ValueError("quoted premise pattern requires a quoted store")
        for pos in quoted_positions:
            out[f"__qt{pos}"] = cols[pos]
        for pos in quoted_positions:
            out = _join_quoted_position(quoted, out, f"__qt{pos}", terms[pos].value)
        for pos in quoted_positions:
            out.pop(f"__qt{pos}", None)
    if not out:
        # fully-constant pattern: presence row so the match count survives
        out["__exists"] = np.zeros(min(len(cols[0]), 1), dtype=np.uint32)
    return out


def _join_quoted_position(
    quoted, table: BindingTable, qid_col_name: str, inner: TriplePattern
) -> BindingTable:
    n = len(quoted)
    qid = np.empty(n, dtype=np.uint32)
    qcols = [np.empty(n, dtype=np.uint32) for _ in range(3)]
    for i, (q, (a, b, c)) in enumerate(quoted.items()):
        qid[i] = q
        qcols[0][i], qcols[1][i], qcols[2][i] = a, b, c
    m = np.ones(n, dtype=bool)
    qtab: BindingTable = {qid_col_name: qid}
    for part_col, t in zip(qcols, inner.terms()):
        if t.is_constant:
            m &= part_col == t.value
        elif t.is_quoted:
            raise NotImplementedError("doubly-nested quoted premise patterns")
    for part_col, t in zip(qcols, inner.terms()):
        if t.is_variable:
            if t.value in qtab:
                m &= qtab[t.value] == part_col
            else:
                qtab[t.value] = part_col
    qtab = {k: v[m] for k, v in qtab.items()}
    return equi_join_tables(table, qtab)


def _apply_rule_filters(reasoner, rule: Rule, table: BindingTable) -> BindingTable:
    """Vectorized filter pass (rules.rs:133-165 ``evaluate_filters``): each
    filter is evaluated once per DISTINCT id in its column (RDF columns are
    highly repetitive) and broadcast back with the unique-inverse map."""
    n = table_len(table)
    if n == 0 or not rule.filters:
        return table
    mask = np.ones(n, dtype=bool)
    decode = reasoner.dictionary.decode
    for f in rule.filters:
        col = table.get(f.variable)
        if col is None:
            mask[:] = False
            break
        uniq, inv = np.unique(col, return_inverse=True)
        verdicts = np.fromiter(
            (f.evaluate(int(u), decode) for u in uniq),
            dtype=bool,
            count=len(uniq),
        )
        mask &= verdicts[inv]
    return {k: v[mask] for k, v in table.items()}


def _apply_negative_premises(
    reasoner, rule: Rule, table: BindingTable, store: ColumnarTripleStore
) -> BindingTable:
    """NAF premises as anti-joins against the fact store.  A negated premise
    sharing NO variables with the bindings is an existence test: any match
    kills every row."""
    for neg in rule.negative_premise:
        neg_table = scan_pattern_store(store, neg, reasoner.quoted)
        shared = set(table) & set(neg_table) - {"__exists"}
        if not shared:
            if table_len(neg_table) > 0:
                table = {k: v[:0] for k, v in table.items()}
        else:
            table = anti_join_tables(table, neg_table)
        if table_len(table) == 0:
            break
    return table


def eval_rule_body(
    reasoner,
    rule: Rule,
    store: ColumnarTripleStore,
    delta: Optional[Cols] = None,
    old_store: Optional[ColumnarTripleStore] = None,
) -> BindingTable:
    """Bindings satisfying the rule body.

    With ``delta``: semi-naive expansion — union over premise positions i
    (semi_naive.rs:22-44).  Without ``old_store``, positions != i scan ALL
    facts (cheap, but the same derivation can appear in several expansions —
    harmless for set semantics since new facts are deduped).  With
    ``old_store`` (= facts \\ delta), positions < i scan old facts only, so
    every derivation appears EXACTLY once — required by non-idempotent
    provenance semirings where each derivation's tag is ⊕-merged.
    """
    k = len(rule.premise)
    if k == 0:
        return {}
    if delta is None or len(delta[0]) == 0:
        if delta is not None:
            return {}
        table: Optional[BindingTable] = None
        for prem in rule.premise:
            t = scan_pattern_store(store, prem, reasoner.quoted)
            table = t if table is None else equi_join_tables(table, t)
            if table_len(table) == 0:
                return table
        table = _apply_negative_premises(reasoner, rule, table, store)
        return _apply_rule_filters(reasoner, rule, table)
    parts: List[BindingTable] = []
    for i in range(k):
        table = None
        for j, prem in enumerate(rule.premise):
            if j == i:
                t = scan_pattern_cols(delta, prem, reasoner.quoted)
            elif j < i and old_store is not None:
                t = scan_pattern_store(old_store, prem, reasoner.quoted)
            else:
                t = scan_pattern_store(store, prem, reasoner.quoted)
            table = t if table is None else equi_join_tables(table, t)
            if table_len(table) == 0:
                table = None
                break
        if table is not None:
            parts.append(table)
    if not parts:
        return {}
    merged = concat_tables(parts) if len(parts) > 1 else parts[0]
    merged = _apply_negative_premises(reasoner, rule, merged, store)
    return _apply_rule_filters(reasoner, rule, merged)


def instantiate_conclusions(rule: Rule, table: BindingTable, quoted=None) -> Cols:
    """Substitute bindings into the (multi-head) conclusions → new triples."""
    n = table_len(table)

    def concl_col(t: Term):
        if t.is_variable:
            return table.get(t.value)
        if t.is_quoted:
            if quoted is None:
                return None
            inner = [concl_col(x) for x in t.value.terms()]
            if any(c is None for c in inner):
                return None
            col = np.empty(n, dtype=np.uint32)
            for i in range(n):
                col[i] = quoted.intern(
                    int(inner[0][i]), int(inner[1][i]), int(inner[2][i])
                )
            return col
        return np.full(n, t.value, dtype=np.uint32)

    out_s: List[np.ndarray] = []
    out_p: List[np.ndarray] = []
    out_o: List[np.ndarray] = []
    for concl in rule.conclusion:
        cols = []
        ok = True
        for t in (concl.subject, concl.predicate, concl.object):
            col = concl_col(t)
            if col is None:
                ok = False
                break
            cols.append(col)
        if ok:
            out_s.append(cols[0])
            out_p.append(cols[1])
            out_o.append(cols[2])
    if not out_s:
        z = np.empty(0, dtype=np.uint32)
        return z, z, z
    s = np.concatenate(out_s)
    p = np.concatenate(out_p)
    o = np.concatenate(out_o)
    (s, p, o), _ = unique_rows([s, p, o])
    return s, p, o


def subtract_existing(store: ColumnarTripleStore, cols: Cols) -> Cols:
    """Keep only rows not already in the store — vectorized membership:
    dense-rank the (s, p) pairs over both sides, pack with o into one u64
    key per row, then one sorted-membership probe (the host twin of
    ``ops.device_join._row_membership``)."""
    s, p, o = cols
    if len(s) == 0:
        return cols
    ss, sp, so = store.columns()
    if len(ss) == 0:
        return cols

    def pack2(a, b):
        return (a.astype(np.uint64) << np.uint64(32)) | b.astype(np.uint64)

    osp = pack2(s, p)
    tsp = pack2(ss, sp)
    sorted_u = np.sort(np.concatenate([osp, tsp]))
    rank_o = np.searchsorted(sorted_u, osp).astype(np.uint32)
    rank_t = np.searchsorted(sorted_u, tsp).astype(np.uint32)
    from kolibrie_tpu_torch.ops.join import semi_join_mask

    member = semi_join_mask(pack2(rank_o, o), pack2(rank_t, so))
    keep = ~member
    return s[keep], p[keep], o[keep]


# --------------------------------------------------------------------------
# Fixpoint loops (infer_generic.rs parity)
# --------------------------------------------------------------------------


def infer_naive(reasoner) -> int:
    """Every round joins every premise against ALL facts (my_naive.rs)."""
    total = 0
    while True:
        new_parts: List[Cols] = []
        for rule in reasoner.rules:
            table = eval_rule_body(reasoner, rule, reasoner.facts, delta=None)
            if table_len(table) == 0:
                continue
            cols = instantiate_conclusions(rule, table, reasoner.quoted)
            cols = subtract_existing(reasoner.facts, cols)
            if len(cols[0]):
                new_parts.append(cols)
        if not new_parts:
            return total
        s = np.concatenate([c[0] for c in new_parts])
        p = np.concatenate([c[1] for c in new_parts])
        o = np.concatenate([c[2] for c in new_parts])
        (s, p, o), _ = unique_rows([s, p, o])
        before = len(reasoner.facts)
        reasoner.facts.add_batch(s, p, o)
        added = len(reasoner.facts) - before
        if added == 0:
            return total
        total += added


def infer_semi_naive(reasoner) -> int:
    """Delta-driven fixpoint: round N only re-derives through facts added in
    round N-1 (semi_naive.rs:57-59 'delta = facts appended since last
    round')."""
    total = 0
    s, p, o = reasoner.facts.columns()
    delta: Cols = (s, p, o)  # first round: everything is new
    while len(delta[0]) > 0:
        new_parts: List[Cols] = []
        for rule in reasoner.rules:
            table = eval_rule_body(reasoner, rule, reasoner.facts, delta=delta)
            if table_len(table) == 0:
                continue
            cols = instantiate_conclusions(rule, table, reasoner.quoted)
            cols = subtract_existing(reasoner.facts, cols)
            if len(cols[0]):
                new_parts.append(cols)
        if not new_parts:
            break
        s = np.concatenate([c[0] for c in new_parts])
        p = np.concatenate([c[1] for c in new_parts])
        o = np.concatenate([c[2] for c in new_parts])
        (s, p, o), _ = unique_rows([s, p, o])
        before = len(reasoner.facts)
        reasoner.facts.add_batch(s, p, o)
        added = len(reasoner.facts) - before
        if added == 0:
            break
        total += added
        delta = (s, p, o)
    return total
