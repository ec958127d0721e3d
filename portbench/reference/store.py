"""Facts by predicate, and the sort-merge join the reference is made of."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def display_form(term: Optional[str]) -> str:
    """How an answer shows a term: a literal without its quotes, an IRI
    bare."""
    if not term:
        return ""
    if term[0] == '"':
        end = term.rfind('"')
        if end > 0:
            return term[1:end]
    return term


def seg_local(counts: np.ndarray) -> np.ndarray:
    starts = np.cumsum(counts) - counts
    return np.arange(int(counts.sum()), dtype=np.int64) - np.repeat(starts, counts)


class ByPredicate:
    """Fact columns split by predicate ID: ``parts[p] = (s, o)``."""

    def __init__(self, s: np.ndarray, p: np.ndarray, o: np.ndarray):
        s, p, o = (np.asarray(c, dtype=np.int64) for c in (s, p, o))
        order = np.argsort(p, kind="stable")
        s, p, o = s[order], p[order], o[order]
        preds, starts = np.unique(p, return_index=True)
        ends = np.append(starts[1:], len(p))
        self.parts: Dict[int, Tuple[np.ndarray, np.ndarray]] = {
            int(q): (s[a:b], o[a:b]) for q, a, b in zip(preds, starts, ends)
        }

    def add(self, s: np.ndarray, p: np.ndarray, o: np.ndarray) -> None:
        for q in np.unique(p).tolist():
            m = p == q
            old = self.parts.get(q)
            if old is None:
                self.parts[q] = (s[m], o[m])
            else:
                self.parts[q] = (np.concatenate([old[0], s[m]]), np.concatenate([old[1], o[m]]))

    def match(self, pattern) -> Dict[str, np.ndarray]:
        """Bindings of one triple pattern: ``pattern`` is three terms, each
        ``("var", name)`` or ``("id", int)``."""
        (ks, vs), (kp, vp), (ko, vo) = pattern
        if kp == "id":
            s, o = self.parts.get(vp, (np.empty(0, np.int64), np.empty(0, np.int64)))
            p = np.full(len(s), vp, dtype=np.int64)
        else:
            items = sorted(self.parts.items())
            s = np.concatenate([v[0] for _, v in items]) if items else np.empty(0, np.int64)
            o = np.concatenate([v[1] for _, v in items]) if items else np.empty(0, np.int64)
            p = np.concatenate([np.full(len(v[0]), k, np.int64) for k, v in items]) if items else np.empty(0, np.int64)
        cols = {"s": s, "p": p, "o": o}
        m = np.ones(len(s), dtype=bool)
        bound: Dict[str, str] = {}
        for pos, (kind, val) in zip("spo", pattern):
            if kind == "id":
                m &= cols[pos] == val
            elif val in bound:
                m &= cols[pos] == cols[bound[val]]
            else:
                bound[val] = pos
        return {v: cols[pos][m] for v, pos in bound.items()}


def _table_len(t: Dict[str, np.ndarray]) -> int:
    return len(next(iter(t.values()))) if t else 0


def join_keys(left: Sequence[np.ndarray], right: Sequence[np.ndarray]):
    """One int64 key a row from one or more ID columns, equal on both sides
    exactly when the rows are."""
    kl, kr = left[0], right[0]
    for a, b in zip(left[1:], right[1:]):
        # dense ranks of the key so far, then the next column beside them
        _, inv = np.unique(np.concatenate([kl, kr]), return_inverse=True)
        both = inv.astype(np.int64) * (1 << 32) + np.concatenate([a, b])
        kl, kr = both[: len(kl)], both[len(kl):]
    return kl, kr


def join(left: Dict[str, np.ndarray], right: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Sort-merge equi-join of two binding tables on their shared
    variables (a cartesian product when they share none)."""
    shared = [v for v in left if v in right]
    nl, nr = _table_len(left), _table_len(right)
    if shared:
        kl, kr = join_keys([left[v] for v in shared], [right[v] for v in shared])
    else:
        kl, kr = np.zeros(nl, np.int64), np.zeros(nr, np.int64)
    order = np.argsort(kr, kind="stable")
    krs = kr[order]
    lo = np.searchsorted(krs, kl, "left")
    cnt = np.searchsorted(krs, kl, "right") - lo
    li = np.repeat(np.arange(nl, dtype=np.int64), cnt)
    ri = order[np.repeat(lo, cnt) + seg_local(cnt)]
    out = {v: c[li] for v, c in left.items()}
    for v, c in right.items():
        if v not in out:
            out[v] = c[ri]
    return out


def evaluate(patterns: List[tuple], source: ByPredicate, first: Optional[int] = None,
             first_source: Optional[ByPredicate] = None) -> Dict[str, np.ndarray]:
    """Bindings of a conjunction of patterns: ``first`` (matched against
    ``first_source``, the semi-naive delta) or the pattern with the fewest
    matches starts; then each step joins the connected pattern with the
    fewest matches."""
    tables = [source.match(pt) for pt in patterns]
    if first is None:
        first = min(range(len(patterns)), key=lambda i: _table_len(tables[i]))
    else:
        tables[first] = (first_source or source).match(patterns[first])
    acc = tables[first]
    left = [i for i in range(len(patterns)) if i != first]
    while left and _table_len(acc):
        linked = [i for i in left if set(tables[i]) & set(acc)] or left
        nxt = min(linked, key=lambda i: _table_len(tables[i]))
        acc = join(acc, tables[nxt])
        left.remove(nxt)
    if left:  # an empty table ends the conjunction early
        for i in left:
            for v in tables[i]:
                acc.setdefault(v, np.empty(0, np.int64))
        acc = {v: c[:0] for v, c in acc.items()}
    return acc
