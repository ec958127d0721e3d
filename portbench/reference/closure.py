"""Plain NumPy semi-naive fixpoint: the reference for a materialisation.

Each round joins every rule's premises with one premise taken from the
last round's new facts (each position in turn) and the others from every
fact known, instantiates the conclusion, and keeps the facts not known
yet.  It ends when a round finds none.  Facts are kept as sorted unique
int64 keys ``(s * P + rank(p)) * N + o``, so the key order is the (s, p, o)
order the program's store keeps."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from portbench.reference.store import ByPredicate, evaluate


def lower_rules(rules: Sequence[dict], ids: Dict[str, int]) -> List[Tuple[list, tuple]]:
    """Rules of expanded string terms (``?x`` a variable) as
    ``(premises, conclusion)`` of ``("var", name)`` / ``("id", int)``."""

    def term(t: str):
        return ("var", t[1:]) if t.startswith("?") else ("id", ids[t])

    out = []
    for r in rules:
        prem = [tuple(term(t) for t in pt) for pt in r["if"]]
        for pt in prem:
            if all(k == "id" for k, _ in pt):
                raise ValueError("a ground premise")
        out.append((prem, tuple(term(t) for t in r["then"])))
    return out


class KeyCodec:
    """The (s, p, o) <-> int64 key packing over ``n_terms`` IDs and the
    predicates the facts and the rule heads can hold."""

    def __init__(self, n_terms: int, predicates: np.ndarray):
        self.n = int(n_terms)
        self.preds = np.unique(np.asarray(predicates, dtype=np.int64))
        if (self.n * len(self.preds) + len(self.preds)) * self.n >= 1 << 62:
            raise OverflowError("too many terms for one int64 key")

    def encode(self, s, p, o) -> np.ndarray:
        s, p, o = (np.asarray(c, dtype=np.int64) for c in (s, p, o))
        pr = np.searchsorted(self.preds, p)
        bad = (pr >= len(self.preds)) | (s >= self.n) | (o >= self.n)
        if bad.any():
            raise ValueError(f"{int(bad.sum())} facts outside the codec")
        if (self.preds[pr] != p).any():
            raise ValueError("a predicate outside the codec")
        return (s * len(self.preds) + pr) * self.n + o

    def decode(self, keys: np.ndarray):
        so, o = np.divmod(keys, self.n)
        s, pr = np.divmod(so, len(self.preds))
        return s, self.preds[pr], o


def closure(n_terms: int, s, p, o, rules: List[Tuple[list, tuple]],
            max_rounds: Optional[int] = None):
    """The fixpoint of ``rules`` over the facts ``(s, p, o)``: returns
    ``(codec, keys)``, every fact's key sorted.  ``max_rounds`` stops it
    early (the control's incomplete closure)."""
    heads = [h[1][1] for _, h in rules if h[1][0] == "id"]
    if any(h[1][0] == "var" for _, h in rules):
        heads = list(range(n_terms))
    codec = KeyCodec(n_terms, np.concatenate([np.asarray(p, np.int64), np.asarray(heads, np.int64)]))
    known = np.unique(codec.encode(s, p, o))
    every = ByPredicate(*codec.decode(known))
    delta = every
    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        found = []
        for prem, head in rules:
            for i in range(len(prem)):
                b = evaluate(prem, every, first=i, first_source=delta)
                n = len(next(iter(b.values())))
                if not n:
                    continue
                cols = [b[v] if k == "var" else np.full(n, v, np.int64) for k, v in head]
                found.append(codec.encode(*cols))
        if not found:
            break
        new = np.unique(np.concatenate(found))
        pos = np.searchsorted(known, new)
        fresh = new[(pos >= len(known)) | (known[np.minimum(pos, len(known) - 1)] != new)]
        if not len(fresh):
            break
        known = np.insert(known, np.searchsorted(known, fresh), fresh)
        ds, dp, do = codec.decode(fresh)
        every.add(ds, dp, do)
        delta = ByPredicate(ds, dp, do)
        rounds += 1
    return codec, known
