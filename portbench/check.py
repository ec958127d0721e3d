"""How ``correct`` is decided: what the timed path produced, held against
the plain reference once the window has closed.  This module holds what
every loop's judge shares: the reference's view of a cell's data and the
comparisons.  Each loop (``loops/<loop>.py``) names the numbers it
compares, with their limits, in ``LIMITS``, computes them in ``judge``,
and puts its control, a weakened reference, in the program's place in
``control``; the control has to come out not correct."""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional

import numpy as np

from portbench import spec
from portbench.reference import bgp, closure
from portbench.reference.store import ByPredicate


class Reference:
    """The reference's view of one cell's data: the fixpoint when the
    configuration reasons, facts by predicate, and answers by text."""

    def __init__(self, config: dict, g, rounds: Optional[int] = None,
                 lose_every: Optional[int] = None):
        self.terms = g.terms
        self.ids = {t: i for i, t in enumerate(g.terms) if t is not None}
        rules = spec.rules(config)
        self.codec = None
        if rules:
            lowered = closure.lower_rules(rules, self.ids)
            self.codec, self.keys = closure.closure(
                len(g.terms), g.s, g.p, g.o, lowered, max_rounds=rounds)
            self.source_cols = self.codec.decode(self.keys)
        else:
            self.source_cols = (g.s, g.p, g.o)
        if lose_every:
            keep = np.arange(len(self.source_cols[0])) % lose_every != lose_every - 1
            self.source_cols = tuple(np.asarray(c)[keep] for c in self.source_cols)
        self._source = None
        self._answers: Dict[str, Counter] = {}

    @property
    def source(self) -> ByPredicate:
        if self._source is None:
            self._source = ByPredicate(*self.source_cols)
        return self._source

    def rows(self, text: str) -> List[tuple]:
        return bgp.answer(text, self.source, self.ids, self.terms)

    def answer(self, text: str) -> Counter:
        got = self._answers.get(text)
        if got is None:
            got = self._answers[text] = Counter(self.rows(text))
        return got

    def fact_mismatch(self, cols) -> int:
        """Facts of ``cols`` (s, p, o) not in the fixpoint, plus fixpoint
        facts not in ``cols``."""
        s, p, o = (np.asarray(c, dtype=np.int64) for c in cols)
        c = self.codec
        inside = (s < c.n) & (o < c.n) & np.isin(p, c.preds)
        keys = c.encode(s[inside], p[inside], o[inside])
        if inside.all() and np.array_equal(keys, self.keys):
            return 0  # the store's columns are sorted and unique, as the keys
        keys = np.unique(keys)
        return int((~inside).sum()) + len(np.setxor1d(keys, self.keys, assume_unique=True))


def bag_mismatch(rows, want: Counter) -> int:
    got = Counter(map(tuple, rows or ()))
    return sum(((got - want) + (want - got)).values())


def verdict(vals: Dict[str, int], limits: Dict[str, int]) -> Dict[str, dict]:
    """The numbers compared, each beside its limit."""
    return {k: {"value": v, "limit": limits[k]} for k, v in vals.items()}


def correct(checks: Dict[str, dict]) -> bool:
    return all(v["value"] <= v["limit"] for v in checks.values())
