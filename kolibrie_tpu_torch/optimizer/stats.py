"""Sampled database statistics for cardinality estimation.

Parity: ``streamertail_optimizer/stats/database_stats.rs:18-105`` —
``gather_stats_fast``: ≤100k step-sampled triples, scaled-up per-term
cardinality maps, and a join-selectivity cache.  Counting is vectorized
(np.unique) rather than rayon-folded.
"""

from __future__ import annotations

import weakref
from typing import Dict

import numpy as np

SAMPLE_CAP = 100_000


class DatabaseStats:
    def __init__(self) -> None:
        self.total_triples = 0
        self.quoted_triple_count = 0
        self.distinct_subjects = 0
        self.distinct_predicates = 0
        self.distinct_objects = 0
        self.predicate_counts: Dict[int, float] = {}
        self.subject_counts: Dict[int, float] = {}
        self.object_counts: Dict[int, float] = {}
        self.join_selectivity_cache: Dict[int, float] = {}
        self._db_ref = None  # weakref to the sampled database

    def database(self):
        """The database these stats were sampled from (None for
        hand-built stats or after the database was collected) — the
        stats-advisor's host-oracle exploration needs a store to count
        against (docs/OPTIMIZER.md)."""
        return self._db_ref() if self._db_ref is not None else None

    @staticmethod
    def gather_stats_fast(db) -> "DatabaseStats":
        st = DatabaseStats()
        st._db_ref = weakref.ref(db)
        s, p, o = db.store.columns()
        n = len(s)
        st.total_triples = n
        st.quoted_triple_count = len(getattr(db, "quoted", ()) or ())
        if n == 0:
            return st
        if n > SAMPLE_CAP:
            step = n // SAMPLE_CAP
            idx = np.arange(0, n, step)
            scale = n / len(idx)
            s, p, o = s[idx], p[idx], o[idx]
        else:
            scale = 1.0
        us, cs = np.unique(s, return_counts=True)
        up, cp = np.unique(p, return_counts=True)
        uo, co = np.unique(o, return_counts=True)
        st.distinct_subjects = int(len(us) * scale) if scale > 1 else len(us)
        st.distinct_predicates = len(up)
        st.distinct_objects = int(len(uo) * scale) if scale > 1 else len(uo)
        st.subject_counts = dict(zip(us.tolist(), (cs * scale).tolist()))
        st.predicate_counts = dict(zip(up.tolist(), (cp * scale).tolist()))
        st.object_counts = dict(zip(uo.tolist(), (co * scale).tolist()))
        return st

    # ------------------------------------------------------------ estimates

    def pattern_cardinality(self, pattern) -> float:
        """Estimated matching rows for a triple pattern (constant positions
        narrow the estimate multiplicatively, mirroring estimator.rs:194+)."""
        n = float(max(self.total_triples, 1))
        est = n
        s, p, o = pattern.subject, pattern.predicate, pattern.object
        if s.kind == "id":
            est = min(est, self.subject_counts.get(s.value, 1.0))
        if p.kind == "id":
            est = min(est, self.predicate_counts.get(p.value, 1.0))
        if o.kind == "id":
            est = min(est, self.object_counts.get(o.value, 1.0))
        return max(est, 0.0)

    def join_selectivity(self, card_left: float, card_right: float) -> float:
        """Crude independence assumption over the larger distinct-value side
        (fallback when neither join side has a bound predicate)."""
        denom = max(self.distinct_subjects + self.distinct_objects, 1)
        return 1.0 / denom

    def get_join_selectivity(self, predicate: int) -> float:
        """Cached per-predicate selectivity = |pred| / |db|
        (``database_stats.rs:129-153`` ``get_join_selectivity``)."""
        cached = self.join_selectivity_cache.get(predicate)
        if cached is not None:
            return cached
        if self.total_triples > 0:
            sel = self.predicate_counts.get(predicate, 0.0) / self.total_triples
        else:
            sel = 0.1
        self.join_selectivity_cache[predicate] = sel
        return sel

    # --------------------------------------------- incremental maintenance

    def update_stats(self, s: int, p: int, o: int) -> None:
        """Count one added triple (``database_stats.rs:156-165`` parity
        API).  The engine itself rebuilds stats per store version
        (``SparqlDatabase.get_or_build_stats``); this keeps a LONG-LIVED
        stats object coherent across small mutation batches — including
        the distinct counts the independence-fallback selectivity uses."""
        self.total_triples += 1
        for counts, key, attr in (
            (self.subject_counts, s, "distinct_subjects"),
            (self.predicate_counts, p, "distinct_predicates"),
            (self.object_counts, o, "distinct_objects"),
        ):
            prev = counts.get(key, 0.0)
            if prev <= 0:
                setattr(self, attr, getattr(self, attr) + 1)
            counts[key] = prev + 1.0
        self.join_selectivity_cache.clear()

    def remove_stats(self, s: int, p: int, o: int) -> None:
        """Uncount one removed triple (``database_stats.rs:168-193``)."""
        self.total_triples = max(self.total_triples - 1, 0)
        for counts, key, attr in (
            (self.subject_counts, s, "distinct_subjects"),
            (self.predicate_counts, p, "distinct_predicates"),
            (self.object_counts, o, "distinct_objects"),
        ):
            v = counts.get(key)
            if v is not None and v > 0:
                counts[key] = v - 1.0
                if v - 1.0 <= 0:
                    setattr(self, attr, max(getattr(self, attr) - 1, 0))
        self.join_selectivity_cache.clear()
