"""Fluent native query API over :class:`SparqlDatabase`.

Parity: ``kolibrie/src/query_builder.rs`` — subject/predicate/object filters
including like/starting/ending and custom closures (:180-259), joins on
s/p/o or a custom condition against a second database (:261-292), distinct /
order_by / desc / asc / limit / offset / count / group_by (:294-331,:442-470),
and streaming mode ``.window(width, slide).with_report_strategy(...)
.with_tick_strategy(...).with_stream_operator(...).as_stream()`` with
``add_stream_triple`` / ``get_stream_results`` (:624-751).

Rebuild notes: exact s/p/o filters are evaluated as
ID-compares over the columnar store (one ``Dictionary.lookup`` then a numpy
mask over the u32 columns); pattern filters
(contains/starts/ends) decode each column's *unique* IDs once and map the
string predicate over those, so string work is O(distinct terms) instead of
O(triples).  Joins hash the right side by key once instead of the reference's
nested loop.

Copy of ``kolibrie_tpu/query/builder.py`` for the PyTorch port (the
imports pointed at the port's ``rsp/``); it works on the database's host
columns, whatever its device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from kolibrie_tpu_torch.core.triple import Triple
from kolibrie_tpu_torch.rsp.r2s import Relation2StreamOperator, StreamOperator
from kolibrie_tpu_torch.rsp.s2r import ContentContainer, ReportStrategy, Tick, WindowTriple
from kolibrie_tpu_torch.rsp.window_runner import WindowRunner, WindowSpec


class TripleFilter:
    """One positional filter (query_builder.rs:75-82)."""

    EXACT = "exact"
    CONTAINS = "contains"
    STARTS_WITH = "starts_with"
    ENDS_WITH = "ends_with"

    def __init__(self, kind: str, value=None):
        self.kind = kind
        self.value = value

    def matches(self, s: str) -> bool:
        if self.kind == TripleFilter.EXACT:
            return s == self.value
        if self.kind == TripleFilter.CONTAINS:
            return self.value in s
        if self.kind == TripleFilter.STARTS_WITH:
            return s.startswith(self.value)
        if self.kind == TripleFilter.ENDS_WITH:
            return s.endswith(self.value)
        raise ValueError(f"unknown filter kind {self.kind!r}")


class JoinCondition:
    ON_SUBJECT = "subject"
    ON_PREDICATE = "predicate"
    ON_OBJECT = "object"


class QueryBuilder:
    """Chainable triple query; terminal methods return materialized results."""

    def __init__(self, db):
        self.db = db
        self._filters: Dict[str, Optional[TripleFilter]] = {
            "subject": None,
            "predicate": None,
            "object": None,
        }
        self._custom_filter: Optional[Callable[[Triple], bool]] = None
        self._join_db = None
        self._join_conditions: List = []
        self._distinct = False
        self._sort_key: Optional[Callable[[Triple], object]] = None
        self._sort_desc = False
        self._limit: Optional[int] = None
        self._offset: Optional[int] = None
        # Streaming state (query_builder.rs:624-751)
        self._window_spec: Optional[Tuple[int, int]] = None
        self._report_strategies: List[ReportStrategy] = []
        self._tick: str = Tick.TIME_DRIVEN
        self._stream_operator: Optional[str] = None
        self._r2s: Optional[Relation2StreamOperator] = None
        self._runner: Optional[WindowRunner] = None
        self._pending: List[ContentContainer] = []
        self._stream_results: List[List[Triple]] = []
        self._current_ts = 0
        self.streaming = False

    # ------------------------------------------------------------ filters

    def _set(self, pos: str, kind: str, value) -> "QueryBuilder":
        self._filters[pos] = TripleFilter(kind, value)
        return self

    def with_subject(self, subject: str) -> "QueryBuilder":
        return self._set("subject", TripleFilter.EXACT, subject)

    def with_subject_like(self, pattern: str) -> "QueryBuilder":
        return self._set("subject", TripleFilter.CONTAINS, pattern)

    def with_subject_starting(self, prefix: str) -> "QueryBuilder":
        return self._set("subject", TripleFilter.STARTS_WITH, prefix)

    def with_subject_ending(self, suffix: str) -> "QueryBuilder":
        return self._set("subject", TripleFilter.ENDS_WITH, suffix)

    def with_predicate(self, predicate: str) -> "QueryBuilder":
        return self._set("predicate", TripleFilter.EXACT, predicate)

    def with_predicate_like(self, pattern: str) -> "QueryBuilder":
        return self._set("predicate", TripleFilter.CONTAINS, pattern)

    def with_predicate_starting(self, prefix: str) -> "QueryBuilder":
        return self._set("predicate", TripleFilter.STARTS_WITH, prefix)

    def with_predicate_ending(self, suffix: str) -> "QueryBuilder":
        return self._set("predicate", TripleFilter.ENDS_WITH, suffix)

    def with_object(self, obj: str) -> "QueryBuilder":
        return self._set("object", TripleFilter.EXACT, obj)

    def with_object_like(self, pattern: str) -> "QueryBuilder":
        return self._set("object", TripleFilter.CONTAINS, pattern)

    def with_object_starting(self, prefix: str) -> "QueryBuilder":
        return self._set("object", TripleFilter.STARTS_WITH, prefix)

    def with_object_ending(self, suffix: str) -> "QueryBuilder":
        return self._set("object", TripleFilter.ENDS_WITH, suffix)

    def filter(self, predicate: Callable[[Triple], bool]) -> "QueryBuilder":
        self._custom_filter = predicate
        return self

    # -------------------------------------------------------------- joins

    def join(self, other) -> "QueryBuilder":
        self._join_db = other
        return self

    def join_on_subject(self) -> "QueryBuilder":
        self._join_conditions.append(JoinCondition.ON_SUBJECT)
        return self

    def join_on_predicate(self) -> "QueryBuilder":
        self._join_conditions.append(JoinCondition.ON_PREDICATE)
        return self

    def join_on_object(self) -> "QueryBuilder":
        self._join_conditions.append(JoinCondition.ON_OBJECT)
        return self

    def join_with(self, condition: Callable[[Triple, Triple], bool]) -> "QueryBuilder":
        self._join_conditions.append(condition)
        return self

    # ----------------------------------------------------------- modifiers

    def distinct(self) -> "QueryBuilder":
        self._distinct = True
        return self

    def order_by(self, key: Callable[[Triple], object]) -> "QueryBuilder":
        self._sort_key = key
        return self

    def desc(self) -> "QueryBuilder":
        self._sort_desc = True
        return self

    def asc(self) -> "QueryBuilder":
        self._sort_desc = False
        return self

    def limit(self, n: int) -> "QueryBuilder":
        self._limit = n
        return self

    def offset(self, n: int) -> "QueryBuilder":
        self._offset = n
        return self

    # ----------------------------------------------------------- execution

    def _column_mask(self, pos: str, ids: np.ndarray) -> Optional[np.ndarray]:
        """Mask for one positional filter over an ID column (vectorized)."""
        filt = self._filters[pos]
        if filt is None:
            return None
        if filt.kind == TripleFilter.EXACT:
            # Exact match never needs string decode: one lookup, one compare.
            tid = self.db.lookup_term_str(filt.value)
            if tid is None:
                return np.zeros(len(ids), dtype=bool)
            return ids == np.uint32(tid)
        uniq, inverse = np.unique(ids, return_inverse=True)
        keep = np.fromiter(
            (filt.matches(self.db.decode_term(int(u)) or "") for u in uniq),
            dtype=bool,
            count=len(uniq),
        )
        return keep[inverse]

    def _matching_triples(self) -> List[Triple]:
        s, p, o = self.db.store.columns()
        mask = np.ones(len(s), dtype=bool)
        for pos, col in (("subject", s), ("predicate", p), ("object", o)):
            m = self._column_mask(pos, col)
            if m is not None:
                mask &= m
        idx = np.nonzero(mask)[0]
        triples = [Triple(int(s[i]), int(p[i]), int(o[i])) for i in idx]
        if self._custom_filter is not None:
            triples = [t for t in triples if self._custom_filter(t)]
        return triples

    def _apply_join(self, left: List[Triple]) -> List[Triple]:
        """Hash-join against the second DB (reference semantics: the output
        triple mixes left/right fields per condition, query_builder.rs:562-618).

        If the two databases do not share a dictionary, the right side is
        re-encoded into the left dictionary first — raw IDs from different
        dictionaries are not comparable."""
        if self._join_db.dictionary is self.db.dictionary:
            right = list(self._join_db.store)
        else:
            enc = self.db.encode_term_str
            rdec = self._join_db.decode_term
            right = [
                Triple(
                    enc(rdec(t.subject) or ""),
                    enc(rdec(t.predicate) or ""),
                    enc(rdec(t.object) or ""),
                )
                for t in self._join_db.store
            ]
        out = set()
        for cond in self._join_conditions:
            if callable(cond):
                for lt in left:
                    for rt in right:
                        if cond(lt, rt):
                            out.add(Triple(lt.subject, rt.predicate, rt.object))
                continue
            table: Dict[int, List[Triple]] = {}
            keyget = {
                JoinCondition.ON_SUBJECT: lambda t: t.subject,
                JoinCondition.ON_PREDICATE: lambda t: t.predicate,
                JoinCondition.ON_OBJECT: lambda t: t.object,
            }[cond]
            for rt in right:
                table.setdefault(keyget(rt), []).append(rt)
            keep_left_pred = cond != JoinCondition.ON_OBJECT
            for lt in left:
                for rt in table.get(keyget(lt), ()):
                    pred = lt.predicate if keep_left_pred else rt.predicate
                    out.add(Triple(lt.subject, pred, rt.object))
        return sorted(out)

    def get_triples(self) -> List[Triple]:
        """Materialize: ordered unique triples (the reference's BTreeSet)."""
        if self.streaming:
            return []
        results = sorted(set(self._matching_triples()))
        if self._join_db is not None and self._join_conditions:
            results = self._apply_join(results)
        if self._sort_key is not None:
            results.sort(key=self._sort_key, reverse=self._sort_desc)
        if self._offset is not None or self._limit is not None:
            start = self._offset or 0
            end = start + self._limit if self._limit is not None else None
            results = results[start:end]
        return results

    def _decode(self, tid: int) -> str:
        return self.db.decode_term(tid) or ""

    def get_decoded_triples(self) -> List[Tuple[str, str, str]]:
        return [
            (self._decode(t.subject), self._decode(t.predicate), self._decode(t.object))
            for t in self.get_triples()
        ]

    def _get_position(self, getter) -> List[str]:
        vals = [self._decode(getter(t)) for t in self.get_triples()]
        if self._distinct:
            vals = sorted(set(vals))
        return vals

    def get_subjects(self) -> List[str]:
        return self._get_position(lambda t: t.subject)

    def get_predicates(self) -> List[str]:
        return self._get_position(lambda t: t.predicate)

    def get_objects(self) -> List[str]:
        return self._get_position(lambda t: t.object)

    def count(self) -> int:
        return len(self.get_triples())

    def group_by(self, key_fn: Callable[[Triple], object]) -> Dict[object, List[Triple]]:
        groups: Dict[object, List[Triple]] = {}
        for t in self.get_triples():
            groups.setdefault(key_fn(t), []).append(t)
        return dict(sorted(groups.items(), key=lambda kv: kv[0]))

    # ----------------------------------------------------------- streaming

    def window(self, width: int, slide: int) -> "QueryBuilder":
        self._window_spec = (width, slide)
        return self

    def with_report_strategy(self, strategy) -> "QueryBuilder":
        if isinstance(strategy, str):
            strategy = ReportStrategy.from_name(strategy)
        self._report_strategies.append(strategy)
        return self

    def with_tick_strategy(self, tick: str) -> "QueryBuilder":
        self._tick = tick
        return self

    def with_stream_operator(self, operator: str) -> "QueryBuilder":
        self._stream_operator = operator
        return self

    def as_stream(self) -> "QueryBuilder":
        if self._window_spec is not None:
            width, slide = self._window_spec
            spec = WindowSpec(
                window_iri="builder", stream_iri="builder", width=width, slide=slide,
                tick=self._tick,
            )
            self._runner = WindowRunner(spec)
            if self._report_strategies:
                report = self._runner.window.report
                report.strategies = list(self._report_strategies)
            self._runner.register_callback(self._pending.append)
        if self._stream_operator is not None:
            self._r2s = Relation2StreamOperator(self._stream_operator, self._current_ts)
        self.streaming = True
        return self

    def add_stream_triple(self, subject: str, predicate: str, obj: str, timestamp: int) -> None:
        if not self.streaming:
            raise RuntimeError("Query not in streaming mode. Call as_stream() first.")
        if self._runner is None:
            raise RuntimeError("No window configured for streaming.")
        self._runner.add_to_window(WindowTriple(subject, predicate, obj), timestamp)
        self._current_ts = timestamp

    @classmethod
    def _norm_term_text(cls, term: str) -> str:
        """Text-level counterpart of encode_term_str normalization: strip
        surrounding ``<...>`` and recursively normalize each component of
        ``<< s p o >>`` (so bracketed and bare spellings compare equal)."""
        from kolibrie_tpu_torch.query.sparql_database import split_quoted_triple_content

        term = term.strip()
        if term.startswith("<<") and term.endswith(">>"):
            parts = split_quoted_triple_content(term[2:-2].strip())
            return "<< " + " ".join(cls._norm_term_text(p) for p in parts) + " >>"
        if term.startswith("<") and term.endswith(">"):
            return term[1:-1]
        return term

    def _execute_on_window_content(self, content: ContentContainer) -> List[Triple]:
        """Apply the configured s/p/o filters to the window's string triples
        and intern matches into the database dictionary (query_builder.rs:757+).

        Filters run BEFORE interning so rejected stream triples never grow
        the dictionary; exact filters compare normalized text so they agree
        with the static path's ID-based semantics."""
        out = []
        norm_exact = {
            pos: self._norm_term_text(f.value)
            for pos, f in self._filters.items()
            if f is not None and f.kind == TripleFilter.EXACT
        }
        enc = self.db.encode_term_str
        for wt in content:
            ok = True
            for pos, val in (("subject", wt.s), ("predicate", wt.p), ("object", wt.o)):
                filt = self._filters[pos]
                if filt is None:
                    continue
                if filt.kind == TripleFilter.EXACT:
                    if self._norm_term_text(val) != norm_exact[pos]:
                        ok = False
                        break
                elif not filt.matches(self._norm_term_text(val)):
                    ok = False
                    break
            if not ok:
                continue
            t = Triple(enc(wt.s), enc(wt.p), enc(wt.o))
            if self._custom_filter is None or self._custom_filter(t):
                out.append(t)
        return out

    def get_stream_results(self) -> List[List[Triple]]:
        if not self.streaming or self._runner is None:
            return []
        pending, self._pending = self._pending, []
        results = []
        for content in pending:
            window_results = self._execute_on_window_content(content)
            if self._r2s is not None:
                emitted = self._r2s.eval(window_results, self._current_ts)
                if emitted:
                    results.append(emitted)
            elif window_results:
                results.append(window_results)
        self._stream_results.extend(results)
        return results

    def get_all_stream_results(self) -> List[List[Triple]]:
        return list(self._stream_results)

    def clear_stream_results(self) -> None:
        self._stream_results.clear()

    def stop_stream(self) -> None:
        if self._runner is not None:
            self._runner.stop()
        self.streaming = False

    def is_streaming(self) -> bool:
        return self.streaming
