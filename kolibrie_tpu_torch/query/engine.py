"""QueryEngine facade — load + query + explain + stats.

Parity: ``kolibrie/src/query_engine.rs:17-158`` — ``QueryEngine`` (new /
load_ntriples_to_memory / add_triple / query via the Volcano path),
``explain`` with ``StorageMode`` Static/Streaming/Hybrid decided by keyword
detection (:117-156), and ``QueryEngineStats`` (:114-116).

Port of ``kolibrie_tpu/query/engine.py``: the facade's database runs on
``device`` (the CUDA card unless the caller passes another).
:meth:`QueryEngine.explain_device` raises until ROADMAP A7 brings the
lowered plan's host twin.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional

from kolibrie_tpu_torch.backend import DeviceLike

from kolibrie_tpu_torch.query.executor import execute_query_volcano
from kolibrie_tpu_torch.query.sparql_database import SparqlDatabase


class StorageMode:
    STATIC = "Static"
    STREAMING = "Streaming"
    HYBRID = "Hybrid"


@dataclass
class QueryExplanation:
    storage_mode: str
    will_use_volcano: bool
    has_windowing: bool
    window_clauses: List[str] = field(default_factory=list)


@dataclass
class QueryEngineStats:
    memory_triple_count: int


_WINDOWING_KEYWORDS = (
    "WINDOW", "FROM NAMED WINDOW", "SLIDING", "TUMBLING", "RANGE",
    "RSTREAM", "ISTREAM", "DSTREAM", "SLIDE",
)

# Keywords must be standalone tokens: not part of a larger word, not the
# local part of a prefixed name (ex:range), not a variable (?range) — and
# IRIs, string literals, and # comments are scrubbed before matching.
_WINDOWING_RE = re.compile(
    r"(?<![\w:?$])("
    + "|".join(re.escape(k) for k in _WINDOWING_KEYWORDS)
    + r")(?![\w:])"
)
_SCRUB_RE = re.compile(
    r"""<[^>\s]*>              # IRIs
      | "(?:[^"\\]|\\.)*"      # double-quoted literals
      | '(?:[^'\\]|\\.)*'      # single-quoted literals
      | \#[^\n]*               # comments
    """,
    re.VERBOSE,
)


def _scrub(query: str) -> str:
    """Blank out IRIs, literals and comments so keyword detection only sees
    real syntax."""
    return _SCRUB_RE.sub(" ", query)


def has_windowing_operations(query: str) -> bool:
    return _WINDOWING_RE.search(_scrub(query).upper()) is not None


_RSPQL_RE = re.compile(
    r"(?<![\w:?$])REGISTER\s+(R|I|D)STREAM(?![\w:])", re.IGNORECASE
)


def is_rspql_query(query: str) -> bool:
    return _RSPQL_RE.search(_scrub(query)) is not None


def extract_window_clauses(query: str) -> List[str]:
    clauses = []
    start = query.upper().find("FROM NAMED WINDOW")
    if start >= 0:
        remaining = query[start:]
        end = remaining.upper().find("WHERE")
        clauses.append((remaining[:end] if end >= 0 else remaining).strip())
    return clauses


class QueryEngine:
    """Simple facade: an in-memory database plus the Volcano query path."""

    def __init__(self, db: Optional[SparqlDatabase] = None, device: DeviceLike = None) -> None:
        self.db = db if db is not None else SparqlDatabase(device)

    def load_ntriples_to_memory(self, data: str) -> int:
        return self.db.parse_ntriples(data)

    def load_turtle_to_memory(self, data: str) -> int:
        return self.db.parse_turtle(data)

    def add_triple(self, subject: str, predicate: str, obj: str) -> None:
        self.db.add_triple_parts(subject, predicate, obj)

    def query(self, sparql: str) -> List[List[str]]:
        return execute_query_volcano(sparql, self.db)

    def explain(self, sparql: str) -> QueryExplanation:
        windowing = has_windowing_operations(sparql)
        rspql = is_rspql_query(sparql)
        if rspql:
            mode = StorageMode.STREAMING
        elif windowing:
            mode = StorageMode.HYBRID
        else:
            mode = StorageMode.STATIC
        return QueryExplanation(
            storage_mode=mode,
            will_use_volcano=not rspql,
            has_windowing=windowing,
            window_clauses=extract_window_clauses(sparql),
        )

    def stats(self) -> QueryEngineStats:
        return QueryEngineStats(memory_triple_count=len(self.db))

    def explain_device(self, sparql: str, exact_counts: bool = True,
                       analyze: bool = False) -> str:
        """Physical-plan EXPLAIN of the device engine: the Streamertail plan
        lowered to its spec tree, rendered with scan orders + live range
        sizes, join keys + capacities, filters, quoted expansions and the
        final projection.  ``exact_counts`` also runs the host twin to
        annotate each join with its true match count (no device I/O).
        Returns a 'host path: <reason>' line when the plan does not lower.

        ``analyze=True`` is EXPLAIN ANALYZE: the lowered plan runs once
        under an analyze capture, and the tree is annotated with
        per-operator actual row counts, cap occupancy percentages and the
        per-stage wall times of the run's spans."""
        from kolibrie_tpu_torch.obs import analyze as obs_analyze
        from kolibrie_tpu_torch.obs.spans import spans_snapshot, trace_scope
        from kolibrie_tpu_torch.optimizer import mqo
        from kolibrie_tpu_torch.optimizer import stats_advisor as _sa
        from kolibrie_tpu_torch.optimizer.device_engine import Unsupported, lower_plan
        from kolibrie_tpu_torch.optimizer.engine import resolve_pattern
        from kolibrie_tpu_torch.optimizer.planner import Streamertail, build_logical_plan
        from kolibrie_tpu_torch.query.executor import _clause_plans
        from kolibrie_tpu_torch.query.parser import parse_combined_query
        from kolibrie_tpu_torch.query.subquery_inline import inline_subqueries
        from kolibrie_tpu_torch.query.template import fingerprint_query

        self.db.register_prefixes_from_query(sparql)
        # plan under the SAME template fingerprint the executor would use,
        # so the planner consults (and the analyze run feeds) the stats
        # advisor's learned cardinalities for this template
        cq = parse_combined_query(sparql, self.db.prefixes)
        fp, _ = fingerprint_query(cq)
        _sa.set_current_fp(fp)
        w = inline_subqueries(cq.select.where)
        resolved = [resolve_pattern(self.db, p) for p in w.patterns]
        logical = build_logical_plan(resolved, list(w.filters), [], w.values)
        planner = Streamertail(self.db.get_or_build_stats())
        plan = planner.find_best_plan(logical)
        clauses = None if w.subqueries else _clause_plans(self.db, planner, w)
        union_groups, optional_plans, anti_plans = clauses or ((), (), ())
        try:
            lowered = lower_plan(self.db, plan, anti_plans, union_groups, optional_plans)
        except Unsupported as e:
            return f"host path: {e}"
        counts = lowered.calibrate_host() if exact_counts or analyze else None
        mqo_line = mqo.describe_shared(self.db, lowered)
        if not analyze:
            out = lowered.describe(counts)
            return out + "\n" + mqo_line if mqo_line else out
        with obs_analyze.capture() as cap, trace_scope() as tid:
            lowered.execute()
        rec = cap.last("device") or {}
        rep = _sa.stats_advisor.report(fp)
        drift = rep["ops"] if rep else None
        lines = [lowered.describe(counts, analyze=rec, drift=drift)]
        if mqo_line:
            lines.append(mqo_line)
        if _sa.stats_advisor_mode() == "off":
            lines.append("advisor: off")
        elif rep is None:
            lines.append("advisor: source=agm replans=0 drift=cold")
        else:
            lines.append(
                f"advisor: source={rep['source']}"
                f" replans={rep['replans']} drift={rep['drift']}"
            )
        if rec:
            lines.append(f"source: {rec.get('source', '?')}")
            lines.append(f"rows: {rec.get('rows', '?')}")
        stage_spans = [
            s for s in spans_snapshot(tid) if s["name"].startswith(("device.", "interp."))
        ]
        if stage_spans:
            lines.append("device time:")
            for s in stage_spans:
                lines.append(f"  {s['name']}: {s['dur_ms']:.3f} ms")
        return "\n".join(lines)
