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
        """Physical-plan EXPLAIN of the device engine.  It needs the lowered
        plan's host twin (``LoweredPlan.calibrate_host``) and the analyze
        capture (``obs.analyze``), which come with ROADMAP A7 (the
        StatsAdvisor feed) and A10 (serving); until then it raises."""
        raise NotImplementedError(
            "QueryEngine.explain_device needs LoweredPlan.calibrate_host and "
            "obs.analyze (ROADMAP A7, A10), which kolibrie_tpu_torch does not "
            "have yet"
        )
