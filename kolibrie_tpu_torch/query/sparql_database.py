"""SparqlDatabase — the store facade of the PyTorch port: columnar triples
+ dictionary + parsers + prefixes, with the device mirror on an explicit
torch device.

Port of ``kolibrie_tpu/query/sparql_database.py``, trimmed to what the
SPARQL statements reach: the pure-Python RDF parsers (the C++ bulk
tokenizers are not ported), term encoding/decoding, prefixes, the
numeric-literal table, the optimizer statistics, and the registries that
``execute_combined`` and RULE definitions read (``rule_map``,
``neural_relations``, ``probability_seeds``).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

import torch

from kolibrie_tpu_torch.backend import DeviceLike, resolve_device
from kolibrie_tpu_torch.core.dictionary import Dictionary
from kolibrie_tpu_torch.core.quoted import QuotedTripleStore
from kolibrie_tpu_torch.core.store import ColumnarTripleStore
from kolibrie_tpu_torch.core.triple import Triple
from kolibrie_tpu_torch.query import rdf_parsers
from kolibrie_tpu_torch.query.rdf_parsers import ParsedTerm

_NUM_RE = re.compile(r'^"([+-]?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)"')

DEFAULT_PREFIXES = {
    "rdf": "http://www.w3.org/1999/02/22-rdf-syntax-ns#",
    "rdfs": "http://www.w3.org/2000/01/rdf-schema#",
    "xsd": "http://www.w3.org/2001/XMLSchema#",
}


class SparqlDatabase:
    """In-memory RDF(-star) store with dictionary-encoded columnar triples.

    ``device`` is where the store's sorted orders are mirrored and every
    query on this database runs: the CUDA card unless the caller passes
    another (``device="cpu"`` in the tests)."""

    def __init__(self, device: DeviceLike = None) -> None:
        self.device: torch.device = resolve_device(device)
        self.store = ColumnarTripleStore(self.device)
        self.dictionary = Dictionary()
        self.quoted = QuotedTripleStore()
        self.prefixes: Dict[str, str] = dict(DEFAULT_PREFIXES)
        self.udfs: Dict[str, Callable] = {}
        #: RULE definitions by name (``execute_combined``)
        self.rule_map: Dict[str, object] = {}
        #: NEURAL RELATION declarations; empty until the ML slice is ported
        self.neural_relations: Dict[str, object] = {}
        #: input probabilities of facts, for the provenance seeds
        self.probability_seeds: Dict[Tuple[int, int, int], float] = {}
        self._stats = None
        self._stats_version = -1
        self._numeric_cache: Optional[np.ndarray] = None
        self._numeric_cache_len = 0

    # ------------------------------------------------------------- encoding

    def encode_parsed_term(self, term: ParsedTerm) -> int:
        """Encode a parser-produced term (string or nested ('qt', s, p, o))."""
        if isinstance(term, tuple):
            _, s, p, o = term
            return self.quoted.intern(
                self.encode_parsed_term(s),
                self.encode_parsed_term(p),
                self.encode_parsed_term(o),
            )
        return self.dictionary.encode(term)

    def encode_term_str(self, term: str) -> int:
        """Encode a term given in text syntax, supporting ``<< s p o >>``.

        Parity: ``sparql_database.rs:87`` ``encode_term_star``.
        """
        term = term.strip()
        if term.startswith("<<") and term.endswith(">>"):
            parts = split_quoted_triple_content(term[2:-2].strip())
            ids = [self.encode_term_str(p) for p in parts]
            if len(ids) != 3:
                raise ValueError(f"malformed quoted triple: {term!r}")
            return self.quoted.intern(*ids)
        if term.startswith("<") and term.endswith(">"):
            return self.dictionary.encode(term[1:-1])
        return self.dictionary.encode(term)

    def lookup_term_str(self, term: str) -> Optional[int]:
        """Non-interning counterpart of :meth:`encode_term_str` — same
        normalization (``<iri>`` brackets, ``<< s p o >>`` quoted triples),
        but returns ``None`` for unknown terms instead of allocating IDs."""
        term = term.strip()
        if term.startswith("<<") and term.endswith(">>"):
            parts = split_quoted_triple_content(term[2:-2].strip())
            if len(parts) != 3:
                return None
            ids = [self.lookup_term_str(p) for p in parts]
            if any(i is None for i in ids):
                return None
            return self.quoted.lookup(*ids)
        if term.startswith("<") and term.endswith(">"):
            term = term[1:-1]
        return self.dictionary.lookup(term)

    def decode_term(self, term_id: int) -> Optional[str]:
        return self.dictionary.decode_term(term_id, self.quoted)

    # ------------------------------------------------------------- mutation

    def add_triple_parts(self, s: str, p: str, o: str) -> Triple:
        t = Triple(
            self.encode_term_str(s), self.encode_term_str(p), self.encode_term_str(o)
        )
        self.store.add_triple(t)
        return t

    def add_triple(self, t: Triple) -> None:
        self.store.add_triple(t)

    def delete_triple(self, t: Triple) -> None:
        self.store.remove(t.subject, t.predicate, t.object)

    def __len__(self) -> int:
        return len(self.store)

    # -------------------------------------------------------------- parsing

    def _ingest(self, parsed: List[Tuple[ParsedTerm, ParsedTerm, ParsedTerm]]) -> int:
        if not parsed:
            return 0
        n = len(parsed)
        s = np.empty(n, dtype=np.uint32)
        p = np.empty(n, dtype=np.uint32)
        o = np.empty(n, dtype=np.uint32)
        enc = self.encode_parsed_term
        for i, (ts, tp, to) in enumerate(parsed):
            s[i] = enc(ts)
            p[i] = enc(tp)
            o[i] = enc(to)
        self.store.add_batch(s, p, o)
        return n

    def parse_turtle(self, data: str) -> int:
        triples, prefixes = rdf_parsers.parse_turtle(data, self.prefixes)
        self.prefixes.update(prefixes)
        return self._ingest(triples)

    def parse_n3(self, data: str) -> int:
        triples, prefixes = rdf_parsers.parse_n3(data, self.prefixes)
        self.prefixes.update(prefixes)
        return self._ingest(triples)

    def parse_ntriples(self, data: str) -> int:
        return self._ingest(rdf_parsers.parse_ntriples(data))

    @classmethod
    def from_arrays(
        cls, terms, s, p, o, quoted=None, device: DeviceLike = None
    ) -> "SparqlDatabase":
        """A database holding another database's state: ``terms`` is the
        dictionary's term list in ID order (index 0 the NULL slot, ``None``),
        ``s``/``p``/``o`` are u32 columns with deletions already applied and
        ``quoted`` an optional mapping quoted-triple ID -> ``(s, p, o)``.
        Dictionary and quoted IDs, and hence every sort order, match the
        source's."""
        db = cls(device)
        db.dictionary = Dictionary.from_terms(terms)
        for qid, (qs, qp, qo) in sorted((quoted or {}).items()):
            if db.quoted.intern(int(qs), int(qp), int(qo)) != qid:
                raise ValueError(f"quoted-triple ID {qid:#x} is not dense")
        db.store.add_batch(
            np.asarray(s, np.uint32), np.asarray(p, np.uint32), np.asarray(o, np.uint32)
        )
        return db

    # -------------------------------------------------------------- prefixes

    def register_prefix(self, prefix: str, iri: str) -> None:
        self.prefixes[prefix.rstrip(":")] = iri

    def register_prefixes_from_query(self, query: str) -> None:
        """Parity: ``sparql_database.rs:1442``."""
        for m in re.finditer(
            r"(?i)\bPREFIX\s+([\w-]*):\s*<([^>]*)>", query
        ):
            self.prefixes[m.group(1)] = m.group(2)

    def expand_term(self, term: str) -> str:
        """Expand a prefixed name using registered prefixes; pass through IRIs
        and literals."""
        if term.startswith("<") and term.endswith(">"):
            return term[1:-1]
        if term.startswith('"') or term.startswith("_:") or term.startswith("?"):
            return term
        if ":" in term:
            pfx, local = term.split(":", 1)
            if not local.startswith("//"):
                ns = self.prefixes.get(pfx)
                if ns is not None:
                    return ns + local
        return term

    # --------------------------------------------------------- numeric cache

    def numeric_values(self) -> np.ndarray:
        """f64 array aligned to dictionary IDs: literal numeric value or NaN.

        This is the VPU-friendly replacement for the reference's SIMD numeric
        filter path (``apply_filters_simd``, ``sparql_database.rs:1497``):
        numeric comparison over ID columns becomes one vectorized gather +
        compare over this table.
        """
        d = self.dictionary
        n = len(d.id_to_str)
        if self._numeric_cache is None or self._numeric_cache_len < n:
            vals = np.full(n, np.nan)
            if self._numeric_cache is not None:
                vals[: self._numeric_cache_len] = self._numeric_cache
                start = self._numeric_cache_len
            else:
                start = 1
            for i in range(start, n):
                s = d.id_to_str[i]
                if s is None:
                    continue
                m = _NUM_RE.match(s) if s.startswith('"') else None
                if m:
                    vals[i] = float(m.group(1))
                elif not s.startswith('"'):
                    try:
                        vals[i] = float(s)
                    except ValueError:
                        pass
            self._numeric_cache = vals
            self._numeric_cache_len = n
        return self._numeric_cache

    # ----------------------------------------------------------------- stats

    def get_or_build_stats(self):
        """Sampled cardinality stats for the optimizer (built lazily, cached
        per store BASE version — stats guide plan choice, so small delta
        drift is tolerable and re-sampling per mutation batch is not).
        Parity: ``sparql_database.rs:202`` →
        ``stats/database_stats.rs:43``."""
        from kolibrie_tpu_torch.optimizer.stats import DatabaseStats

        v = self.store.base_version
        if self._stats is None or self._stats_version != v:
            self._stats = DatabaseStats.gather_stats_fast(self)
            self._stats_version = v
        return self._stats


def split_quoted_triple_content(content: str) -> List[str]:
    """Split ``s p o`` inside ``<< ... >>`` respecting nested ``<< >>``,
    ``<...>`` IRIs and quoted literals.

    Parity: ``sparql_database.rs:130`` ``split_quoted_triple_content``.
    """
    parts: List[str] = []
    buf: List[str] = []
    depth = 0
    in_str = False
    i = 0
    n = len(content)
    while i < n:
        c = content[i]
        if in_str:
            buf.append(c)
            if c == "\\" and i + 1 < n:
                buf.append(content[i + 1])
                i += 2
                continue
            if c == '"':
                in_str = False
            i += 1
            continue
        if c == '"':
            in_str = True
            buf.append(c)
            i += 1
            continue
        if content.startswith("<<", i):
            depth += 1
            buf.append("<<")
            i += 2
            continue
        if content.startswith(">>", i):
            depth -= 1
            buf.append(">>")
            i += 2
            continue
        if c.isspace() and depth == 0:
            if buf:
                parts.append("".join(buf))
                buf = []
            i += 1
            continue
        buf.append(c)
        i += 1
    if buf:
        parts.append("".join(buf))
    return parts
