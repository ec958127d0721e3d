"""SparqlDatabase — the store facade of the PyTorch port: columnar triples
+ dictionary + parsers + prefixes, with the device mirror on an explicit
torch device.

Port of ``kolibrie_tpu/query/sparql_database.py``: the RDF parsers (the
native bulk tokenizers of the repo's ``native/`` library first, the
pure-Python parsers where they decline), one-file checkpoints (the
reference's file format, readable by either package), clone / union /
``par_join``, the N-Triples, Turtle and RDF/XML serializers, term
encoding/decoding, prefixes, UDFs, the numeric-literal table, the
optimizer statistics, and the registries that ``execute_combined`` and
RULE definitions read (``rule_map``, ``model_registry``,
``neural_relations``, ``trained_models``, ``probability_seeds``).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

import torch

from kolibrie_tpu_torch.backend import DeviceLike, resolve_device
from kolibrie_tpu_torch.core.dictionary import QUOTED_BIT, Dictionary
from kolibrie_tpu_torch.core.quoted import QuotedTripleStore
from kolibrie_tpu_torch.core.store import ColumnarTripleStore
from kolibrie_tpu_torch.core.triple import Triple
from kolibrie_tpu_torch.query import rdf_parsers
from kolibrie_tpu_torch.query.rdf_parsers import ParsedTerm, format_term_nt

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
        #: "auto" (the device program from ``query.executor._DEVICE_AUTO_MIN``
        #: triples, the host engine below), "device" or "host"; the host
        #: engine runs on this database's device too
        self.execution_mode: str = "auto"
        #: RULE definitions by name (``execute_combined``)
        self.rule_map: Dict[str, object] = {}
        #: MODEL declarations by name
        self.model_registry: Dict[str, object] = {}
        #: NEURAL RELATION declarations by predicate IRI (and "by_model:<name>")
        self.neural_relations: Dict[str, object] = {}
        #: MLP neural predicates by model name, on this database's device
        self.trained_models: Dict[str, object] = {}
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
        native = self._parse_turtle_native(data)
        if native is not None:
            return native
        triples, prefixes = rdf_parsers.parse_turtle(data, self.prefixes)
        self.prefixes.update(prefixes)
        return self._ingest(triples)

    def _parse_turtle_native(self, data: str) -> Optional[int]:
        """Bulk fast path: chunk-parallel C++ Turtle tokenizer + unique-term
        interning (see :mod:`kolibrie_tpu_torch.native.ttl_native`).  Returns None
        (fall back) for Turtle-star / ``[]`` / ``()`` / multiline strings /
        ``@base`` or if native is off."""
        try:
            from kolibrie_tpu_torch.native.ttl_native import bulk_parse_turtle
        except ImportError:
            return None
        result = bulk_parse_turtle(data, self.prefixes)
        if result is None:
            return None
        ids, terms, prefixes_out = result
        self.prefixes.update(prefixes_out)
        return self._ingest_native_session(ids, terms)

    def parse_n3(self, data: str) -> int:
        triples, prefixes = rdf_parsers.parse_n3(data, self.prefixes)
        self.prefixes.update(prefixes)
        return self._ingest(triples)

    def parse_ntriples(self, data: str) -> int:
        native = self._parse_ntriples_native(data)
        if native is not None:
            return native
        return self._ingest(rdf_parsers.parse_ntriples(data))

    def _ingest_native_session(self, ids: np.ndarray, terms) -> int:
        """Shared tail of every native bulk parse: intern the session's
        UNIQUE terms once (``encode_batch``), then remap the (n, 3)
        1-based id matrix with one vectorized gather into the store.
        ``remap[0]`` is intentionally never read (ids are 1-based)."""
        remap = np.empty(len(terms) + 1, dtype=np.uint32)
        remap[1:] = self.dictionary.encode_batch(terms)
        cols = remap[ids]
        self.store.add_batch(cols[:, 0], cols[:, 1], cols[:, 2])
        return int(ids.shape[0])

    def _parse_ntriples_native(self, data: str) -> Optional[int]:
        """Bulk fast path: C++ tokenizer + unique-term interning; Python
        interns only unique terms, then one vectorized remap.  Returns None
        (fall back) for RDF-star / Turtle constructs or if native is off."""
        try:
            from kolibrie_tpu_torch.native.nt_native import bulk_parse_ntriples
        except ImportError:
            return None
        result = bulk_parse_ntriples(data)
        if result is None:
            return None
        return self._ingest_native_session(*result)

    # ------------------------------------------------- preemption/restart

    def checkpoint(self, path: str) -> None:
        """One-file durable snapshot of the DATA state (docs/PREEMPTION.md):
        triple columns, dictionary, quoted-triple table, prefixes, and
        probability seeds.  Rules, UDFs, neural registries, and device
        residency are CONFIGURATION/derived state — re-registered by the
        application and lazily rebuilt from the restored columns.  The
        reference keeps everything in memory with no snapshot at all
        (SURVEY §5 "checkpoint/resume: none")."""
        # kolint: durable-path — checkpoints must survive a crash mid-write
        from kolibrie_tpu_torch.durability.fsio import atomic_write

        s, p, o = self.store.columns()
        seeds = self.probability_seeds
        # write through a file object: np.savez_compressed appends ".npz"
        # to bare string paths, which would break same-path restore.
        # temp → fsync → rename: a kill -9 mid-checkpoint leaves the
        # previous checkpoint intact, never a torn half-file
        with atomic_write(path) as fh:
            self._checkpoint_to(fh, s, p, o, seeds)

    def _checkpoint_to(self, fh, s, p, o, seeds) -> None:
        import pickle

        np.savez_compressed(
            fh,
            s=s,
            p=p,
            o=o,
            terms=np.frombuffer(
                pickle.dumps(self.dictionary.id_to_str), dtype=np.uint8
            ),
            quoted=np.asarray(
                [
                    (qid, t[0], t[1], t[2])
                    for qid, t in sorted(self.quoted.items())
                ],
                dtype=np.uint64,
            ).reshape(-1, 4),
            prefixes=np.frombuffer(pickle.dumps(self.prefixes), dtype=np.uint8),
            seeds=np.asarray(
                [(k[0], k[1], k[2], v) for k, v in sorted(seeds.items())],
                dtype=np.float64,
            ).reshape(-1, 4),
        )

    @classmethod
    def from_checkpoint(cls, path: str, device: DeviceLike = None) -> "SparqlDatabase":
        """Rebuild a database from :meth:`checkpoint` output (either
        package's) on ``device``, the CUDA card unless the caller passes
        another; indexes and device mirrors are built anew from the
        restored columns on first use."""
        import pickle

        data = np.load(path, allow_pickle=False)
        db = cls(device)
        db.store.add_batch(
            data["s"].astype(np.uint32),
            data["p"].astype(np.uint32),
            data["o"].astype(np.uint32),
        )
        db.dictionary = Dictionary.from_terms(pickle.loads(data["terms"].tobytes()))
        for qid, s_, p_, o_ in data["quoted"].astype(np.uint64).tolist():
            key = (int(s_), int(p_), int(o_))
            db.quoted.triple_to_id[key] = int(qid)
            db.quoted.id_to_triple[int(qid)] = key
        db.prefixes = pickle.loads(data["prefixes"].tobytes())
        for s_, p_, o_, prob in data["seeds"].tolist():
            db.probability_seeds[(int(s_), int(p_), int(o_))] = float(prob)
        return db

    @classmethod
    def from_arrays(
        cls, terms, s, p, o, quoted=None, device: DeviceLike = None, probability_seeds=None
    ) -> "SparqlDatabase":
        """A database holding another database's state: ``terms`` is the
        dictionary's term list in ID order (index 0 the NULL slot, ``None``),
        ``s``/``p``/``o`` are u32 columns with deletions already applied,
        ``quoted`` an optional mapping quoted-triple ID -> ``(s, p, o)`` and
        ``probability_seeds`` an optional mapping ``(s, p, o)`` -> input
        probability (the facts ``RULE … PROB`` seeds its tags from).
        Dictionary and quoted IDs, and hence every sort order, match the
        source's."""
        db = cls(device)
        db.probability_seeds = {
            (int(a), int(b), int(c)): float(v)
            for (a, b, c), v in (probability_seeds or {}).items()
        }
        db.dictionary = Dictionary.from_terms(terms)
        for qid, (qs, qp, qo) in sorted((quoted or {}).items()):
            if db.quoted.intern(int(qs), int(qp), int(qo)) != qid:
                raise ValueError(f"quoted-triple ID {qid:#x} is not dense")
        db.store.add_batch(
            np.asarray(s, np.uint32), np.asarray(p, np.uint32), np.asarray(o, np.uint32)
        )
        return db

    # --------------------------------------------------- whole-database ops

    def _remap_from(self, other: "SparqlDatabase"):
        """Id remap other→self: ``(remap, qremap)`` where ``remap`` is a
        vectorized per-plain-id array (other's terms bulk-interned into
        self's dictionary) and ``qremap`` maps other's quoted-triple ids
        after a store merge (None when other has no quoted triples)."""
        its = other.dictionary.id_to_str
        n_plain = len(its)
        remap = np.zeros(n_plain, dtype=np.uint32)
        if n_plain > 1:
            remap[1:] = self.dictionary.encode_batch(its[1:])
        if len(other.quoted) == 0:
            return remap, None
        # only the plain ids actually referenced inside quoted triples need
        # dict entries (not the whole id space)
        refs = set()
        for _qid, (qs, qp, qo) in other.quoted.items():
            for t in (qs, qp, qo):
                if not (t & QUOTED_BIT):
                    refs.add(t)
        term_remap = {i: int(remap[i]) for i in refs}
        qremap = self.quoted.merge(other.quoted, term_remap)
        return remap, qremap

    @staticmethod
    def _apply_remap(col: np.ndarray, remap: np.ndarray, qremap) -> np.ndarray:
        if qremap is None:
            return remap[col]
        quoted = (col & QUOTED_BIT) != 0
        out = remap[np.where(quoted, 0, col)]
        if quoted.any():
            out[quoted] = [qremap[int(q)] for q in col[quoted]]
        return out

    def union(self, other: "SparqlDatabase") -> "SparqlDatabase":
        """New database holding both stores' triples: other's ids re-encoded
        through a merged dictionary, probability seeds merged, prefixes/
        UDFs/registries/execution mode from self.  Parity: the reference's
        whole-DB ``union`` (``sparql_database.rs:1990-2041``) — vectorized
        remap instead of a per-triple decode/encode loop."""
        out = self.clone()
        remap, qremap = out._remap_from(other)
        s, p, o = other.store.columns()
        out.store.add_batch(
            *(self._apply_remap(c, remap, qremap) for c in (s, p, o))
        )

        def map_id(i: int) -> int:
            if qremap is not None and (i & QUOTED_BIT):
                return qremap[i]
            return int(remap[i])

        for (ts, tp, to), prob in other.probability_seeds.items():
            out.probability_seeds[
                (map_id(ts), map_id(tp), map_id(to))
            ] = prob
        return out

    def par_join(
        self, other: "SparqlDatabase", predicate: str
    ) -> "SparqlDatabase":
        """New database with the join of the two stores along ``predicate``:
        for self ``(a, p, b)`` and other ``(b, p, c)``, emit ``(a, p, c)``.
        Shares self's dictionary (ids remain valid); other's ids are
        remapped first, so the databases need not share an id space.
        Parity: ``sparql_database.rs:2042-2117`` ``par_join`` — one
        vectorized sort join instead of a rayon fold."""
        from kolibrie_tpu_torch.ops.join import join_indices

        out = SparqlDatabase(self.device)
        out.dictionary = self.dictionary  # shared, like the reference
        out.quoted = self.quoted
        out.prefixes = dict(self.prefixes)
        # normalized non-interning lookup (<iri> brackets accepted); an
        # unknown predicate joins nothing and must not pollute the SHARED
        # dictionary with a garbage term
        pid = self.lookup_term_str(predicate)
        if pid is None:
            return out
        remap, qremap = self._remap_from(other)
        os_, op, oo = (
            self._apply_remap(c, remap, qremap)
            for c in other.store.columns()
        )
        s, p, o = self.store.columns()
        lmask = p == pid
        rmask = op == pid
        li, ri = join_indices(
            o[lmask].astype(np.uint64), os_[rmask].astype(np.uint64)
        )
        ls = s[lmask][li]
        ro = oo[rmask][ri]
        out.store.add_batch(
            ls, np.full(len(ls), pid, dtype=np.uint32), ro
        )
        return out

    def parse_rdf(self, data: str) -> int:
        """RDF/XML. Parity: ``sparql_database.rs:401`` ``parse_rdf``."""
        native = self._parse_rdf_native(data)
        if native is not None:
            return native
        return self._ingest(rdf_parsers.parse_rdf_xml(data))

    def _parse_rdf_native(self, data: str) -> Optional[int]:
        """Bulk fast path: streaming C++ RDF/XML parser + unique-term
        interning.  None (fall back to ElementTree) for shapes outside the
        common bulk subset — see ``bulk_parse_rdf_xml``."""
        try:
            from kolibrie_tpu_torch.native.nt_native import bulk_parse_rdf_xml
        except ImportError:
            return None
        result = bulk_parse_rdf_xml(data)
        if result is None:
            return None
        return self._ingest_native_session(*result)

    def parse_rdf_from_file(self, path: str) -> int:
        with open(path, "r", encoding="utf-8") as f:
            return self.parse_rdf(f.read())

    def load_file(self, path: str, fmt: Optional[str] = None) -> int:
        if fmt is None:
            for ext, f in (
                (".ttl", "turtle"),
                (".nt", "ntriples"),
                (".n3", "n3"),
                (".rdf", "rdfxml"),
                (".xml", "rdfxml"),
                (".owl", "rdfxml"),
            ):
                if path.endswith(ext):
                    fmt = f
                    break
            else:
                fmt = "turtle"
        with open(path, "r", encoding="utf-8") as fh:
            data = fh.read()
        if fmt in ("rdfxml", "rdf/xml", "xml"):
            return self.parse_rdf(data)
        if fmt in ("nt", "ntriples"):
            return self.parse_ntriples(data)
        if fmt == "n3":
            return self.parse_n3(data)
        return self.parse_turtle(data)

    # ---------------------------------------------------------- serialization

    def iter_decoded(self):
        for t in self.store:
            yield (
                self.decode_term(t.subject),
                self.decode_term(t.predicate),
                self.decode_term(t.object),
            )

    def to_ntriples(self) -> str:
        out = []
        for s, p, o in self.iter_decoded():
            out.append(f"{format_term_nt(s)} {format_term_nt(p)} {format_term_nt(o)} .")
        return "\n".join(out) + ("\n" if out else "")

    def to_turtle(self) -> str:
        """Subject/predicate-grouped Turtle-star with prefix compaction
        (``generate_turtle``, sparql_database.rs:343-400)."""
        from kolibrie_tpu_torch.query.rdf_parsers import serialize_turtle

        return serialize_turtle(self.iter_decoded(), self.prefixes)

    def to_rdfxml(self) -> str:
        """RDF/XML export (``generate_rdf_xml``, sparql_database.rs:277-317).
        Quoted-triple (RDF-star) facts are omitted — RDF/XML cannot express
        them; use :meth:`to_ntriples`/:meth:`to_turtle`.  Raises
        ``ValueError`` if a predicate IRI cannot form an XML QName."""
        from kolibrie_tpu_torch.query.rdf_parsers import serialize_rdfxml

        return serialize_rdfxml(self.iter_decoded(), self.prefixes)

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

    # ------------------------------------------------------------------ UDFs

    def register_udf(self, name: str, fn: Callable) -> None:
        """Parity: ``sparql_database.rs:3164`` UDF registry."""
        self.udfs[name.upper()] = fn
        # re-registering a name can change semantics of an already-cached
        # plan whose filters bound the old function: bump the cache state
        self._udf_version = self.__dict__.get("_udf_version", 0) + 1

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

    def query(self):
        """Fluent builder entry point (python/src/py_query_builder.rs surface)."""
        from kolibrie_tpu_torch.query.builder import QueryBuilder

        return QueryBuilder(self)

    def clone(self) -> "SparqlDatabase":
        """An independent database on the same device: the store is a
        copy-on-write clone, the dictionary, quoted table and registries
        are copies."""
        db = SparqlDatabase(self.device)
        db.store = self.store.clone()
        db.dictionary = self.dictionary.clone()
        db.quoted = self.quoted.clone()
        db.prefixes = dict(self.prefixes)
        db.udfs = dict(self.udfs)
        db.execution_mode = self.execution_mode
        db.rule_map = dict(self.rule_map)
        db.model_registry = dict(self.model_registry)
        db.neural_relations = dict(self.neural_relations)
        db.trained_models = dict(self.trained_models)
        db.probability_seeds = dict(self.probability_seeds)
        return db


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
