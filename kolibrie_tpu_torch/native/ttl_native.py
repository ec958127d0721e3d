"""Native Turtle bulk load: chunk-parallel tokenize + unique-term interning
in C++ (the streamed-ingestion twin of :mod:`kolibrie_tpu_torch.native.nt_native`).

Fast path for :meth:`SparqlDatabase.parse_turtle`; returns None when the
native library is unavailable or the document uses constructs the native
tokenizer does not handle (Turtle-star, ``[]`` property lists, ``()``
collections, multiline/single-quoted strings, ``@base``) — the caller then
falls back to the Python recursive-descent parser.

Replaces the reference's crossbeam-streamed chunked
Turtle ingestion (``kolibrie/src/sparql_database.rs:729`` over the worker
pipeline at ``:401-571``) with statement-boundary thread chunks + interner
merge (``shared/src/dictionary.rs:82-90``).

Port of ``kolibrie_tpu/native/ttl_native.py`` (a copy, the imports rewritten).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np

from kolibrie_tpu_torch.native import load
from kolibrie_tpu_torch.native.nt_native import input_view, read_session_terms


def _prefix_blob(prefixes: Dict[str, str]) -> bytes:
    parts: List[str] = []
    for pfx, iri in prefixes.items():
        parts.append(f"{pfx}\x1f{iri}\x1e")
    return "".join(parts).encode("utf-8")


def bulk_parse_turtle(
    data: str, prefixes: Dict[str, str], nthreads: int = 0
) -> Optional[Tuple[np.ndarray, List[str], Dict[str, str]]]:
    """Parse a Turtle document natively.

    Returns ``(ids, terms, prefixes_out)``: an ``(n, 3) uint32`` array of
    1-based indices into ``terms`` plus the final prefix map (initial +
    document directives), or None to request the Python fallback.
    ``nthreads``: 0 = auto (chunk-parallel past ~1MB); >= 2 forces the
    chunked path (tests).
    """
    lib = load()
    if lib is None:
        return None
    raw, raw_len = input_view(data)
    blob = _prefix_blob(prefixes)
    session = ctypes.c_void_p()
    n = int(
        lib.kn_ttl_parse_mt(
            raw, raw_len, nthreads, blob, len(blob), ctypes.byref(session)
        )
    )
    if n < 0:
        return None  # -1 syntax / -2 unsupported / -3 internal: Python decides
    try:
        result = read_session_terms(
            lib,
            session,
            n,
            ("kn_ttl_ids", "kn_ttl_nterms", "kn_ttl_term_bytes", "kn_ttl_terms"),
        )
        if result is None:
            return None
        ids, terms = result
        plen = int(lib.kn_ttl_prefixes_len(session))
        pbuf = ctypes.create_string_buffer(plen)
        lib.kn_ttl_prefixes(session, pbuf)
        prefixes_out: Dict[str, str] = {}
        for entry in pbuf.raw.decode("utf-8", "surrogatepass").split("\x1e"):
            if "\x1f" in entry:
                pfx, iri = entry.split("\x1f", 1)
                prefixes_out[pfx] = iri
    finally:
        lib.kn_ttl_free(session)
    return ids, terms, prefixes_out
