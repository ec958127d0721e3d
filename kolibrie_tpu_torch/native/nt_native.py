"""Native N-Triples bulk load: tokenize + unique-term interning in C++, so
Python interns only the document's UNIQUE terms (then remaps the per-triple
term indices with one vectorized gather).

Fast path for :meth:`SparqlDatabase.parse_ntriples`; returns None when the
native library is unavailable or the document uses constructs the native
tokenizer does not handle (RDF-star, Turtle shorthand) — the caller then
falls back to the Python parser.

Port of ``kolibrie_tpu/native/nt_native.py`` (a copy, the imports rewritten).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from kolibrie_tpu_torch.native import load

# Zero-copy access to a str's UTF-8 bytes: CPython caches the UTF-8 form on
# the unicode object (for ASCII strs it IS the compact in-object buffer), so
# the tokenizer reads the string's own memory instead of paying a whole-
# document ``data.encode()`` copy (~1.4s per 200MB on this class of host).
_utf8_and_size = ctypes.pythonapi.PyUnicode_AsUTF8AndSize
_utf8_and_size.argtypes = [ctypes.py_object, ctypes.POINTER(ctypes.c_ssize_t)]
_utf8_and_size.restype = ctypes.c_void_p


def input_view(data: str):
    """``(raw, raw_len)`` UTF-8 view of ``data`` for a tokenizer call.

    ASCII strings hand the tokenizer the str's OWN cached UTF-8 buffer
    (zero copy; see module doc); non-ASCII pays one encode (AsUTF8 would
    set a pending exception on lone surrogates, which a ctypes call cannot
    surface safely).  The caller must keep ``data`` alive for the call.
    """
    if data.isascii():  # O(1) flag check; zero-copy path cannot fail
        size = ctypes.c_ssize_t()
        addr = _utf8_and_size(data, ctypes.byref(size))  # borrowed from data
        return ctypes.cast(addr, ctypes.c_char_p), size.value
    buf = data.encode("utf-8")
    return buf, len(buf)


def read_session_terms(lib, session, n: int, fns: tuple):
    """Read back a parse session's ``(ids, terms)``; None on an
    undecodable term blob (out-of-range escape — Python parser decides).

    ``fns``: the session's accessor names ``(ids, nterms, term_bytes,
    terms)`` — shared by the N-Triples and Turtle sessions, whose layouts
    are identical.
    """
    f_ids, f_nterms, f_bytes, f_terms = (getattr(lib, f) for f in fns)
    ids = np.empty(n * 3, dtype=np.uint32)
    if n:
        f_ids(session, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    n_terms = int(f_nterms(session))
    nbytes = int(f_bytes(session))
    buf = ctypes.create_string_buffer(nbytes)
    offsets = (ctypes.c_int64 * (n_terms + 1))()
    f_terms(session, buf, offsets)
    blob = buf.raw
    try:
        if blob.isascii():
            # one whole-blob decode, then per-term str slicing — byte
            # offsets equal codepoint offsets for pure-ASCII data, which
            # is the common case for dictionary-encoded RDF terms
            text = blob.decode("ascii")
            offs = offsets[:]
            terms = [text[offs[i]: offs[i + 1]] for i in range(n_terms)]
        else:
            # surrogatepass: lone-surrogate \uXXXX escapes decode to the
            # same string the Python parser's chr() produces
            terms = [
                blob[offsets[i]: offsets[i + 1]].decode(
                    "utf-8", "surrogatepass"
                )
                for i in range(n_terms)
            ]
    except UnicodeDecodeError:
        return None
    return ids.reshape(n, 3), terms


def bulk_parse_rdf_xml(data: str, nthreads: int = 0) -> Optional[tuple]:
    """Parse an RDF/XML document natively (streaming byte parser for the
    common bulk shape, chunk-parallel past ~1MB with splits after
    ``</rdf:Description>``; see ``RxParser`` in the C++ runtime).  Returns
    ``(ids, terms)`` like :func:`bulk_parse_ntriples`, or None to request
    the Python ElementTree fallback (default xmlns, nested node elements,
    fresh blank nodes, parseType, CDATA, DOCTYPE...)."""
    lib = load()
    if lib is None:
        return None
    raw, raw_len = input_view(data)
    session = ctypes.c_void_p()
    n = int(lib.kn_rx_parse_mt(raw, raw_len, nthreads, ctypes.byref(session)))
    if n < 0:
        return None
    try:
        return read_session_terms(
            lib,
            session,
            n,
            ("kn_nt_ids", "kn_nt_nterms", "kn_nt_term_bytes", "kn_nt_terms"),
        )
    finally:
        lib.kn_nt_free(session)


def bulk_parse_ntriples(data: str, nthreads: int = 0) -> Optional[tuple]:
    """Parse a plain N-Triples document natively.

    Returns ``(ids, terms)`` where ``ids`` is an ``(n, 3) uint32`` array of
    1-based indices into ``terms`` (the unique term strings, in first-seen
    order), or None to request the Python fallback.  ``nthreads``: 0 = auto
    (parallel chunked parse past ~1MB); an explicit value >= 2 forces the
    chunked path regardless of size (tests use this).
    """
    lib = load()
    if lib is None:
        return None
    raw, raw_len = input_view(data)
    session = ctypes.c_void_p()
    n = int(lib.kn_nt_parse_mt(raw, raw_len, nthreads, ctypes.byref(session)))
    if n < 0:
        return None  # -1 syntax error / -2 unsupported: Python decides
    try:
        return read_session_terms(
            lib,
            session,
            n,
            ("kn_nt_ids", "kn_nt_nterms", "kn_nt_term_bytes", "kn_nt_terms"),
        )
    finally:
        lib.kn_nt_free(session)
