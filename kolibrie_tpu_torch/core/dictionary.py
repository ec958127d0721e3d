"""Bidirectional string <-> u32 dictionary encoding.

Strings never reach the device: every RDF term is encoded to a u32 ID on the host
and all device compute happens on ID columns.

Parity: reference ``shared/src/dictionary.rs:17-91`` — IDs are limited to bits
0..30; bit 31 (``0x8000_0000``) is reserved to mark RDF-star quoted-triple IDs
(``shared/src/quoted_triple_store.rs:17``).  ``merge`` supports parallel parsing
workers each building a partial dictionary (``dictionary.rs:82-90``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

QUOTED_BIT = 0x8000_0000
MAX_PLAIN_ID = 0x7FFF_FFFF


def display_form(s: Optional[str]) -> str:
    """Human-facing form of a stored term: literal quotes stripped
    (``executor._format_value`` semantics).  Maintained incrementally at
    intern time so result formatting never re-walks the dictionary."""
    if not s:
        return ""
    if s[0] == '"':
        end = s.rfind('"')
        if end > 0:
            return s[1:end]
    return s


def is_quoted_triple_id(term_id: int) -> bool:
    """True if the ID refers to a quoted triple ``<< s p o >>`` (bit 31 set)."""
    return bool(term_id & QUOTED_BIT)


class Dictionary:
    """Host-side bidirectional string<->u32 encoder.

    ID 0 is reserved as the invalid/NULL sentinel so that device code can use 0
    for padding.  Plain-term IDs start at 1 and must stay below 2^31.
    """

    __slots__ = ("str_to_id", "id_to_str", "display", "_next_id")

    def __init__(self) -> None:
        self.str_to_id: Dict[str, int] = {}
        self.id_to_str: List[Optional[str]] = [None]  # index 0 = NULL sentinel
        self.display: List[str] = [""]  # display_form per ID, same order
        self._next_id = 1

    @classmethod
    def from_terms(cls, terms: Iterable[Optional[str]]) -> "Dictionary":
        """A dictionary holding another's state: ``terms`` is its term list
        in ID order (index 0 the NULL slot, ``None``), so every ID keeps
        its value."""
        d = cls()
        d.id_to_str = list(terms)
        d.str_to_id = {t: i for i, t in enumerate(d.id_to_str) if t is not None}
        d.display = [display_form(t) for t in d.id_to_str]
        d._next_id = len(d.id_to_str)
        return d

    def __len__(self) -> int:
        return len(self.str_to_id)

    def encode(self, s: str) -> int:
        """Intern ``s`` and return its u32 ID (stable across calls)."""
        eid = self.str_to_id.get(s)
        if eid is not None:
            return eid
        eid = self._next_id
        if eid > MAX_PLAIN_ID:
            raise OverflowError("dictionary exhausted 31-bit ID space")
        self._next_id = eid + 1
        self.str_to_id[s] = eid
        self.id_to_str.append(s)
        self.display.append(display_form(s))
        return eid

    def encode_many(self, strs: Iterable[str]) -> List[int]:
        enc = self.encode
        return [enc(s) for s in strs]

    def encode_batch(self, strs: List[str]) -> List[int]:
        """Bulk intern with the dict/list bound to locals — the hot path of
        native bulk loads, where every term of a 10M-triple document passes
        through here exactly once."""
        if self._next_id + len(strs) > MAX_PLAIN_ID + 1:
            # possible overflow mid-batch: take the checked per-item path
            return self.encode_many(strs)
        sti = self.str_to_id
        its_append = self.id_to_str.append
        dis_append = self.display.append
        disp = display_form
        get = sti.get
        nid = self._next_id
        out = []
        append = out.append
        for s in strs:
            eid = get(s)
            if eid is None:
                eid = nid
                nid += 1
                sti[s] = eid
                its_append(s)
                dis_append(disp(s))
            append(eid)
        self._next_id = nid
        return out

    def lookup(self, s: str) -> Optional[int]:
        """Return the ID for ``s`` without interning, or None."""
        return self.str_to_id.get(s)

    def decode(self, term_id: int) -> Optional[str]:
        """Plain-term decode. Quoted-triple IDs are not resolvable here — use
        :meth:`decode_term` with a :class:`QuotedTripleStore`."""
        if term_id & QUOTED_BIT:
            return None
        if 0 < term_id < self._next_id:
            return self.id_to_str[term_id]
        return None

    def decode_term(self, term_id: int, quoted_store=None) -> Optional[str]:
        """RDF-star-aware decode: quoted-triple IDs render as ``<< s p o >>``.

        Mirrors ``shared/src/dictionary.rs:62-80`` (``decode_term`` /
        ``decode_triple_star``).
        """
        if term_id & QUOTED_BIT:
            if quoted_store is None:
                return None
            inner = quoted_store.get(term_id)
            if inner is None:
                return None
            s, p, o = inner
            ds = self.decode_term(s, quoted_store)
            dp = self.decode_term(p, quoted_store)
            do = self.decode_term(o, quoted_store)
            if ds is None or dp is None or do is None:
                return None
            return f"<< {ds} {dp} {do} >>"
        return self.decode(term_id)

    def merge(self, other: "Dictionary") -> Dict[int, int]:
        """Merge ``other`` into self; returns a remap ``other_id -> self_id``.

        Used by parallel parsing workers and for dictionary synchronization
        between query plans and RSP window stores (``rsp_engine.rs:272-293``).
        """
        remap: Dict[int, int] = {0: 0}
        for s, oid in other.str_to_id.items():
            remap[oid] = self.encode(s)
        return remap

    def display_forms(self) -> List[str]:
        """Display form per ID, resynced if ``id_to_str`` was replaced
        wholesale (checkpoint restore assigns it directly)."""
        disp, its = self.display, self.id_to_str
        if len(disp) > len(its):
            del disp[len(its):]
        elif len(disp) < len(its):
            disp.extend(display_form(s) for s in its[len(disp):])
        return disp

    def clone(self) -> "Dictionary":
        d = Dictionary.__new__(Dictionary)
        d.str_to_id = dict(self.str_to_id)
        d.id_to_str = list(self.id_to_str)
        d.display = list(self.display)
        d._next_id = self._next_id
        return d
