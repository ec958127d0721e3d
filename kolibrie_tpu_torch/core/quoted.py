"""RDF-star quoted-triple store: ``<< s p o >>`` terms as u32 IDs with bit 31 set.

Parity: ``shared/src/quoted_triple_store.rs:20-159`` — dedup, arbitrary nesting
(a quoted triple may itself contain quoted-triple IDs), and ``merge`` for
parallel parsing.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

from kolibrie_tpu_torch.core.dictionary import QUOTED_BIT

TripleIds = Tuple[int, int, int]


class QuotedTripleStore:
    """Interns (s, p, o) ID triples as quoted-triple term IDs (``0x8000_0000 | n``)."""

    __slots__ = ("triple_to_id", "id_to_triple")

    def __init__(self) -> None:
        self.triple_to_id: Dict[TripleIds, int] = {}
        self.id_to_triple: Dict[int, TripleIds] = {}

    def __len__(self) -> int:
        return len(self.triple_to_id)

    def intern(self, s: int, p: int, o: int) -> int:
        key = (s, p, o)
        qid = self.triple_to_id.get(key)
        if qid is not None:
            return qid
        qid = QUOTED_BIT | len(self.triple_to_id)
        self.triple_to_id[key] = qid
        self.id_to_triple[qid] = key
        return qid

    def get(self, qid: int) -> Optional[TripleIds]:
        return self.id_to_triple.get(qid)

    def lookup(self, s: int, p: int, o: int) -> Optional[int]:
        return self.triple_to_id.get((s, p, o))

    def items(self) -> Iterator[Tuple[int, TripleIds]]:
        return iter(self.id_to_triple.items())

    def merge(self, other: "QuotedTripleStore", term_remap: Dict[int, int]) -> Dict[int, int]:
        """Merge ``other`` (whose plain-term IDs were remapped by ``term_remap``)
        into self; returns quoted-ID remap ``other_qid -> self_qid``.

        Handles nesting by iterating until all inner references resolve.
        """
        qremap: Dict[int, int] = {}
        pending = dict(other.id_to_triple)
        while pending:
            progressed = False
            for qid, (s, p, o) in list(pending.items()):
                try:
                    rs = qremap[s] if (s & QUOTED_BIT) else term_remap.get(s, s)
                    rp = qremap[p] if (p & QUOTED_BIT) else term_remap.get(p, p)
                    ro = qremap[o] if (o & QUOTED_BIT) else term_remap.get(o, o)
                except KeyError:
                    continue
                qremap[qid] = self.intern(rs, rp, ro)
                del pending[qid]
                progressed = True
            if not progressed:  # cyclic/unresolvable — should not happen
                raise ValueError("unresolvable nested quoted triples in merge")
        return qremap

    def clone(self) -> "QuotedTripleStore":
        q = QuotedTripleStore.__new__(QuotedTripleStore)
        q.triple_to_id = dict(self.triple_to_id)
        q.id_to_triple = dict(self.id_to_triple)
        return q
