"""Per-triple provenance tag map.

Port of ``kolibrie_tpu/reasoner/tag_store.py`` (a copy, the imports rewritten, plus
:meth:`TagStore.from_items`).

Parity: ``shared/src/tag_store.rs`` — absent triple ⇒ ``one()`` (certain),
``update_disjunction`` with saturation check (:58-67), RDF-star export
``<< s p o >> prob:value "p"^^xsd:double`` (:89-111), and proof-path
explanation export (prob:proofCount/hasProof/hasSeed/hasNegatedSeed/formula)
for DNF tags (:121-180) and SDD tags via model enumeration (:184-246).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from kolibrie_tpu_torch.core.triple import Triple
from kolibrie_tpu_torch.reasoner.provenance import DnfWmcProvenance, Provenance, TopKProofs
from kolibrie_tpu_torch.reasoner.sdd import SddProvenance

PROB_NS = "http://kolibrie.tpu/prob#"
XSD_DOUBLE = "http://www.w3.org/2001/XMLSchema#double"


class TagStore:
    """Maps triples to semiring tags; absent = one() (certain fact)."""

    def __init__(self, provenance: Provenance):
        self.provenance = provenance
        self.tags: Dict[Tuple[int, int, int], object] = {}

    @classmethod
    def from_items(cls, provenance: Provenance, items) -> "TagStore":
        """A store holding ``items`` (``((s, p, o), tag)`` pairs, such as
        another store's ``tags.items()``) verbatim.  Scalar tags only: SDD
        tags are node IDs inside one manager and do not carry over."""
        store = cls(provenance)
        for (s, p, o), tag in items:
            store.tags[(int(s), int(p), int(o))] = tag
        return store

    def get(self, t: Triple):
        return self.tags.get(tuple(t), self.provenance.one())

    def get_opt(self, t: Triple):
        """Tag if explicitly stored, else None."""
        return self.tags.get(tuple(t))

    def set(self, t: Triple, tag) -> None:
        self.tags[tuple(t)] = tag

    def contains(self, t: Triple) -> bool:
        return tuple(t) in self.tags

    def update_disjunction(self, t: Triple, tag) -> bool:
        """⊕-merge a new derivation's tag; returns True if the stored tag
        changed.  Saturated tags short-circuit (tag_store.rs:58-67)."""
        key = tuple(t)
        old = self.tags.get(key)
        if old is None:
            self.tags[key] = self.provenance.saturate(tag)
            return True
        if self.provenance.is_saturated(old):
            return False
        new = self.provenance.saturate(self.provenance.disjunction(old, tag))
        if self.provenance.tag_eq(new, old):
            return False
        self.tags[key] = new
        return True

    def items(self) -> Iterator[Tuple[Tuple[int, int, int], object]]:
        return iter(self.tags.items())

    def __len__(self) -> int:
        return len(self.tags)

    # ------------------------------------------------------------- export

    def encode_as_rdf_star(self, db) -> List[Triple]:
        """``<< s p o >> prob:value "p"^^xsd:double`` facts
        (tag_store.rs:89-111)."""
        out: List[Triple] = []
        pv = db.dictionary.encode(PROB_NS + "value")
        for (s, p, o), tag in self.tags.items():
            prob = self.provenance.recover_probability(tag)
            qid = db.quoted.intern(s, p, o)
            lit = db.dictionary.encode(f'"{prob}"^^{XSD_DOUBLE}')
            out.append(Triple(qid, pv, lit))
        return out

    def explain_proofs(self, db, t: Triple) -> List[Triple]:
        """Proof-structure explanation triples for one fact
        (tag_store.rs:121-246).  Emits prob:proofCount plus per-proof
        prob:hasSeed / prob:hasNegatedSeed facts; SDD tags are expanded via
        model enumeration."""
        tag = self.get_opt(t)
        if tag is None:
            return []
        enc = db.dictionary.encode
        qid = db.quoted.intern(*t)
        out: List[Triple] = []
        proofs: List[List[Tuple[int, bool]]] = []
        prov = self.provenance
        if isinstance(prov, (TopKProofs, DnfWmcProvenance)):
            for proof in tag:
                proofs.append(sorted(proof))
        elif isinstance(prov, SddProvenance):
            models = prov.manager.enumerate_models(tag)
            var_to_seed = {v: s for s, v in prov.seed_vars.items()}
            for m in models:
                proofs.append(
                    sorted(
                        (var_to_seed.get(v, v), pos) for v, pos in m.items()
                    )
                )
        else:
            out.append(
                Triple(
                    qid,
                    enc(PROB_NS + "value"),
                    enc(f'"{prov.recover_probability(tag)}"^^{XSD_DOUBLE}'),
                )
            )
            return out
        out.append(
            Triple(qid, enc(PROB_NS + "proofCount"), enc(f'"{len(proofs)}"'))
        )
        for i, proof in enumerate(proofs):
            proof_node = enc(f"{PROB_NS}proof/{i}")
            out.append(Triple(qid, enc(PROB_NS + "hasProof"), proof_node))
            for sid, pos in proof:
                pred = PROB_NS + ("hasSeed" if pos else "hasNegatedSeed")
                out.append(Triple(proof_node, enc(pred), enc(f'"{sid}"')))
            formula = " & ".join(
                ("" if pos else "!") + f"s{sid}" for sid, pos in proof
            )
            out.append(
                Triple(proof_node, enc(PROB_NS + "formula"), enc(f'"{formula}"'))
            )
        return out
