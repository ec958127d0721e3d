"""Reasoner construction over a database, for rule evaluation.

Port of ``build_reasoner_from_db`` from ``kolibrie_tpu/reasoner/rule_runtime.py``
(parity: ``kolibrie/src/parser.rs:2499-2504``), built against the port's
:class:`Reasoner`.  The SPARQL RULE definitions of that module
(``convert_combined_rule``, ``process_combined_rule``) run provenance
semirings and come with the provenance slice.
"""

from __future__ import annotations

from kolibrie_tpu_torch.reasoner.reasoner import Reasoner


def build_reasoner_from_db(db) -> Reasoner:
    """Reasoner sharing the database dictionary, loaded with all triples and
    probability seeds (parser.rs:2499-2504).  It runs on the database's
    device."""
    kg = Reasoner(db.dictionary, device=db.device)
    kg.quoted = db.quoted
    kg.facts = db.store.clone()
    kg.probability_seeds = dict(getattr(db, "probability_seeds", {}) or {})
    return kg
