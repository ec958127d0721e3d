"""Shared rule-application helpers for the CLI and HTTP frontends.

Parity: the /query handler's rule pipeline in
``kolibrie-http-server/src/main.rs`` — ``strip_hash_comments`` (:222),
``has_n3_rule_text`` (:216), N3-logic application via the Reasoner
(:985-1050), and SPARQL RULE processing via process_rule_definition
(:1053-1076).

Copy of ``kolibrie_tpu/frontends/rules.py`` for the PyTorch port, its imports
rewritten.
"""

from __future__ import annotations

from typing import List

from kolibrie_tpu_torch.core.triple import Triple


def strip_hash_comments(text: str) -> str:
    """Remove ``#`` comments without touching ``#`` inside IRIs or literals."""
    out: List[str] = []
    in_iri = False
    in_literal = False
    escaped = False
    skipping = False
    for ch in text:
        if skipping:
            if ch == "\n":
                skipping = False
                out.append(ch)
            continue
        if escaped:
            out.append(ch)
            escaped = False
            continue
        if ch == "\\" and in_literal:
            out.append(ch)
            escaped = True
            continue
        if ch == '"' and not in_iri:
            in_literal = not in_literal
        elif ch == "<" and not in_literal:
            in_iri = True
        elif ch == ">" and not in_literal:
            in_iri = False
        elif ch == "#" and not in_iri and not in_literal:
            skipping = True
            continue
        out.append(ch)
    return "".join(out)


def has_n3_rule_text(text: str) -> bool:
    return any(
        "=>" in line
        for line in text.splitlines()
        if not line.lstrip().startswith("#")
    )


def apply_n3_logic(db, n3_text: str) -> int:
    """Parse ``{ premise } => { conclusion }`` rules, run the semi-naive
    closure over the database's triples, and insert the inferred facts.

    Returns the number of newly inferred facts."""
    from kolibrie_tpu_torch.reasoner.n3_parser import parse_n3_document
    from kolibrie_tpu_torch.reasoner.rule_runtime import build_reasoner_from_db

    n3_text = strip_hash_comments(n3_text)
    if not has_n3_rule_text(n3_text):
        return 0
    kg = build_reasoner_from_db(db)
    for rule in parse_n3_document(n3_text, db.dictionary):
        kg.add_rule(rule)
    kg.infer_new_facts_semi_naive()
    new = kg.facts.triples_set() - db.store.triples_set()
    for key in new:
        db.store.add_triple(Triple(*key))
    return len(new)


def apply_sparql_rules(db, rule_texts: List[str]) -> int:
    """Process ``RULE :Name(...) :- ... => { ... }`` definitions (the full
    pipeline incl. TRAIN/ML.PREDICT, via rule_runtime)."""
    from kolibrie_tpu_torch.query.parser import parse_combined_query
    from kolibrie_tpu_torch.reasoner.rule_runtime import process_combined_rule

    total = 0
    for text in rule_texts:
        text = strip_hash_comments(text)
        if not text.strip():
            continue
        cq = parse_combined_query(text, db.prefixes)
        for rule in cq.rules:
            _, emitted = process_combined_rule(db, rule)
            total += len(emitted)
    return total
