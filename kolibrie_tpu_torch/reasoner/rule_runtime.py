"""SPARQL RULE definitions over a database, and reasoner construction.

Port of ``kolibrie_tpu/reasoner/rule_runtime.py`` (parity:
``kolibrie/src/parser.rs`` ``convert_combined_rule`` :2256-2436 and
``process_rule_definition`` :2439-2734): a parsed
:class:`CombinedRule` becomes an ID-space datalog rule over a reasoner
holding the database's triples and probability seeds.  A classical rule's
closure runs through :meth:`Reasoner.infer_new_facts_semi_naive_parallel`
(the device fixpoint from 50,000 facts, the host strategy below that or
for a rule set the device lowering declines); a rule with ``PROB(...)``
runs the selected provenance semiring through
:func:`infer_with_provenance` (the device tagged fixpoint on the card for
the scalar semirings) and writes its tags into the database as
``<< s p o >> prob:value`` triples, with proof explanations for ``wmc`` /
``sdd``.  The R2S operator's facts are written back with one batch.  The
neural predicates a rule body names materialise first, and a rule with
``ML.PREDICT`` runs the prediction into the database before its closure.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from kolibrie_tpu_torch.core.rule import FilterCondition, Rule
from kolibrie_tpu_torch.core.store import _member_mask, _pack2
from kolibrie_tpu_torch.core.terms import Term, TriplePattern
from kolibrie_tpu_torch.core.triple import Triple
from kolibrie_tpu_torch.query import ast as A
from kolibrie_tpu_torch.reasoner.provenance import make_provenance
from kolibrie_tpu_torch.reasoner.provenance_seminaive import infer_with_provenance
from kolibrie_tpu_torch.reasoner.reasoner import Reasoner


def _convert_term(db, t: A.PatternTerm) -> Term:
    if t.kind == "var":
        return Term.variable(t.value)
    if t.kind == "quoted":
        s, p, o = t.value
        return Term.quoted(
            TriplePattern(_convert_term(db, s), _convert_term(db, p), _convert_term(db, o))
        )
    return Term.constant(db.dictionary.encode(db.expand_term(t.value)))


def _convert_pattern(db, p: A.PatternTriple) -> TriplePattern:
    return TriplePattern(
        _convert_term(db, p.subject),
        _convert_term(db, p.predicate),
        _convert_term(db, p.object),
    )


def _convert_filters(db, filters) -> List[FilterCondition]:
    out: List[FilterCondition] = []
    for f in filters:
        if not isinstance(f, A.Comparison):
            continue  # complex filters are handled only on the query path
        if isinstance(f.left, A.Var):
            var, rhs, op = f.left.name, f.right, f.op
        elif isinstance(f.right, A.Var):
            flip = {"<": ">", ">": "<", "<=": ">=", ">=": "<="}
            var, rhs, op = f.right.name, f.left, flip.get(f.op, f.op)
        else:
            continue
        if isinstance(rhs, A.NumberLit):
            out.append(FilterCondition(var, op, float(rhs.value)))
        elif isinstance(rhs, A.IriRef):
            out.append(FilterCondition(var, op, db.dictionary.encode(db.expand_term(rhs.iri))))
        elif isinstance(rhs, A.StringLit):
            out.append(FilterCondition(var, op, db.dictionary.encode(rhs.value)))
    return out


def convert_combined_rule(db, rule: A.CombinedRule) -> Rule:
    """AST rule -> ID-space datalog rule (parser.rs:2256 parity)."""
    premise = [_convert_pattern(db, p) for p in rule.body.patterns]
    negative = [_convert_pattern(db, p) for nb in rule.body.not_blocks for p in nb.patterns]
    # window-block patterns are part of the body for the non-streaming path
    for wb in rule.body.window_blocks:
        premise.extend(_convert_pattern(db, p) for p in wb.patterns)
    return Rule(
        premise=premise,
        negative_premise=negative,
        filters=_convert_filters(db, rule.body.filters),
        conclusion=[_convert_pattern(db, c) for c in rule.conclusions],
    )


def build_reasoner_from_db(db) -> Reasoner:
    """Reasoner sharing the database dictionary, loaded with all triples and
    probability seeds (parser.rs:2499-2504).  It runs on the database's
    device."""
    kg = Reasoner(db.dictionary, device=db.device)
    kg.quoted = db.quoted
    kg.facts = db.store.clone()
    kg.probability_seeds = dict(getattr(db, "probability_seeds", {}) or {})
    return kg


def _new_rows(after, before) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The rows of the SPO-sorted unique columns ``after`` that are not in
    ``before`` (also SPO-sorted), in SPO order."""
    fresh = ~_member_mask(_pack2(after[0], after[1]), after[2], _pack2(before[0], before[1]), before[2])
    return tuple(c[fresh] for c in after)


def process_combined_rule(db, rule: A.CombinedRule) -> Tuple[Rule, List[Triple]]:
    """Register and immediately apply a RULE definition
    (process_rule_definition parity): the closure of the database's
    triples under the rule, and the R2S operator's facts written to the
    store.  Returns the rule and the emitted facts (SPO order; the
    reference's order is its set difference's, and the store is a set)."""
    if db.neural_relations:
        # rule bodies referencing neural predicates materialize first
        # (parser.rs:2482 parity)
        from kolibrie_tpu_torch.ml import runtime as ml_runtime
        from kolibrie_tpu_torch.query.executor import collect_all_patterns

        ml_runtime.materialize_neural_relations_for_patterns(
            db, collect_all_patterns(rule.body)
        )
    kg = build_reasoner_from_db(db)
    dynamic_rule = convert_combined_rule(db, rule)
    db.rule_map[rule.name] = dynamic_rule
    if rule.ml_predict is not None:
        from kolibrie_tpu_torch.ml import runtime as ml_runtime

        ml_runtime.execute_ml_predict(db, rule.ml_predict)
        kg.facts = db.store.clone()
    before = kg.facts.columns()
    kg.add_rule(dynamic_rule)
    if rule.prob is not None:
        prov = make_provenance(rule.prob.combination, rule.prob.k)
        tag_store = infer_with_provenance(kg, prov)
        # materialize << s p o >> prob:value tags into the database, with
        # the proof explanations for the proof-set semirings
        star: List[Triple] = []
        if rule.prob.combination in ("wmc", "sdd"):
            for (s, p, o), _tag in tag_store.items():
                star.extend(tag_store.explain_proofs(db, Triple(s, p, o)))
        star.extend(tag_store.encode_as_rdf_star(db))
        if star:
            db.store.add_batch(*np.asarray(star, dtype=np.uint32).T)
    else:
        kg.infer_new_facts_semi_naive_parallel()
    inferred = _new_rows(kg.facts.columns(), before)
    # R2S at definition time: RSTREAM (the default) and ISTREAM emit every
    # inferred fact (nothing was emitted before); DSTREAM emits nothing
    stream_type = rule.stream_type or A.StreamType.RSTREAM
    if stream_type == A.StreamType.DSTREAM:
        inferred = tuple(c[:0] for c in inferred)
    if len(inferred[0]):
        db.store.add_batch(*inferred)
    emitted = [Triple(*t) for t in zip(*(c.tolist() for c in inferred))]
    return dynamic_rule, emitted
