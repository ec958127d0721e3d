"""SDD seed materialisation: build an SddProvenance tag store from SeedSpecs
(independent literals; exclusive groups via ``exactly_one`` ∧ literal), then
run provenance semi-naive.

Port of ``kolibrie_tpu/reasoner/sdd_seed.py`` (a copy, the imports rewritten).

Parity: ``datalog/src/reasoning/materialisation/sdd_seed_materialise.rs``
(:27-75) ``infer_new_facts_with_sdd_seed_specs``.
"""

from __future__ import annotations

from typing import List, Tuple

from kolibrie_tpu_torch.core.triple import Triple
from kolibrie_tpu_torch.reasoner.provenance_seminaive import infer_with_provenance
from kolibrie_tpu_torch.reasoner.sdd import SddProvenance
from kolibrie_tpu_torch.reasoner.seed_spec import ExclusiveGroupSeed, IndependentSeed
from kolibrie_tpu_torch.reasoner.tag_store import TagStore


def infer_new_facts_with_sdd_seed_specs(
    reasoner, seed_specs: List[object], seeds_only_delta: bool = False,
    base_store=None,
) -> Tuple[TagStore, SddProvenance]:
    """Returns (tag store after closure, the SddProvenance used).

    ``seeds_only_delta``: the caller guarantees ``reasoner.facts`` is already
    closed under the (NAF-free) rules, so the first semi-naive round needs
    only the seed triples as its delta — every derivation not reachable from
    a seed already exists with a certain (⊤) tag.  The neurosymbolic trainer
    uses this to make the per-sample closure proportional to the seed's
    derivation cone instead of the whole database.

    ``base_store`` (with ``seeds_only_delta``): a store equal to
    ``reasoner.facts`` WITHOUT the seed triples, borrowed read-only as the
    first round's old-side — lets repeated calls share its cached sort
    orders instead of re-deriving them per call.

    Safety: the exactly-once derivation invariant needs old ∩ delta = ∅.
    If a seed triple ALREADY exists in the facts (e.g. a prior ML.PREDICT
    materialized it), both flags are dropped for this call and the closure
    runs with the full delta — same semantics as an unseeded-base run.
    """
    if seeds_only_delta:
        for spec in seed_specs:
            triples = (
                [spec.triple]
                if isinstance(spec, IndependentSeed)
                else [t for t, _p, _sid in spec.choices]
            )
            if any(
                reasoner.facts.contains(t.subject, t.predicate, t.object)
                for t in triples
            ):
                seeds_only_delta = False
                base_store = None
                break
    prov = SddProvenance()
    store = TagStore(prov)
    mgr = prov.manager
    for spec in seed_specs:
        if isinstance(spec, IndependentSeed):
            # seeds without an explicit id stay unregistered in seed_vars —
            # gradients are keyed by explicit seed ids only, and registering
            # by allocation order would collide with numbered seeds
            tag = (
                prov.tag_from_probability_with_id(spec.prob, spec.seed_id)
                if spec.seed_id is not None
                else prov.tag_from_probability(spec.prob)
            )
            store.set(spec.triple, tag)
            reasoner.facts.add_triple(spec.triple)
        elif isinstance(spec, ExclusiveGroupSeed):
            members = []
            for triple, p, seed_id in spec.choices:
                var = mgr.new_var(
                    w_pos=p, w_neg=1.0, kind="exclusive", group_id=spec.group_id,
                    seed_id=seed_id,
                )
                if seed_id is not None:
                    prov.seed_vars[seed_id] = var
                members.append((triple, var))
            constraint = mgr.exactly_one([v for _, v in members])
            for triple, var in members:
                tag = mgr.conjoin(constraint, mgr.literal(var, True))
                store.set(triple, tag)
                reasoner.facts.add_triple(triple)
        else:
            raise TypeError(f"unknown seed spec {spec!r}")
    initial_delta = None
    if seeds_only_delta:
        initial_delta = set()
        for spec in seed_specs:
            if isinstance(spec, IndependentSeed):
                t = spec.triple
                initial_delta.add((t.subject, t.predicate, t.object))
            else:
                for triple, _p, _sid in spec.choices:
                    initial_delta.add(
                        (triple.subject, triple.predicate, triple.object)
                    )
    tag_store = infer_with_provenance(
        reasoner,
        prov,
        store,
        initial_delta=initial_delta,
        round1_old_store=base_store if seeds_only_delta else None,
    )
    return tag_store, prov
