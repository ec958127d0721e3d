"""Semiring-generic semi-naive materialisation with stratified negation.

Port of ``kolibrie_tpu/reasoner/provenance_seminaive.py`` (a copy, the imports
rewritten; the device auto-route takes the CUDA card where the reference
takes the TPU).

Parity: ``datalog/src/reasoning/materialisation/provenance_semi_naive.rs`` —
delta also re-includes facts whose tags improved last round (:26-34,134-147),
per-derivation tag = ⊗ of premise tags merged with ⊕ (:163-193), zero-tag
pruning (:171), fixpoint = no new facts AND no tag change
(provenance_infer_generic.rs:94-97), seeding from ``probability_seeds``
sorted for deterministic seed IDs (:210-232), stratified NAF — positive
fixpoint then one negative pass where an absent fact contributes ``one()``
and a present fact contributes ``⊖(tag)`` (:235-389) — and the
explicit-delta entry for incremental SDS+
(``semi_naive_with_initial_tags_and_delta``, :271-294).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from kolibrie_tpu_torch.core.rule import Rule
from kolibrie_tpu_torch.core.triple import Triple
from kolibrie_tpu_torch.reasoner.provenance import Provenance
from kolibrie_tpu_torch.reasoner.strategies import (
    eval_rule_body,
    scan_pattern_cols,
    scan_pattern_store,
    table_len,
)
from kolibrie_tpu_torch.reasoner.tag_store import TagStore


TripleKey = Tuple[int, int, int]


def seed_tag_store(reasoner, provenance: Provenance) -> TagStore:
    """Build the initial TagStore from ``probability_seeds`` (sorted for
    deterministic seed IDs; :210-232)."""
    store = TagStore(provenance)
    for seed_id, (key, prob) in enumerate(sorted(reasoner.probability_seeds.items())):
        tag = provenance.tag_from_probability_with_id(prob, seed_id)
        store.set(Triple(*key), tag)
    return store


def _positive_stratum_rules(rules: List[Rule]) -> Tuple[List[Rule], List[Rule]]:
    pos = [r for r in rules if not r.negative_premise]
    neg = [r for r in rules if r.negative_premise]
    return pos, neg


def _derivation_rows(
    reasoner, rule: Rule, table, row_count: int
) -> List[Dict[str, int]]:
    """Materialize binding rows as var->id dicts (host loop; tags are
    pointer-structures so this boundary is inherently host-side)."""
    keys = [k for k in table.keys() if not k.startswith("__")]
    cols = [table[k] for k in keys]
    return [
        {k: int(c[i]) for k, c in zip(keys, cols)} for i in range(row_count)
    ]


def _pattern_key_rows(
    table, pattern, n: int, quoted
) -> Optional[List[TripleKey]]:
    """Substitute a pattern under all binding rows at once: one key tuple
    per row (columnar — no per-row dicts).  None when a variable is unbound
    (the caller skips the pattern wholesale, as _subst would row-wise)."""
    cols = []
    for t in (pattern.subject, pattern.predicate, pattern.object):
        if t.is_variable:
            c = table.get(t.value)
            if c is None:
                return None
            cols.append(c.tolist())
        elif t.is_quoted:
            inner_rows = _pattern_key_rows(table, t.value, n, quoted)
            if inner_rows is None or quoted is None:
                return None
            cols.append([quoted.intern(*k) for k in inner_rows])
        else:
            cols.append([int(t.value)] * n)
    return list(zip(*cols))


def _subst(pattern, row: Dict[str, int], quoted=None) -> Optional[TripleKey]:
    def term_id(t) -> Optional[int]:
        if t.is_variable:
            return row.get(t.value)
        if t.is_quoted:
            if quoted is None:
                return None
            inner = [term_id(x) for x in t.value.terms()]
            if any(i is None for i in inner):
                return None
            return quoted.intern(*inner)
        return t.value

    ids = []
    for t in (pattern.subject, pattern.predicate, pattern.object):
        v = term_id(t)
        if v is None:
            return None
        ids.append(v)
    return tuple(ids)


def _premise_tag(provenance, tag_store: TagStore, key: TripleKey):
    t = tag_store.get_opt(Triple(*key))
    return t if t is not None else provenance.one()


def infer_with_provenance(
    reasoner,
    provenance: Provenance,
    tag_store: Optional[TagStore] = None,
    initial_delta: Optional[Set[TripleKey]] = None,
    round1_old_store=None,
) -> TagStore:
    """Provenance semi-naive fixpoint; returns the final TagStore.

    ``initial_delta`` (incremental SDS+ entry): restrict the first round's
    delta to exactly these facts instead of all facts.

    ``round1_old_store``: caller-provided store equal to
    ``reasoner.facts`` minus ``initial_delta`` (i.e. the delta facts must
    NOT be in it).  Borrowed read-only for the first round — its cached
    sort orders survive across calls, which is what makes the trainer's
    10k-per-epoch seeded closures O(cone) each.  Later rounds copy-on-write
    before the incremental old-store maintenance mutates it.
    """
    if tag_store is None:
        tag_store = seed_tag_store(reasoner, provenance)

    # the scalar semirings (minmax/boolean/expiration/addmult) above the
    # size threshold run the whole tagged fixpoint on the device (tags as an
    # f64 column); None (the reference's declines) → host loop below.
    # Auto-routing takes the CUDA card only — the reference routes the TPU
    # only — so CPU callers opt in via infer_provenance_device directly.  A
    # device failure raises: nothing reruns on the host.
    from kolibrie_tpu_torch.reasoner import device_provenance

    if (
        device_provenance.supports(provenance)
        and reasoner.device.type == "cuda"
        and len(reasoner.facts) >= device_provenance.AUTO_MIN_FACTS
        and device_provenance.infer_provenance_device(
            reasoner, provenance, tag_store, initial_delta
        )
        is not None
    ):
        return tag_store
    return infer_with_provenance_host(
        reasoner, provenance, tag_store, initial_delta, round1_old_store
    )


def infer_with_provenance_host(
    reasoner,
    provenance: Provenance,
    tag_store: TagStore,
    initial_delta: Optional[Set[TripleKey]] = None,
    round1_old_store=None,
) -> TagStore:
    """The host loop of :func:`infer_with_provenance` (the same arguments,
    ``tag_store`` seeded): positive fixpoint, then the stratified negative
    pass, until the NAF pass derives nothing new."""
    pos_rules, neg_rules = _positive_stratum_rules(reasoner.rules)

    facts = reasoner.facts
    if initial_delta is not None:
        delta_keys: Set[TripleKey] = set(initial_delta)
    else:
        s, p, o = facts.columns()
        delta_keys = set(zip(s.tolist(), p.tolist(), o.tolist()))
    naf_seen: Set[Tuple] = set()  # processed NAF derivation signatures
    while True:
        delta_keys = _positive_fixpoint(
            reasoner,
            provenance,
            tag_store,
            pos_rules,
            facts,
            delta_keys,
            round1_old_store=round1_old_store,
        )
        round1_old_store = None  # only valid for the very first round
        naf_new = _negative_pass(
            reasoner, provenance, tag_store, neg_rules, facts, naf_seen
        )
        if not naf_new:
            break
        # NAF-derived facts feed back into the positive stratum
        delta_keys = naf_new
    return tag_store


def _sdd_batched_derive(
    mgr, tag_store, prem_rows, concl_rows, n: int
) -> Dict[TripleKey, object]:
    """One rule's derivations through the native SDD manager in BATCH:
    per-premise tag columns folded with one ``apply_batch`` per premise
    position (⊗ chain), zero-tag pruning as a mask, and one
    ``reduce_groups`` per conclusion pattern (⊕ per unique conclusion key,
    in row order — identical fold order to the per-row loop).

    SURVEY §7 "hard parts": the SDD boundary design — batch tags per
    derivation round between the device/columnar join side and the host
    SDD manager; replaces the per-row ctypes crossings that dominated
    structural-semiring closures (reasoner as of round 2:
    provenance_seminaive.py:190-326).
    """
    from kolibrie_tpu_torch.reasoner.sdd import FALSE, TRUE

    tags = tag_store.tags
    tag_col = None
    for pr in prem_rows:
        col = np.fromiter(
            (tags.get(k, TRUE) for k in pr), dtype=np.int64, count=n
        )
        tag_col = (
            col if tag_col is None else mgr.apply_batch(tag_col, col, "and")
        )
    if tag_col is None:  # no premises: cannot happen (rules require ≥1)
        return {}
    keep = tag_col != FALSE  # zero-tag pruning (:171)
    acc: Dict[TripleKey, object] = {}
    if not keep.any():
        return acc
    kept_tags = tag_col[keep]
    for cr in concl_rows:
        if cr is None:
            continue
        arr = np.asarray(cr, dtype=np.uint32)[keep]
        uniq, inv = np.unique(arr, axis=0, return_inverse=True)
        red = mgr.reduce_groups(kept_tags, inv, len(uniq), "or")
        for row, tag in zip(uniq.tolist(), red.tolist()):
            ckey = tuple(row)
            prev = acc.get(ckey)
            acc[ckey] = int(tag) if prev is None else mgr.disjoin(prev, int(tag))
    return acc


def _positive_fixpoint(
    reasoner,
    provenance,
    tag_store,
    pos_rules,
    facts,
    delta_keys,
    round1_old_store=None,
) -> Set[TripleKey]:
    # old = facts \ delta, so each derivation is found exactly once
    # (non-idempotent ⊕ must not see duplicates).  Both the old-store and
    # the membership set are maintained INCREMENTALLY across rounds — a
    # per-round rebuild makes deep (recursive-rule) fixpoints quadratic.
    # Membership test for "conclusion already known".  Two regimes:
    # - small delta over a big base (the trainer's per-sample seeded
    #   closures): NO Python materialization of the fact set — membership is
    #   a binary-search ``facts.count`` probe, and the round-1 old-store is a
    #   vectorized clone + pending deletes.  Keeps per-closure cost
    #   proportional to the seed's derivation cone, not the database.
    # - otherwise (full closure): one memoized set (SHARED with the store —
    #   read-only here) plus a local overlay of this fixpoint's additions.
    small_delta = round1_old_store is not None or (
        delta_keys and len(delta_keys) * 16 < len(facts)
    )
    base_keys: Optional[Set[TripleKey]] = (
        None if small_delta else facts.triples_set()
    )
    new_keys: Set[TripleKey] = set()
    old_store = None
    prev_delta: Set[TripleKey] = set()
    prev_new: Set[TripleKey] = set()
    while delta_keys:
        arr = np.asarray(sorted(delta_keys), dtype=np.uint32)
        delta_cols = (arr[:, 0], arr[:, 1], arr[:, 2])
        # Invariant: old_store = committed facts \ current delta, updated in
        # O(|delta|) per round (a full rebuild per round makes deep
        # recursive fixpoints quadratic):
        #   ADD    prev_delta \ delta   (left the delta → becomes old; the
        #          previous round's new facts all re-enter the delta, so
        #          nothing else grows old)
        #   REMOVE (delta \ prev_new) \ prev_delta   (an OLD fact whose tag
        #          improved re-enters the delta → hide from old)
        if old_store is None:
            if round1_old_store is not None:
                # borrowed: already equals facts \ delta, orders pre-built
                old_store = round1_old_store
            elif small_delta:
                # COW clone + pending deletes beats rebuilding from a
                # Python set of every fact
                old_store = facts.clone()
                for k in delta_keys:
                    old_store.remove(*k)
            else:
                old_store = reasoner._store_from(base_keys - delta_keys)
        else:
            if old_store is round1_old_store:
                old_store = old_store.clone()  # COW before maintenance
            grown = prev_delta - delta_keys
            if grown:
                g = np.asarray(sorted(grown), dtype=np.uint32)
                old_store.add_batch(g[:, 0], g[:, 1], g[:, 2])
            for k in (delta_keys - prev_new) - prev_delta:
                old_store.remove(*k)
        prev_delta = set(delta_keys)
        next_delta: Set[TripleKey] = set()
        round_new: Set[TripleKey] = set()  # buffered until the round ends
        for rule in pos_rules:
            table = eval_rule_body(
                reasoner, rule, facts, delta=delta_cols, old_store=old_store
            )
            n = table_len(table)
            if n == 0:
                continue
            # Columnar substitution: per-premise/conclusion key rows built
            # once; the remaining per-row work is tag algebra only.
            prem_rows = [
                _pattern_key_rows(table, p, n, reasoner.quoted)
                for p in rule.premise
            ]
            if any(pr is None for pr in prem_rows):
                continue
            concl_rows = [
                _pattern_key_rows(table, c, n, reasoner.quoted)
                for c in rule.conclusion
            ]
            tags_get = tag_store.tags.get
            one = provenance.one()
            conj = provenance.conjunction
            disj = provenance.disjunction
            is_zero = provenance.is_zero
            # Pre-aggregate this round's derivations per conclusion key
            # (⊕ is associative and saturate() is the identity for every
            # semiring, so one final update_disjunction per key is exact).
            mgr = getattr(provenance, "manager", None)
            if (
                getattr(provenance, "name", "") == "sdd"
                and mgr is not None
                and hasattr(mgr, "apply_batch")
                and n >= 32
            ):
                # batched SDD round: whole derivation columns cross into the
                # native manager ONCE per premise (chained ⊗) and once per
                # conclusion (segment ⊕) instead of one ctypes call per row
                acc = _sdd_batched_derive(
                    mgr, tag_store, prem_rows, concl_rows, n
                )
            else:
                acc: Dict[TripleKey, object] = {}
                for i in range(n):
                    tag = one
                    for pr in prem_rows:
                        ptag = tags_get(pr[i])
                        if ptag is not None:
                            tag = conj(tag, ptag)
                    if is_zero(tag):
                        continue  # zero-tag pruning (:171)
                    for cr in concl_rows:
                        if cr is None:
                            continue
                        ckey = cr[i]
                        prev = acc.get(ckey)
                        acc[ckey] = tag if prev is None else disj(prev, tag)
            for ckey, tag in acc.items():
                if base_keys is None:
                    # committed facts (base + prior rounds) live in the store
                    existed = ckey in round_new or facts.count(*ckey) > 0
                else:
                    existed = (
                        ckey in base_keys
                        or ckey in new_keys
                        or ckey in round_new
                    )
                changed = tag_store.update_disjunction(Triple(*ckey), tag)
                if not existed:
                    round_new.add(ckey)
                    next_delta.add(ckey)
                elif changed:
                    # tag improved: re-include in delta (:26-34)
                    next_delta.add(ckey)
        # commit this round's facts only now, so the full-store scans within
        # the round never see mid-round additions (each derivation must be
        # found exactly once — non-idempotent ⊕ safety)
        if round_new:
            rn = np.asarray(sorted(round_new), dtype=np.uint32)
            facts.add_batch(rn[:, 0], rn[:, 1], rn[:, 2])
            new_keys |= round_new
        prev_new = round_new
        delta_keys = next_delta
    return set()


def _negative_pass(
    reasoner, provenance, tag_store, neg_rules, facts, naf_seen: Set[Tuple]
) -> Set[TripleKey]:
    """Stratified NAF pass (:235-389); returns NEWLY added fact keys so the
    caller can feed them back into the positive stratum.  Each derivation is
    processed at most once across passes (non-idempotent ⊕ safety)."""
    new_keys: Set[TripleKey] = set()
    for rule_idx, rule in enumerate(neg_rules):
        pos_only = Rule(
            premise=rule.premise,
            negative_premise=[],
            filters=rule.filters,
            conclusion=rule.conclusion,
        )
        table = eval_rule_body(reasoner, pos_only, facts, delta=None)
        n = table_len(table)
        rows = _derivation_rows(reasoner, rule, table, n)
        for row in rows:
            sig = (rule_idx, tuple(sorted(row.items())))
            if sig in naf_seen:
                continue
            naf_seen.add(sig)
            tag = provenance.one()
            for prem in rule.premise:
                key = _subst(prem, row, reasoner.quoted)
                if key is None:
                    tag = provenance.zero()
                    break
                tag = provenance.conjunction(
                    tag, _premise_tag(provenance, tag_store, key)
                )
            for neg in rule.negative_premise:
                key = _subst(neg, row, reasoner.quoted)
                if key is None or not facts.contains(*key):
                    # absent fact: contributes one()
                    continue
                neg_tag = provenance.negate(
                    _premise_tag(provenance, tag_store, key)
                )
                tag = provenance.conjunction(tag, neg_tag)
            if provenance.is_zero(tag):
                continue
            for concl in rule.conclusion:
                ckey = _subst(concl, row, reasoner.quoted)
                if ckey is None:
                    continue
                existed = facts.contains(*ckey)
                tag_store.update_disjunction(Triple(*ckey), tag)
                facts.add(*ckey)
                if not existed:
                    new_keys.add(ckey)
    return new_keys


def semi_naive_with_initial_tags_and_delta(
    reasoner,
    provenance: Provenance,
    tag_store: TagStore,
    delta: Set[TripleKey],
) -> TagStore:
    """Explicit-delta entry point for incremental SDS+ (:271-294)."""
    return infer_with_provenance(
        reasoner, provenance, tag_store, initial_delta=delta
    )
