"""Device provenance semi-naive fixpoint for the scalar semirings.

Port of ``kolibrie_tpu/reasoner/device_provenance.py``.  The host
provenance loop (:mod:`kolibrie_tpu_torch.reasoner.provenance_seminaive`)
runs per-derivation tag algebra in Python.  For the three IDEMPOTENT scalar
semirings — MinMax (fuzzy), Boolean, Expiration (the cross-window SDS+
workhorse) — the whole algebra collapses onto one device form: tags are an
f64 column, ⊗ (conjunction over a derivation's premises) is ``min`` and
⊕ (disjunction over derivations of the same fact) is ``max``:

- minmax:     tags in [0,1] verbatim,     zero 0.0, one 1.0
- boolean:    False/True → 0.0/1.0,       zero 0.0, one 1.0
- expiration: expiry timestamps → f64 (exact below 2^53; FOREVER → +inf),
              zero 0.0 (expired), one +inf (static)

Because ⊕ is idempotent, duplicate discoveries of the same derivation are
harmless — the per-seed delta expansion (every premise position seeded from
the delta, remaining positions joined against ALL facts) needs no old/delta
store split.

The NON-idempotent AddMult semiring (⊕ = noisy-OR a+b−ab, ⊗ = product)
runs a separate round (:func:`_prov_round_addmult`) with exactly-once
derivation accounting: old/delta premise decomposition, the delta carried
as fact-row indices, and per-group ⊕ as a segment noisy-OR in log space.
Only the structural semirings (SDD/TopK/DNF), whose tags are pointer-shaped
proof objects, stay host-side.

A round queues its device work eagerly: delta-seeded premise joins with
the tag carried through the join chain, filter masks, conclusion
instantiation, the (s, p, o) grouping sort, the match-against-facts lookup,
fact append + tag improvement into new buffers, and the next delta = new
facts ∪ tag-improved facts.  The host reads ONE scalar triple per round
(overflow code, fact count, delta count), which both commits the round
and ends the loop; an overflowing round is dropped (its buffers are never
adopted) and the host doubles the failing capacity, the same protocol as
the reference's :func:`_run_overflow_protocol`.

Port notes:

- Kernels: every premise scan's constant clauses run as one fused
  ``filter_mask`` launch (``device_fixpoint._scan_premise``) and every
  premise join goes through ``ranked_merge_join_indices`` (the merge-path
  kernel), whose ``(li, ri, valid, total)`` pairs come in the same order as
  the reference's ``join_indices``: left row by left row, each row's matches
  in the right side's stable sort order.  The f64 tag algebra stays plain
  PyTorch ops, as it is plain XLA in the reference; the f32 ``tag_combine``
  kernel is on no path here, as in the reference.
- Multi-key sorts are stable sorts from the last key, with u32 key pairs
  packed into one int64 carrier.  The idempotent commit's 4-key sort keys
  the tag as ``-tag + 0.0``, so ``-0.0`` and ``0.0`` tie on every device as
  they do in ``lax.sort``; the group head carries the original tag bits.
- AddMult's group ⊕ sums ``log1p(-p)`` per (s, p, o) group with
  ``torch.segment_reduce`` over the stably sorted rows: a segmented
  reduction with a fixed order and no atomics, so the tags, and the rounds
  the 1e-12 change cutoff yields, are the same from run to run.  A group
  of one derivation keeps its tag verbatim, as the host inserts it.
- Failures raise: a capacity that does not converge within
  ``max_attempts`` doublings, or a closure past the round limit, raises
  ``RuntimeError`` instead of returning None.  None is returned only where
  the reference declines a program (:func:`infer_provenance_device`).
- ``LAST_RUN`` records the last run's dispatches ``(kind, caps, code)``,
  committed rounds and overflow attempts (the EXPLAIN-style counters).

Parity: ``datalog/.../provenance_semi_naive.rs:26-34,134-197`` (delta
re-inclusion of improved tags, per-derivation ⊗, ⊕ merge, zero-pruning) —
redesigned as whole-column device programs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from kolibrie_tpu_torch.backend import _LPAD, _RPAD, SENT, pack2
from kolibrie_tpu_torch.ops import round_cap as _round_cap
from kolibrie_tpu_torch.ops.device_join import pack_key_multi
from kolibrie_tpu_torch.ops.kernels import ranked_merge_join_indices
from kolibrie_tpu_torch.reasoner.device_fixpoint import (
    Unsupported,
    _Caps,
    _eval_filters,
    _pack,
    _scan_premise,
    lower_rules,
)

__all__ = [
    "supports", "supports_idempotent", "infer_provenance_device", "AUTO_MIN_FACTS", "LAST_RUN",
]

# below this many facts the host loop wins (device round trips).  On an
# H100 80GB HBM3 at 700 W (chip_profile.py::profile_prov_crossover, the
# 2-hop observes graph, two or three runs a size) the device closure was
# level with the host loop at 2,145 facts (0.94-1.6x its speed), 1.7-4.1x
# faster at 5,204 facts and 1.2-5.3x slower at 437-1,723 facts, under
# Expiration, MinMax and AddMult alike.
AUTO_MIN_FACTS = 2_000

_IDEMPOTENT = ("minmax", "boolean", "expiration")

# addmult (noisy-OR/product) is NON-idempotent: it runs a separate round
# with exactly-once derivation accounting (see _prov_round_addmult)
_DEVICE_SEMIRINGS = _IDEMPOTENT + ("addmult",)

_EXP_FOREVER = 0xFFFF_FFFF_FFFF_FFFF

# host TagStore parity: AddMultProbability.tag_eq treats |Δ| < 1e-12 as
# "unchanged", which is also what terminates cyclic noisy-OR fixpoints
_ADDMULT_TAG_EQ = 1e-12

ROUND_LIMIT = 10_000

# the last run's counters: every dispatch as (kind, caps, overflow code),
# with kind "round" | "round_addmult" | "naf" | "naf_addmult" and caps
# (F, D, J) (+ the seen-set capacity for "naf_addmult"); the committed
# dispatches ("rounds"), the overflowed ones ("attempts"), the final caps
LAST_RUN: Dict[str, object] = {"dispatches": [], "rounds": 0, "attempts": 0, "caps": None}


def _record(kind: str, caps: tuple, code: int) -> None:
    LAST_RUN["dispatches"].append((kind, caps, code))
    LAST_RUN["caps"] = caps
    if code:
        LAST_RUN["attempts"] += 1
    else:
        LAST_RUN["rounds"] += 1


def supports(provenance) -> bool:
    return getattr(provenance, "name", None) in _DEVICE_SEMIRINGS


def supports_idempotent(provenance) -> bool:
    """True only for the scalar-IDEMPOTENT semirings (min/max tag algebra).
    The distributed tagged round's idempotent kind has no exactly-once
    accounting, so it gates on THIS predicate, not :func:`supports`."""
    return getattr(provenance, "name", None) in _IDEMPOTENT


def _addmult_order_sensitive(rules) -> bool:
    """True when within-round tag updates could be VISIBLE to a later rule,
    making the non-idempotent fixpoint depend on rule evaluation order.

    The host loop (reference parity: ``provenance_semi_naive.rs:163-193``
    reads ``tag_store.get_tag`` live) lets rule j read a tag that rule i<j
    improved in the same round; the device round reads a round-start
    snapshot.  For idempotent ⊕ both converge to the same fixpoint; for
    addmult the accumulated noisy-OR values genuinely differ.  The device
    path therefore only takes rule sets where rule i's conclusion predicates
    never feed rule j>i's premises — then no mid-round improvement can be
    observed and snapshot ≡ live.  (A rule's OWN conclusions are safe: the
    host pre-aggregates per rule and writes after it.)  Variable predicates
    count as wildcards."""

    def preds(terms):
        out = set()
        for t in terms:
            p = t.predicate
            out.add(None if p.is_variable else int(p.value))
        return out

    for i, ri in enumerate(rules):
        concl = preds(ri.conclusion)
        for rj in rules[i + 1:]:
            prem = preds(rj.premise)
            if None in concl or None in prem or (concl & prem):
                return True
    return False


def _encode_tags(provenance, tags) -> np.ndarray:
    name = provenance.name
    if name == "boolean":
        return np.asarray([1.0 if t else 0.0 for t in tags], dtype=np.float64)
    if name == "expiration":
        return np.asarray(
            [np.inf if t >= _EXP_FOREVER else float(t) for t in tags],
            dtype=np.float64,
        )
    return np.asarray(tags, dtype=np.float64)


def _decode_tags(provenance, vals: np.ndarray) -> list:
    """Vectorized inverse of :func:`_encode_tags` (shared by the single-chip
    and distributed write-backs)."""
    name = provenance.name
    if name == "boolean":
        return (vals > 0.5).tolist()
    if name == "expiration":
        return [
            _EXP_FOREVER if np.isinf(v) else int(round(v))
            for v in vals.tolist()
        ]
    return vals.tolist()


def _seed_tag_arrays(provenance, tag_store, cols) -> Tuple[np.ndarray, float]:
    """(tags0, one_enc) for the fact columns ``cols`` (on the device): NaN =
    "no explicit TagStore entry" (premise reads see one(); the first
    derivation overwrites — update_disjunction parity).  Shared by both
    device drivers.  Entries of absent facts are ignored, as in the
    reference.

    Tags are read with ``tag_store.tags.get`` semantics.  A plain dict is
    looked up by its own keys on the device; a map whose ``get`` resolves
    more than its own entries (the incremental SDS+ overlay, which falls
    back to the prior windows' expiries) is read with one ``get`` per fact,
    as the reference does for every map."""
    one_enc = float(_encode_tags(provenance, [provenance.one()])[0])
    n = cols[0].shape[0]
    tags = tag_store.tags
    if type(tags).get is not dict.get:
        tget = tags.get
        host = [tget(k) for k in zip(*(c.cpu().tolist() for c in cols))]
        absent = np.fromiter((t is None for t in host), dtype=bool, count=n)
        one = provenance.one()
        enc = _encode_tags(provenance, [one if t is None else t for t in host])
        return np.where(absent, np.nan, enc), one_enc
    tags0 = np.full(n, np.nan)
    if tags:
        rows = _fact_rows(cols, list(tags.keys()))
        vals = _encode_tags(provenance, list(tags.values()))
        hit = rows < n
        tags0[rows[hit]] = vals[hit]
    return tags0, one_enc


def _guard_tag_array(rules, provenance, tag_store) -> np.ndarray:
    """Per-rule encoded ⊗ of the rule's ground-guard tags (one() when the
    rule has no guards).  Guards are non-derivable by construction
    (lower_rules), so these values are CONSTANT through the closure —
    one dynamic operand, no recompile per tag value."""
    out = []
    for r in rules:
        t = provenance.one()
        for g in r.guards:
            gt = tag_store.tags.get(tuple(g.consts))
            if gt is not None:
                t = provenance.conjunction(t, gt)
        out.append(t)
    return _encode_tags(provenance, out) if out else np.zeros(0, np.float64)


# ---------------------------------------------------------------------------
# Device building blocks
# ---------------------------------------------------------------------------


def _scatter_drop(base: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """A copy of ``base`` with ``vals`` written at ``idx``; indices at or
    past ``len(base)`` are dropped (the reference's ``.at[idx].set(vals,
    mode="drop")``): they land in one spare slot that is cut off."""
    n = base.shape[0]
    out = torch.cat([base, base.new_zeros(1)])
    out.index_put_((idx.clamp(max=n),), vals if torch.is_tensor(vals) else torch.as_tensor(
        vals, dtype=base.dtype, device=base.device))
    return out[:n]


def _lex_perm(keys: List[torch.Tensor]) -> torch.Tensor:
    """Permutation sorting rows lexicographically by the u32 ``keys`` (the
    reference's ``lax.sort(num_keys=len(keys))``), ties in row order:
    stable sorts from the last key, two u32 keys packed into one int64
    carrier per sort."""
    groups = [keys[i:i + 2] for i in range(0, len(keys), 2)]
    perm = None
    for g in reversed(groups):
        k = g[0] if len(g) == 1 else pack2(g[0], g[1])
        if perm is None:
            perm = torch.sort(k, stable=True).indices
        else:
            perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def _isnew(cols) -> torch.Tensor:
    """First row of each run of equal rows (over sorted columns)."""
    head = torch.ones(cols[0].shape[0], dtype=torch.bool, device=cols[0].device)
    if cols[0].shape[0] > 1:
        diff = cols[0][1:] != cols[0][:-1]
        for c in cols[1:]:
            diff = diff | (c[1:] != c[:-1])
        head[1:] = diff
    return head


def _join_keys(table, ptable, kv, valid, pm):
    """Join keys for a premise-join step: 1-2 shared variables pack
    exactly; 3+ ride the union dense-rank composition (the same
    ``pack_key_multi`` path as the untagged fixpoint)."""
    if len(kv) > 2:
        return pack_key_multi([table[v] for v in kv], [ptable[v] for v in kv], valid, pm)
    return (
        _pack([table[v] for v in kv], valid, _LPAD),
        _pack([ptable[v] for v in kv], pm, _RPAD),
    )


def _join_step(table, valid, premise, kv, fcols, pvalid, J, overflow):
    """Scan ``premise`` over the fact buffer (rows where ``pvalid``) and
    join it onto ``table`` on the key variables ``kv`` through the
    merge-path kernel.  Returns ``(table, valid, li, ri, overflow)``:
    ``overflow`` gains bit0 when the join's matches exceed ``J``."""
    ptable, pm = _scan_premise(premise, fcols, pvalid)
    lkey, rkey = _join_keys(table, ptable, kv, valid, pm)
    li, ri, jvalid, total = ranked_merge_join_indices(lkey, rkey, J)
    overflow = overflow | (total > J).to(torch.int64)
    new_table = {v: c[li] for v, c in table.items()}
    for v, c in ptable.items():
        if v not in new_table:
            new_table[v] = c[ri]
    return new_table, jvalid, li, ri, overflow


def _concl_parts(rule, table, tag, valid, parts) -> None:
    """Instantiate the rule's conclusions over the binding table as
    ``(s, p, o, tag, valid)`` candidate blocks."""
    n = valid.shape[0]
    for concl in rule.concls:
        out = [
            table[v] if kind == "var"
            else torch.full((n,), v, dtype=torch.int64, device=valid.device)
            for kind, v in concl
        ]
        parts.append((out[0], out[1], out[2], tag, valid))


def _fact_lookup(qs, qp, qo, qvalid, fs, fp, fo, fvalid, F):
    """Exact ground (s,p,o) → fact-row lookup: dense-rank the (s,p) pair
    over the union, pack with o, binary-search the sorted fact keys.
    Returns ``(found, fidx)`` with ``fidx == F`` for misses.  Relies on
    dictionary IDs never reaching 0xFFFFFFFF."""
    fsp = pack2(torch.where(fvalid, fs, SENT), torch.where(fvalid, fp, SENT))
    usp = pack2(torch.where(qvalid, qs, SENT), torch.where(qvalid, qp, SENT))
    union = torch.sort(torch.cat([fsp, usp])).values
    rank_f = torch.searchsorted(union, fsp)
    rank_u = torch.searchsorted(union, usp)
    fkey = pack2(rank_f, torch.where(fvalid, fo, SENT))
    ukey = pack2(rank_u, torch.where(qvalid, qo, SENT))
    fsorted, forder = torch.sort(fkey, stable=True)
    pos = torch.searchsorted(fsorted, ukey).clamp_(0, F - 1)
    found = qvalid & (fsorted[pos] == ukey)
    fidx = torch.where(found, forder[pos], F)
    return found, fidx


def _fact_rows(cols, keys) -> np.ndarray:
    """Host row of each ``(s, p, o)`` key of ``keys`` in the fact columns
    ``cols``, through the rounds' :func:`_fact_lookup`; ``len(cols[0])``
    for a key that is no fact."""
    n = cols[0].shape[0]
    dev = cols[0].device
    q = torch.from_numpy(np.asarray(keys, dtype=np.int64).reshape(-1, 3)).to(dev)
    qvalid = torch.ones(q.shape[0], dtype=torch.bool, device=dev)
    fvalid = torch.ones(n, dtype=torch.bool, device=dev)
    _, fidx = _fact_lookup(q[:, 0], q[:, 1], q[:, 2], qvalid, *cols, fvalid, n)
    return fidx.cpu().numpy()


def _cat_parts(parts):
    return tuple(torch.cat([p[i] for p in parts]) for i in range(5))


def _commit_parts(
    parts, caps, fs, fp, fo, ftag, n_facts, ds, dp, do, dtag, overflow,
    fresh_delta_only=False,
):
    """Shared commit tail of the idempotent round and NAF pass: dedup
    candidate conclusions by (s,p,o) keeping each group's ⊕-max tag, look
    them up against the fact columns, append new facts / improve tags in
    new buffers, and emit the next delta (new ∪ changed facts — or new
    ONLY under ``fresh_delta_only``, the NAF-pass contract: the host
    stratified loop feeds just ``naf_new`` KEYS back into the positive
    stratum, so a tag-improved existing fact must NOT re-fire it).

    Reads the round's one host triple and returns the reference's tuple
    ``(fs, fp, fo, ftag, n_facts, ds, dp, do, dtag, n_delta, code)`` with
    host ints for the last three: the new state, or on overflow the state
    passed in with ``n_delta`` 0."""
    F, D = caps.fact, caps.delta
    dev = fs.device
    fvalid = torch.arange(F, device=dev) < n_facts
    cs, cp, co, ctag, cv = _cat_parts(parts)

    # group candidates by (s,p,o), each group's FIRST row carrying its max
    # tag: 4-key sort with -tag as the tie-breaking key (⊕ = max)
    ss = torch.where(cv, cs, SENT)
    sp = torch.where(cv, cp, SENT)
    so = torch.where(cv, co, SENT)
    stag = torch.where(cv, ctag, 0.0)
    perm = torch.sort(-stag + 0.0, stable=True).indices
    perm = perm[_lex_perm([ss[perm], sp[perm], so[perm]])]
    ss, sp, so, utag = ss[perm], sp[perm], so[perm], stag[perm]
    isnew = _isnew((ss, sp, so)) & (ss != SENT)
    n_uniq = isnew.sum()
    overflow = overflow | (n_uniq > D).to(torch.int64) << 1
    dest = torch.where(isnew, torch.cumsum(isnew, 0) - 1, D)
    zeros_d = torch.zeros(D, dtype=torch.int64, device=dev)
    us, up, uo = (_scatter_drop(zeros_d, dest, c) for c in (ss, sp, so))
    ut = _scatter_drop(torch.zeros(D, dtype=torch.float64, device=dev), dest, utag)
    uvalid = torch.arange(D, device=dev) < n_uniq

    found, fidx = _fact_lookup(us, up, uo, uvalid, fs, fp, fo, fvalid, F)
    old_tag = ftag[fidx.clamp(0, F - 1)]
    # update_disjunction parity: no entry (NaN) → first derivation
    # OVERWRITES; an existing entry ⊕-merges (max), changed iff it grew
    absent = found & torch.isnan(old_tag)
    improved = found & (ut > old_tag)  # NaN compares False
    changed = absent | improved
    fresh = uvalid & ~found

    # append new facts (tags included)
    n_facts_next = n_facts + fresh.sum()
    overflow = overflow | (n_facts_next > F).to(torch.int64) << 2
    adest = torch.where(fresh, n_facts + torch.cumsum(fresh, 0) - 1, F)
    nfs, nfp, nfo = (_scatter_drop(c, adest, u) for c, u in ((fs, us), (fp, up), (fo, uo)))
    nftag = _scatter_drop(ftag, adest, ut)
    # in-place store for changed facts: overwrite when absent, else the
    # grown max (ut > old ⇒ max(old, ut) = ut in both cases)
    nftag = _scatter_drop(nftag, torch.where(changed, fidx, F), ut)

    # next delta = new ∪ changed facts, with their stored tags
    dmask = fresh if fresh_delta_only else (fresh | changed)
    n_dnext = dmask.sum()
    ddest = torch.where(dmask, torch.cumsum(dmask, 0) - 1, D)
    nds, ndp, ndo = (_scatter_drop(zeros_d, ddest, u) for u in (us, up, uo))
    ndt = _scatter_drop(torch.zeros(D, dtype=torch.float64, device=dev), ddest, ut)

    code, n_next, n_d = torch.stack([overflow, n_facts_next, n_dnext]).tolist()  # the one sync
    if code:
        return fs, fp, fo, ftag, n_facts, ds, dp, do, dtag, 0, code
    return nfs, nfp, nfo, nftag, n_next, nds, ndp, ndo, ndt, n_d, 0


# ---------------------------------------------------------------------------
# Idempotent round
# ---------------------------------------------------------------------------


def _prov_round(
    rules: tuple, caps: _Caps, fs, fp, fo, ftag, n_facts, ds, dp, do, dtag, n_delta,
    one_enc, masks, gtags,
):
    """One tagged semi-naive round.  Returns the updated fact columns/tags,
    the next delta (new ∪ changed facts, with their stored tags), the count
    of delta entries, and an overflow bitmask (bit0 join, bit1 delta cap,
    bit2 fact cap).  An overflowing round does not commit.

    Tag-store parity: ``ftag`` mirrors the host TagStore exactly — NaN
    means "no explicit entry" (premise reads see ``one_enc``), and a fact's
    FIRST derivation overwrites (``update_disjunction`` inserts the new tag
    when no entry exists) while later derivations ⊕-merge with ``max``.
    Delta tags (``dtag``) are effective values, never NaN."""
    F, J = caps.fact, caps.join
    dev = fs.device
    fvalid = torch.arange(F, device=dev) < n_facts
    dvalid = torch.arange(ds.shape[0], device=dev) < n_delta
    fcols, dcols = (fs, fp, fo), (ds, dp, do)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    parts: List[tuple] = []
    for r_idx, rule in enumerate(rules):
        for order, keys in rule.plans:
            table, valid = _scan_premise(rule.premises[order[0]], dcols, dvalid)
            # statically-satisfied ground guards contribute their (closure-
            # constant) tags to every derivation's ⊗ — one() when no guards
            tag = torch.minimum(dtag, gtags[r_idx])
            for step, j in enumerate(order[1:]):
                table, valid, li, ri, overflow = _join_step(
                    table, valid, rule.premises[j], keys[step], fcols, fvalid, J, overflow)
                # ⊗ = min: a derivation is as strong as its weakest premise;
                # an absent (NaN) entry reads as one() for premises
                ptag = ftag[ri]
                tag = torch.minimum(tag[li], torch.where(torch.isnan(ptag), one_enc, ptag))
            valid = _eval_filters(rule, table, valid, masks)
            # zero-tag pruning (provenance_semi_naive.rs:171)
            _concl_parts(rule, table, tag, valid & (tag > 0.0), parts)
    return _commit_parts(parts, caps, fs, fp, fo, ftag, n_facts, ds, dp, do, dtag, overflow)


# ---------------------------------------------------------------------------
# Stratified NAF pass (idempotent semirings)
# ---------------------------------------------------------------------------


def _concl_unifies_neg(concl, neg) -> bool:
    """Conservative syntactic unification of a conclusion pattern with a
    negated premise — variables unify with anything."""
    return all(
        kind != "const" or c is None or c == v
        for (kind, v), c in zip(concl, neg.consts)
    )


def _naf_cross_blocking(naf_rules) -> bool:
    """True when some NAF rule's conclusion pattern could unify with some
    NAF rule's NEGATED premise (including its own): within one negative
    pass the host's sequential fact commits make the outcome order-
    dependent.  Such programs take the SEQUENTIAL per-rule driver (host
    rule order reproduced dispatch by dispatch); only the within-rule case
    (:func:`_naf_self_blocking`) declines to the host."""
    for ra in naf_rules:
        for concl in ra.concls:
            for rb in naf_rules:
                for neg in rb.negs:
                    if _concl_unifies_neg(concl, neg):
                        return True
    return False


def _naf_self_blocking(naf_rules) -> bool:
    """True when a NAF rule's conclusion unifies a negated premise OF THE
    SAME rule: the host commits that rule's derivations row by row, so an
    earlier row's conclusion can block a later row of the same evaluation
    — an order no snapshot pass or per-rule sequencing reproduces."""
    for r in naf_rules:
        for concl in r.concls:
            for neg in r.negs:
                if _concl_unifies_neg(concl, neg):
                    return True
    return False


def _naf_premise_drift(all_rules, naf_rules) -> bool:
    """True when a NAF pass's output can REACH a NAF rule's positive
    premise through the rule graph.  Then a premise tag read by a NAF body
    can improve BETWEEN passes, and the host's exactly-once ``naf_seen``
    skip (which freezes each derivation's first-read tags) becomes
    load-bearing — a snapshot recomputation would ⊕-merge the improved
    value.  NAF bodies over predicates that are derived but FINAL before
    the first pass (no feedback from NAF conclusions) are safe.

    Predicate-level reachability, conservative: variable predicates are
    wildcards; guard premises are excluded (non-derivable by
    construction)."""
    reach: Set[int] = set()  # predicate ids reachable from NAF conclusions
    wild = False  # a variable-predicate conclusion reaches everything

    def add_concls(r) -> bool:
        nonlocal wild
        changed = False
        for c in r.concls:
            kind, v = c[1]
            if kind == "const":
                if v not in reach:
                    reach.add(v)
                    changed = True
            elif not wild:
                wild = True
                changed = True
        return changed

    for nr in naf_rules:
        add_concls(nr)
    changed = True
    while changed:
        changed = False
        for r in all_rules:
            prem_preds = [p.consts[1] for p in r.premises]
            fires = wild or any(
                (pp is None and reach) or (pp in reach) for pp in prem_preds
            )
            if fires and add_concls(r):
                changed = True
    for nr in naf_rules:
        for p in nr.premises:
            pp = p.consts[1]
            if wild or (pp is None and reach) or pp in reach:
                return True
    return False


def _negate_enc(t, neg_kind):
    """⊖ on the f64 tag encoding.  ``complement``: 1 − t (minmax fuzzy
    complement; boolean 0/1 flip).  ``expiration``: an expired premise
    (NEVER → 0.0) negates to FOREVER (+inf) and any live one to NEVER
    (provenance.rs negate parity)."""
    if neg_kind == "expiration":
        return torch.where(t == 0.0, float("inf"), 0.0).to(torch.float64)
    return 1.0 - t


def _ground_neg(neg, table, n, dev):
    """The negated pattern grounded per derivation row: constants, bound
    variables (lowering guarantees binding), repeats."""
    qcol: list = [None, None, None]
    for pos_i, c in enumerate(neg.consts):
        if c is not None:
            qcol[pos_i] = torch.full((n,), c, dtype=torch.int64, device=dev)
    for v, pos_i in neg.vars:
        qcol[pos_i] = table[v]
    for a, b in neg.eq_pairs:
        qcol[b] = qcol[a]
    return qcol


def _prov_naf_pass(
    rules: tuple, caps: _Caps, fs, fp, fo, ftag, n_facts, ds, dp, do, dtag, one_enc,
    masks, neg_kind, gtags,
):
    """One stratified NAF pass over the QUIESCED positive fixpoint: each
    NAF rule's positive body is evaluated against ALL facts (no delta
    decomposition — ⊕ is idempotent, so re-derivation is harmless), the
    per-row tag is the ⊗-chain of premise tags, and every negative premise
    contributes ``one()`` when its ground instantiation is absent from the
    facts and ``⊖tag`` when present (provenance_semi_naive.rs:235-389).
    Same state contract / return tuple as :func:`_prov_round`; the ``ds``
    inputs are the (drained) delta buffers, passed for the non-commit
    fallback and output shapes."""
    F, J = caps.fact, caps.join
    dev = fs.device
    fvalid = torch.arange(F, device=dev) < n_facts
    fcols = (fs, fp, fo)
    eff = torch.where(torch.isnan(ftag), one_enc, ftag)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    parts: List[tuple] = []
    for r_idx, rule in enumerate(rules):
        # one plan suffices: the body runs against the full fact store
        order, keys = rule.plans[0]
        table, valid = _scan_premise(rule.premises[order[0]], fcols, fvalid)
        tag = torch.minimum(eff, gtags[r_idx])
        for step, j in enumerate(order[1:]):
            table, valid, li, ri, overflow = _join_step(
                table, valid, rule.premises[j], keys[step], fcols, fvalid, J, overflow)
            tag = torch.minimum(tag[li], eff[ri])
        valid = _eval_filters(rule, table, valid, masks)
        n = valid.shape[0]
        for neg in rule.negs:
            q = _ground_neg(neg, table, n, dev)
            found, fidx = _fact_lookup(q[0], q[1], q[2], valid, fs, fp, fo, fvalid, F)
            ntag = _negate_enc(eff[fidx.clamp(0, F - 1)], neg_kind)
            tag = torch.minimum(tag, torch.where(found, ntag, one_enc))
        # zero-tag pruning (a certainly-blocked derivation adds nothing)
        _concl_parts(rule, table, tag, valid & (tag > 0.0), parts)
    return _commit_parts(
        parts, caps, fs, fp, fo, ftag, n_facts, ds, dp, do, dtag, overflow,
        fresh_delta_only=True,
    )


# ---------------------------------------------------------------------------
# Non-idempotent round: AddMult (noisy-OR ⊕, product ⊗)
# ---------------------------------------------------------------------------


def _prov_round_addmult(rules: tuple, caps: _Caps, fs, fp, fo, ftag, n_facts, didx, n_delta,
                        masks, gtags):
    """One EXACTLY-ONCE tagged semi-naive round for the addmult semiring.

    Non-idempotent ⊕ (a+b-ab) must see every derivation exactly once, so
    the round differs from the idempotent one in three ways:

    - **Decomposition** (host parity: ``eval_rule_body``'s old/delta split,
      ``provenance_semi_naive.rs:26-34``): for the plan seeded at premise
      position k, premise j < k scans OLD facts (facts minus delta), j > k
      scans ALL facts, so a derivation touching several delta facts is
      counted at exactly one seed position.
    - **Delta as fact-row indices** (``didx``): the delta is always a set of
      committed fact rows, so membership ("old" mask) is one scatter, and
      delta columns/tags are gathers.
    - **⊕ within the round** is a segment noisy-OR in log space:
      group tag = 1 - ∏(1-pᵢ) = -expm1(Σ log1p(-pᵢ)) over the group's
      derivations.

    Merge with the stored tag matches ``TagStore.update_disjunction``:
    absent (NaN) → the group tag is inserted verbatim; saturated (≥ 1.0)
    short-circuits; otherwise new = old + g - old·g, and the fact re-enters
    the delta iff |new - old| ≥ 1e-12 (``AddMultProbability.tag_eq``).
    Returns ``(fs, fp, fo, ftag, n_facts, didx, n_delta, code)``, host ints
    for the last three; an overflowing round does not commit."""
    F, D, J = caps.fact, caps.delta, caps.join
    dev = fs.device
    fvalid = torch.arange(F, device=dev) < n_facts
    dvalid = torch.arange(D, device=dev) < n_delta
    fcols = (fs, fp, fo)
    didx_c = didx.clamp(0, F - 1)
    dcols = tuple(c[didx_c] for c in fcols)
    dtag_eff = ftag[didx_c]
    dtag_eff = torch.where(torch.isnan(dtag_eff), 1.0, dtag_eff)  # one() = 1.0
    in_delta = _scatter_drop(
        torch.zeros(F, dtype=torch.bool, device=dev), torch.where(dvalid, didx_c, F), True)
    old_valid = fvalid & ~in_delta

    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    parts: List[tuple] = []
    for r_idx, rule in enumerate(rules):
        for order, keys in rule.plans:
            seed = order[0]
            table, valid = _scan_premise(rule.premises[seed], dcols, dvalid)
            tag = dtag_eff * gtags[r_idx]
            for step, j in enumerate(order[1:]):
                pvalid = old_valid if j < seed else fvalid
                table, valid, li, ri, overflow = _join_step(
                    table, valid, rule.premises[j], keys[step], fcols, pvalid, J, overflow)
                # ⊗ = product; absent (NaN) entries read as one()
                ptag = ftag[ri]
                tag = tag[li] * torch.where(torch.isnan(ptag), 1.0, ptag)
            valid = _eval_filters(rule, table, valid, masks)
            _concl_parts(rule, table, tag, valid & (tag > 0.0), parts)
    out = _addmult_commit(parts, caps, fs, fp, fo, ftag, n_facts, overflow)
    nfs, nfp, nfo, nftag, n_next, ndidx, n_d, code = out
    if code:
        return fs, fp, fo, ftag, n_facts, didx, 0, code
    return out


def _group_lengths(isnew, live, D):
    """Lengths of the first ``D`` (s,p,o) groups of sorted candidate rows,
    zeros after them, and one last segment holding every remaining row, so
    the lengths always sum to the row count (the last kept group may run
    long when there are more than ``D`` groups: that round overflows and is
    dropped)."""
    dev = isnew.device
    N = isnew.shape[0]
    seg = torch.cumsum(isnew, 0) - 1
    hp = _scatter_drop(torch.zeros(D + 1, dtype=torch.int64, device=dev),
                       torch.where(isnew, seg, D + 1), torch.arange(N, device=dev))
    n_g = torch.clamp(isnew.sum(), max=D)
    g = torch.arange(D, device=dev)
    nxt = torch.where(g + 1 < n_g, hp[1:], live.sum())
    lengths = torch.where(g < n_g, nxt - hp[:D], 0)
    return torch.cat([lengths, (N - lengths.sum()).reshape(1)])


def _addmult_commit(
    parts, caps, fs, fp, fo, ftag, n_facts, overflow, fresh_delta_only=False, extra=()
):
    """Shared commit tail of the addmult round AND NAF pass: group the
    candidate (s,p,o,tag,valid) blocks, ⊕ per group as a segment noisy-OR
    in log space, merge with stored tags (``TagStore.update_disjunction``
    semantics incl. the 1e-12 change cutoff), append fresh facts, and emit
    the next delta as fact-row indices.  ``fresh_delta_only`` (the NAF
    pass): the delta carries ONLY newly-appended facts — host parity with
    ``_negative_pass``, whose ``naf_new`` returns newly ADDED keys.

    The group sum is ``torch.segment_reduce`` over the candidates sorted
    stably by (s, p, o) (each group contiguous, its rows in candidate
    order): a fixed-order segmented reduction, deterministic run to run,
    where the reference scatter-adds; a one-derivation group keeps its tag
    verbatim.  Reads the round's one host read (the
    overflow code, the counts and the ``extra`` 0-dim tensors); returns the
    new state (not yet checked against the code), then the extras' values."""
    F, D = caps.fact, caps.delta
    dev = fs.device
    fvalid = torch.arange(F, device=dev) < n_facts
    cs, cp, co, ctag, cv = _cat_parts(parts)

    ss = torch.where(cv, cs, SENT)
    sp = torch.where(cv, cp, SENT)
    so = torch.where(cv, co, SENT)
    stag = torch.where(cv, ctag.clamp(0.0, 1.0), 0.0)
    perm = _lex_perm([ss, sp, so])
    ss, sp, so, stag = ss[perm], sp[perm], so[perm], stag[perm]
    live = ss != SENT
    isnew = _isnew((ss, sp, so)) & live
    n_uniq = isnew.sum()
    overflow = overflow | (n_uniq > D).to(torch.int64) << 1
    seg = torch.cumsum(isnew, 0) - 1
    # log1p(-p): p=1 → -inf → group tag exactly 1.0; p∈[0,1) stays finite
    lengths = _group_lengths(isnew, live, D)
    logsum = torch.segment_reduce(torch.log1p(-stag), "sum", lengths=lengths, unsafe=True)[:D]
    dest = torch.where(isnew, seg, D)
    # a group of ONE derivation keeps its tag verbatim (⊕ over one
    # derivation is the identity, as the host inserts it); the log-space
    # round trip would move its last bits off the host's
    head_tag = _scatter_drop(torch.zeros(D, dtype=torch.float64, device=dev), dest, stag)
    gtag = torch.where(lengths[:D] == 1, head_tag, -torch.expm1(logsum))  # 1 - ∏(1-pᵢ)
    zeros_d = torch.zeros(D, dtype=torch.int64, device=dev)
    us, up, uo = (_scatter_drop(zeros_d, dest, c) for c in (ss, sp, so))
    uvalid = torch.arange(D, device=dev) < n_uniq

    found, fidx = _fact_lookup(us, up, uo, uvalid, fs, fp, fo, fvalid, F)
    old_tag = ftag[fidx.clamp(0, F - 1)]
    absent = found & torch.isnan(old_tag)
    saturated = found & (old_tag >= 1.0)  # NaN compares False
    new_tag = old_tag + gtag - old_tag * gtag
    improved = found & ~absent & ~saturated & ((new_tag - old_tag).abs() >= _ADDMULT_TAG_EQ)
    changed = absent | improved
    merged = torch.where(absent, gtag, new_tag)
    fresh = uvalid & ~found

    n_facts_next = n_facts + fresh.sum()
    overflow = overflow | (n_facts_next > F).to(torch.int64) << 2
    adest = torch.where(fresh, n_facts + torch.cumsum(fresh, 0) - 1, F)
    nfs, nfp, nfo = (_scatter_drop(c, adest, u) for c, u in ((fs, us), (fp, up), (fo, uo)))
    nftag = _scatter_drop(ftag, adest, gtag)
    nftag = _scatter_drop(nftag, torch.where(changed, fidx, F), merged)

    # next delta = indices of new (∪ changed, unless fresh_delta_only) rows
    dmask = fresh if fresh_delta_only else (fresh | changed)
    row_idx = torch.where(fresh, adest, fidx)
    n_dnext = dmask.sum()
    ddest = torch.where(dmask, torch.cumsum(dmask, 0) - 1, D)
    ndidx = _scatter_drop(zeros_d, ddest, row_idx)
    code, n_next, n_d, *more = torch.stack(
        [overflow, n_facts_next, n_dnext, *extra]).tolist()  # the one sync
    return (nfs, nfp, nfo, nftag, n_next, ndidx, n_d, code, *more)


# ---------------------------------------------------------------------------
# Non-idempotent stratified NAF pass: exactly-once via a device seen-set
# ---------------------------------------------------------------------------


def _prov_naf_pass_addmult(rule, caps: _Caps, scap: int, fs, fp, fo, ftag, n_facts, seen_cols,
                           n_seen, masks, gtag):
    """One NAF rule's stratified pass for the NON-idempotent addmult
    semiring, with the host's exactly-once derivation accounting
    (``naf_seen``, provenance_seminaive.py::_negative_pass) ON DEVICE.

    The host processes each derivation signature — (rule, variable
    bindings) — at most once across passes, because noisy-OR ⊕ would
    double-count re-derivations.  Here the signature set is a device-
    resident SEEN relation: ``seen_cols`` is one sorted u32 column per
    rule variable (lexicographic, capacity ``scap``).  The pass sorts
    [seen rows ∥ this pass's candidate rows] on the binding columns with a
    seen-first tie-break; a candidate fires iff it HEADS its equal-binding
    group, and the sorted union of distinct bindings is the next seen
    relation — dedup, membership, and maintenance in ONE multi-key sort.

    One rule per dispatch: the driver sequences rules in host order, so a
    rule's committed facts are visible to later rules' body joins and
    negated-premise checks like the host's within-pass sequential commits.
    Returns ``(fs, fp, fo, ftag, n_facts, didx, n_delta, seen_cols,
    n_seen, code)``, host ints for the counts and the code; overflow bit 8
    = seen-set capacity."""
    F, J = caps.fact, caps.join
    dev = fs.device
    fvalid = torch.arange(F, device=dev) < n_facts
    fcols = (fs, fp, fo)
    eff = torch.where(torch.isnan(ftag), 1.0, ftag)

    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    # body vs ALL facts (host: eval_rule_body with delta=None)
    order, keys = rule.plans[0]
    table, valid = _scan_premise(rule.premises[order[0]], fcols, fvalid)
    tag = eff * gtag
    for step, j in enumerate(order[1:]):
        table, valid, li, ri, overflow = _join_step(
            table, valid, rule.premises[j], keys[step], fcols, fvalid, J, overflow)
        tag = tag[li] * eff[ri]
    valid = _eval_filters(rule, table, valid, masks)

    # ---- seen-set: dedup + membership + maintenance in one sort ----------
    var_names = tuple(sorted(table))  # host sig order: sorted(row.items())
    n_cand = valid.shape[0]
    seen_valid = torch.arange(scap, device=dev) < n_seen
    ops = [
        torch.cat([torch.where(seen_valid, seen_cols[k], SENT), torch.where(valid, table[v], SENT)])
        for k, v in enumerate(var_names)
    ]
    # flag sorts seen (0) before equal-binding candidates (1)
    flag = torch.cat([torch.zeros(scap, dtype=torch.int64, device=dev),
                      torch.ones(n_cand, dtype=torch.int64, device=dev)])
    payload_tag = torch.cat([torch.zeros(scap, dtype=torch.float64, device=dev), tag])
    perm = _lex_perm([*ops, flag])
    scols = [c[perm] for c in ops]
    sflag, stag = flag[perm], payload_tag[perm]
    live = scols[0] != SENT  # all-sentinel rows (invalid) sort last
    head = _isnew(scols)
    # a candidate FIRES iff it heads its equal-binding group: no seen row
    # (flag 0 sorts first) and no duplicate candidate precedes it
    fire = live & head & (sflag == 1)
    # next seen relation = the distinct bindings of the union
    keep = live & head
    n_seen_next = keep.sum()
    overflow = overflow | (n_seen_next > scap).to(torch.int64) << 3
    kdest = torch.where(keep, torch.cumsum(keep, 0) - 1, scap)
    sent_s = torch.full((scap,), SENT, dtype=torch.int64, device=dev)
    seen_next = tuple(_scatter_drop(sent_s, kdest, c) for c in scols)

    # ---- negated premises over the firing rows ---------------------------
    bind = {v: scols[k] for k, v in enumerate(var_names)}
    n_all = scap + n_cand
    tag2 = stag
    for neg in rule.negs:
        q = _ground_neg(neg, bind, n_all, dev)
        found, fidx = _fact_lookup(q[0], q[1], q[2], fire, fs, fp, fo, fvalid, F)
        ntag = 1.0 - eff[fidx.clamp(0, F - 1)]  # addmult ⊖ = 1 − t
        tag2 = tag2 * torch.where(found, ntag, 1.0)
    fire = fire & (tag2 > 0.0)  # zero-tag pruning

    parts: List[tuple] = []
    _concl_parts(rule, bind, tag2, fire, parts)
    nfs, nfp, nfo, nftag, n_next, ndidx, n_d, code, n_seen_h = _addmult_commit(
        parts, caps, fs, fp, fo, ftag, n_facts, overflow, fresh_delta_only=True,
        extra=(n_seen_next,))
    if code:
        return fs, fp, fo, ftag, n_facts, ndidx, 0, seen_cols, n_seen, code
    return nfs, nfp, nfo, nftag, n_next, ndidx, n_d, seen_next, n_seen_h, 0


# ---------------------------------------------------------------------------
# Host driver + integration
# ---------------------------------------------------------------------------


def infer_provenance_device(
    reasoner,
    provenance,
    tag_store,
    initial_delta: Optional[Set[Tuple[int, int, int]]] = None,
    max_attempts: int = 32,
) -> Optional[Dict[Tuple[int, int, int], float]]:
    """Run the tagged fixpoint on ``reasoner.device``; returns None where
    the reference declines the program (the host loop then runs).

    On success the derived facts are appended to ``reasoner.facts`` and
    ``tag_store`` holds the final tags (exactly like the host path).  A
    capacity that does not converge, the round limit, or a kernel failure
    raises."""
    LAST_RUN.update(dispatches=[], rounds=0, attempts=0, caps=None)
    if not supports(provenance):
        return None
    if provenance.name == "addmult" and _addmult_order_sensitive(
        [r for r in reasoner.rules if not r.negative_premise]
    ):
        # order-dependent accumulation WITHIN the positive round: host
        # semantics win.  NAF rules are excluded — the stratified driver
        # dispatches them one at a time in host order.
        return None
    try:
        rules, bank = lower_rules(reasoner, reasoner.rules)
    except Unsupported:
        return None
    if not rules:
        return None
    # ground-guard satisfaction at DRIVER time: facts never retract and
    # guards are non-derivable, so an absent guard makes its rule dead for
    # this whole closure
    rules = tuple(r for r in rules if all(reasoner.facts.contains(*g.consts) for g in r.guards))
    if not rules:
        return {}  # every rule statically dead: nothing to derive
    pos_rules = tuple(r for r in rules if not r.negs)
    naf_rules = tuple(r for r in rules if r.negs)
    if naf_rules and _naf_self_blocking(naf_rules):
        # a rule whose conclusion unifies its OWN negated premise: the
        # host's per-ROW sequential commits within that rule's evaluation
        # are load-bearing
        return None
    if naf_rules and _naf_premise_drift(rules, naf_rules):
        # a NAF body reading DERIVED predicates can see its premise tags
        # improve between passes; host freezes each derivation's first
        # read (naf_seen) — keep those programs host-side
        return None
    # CROSS-rule blocking dispatches NAF rules one at a time in host order
    # (addmult is ALWAYS sequential: its per-rule seen-sets need it anyway)
    naf_sequential = bool(naf_rules) and (
        provenance.name == "addmult" or _naf_cross_blocking(naf_rules)
    )

    dev = reasoner.device
    s, p, o = reasoner.facts.columns()
    n0 = len(s)
    if n0 == 0:
        return None
    cols = [torch.from_numpy(c.astype(np.int64)).to(dev) for c in (s, p, o)]
    tags0, one_enc = _seed_tag_arrays(provenance, tag_store, cols)
    masks = tuple(torch.from_numpy(m).to(dev) for m in bank.materialize()) or (
        torch.zeros(1, dtype=torch.bool, device=dev),
    )
    # delta tags are EFFECTIVE values (absent resolves to one())
    eff0 = np.where(np.isnan(tags0), one_enc, tags0)
    if initial_delta is not None:
        rows = _fact_rows(cols, sorted(initial_delta))
        didx = np.unique(rows[rows < n0])
        if didx.size == 0:
            return {}
    else:
        didx = np.arange(n0, dtype=np.int64)
    ftag0 = torch.from_numpy(tags0).to(dev)

    if provenance.name == "addmult":
        return _drive_addmult(
            reasoner, provenance, tag_store, pos_rules, naf_rules, masks, cols, ftag0,
            tags0, torch.from_numpy(didx).to(dev), n0, max_attempts,
        )

    didx_t = torch.from_numpy(didx).to(dev)
    nd0 = len(didx)
    st = {
        "fs": cols[0], "fp": cols[1], "fo": cols[2], "ftag": ftag0, "n_facts": n0,
        "ds": cols[0][didx_t], "dp": cols[1][didx_t], "do": cols[2][didx_t],
        "dt": torch.from_numpy(eff0).to(dev)[didx_t], "n_delta": nd0,
    }
    gtags_pos = torch.from_numpy(_guard_tag_array(pos_rules, provenance, tag_store)).to(dev)

    def round_fn(caps, st):
        out = _prov_round(
            pos_rules, caps, st["fs"], st["fp"], st["fo"], st["ftag"], st["n_facts"],
            st["ds"], st["dp"], st["do"], st["dt"], st["n_delta"], one_enc, masks, gtags_pos,
        )
        code = out[10]  # the round's one host read
        _record("round", (caps.fact, caps.delta, caps.join), code)
        if code != 0:
            return None, code
        return dict(zip(("fs", "fp", "fo", "ftag", "n_facts", "ds", "dp", "do", "dt",
                         "n_delta"), out[:10])), 0

    def pad_delta(st, D):
        for k in ("ds", "dp", "do", "dt"):
            st[k] = _pad(st[k], D)
        return st

    if pos_rules:
        st = _run_overflow_protocol(round_fn, st, n0, nd0, pad_delta, max_attempts)
    else:
        # no positive stratum: pad buffers (the protocol's job) and treat
        # the initial delta as drained — NAF evaluates vs ALL facts
        F = _round_cap(4 * n0, 2048)
        D = _round_cap(max(2 * nd0, n0 // 2, 1024))
        for k in ("fs", "fp", "fo", "ftag"):
            st[k] = _pad(st[k], F)
        st = pad_delta(st, D)
        st["n_delta"] = 0
    if naf_rules:
        st = _drive_naf(
            naf_rules, st, round_fn if pos_rules else None, pad_delta, provenance, one_enc,
            masks, torch.from_numpy(_guard_tag_array(naf_rules, provenance, tag_store)).to(dev),
            n0, nd0, max_attempts, sequential=naf_sequential,
        )
    _write_back(reasoner, provenance, tag_store, st["fs"], st["fp"], st["fo"], st["ftag"],
                st["n_facts"], n0, tags0)
    return {}


def _pad(x: torch.Tensor, cap: int) -> torch.Tensor:
    """``x`` followed by zeros up to ``cap`` rows (never shortened)."""
    pad = cap - x.shape[0]
    if pad <= 0:
        return x
    return torch.cat([x, x.new_zeros(pad)])


def _grow_caps(code, st, F, D, J, pad_delta):
    """The doubling step of the overflow protocol: double each capacity
    whose bit is set (bit0 join, bit1 delta, bit2 fact), re-padding the
    state's buffers."""
    if code & 1:
        J *= 2
    if code & 2:
        D *= 2
        st = pad_delta(st, D)
    if code & 4:
        F *= 2
        for k in ("fs", "fp", "fo", "ftag"):
            st[k] = _pad(st[k], F)
    return st, F, D, J


def _run_overflow_protocol(round_fn, st, n0, nd0, pad_delta, max_attempts):
    """THE shared static-capacity fixpoint protocol (both round kinds):
    run rounds until the delta drains; an overflowing round does NOT commit
    — the failing capacity doubles (bit0 join, bit1 delta, bit2 fact) and
    the round retries from the preserved state.

    ``round_fn(caps, st) -> (next_st | None, code)``; ``st`` holds fact
    buffers under keys fs/fp/fo/ftag (+ counts n_facts/n_delta), with the
    delta representation private to the caller (re-padded by ``pad_delta``).
    Returns the final state; raises after ``max_attempts`` overflows or the
    round limit (the reference falls back to the host there)."""
    # never shrink below already-padded buffers: the stratified-NAF driver
    # re-enters this protocol after a pass that may have doubled capacities
    F = max(_round_cap(4 * n0, 2048), st["fs"].shape[0])
    D = _round_cap(max(2 * nd0, n0 // 2, 1024))
    _dbuf = st.get("ds", st.get("didx"))
    if _dbuf is not None:
        D = max(D, _dbuf.shape[0])
    # start TIGHT: the candidate sort scales with J × plans, and the
    # overflow protocol doubles J cheaply when a round actually needs it
    J = _round_cap(max(nd0, 1024), 1024)
    for k in ("fs", "fp", "fo", "ftag"):
        st[k] = _pad(st[k], F)
    st = pad_delta(st, D)

    attempts = 0
    for _round in range(ROUND_LIMIT):
        new_st, code = round_fn(_Caps(F, D, J), st)
        if code != 0:
            attempts += 1
            if attempts > max_attempts:
                raise RuntimeError(
                    f"device provenance: capacities failed to converge in {max_attempts} "
                    f"doublings (last overflow code {code})")
            st, F, D, J = _grow_caps(code, st, F, D, J, pad_delta)
            continue  # retry the round (it did not commit)
        st = new_st
        if st["n_delta"] == 0:
            return st
    raise RuntimeError("device provenance hit the round limit before convergence")


def _drive_naf(naf_rules, st, round_fn, pad_delta, provenance, one_enc, masks, gtags, n0, nd0,
               max_attempts, sequential: bool = False):
    """Stratified-NAF driver (host loop parity, provenance_seminaive.py):
    alternate one device NAF pass with a positive fixpoint re-run seeded by
    the pass's delta, until a pass derives nothing new.  Shares the
    doubling overflow protocol; ``round_fn is None`` means the program has
    no positive stratum.

    ``sequential`` (cross-blocking rule sets): dispatch ONE rule at a
    time in host rule order — a rule's committed facts are then visible
    to later rules' negated-premise checks and body joins within the same
    pass, exactly like the host's sequential commits; the pass delta is
    the facts appended during the pass."""
    neg_kind = "expiration" if provenance.name == "expiration" else "complement"
    F = st["fs"].shape[0]
    D = st["ds"].shape[0]
    # NAF bodies join over ALL facts, not a delta — start J at fact scale
    J = _round_cap(max(st["n_facts"], 1024), 1024)
    attempts = 0
    rule_groups = (
        [((r,), gtags[i: i + 1]) for i, r in enumerate(naf_rules)]
        if sequential
        else [(naf_rules, gtags)]
    )
    for _pass in range(ROUND_LIMIT):
        pass_start = st["n_facts"]
        committed = [False] * len(rule_groups)
        while True:  # per-pass retry loop: only NOT-yet-committed groups
            failed = False
            for gi, (grules, ggtags) in enumerate(rule_groups):
                if committed[gi]:
                    # a group that committed before an overflow keeps its
                    # commit — its appended facts are recovered from the
                    # fact buffers at pass end
                    continue
                out = _prov_naf_pass(
                    grules, _Caps(F, D, J), st["fs"], st["fp"], st["fo"], st["ftag"],
                    st["n_facts"], st["ds"], st["dp"], st["do"], st["dt"], one_enc, masks,
                    neg_kind, ggtags,
                )
                code = out[10]  # one host read per dispatch
                _record("naf", (F, D, J), code)
                if code != 0:
                    attempts += 1
                    if attempts > max_attempts:
                        raise RuntimeError("device provenance NAF pass: capacities failed "
                                           f"to converge (last overflow code {code})")
                    st, F, D, J = _grow_caps(code, st, F, D, J, pad_delta)
                    failed = True
                    break  # retry the remaining groups at bigger caps
                st = dict(zip(("fs", "fp", "fo", "ftag", "n_facts", "ds", "dp", "do", "dt",
                               "n_delta"), out[:10]))
                if sequential:
                    committed[gi] = True
            if not failed:
                break
        if sequential:
            # the pass delta = EXACTLY the facts appended during the pass
            # (host naf_new) WITH their current tags — a later rule may
            # have ⊕-improved an earlier rule's fresh fact
            nd = st["n_facts"] - pass_start
            if nd > D:
                D = _round_cap(nd)
            if nd:
                sl = slice(pass_start, st["n_facts"])
                dt = st["ftag"][sl]
                st["ds"] = _pad(st["fs"][sl], D)
                st["dp"] = _pad(st["fp"][sl], D)
                st["do"] = _pad(st["fo"][sl], D)
                st["dt"] = _pad(torch.where(torch.isnan(dt), one_enc, dt), D)
            st["n_delta"] = int(nd)
        if st["n_delta"] == 0:
            return st
        # NAF-derived facts feed back into the positive stratum
        if round_fn is not None:
            st = _run_overflow_protocol(round_fn, st, n0, nd0, pad_delta, max_attempts)
        else:
            st["n_delta"] = 0
        F = st["fs"].shape[0]
        D = st["ds"].shape[0]
    raise RuntimeError("device provenance hit the NAF pass limit")


def _drive_naf_addmult(naf_rules, st, round_fn, pad_delta, provenance, tag_store, masks, n0,
                       max_attempts):
    """Stratified-NAF driver for the NON-idempotent addmult semiring:
    one rule per dispatch in host order (sequential commits visible to
    later rules), each rule carrying its own device-resident seen-set
    (exactly-once across passes), the pass's union delta re-seeding the
    positive protocol until a pass derives nothing new."""
    dev = st["fs"].device
    F = st["fs"].shape[0]
    D = st["didx"].shape[0]
    # NAF bodies join over ALL facts, not a delta — start J at fact scale
    J = _round_cap(max(st["n_facts"], 1024), 1024)
    gtags = _guard_tag_array(naf_rules, provenance, tag_store)
    scaps = [_round_cap(max(2 * st["n_facts"], 1024)) for _ in naf_rules]
    seen: List[Optional[tuple]] = [None] * len(naf_rules)
    attempts = 0
    for _pass in range(ROUND_LIMIT):
        pass_start = st["n_facts"]
        committed = [False] * len(naf_rules)
        while True:  # per-pass retry loop: only NOT-yet-committed rules
            failed = False
            for gi, rule in enumerate(naf_rules):
                if committed[gi]:
                    continue
                nvars = len({v for prem in rule.premises for v, _pos in prem.vars})
                if seen[gi] is None:
                    cols = tuple(
                        torch.full((scaps[gi],), SENT, dtype=torch.int64, device=dev)
                        for _ in range(nvars)
                    )
                    ns = 0
                else:
                    cols, ns = seen[gi]
                if cols and cols[0].shape[0] != scaps[gi]:
                    cols = tuple(_pad(c, scaps[gi]) for c in cols)
                out = _prov_naf_pass_addmult(
                    rule, _Caps(F, D, J), scaps[gi], st["fs"], st["fp"], st["fo"], st["ftag"],
                    st["n_facts"], cols, ns, masks, float(gtags[gi]),
                )
                code = out[9]  # one host read per dispatch
                _record("naf_addmult", (F, D, J, scaps[gi]), code)
                if code != 0:
                    attempts += 1
                    if attempts > max_attempts:
                        raise RuntimeError("device provenance NAF pass: capacities failed "
                                           f"to converge (last overflow code {code})")
                    st, F, D, J = _grow_caps(code, st, F, D, J, pad_delta)
                    if code & 8:
                        scaps[gi] *= 2
                    failed = True
                    break  # retry the remaining rules at bigger caps
                st = dict(zip(("fs", "fp", "fo", "ftag", "n_facts", "didx", "n_delta"), out[:7]))
                seen[gi] = (out[7], out[8])
                committed[gi] = True
            if not failed:
                break
        # the pass delta = EXACTLY the facts appended during the pass
        # (host naf_new), as fact-row indices
        if st["n_facts"] == pass_start:
            return st
        nd = st["n_facts"] - pass_start
        if nd > D:
            D = _round_cap(nd)
        st["didx"] = _pad(torch.arange(pass_start, st["n_facts"], device=dev), D)
        st["n_delta"] = nd
        if round_fn is not None:
            st = _run_overflow_protocol(round_fn, st, n0, st["n_delta"], pad_delta, max_attempts)
            F = st["fs"].shape[0]
            D = st["didx"].shape[0]
        else:
            st["n_delta"] = 0
    raise RuntimeError("device provenance hit the NAF pass limit")


def _write_back(reasoner, provenance, tag_store, fs, fp, fo, ftag, n_facts, n0, tags0) -> None:
    """Write back: new facts into the store; every changed-or-new tag entry
    into the tag store (vectorized — no per-fact Python loop).  Host parity:
    each derived fact gets an explicit entry (update_disjunction inserts on
    first derivation); NaN still means "no entry"."""
    fs_h, fp_h, fo_h = (c[:n_facts].cpu().numpy().astype(np.uint32) for c in (fs, fp, fo))
    ft_h = ftag[:n_facts].cpu().numpy()
    if n_facts > n0:
        reasoner.facts.add_batch(fs_h[n0:], fp_h[n0:], fo_h[n0:])
    has_entry = ~np.isnan(ft_h)
    unchanged = np.zeros(n_facts, dtype=bool)
    unchanged[:n0] = ~np.isnan(tags0) & (ft_h[:n0] == tags0)
    sel = np.flatnonzero(has_entry & ~unchanged)
    if sel.size:
        decoded = _decode_tags(provenance, ft_h[sel])
        keys = zip(fs_h[sel].tolist(), fp_h[sel].tolist(), fo_h[sel].tolist())
        tag_store.tags.update(zip(keys, decoded))


def _drive_addmult(reasoner, provenance, tag_store, pos_rules, naf_rules, masks, cols, ftag0,
                   tags0, didx0: torch.Tensor, n0: int, max_attempts: int):
    """Host driver for the exactly-once addmult rounds: the shared overflow
    protocol with the delta carried as fact-row INDICES.  NAF rules run as
    the stratified loop — positive protocol to quiescence, then ONE rule
    per dispatch in host order (:func:`_prov_naf_pass_addmult`), the
    pass's union delta feeding the positive stratum again until a pass
    derives nothing."""
    dev = reasoner.device
    nd0 = int(didx0.shape[0])
    st = {"fs": cols[0], "fp": cols[1], "fo": cols[2], "ftag": ftag0, "n_facts": n0,
          "didx": didx0, "n_delta": nd0}
    gtags = torch.from_numpy(_guard_tag_array(pos_rules, provenance, tag_store)).to(dev)

    def round_fn(caps, st):
        out = _prov_round_addmult(
            pos_rules, caps, st["fs"], st["fp"], st["fo"], st["ftag"], st["n_facts"],
            st["didx"], st["n_delta"], masks, gtags,
        )
        code = out[7]  # the round's one host read
        _record("round_addmult", (caps.fact, caps.delta, caps.join), code)
        if code != 0:
            return None, code
        return dict(zip(("fs", "fp", "fo", "ftag", "n_facts", "didx", "n_delta"), out[:7])), 0

    def pad_delta(st, D):
        st["didx"] = _pad(st["didx"], D)
        return st

    if pos_rules:
        st = _run_overflow_protocol(round_fn, st, n0, nd0, pad_delta, max_attempts)
    else:
        F = max(_round_cap(4 * n0, 2048), st["fs"].shape[0])
        D = _round_cap(max(2 * nd0, n0 // 2, 1024))
        for k in ("fs", "fp", "fo", "ftag"):
            st[k] = _pad(st[k], F)
        st = pad_delta(st, D)
        st["n_delta"] = 0
    if naf_rules:
        st = _drive_naf_addmult(naf_rules, st, round_fn if pos_rules else None, pad_delta,
                                provenance, tag_store, masks, n0, max_attempts)
    _write_back(reasoner, provenance, tag_store, st["fs"], st["fp"], st["fo"], st["ftag"],
                st["n_facts"], n0, tags0)
    return {}
