"""Distributed provenance semi-naive fixpoint: tag columns over the mesh.

Port of ``kolibrie_tpu/parallel/dist_provenance.py``.  Extends the general
distributed fixpoint (:mod:`kolibrie_tpu_torch.parallel.dist_general`) with
f64 semiring tag columns for the idempotent scalar semirings (minmax /
boolean / expiration — the family the one-device path accelerates,
:mod:`kolibrie_tpu_torch.reasoner.device_provenance`): ⊗ = ``min`` carried
through the routed join chain, ⊕ = ``max`` via group-max dedup on the
conclusion's subject-owner shard, in-place tag improvement on the owner,
and improved facts re-entering the delta.  Tags ride the same
:func:`~kolibrie_tpu_torch.parallel.dist_join.exchange` as the binding
columns (as the last column, float64), and the fixpoint terminates on
``psum(new + improved) == 0``.

TagStore parity follows the one-device path exactly: NaN in a tag column
means "no explicit TagStore entry" — premise reads see ``one()``, but a
fact's first derivation OVERWRITES (``update_disjunction`` inserts), later
derivations ⊕-merge.

The subject-owned fact block is authoritative for tags; the object-hash
mirror's tag column is refreshed for new AND improved facts (routed to the
object owner and scattered by exact (s,p,o) row lookup) so object-keyed
premise reads stay consistent.

The non-idempotent AddMult semiring runs distributed too (``kind=
"addmult"``): exactly-once accounting with OLD (facts \\ delta) views of
both fact blocks for premise positions before the seed, and ⊕ as a
shard-local segment noisy-OR in log space (every derivation of a fact lands
on its subject owner, so the local reduction is globally exact).  Rule sets
whose accumulation depends on evaluation order are refused, as on one
device.  Stratified NAF runs after the positive stratum quiesces: a NAF
pass evaluates each NAF rule's body over the full fact block and resolves
negated premises with a two-hop exchange (ground keys to their subject
owner, negated tags back); its delta re-enters the positive stratum.
Cross-blocking NAF rule sets dispatch ONE rule per pass program in host
rule order, the pass delta recovered from the per-shard appended rows;
AddMult NAF is always sequential, each rule carrying a binding-owner-routed
seen relation.  Self-blocking NAF, NAF premise drift and the structural
semirings raise :class:`Unsupported`.

Port notes:

- The reference's ``shard_map`` programs are controller code looping over
  the shards (:mod:`~kolibrie_tpu_torch.parallel.mesh`), split at each
  :func:`exchange` and :func:`~kolibrie_tpu_torch.parallel.mesh.psum`.
  Nothing is compiled, so there is no program cache; the capacity attempts
  are the reference's (the four caps and the NAF seen-relation cap double
  together after a failed attempt).
- Kernels: premise scans go through ``device_fixpoint._scan_premise`` (the
  fused ``filter_mask`` kernel on the card) and premise joins through
  ``dist_join.local_join_u32`` (the merge-path kernel).  The f64 tag algebra
  is plain PyTorch, as it is plain XLA in the reference.
- The exact (s,p,o) → row lookup (the reference's ``_index3``) is
  ``device_provenance._fact_lookup``: it packs the rows and answers with
  one ``searchsorted``, where the reference narrows three binary searches.
- A round reads its count and overflow with one host sync, never one per
  shard.  AddMult's group ⊕ is ``torch.segment_reduce`` over stably sorted
  candidates (fixed order, no atomics, the same bits run to run), and a
  group of one derivation keeps its tag verbatim, as the host inserts it
  and as the one-device port does.

Parity: ``datalog/.../provenance_semi_naive.rs:26-34,134-197`` over
``semi_naive_parallel.rs``'s partitioning.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from kolibrie_tpu_torch.backend import SENT
from kolibrie_tpu_torch.ops import round_cap
from kolibrie_tpu_torch.parallel.dist_general import (
    _apply_filters,
    _instantiate,
    _pos2var,
    lower_rules_dist,
)
from kolibrie_tpu_torch.parallel.dist_join import exchange, local_join_u32, mix32, shard_of_dev
from kolibrie_tpu_torch.parallel.mesh import Mesh, psum, replicate, shard_put
from kolibrie_tpu_torch.parallel.sharded_store import partition_rows
from kolibrie_tpu_torch.reasoner.device_fixpoint import Unsupported, _scan_premise
from kolibrie_tpu_torch.reasoner.device_provenance import (
    _ADDMULT_TAG_EQ,
    _addmult_order_sensitive,
    _cat_parts,
    _concl_parts,
    _decode_tags,
    _fact_lookup,
    _group_lengths,
    _guard_tag_array,
    _isnew,
    _lex_perm,
    _naf_cross_blocking,
    _naf_premise_drift,
    _naf_self_blocking,
    _negate_enc,
    _pad,
    _scatter_drop,
    _seed_tag_arrays,
    supports_idempotent,
)

__all__ = ["DistProvenanceReasoner", "Unsupported"]


class _Shard(NamedTuple):
    """One shard's state: the subject-owned fact block (columns, tags,
    validity), the object-hashed mirror, and the delta (effective tags)."""

    fs: torch.Tensor
    fp: torch.Tensor
    fo: torch.Tensor
    ftag: torch.Tensor
    fv: torch.Tensor
    gs: torch.Tensor
    gp: torch.Tensor
    go: torch.Tensor
    gtag: torch.Tensor
    gv: torch.Tensor
    ds: torch.Tensor
    dp: torch.Tensor
    do: torch.Tensor
    dtag: torch.Tensor
    dv: torch.Tensor


class _Caps(NamedTuple):
    fact: int
    delta: int
    join: int
    bucket: int


def _rows_hit(idx, found, cap):
    """Mask of the ``cap`` rows that ``idx`` hits where ``found``."""
    z = torch.zeros(cap, dtype=torch.bool, device=found.device)
    return _scatter_drop(z, torch.where(found, idx, cap), True)


def _exchange_tagged(tables, tags, valids, key_var, n, bucket_cap):
    """Route every shard's binding table and its tag column (the last
    column) to ``hash(table[key_var])`` owners."""
    names = sorted(tables[0])
    routed, rvalid, dropped = exchange(
        [tuple(t[v] for v in names) + (tag,) for t, tag in zip(tables, tags)],
        valids,
        [shard_of_dev(t[key_var], n) for t in tables],
        n,
        bucket_cap,
    )
    return [dict(zip(names, r[:-1])) for r in routed], [r[-1] for r in routed], rvalid, dropped


def _join_side(table, tag, valid, prem, kv, extra, side_cols, side_key, side_valid, side_tag,
               combine, join_cap):
    """One routed join step on one shard: scan ``prem`` over the side
    block, join on ``kv`` through the merge path, carry the side's new
    variables, mask extra shared variables, fold the side's (effective)
    tag with ``combine``.  Returns the new table, tag, validity and the
    join's overrun."""
    ptable, pmask = _scan_premise(prem, side_cols, side_valid)
    li, ri, jvalid, total = local_join_u32(table[kv], side_key, join_cap, valid, pmask)
    new_table = {v: c[li] for v, c in table.items()}
    for v, c in ptable.items():
        if v not in new_table:
            new_table[v] = c[ri]
        elif v in extra:
            jvalid = jvalid & (new_table[v] == c[ri])
    return new_table, combine(tag[li], side_tag[ri]), jvalid, (total - join_cap).clamp(min=0)


def _effective(tags, one_enc):
    """Absent (NaN) entries read as ``one()``."""
    return [torch.where(torch.isnan(t), one_enc, t) for t in tags]


def _tagged_round(state, masks, one_enc, gtags, *, rules, n, caps, kind="idem"):
    """One tagged semi-naive round over every shard (the reference's mesh
    program).  ``masks[i]`` / ``gtags[i]`` are shard *i*'s copies of the
    replicated filter masks and per-rule guard tags.  Returns the next
    state, the global delta count and the global overflow (0-dim tensors
    on the first shard's device, not yet read)."""
    F, J, B = caps.fact, caps.join, caps.bucket
    addmult = kind == "addmult"
    ovf: List[torch.Tensor] = []
    if addmult:
        # exactly-once decomposition needs OLD (= facts \ delta) views of
        # both blocks: the delta is subject-partitioned like the subject
        # block (a local lookup); the mirror needs the delta at object owners
        old_fv, old_gv = [], []
        for st in state:
            found, idx = _fact_lookup(st.ds, st.dp, st.do, st.dv, st.fs, st.fp, st.fo, st.fv, F)
            old_fv.append(st.fv & ~_rows_hit(idx, found, F))
        routed, rvalid, dropped = exchange(
            [(st.ds, st.dp, st.do) for st in state],
            [st.dv for st in state],
            [shard_of_dev(st.do, n) for st in state],
            n,
            B,
        )
        ovf.append(dropped)
        for st, r, rv in zip(state, routed, rvalid):
            found, idx = _fact_lookup(*r, rv, st.gs, st.gp, st.go, st.gv, F)
            old_gv.append(st.gv & ~_rows_hit(idx, found, F))
    else:
        # idempotent ⊕: duplicate derivations are harmless
        old_fv, old_gv = [st.fv for st in state], [st.gv for st in state]
    eff_f = _effective([st.ftag for st in state], one_enc)
    eff_g = _effective([st.gtag for st in state], one_enc)
    combine = torch.mul if addmult else torch.minimum

    parts = [[] for _ in range(n)]
    for r_idx, (lr, plans) in enumerate(rules):
        for seed, steps in plans:
            tables, tags, valids = [], [], []
            for st, g in zip(state, gtags):
                table, valid = _scan_premise(lr.premises[seed], (st.ds, st.dp, st.do), st.dv)
                # delta tags are EFFECTIVE values (never NaN); statically
                # satisfied ground guards fold their closure-constant tags in
                tables.append(table)
                tags.append(combine(st.dtag, g[r_idx]))
                valids.append(valid)
            for j, kv, kpos, extra in steps:
                tables, tags, valids, dropped = _exchange_tagged(tables, tags, valids, kv, n, B)
                ovf.append(dropped)
                for i, st in enumerate(state):
                    if kpos == 0:
                        side = ((st.fs, st.fp, st.fo), st.fs,
                                old_fv[i] if j < seed else st.fv, eff_f[i])
                    else:
                        side = ((st.gs, st.gp, st.go), st.go,
                                old_gv[i] if j < seed else st.gv, eff_g[i])
                    tables[i], tags[i], valids[i], over = _join_side(
                        tables[i], tags[i], valids[i], lr.premises[j], kv, extra, *side,
                        combine, J)
                    ovf.append(over)
            for i in range(n):
                valid = _apply_filters(lr.filters, tables[i], valids[i], masks[i])
                # zero-tag pruning
                _concl_parts(lr, tables[i], tags[i], valid & (tags[i] > 0.0), parts[i])
    return _commit_candidates(parts, ovf, state, kind=kind, n=n, caps=caps)


def _group_max(rs, rp, ro, rt, rv, D):
    """Idempotent ⊕ = max: group the candidates per (s,p,o), each group's
    first row carrying its max tag (a stable sort on ``-tag`` under the
    lexicographic one; ``-tag + 0.0`` ties ``-0.0`` with ``0.0``)."""
    ss, sp, so = (torch.where(rv, c, SENT) for c in (rs, rp, ro))
    st = torch.where(rv, rt, 0.0)
    perm = torch.sort(-st + 0.0, stable=True).indices
    perm = perm[_lex_perm([ss[perm], sp[perm], so[perm]])]
    ss, sp, so, st = ss[perm], sp[perm], so[perm], st[perm]
    isnew = _isnew((ss, sp, so)) & (ss != SENT)
    dest = torch.where(isnew, torch.cumsum(isnew, 0) - 1, D)
    ut = _scatter_drop(torch.zeros(D, dtype=torch.float64, device=rt.device), dest, st)
    return ss, sp, so, isnew, dest, ut


def _group_noisy_or(rs, rp, ro, rt, rv, D):
    """AddMult ⊕ = noisy-OR over the group, as a fixed-order segment sum
    in log space: 1 - ∏(1-pᵢ) = -expm1(Σ log1p(-pᵢ)); a group of one keeps
    its tag verbatim."""
    dev = rt.device
    ss, sp, so = (torch.where(rv, c, SENT) for c in (rs, rp, ro))
    st = torch.where(rv, rt.clamp(0.0, 1.0), 0.0)
    perm = _lex_perm([ss, sp, so])
    ss, sp, so, st = ss[perm], sp[perm], so[perm], st[perm]
    live = ss != SENT
    isnew = _isnew((ss, sp, so)) & live
    lengths = _group_lengths(isnew, live, D)
    logsum = torch.segment_reduce(torch.log1p(-st), "sum", lengths=lengths, unsafe=True)[:D]
    dest = torch.where(isnew, torch.cumsum(isnew, 0) - 1, D)
    head = _scatter_drop(torch.zeros(D, dtype=torch.float64, device=dev), dest, st)
    ut = torch.where(lengths[:D] == 1, head, -torch.expm1(logsum))
    return ss, sp, so, isnew, dest, ut


def _commit_candidates(parts, ovf, state, *, kind, n, caps, fresh_delta_only=False):
    """Shared commit tail of the round and the NAF passes: route candidate
    conclusions to their subject owner, segment-⊕ per (s,p,o) group, merge
    into the subject-owned block, refresh the object-hash mirror, and emit
    the next delta (new ∪ changed — or new ONLY under
    ``fresh_delta_only``, the NAF-pass / host ``naf_new`` contract).
    ``ovf`` holds the overflow terms so far (local and global)."""
    F, D, B = caps.fact, caps.delta, caps.bucket
    addmult = kind == "addmult"
    cands = [_cat_parts(p) for p in parts]
    routed, rvalid, dropped = exchange(
        [c[:4] for c in cands], [c[4] for c in cands],
        [shard_of_dev(c[0], n) for c in cands], n, B,
    )
    ovf.append(dropped)
    group = _group_noisy_or if addmult else _group_max
    owned, mirror_cols, mirror_valid, mirror_dest = [], [], [], []
    for st, (rs, rp, ro, rt), rv in zip(state, routed, rvalid):
        dev = rt.device
        ss, sp, so, isnew, dest, ut = group(rs, rp, ro, rt, rv, D)
        n_uniq = isnew.sum()
        ovf.append((n_uniq - D).clamp(min=0))
        zeros_d = torch.zeros(D, dtype=torch.int64, device=dev)
        us, up, uo = (_scatter_drop(zeros_d, dest, c) for c in (ss, sp, so))
        uv = torch.arange(D, device=dev) < n_uniq

        # owner-local exact lookup into the subject-owned block
        found, fidx = _fact_lookup(us, up, uo, uv, st.fs, st.fp, st.fo, st.fv, F)
        old_tag = st.ftag[fidx.clamp(0, F - 1)]
        absent = found & torch.isnan(old_tag)
        if addmult:
            # update_disjunction parity: saturated (≥1) short-circuits; else
            # new = old ⊕ g with the 1e-12 tag_eq change cutoff
            saturated = found & (old_tag >= 1.0)  # NaN compares False
            merged = old_tag + ut - old_tag * ut
            improved = (found & ~absent & ~saturated
                        & ((merged - old_tag).abs() >= _ADDMULT_TAG_EQ))
            ut = torch.where(improved, merged, ut)
        else:
            improved = found & (ut > old_tag)  # NaN compares False
        changed = absent | improved
        fresh = uv & ~found

        # append new facts (with tags), then store changed tags in place
        n_local = st.fv.sum()
        ovf.append((n_local + fresh.sum() - F).clamp(min=0))
        adest = torch.where(fresh, n_local + torch.cumsum(fresh, 0) - 1, F)
        fs, fp, fo = (_scatter_drop(c, adest, u)
                      for c, u in ((st.fs, us), (st.fp, up), (st.fo, uo)))
        ftag = _scatter_drop(st.ftag, adest, ut)
        fv = _scatter_drop(st.fv, adest, True)
        ftag = _scatter_drop(ftag, torch.where(changed, fidx, F), ut)

        # next delta = new ∪ changed, subject-owned rows with final tags;
        # the mirror flag marks which of them are fresh
        dmask = fresh | changed
        n_d = dmask.sum()
        ddest = torch.where(dmask, torch.cumsum(dmask, 0) - 1, D)
        nds, ndp, ndo = (_scatter_drop(zeros_d, ddest, u) for u in (us, up, uo))
        ndt = _scatter_drop(torch.zeros(D, dtype=torch.float64, device=dev), ddest, ut)
        ndv = torch.arange(D, device=dev) < n_d
        mflag = _scatter_drop(zeros_d, ddest, fresh.to(torch.int64))
        owned.append((fs, fp, fo, ftag, fv, us, up, uo, ut, fresh, n_d))
        mirror_cols.append((nds, ndp, ndo, ndt, mflag))
        mirror_valid.append(ndv)
        mirror_dest.append(shard_of_dev(ndo, n))

    # refresh the object-hash mirror for new AND changed rows: route to the
    # object owner, append the fresh ones, scatter tags for the rest
    routed, mvalid, dropped = exchange(mirror_cols, mirror_valid, mirror_dest, n, B)
    ovf.append(dropped)
    out, counts = [], []
    for st, own, mcols, mcols_v, mv in zip(state, owned, routed, mirror_cols, mvalid):
        fs, fp, fo, ftag, fv, us, up, uo, ut, fresh, n_d = own
        ms, mp, mo, mt, mf = mcols
        mfresh = mv & (mf > 0)
        mold = mv & (mf == 0)
        n_g = st.gv.sum()
        ovf.append((n_g + mfresh.sum() - F).clamp(min=0))
        gdest = torch.where(mfresh, n_g + torch.cumsum(mfresh, 0) - 1, F)
        gs, gp, go = (_scatter_drop(c, gdest, m)
                      for c, m in ((st.gs, ms), (st.gp, mp), (st.go, mo)))
        gtag = _scatter_drop(st.gtag, gdest, mt)
        gv = _scatter_drop(st.gv, gdest, True)
        gfound, gidx = _fact_lookup(ms, mp, mo, mold, gs, gp, go, gv, F)
        gtag = _scatter_drop(gtag, torch.where(gfound, gidx, F), mt)

        nds, ndp, ndo, ndt, _flag = mcols_v
        if fresh_delta_only:
            # returned delta = NEW facts only (host naf_new parity); the
            # mirror refresh above still covered tag-improved rows
            dev = fresh.device
            n_d = fresh.sum()
            fdest = torch.where(fresh, torch.cumsum(fresh, 0) - 1, D)
            zeros_d = torch.zeros(D, dtype=torch.int64, device=dev)
            nds, ndp, ndo = (_scatter_drop(zeros_d, fdest, u) for u in (us, up, uo))
            ndt = _scatter_drop(torch.zeros(D, dtype=torch.float64, device=dev), fdest, ut)
        ndv = torch.arange(D, device=nds.device) < n_d
        out.append(_Shard(fs, fp, fo, ftag, fv, gs, gp, go, gtag, gv, nds, ndp, ndo, ndt, ndv))
        counts.append(n_d)
    return out, psum(counts), psum(ovf)


def _naf_body(lr, plans, state, eff_f, eff_g, start_tags, combine, masks, n, caps):
    """Shared NAF-rule body evaluation over ALL facts: seed scan, routed
    joins with the per-row tag folded by ``combine`` (⊗ = min for the
    idempotent family, product for addmult), extra-var equality, filters.
    Returns per-shard ``(tables, tags, valids)`` and the overflow terms —
    the negated premises and the commit differ per pass."""
    ovf: List[torch.Tensor] = []
    seed, steps = plans[0]
    tables, valids = [], []
    for st in state:
        table, valid = _scan_premise(lr.premises[seed], (st.fs, st.fp, st.fo), st.fv)
        tables.append(table)
        valids.append(valid)
    tags = list(start_tags)
    for j, kv, kpos, extra in steps:
        tables, tags, valids, dropped = _exchange_tagged(tables, tags, valids, kv, n, caps.bucket)
        ovf.append(dropped)
        for i, st in enumerate(state):
            if kpos == 0:
                side = ((st.fs, st.fp, st.fo), st.fs, st.fv, eff_f[i])
            else:
                side = ((st.gs, st.gp, st.go), st.go, st.gv, eff_g[i])
            tables[i], tags[i], valids[i], over = _join_side(
                tables[i], tags[i], valids[i], lr.premises[j], kv, extra, *side, combine,
                caps.join)
            ovf.append(over)
    valids = [_apply_filters(lr.filters, t, v, m) for t, v, m in zip(tables, valids, masks)]
    return tables, tags, valids, ovf


def _negated_tags(neg, tables, valids, state, eff_f, negate, one, n, caps, ovf):
    """Resolve one negated premise with the two-hop exchange: each row's
    ground (s,p,o) key rides to its subject owner for an exact lookup, and
    the negated tag (absent ⇒ ``one``, present ⇒ ``negate(tag)``) rides
    back to the origin shard's row.  Returns per-shard tag columns."""
    F, B = caps.fact, caps.bucket
    term_map = _pos2var(neg)
    cols, dest = [], []
    for i, (table, valid) in enumerate(zip(tables, valids)):
        L, dev = valid.shape[0], valid.device
        qs, qp, qo = _instantiate(term_map, neg.consts, table, L, dev)
        rowid = torch.arange(L, device=dev)
        cols.append((qs, qp, qo, rowid, torch.full((L,), i, dtype=torch.int64, device=dev)))
        dest.append(shard_of_dev(qs, n))
    routed, rqv, d1 = exchange(cols, valids, dest, n, B)
    ovf.append(d1)
    back, back_dest = [], []
    for st, eff, (rqs, rqp, rqo, rrow, rorig), v in zip(state, eff_f, routed, rqv):
        found, idx = _fact_lookup(rqs, rqp, rqo, v, st.fs, st.fp, st.fo, st.fv, F)
        t = eff[idx.clamp(0, F - 1)]
        back.append((rrow, torch.where(found, negate(t), one)))
        back_dest.append(rorig)
    returned, bv, d2 = exchange(back, rqv, back_dest, n, B)
    ovf.append(d2)
    out = []
    for valid, (brow, bnt), v in zip(valids, returned, bv):
        L = valid.shape[0]
        buf = torch.full((L,), one, dtype=torch.float64, device=valid.device)
        out.append(_scatter_drop(buf, torch.where(v, brow, L), bnt))
    return out


def _naf_pass(state, masks, one_enc, gtags, *, rules, neg_kind, n, caps):
    """One stratified NAF pass over the quiesced positive fixpoint (the
    one-device ``_prov_naf_pass`` twin).  Each NAF rule's positive body is
    evaluated against the FULL subject-owned block (idempotent ⊕ —
    re-derivation is harmless); every negated premise is resolved by
    :func:`_negated_tags`.  Commit tail shared with the round."""
    eff_f = _effective([st.ftag for st in state], one_enc)
    eff_g = _effective([st.gtag for st in state], one_enc)
    ovf: List[torch.Tensor] = []
    parts = [[] for _ in range(n)]
    for r_idx, (lr, plans) in enumerate(rules):
        start = [torch.minimum(e, g[r_idx]) for e, g in zip(eff_f, gtags)]
        tables, tags, valids, body_ovf = _naf_body(
            lr, plans, state, eff_f, eff_g, start, torch.minimum, masks, n, caps)
        ovf.extend(body_ovf)
        for neg in lr.negs:
            ntags = _negated_tags(neg, tables, valids, state, eff_f,
                                  lambda t: _negate_enc(t, neg_kind), one_enc, n, caps, ovf)
            tags = [torch.minimum(t, nt) for t, nt in zip(tags, ntags)]
        for i in range(n):
            # zero-tag pruning
            _concl_parts(lr, tables[i], tags[i], valids[i] & (tags[i] > 0.0), parts[i])
    return _commit_candidates(parts, ovf, state, kind="idem", n=n, caps=caps,
                              fresh_delta_only=True)


def _naf_pass_addmult(state, seen, n_seen, masks, gtag, *, rule, n, caps, seen_cap):
    """ONE NAF rule's stratified pass for the addmult semiring (the
    one-device ``_prov_naf_pass_addmult`` twin); the controller dispatches the
    rules in host order.

    Exactly-once accounting on the mesh: candidate rows route by a hash of
    their FULL variable binding to a binding-owner shard, so the owner-local
    [seen ∥ candidates] sort (dedup, membership and the next seen relation
    in one sort) is globally exact.  ``seen[i]`` is shard *i*'s tuple of
    sorted columns, one per rule variable, ``n_seen[i]`` its count.
    Negated premises resolve from the binding owner (⊖ = 1 − t); the commit
    is addmult's with ``fresh_delta_only``.  Returns the state, count and
    overflow, then the next seen relations and their counts."""
    lr, plans = rule
    eff_f = _effective([st.ftag for st in state], 1.0)
    eff_g = _effective([st.gtag for st in state], 1.0)
    start = [e * g for e, g in zip(eff_f, gtag)]
    tables, tags, valids, ovf = _naf_body(
        lr, plans, state, eff_f, eff_g, start, torch.mul, masks, n, caps)

    # route candidates to their binding owner
    var_names = tuple(sorted(tables[0]))
    dest = []
    for t in tables:
        h = torch.zeros_like(t[var_names[0]])
        for v in var_names:
            h = mix32(h ^ t[v])
        dest.append(h % n)
    routed, rvalid, dropped = exchange(
        [tuple(t[v] for v in var_names) + (tag,) for t, tag in zip(tables, tags)],
        valids, dest, n, caps.bucket,
    )
    ovf.append(dropped)

    # owner-local seen/dedup: one multi-key sort, seen rows (flag 0) before
    # equal-binding candidates (flag 1)
    binds, fires, tags2, seen_next, n_seen_next = [], [], [], [], []
    for cols_in, rv, sc, ns in zip(routed, rvalid, seen, n_seen):
        dev = rv.device
        n_cand = rv.shape[0]
        seen_valid = torch.arange(seen_cap, device=dev) < ns
        ops = [torch.cat([torch.where(seen_valid, sc[k], SENT), torch.where(rv, cols_in[k], SENT)])
               for k in range(len(var_names))]
        flag = torch.cat([torch.zeros(seen_cap, dtype=torch.int64, device=dev),
                          torch.ones(n_cand, dtype=torch.int64, device=dev)])
        payload = torch.cat([torch.zeros(seen_cap, dtype=torch.float64, device=dev),
                             cols_in[len(var_names)]])
        perm = _lex_perm([*ops, flag])
        scols = [c[perm] for c in ops]
        sflag, stag = flag[perm], payload[perm]
        live = scols[0] != SENT
        head = _isnew(scols)
        keep = live & head
        n_keep = keep.sum()
        ovf.append((n_keep - seen_cap).clamp(min=0))
        kdest = torch.where(keep, torch.cumsum(keep, 0) - 1, seen_cap)
        sent_s = torch.full((seen_cap,), SENT, dtype=torch.int64, device=dev)
        seen_next.append(tuple(_scatter_drop(sent_s, kdest, c) for c in scols))
        n_seen_next.append(n_keep)
        binds.append(dict(zip(var_names, scols)))
        fires.append(live & head & (sflag == 1))
        tags2.append(stag)

    # negated premises from the binding owner (two-hop)
    for neg in lr.negs:
        ntags = _negated_tags(neg, binds, fires, state, eff_f, lambda t: 1.0 - t, 1.0, n, caps,
                              ovf)
        tags2 = [t * nt for t, nt in zip(tags2, ntags)]
    parts = [[] for _ in range(n)]
    for i in range(n):
        # zero-tag pruning
        _concl_parts(lr, binds[i], tags2[i], fires[i] & (tags2[i] > 0.0), parts[i])
    out, count, overflow = _commit_candidates(parts, ovf, state, kind="addmult", n=n, caps=caps,
                                              fresh_delta_only=True)
    return out, count, overflow, seen_next, n_seen_next


def _read_ints(xs) -> list:
    """Host ints of 0-dim tensors (any shards' devices) in one sync."""
    first = xs[0].device
    return torch.stack([x.to(first) for x in xs]).tolist()


# ---------------------------------------------------------------------------
# Host controller
# ---------------------------------------------------------------------------


class DistProvenanceReasoner:
    """Host controller of the distributed tagged fixpoint (see module doc).

    ``infer()`` runs the closure over the mesh, writes derived facts into
    ``reasoner.facts`` and final tags into ``tag_store`` (host-TagStore
    parity), and returns the derived count.  Raises :class:`Unsupported`
    for rule sets or semirings the distributed path declines.  After a
    run, ``dispatches`` counts the round and NAF-pass dispatches,
    ``rounds`` the committed ones, ``attempts`` the capacity attempts."""

    def __init__(
        self,
        mesh: Mesh,
        reasoner,
        provenance,
        tag_store,
        fact_cap: Optional[int] = None,
        delta_cap: Optional[int] = None,
        join_cap: Optional[int] = None,
        bucket_cap: Optional[int] = None,
    ):
        if supports_idempotent(provenance):
            self.kind = "idem"
        elif getattr(provenance, "name", None) == "addmult":
            if _addmult_order_sensitive([r for r in reasoner.rules if not r.negative_premise]):
                # POSITIVE rules only: NAF rules never run inside the round
                # (they dispatch sequentially in host order), and
                # NAF→premise feedback is gated by _naf_premise_drift
                raise Unsupported(
                    "addmult accumulation is rule-evaluation-order-dependent for this rule set"
                    " (a rule's conclusions feed a later rule's premises): host semantics win"
                )
            self.kind = "addmult"
        else:
            raise Unsupported(f"semiring {provenance.name!r} has no distributed tag algebra")
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.n = mesh.size
        self.reasoner = reasoner
        self.provenance = provenance
        self.tag_store = tag_store
        self.rules, self.bank = lower_rules_dist(reasoner, reasoner.rules)
        # ground-guard satisfaction at construction (facts are real here;
        # guards are non-derivable, so absence is final for this closure)
        self.rules = tuple(
            (lr, pl) for lr, pl in self.rules
            if all(reasoner.facts.contains(*g.consts) for g in lr.guards)
        )
        self.pos_rules = tuple((lr, pl) for lr, pl in self.rules if not lr.negs)
        self.naf_rules = tuple((lr, pl) for lr, pl in self.rules if lr.negs)
        if self.naf_rules and _naf_self_blocking([lr for lr, _ in self.naf_rules]):
            raise Unsupported(
                "a NAF conclusion unifies with the SAME rule's negated premise: the host's"
                " per-row sequential commits are load-bearing"
            )
        # CROSS-rule blocking runs SEQUENTIALLY (one rule per pass dispatch,
        # host rule order); addmult NAF is ALWAYS sequential (its per-rule
        # seen relations need the partition anyway)
        self.naf_sequential = bool(self.naf_rules) and (
            self.kind == "addmult" or _naf_cross_blocking([lr for lr, _ in self.naf_rules])
        )
        if self.naf_rules and _naf_premise_drift(
            [lr for lr, _ in self.rules], [lr for lr, _ in self.naf_rules]
        ):
            raise Unsupported(
                "a NAF body reads derived predicates: the host's exactly-once naf_seen tag"
                " freezing is load-bearing"
            )
        self.neg_kind = (
            "expiration" if getattr(provenance, "name", None) == "expiration" else "complement"
        )
        n_local = max(1, -(-len(reasoner.facts) // self.n))
        self.fact_cap = fact_cap or round_cap(8 * n_local, 512)
        self.delta_cap = delta_cap or round_cap(4 * n_local, 256)
        self.join_cap = join_cap or round_cap(4 * n_local, 256)
        self.bucket_cap = bucket_cap or round_cap(4 * n_local, 256)
        # per-rule NAF seen-relation capacity (addmult exactly-once)
        self.seen_cap = round_cap(4 * n_local, 256)
        self.dispatches = self.rounds = self.attempts = 0

    @staticmethod
    def _rule_vars(lr) -> int:
        return len({v for prem in lr.premises for v, _pos in prem.vars})

    def _caps(self) -> _Caps:
        return _Caps(self.fact_cap, self.delta_cap, self.join_cap, self.bucket_cap)

    def infer(self, max_rounds: int = 256, max_attempts: int = 8) -> int:
        r = self.reasoner
        s, p, o = r.facts.columns()
        n0 = len(s)
        self.dispatches = self.rounds = self.attempts = 0
        if n0 == 0 or not self.rules:
            return 0
        dev0 = self.mesh.devices[0]
        cols = [torch.from_numpy(c.astype(np.int64)).to(dev0) for c in (s, p, o)]
        tags0, one_enc = _seed_tag_arrays(self.provenance, self.tag_store, cols)
        for attempt in range(max_attempts):
            self.attempts = attempt + 1
            result = self._try_infer(s, p, o, tags0, one_enc, max_rounds)
            if result is not None:
                return self._write_back(cols, torch.from_numpy(tags0).to(dev0), *result)
            self.fact_cap *= 2
            self.seen_cap *= 2
            self.delta_cap *= 2
            self.join_cap *= 2
            self.bucket_cap *= 2
        raise RuntimeError("distributed tagged fixpoint capacities failed to converge")

    def _initial_state(self, s, p, o, tags0, one_enc):
        """The sharded blocks and the initial delta (every fact, effective
        tags), or None when a shard's load exceeds a capacity."""
        n, F, D = self.n, self.fact_cap, self.delta_cap
        try:
            (ss, sp, so, stg), sv = partition_rows((s, p, o, tags0), s, n, F)
            (os_, op, oo, otg), ov = partition_rows((s, p, o, tags0), o, n, F)
        except ValueError:
            # a shard's initial load exceeds fact_cap: infer()'s doubling
            # protocol retries, like every other capacity
            return None
        eff = np.where(np.isnan(stg), one_enc, stg)
        if D < F:
            if int(sv.sum(axis=1).max(initial=0)) > D:
                return None
            delta = [a[:, :D] for a in (ss, sp, so, eff, sv)]
        else:
            delta = [np.concatenate([a, np.zeros((n, D - F), a.dtype)], axis=1)
                     for a in (ss, sp, so, eff, sv)]
        arrays = [shard_put(self.mesh, a)
                  for a in (ss, sp, so, stg, sv, os_, op, oo, otg, ov, *delta)]
        return [_Shard(*(a[i] for a in arrays)) for i in range(n)]

    def _replicated(self, arrays):
        """Per shard, that shard's copies of the host ``arrays``."""
        per = [replicate(self.mesh, torch.from_numpy(np.ascontiguousarray(a))) for a in arrays]
        return [tuple(c[i] for c in per) for i in range(self.n)]

    def _try_infer(self, s, p, o, tags0, one_enc, max_rounds):
        n = self.n
        caps = self._caps()
        state = self._initial_state(s, p, o, tags0, one_enc)
        if state is None:
            return None
        masks = self._replicated(self.bank.materialize())
        gt_pos, gt_naf = (
            [g[0] for g in self._replicated(
                [_guard_tag_array([lr for lr, _ in rules], self.provenance, self.tag_store)])]
            for rules in (self.pos_rules, self.naf_rules)
        )
        if self.kind == "addmult" and self.naf_rules:
            seen_state = [
                ([tuple(torch.full((self.seen_cap,), SENT, dtype=torch.int64, device=d)
                        for _ in range(self._rule_vars(lr))) for d in self.mesh.devices],
                 [torch.zeros((), dtype=torch.int64, device=d) for d in self.mesh.devices])
                for lr, _pl in self.naf_rules
            ]

        def commit(out):
            nonlocal state
            new_state, count, overflow = out[:3]
            ovf, cnt = _read_ints([overflow, count])  # the dispatch's one host read
            self.dispatches += 1
            if ovf > 0:
                return None
            self.rounds += 1
            state = new_state
            return cnt

        quiesced = not self.pos_rules  # no positive stratum to drain
        for _ in range(max_rounds):
            if not quiesced:
                cnt = commit(_tagged_round(state, masks, one_enc, gt_pos, rules=self.pos_rules,
                                           n=n, caps=caps, kind=self.kind))
                if cnt is None:
                    return None
                if cnt > 0:
                    continue
                quiesced = True
            # positive stratum drained: fire one NAF pass (host stratified
            # loop parity); its delta re-enters the positive stratum
            if not self.naf_rules:
                return self._extract(state)
            if not self.naf_sequential:
                cnt = commit(_naf_pass(state, masks, one_enc, gt_naf, rules=self.naf_rules,
                                       neg_kind=self.neg_kind, n=n, caps=caps))
                if cnt is None:
                    return None
                if cnt == 0:
                    return self._extract(state)
            else:
                # sequential pass: per-shard fact counts BEFORE, one dispatch
                # per rule, then the pass delta = exactly the rows each shard
                # appended during the pass, read WITH their final tags (a
                # later rule may have ⊕-improved an earlier rule's fresh fact)
                n_before = _read_ints([st.fv.sum() for st in state])
                for i, rule in enumerate(self.naf_rules):
                    gi = [g[i:i + 1] for g in gt_naf]
                    if self.kind == "addmult":
                        cols, cnts = seen_state[i]
                        out = _naf_pass_addmult(state, cols, cnts, masks, [g[0] for g in gi],
                                                rule=rule, n=n, caps=caps,
                                                seen_cap=self.seen_cap)
                        if commit(out) is None:
                            return None
                        seen_state[i] = (out[3], out[4])
                    elif commit(_naf_pass(state, masks, one_enc, gi, rules=(rule,),
                                          neg_kind=self.neg_kind, n=n, caps=caps)) is None:
                        return None
                n_after = _read_ints([st.fv.sum() for st in state])
                grown = [a - b for a, b in zip(n_after, n_before)]
                if sum(grown) == 0:
                    return self._extract(state)
                if max(grown) > self.delta_cap:
                    return None  # retry at doubled caps
                state = [self._pass_delta(st, b, a, one_enc)
                         for st, b, a in zip(state, n_before, n_after)]
            quiesced = not self.pos_rules
        raise RuntimeError("distributed tagged fixpoint hit the round limit")

    def _pass_delta(self, st: _Shard, b: int, a: int, one_enc) -> _Shard:
        """A shard's state with the delta = its rows ``[b, a)`` (appended
        during a sequential pass), effective tags."""
        D = self.delta_cap
        t = st.ftag[b:a]
        dtag = _pad(torch.where(torch.isnan(t), one_enc, t), D)
        dv = torch.arange(D, device=st.fv.device) < (a - b)
        return st._replace(ds=_pad(st.fs[b:a], D), dp=_pad(st.fp[b:a], D),
                           do=_pad(st.fo[b:a], D), dtag=dtag, dv=dv)

    @staticmethod
    def _extract(state):
        """The valid fact rows of every shard, with tags, on the first
        shard's device."""
        dev0 = state[0].fv.device
        return tuple(torch.cat([getattr(st, k)[st.fv].to(dev0) for st in state])
                     for k in ("fs", "fp", "fo", "ftag"))

    def _write_back(self, cols, tags0, fs, fp, fo, ft) -> int:
        """Append derived facts (sorted) and store changed-or-new tag
        entries (vectorized, host-TagStore parity).  ``cols`` / ``tags0``
        are the seed facts and their tags (NaN: no entry)."""
        n0 = cols[0].shape[0]
        found, rows = _fact_lookup(fs, fp, fo, torch.ones_like(ft, dtype=torch.bool), *cols,
                                   torch.ones_like(tags0, dtype=torch.bool), n0)
        v0 = torch.where(found, tags0[rows.clamp(max=n0 - 1)], float("nan"))
        # an entry for every non-NaN tag that is new or differs from the
        # seed (a NaN seed differs from every value)
        entry = (~torch.isnan(ft) & (ft != v0)).cpu().numpy()
        new = (~found).cpu().numpy()
        fs, fp, fo = (c.cpu().numpy().astype(np.uint32) for c in (fs, fp, fo))
        if new.any():
            ns, np_, no = fs[new], fp[new], fo[new]
            order = np.lexsort((no, np_, ns))
            self.reasoner.facts.add_batch(ns[order], np_[order], no[order])
        if entry.any():
            keys = zip(fs[entry].tolist(), fp[entry].tolist(), fo[entry].tolist())
            vals = ft.cpu().numpy()[entry]
            self.tag_store.tags.update(zip(keys, _decode_tags(self.provenance, vals)))
        return int(new.sum())
