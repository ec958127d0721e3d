"""Distributed semi-naive Datalog fixpoint over a shard mesh.

Port of ``kolibrie_tpu/parallel/dist_fixpoint.py``.  The fact base itself
is hash-partitioned across shards (subject-owned, with an object-hashed
mirror — :class:`~kolibrie_tpu_torch.parallel.sharded_store.
ShardedTripleStore`), and each round is one pass of controller code over
the shards:

  1. join the round's delta against the full fact base for every rule, in
     both premise positions (delta-as-p1 needs one all-to-all to move delta
     rows to the shard owning their join key; delta-as-p2 is local by
     construction),
  2. route derived triples to their subject-owner shard (all-to-all),
  3. sort-unique + set-difference against known facts → the next delta,
  4. psum the global new-fact count — the host loop stops at zero.

Supported rule shapes (the distributed fast path; everything else runs on
the host reasoner or :mod:`~kolibrie_tpu_torch.parallel.dist_general`):

- unary:  ``head(X,Y) :- p(X,Y)``            (predicate renaming / RDFS sub*)
- binary: ``head(X,Z) :- p1(X,Y), p2(Y,Z)``  (transitivity / chains)

Capacities are static per shard; a scatter past one drops into a spare
slot that is cut off (the reference's ``mode="drop"``), and the drop
counts into the round's overflow.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch

from kolibrie_tpu_torch.core.rule import Rule
from kolibrie_tpu_torch.core.terms import Term
from kolibrie_tpu_torch.ops.device_join import _row_membership
from kolibrie_tpu_torch.ops.device_join import _sort_unique3 as _sort_unique3
from kolibrie_tpu_torch.parallel.dist_join import (
    _LPAD32,
    _RPAD32,
    exchange,
    local_join_u32,
    shard_of_dev,
)
from kolibrie_tpu_torch.parallel.mesh import Mesh, psum
from kolibrie_tpu_torch.parallel.sharded_store import ShardedTripleStore

__all__ = ["DistRuleSet", "DistributedReasoner", "distributed_seminaive"]


@dataclass
class DistRuleSet:
    """Rules lowered to u32 predicate IDs for the device fixpoint."""

    unary: List[Tuple[int, int]] = field(default_factory=list)  # (p, head)
    binary: List[Tuple[int, int, int]] = field(default_factory=list)  # (p1, p2, head)

    @classmethod
    def from_rules(cls, rules: List[Rule]) -> Optional["DistRuleSet"]:
        """Lower :class:`Rule` objects; ``None`` if any rule is unsupported."""
        rs = cls()
        for r in rules:
            if r.negative_premise or r.filters or len(r.conclusion) != 1:
                return None
            (hs, hp, ho) = _pat(r.conclusion[0])
            if len(r.premise) == 1:
                (s1, p1, o1) = _pat(r.premise[0])
                if (
                    isinstance(p1, int)
                    and isinstance(hp, int)
                    and s1 == hs
                    and o1 == ho
                    and isinstance(s1, str)
                    and isinstance(o1, str)
                    and s1 != o1
                ):
                    rs.unary.append((p1, hp))
                    continue
                return None
            if len(r.premise) == 2:
                (s1, p1, o1) = _pat(r.premise[0])
                (s2, p2, o2) = _pat(r.premise[1])
                ok = (
                    isinstance(p1, int)
                    and isinstance(p2, int)
                    and isinstance(hp, int)
                    and isinstance(s1, str)
                    and isinstance(o1, str)
                    and isinstance(o2, str)
                    and o1 == s2  # chain variable
                    and hs == s1
                    and ho == o2
                    and len({s1, o1, o2}) == 3
                )
                if ok:
                    rs.binary.append((p1, p2, hp))
                    continue
                return None
            return None
        return rs


def _pat(pattern):
    out = []
    for t in pattern.terms():
        if isinstance(t, Term):
            out.append(t.value if t.is_variable else int(t.value))
        else:
            out.append(t)
    return tuple(out)


def _append_rows(cols, valid, new_cols, new_valid, cap):
    """Append one shard's new rows after its current valid block (static
    shapes): rows past ``cap`` drop into a spare slot that is cut off."""
    dev = valid.device
    count = valid.sum()
    rank = torch.cumsum(new_valid, 0) - 1
    dest = torch.where(new_valid, count + rank, cap).clamp(max=cap)
    outs = []
    for c, nc in zip(cols, new_cols):
        out = torch.cat([c, c.new_zeros(1)])
        out[dest] = nc
        outs.append(out[:cap])
    out_valid = torch.cat([valid, torch.zeros(1, dtype=torch.bool, device=dev)])
    out_valid[dest] = new_valid
    overflow = (count + new_valid.sum() - cap).clamp(min=0)
    return tuple(outs), out_valid[:cap], overflow


def _member3(ours, ours_valid, theirs, theirs_valid):
    """For each u32 ``(s, p, o)`` row of ``ours``: does it occur among the
    valid rows of ``theirs``?  The reference sorts ``theirs`` once and
    narrows a per-row binary search level by level; here the rows pack
    exactly (dense rank of ``(s, p)`` over both sides, then ``o``) and one
    ``searchsorted`` answers (``ops/device_join.py::_row_membership``).
    Padding rows carry different sentinels on the two sides, so padding
    never matches padding."""
    o = [torch.where(ours_valid, c, _LPAD32) for c in ours]
    t = [torch.where(theirs_valid, c, _RPAD32) for c in theirs]
    return ours_valid & _row_membership(o, t)


def _compact_front(cols, valid, cap):
    """Rows of ``valid`` compacted to the front of ``cap``-row outputs
    (order kept), their validity and count."""
    dev = valid.device
    dst = torch.where(valid, torch.cumsum(valid, 0) - 1, cap).clamp(max=cap)
    outs = []
    for c in cols:
        out = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
        out[dst] = c
        outs.append(out[:cap])
    n_new = valid.sum()
    return tuple(outs), torch.arange(cap, device=dev) < n_new, n_new


def _finish_round(n, cands, fcols, fv, gcols, gv, *, fact_cap, delta_cap, bucket_cap):
    """The common tail of a round: route candidate triples to their
    subject owner, sort-unique, subtract known facts, append the new delta
    to the facts and (routed to object owners) to the mirror.  ``cands[i]``
    is shard *i*'s ``(s, p, o, valid)``.  Returns the next state, the
    global new-fact count and the overflow."""
    (routed, rvalid, drop1) = exchange(
        [c[:3] for c in cands],
        [c[3] for c in cands],
        [shard_of_dev(c[0], n) for c in cands],
        n,
        bucket_cap,
    )
    deltas, ndvs, n_news, local_ovf = [], [], [], []
    for i in range(n):
        (us, up, uo), uv, n_uniq = _sort_unique3(routed[i], rvalid[i], delta_cap)
        known = _member3((us, up, uo), uv, fcols[i], fv[i])
        delta, ndv, n_new = _compact_front((us, up, uo), uv & ~known, delta_cap)
        deltas.append(delta)
        ndvs.append(ndv)
        n_news.append(n_new)
        local_ovf.append((n_uniq - delta_cap).clamp(min=0))
    new_f, new_fv, new_g, new_gv = [], [], [], []
    for i in range(n):
        cols, v, ovf = _append_rows(fcols[i], fv[i], deltas[i], ndvs[i], fact_cap)
        new_f.append(cols)
        new_fv.append(v)
        local_ovf.append(ovf)
    mirrored, mvalid, drop2 = exchange(
        deltas, ndvs, [shard_of_dev(d[2], n) for d in deltas], n, bucket_cap
    )
    for i in range(n):
        cols, v, ovf = _append_rows(gcols[i], gv[i], mirrored[i], mvalid[i], fact_cap)
        new_g.append(cols)
        new_gv.append(v)
        local_ovf.append(ovf)
    overflow = psum(local_ovf)
    overflow = overflow + drop1.to(overflow.device) + drop2.to(overflow.device)
    state = (new_f, new_fv, new_g, new_gv, deltas, ndvs)
    return state, psum(n_news), overflow


def _round_body(state, *, unary, binary, n, fact_cap, delta_cap, join_cap, bucket_cap):
    """One semi-naive round over every shard.  ``state`` is ``(fcols, fv,
    gcols, gv, dcols, dv)``: per shard the subject-owned facts, the
    object-hashed mirror and the delta."""
    fcols, fv, gcols, gv, dcols, dv = state
    derived = [[] for _ in range(n)]
    ovfs = []
    drops = None
    for pb, ph in unary:
        for i in range(n):
            ds, dp_, do_ = dcols[i]
            m = dv[i] & (dp_ == pb)
            derived[i].append((ds, torch.full_like(dp_, ph), do_, m))
    for p1, p2, ph in binary:
        # Δ as premise1: key Y = Δ.o → shard hash(o); facts p2 subject-owned
        sent, svalid, drop0 = exchange(
            dcols,
            [dv[i] & (dcols[i][1] == p1) for i in range(n)],
            [shard_of_dev(dcols[i][2], n) for i in range(n)],
            n,
            bucket_cap,
        )
        drops = drop0 if drops is None else drops + drop0.to(drops.device)
        for i in range(n):
            es, _ep, eo = sent[i]
            fs, fp, fo = fcols[i]
            li, ri, jv, jtot = local_join_u32(eo, fs, join_cap, svalid[i], fv[i] & (fp == p2))
            ovfs.append((jtot - join_cap).clamp(min=0))
            derived[i].append(
                (
                    torch.where(jv, es[li], 0),
                    torch.full((join_cap,), ph, dtype=torch.int64, device=jv.device),
                    torch.where(jv, fo[ri], 0),
                    jv,
                )
            )
            # Δ as premise2: key Y = Δ.s (already owner-local); probe the
            # object-hashed mirror for p1 facts with fact.o == Δ.s
            ds, dp_, do_ = dcols[i]
            gs, gp, go = gcols[i]
            li2, ri2, jv2, jtot2 = local_join_u32(
                go, ds, join_cap, gv[i] & (gp == p1), dv[i] & (dp_ == p2)
            )
            ovfs.append((jtot2 - join_cap).clamp(min=0))
            derived[i].append(
                (
                    torch.where(jv2, gs[li2], 0),
                    torch.full((join_cap,), ph, dtype=torch.int64, device=jv2.device),
                    torch.where(jv2, do_[ri2], 0),
                    jv2,
                )
            )
    cands = []
    for i in range(n):
        dev = dv[i].device
        if derived[i]:
            cands.append(tuple(torch.cat([d[k] for d in derived[i]]) for k in range(4)))
        else:
            z = torch.zeros(1, dtype=torch.int64, device=dev)
            cands.append((z, z, z, torch.zeros(1, dtype=torch.bool, device=dev)))
    state, count, overflow = _finish_round(
        n, cands, fcols, fv, gcols, gv,
        fact_cap=fact_cap, delta_cap=delta_cap, bucket_cap=bucket_cap,
    )
    if ovfs:
        overflow = overflow + psum(ovfs).to(overflow.device)
    if drops is not None:
        overflow = overflow + drops.to(overflow.device)
    return state, count, overflow


def _initial_delta(store: ShardedTripleStore, width: int):
    """Round 0's delta — every fact — per shard, cut or padded to
    ``width`` rows (valid rows sit in a front block per shard)."""

    def fit(t, fill):
        out = torch.full((width,), fill, dtype=t.dtype, device=t.device)
        w = min(width, t.shape[0])
        out[:w] = t[:w]
        return out

    cols = [tuple(fit(t, 0) for t in shard) for shard in store.shard_state()[0]]
    return cols, [fit(v, False) for v in store.by_subj_valid]


class DistributedReasoner:
    """Host driver for the device fixpoint.

    ``infer()`` runs semi-naive rounds until the global new-fact count is
    zero (one read of the count and the overflow per round — the only host
    sync)."""

    def __init__(
        self,
        mesh: Mesh,
        ruleset: DistRuleSet,
        fact_cap: int = 4096,
        delta_cap: int = 2048,
        join_cap: int = 4096,
        bucket_cap: int = 1024,
    ):
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.n = mesh.size
        self.ruleset = ruleset
        self.fact_cap = fact_cap
        self.delta_cap = delta_cap
        self.join_cap = join_cap
        self.bucket_cap = bucket_cap

    def _round(self, state):
        return _round_body(
            state,
            unary=tuple(self.ruleset.unary),
            binary=tuple(self.ruleset.binary),
            n=self.n,
            fact_cap=self.fact_cap,
            delta_cap=self.delta_cap,
            join_cap=self.join_cap,
            bucket_cap=self.bucket_cap,
        )

    def infer(self, store: ShardedTripleStore, max_rounds: int = 64) -> int:
        """Run to fixpoint; facts accumulate inside ``store``.  Returns the
        number of rounds executed (excluding the final empty round)."""
        if store.cap != self.fact_cap:
            raise ValueError("store capacity must match reasoner fact_cap")
        # initial delta = all facts (round-0 semantics of semi-naive with
        # empty previous state).  Valid rows sit in a contiguous front block
        # per shard, so a shard holding more seed facts than delta_cap
        # would lose some — refuse rather than run an incomplete fixpoint
        per_shard = max(int(v.sum()) for v in store.by_subj_valid)
        if per_shard > self.delta_cap:
            raise OverflowError(
                f"initial delta ({per_shard} facts on one shard) exceeds "
                f"delta_cap={self.delta_cap}"
            )
        state = store.shard_state() + _initial_delta(store, self.delta_cap)
        rounds = 0
        for _ in range(max_rounds):
            state, count, overflow = self._round(state)
            if int(overflow) > 0:
                raise OverflowError(
                    "distributed fixpoint buffer overflow — grow "
                    "fact_cap/delta_cap/join_cap/bucket_cap"
                )
            if int(count) == 0:
                break
            rounds += 1
        adopt_state(store, state)
        return rounds


def adopt_state(store: ShardedTripleStore, state) -> None:
    """Write a round's fact blocks (``state[:4]``: subject copy, its
    validity, object copy, its validity, per shard) back into ``store``;
    the probe index rebuilds lazily on the next ``ensure_subj_index()``."""
    fcols, fv, gcols, gv = state[:4]
    store.by_subj = tuple(tuple(c[k] for c in fcols) for k in range(3))
    store.by_subj_valid = tuple(fv)
    store.by_obj = tuple(tuple(c[k] for c in gcols) for k in range(3))
    store.by_obj_valid = tuple(gv)


def distributed_seminaive(mesh: Mesh, store: ShardedTripleStore, rules: List[Rule], **caps) -> int:
    """Lower rules and run the fixpoint.  Raises on rules the distributed
    fast path can't express (the caller falls back to the host
    :class:`~kolibrie_tpu_torch.reasoner.reasoner.Reasoner`)."""
    rs = DistRuleSet.from_rules(rules)
    if rs is None:
        raise NotImplementedError("rule set not expressible on the distributed fast path")
    caps.setdefault("fact_cap", store.cap)
    dr = DistributedReasoner(mesh, rs, **caps)
    return dr.infer(store)
