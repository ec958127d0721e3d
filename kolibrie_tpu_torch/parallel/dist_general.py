"""General distributed semi-naive fixpoint: arbitrary rule shapes.

Port of ``kolibrie_tpu/parallel/dist_general.py``.
:mod:`~kolibrie_tpu_torch.parallel.dist_fixpoint` lowers only two rule
shapes (unary renaming, binary chains).  This module runs ARBITRARY
positive rules — any premise count, constants in any position,
shared/repeated variables, numeric filters, stratum-free NAF — across the
shard mesh, reusing the single-device lowering IR
(:mod:`kolibrie_tpu_torch.reasoner.device_fixpoint`).

Per round (one pass of controller code over the shards):

1. seed a binding table from the shard-local delta for every (rule, seed
   premise) pair,
2. for each further premise, route binding rows to the shard owning the
   join key (all-to-all), then join locally against the subject-owned
   facts (key at subject) or the object-hashed mirror (key at object);
   extra shared variables beyond the routed key become post-join equality
   masks,
3. numeric filters gather replicated per-ID masks; NAF premises route rows
   to the owner of the instantiated negated subject and anti-check
   membership there,
4. conclusions are instantiated, routed to their subject owner, deduped
   (sort-unique), subtracted against known facts, appended to the facts
   and the object mirror; the global new-fact count is the psum the host
   loop terminates on.

Premise scans go through ``device_fixpoint._scan_premise`` (the fused
``filter_mask`` kernel on the card) and joins through
``dist_join.local_join_u32`` (the merge-path kernel).  Static-shape
overflow protocol as everywhere else: an overflowing round reports a
global drop/overflow count; the host doubles the capacities and retries.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kolibrie_tpu_torch.core.rule import Rule
from kolibrie_tpu_torch.ops import round_cap
from kolibrie_tpu_torch.parallel.dist_fixpoint import _finish_round, _initial_delta, _member3
from kolibrie_tpu_torch.parallel.dist_join import exchange, local_join_u32, shard_of_dev
from kolibrie_tpu_torch.parallel.mesh import Mesh, psum, replicate
from kolibrie_tpu_torch.parallel.sharded_store import ShardedTripleStore
from kolibrie_tpu_torch.reasoner.device_fixpoint import (
    LoweredPremise,
    Unsupported,
    _MaskBank,
    _scan_premise,
    lower_rules,
)

__all__ = ["DistGeneralReasoner", "distributed_seminaive_general", "Unsupported"]


# ---------------------------------------------------------------------------
# Distributed planning: single routed key per step, rest as equality masks
# ---------------------------------------------------------------------------


def _pos_of_var(prem: LoweredPremise) -> Dict[str, int]:
    return {v: pos for v, pos in prem.vars}


def _plan_rule_dist(premises: Tuple[LoweredPremise, ...]) -> tuple:
    """Per seed position: join order, and per step ``(j, key_var,
    key_pos, extra_eq_vars)``.  ``key_pos`` must be 0 (subject-owned
    facts) or 2 (object mirror) — predicates are not a partition axis."""
    plans = []
    for i in range(len(premises)):
        bound = {v for v, _ in premises[i].vars}
        remaining = [j for j in range(len(premises)) if j != i]
        steps: List[tuple] = []
        while remaining:
            best = None
            for j in remaining:
                pv = _pos_of_var(premises[j])
                shared = set(pv) & bound
                if not shared:
                    continue
                # prefer a subject-position key, then object
                key = None
                for v in sorted(shared):
                    if pv[v] == 0:
                        key = (v, 0)
                        break
                if key is None:
                    for v in sorted(shared):
                        if pv[v] == 2:
                            key = (v, 2)
                            break
                if key is None:
                    continue  # only predicate-position sharing: try later
                cand = (len(shared), j, key, tuple(sorted(shared - {key[0]})))
                if best is None or cand[0] > best[0]:
                    best = cand
            if best is None:
                raise Unsupported("premise join key not at subject/object position")
            _, j, (kv, kpos), extra = best
            steps.append((j, kv, kpos, extra))
            bound |= {v for v, _ in premises[j].vars}
            remaining.remove(j)
        plans.append((i, tuple(steps)))
    return tuple(plans)


def lower_rules_dist(reasoner, rules: List[Rule]) -> Tuple[tuple, _MaskBank]:
    """Single-device lowering + distributed join plans."""
    lowered, bank = lower_rules(reasoner, rules)
    return tuple((lr, _plan_rule_dist(lr.premises)) for lr in lowered), bank


# ---------------------------------------------------------------------------
# The round (controller code over the shards)
# ---------------------------------------------------------------------------


def _exchange_table(tables, valid, key_var, n, bucket_cap):
    """Route every shard's binding table to ``hash(table[key_var])``
    owners; returns the routed tables, validity, and the global dropped
    count."""
    names = sorted(tables[0])
    routed, rvalid, dropped = exchange(
        [tuple(t[v] for v in names) for t in tables],
        valid,
        [shard_of_dev(t[key_var], n) for t in tables],
        n,
        bucket_cap,
    )
    return [dict(zip(names, r)) for r in routed], rvalid, dropped


def _pos2var(prem: LoweredPremise) -> Dict[int, str]:
    m = {pos: v for v, pos in prem.vars}
    for a, b in prem.eq_pairs:
        m[b] = m[a]
    return m


def _instantiate(term_map, consts, table, length, device):
    cols = []
    for pos in range(3):
        if consts[pos] is not None:
            cols.append(torch.full((length,), consts[pos], dtype=torch.int64, device=device))
        else:
            cols.append(table[term_map[pos]])
    return cols


def _join_step(tables, valids, fcols, fv, gcols, gv, prem, kv, kpos, extra, join_cap):
    """One routed join step on every shard (rows already co-located on
    ``kv``): scan the side premise, join locally, carry the side's new
    variables, mask extra shared variables.  Returns the new tables,
    validity and the per-shard overruns."""
    out_t, out_v, ovfs = [], [], []
    for i, (table, valid) in enumerate(zip(tables, valids)):
        if kpos == 0:
            side_cols, side_valid, side_key = fcols[i], fv[i], fcols[i][0]
        else:
            side_cols, side_valid, side_key = gcols[i], gv[i], gcols[i][2]
        ptable, pmask = _scan_premise(prem, side_cols, side_valid)
        li, ri, jvalid, total = local_join_u32(table[kv], side_key, join_cap, valid, pmask)
        ovfs.append((total - join_cap).clamp(min=0))
        new_table = {v: c[li] for v, c in table.items()}
        for v, c in ptable.items():
            if v not in new_table:
                new_table[v] = c[ri]
            elif v in extra:
                # shared var beyond the routed key: equality mask
                jvalid = jvalid & (new_table[v] == c[ri])
        out_t.append(new_table)
        out_v.append(jvalid)
    return out_t, out_v, ovfs


def _general_round(state, masks, *, rules, n, fact_cap, delta_cap, join_cap, bucket_cap):
    """One round over every shard.  ``masks[i]`` are shard *i*'s copies of
    the replicated per-ID filter masks."""
    fcols, fv, gcols, gv, dcols, dv = state
    ovfs: List[torch.Tensor] = []
    drops: List[torch.Tensor] = []
    parts = [[] for _ in range(n)]
    for lr, plans in rules:
        # ground-guard gate: shard-local membership in the subject-owned
        # block, psum'd — non-derivable (lowering gate), so constant
        # through the closure
        guard_ok = None
        for g in lr.guards:
            hits = [_scan_premise(g, fcols[i], fv[i])[1].any().to(torch.int64) for i in range(n)]
            hit = psum(hits) > 0
            guard_ok = hit if guard_ok is None else (guard_ok & hit)
        for seed, steps in plans:
            tables, valids = [], []
            for i in range(n):
                table, valid = _scan_premise(lr.premises[seed], dcols[i], dv[i])
                if guard_ok is not None:
                    valid = valid & guard_ok.to(valid.device)
                tables.append(table)
                valids.append(valid)
            for j, kv, kpos, extra in steps:
                # route bindings to the shard owning the join key
                tables, valids, dropped = _exchange_table(tables, valids, kv, n, bucket_cap)
                drops.append(dropped)
                tables, valids, step_ovf = _join_step(
                    tables, valids, fcols, fv, gcols, gv, lr.premises[j], kv, kpos, extra,
                    join_cap,
                )
                ovfs.extend(step_ovf)
            # filters (replicated per-ID masks)
            for i in range(n):
                valids[i] = _apply_filters(lr.filters, tables[i], valids[i], masks[i])
            # NAF: route to the owner of the instantiated negated subject,
            # anti-check membership in the subject-owned facts there
            for neg in lr.negs:
                p2v = _pos2var(neg)
                names = sorted(tables[0])
                cols, dest = [], []
                for i in range(n):
                    L = valids[i].shape[0]
                    inst = _instantiate(p2v, neg.consts, tables[i], L, valids[i].device)
                    cols.append(tuple(tables[i][v] for v in names) + tuple(inst))
                    dest.append(shard_of_dev(inst[0], n))
                routed, rvalid, dropped = exchange(cols, valids, dest, n, bucket_cap)
                drops.append(dropped)
                tables, valids = [], []
                for i in range(n):
                    tables.append(dict(zip(names, routed[i][:-3])))
                    member = _member3(routed[i][-3:], rvalid[i], fcols[i], fv[i])
                    valids.append(rvalid[i] & ~member)
            # conclusions
            for i in range(n):
                L = valids[i].shape[0]
                dev = valids[i].device
                for concl in lr.concls:
                    cols = []
                    for kind, v in concl:
                        if kind == "const":
                            cols.append(torch.full((L,), v, dtype=torch.int64, device=dev))
                        else:
                            cols.append(tables[i][v])
                    parts[i].append((cols[0], cols[1], cols[2], valids[i]))
    cands = [tuple(torch.cat([p[k] for p in parts[i]]) for k in range(4)) for i in range(n)]
    state, count, overflow = _finish_round(
        n, cands, fcols, fv, gcols, gv,
        fact_cap=fact_cap, delta_cap=delta_cap, bucket_cap=bucket_cap,
    )
    for extra in (ovfs, drops):
        if extra:
            overflow = overflow + psum(extra).to(overflow.device)
    return state, count, overflow


def _apply_filters(filters, table, valid, masks):
    for f in filters:
        col = table[f.var]
        if f.kind == "eq":
            valid = valid & (col == f.const_id)
        elif f.kind == "ne":
            valid = valid & (col != f.const_id)
        else:
            m = masks[f.mask_idx]
            valid = valid & m[col.clamp(max=m.shape[0] - 1)]
    return valid


# ---------------------------------------------------------------------------
# Host driver
# ---------------------------------------------------------------------------


class DistGeneralReasoner:
    """Host driver for the general distributed fixpoint (see module doc)."""

    def __init__(
        self,
        mesh: Mesh,
        reasoner,
        fact_cap: Optional[int] = None,
        delta_cap: Optional[int] = None,
        join_cap: Optional[int] = None,
        bucket_cap: Optional[int] = None,
    ):
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.n = mesh.size
        self.reasoner = reasoner
        self.rules, self.bank = lower_rules_dist(reasoner, reasoner.rules)
        n_local = max(1, -(-len(reasoner.facts) // self.n))
        self.fact_cap = fact_cap or round_cap(8 * n_local, 512)
        self.delta_cap = delta_cap or round_cap(4 * n_local, 256)
        self.join_cap = join_cap or round_cap(4 * n_local, 256)
        self.bucket_cap = bucket_cap or round_cap(4 * n_local, 256)
        self.attempts = 0  # capacity attempts of the last infer()
        self.rounds = 0  # rounds of the last infer(), the final empty one included

    def infer(self, max_rounds: int = 256, max_attempts: int = 8) -> int:
        """Run to fixpoint over a :class:`ShardedTripleStore` built from the
        reasoner's facts; derived facts are written back into
        ``reasoner.facts``.  Returns the number of derived facts."""
        r = self.reasoner
        s, p, o = r.facts.columns()
        if len(s) == 0 or not self.rules:
            return 0
        for attempt in range(max_attempts):
            self.attempts = attempt + 1
            derived = self._try_infer(s, p, o, max_rounds)
            if derived is not None:
                if len(derived[0]):
                    r.facts.add_batch(*derived)
                return len(derived[0])
            self.fact_cap *= 2
            self.delta_cap *= 2
            self.join_cap *= 2
            self.bucket_cap *= 2
        raise RuntimeError("distributed fixpoint capacities failed to converge")

    def _try_infer(self, s, p, o, max_rounds: int = 256):
        """One capacity attempt: the derived facts as u32 ``(s, p, o)``
        columns, or None on overflow (the caller doubles)."""
        store = ShardedTripleStore.from_columns(self.mesh, s, p, o, cap_per_shard=self.fact_cap)
        host_masks = self.bank.materialize()
        per_dev = [replicate(self.mesh, torch.from_numpy(m)) for m in host_masks]
        masks = [tuple(m[i] for m in per_dev) for i in range(self.n)]
        per_shard = max(int(v.sum()) for v in store.by_subj_valid)
        if per_shard > self.delta_cap:
            return None  # the initial delta does not fit: grow delta_cap
        seeds = [int(v.sum()) for v in store.by_subj_valid]
        state = store.shard_state() + _initial_delta(store, self.delta_cap)
        converged = False
        self.rounds = 0
        for _ in range(max_rounds):
            state, count, overflow = _general_round(
                state,
                masks,
                rules=self.rules,
                n=self.n,
                fact_cap=self.fact_cap,
                delta_cap=self.delta_cap,
                join_cap=self.join_cap,
                bucket_cap=self.bucket_cap,
            )
            self.rounds += 1
            if int(overflow) > 0:
                return None
            if int(count) == 0:
                converged = True
                break
        if not converged:
            raise RuntimeError("distributed fixpoint hit the round limit before convergence")
        # the derived facts: a shard appends its new facts after its valid
        # block, each deduplicated and new there, and only its subject's
        # owner holds a fact — so the rows past each shard's seed block
        # are exactly the closure less the seed facts
        fcols, fv = state[0], state[1]
        return tuple(
            np.concatenate(
                [c[k][seed:int(v.sum())].cpu().numpy() for c, v, seed in zip(fcols, fv, seeds)]
            ).astype(np.uint32)
            for k in range(3)
        )


def distributed_seminaive_general(mesh: Mesh, reasoner, **caps) -> int:
    """Lower the reasoner's rules for the mesh and run the general
    distributed fixpoint; raises :class:`Unsupported` for rule shapes even
    this path can't express (quoted patterns, predicate-position joins) —
    callers then fall back to the host reasoner."""
    return DistGeneralReasoner(mesh, reasoner, **caps).infer()
