"""Semi-naive Datalog fixpoint on the device.

Port of ``kolibrie_tpu/reasoner/device_fixpoint.py``.  The host strategies
(:mod:`kolibrie_tpu_torch.reasoner.strategies`) evaluate rule bodies with
numpy joins round by round.  Here every round runs on the device: delta-
seeded premise joins (static-capacity merge-path joins), filter masks, NAF
anti-joins, conclusion instantiation, sort-unique dedup, set difference
against the known facts, fact append.

The reference runs the whole fixpoint as ONE XLA dispatch (a
``lax.while_loop`` whose body is one round).  PyTorch runs eagerly, so the
loop is a host loop of rounds; each round queues its device work and the
host reads ONE scalar pair per round (the new-fact count and the overflow
code together), which both ends the loop and commits the round.

Parity: ``datalog/src/reasoning/materialisation/semi_naive_parallel.rs:11-177``
— the rayon delta fan-out becomes whole-column joins; ``semi_naive.rs:22-59``
— delta seeding per premise position.

Static-shape protocol: every buffer has a power-of-two capacity.  A round
that would overflow any capacity does NOT commit (the loop stops with the
pre-round state and an overflow code); the host side doubles the failing
capacity and re-enters the loop from the preserved state.  The overflow
code is a bitmask: bit0 join cap, bit1 delta cap, bit2 fact cap, bit3 round
limit reached with work remaining.

GROUND quoted (RDF-star) terms lower to their qid constants — premises
against never-interned triples become never-match scans, quoted
conclusions intern eagerly at lowering.  Rules whose shapes the device
path cannot express (quoted terms with INNER VARIABLES, non-numeric
filters, cartesian premise joins) raise :class:`Unsupported`; callers run
the host strategies.  3-variable join keys ride the union dense-rank
composition (``ops/device_join.py::pack_key_multi``).

Kernels: every premise scan's constant clauses go through the fused
``filter_mask`` kernel and every premise join through
``ranked_merge_join_indices`` (the merge-path kernel) — on CUDA tensors
the kernels, on CPU tensors their plain versions; there is no switch.
Fact columns are int64 carriers of u32 IDs (:mod:`kolibrie_tpu_torch.backend`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kolibrie_tpu_torch.backend import _LPAD, _RPAD, key1, pack2
from kolibrie_tpu_torch.core.rule import FilterCondition, Rule
from kolibrie_tpu_torch.ops import round_cap as _round_cap
from kolibrie_tpu_torch.ops.device_join import (
    _row_membership,
    _sort_unique3,
    pack_key_multi,
    semi_join_mask,
)
from kolibrie_tpu_torch.ops.kernels import filter_mask, ranked_merge_join_indices

__all__ = ["Unsupported", "DeviceFixpoint", "infer_semi_naive_device"]


class Unsupported(Exception):
    """Rule set the device fixpoint cannot express (host fallback)."""


# ---------------------------------------------------------------------------
# Rule lowering (host) — copied from the reference
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LoweredPremise:
    consts: tuple  # (Optional[int], Optional[int], Optional[int])
    vars: tuple  # ((var, pos) first occurrence ...)
    eq_pairs: tuple  # ((pos, pos) ...) repeated variables


@dataclass(frozen=True)
class LoweredFilter:
    kind: str  # 'mask' (per-ID bool gather) | 'eq' | 'ne' (ID compare)
    var: str
    mask_idx: int = -1
    const_id: int = 0


@dataclass(frozen=True)
class LoweredRule:
    premises: tuple  # (LoweredPremise, ...)
    negs: tuple  # (LoweredPremise, ...)
    filters: tuple  # (LoweredFilter, ...)
    concls: tuple  # ((term, term, term), ...); term = ('var', name) | ('const', id)
    # per seed position: premise evaluation order (seed first) and the join
    # key variables for each subsequent step
    plans: tuple  # ((order: tuple[int], keys: tuple[tuple[str,...]]), ...)
    # fully-ground GUARD premises dropped from the join plan after static
    # satisfaction (see lower_rules: non-derivable + present in the initial
    # facts — facts never retract, so the gate holds for the whole closure).
    guards: tuple = ()


def _ground_quoted_id(term, quoted) -> Optional[int]:
    """qid of a GROUND quoted term (recursively constant inner triple), or
    None when the triple is not interned — a premise against it can never
    match.  Raises Unsupported for quoted terms with inner variables (the
    host unification path covers those)."""
    inner = term.value.terms()
    ids = []
    for t in inner:
        if t.is_quoted:
            qid = _ground_quoted_id(t, quoted)
            if qid is None:
                return None
            ids.append(qid)
        elif t.is_constant:
            ids.append(int(t.value))
        else:
            raise Unsupported("quoted-triple pattern with inner variables")
    if quoted is None:
        raise Unsupported("quoted-triple pattern without a quoted store")
    return quoted.lookup(*ids)


# never a dictionary ID (bits 0..30 + quoted bit 31, not all-ones): a scan
# constant that matches nothing — the lowering of a ground quoted premise
# whose triple was never interned.  Padding rows of the fact buffers are 0.
_NEVER_MATCH = 0xFFFFFFFF


def _lower_pattern(pattern, dictionary, quoted=None) -> LoweredPremise:
    consts: List[Optional[int]] = []
    out_vars: List[tuple] = []
    eq_pairs: List[tuple] = []
    seen: Dict[str, int] = {}
    for pos, t in enumerate(pattern.terms()):
        if t.is_quoted:
            # ground quoted term → its qid constant (absent ⇒ never match);
            # inner variables stay host-side (Unsupported from the helper)
            qid = _ground_quoted_id(t, quoted)
            consts.append(_NEVER_MATCH if qid is None else int(qid))
            continue
        if t.is_constant:
            consts.append(int(t.value))
        else:
            consts.append(None)
            if t.value in seen:
                eq_pairs.append((seen[t.value], pos))
            else:
                seen[t.value] = pos
                out_vars.append((t.value, pos))
    return LoweredPremise(tuple(consts), tuple(out_vars), tuple(eq_pairs))


def _plan_rule(premises: List[LoweredPremise]) -> tuple:
    """For each seed position: greedy connected join order + key vars."""
    plans = []
    for i in range(len(premises)):
        order = [i]
        bound = {v for v, _ in premises[i].vars}
        remaining = [j for j in range(len(premises)) if j != i]
        keys: List[tuple] = []
        while remaining:
            scored = []
            for j in remaining:
                jvars = {v for v, _ in premises[j].vars}
                scored.append((len(jvars & bound), -len(jvars), j))
            scored.sort(reverse=True)
            n_shared, _, best = scored[0]
            if n_shared == 0:
                raise Unsupported("cartesian premise join")
            jvars = {v for v, _ in premises[best].vars}
            shared = tuple(sorted(jvars & bound))
            # 1-2 keys pack exactly into u64; 3 keys (a premise has only
            # three positions) ride the union dense-rank composition
            keys.append(shared)
            order.append(best)
            bound |= jvars
            remaining.remove(best)
        plans.append((tuple(order), tuple(keys)))
    return tuple(plans)


class _MaskBank:
    """Per-ID boolean masks for numeric rule filters (host-precomputed)."""

    def __init__(self, reasoner):
        self.reasoner = reasoner
        self.exprs: List[tuple] = []  # (op, float const)
        self._keys: Dict[tuple, int] = {}

    def index_for(self, op: str, const: float) -> int:
        key = (op, const)
        idx = self._keys.get(key)
        if idx is None:
            idx = len(self.exprs)
            self.exprs.append(key)
            self._keys[key] = idx
        return idx

    def materialize(self) -> List[np.ndarray]:
        if not self.exprs:
            return []
        d = self.reasoner.dictionary
        n = len(d.id_to_str)
        cached = getattr(self, "_mask_cache", None)
        if cached is not None and cached[0] == n:
            return cached[1]
        vals = np.full(n, np.nan)
        for i in range(1, n):
            v = self.reasoner.numeric_value(i)
            if v is not None:
                vals[i] = v
        out = []
        with np.errstate(invalid="ignore"):
            for op, const in self.exprs:
                if op == "=":
                    m = vals == const
                elif op == "!=":
                    m = vals != const
                elif op == "<":
                    m = vals < const
                elif op == "<=":
                    m = vals <= const
                elif op == ">":
                    m = vals > const
                else:
                    m = vals >= const
                out.append(m & ~np.isnan(vals))
        self._mask_cache = (n, out)
        return out


def _guard_derivable(guard: LoweredPremise, rules: List[Rule]) -> bool:
    """Could any rule's conclusion unify with this fully-ground premise?
    Conservative syntactic test (variables unify with anything; quoted
    conclusion terms count as wildcards)."""
    for r in rules:
        for c in r.conclusion:
            if all(
                (not t.is_constant) or int(t.value) == g
                for t, g in zip(c.terms(), guard.consts)
            ):
                return True
    return False


def lower_rules(reasoner, rules: List[Rule]) -> Tuple[tuple, _MaskBank]:
    bank = _MaskBank(reasoner)
    lowered: List[LoweredRule] = []
    for rule in rules:
        quoted = getattr(reasoner, "quoted", None)
        prems = [
            _lower_pattern(p, reasoner.dictionary, quoted)
            for p in rule.premise
        ]
        if not prems:
            raise Unsupported("rule without positive premises")
        # fully-ground GUARD premises (the RDF-star annotation-gate shape):
        # facts never retract, so a non-derivable guard's truth is CONSTANT
        # through any one closure — it drops out of the JOIN PLAN and is
        # evaluated as a whole-rule membership gate at RUN time.  A
        # derivable guard can flip mid-closure, which the delta-seeded
        # plans over the remaining premises would miss — host fallback.
        guards = [p for p in prems if not p.vars]
        if guards:
            for g in guards:
                if _guard_derivable(g, rules):
                    raise Unsupported("derivable ground guard premise")
            prems = [p for p in prems if p.vars]
            if not prems:
                raise Unsupported("fully ground rule")
        bound = {v for pr in prems for v, _ in pr.vars}
        negs = [
            _lower_pattern(p, reasoner.dictionary, quoted)
            for p in rule.negative_premise
        ]
        for neg in negs:
            # the host path anti-joins on the SHARED variables only; a
            # negated variable outside the positive premises needs that
            # looser semantics — fall back
            if any(v not in bound for v, _ in neg.vars):
                raise Unsupported("negated variable unbound in positive premises")
        filters: List[LoweredFilter] = []
        for f in rule.filters:
            if f.variable not in bound:
                raise Unsupported("filter variable unbound in positive premises")
            filters.append(_lower_filter(f, bank))
        concls = []
        for c in rule.conclusion:
            terms = []
            for t in c.terms():
                if t.is_quoted:
                    # a GROUND quoted conclusion is a constant qid; intern
                    # eagerly.  Inner variables (constructing new quoted
                    # terms per binding) stay host-side.
                    inner = t.value.terms()
                    if any(not it.is_constant for it in inner):
                        raise Unsupported(
                            "quoted-triple conclusion with inner variables"
                        )
                    if quoted is None:
                        raise Unsupported("quoted conclusion without a store")
                    qid = quoted.intern(*(int(it.value) for it in inner))
                    terms.append(("const", int(qid)))
                    continue
                if t.is_constant:
                    terms.append(("const", int(t.value)))
                else:
                    if t.value not in bound:
                        raise Unsupported("head variable unbound in premises")
                    terms.append(("var", t.value))
            concls.append(tuple(terms))
        lowered.append(
            LoweredRule(
                tuple(prems),
                tuple(negs),
                tuple(filters),
                tuple(concls),
                _plan_rule(prems),
                tuple(guards),
            )
        )
    return tuple(lowered), bank


def _lower_filter(f: FilterCondition, bank: _MaskBank) -> LoweredFilter:
    if isinstance(f.value, bool):
        raise Unsupported("boolean filter value")
    if isinstance(f.value, int):
        if f.operator == "=":
            return LoweredFilter("eq", f.variable, const_id=int(f.value))
        if f.operator == "!=":
            return LoweredFilter("ne", f.variable, const_id=int(f.value))
        # ordered comparison against an ID-valued constant is numeric on the
        # DECODED literal in the host path — same here via the mask bank
        raise Unsupported("ordered comparison against term id")
    try:
        const = float(f.value)  # type: ignore[arg-type]
    except (TypeError, ValueError):
        raise Unsupported(f"non-numeric filter value {f.value!r}")
    return LoweredFilter("mask", f.variable, mask_idx=bank.index_for(f.operator, const))


# ---------------------------------------------------------------------------
# Device rounds
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Caps:
    fact: int
    delta: int
    join: int  # one shared capacity for all intermediate joins


ROUND_LIMIT = 10_000  # runaway-rule backstop, far above any real closure
# capacity-doubling runs before the one-run and chunked drivers give up
MAX_ATTEMPTS = 12
MAX_CHUNKED_ATTEMPTS = 64
_KNOWN_PAD = 0xFFFFFFFE  # candidate rows masked out of a membership probe
_FACT_PAD = 0xFFFFFFFF  # fact rows masked out of a membership probe


def _scan_premise(prem: LoweredPremise, cols, valid):
    """Premise match against a (cols, valid) buffer → (var table, mask).
    The constant clauses run as one fused ``filter_mask`` pass."""
    m = valid
    if any(c is not None for c in prem.consts):
        s_c, p_c, o_c = (-1 if c is None else c for c in prem.consts)
        m = m & filter_mask(cols[0], cols[1], cols[2], s_c, p_c, o_c)
    for a, b in prem.eq_pairs:
        m = m & (cols[a] == cols[b])
    table = {v: cols[pos] for v, pos in prem.vars}
    return table, m


def _pack(cols: List[torch.Tensor], valid, sentinel):
    """u64 key carrier of one or two u32 columns, padding where invalid."""
    key = key1(cols[0]) if len(cols) == 1 else pack2(cols[0], cols[1])
    return torch.where(valid, key, sentinel)


def _eval_filters(rule, table, valid, masks):
    for f in rule.filters:
        col = table[f.var]
        if f.kind == "eq":
            valid = valid & (col == f.const_id)
        elif f.kind == "ne":
            valid = valid & (col != f.const_id)
        else:
            m = masks[f.mask_idx]
            valid = valid & m[col.clamp(max=m.shape[0] - 1)]
    return valid


def _eval_negs(rule, table, valid, facts):
    fsx, fpx, fox, fvx = facts
    fcols = (fsx, fpx, fox)
    for neg in rule.negs:
        _t, nm = _scan_premise(neg, fcols, fvx)
        key_cols = [table[v] for v, _ in neg.vars]
        fact_cols = [fcols[pos] for _, pos in neg.vars]
        if not key_cols:
            # fully-constant negated premise: existence kills every row
            valid = valid & ~nm.any()
            continue
        if len(key_cols) <= 2:
            member = semi_join_mask(
                _pack(key_cols, valid, _LPAD), _pack(fact_cols, nm, _RPAD)
            )
        else:
            ours = [torch.where(valid, c, _KNOWN_PAD) for c in key_cols]
            theirs = [torch.where(nm, c, _FACT_PAD) for c in fact_cols]
            member = _row_membership(ours, theirs)
        valid = valid & ~member
    return valid


def _gen_candidates(rules, fcols, fvalid, dcols, dvalid, masks, J):
    """Candidate conclusions of one semi-naive round: delta-seeded premise
    joins + filters + NAF over a FROZEN fact snapshot, as static-cap column
    blocks.  Shared by the fixpoint's rounds and the per-round chunk
    (:func:`_device_round_chunk`).  Premise joins always go through
    ``ranked_merge_join_indices``.  Returns ``(cs, cp, co, cv, overflow)``
    with ``overflow`` a 0-dim int64 device tensor (bit0: a join overflowed
    ``J``)."""
    dev = fvalid.device
    facts = (*fcols, fvalid)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    cand_parts: List[tuple] = []  # (s, p, o, valid) static-cap blocks

    for rule in rules:
        # ground-guard gate: a whole-rule membership test against the fact
        # snapshot (non-derivable by the lowering gate, so its value is
        # constant through the closure)
        guard_ok = None
        for g in rule.guards:
            _t, gm = _scan_premise(g, fcols, fvalid)
            hit = gm.any()
            guard_ok = hit if guard_ok is None else (guard_ok & hit)
        for order, keys in rule.plans:
            seed = order[0]
            table, m = _scan_premise(rule.premises[seed], dcols, dvalid)
            valid = m if guard_ok is None else (m & guard_ok)
            for step, j in enumerate(order[1:]):
                ptable, pm = _scan_premise(rule.premises[j], fcols, fvalid)
                kv = keys[step]
                if len(kv) > 2:
                    lkey, rkey = pack_key_multi(
                        [table[v] for v in kv], [ptable[v] for v in kv], valid, pm
                    )
                else:
                    lkey = _pack([table[v] for v in kv], valid, _LPAD)
                    rkey = _pack([ptable[v] for v in kv], pm, _RPAD)
                li, ri, jvalid, total = ranked_merge_join_indices(lkey, rkey, J)
                overflow = overflow | (total > J).to(torch.int64)
                new_table = {v: c[li] for v, c in table.items()}
                for v, c in ptable.items():
                    if v not in new_table:
                        new_table[v] = c[ri]
                table, valid = new_table, jvalid
            valid = _eval_filters(rule, table, valid, masks)
            valid = _eval_negs(rule, table, valid, facts)
            n = valid.shape[0]
            for concl in rule.concls:
                out = [
                    table[v] if kind == "var"
                    else torch.full((n,), v, dtype=torch.int64, device=dev)
                    for kind, v in concl
                ]
                cand_parts.append((out[0], out[1], out[2], valid))

    cs = torch.cat([p[0] for p in cand_parts])
    cp = torch.cat([p[1] for p in cand_parts])
    co = torch.cat([p[2] for p in cand_parts])
    cv = torch.cat([p[3] for p in cand_parts])
    return cs, cp, co, cv, overflow


def _fixpoint_round(rules, caps: _Caps, fcols, n_facts: int, dcols, dvalid, masks):
    """One semi-naive round (the reference's ``round_body``) over the facts
    ``fcols[:n_facts]`` and the delta ``dcols`` (rows where ``dvalid``).
    Queues the round's device work and reads ONE host scalar pair: returns
    ``(n_uniq, code, (us, up, uo), uvalid)`` — the new distinct facts
    (sorted, compacted, up to ``caps.delta``), their exact count and the
    overflow bitmask.  Nothing is written: the caller commits on code 0."""
    F, D, J = caps.fact, caps.delta, caps.join
    fvalid = torch.arange(F, device=dvalid.device) < n_facts
    cs, cp, co, cv, overflow = _gen_candidates(
        rules, fcols, fvalid, dcols, dvalid, masks, J
    )
    # dedup + subtract known facts (fused membership: rank (s,p), pack o)
    known = _row_membership(
        [torch.where(cv, c, _KNOWN_PAD) for c in (cs, cp, co)],
        [torch.where(fvalid, c, _FACT_PAD) for c in fcols],
    )
    cv = cv & ~known
    ucols, uvalid, n_uniq = _sort_unique3((cs, cp, co), cv, D)
    overflow = overflow | (n_uniq > D).to(torch.int64) << 1
    overflow = overflow | (n_facts + n_uniq.clamp(max=D) > F).to(torch.int64) << 2
    n_uniq_h, code = torch.stack([n_uniq, overflow]).tolist()  # the one sync
    return n_uniq_h, code, ucols, uvalid


def _device_fixpoint(rules: tuple, caps: _Caps, fs, fp, fo, n_facts: int, masks):
    """Run semi-naive rounds to fixpoint (or capacity overflow).

    ``fs/fp/fo`` are int64 device columns padded to ``caps.fact`` and owned
    by this call: committed rounds append to them IN PLACE (the port's
    counterpart of the reference's functional ``.at[].set``, without a
    second F-row buffer).  Returns ``(fs, fp, fo, n_facts, rounds, code)``
    with host ints for the last three: ``code`` 0 on success, else the
    overflow bitmask of the round that did not commit (the columns then
    hold the state before it)."""
    F, D = caps.fact, caps.delta
    dev = fs.device
    # round 0: delta = all facts
    if D <= F:
        dcols = (fs[:D].clone(), fp[:D].clone(), fo[:D].clone())
    else:
        dcols = tuple(
            torch.cat([c, torch.zeros(D - F, dtype=torch.int64, device=dev)])
            for c in (fs, fp, fo)
        )
    dvalid = torch.arange(D, device=dev) < min(n_facts, D)
    code = 2 if n_facts > D else 0  # bit1: the delta cannot hold all facts
    n_new = min(n_facts, 1)
    rounds = 0
    while n_new > 0 and code == 0 and rounds < ROUND_LIMIT:
        n_uniq, code, ucols, uvalid = _fixpoint_round(
            rules, caps, (fs, fp, fo), n_facts, dcols, dvalid, masks
        )
        if code:
            break
        n_new = min(n_uniq, D)
        for col, new in zip((fs, fp, fo), ucols):
            col[n_facts : n_facts + n_new] = new[:n_new]
        n_facts += n_new
        dcols, dvalid = ucols, uvalid
        rounds += 1
    if rounds >= ROUND_LIMIT and n_new > 0:
        # an incomplete closure must never be reported as success
        code |= 8
    return fs, fp, fo, n_facts, rounds, code


def _device_round_chunk(
    rules: tuple,
    caps: _Caps,
    fs,
    fp,
    fo,
    n_facts: int,
    ds,
    dp,
    do,
    n_delta: int,
    accs,
    accp,
    acco,
    n_acc,
    masks,
):
    """One delta CHUNK of one semi-naive round.

    The facts are FROZEN for the whole round — NAF and known-fact
    subtraction see the same snapshot in every chunk, so K chunks produce
    exactly the round :func:`_fixpoint_round` would.  New facts accumulate
    (deduplicated) in the ``acc*`` buffers, which hold ``caps.delta`` rows
    plus one spare slot that takes the rows a chunk drops; the host loop
    merges the accumulator into the fact columns at round end and feeds it
    back as the next round's delta.  ``n_acc`` and the returned overflow
    code are 0-dim device tensors, so chunks chain without a host sync.
    Returns ``(accs, accp, acco, n_acc, overflow)``, the accumulator updated
    IN PLACE; an overflowing chunk does NOT commit (bit0 join cap, bit1
    accumulator cap), so the caller can double the failing capacity and
    re-run the round."""
    F, D, J = caps.fact, caps.delta, caps.join
    dev = fs.device
    fvalid = torch.arange(F, device=dev) < n_facts
    dvalid = torch.arange(ds.shape[0], device=dev) < n_delta

    cs, cp, co, cv, overflow = _gen_candidates(
        rules, (fs, fp, fo), fvalid, (ds, dp, do), dvalid, masks, J
    )
    # subtract known facts AND rows already accumulated by earlier chunks
    ours = [torch.where(cv, c, _KNOWN_PAD) for c in (cs, cp, co)]
    known = _row_membership(
        ours, [torch.where(fvalid, c, _FACT_PAD) for c in (fs, fp, fo)]
    )
    accv = torch.arange(D + 1, device=dev) < n_acc
    in_acc = _row_membership(
        ours, [torch.where(accv, c, _FACT_PAD) for c in (accs, accp, acco)]
    )
    cv = cv & ~known & ~in_acc

    (us, up, uo), uvalid, n_uniq = _sort_unique3((cs, cp, co), cv, D)
    n_u = n_uniq.clamp(max=D)
    overflow = overflow | ((n_uniq > D) | (n_acc + n_u > D)).to(torch.int64) << 1
    ok = overflow == 0
    dest = torch.where(uvalid & ok, n_acc + torch.cumsum(uvalid, 0) - 1, D)
    for acc, new in zip((accs, accp, acco), (us, up, uo)):
        acc.index_put_((dest,), new)  # slot D takes the dropped rows
    return accs, accp, acco, torch.where(ok, n_acc + n_u, n_acc), overflow


# ---------------------------------------------------------------------------
# Host side
# ---------------------------------------------------------------------------


def _u32_tensor(x, device) -> torch.Tensor:
    """int64 carrier tensor of a u32 numpy column, on ``device``."""
    return torch.from_numpy(np.asarray(x, dtype=np.uint32).astype(np.int64)).to(device)


def _to_host_u32(col: torch.Tensor) -> np.ndarray:
    return col.cpu().numpy().astype(np.uint32)


class DeviceFixpoint:
    """Host side: lowers the reasoner's rules, sizes capacities, runs the
    device fixpoint with overflow-driven capacity doubling, and writes
    derived facts back into ``reasoner.facts``.  Runs on
    ``reasoner.device``."""

    def __init__(self, reasoner):
        self.reasoner = reasoner
        self.device: torch.device = reasoner.device
        self.rules, self.bank = lower_rules(reasoner, reasoner.rules)
        # rounds taken by the most recent successful run
        self.last_rounds = 0

    def _caps(self, n_facts: int):
        return _Caps(
            fact=_round_cap(8 * n_facts, 2048),
            delta=_round_cap(max(2 * n_facts, 1024)),
            join=_round_cap(4 * n_facts, 1024),
        )

    def _masks(self) -> tuple:
        return tuple(
            torch.from_numpy(m).to(self.device) for m in self.bank.materialize()
        ) or (torch.zeros(1, dtype=torch.bool, device=self.device),)

    def _padded(self, x: torch.Tensor, cap: int) -> torch.Tensor:
        """A fresh int64 column of ``cap`` rows: ``x`` then zeros (longer
        columns are cut: only invalid padding drops)."""
        x = x.to(device=self.device, dtype=torch.int64)
        if x.shape[0] >= cap:
            return x[:cap].clone()
        return torch.cat([x, torch.zeros(cap - x.shape[0], dtype=torch.int64, device=self.device)])

    def run_raw(self):
        """One fixpoint run over the reasoner's facts at the default
        capacities, without the capacity retry and without touching
        ``reasoner.facts``: returns ``(fs, fp, fo, n_facts, rounds, code)``,
        the padded device columns and host ints; the caller must check
        ``code == 0``."""
        s, p, o = self.reasoner.facts.columns()
        n0 = len(s)
        caps = self._caps(n0)
        cols = [_u32_tensor(c, self.device) for c in (s, p, o)]
        if not self.rules:
            return (*cols, n0, 0, 0)
        fs, fp, fo = (self._padded(c, caps.fact) for c in cols)
        return _device_fixpoint(self.rules, caps, fs, fp, fo, n0, self._masks())

    def infer_padded(self, fs, fp, fo, n_facts: int, caps: _Caps):
        """Capacity-retry fixpoint over device-resident fact columns.

        ``fs/fp/fo`` are int64 device columns holding ``n_facts`` valid rows
        (any padding beyond is ignored; they are not modified).  Returns
        ``(ofs, ofp, ofo, n_out, caps)`` — the padded output columns (input
        rows first, derived appended), the fact count, and the converged
        capacities — WITHOUT touching ``reasoner.facts``."""
        n_facts = int(n_facts)
        if not self.rules:
            return fs, fp, fo, n_facts, caps
        masks = self._masks()
        for _attempt in range(MAX_ATTEMPTS):
            fs, fp, fo = (self._padded(c, caps.fact) for c in (fs, fp, fo))
            ofs, ofp, ofo, on, rounds, code = _device_fixpoint(
                self.rules, caps, fs, fp, fo, n_facts, masks
            )
            if code == 0:
                self.last_rounds = rounds
                return ofs, ofp, ofo, on, caps
            if code & 8:
                raise RuntimeError(
                    "device fixpoint hit the round limit before convergence"
                )
            # preserve progress: restart from the (committed) returned state,
            # doubling every capacity that overflowed (code is a bitmask)
            fs, fp, fo, n_facts = ofs, ofp, ofo, on
            caps = _Caps(
                caps.fact * (2 if code & 4 else 1),
                caps.delta * (2 if code & 2 else 1),
                caps.join * (2 if code & 1 else 1),
            )
        raise RuntimeError("device fixpoint capacities failed to converge")

    def infer(self) -> int:
        r = self.reasoner
        s, p, o = r.facts.columns()
        n0 = len(s)
        if n0 == 0 or not self.rules:
            # every rule was statically dead (unsatisfiable ground guards)
            return 0
        ofs, ofp, ofo, n_out, caps = self.infer_padded(
            *(_u32_tensor(c, self.device) for c in (s, p, o)), n0, self._caps(n0)
        )
        self.converged_caps = caps
        self._last_state = (ofs, ofp, ofo, n_out, n0)
        return self.materialize_to_host()

    def infer_chunked(
        self,
        chunk_rows: Optional[int] = None,
        join_cap: Optional[int] = None,
        delta_cap: Optional[int] = None,
    ) -> int:
        """Host-driven per-round fixpoint over delta CHUNKS.

        Each round runs :func:`_device_round_chunk` per ``chunk_rows``-row
        slice of the delta, with the fact columns frozen for the round; the
        host merges the round's accumulator into the facts and feeds it
        back as the next delta.  One host sync per round attempt.  Bounds
        every join buffer by the chunk rather than by the whole delta."""
        r = self.reasoner
        s, p, o = r.facts.columns()
        n0 = len(s)
        if n0 == 0 or not self.rules:
            return 0
        dev = self.device
        masks = self._masks()
        # all powers of two (user values rounded up), so chunk offsets stay
        # aligned across buffers
        Dc = _round_cap(chunk_rows, 8) if chunk_rows else min(_round_cap(n0, 1024), 1 << 19)
        J = join_cap or _round_cap(4 * max(Dc, 1024), 1024)
        D = _round_cap(max(delta_cap, Dc) if delta_cap else max(2 * Dc, 2048), Dc)
        F = _round_cap(n0 + D, 2048)
        attempts = 0

        cols = [_u32_tensor(c, dev) for c in (s, p, o)]
        fs, fp, fo = (self._padded(c, F) for c in cols)
        n_facts = n0
        # round-0 delta = all facts, in a chunk-aligned buffer
        dels, delp, delo = (self._padded(c, _round_cap(n0, Dc)) for c in cols)
        n_delta = n0

        for _round in range(ROUND_LIMIT):
            while True:
                # accumulator: D rows + the spare slot of dropped rows
                accs, accp, acco = (
                    torch.zeros(D + 1, dtype=torch.int64, device=dev) for _ in range(3)
                )
                n_acc_dev = torch.zeros((), dtype=torch.int64, device=dev)
                code_dev = torch.zeros((), dtype=torch.int64, device=dev)
                for off in range(0, n_delta, Dc):
                    m = min(Dc, n_delta - off)
                    accs, accp, acco, n_acc_dev, ovf = _device_round_chunk(
                        self.rules,
                        _Caps(F, D, J),
                        fs,
                        fp,
                        fo,
                        n_facts,
                        dels[off : off + Dc],
                        delp[off : off + Dc],
                        delo[off : off + Dc],
                        m,
                        accs,
                        accp,
                        acco,
                        n_acc_dev,
                        masks,
                    )
                    code_dev = code_dev | ovf
                code, n_acc = torch.stack([code_dev, n_acc_dev]).tolist()  # the one sync
                if code == 0:
                    break
                # overflow: retry the WHOLE round (facts are frozen per
                # round, so a round restart is exact) with the failing
                # capacities doubled
                attempts += 1
                if attempts > MAX_CHUNKED_ATTEMPTS:
                    raise RuntimeError(
                        "chunked device fixpoint: capacities failed to converge"
                    )
                if code & 1:
                    J *= 2
                if code & 2:
                    D *= 2
            if n_acc == 0:
                break
            # merge the round's accumulator into the fact columns
            if n_facts + D > F:
                newF = _round_cap(n_facts + D, 2048)
                fs, fp, fo = (self._padded(c, newF) for c in (fs, fp, fo))
                F = newF
            for col, acc in zip((fs, fp, fo), (accs, accp, acco)):
                col[n_facts : n_facts + n_acc] = acc[:n_acc]
            n_facts += n_acc
            # next round's delta = this round's accumulator (D is a power
            # of two >= Dc, so it stays chunk-aligned)
            dels, delp, delo, n_delta = accs[:D], accp[:D], acco[:D], n_acc
        else:
            raise RuntimeError("device fixpoint hit the round limit before convergence")

        self.last_rounds = _round  # productive rounds (final is empty)
        self.converged_caps = _Caps(F, D, J)
        self._last_state = (fs, fp, fo, n_facts, n0)
        return self.materialize_to_host()

    def materialize_to_host(self) -> int:
        """Copy the facts derived by the last run into ``reasoner.facts``;
        returns the derived count."""
        fs, fp, fo, n_facts, n0 = self._last_state
        if n_facts > n0:
            self.reasoner.facts.add_batch(
                *(_to_host_u32(c[n0:n_facts]) for c in (fs, fp, fo))
            )
        return n_facts - n0


def infer_semi_naive_device(reasoner) -> Optional[int]:
    """Device fixpoint if the rule set lowers; ``None`` → host fallback.
    Only :class:`Unsupported` from the lowering routes to the host: a
    kernel or CUDA error propagates."""
    try:
        fx = DeviceFixpoint(reasoner)
    except Unsupported:
        return None
    return fx.infer()
