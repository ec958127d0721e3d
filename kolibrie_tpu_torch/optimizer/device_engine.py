"""Device execution of physical plans on PyTorch tensors.

Port of ``kolibrie_tpu/optimizer/device_engine.py`` for SPARQL SELECT.  A
physical plan from :mod:`kolibrie_tpu_torch.optimizer.planner` is lowered
to a tree of frozen spec nodes and evaluated by :func:`_plan_body` over the
store's device-resident sorted orders
(:meth:`ColumnarTripleStore.device_segment`):

- scans are windows over the frozen base order (tombstones masked) merged
  by rank with a window over the small delta order; a quoted pattern with
  inner variables scans its position as a synthetic qid column and expands
  it against the device copy of the quoted table (a searchsorted gather);
- VALUES rows are uploaded as columns;
- joins are the merge-path kernel — :func:`merge_join_indices` when the
  right side's scan order presents the single key column sorted,
  :func:`ranked_merge_join_indices` (dense-rank prepass) otherwise;
- FILTERs are per-ID mask gathers, ID compares and numeric compares;
- cyclic BGPs run the worst-case-optimal join node, one variable per
  level, with the ``lex_probe_select``/``lex_probe_validate`` kernels;
- UNION / OPTIONAL / MINUS / NOT clauses compose over the main tree in the
  executor's post-pass order: union concatenation joined in, left-outer
  joins (the merge-path kernel for the matches), anti-joins.

After the plan, :func:`try_device_execute_aggregated` segment-reduces the
table by its GROUP BY keys and :func:`try_device_execute_ordered` takes
the ORDER BY top-k, so the host reads one row per group or ``k`` rows.

The reference compiles the tree into one XLA program; here it runs eagerly,
one PyTorch op (or kernel) at a time.  What stays the same is the
capacity protocol: every join and WCOJ level runs at a capacity, reports
its exact match count, and :meth:`LoweredPlan.converge` re-runs with
doubled capacities until every count fits — so counts, capacities and the
per-operator stats keys (``scan{i}``, ``join{i}``, ``filter{i}``,
``wcoj{i}:cand/:dedup/:live``, ``union{i}``, ``optional{j}``, ``anti{i}``,
``values{i}``, ``quoted{i}``) agree with the reference one for one.

Shapes the device engine does not lower (cartesian joins, non-constant
string patterns, UDFs, doubly-nested quoted patterns) raise
:class:`Unsupported` from :func:`lower_plan`; the executor then runs the
plan on the host engine (``optimizer/engine.py``), whose scans read the
same two-tier mirror through :func:`scan_rows`.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kolibrie_tpu_torch.backend import SENT, _LPAD, _RPAD, key1, pack2
from kolibrie_tpu_torch.core.dictionary import QUOTED_BIT
from kolibrie_tpu_torch.core.store import ColumnarTripleStore
from kolibrie_tpu_torch.ops import round_cap as _round_cap
from kolibrie_tpu_torch.ops.device_join import pack_key_multi
from kolibrie_tpu_torch.ops.join import UNBOUND, BindingTable
from kolibrie_tpu_torch.ops.kernels import (
    lex_probe_select,
    lex_probe_validate,
    merge_join_indices,
    ranked_merge_join_indices,
)
from kolibrie_tpu_torch.ops.wcoj import lex_range
from kolibrie_tpu_torch.optimizer import plan as P
from kolibrie_tpu_torch.optimizer.engine import strip_literal
from kolibrie_tpu_torch.query.ast import (
    Comparison,
    FunctionCall,
    IriRef,
    LogicalAnd,
    LogicalNot,
    LogicalOr,
    NumberLit,
    PatternTriple,
    StringLit,
    Var,
)

__all__ = [
    "Unsupported",
    "LoweredPlan",
    "lower_plan",
    "try_device_execute_aggregated",
    "try_device_execute_ordered",
    "aggregate_table",
    "host_quoted_table",
    "device_quoted",
    "device_string_ranks",
    "template_scan_cap",
    "scan_range",
    "scan_rows",
    "string_filter_mask",
    "numeric_filter_mask",
]


def _pad_pow2(arr: np.ndarray, fill, lo: int = 128) -> np.ndarray:
    """Pad a 1-D per-ID table to a power-of-two length with a neutral fill."""
    cap = _round_cap(len(arr), lo)
    if cap == len(arr):
        return arr
    out = np.full(cap, fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


class Unsupported(Exception):
    """Plan construct this slice of the device engine cannot express."""


# ---------------------------------------------------------------------------
# Frozen spec nodes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScanSpec:
    order_idx: int  # into PlanSpec.orders
    scan_idx: int  # into the (n_scans, 4) [lo_b, n_b, lo_d, n_d] scalars
    out_vars: tuple  # ((var, pos), ...) pos: 0=s 1=p 2=o canonical
    eq_pairs: tuple  # ((pos_a, pos_b), ...) repeated-variable constraints
    cap: int
    # canonical positions of the two order columns packed as the base/delta
    # merge key — the first unbound perm column (and its successor), so the
    # merged stream stays sorted exactly where the rsorted joins require it
    key_pos: tuple = (0, 1)


@dataclass(frozen=True)
class QuotedExpandSpec:
    """Expand a column of quoted-triple IDs against the device-resident
    quoted table (qid-sorted): bind inner variables, enforce inner
    constants and repeats / collisions with already-bound variables.  Each
    qid names exactly one quoted row, so the expansion is a searchsorted
    gather, not a join."""

    child: object
    qvar: str  # synthetic column of qids produced by the scan
    out_vars: tuple  # ((var, inner_pos 0..2), ...) fresh inner bindings
    const_checks: tuple  # ((inner_pos, param_idx), ...)
    eq_checks: tuple  # ((inner_pos, bound_var), ...) incl. repeats


@dataclass(frozen=True)
class ValuesSpec:
    values_idx: int
    vars: tuple
    n: int


@dataclass(frozen=True)
class JoinSpec:
    left: object
    right: object
    key_vars: tuple  # shared variable names
    join_idx: int  # into the capacity table / counts output
    cap: int
    rsorted: bool = False  # right key column pre-sorted by its scan order


@dataclass(frozen=True)
class UnionSpec:
    """UNION group: concatenation of branch tables over the union of their
    variables, a branch's missing columns filled with UNBOUND (0).
    Capacity = sum of the branch capacities."""

    children: tuple
    vars: tuple


@dataclass(frozen=True)
class LeftOuterSpec:
    """OPTIONAL: matches of left ⋈ right plus the unmatched left rows with
    UNBOUND right-only columns.  Carries a join capacity for the matches;
    output capacity = join cap + left capacity."""

    left: object
    right: object
    key_vars: tuple
    join_idx: int
    cap: int


@dataclass(frozen=True)
class AntiJoinSpec:
    """MINUS / NOT: keep the ``left`` rows with NO ``right`` match on the
    shared variables.  Output columns and capacity are the left child's."""

    left: object
    right: object
    key_vars: tuple


@dataclass(frozen=True)
class WcojAccessor:
    """One pattern's sorted-order view at a WCOJ level: the order whose
    perm prefix is exactly the pattern's bound positions followed by the
    level variable.  ``key_srcs`` supply the bound-prefix key values in
    PERM order — ``('u', param_idx)`` a query constant, ``('v', var)`` an
    already-eliminated variable's column."""

    order_idx: int
    key_srcs: tuple
    key_pos: tuple
    val_pos: int


@dataclass(frozen=True)
class WcojLevel:
    """Eliminate one variable: candidates from the accessor with the
    smallest raw range count, deduplicated to first-of-run, validated by
    live-existence probes against every accessor."""

    var: str
    join_idx: int
    cap: int
    accessors: tuple


@dataclass(frozen=True)
class WcojSpec:
    """Worst-case-optimal multiway join over a whole basic graph pattern:
    one :class:`WcojLevel` per variable, in elimination order."""

    levels: tuple


@dataclass(frozen=True)
class FilterSpec:
    child: object
    expr: object


@dataclass(frozen=True)
class MaskRef:
    """Per-ID boolean mask gather (host-precomputed filter verdicts)."""

    mask_idx: int
    var: str


@dataclass(frozen=True)
class StrMaskRef:
    """String-predicate verdict gathers (REGEX/CONTAINS/STRSTARTS/STRENDS
    against a constant pattern): dictionary IDs read one mask, quoted IDs
    (bit 31) a second one built over the quoted store."""

    dict_idx: int
    quoted_idx: int
    var: str


@dataclass(frozen=True)
class QuotedCheck:
    """ISTRIPLE(?v): bit-31 test on the ID column."""

    var: str


@dataclass(frozen=True)
class IdCmp:
    """ID equality against the query constant ``u_params[param_idx]``."""

    op: str  # '=' | '!='
    var: str
    param_idx: int


@dataclass(frozen=True)
class NumConstCmp:
    """Numeric compare of a variable's value against ``f_params[param_idx]``
    (NaN = non-numeric, always excluded)."""

    op: str
    var: str
    param_idx: int


@dataclass(frozen=True)
class NumCmp:
    """Numeric compare between two variables' values (f64 gather)."""

    op: str
    lvar: str
    rvar: str


@dataclass(frozen=True)
class BoolNode:
    kind: str  # 'and' | 'or' | 'not'
    args: tuple


@dataclass(frozen=True)
class PlanSpec:
    root: object
    out_vars: tuple
    orders: tuple  # order names aligned with the order_arrays input


# ---------------------------------------------------------------------------
# Plan evaluation
# ---------------------------------------------------------------------------


def _cmp(op: str, a, b):
    if op == "=":
        return a == b
    if op == "!=":
        return a != b
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    return a >= b


def _pack_key(cols: List[torch.Tensor], valid, pad_sentinel: int):
    """Key carrier of one or two u32 columns, padding invalid rows."""
    key = key1(cols[0]) if len(cols) == 1 else pack2(cols[0], cols[1])
    return torch.where(valid, key, pad_sentinel)


def _drop_scatter(cap: int, dst_b, vb, dst_d, vd, device):
    """``zeros(cap).at[dst_b].set(vb).at[dst_d].set(vd)`` with
    out-of-range destinations dropped (slot ``cap`` is the sink)."""
    out = torch.zeros(cap + 1, dtype=torch.int64, device=device)
    out[dst_b] = vb
    out[dst_d] = vd
    return out[:cap]


def _join_keys(lcols, rcols, key_vars, lvalid, rvalid):
    """Comparable key carriers of both sides of a join on ``key_vars``,
    invalid rows padded (distinct pads on each side never match)."""
    lc = [lcols[v] for v in key_vars]
    rc = [rcols[v] for v in key_vars]
    if len(key_vars) > 2:
        # 3+ shared variables: union dense-rank composition
        return pack_key_multi(lc, rc, lvalid, rvalid)
    return _pack_key(lc, lvalid, _LPAD), _pack_key(rc, rvalid, _RPAD)


def _unmatched(lkey, rkey):
    """Left rows whose key has no equal among the right keys."""
    rs = torch.sort(rkey).values
    pos = torch.searchsorted(rs, lkey).clamp_(0, rs.shape[0] - 1)
    return rs[pos] != lkey


def _map_children(node, fn):
    """``node`` with ``fn`` applied to each of its child spec nodes."""
    if isinstance(node, (JoinSpec, LeftOuterSpec, AntiJoinSpec)):
        return replace(node, left=fn(node.left), right=fn(node.right))
    if isinstance(node, (FilterSpec, QuotedExpandSpec)):
        return replace(node, child=fn(node.child))
    if isinstance(node, UnionSpec):
        return replace(node, children=tuple(fn(c) for c in node.children))
    return node


def _plan_body(
    spec: PlanSpec, order_arrays, scalars, masks, values, numf, quoted, uparams, fparams
):
    """Evaluate the spec tree.  Returns ``(out_cols, valid, counts,
    stats)``: device tensors of length = the root's capacity, the exact
    per-join / per-WCOJ-level match counts (0-dim tensors, indexed by
    ``join_idx`` order of evaluation) and the per-operator row counts."""
    counts: List[torch.Tensor] = []
    # EXPLAIN ANALYZE operator stats: key -> device scalar.  Indexed nodes
    # use their plan index (scan3, join0, optional1, values0,
    # wcoj2:cand/:dedup/:live); index-less nodes (filter, anti, union,
    # quoted) use a PRE-ORDER occurrence counter assigned at node entry.
    stats: Dict[str, torch.Tensor] = {}
    seq = {"filter": 0, "anti": 0, "union": 0, "quoted": 0}

    def gather_num(ids):
        return numf[ids.clamp(max=numf.shape[0] - 1)]

    def eval_expr(expr, cols):
        if isinstance(expr, MaskRef):
            m = masks[expr.mask_idx]
            return m[cols[expr.var].clamp(max=m.shape[0] - 1)]
        if isinstance(expr, StrMaskRef):
            ids = cols[expr.var]
            dm = masks[expr.dict_idx]
            qm = masks[expr.quoted_idx]
            isq = (ids & QUOTED_BIT) != 0
            dv = dm[ids.clamp(max=dm.shape[0] - 1)]
            qidx = ids & (~QUOTED_BIT & 0xFFFFFFFF)
            qv = qm[qidx.clamp(max=qm.shape[0] - 1)]
            return torch.where(isq, qv, dv)
        if isinstance(expr, QuotedCheck):
            return (cols[expr.var] & QUOTED_BIT) != 0
        if isinstance(expr, IdCmp):
            eq = cols[expr.var] == uparams[expr.param_idx]
            return eq if expr.op == "=" else ~eq
        if isinstance(expr, NumConstCmp):
            vals = gather_num(cols[expr.var])
            res = _cmp(expr.op, vals, fparams[expr.param_idx])
            return res & ~torch.isnan(vals)
        if isinstance(expr, NumCmp):
            a = gather_num(cols[expr.lvar])
            b = gather_num(cols[expr.rvar])
            ok = ~(torch.isnan(a) | torch.isnan(b))
            res = _cmp(expr.op, a, b)
            if expr.op in ("=", "!="):
                idres = _cmp(expr.op, cols[expr.lvar], cols[expr.rvar])
                return torch.where(ok, res, idres)
            return res & ok
        if isinstance(expr, BoolNode):
            if expr.kind == "not":
                return ~eval_expr(expr.args[0], cols)
            m = eval_expr(expr.args[0], cols)
            for a in expr.args[1:]:
                m2 = eval_expr(a, cols)
                m = (m & m2) if expr.kind == "and" else (m | m2)
            return m
        raise TypeError(f"unknown filter spec {expr!r}")

    def eval_scan(node: ScanSpec):
        # Two-segment scan: a window over the FROZEN base order (tombstoned
        # rows masked out) merged with a window over the small delta order.
        # Each live row's output slot is its rank in the two-way merge (base
        # before delta on key ties), which keeps the merge-key column
        # sorted with prefix validity — the contract of the rsorted joins.
        bcols, dcols, del_pos = order_arrays[node.order_idx]
        lo_b, n_b, lo_d, n_d = (int(x) for x in scalars[node.scan_idx])
        cap = node.cap
        dev = del_pos.device
        dcap = del_pos.shape[0]
        ar = torch.arange(cap, dtype=torch.int64, device=dev)
        ard = torch.arange(dcap, dtype=torch.int64, device=dev)
        src_b = (lo_b + ar).clamp_(0, bcols[0].shape[0] - 1)
        src_d = (lo_d + ard).clamp_(0, dcap - 1)
        inb = ar < n_b
        ind = ard < n_d
        # tombstone check: sorted membership of the base ROW POSITION
        jd = torch.searchsorted(del_pos, src_b).clamp_(0, dcap - 1)
        is_del = (del_pos[jd] == src_b) & inb
        bvalid = inb & ~is_del
        k0, k1 = node.key_pos
        # deleted rows KEEP their real key (preserves sortedness and the
        # rank arithmetic); only rows beyond the window go sentinel
        bkey = torch.where(inb, pack2(bcols[k0][src_b], bcols[k1][src_b]), _RPAD)
        dkey = torch.where(ind, pack2(dcols[k0][src_d], dcols[k1][src_d]), _RPAD)
        pos_b = (torch.cumsum(bvalid, 0) - 1) + torch.searchsorted(dkey, bkey)
        cdel = torch.cat(
            [torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(is_del, 0)]
        )
        ib = torch.searchsorted(bkey, dkey, right=True)
        pos_d = ard + ib - cdel[ib]
        n_live = (n_b - cdel[-1]) + n_d
        valid = ar < n_live
        dst_b = torch.where(bvalid & (pos_b < cap), pos_b, cap)
        dst_d = torch.where(ind & (pos_d < cap), pos_d, cap)
        need = {pos for _, pos in node.out_vars}
        for a, b in node.eq_pairs:
            need.update((a, b))
        raw = {
            pos: _drop_scatter(
                cap, dst_b, bcols[pos][src_b], dst_d, dcols[pos][src_d], dev
            )
            for pos in need
        }
        for a, b in node.eq_pairs:
            valid = valid & (raw[a] == raw[b])
        cols = {var: raw[pos] for var, pos in node.out_vars}
        n = valid.sum()
        stats[f"scan{node.scan_idx}"] = n
        return cols, valid, n

    def eval_join(node: JoinSpec):
        lcols, lvalid, _ = eval_node(node.left)
        rcols, rvalid, _ = eval_node(node.right)
        if node.rsorted:
            # right child is a bare range scan whose order presents the
            # single key column sorted with prefix validity
            kv = node.key_vars[0]
            li, ri, valid, total = merge_join_indices(
                lcols[kv], rcols[kv], node.cap, lvalid, rvalid
            )
            # outputs are padded to whole tiles; matches are a prefix
            li, ri, valid = li[: node.cap], ri[: node.cap], valid[: node.cap]
        else:
            lkey, rkey = _join_keys(lcols, rcols, node.key_vars, lvalid, rvalid)
            li, ri, valid, total = ranked_merge_join_indices(lkey, rkey, node.cap)
        counts.append(total)
        stats[f"join{node.join_idx}"] = valid.sum()
        out = {v: torch.where(valid, c[li], 0) for v, c in lcols.items()}
        for v, c in rcols.items():
            if v not in out:
                out[v] = torch.where(valid, c[ri], 0)
        return out, valid, total

    def eval_quoted(node: QuotedExpandSpec):
        skey = f"quoted{seq['quoted']}"
        seq["quoted"] += 1
        cols, valid, _ = eval_node(node.child)
        cols = dict(cols)
        qid_sorted, qs, qp, qo = quoted
        qcol = cols.pop(node.qvar)
        posc = torch.searchsorted(qid_sorted, qcol).clamp_(0, qid_sorted.shape[0] - 1)
        valid = valid & (qid_sorted[posc] == qcol) & ((qcol & QUOTED_BIT) != 0)
        inner = (qs[posc], qp[posc], qo[posc])
        for ipos, pidx in node.const_checks:
            valid = valid & (inner[ipos] == uparams[pidx])
        for var, ipos in node.out_vars:
            cols[var] = inner[ipos]
        for ipos, var in node.eq_checks:
            valid = valid & (inner[ipos] == cols[var])
        n = valid.sum()
        stats[skey] = n
        return cols, valid, n

    def eval_values(node: ValuesSpec):
        cols = {v: values[node.values_idx][i] for i, v in enumerate(node.vars)}
        valid = torch.ones(node.n, dtype=torch.bool, device=scalars_device)
        n = torch.tensor(node.n, dtype=torch.int64, device=scalars_device)
        stats[f"values{node.values_idx}"] = n
        return cols, valid, n

    def eval_anti(node: AntiJoinSpec):
        skey = f"anti{seq['anti']}"
        seq["anti"] += 1
        lcols, lvalid, _ = eval_node(node.left)
        rcols, rvalid, _ = eval_node(node.right)
        lkey, rkey = _join_keys(lcols, rcols, node.key_vars, lvalid, rvalid)
        valid = lvalid & _unmatched(lkey, rkey)
        n = valid.sum()
        stats[skey] = n
        return lcols, valid, n

    def eval_union(node: UnionSpec):
        skey = f"union{seq['union']}"
        seq["union"] += 1
        parts = [eval_node(ch) for ch in node.children]
        cols = {}
        for v in node.vars:
            cols[v] = torch.cat(
                [
                    ccols[v]
                    if v in ccols
                    # branch doesn't bind v: UNBOUND (0) fill
                    else torch.zeros(cvalid.shape[0], dtype=torch.int64, device=cvalid.device)
                    for ccols, cvalid, _ in parts
                ]
            )
        valid = torch.cat([p[1] for p in parts])
        n = valid.sum()
        stats[skey] = n
        return cols, valid, n

    def eval_left_outer(node: LeftOuterSpec):
        lcols, lvalid, _ = eval_node(node.left)
        rcols, rvalid, _ = eval_node(node.right)
        lkey, rkey = _join_keys(lcols, rcols, node.key_vars, lvalid, rvalid)
        li, ri, mvalid, total = ranked_merge_join_indices(lkey, rkey, node.cap)
        counts.append(total)
        keep = lvalid & _unmatched(lkey, rkey)  # unmatched left rows
        out = {v: torch.cat([torch.where(mvalid, c[li], 0), c]) for v, c in lcols.items()}
        for v, c in rcols.items():
            if v not in out:  # right-only: UNBOUND on the kept side
                out[v] = torch.cat(
                    [torch.where(mvalid, c[ri], 0), c.new_zeros(lvalid.shape[0])]
                )
        valid = torch.cat([mvalid, keep])
        n = valid.sum()
        stats[f"optional{node.join_idx}"] = n
        return out, valid, n

    def eval_filter(node: FilterSpec):
        skey = f"filter{seq['filter']}"
        seq["filter"] += 1
        cols, valid, _ = eval_node(node.child)
        valid = valid & eval_expr(node.expr, cols)
        n = valid.sum()
        stats[skey] = n
        return cols, valid, n

    def eval_wcoj(node: WcojSpec):
        # Variable-at-a-time leapfrog over the two-tier sorted orders.
        # Counts are RAW range sizes (tombstoned/duplicate rows included):
        # a sound capacity bound.  Liveness and dedup ride per-slot probes:
        #   valid = in_range & real & first_of_run(chosen segment)
        #         & AND_r(live_exists_r) & (base_slot | no_base_raw)
        # where the last term keeps a value enumerated from the chosen
        # accessor's delta from double-counting when its base also has raw
        # (possibly all-tombstoned) copies.
        dev = scalars_device
        wcols: Dict[str, torch.Tensor] = {}
        wvalid = torch.ones(1, dtype=torch.bool, device=dev)
        for lv in node.levels:
            pcap = wvalid.shape[0]
            segs = [order_arrays[a.order_idx] for a in lv.accessors]
            probes = []
            for a, (bcols, dcols, _dp) in zip(lv.accessors, segs):
                keys = []
                sent = torch.zeros(pcap, dtype=torch.bool, device=dev)
                for src in a.key_srcs:
                    if src[0] == "u":
                        k = torch.full((pcap,), uparams[src[1]], dtype=torch.int64, device=dev)
                    else:
                        k = wcols[src[1]]
                    sent = sent | (k == SENT)
                    keys.append(k)
                if keys:
                    bl, bh = lex_range(tuple(bcols[p] for p in a.key_pos), keys)
                    dl, dh = lex_range(tuple(dcols[p] for p in a.key_pos), keys)
                else:
                    # unbound accessor: the whole live prefix (padding is
                    # all-sentinel and sorts last)
                    bl = torch.zeros(pcap, dtype=torch.int64, device=dev)
                    dl = torch.zeros(pcap, dtype=torch.int64, device=dev)
                    sent_t = torch.tensor([SENT], dtype=torch.int64, device=dev)
                    bh = torch.searchsorted(bcols[a.val_pos], sent_t).expand(pcap)
                    dh = torch.searchsorted(dcols[a.val_pos], sent_t).expand(pcap)
                probes.append((keys, sent, bl, bh, dl, dh))
            cntm = torch.stack(
                [
                    torch.where(sent, 0, (bh - bl) + (dh - dl))
                    for (_k, sent, bl, bh, dl, dh) in probes
                ]
            )
            mins, choice = torch.min(cntm, 0)
            cnt = torch.where(wvalid, mins, 0)
            total = cnt.sum()
            counts.append(total)
            stats[f"wcoj{lv.join_idx}:cand"] = total
            cap = lv.cap
            cum = torch.cumsum(cnt, 0)
            slot = torch.arange(cap, dtype=torch.int64, device=dev)
            row_c = torch.searchsorted(cum, slot, right=True).clamp_(0, pcap - 1)
            kk = slot - (cum[row_c] - cnt[row_c])
            in_range = slot < total
            ch = choice[row_c]
            sel = []
            for a, (bcols, dcols, _dp), (_k, _s, bl, bh, dl, _dh) in zip(
                lv.accessors, segs, probes
            ):
                bv, dv = bcols[a.val_pos], dcols[a.val_pos]
                nb = bh[row_c] - bl[row_c]
                bidx = (bl[row_c] + kk).clamp_(0, bv.shape[0] - 1)
                didx = (dl[row_c] + (kk - nb)).clamp_(0, dv.shape[0] - 1)
                bprev = bv[(bidx - 1).clamp(0, bv.shape[0] - 1)]
                dprev = dv[(didx - 1).clamp(0, dv.shape[0] - 1)]
                sel.append((nb, bv[bidx], dv[didx], bprev, dprev))
            val, new_valid, is_base = lex_probe_select(kk, ch, in_range, sel)
            # dedup count: distinct candidate values BEFORE the liveness /
            # base-representative probes
            stats[f"wcoj{lv.join_idx}:dedup"] = new_valid.sum()
            ex = []
            for a, (bcols, dcols, del_pos), (keys, sent, *_r) in zip(
                lv.accessors, segs, probes
            ):
                fkeys = [k[row_c] for k in keys] + [val]
                bsf = tuple(bcols[p] for p in a.key_pos) + (bcols[a.val_pos],)
                dsf = tuple(dcols[p] for p in a.key_pos) + (dcols[a.val_pos],)
                fl, fh = lex_range(bsf, fkeys)
                dl2, dh2 = lex_range(dsf, fkeys)
                # tombstoned copies inside [fl, fh): del_pos holds sorted
                # base-row positions (sentinel-padded)
                tl = torch.searchsorted(del_pos, fl)
                th = torch.searchsorted(del_pos, fh)
                ex.append((fl, fh, tl, th, dl2, dh2, sent[row_c]))
            new_valid = lex_probe_validate(new_valid, is_base, ch, ex)
            stats[f"wcoj{lv.join_idx}:live"] = new_valid.sum()
            wcols = {
                v: torch.where(new_valid, c[row_c], 0) for v, c in wcols.items()
            }
            wcols[lv.var] = torch.where(new_valid, val, 0)
            wvalid = new_valid
        return wcols, wvalid, wvalid.sum()

    evaluators = {
        ScanSpec: eval_scan,
        QuotedExpandSpec: eval_quoted,
        ValuesSpec: eval_values,
        JoinSpec: eval_join,
        FilterSpec: eval_filter,
        AntiJoinSpec: eval_anti,
        UnionSpec: eval_union,
        LeftOuterSpec: eval_left_outer,
        WcojSpec: eval_wcoj,
    }

    def eval_node(node):
        fn = evaluators.get(type(node))
        if fn is None:
            raise TypeError(f"unknown plan spec node {node!r}")
        return fn(node)

    scalars_device = numf.device
    cols, valid, _ = eval_node(spec.root)
    out = tuple(cols[v] for v in spec.out_vars)
    return out, valid, tuple(counts), stats


# ---------------------------------------------------------------------------
# Lowering: physical plan -> spec tree (+ host-side prep)
# ---------------------------------------------------------------------------


class LoweredPlan:
    """A physical plan lowered for device execution.

    Holds the spec tree plus the host-side preparation products (scan range
    descriptors, filter mask arrays, query constants).  ``execute()`` runs
    the tree, validates join capacities against the true match counts, and
    returns a host :data:`BindingTable`."""

    def __init__(self, db, plan, anti_plans=(), union_groups=(), optional_plans=()):
        self.db = db
        self.device = db.device
        self.scan_descs: List[tuple] = []  # (order_name, (cs, cp, co)) per scan
        self.mask_arrays: List[np.ndarray] = []
        self.mask_exprs: List[tuple] = []
        self._mask_keys: Dict[tuple, int] = {}
        self._mask_dict_len: tuple = (0, 0)
        self.values_tables: List[tuple] = []
        self.order_names: List[str] = []
        self._order_idx: Dict[str, int] = {}
        self.join_count = 0
        self.need_numf = False
        self.need_quoted = False
        # query constants: one slot per syntactic constant site, traversal
        # order (the reference's parameter-vector ABI)
        self.u_params: List[int] = []  # u32 term-id constants
        self.f_params: List[float] = []  # f64 numeric comparands
        self.quoted_specs: List[str] = []  # synthetic qid column names
        # fully-constant patterns: hoisted out of the join tree as host
        # membership guards — a failed guard empties the whole result
        self.const_checks: List[tuple] = []
        if plan is None:
            # clause-only group (UNION/OPTIONAL with no main BGP): the
            # first clause becomes the root
            self.root, vars_ = None, set()
        else:
            self.root, vars_ = self._lower(plan)
            if self.root is None:
                raise Unsupported("constant-only query")
        vars_ = self._lower_clauses(vars_, anti_plans, union_groups, optional_plans)
        if self.root is None:
            raise Unsupported("constant-only query")
        # consumers need to know whether the union/optional/minus host
        # post-passes are already inside this program
        self.fused_clauses = bool(anti_plans or union_groups or optional_plans)
        self.out_vars = tuple(sorted(vars_))
        if not self.out_vars:
            raise Unsupported("no output variables")
        self._compact_orders()
        # key for the db-level capacity cache: a TEMPLATE property (spec
        # tree + scan shapes), shared by every constant variant
        self.cap_key = (
            self.root,
            self.out_vars,
            tuple(
                (name, tuple(c is not None for c in consts))
                for name, consts in self.scan_descs
            ),
        )

    def _compact_orders(self) -> None:
        """Drop sort orders no longer referenced after join-driven order
        re-picking (each order is a full device-resident copy)."""
        used: List[int] = []

        def collect(node):
            if isinstance(node, ScanSpec):
                if node.order_idx not in used:
                    used.append(node.order_idx)
            elif isinstance(node, WcojSpec):
                for lv in node.levels:
                    for a in lv.accessors:
                        if a.order_idx not in used:
                            used.append(a.order_idx)
            else:
                _map_children(node, collect)

        collect(self.root)
        remap = {old: new for new, old in enumerate(sorted(used))}
        if len(remap) == len(self.order_names) and all(
            o == n for o, n in remap.items()
        ):
            return
        self.order_names = [self.order_names[o] for o in sorted(used)]
        self._order_idx = {n: i for i, n in enumerate(self.order_names)}

        def rebuild(node):
            if isinstance(node, ScanSpec):
                return replace(node, order_idx=remap[node.order_idx])
            if isinstance(node, WcojSpec):
                return WcojSpec(
                    tuple(
                        replace(
                            lv,
                            accessors=tuple(
                                replace(a, order_idx=remap[a.order_idx])
                                for a in lv.accessors
                            ),
                        )
                        for lv in node.levels
                    )
                )
            return _map_children(node, rebuild)

        self.root = rebuild(self.root)

    # ---------------------------------------------------- clause lowering

    def _lower_branch(self, bplan, kind: str):
        n_checks = len(self.const_checks)
        broot, bvars = self._lower(bplan)
        if len(self.const_checks) != n_checks or broot is None:
            # a branch-local constant guard gates only the BRANCH, not the
            # query; const_ok() can't express that
            raise Unsupported(f"constant pattern in {kind} branch")
        return broot, bvars

    @staticmethod
    def _phys_vars(op) -> set:
        """Variables a physical branch plan WOULD bind: a statically-empty
        UNION branch is dropped from the tree, but the host post-pass still
        synthesizes its variables as UNBOUND-filled columns, so the device
        union carries them too."""
        if isinstance(op, (P.PhysIndexScan, P.PhysTableScan)):
            # variables() recurses into quoted (RDF-star) terms
            return set(op.pattern.variables())
        if isinstance(
            op, (P.PhysHashJoin, P.PhysMergeJoin, P.PhysParallelJoin, P.PhysNestedLoopJoin)
        ):
            return LoweredPlan._phys_vars(op.left) | LoweredPlan._phys_vars(op.right)
        if isinstance(op, (P.PhysStarJoin, P.WcojNode)):
            out: set = set()
            for s in op.scans:
                out |= LoweredPlan._phys_vars(s)
            return out
        if isinstance(op, (P.PhysFilter, P.PhysProjection)):
            return LoweredPlan._phys_vars(op.child)
        if isinstance(op, P.PhysValues):
            return set(op.values.variables)
        return set()

    @staticmethod
    def _statically_empty(op) -> bool:
        """A branch whose plan scans an UNKNOWN constant can never match
        (the term isn't in the dictionary)."""
        if isinstance(op, (P.PhysIndexScan, P.PhysTableScan)):
            pat = op.pattern
            return any(
                t.kind == "id" and t.value is None
                for t in (pat.subject, pat.predicate, pat.object)
            )
        if isinstance(
            op, (P.PhysHashJoin, P.PhysMergeJoin, P.PhysParallelJoin, P.PhysNestedLoopJoin)
        ):
            return LoweredPlan._statically_empty(op.left) or LoweredPlan._statically_empty(
                op.right
            )
        if isinstance(op, (P.PhysStarJoin, P.WcojNode)):
            return any(LoweredPlan._statically_empty(s) for s in op.scans)
        if isinstance(op, (P.PhysFilter, P.PhysProjection)):
            return LoweredPlan._statically_empty(op.child)
        return False

    def _lower_clauses(self, vars_: set, anti_plans, union_groups, optional_plans) -> set:
        """Compose the clause branches over the main tree in the executor's
        post-pass order — UNION joins, then OPTIONAL left-outer joins, then
        MINUS/NOT anti-joins — so the whole group pattern is one plan."""
        for group in union_groups:
            live = [b for b in group if not self._statically_empty(b)]
            if not live:
                # every branch scans an unknown constant: the union table is
                # empty, and joining it empties the result — a never-true
                # guard says so
                self.const_checks.append((None, None, None))
                continue
            children, all_vars = [], set()
            for bplan in live:
                broot, bvars = self._lower_branch(bplan, "UNION")
                children.append(broot)
                all_vars |= bvars
            # dropped (statically-empty) branches contribute no rows but DO
            # contribute columns, UNBOUND-filled, like the host post-pass
            for bplan in group:
                if not any(bplan is lv for lv in live):
                    all_vars |= self._phys_vars(bplan)
            uspec = UnionSpec(tuple(children), tuple(sorted(all_vars)))
            self.root, vars_ = self._make_join(self.root, vars_, uspec, all_vars)
        for bplan in optional_plans:
            if self._statically_empty(bplan):
                # the host keeps every left row with UNBOUND branch columns
                raise Unsupported("OPTIONAL branch with unknown constant")
            broot, bvars = self._lower_branch(bplan, "OPTIONAL")
            if self.root is None:
                # leading OPTIONAL with no group: stands alone
                self.root, vars_ = broot, set(bvars)
                continue
            shared = tuple(sorted(bvars & vars_))
            if not shared:
                raise Unsupported("OPTIONAL with no shared variables")
            self.root = LeftOuterSpec(self.root, broot, shared, self.join_count, 0)
            self.join_count += 1
            vars_ = vars_ | bvars
        for bplan in anti_plans:
            if self.root is None:
                raise Unsupported("MINUS without a group")
            if self._statically_empty(bplan):
                continue  # empty branch: MINUS/NOT removes nothing
            broot, bvars = self._lower_branch(bplan, "MINUS/NOT")
            shared = tuple(sorted(bvars & vars_))
            if not shared:
                continue  # disjoint domains: MINUS removes nothing
            self.root = AntiJoinSpec(self.root, broot, shared)
        return vars_

    # ------------------------------------------------------------- lowering

    def _order(self, name: str) -> int:
        idx = self._order_idx.get(name)
        if idx is None:
            idx = len(self.order_names)
            self.order_names.append(name)
            self._order_idx[name] = idx
        return idx

    def _lower(self, op):
        if isinstance(op, (P.PhysIndexScan, P.PhysTableScan)):
            pat = op.pattern
            terms = [pat.subject, pat.predicate, pat.object]
            if all(t.kind == "id" for t in terms):
                # hoist as a host membership guard (an unknown constant can
                # never match -> the guard is permanently false)
                self.const_checks.append(
                    tuple(None if t.value is None else int(t.value) for t in terms)
                )
                return None, set()
            return self._lower_scan(pat)
        if isinstance(
            op,
            (P.PhysHashJoin, P.PhysMergeJoin, P.PhysParallelJoin, P.PhysNestedLoopJoin),
        ):
            left, lv = self._lower(op.left)
            right, rv = self._lower(op.right)
            return self._make_join(left, lv, right, rv)
        if isinstance(op, P.PhysStarJoin):
            node = None
            vars_: set = set()
            for scan in op.scans:
                n, v = self._lower(scan)
                if node is None:
                    node, vars_ = n, v
                else:
                    node, vars_ = self._make_join(node, vars_, n, v)
            if node is None:
                raise Unsupported("empty star join")
            return node, vars_
        if isinstance(op, P.PhysFilter):
            child, cv = self._lower(op.child)
            if child is None:
                raise Unsupported("filter over constant-only group")
            expr = self._lower_filter(op.expr, cv)
            return FilterSpec(child, expr), cv
        if isinstance(op, P.PhysProjection):
            # projection to fewer columns happens after readback
            return self._lower(op.child)
        if isinstance(op, P.WcojNode):
            return self._lower_wcoj(op)
        if isinstance(op, P.PhysValues):
            return self._lower_values(op.values)
        raise Unsupported(f"operator {type(op).__name__}")

    _DEFAULT_ORDER = {
        # bound canonical positions -> default order (mirrors store.match)
        frozenset(): "spo",
        frozenset({0}): "spo",
        frozenset({1}): "pos",
        frozenset({2}): "osp",
        frozenset({0, 1}): "spo",
        frozenset({1, 2}): "pos",
        frozenset({0, 2}): "osp",
    }

    @staticmethod
    def _order_for(bound: frozenset, sorted_pos: int) -> Optional[str]:
        """Sort order whose prefix matches the bound positions AND whose next
        column is ``sorted_pos`` — a range scan from it presents that column
        sorted (enabling the sort-free merge join)."""
        pos_of = {"s": 0, "p": 1, "o": 2}
        k = len(bound)
        for name, perm in ColumnarTripleStore._ORDER_PERMS.items():
            idxs = [pos_of[c] for c in perm]
            if frozenset(idxs[:k]) == bound and idxs[k] == sorted_pos:
                return name
        return None

    @staticmethod
    def _merge_key_pos(order_name: str, n_bound: int) -> tuple:
        """Canonical positions of the two order columns the two-segment
        scan packs as its base/delta merge key: the first UNBOUND perm
        column and its successor."""
        pos_of = {"s": 0, "p": 1, "o": 2}
        perm = ColumnarTripleStore._ORDER_PERMS[order_name]
        k = min(n_bound, 2)
        return (pos_of[perm[k]], pos_of[perm[min(k + 1, 2)]])

    def _lower_scan(self, pattern: PatternTriple):
        terms = [pattern.subject, pattern.predicate, pattern.object]
        consts: List[Optional[int]] = []
        quoted_at: List[tuple] = []  # (outer_pos, synthetic var, inner terms)
        for pos, t in enumerate(terms):
            if t.kind == "id":
                # a constant not in the dictionary can never match: keep the
                # scan and let _scan_ranges emit an empty (lo, 0) range
                consts.append(-1 if t.value is None else int(t.value))
            elif t.kind == "var":
                consts.append(None)
            else:
                # quoted term with inner variables (ground quoted terms were
                # folded to their qid by resolve_pattern): scan the position
                # as a synthetic qid variable, then expand it against the
                # quoted table
                qvar = f"__qt{len(self.quoted_specs)}{len(quoted_at)}"
                quoted_at.append((pos, qvar, t.value))
                consts.append(None)
        bound = frozenset(i for i, c in enumerate(consts) if c is not None)
        order_name = self._DEFAULT_ORDER[bound]
        order_idx = self._order(order_name)
        scan_idx = len(self.scan_descs)
        self.scan_descs.append((order_name, tuple(consts)))
        out_vars: List[tuple] = []
        eq_pairs: List[tuple] = []
        seen: Dict[str, int] = {}
        for pos, t in enumerate(terms):
            if t.kind == "var":
                name = t.value
            elif t.kind == "quoted":
                name = next(q for p, q, _ in quoted_at if p == pos)
            else:
                continue
            if name in seen:
                eq_pairs.append((seen[name], pos))
            else:
                seen[name] = pos
                out_vars.append((name, pos))
        if not out_vars:
            raise Unsupported("pattern binds no variables")
        node: object = ScanSpec(
            order_idx,
            scan_idx,
            tuple(out_vars),
            tuple(eq_pairs),
            0,
            self._merge_key_pos(order_name, len(bound)),
        )
        bound_vars = {v for v in seen if not v.startswith("__qt")}
        for _pos, qvar, inner in quoted_at:
            node, bound_vars = self._wrap_quoted(node, qvar, inner, bound_vars)
        return node, bound_vars

    def _wrap_quoted(self, node, qvar: str, inner, bound_vars: set):
        """Wrap ``node`` with one :class:`QuotedExpandSpec` for the quoted
        term ``inner`` scanned into synthetic column ``qvar``."""
        q_out: List[tuple] = []
        q_const: List[tuple] = []
        q_eq: List[tuple] = []
        newly: set = set()
        for ipos, it in enumerate(inner):
            if it.kind == "id":
                # unknown inner constant: the never-an-ID sentinel, so the
                # check can never pass
                q_const.append((ipos, self._uparam(SENT if it.value is None else int(it.value))))
            elif it.kind == "var":
                name = it.value
                if name in bound_vars or name in newly:
                    q_eq.append((ipos, name))  # collision or repeat
                else:
                    q_out.append((name, ipos))
                    newly.add(name)
            else:
                raise Unsupported("doubly-nested quoted pattern")
        self.quoted_specs.append(qvar)
        self.need_quoted = True
        spec = QuotedExpandSpec(node, qvar, tuple(q_out), tuple(q_const), tuple(q_eq))
        return spec, bound_vars | newly

    def _lower_values(self, values):
        if not values.variables or not values.rows:
            raise Unsupported("empty VALUES")
        n = len(values.rows)
        cols = []
        for j, _var in enumerate(values.variables):
            col = np.empty(n, dtype=np.int64)
            for i, row in enumerate(values.rows):
                term = row[j] if j < len(row) else None
                # UNDEF is UNBOUND; a new term is interned, as the
                # reference does
                col[i] = (
                    UNBOUND
                    if term is None
                    else self.db.dictionary.encode(self.db.expand_term(term))
                )
            cols.append(col)
        idx = len(self.values_tables)
        self.values_tables.append(tuple(cols))
        return ValuesSpec(idx, tuple(values.variables), n), set(values.variables)

    def _lower_wcoj(self, op):
        """Lower a :class:`WcojNode`: one level per elimination variable; at
        each level, every pattern containing the variable contributes an
        accessor over the order whose perm prefix is exactly its bound
        positions.  Unknown constants become the never-an-ID sentinel,
        which zeroes the accessor's ranges at run time."""
        srcs: List[tuple] = []
        for scan in op.scans:
            if not isinstance(scan, (P.PhysIndexScan, P.PhysTableScan)):
                raise Unsupported("non-scan input to WCOJ")
            row: List[tuple] = []
            for t in (scan.pattern.subject, scan.pattern.predicate, scan.pattern.object):
                if t.kind == "var":
                    row.append(("v", t.value))
                elif t.kind == "id":
                    cid = SENT if t.value is None else int(t.value)
                    row.append(("u", self._uparam(cid)))
                else:
                    raise Unsupported("quoted term in WCOJ pattern")
            srcs.append(tuple(row))
        pos_of = {"s": 0, "p": 1, "o": 2}
        eliminated: set = set()
        levels: List[WcojLevel] = []
        for var in op.elim_order:
            accessors: List[WcojAccessor] = []
            for row in srcs:
                positions = [i for i, s in enumerate(row) if s == ("v", var)]
                if not positions:
                    continue
                if len(positions) > 1:
                    raise Unsupported("repeated variable in WCOJ pattern")
                val_pos = positions[0]
                bound = frozenset(
                    i
                    for i, s in enumerate(row)
                    if s[0] == "u" or (s[0] == "v" and s[1] in eliminated)
                )
                order_name = self._order_for(bound, val_pos)
                if order_name is None:  # can't happen for |bound| <= 2
                    raise Unsupported("no covering order for WCOJ accessor")
                perm = ColumnarTripleStore._ORDER_PERMS[order_name]
                key_pos = tuple(pos_of[c] for c in perm[: len(bound)])
                accessors.append(
                    WcojAccessor(
                        self._order(order_name),
                        tuple(row[p] for p in key_pos),
                        key_pos,
                        val_pos,
                    )
                )
            if not accessors:
                raise Unsupported("WCOJ variable not covered by any pattern")
            levels.append(WcojLevel(var, self.join_count, 0, tuple(accessors)))
            self.join_count += 1
            eliminated.add(var)
        return WcojSpec(tuple(levels)), set(op.elim_order)

    def _try_presort_scan(self, node, key_var: str) -> Optional[ScanSpec]:
        """If ``node`` is a bare scan (prefix validity) re-pick its order so
        ``key_var``'s column comes out sorted; None if not possible."""
        if not isinstance(node, ScanSpec) or node.eq_pairs:
            return None
        pos = dict(node.out_vars).get(key_var)
        if pos is None:
            return None
        consts = self.scan_descs[node.scan_idx][1]
        bound = frozenset(i for i, c in enumerate(consts) if c is not None)
        order_name = self._order_for(bound, pos)
        if order_name is None:
            return None
        self.scan_descs[node.scan_idx] = (order_name, consts)
        return ScanSpec(
            self._order(order_name),
            node.scan_idx,
            node.out_vars,
            node.eq_pairs,
            node.cap,
            self._merge_key_pos(order_name, len(bound)),
        )

    def _make_join(self, left, lv: set, right, rv: set):
        # a constant-pattern child lowered to a host guard joins as identity
        if left is None:
            return right, rv
        if right is None:
            return left, lv
        shared = tuple(sorted(lv & rv))
        if not shared:
            raise Unsupported("cartesian join")
        rsorted = False
        if len(shared) == 1:
            presorted = self._try_presort_scan(right, shared[0])
            if presorted is not None:
                right, rsorted = presorted, True
            else:
                presorted = self._try_presort_scan(left, shared[0])
                if presorted is not None:  # swap sides: inner join commutes
                    left, right, rsorted = right, presorted, True
        spec = JoinSpec(left, right, shared, self.join_count, 0, rsorted)
        self.join_count += 1
        return spec, lv | rv

    # ---------------------------------------------------------- filter lowering

    def _uparam(self, value: int) -> int:
        """Allocate the next u32 constant slot; returns its index."""
        self.u_params.append(int(value) & 0xFFFFFFFF)
        return len(self.u_params) - 1

    def _fparam(self, value: float) -> int:
        """Allocate the next f64 constant slot; returns its index."""
        self.f_params.append(float(value))
        return len(self.f_params) - 1

    def _compute_mask(self, key: tuple) -> np.ndarray:
        _tag, name, pattern, which = key
        return string_filter_mask(self.db, name, pattern, which)

    def _mask_index(self, key: tuple) -> int:
        idx = self._mask_keys.get(key)
        if idx is None:
            idx = len(self.mask_arrays)
            self.mask_arrays.append(self._compute_mask(key))
            self.mask_exprs.append(key)
            self._mask_keys[key] = idx
            self._mask_dict_len = self._store_sizes()
        return idx

    def _store_sizes(self) -> tuple:
        return (len(self.db.dictionary.id_to_str), len(self.db.quoted))

    def _refresh_masks(self) -> None:
        """Rebuild per-ID filter masks if the dictionary (or quoted store)
        grew since lowering."""
        sizes = self._store_sizes()
        if self.mask_arrays and sizes != self._mask_dict_len:
            self.mask_arrays = [self._compute_mask(k) for k in self.mask_exprs]
            self._mask_dict_len = sizes

    def _lower_filter(self, expr, vars_: set):
        if isinstance(expr, LogicalAnd):
            return BoolNode(
                "and",
                (self._lower_filter(expr.left, vars_), self._lower_filter(expr.right, vars_)),
            )
        if isinstance(expr, LogicalOr):
            return BoolNode(
                "or",
                (self._lower_filter(expr.left, vars_), self._lower_filter(expr.right, vars_)),
            )
        if isinstance(expr, LogicalNot):
            return BoolNode("not", (self._lower_filter(expr.inner, vars_),))
        if isinstance(expr, Comparison):
            return self._lower_comparison(expr, vars_)
        if isinstance(expr, FunctionCall):
            return self._lower_function(expr, vars_)
        raise Unsupported(f"filter expression {type(expr).__name__}")

    _STR_FUNCS = ("REGEX", "CONTAINS", "STRSTARTS", "STRENDS")

    def _lower_function(self, expr, vars_: set):
        """BOUND/ISTRIPLE as ID tests; the constant-pattern string
        predicates as per-ID verdict masks (one over dictionary IDs, one
        over quoted IDs)."""
        name = expr.name.upper()
        args = expr.args
        if (
            name in ("BOUND", "ISTRIPLE")
            and len(args) == 1
            and isinstance(args[0], Var)
            and args[0].name in vars_
        ):
            if name == "BOUND":
                return IdCmp("!=", args[0].name, self._uparam(int(UNBOUND)))
            return QuotedCheck(args[0].name)
        if (
            name in self._STR_FUNCS
            and len(args) == 2
            and isinstance(args[0], Var)
            and args[0].name in vars_
            and isinstance(args[1], StringLit)
        ):
            lex = args[1].value
            pattern = lex[1:].split('"')[0] if lex.startswith('"') else lex
            didx = self._mask_index(("str", name, pattern, "dict"))
            qidx = self._mask_index(("str", name, pattern, "quoted"))
            return StrMaskRef(didx, qidx, args[0].name)
        raise Unsupported(f"filter function {expr.name}")

    @staticmethod
    def _as_number(e) -> Optional[float]:
        if isinstance(e, NumberLit):
            return float(e.value)
        if isinstance(e, StringLit):
            try:
                return float(e.value.strip('"').split('"')[0])
            except ValueError:
                return None
        return None

    def _lower_comparison(self, cmp: Comparison, vars_: set):
        lhs, rhs, op = cmp.left, cmp.right, cmp.op
        # const op var  ->  var flipped-op const
        if isinstance(rhs, Var) and not isinstance(lhs, Var):
            lhs, rhs = rhs, lhs
            flip = True
        else:
            flip = False
        if not isinstance(lhs, Var) or lhs.name not in vars_:
            raise Unsupported("filter lhs not a bound variable")
        if isinstance(rhs, Var):
            if rhs.name not in vars_:
                raise Unsupported("filter rhs variable unbound")
            self.need_numf = True
            return NumCmp(op, lhs.name, rhs.name)
        num = self._as_number(rhs)
        if num is not None:
            if flip:
                op = {
                    "<": ">", "<=": ">=", ">": "<", ">=": "<=",
                    "=": "=", "!=": "!=",
                }[op]
            self.need_numf = True
            return NumConstCmp(op, lhs.name, self._fparam(num))
        if op not in ("=", "!="):
            raise Unsupported("ordered comparison with non-numeric constant")
        if isinstance(rhs, IriRef):
            tid = self.db.dictionary.lookup(self.db.expand_term(rhs.iri))
        elif isinstance(rhs, StringLit):
            tid = self.db.dictionary.lookup(rhs.value)
        else:
            raise Unsupported(f"filter rhs {type(rhs).__name__}")
        return IdCmp(op, lhs.name, self._uparam(SENT if tid is None else int(tid)))

    # ------------------------------------------------------------- assembly

    def _scan_ranges(self) -> np.ndarray:
        """:func:`scan_range` of every scan as ``(lo_base, n_base,
        lo_delta, n_delta)`` rows."""
        out = np.zeros((max(len(self.scan_descs), 1), 4), dtype=np.int64)
        for i, (order_name, consts) in enumerate(self.scan_descs):
            out[i] = scan_range(self.db.store, order_name, consts)
        return out

    def _with_caps(self, node, scan_caps: Dict[int, int], join_caps: List[int]):
        if isinstance(node, ScanSpec):
            return replace(node, cap=scan_caps[node.scan_idx])
        if isinstance(node, WcojSpec):
            return WcojSpec(
                tuple(replace(lv, cap=join_caps[lv.join_idx]) for lv in node.levels)
            )
        node = _map_children(node, lambda c: self._with_caps(c, scan_caps, join_caps))
        if isinstance(node, (JoinSpec, LeftOuterSpec)):
            node = replace(node, cap=join_caps[node.join_idx])
        return node

    def _node_cap(self, node, scan_caps, join_caps) -> int:
        if isinstance(node, ScanSpec):
            return scan_caps[node.scan_idx]
        if isinstance(node, JoinSpec):
            return join_caps[node.join_idx]
        if isinstance(node, (FilterSpec, QuotedExpandSpec)):
            return self._node_cap(node.child, scan_caps, join_caps)
        if isinstance(node, AntiJoinSpec):
            return self._node_cap(node.left, scan_caps, join_caps)
        if isinstance(node, LeftOuterSpec):
            return join_caps[node.join_idx] + self._node_cap(node.left, scan_caps, join_caps)
        if isinstance(node, UnionSpec):
            return sum(self._node_cap(ch, scan_caps, join_caps) for ch in node.children)
        if isinstance(node, ValuesSpec):
            return node.n
        if isinstance(node, WcojSpec):
            return join_caps[node.levels[-1].join_idx]
        raise TypeError(node)

    def _initial_join_caps(self, scan_caps) -> List[int]:
        cached = self.db.__dict__.setdefault("_device_cap_cache", {}).get(self.cap_key)
        if cached is not None and len(cached) == self.join_count:
            return list(cached)
        caps: List[int] = [0] * self.join_count

        def walk(node) -> int:
            if isinstance(node, JoinSpec):
                ln = walk(node.left)
                rn = walk(node.right)
                cap = _round_cap(2 * max(ln, rn))
                caps[node.join_idx] = cap
                return cap
            if isinstance(node, AntiJoinSpec):
                ln = walk(node.left)
                walk(node.right)  # fills the branch's own join caps
                return ln
            if isinstance(node, LeftOuterSpec):
                ln = walk(node.left)
                rn = walk(node.right)
                cap = _round_cap(2 * max(ln, rn))
                caps[node.join_idx] = cap
                return cap + ln
            if isinstance(node, UnionSpec):
                return sum(walk(ch) for ch in node.children)
            if isinstance(node, (FilterSpec, QuotedExpandSpec)):
                return walk(node.child)  # fill caps of joins under wrappers
            if isinstance(node, WcojSpec):
                # optimistic start: each level no larger than its tightest
                # accessor's largest key-group or the previous level;
                # convergence doubles on real overflow
                prev = 1
                for lv in node.levels:
                    group = min(
                        template_scan_cap(
                            self.db, self.order_names[a.order_idx], len(a.key_srcs)
                        )
                        for a in lv.accessors
                    )
                    prev = _round_cap(max(prev, group))
                    caps[lv.join_idx] = prev
                return prev
            return self._node_cap(node, scan_caps, caps)

        walk(self.root)
        return caps

    def build(self) -> Tuple[PlanSpec, tuple]:
        """Assemble ``(spec, operands)`` for the current store/capacities."""
        self._refresh_masks()
        self._scan_ranges_np = self._scan_ranges()
        # scan capacities are a TEMPLATE property: the largest key-group of
        # the order's bound-column prefix bounds the live range for ANY
        # constant
        self._scan_caps = {
            i: _round_cap(
                template_scan_cap(self.db, name, sum(c is not None for c in consts))
            )
            for i, (name, consts) in enumerate(self.scan_descs)
        }
        self._join_caps = self._initial_join_caps(self._scan_caps)
        store = self.db.store
        root = self._with_caps(self.root, self._scan_caps, self._join_caps)
        spec = PlanSpec(root, self.out_vars, tuple(self.order_names))
        order_arrays = tuple(store.device_segment(name) for name in self.order_names)
        masks = tuple(
            torch.from_numpy(_pad_pow2(m, False)).to(self.device)
            for m in self.mask_arrays
        )
        values = tuple(
            tuple(torch.from_numpy(c).to(self.device) for c in cols)
            for cols in self.values_tables
        )
        if self.need_numf:
            numf = device_numf(self.db)
        else:
            numf = torch.zeros(1, dtype=torch.float64, device=self.device)
        quoted = device_quoted(self.db) if self.need_quoted else None
        return spec, (order_arrays, self._scan_ranges_np, masks, values, numf, quoted)

    # ------------------------------------------------------------ execution

    def run(self):
        """One evaluation at the current capacities.  Returns (out_cols,
        valid, counts, stats) — all device-resident."""
        spec, operands = self.build()
        return _plan_body(spec, *operands, self.u_params, self.f_params)

    def _store_caps(self) -> None:
        """Publish join capacities to the per-db template cache (monotonic
        max: shared by every constant variant of the template)."""
        cache = self.db.__dict__.setdefault("_device_cap_cache", {})
        prev = cache.get(self.cap_key)
        caps = tuple(self._join_caps)
        if prev is not None and len(prev) == len(caps):
            caps = tuple(max(a, b) for a, b in zip(prev, caps))
        cache[self.cap_key] = caps
        self._join_caps = list(caps)

    def converge(self, out, max_attempts: int = 12):
        """Validate join counts against the capacities ``out`` ran with;
        re-run with doubled capacities until everything fits.  Returns
        ``(out_cols, valid)`` — the one readback of the counts is here."""
        for _attempt in range(max_attempts):
            out_cols, valid, counts, stats = out
            self._last_stats = stats  # device-resident; fetched on demand
            counts_h = torch.stack(counts).tolist() if counts else []
            overflow = [i for i, c in enumerate(counts_h) if c > self._join_caps[i]]
            if not overflow:
                self._last_counts = counts_h
                self._store_caps()
                return out_cols, valid
            for i in overflow:
                self._join_caps[i] = _round_cap(2 * counts_h[i])
            self._store_caps()
            out = self.run()
        raise RuntimeError("device plan capacities failed to converge")

    def to_table(self, out_cols, valid) -> BindingTable:
        keep = torch.nonzero(valid).squeeze(1)
        if not out_cols:
            return {}
        stacked = torch.stack([c[keep] for c in out_cols]).cpu().numpy()
        return {
            var: stacked[j].astype(np.uint32) for j, var in enumerate(self.out_vars)
        }

    def fetch_stats(self) -> Dict[str, int]:
        """Host-read the per-operator stats of the last converged run (one
        extra device->host transfer; the query path never calls this)."""
        stats = getattr(self, "_last_stats", None)
        if not stats:
            return {}
        keys = list(stats)
        vals = torch.stack([stats[k].to(torch.int64) for k in keys]).tolist()
        return dict(zip(keys, vals))

    def const_ok(self) -> bool:
        """Evaluate the hoisted fully-constant pattern guards against the
        CURRENT store (host binary searches; no device op)."""
        if not self.const_checks:
            return True
        order = self.db.store.order("spo")
        for s, p, o in self.const_checks:
            if s is None or p is None or o is None:
                return False  # unknown constant can never match
            lo, hi = order.range012(s, p, o)
            if lo >= hi:
                return False
        return True

    def empty_table(self) -> BindingTable:
        return {v: np.empty(0, dtype=np.uint32) for v in self.out_vars}

    def execute(self) -> BindingTable:
        """Run to completion with capacity validation; returns a host table."""
        if not self.const_ok():
            return self.empty_table()
        return self.to_table(*self.converge(self.run()))


def scan_range(store, order_name: str, consts) -> Tuple[int, int, int, int]:
    """Host searchsorted over the base and delta sorted orders of
    ``order_name``, whose permutation starts with the bound positions of
    ``consts`` (an ID, or None for a variable, per canonical position) →
    ``(lo_base, n_base, lo_delta, n_delta)``.  The base window INCLUDES
    deleted rows (the tombstone positions mask them); an unknown constant
    (negative) gives empty windows."""
    pos_of = {"s": 0, "p": 1, "o": 2}
    out = [0, 0, 0, 0]
    segments = (store.base_order(order_name), store.delta_order(order_name))
    for j, order in enumerate(segments):
        keys = [consts[pos_of[c]] for c in order.perm if consts[pos_of[c]] is not None]
        if any(k < 0 for k in keys):
            continue
        if not keys:
            lo, hi = 0, len(order)
        elif len(keys) == 1:
            lo, hi = order.range0(keys[0])
        elif len(keys) == 2:
            lo, hi = order.range01(keys[0], keys[1])
        else:
            lo, hi = order.range012(keys[0], keys[1], keys[2])
        out[2 * j] = lo
        out[2 * j + 1] = hi - lo
    return tuple(out)


def scan_rows(db, consts) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Canonical ``(s, p, o)`` device columns of the live triples matching
    ``consts`` (an ID, or None for a variable, per position): the rows of
    ``store.match`` in its order (the chosen sort order's, every column
    sorted), read from the two-tier device mirror (the base window less
    its tombstones, then the delta window, merged by two stable sorts when
    the delta holds rows).  Window sizes come from host binary searches,
    so nothing is read back from the device."""
    store = db.store
    bound = frozenset(i for i, c in enumerate(consts) if c is not None)
    order_name = LoweredPlan._DEFAULT_ORDER.get(bound, "spo")
    bcols, dcols, del_pos = store.device_segment(order_name)
    lo_b, n_b, lo_d, n_d = scan_range(store, order_name, consts)
    dels = store.delta_del_positions(order_name)
    n_del = int(np.searchsorted(dels, lo_b + n_b) - np.searchsorted(dels, lo_b))
    if n_del == 0:
        base = [c[lo_b : lo_b + n_b] for c in bcols]
    else:
        src = lo_b + torch.arange(n_b, dtype=torch.int64, device=db.device)
        jd = torch.searchsorted(del_pos, src).clamp_(0, del_pos.shape[0] - 1)
        keep = del_pos[jd] != src
        n_live = n_b - n_del
        dest = torch.where(keep, torch.cumsum(keep, 0) - 1, n_live)
        live = torch.zeros(n_live + 1, dtype=torch.int64, device=db.device)
        live[dest] = src
        base = [c[live[:n_live]] for c in bcols]
    if n_d == 0:
        return tuple(base)
    cols = [torch.cat([b, d[lo_d : lo_d + n_d]]) for b, d in zip(base, dcols)]
    pos_of = {"s": 0, "p": 1, "o": 2}
    c0, c1, c2 = (cols[pos_of[c]] for c in ColumnarTripleStore._ORDER_PERMS[order_name])
    by2 = torch.argsort(c2, stable=True)
    order = by2[torch.argsort(pack2(c0[by2], c1[by2]), stable=True)]
    return tuple(c[order] for c in cols)


def string_filter_mask(db, name: str, pattern: str, which: str) -> np.ndarray:
    """Per-ID verdicts for a constant-pattern string predicate: ``which`` =
    'dict' evaluates over every dictionary term, 'quoted' over every quoted
    ID's decoded RDF-star form.  One sentinel False entry keeps empty
    stores shaped."""
    if which == "dict":
        strs = [strip_literal(s) for s in db.dictionary.id_to_str]
    else:
        strs = [
            strip_literal(db.decode_term(QUOTED_BIT | i)) for i in range(len(db.quoted))
        ]
    if not strs:
        strs = [None]
    if name == "REGEX":
        import re

        rx = re.compile(pattern or "")
        return np.array([bool(rx.search(s or "")) for s in strs], dtype=bool)
    if name == "CONTAINS":
        return np.array([(s or "").find(pattern or "") >= 0 for s in strs], dtype=bool)
    if name == "STRSTARTS":
        return np.array([(s or "").startswith(pattern or "") for s in strs], dtype=bool)
    return np.array([(s or "").endswith(pattern or "") for s in strs], dtype=bool)


def numeric_filter_mask(vals: np.ndarray, op: str, const: float) -> np.ndarray:
    """Per-ID boolean mask for ``term op const`` over the database's
    numeric-literal table (NaN = non-numeric, always excluded) — the host
    definition of the numeric filter semantics :class:`NumConstCmp`
    evaluates on the device."""
    with np.errstate(invalid="ignore"):
        m = _cmp(op, vals, const)
    return m & ~np.isnan(vals)


def template_scan_cap(db, order_name: str, n_bound: int) -> int:
    """Upper bound on ANY constant-variant's merged (base + delta) range
    for a scan whose ``order_name`` prefix binds ``n_bound`` columns: the
    largest key-group of that prefix in the FROZEN base plus the fixed
    delta device capacity.  Cached per (order, prefix, base_version)."""
    store = db.store
    dcap = store.delta_device_cap
    base = store.base_order(order_name)
    nb = len(base)
    if nb == 0:
        return dcap
    if n_bound <= 0:
        return nb + dcap
    cache = db.__dict__.setdefault("_device_group_cap_cache", {})
    bv = store.base_version
    key = (order_name, n_bound, bv)
    hit = cache.get(key)
    if hit is not None:
        return hit + dcap
    for stale in [k for k in cache if k[2] != bv]:
        del cache[stale]
    rows = base.slice_rows(0, nb)
    change = np.zeros(nb, dtype=bool)
    change[0] = True
    for c in base.perm[:n_bound]:
        col = rows[c]
        change[1:] |= col[1:] != col[:-1]
    bounds = np.append(np.flatnonzero(change), nb)
    cap = int(np.max(np.diff(bounds)))
    cache[key] = cap
    return cap + dcap


def device_numf(db) -> torch.Tensor:
    """Device copy of the numeric-literal table (f64), cached until the
    dictionary grows; padded with NaN (non-numeric) to a power of two."""
    cache = db.__dict__.get("_device_numf_cache")
    vals = db.numeric_values()
    n = len(vals)
    if cache is not None and cache[0] == n:
        return cache[1]
    padded = np.full(_round_cap(n, 1024), np.nan)
    padded[:n] = vals
    arr = torch.from_numpy(padded).to(db.device)
    db.__dict__["_device_numf_cache"] = (n, arr)
    return arr


def host_quoted_table(db):
    """Per-database qid-sorted quoted table as numpy ``(qid, s, p, o)``,
    cached until the quoted store grows.  One sentinel row (all-ones qid,
    never a real ID) keeps shapes non-empty and unmatched when the store
    has no quoted triples."""
    cache = db.__dict__.get("_host_qt_cache")
    n = len(db.quoted)
    if cache is not None and cache[0] == n:
        return cache[1]
    qid = np.full(n + 1, SENT, dtype=np.int64)
    qs = np.zeros(n + 1, dtype=np.int64)
    qp = np.zeros(n + 1, dtype=np.int64)
    qo = np.zeros(n + 1, dtype=np.int64)
    for i, (q, (s, p, o)) in enumerate(db.quoted.items()):
        qid[i], qs[i], qp[i], qo[i] = q, s, p, o
    order = np.argsort(qid, kind="stable")
    arrs = tuple(a[order] for a in (qid, qs, qp, qo))
    db.__dict__["_host_qt_cache"] = (n, arrs)
    return arrs


def device_quoted(db):
    """Device copy of :func:`host_quoted_table`, uploaded once per quoted
    store size; padded to a power-of-two row count with sentinel rows (the
    all-ones qid stays sorted last and never matches)."""
    cache = db.__dict__.get("_device_qt_cache")
    n = len(db.quoted)
    if cache is not None and cache[0] == n:
        return cache[1]
    qid, qs, qp, qo = host_quoted_table(db)
    arrs = tuple(
        torch.from_numpy(_pad_pow2(a, fill)).to(db.device)
        for a, fill in ((qid, SENT), (qs, 0), (qp, 0), (qo, 0))
    )
    db.__dict__["_device_qt_cache"] = (n, arrs)
    return arrs


def lower_plan(db, plan, anti_plans=(), union_groups=(), optional_plans=()) -> LoweredPlan:
    """Lower ``plan`` for the database's device, with the MINUS/NOT branch
    plans (``anti_plans``: anti-joins), UNION groups (tuples of branch
    plans: concatenation joined in) and OPTIONAL branch plans (left-outer
    joins) composed over it in the host post-pass order.  Raises
    :class:`Unsupported` for shapes the engine does not lower; only
    lowering raises it, never :meth:`LoweredPlan.execute`."""
    return LoweredPlan(db, plan, anti_plans, union_groups, optional_plans)


# ---------------------------------------------------------------------------
# GROUP BY / aggregation on the device
# ---------------------------------------------------------------------------


def _drop_reduce(cap: int, dst, src, init: float, reduce: Optional[str] = None):
    """``full(cap, init).at[dst].add/min/max(src, mode="drop")`` in f64:
    destinations ``>= cap`` go to a sink slot that is cut off."""
    out = torch.full((cap + 1,), init, dtype=torch.float64, device=src.device)
    dst = dst.clamp(max=cap)
    if reduce is None:
        out.index_add_(0, dst, src)
    else:
        out.scatter_reduce_(0, dst, src, reduce=reduce, include_self=True)
    return out[:cap]


def _drop_set(cap: int, dst, src):
    """``zeros(cap).at[dst].set(src, mode="drop")`` (unique destinations
    below ``cap``; the rest go to the cut-off sink)."""
    out = torch.zeros(cap + 1, dtype=src.dtype, device=src.device)
    out[dst.clamp(max=cap)] = src
    return out[:cap]


def _stable_lexsort(keys: List[torch.Tensor]) -> torch.Tensor:
    """Permutation sorting rows by ``keys`` (first key primary), ties in
    row order: ``lax.sort(num_keys=len(keys), is_stable=True)``, built as
    stable sorts from the last key to the first."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def _segment_aggregate(cols, valid, numf, gpos, funcs, apos, distincts, cap: int):
    """Segment-reduce the final plan table on the device: stable sort by the
    group key columns, first-occurrence segment ids, scatter-reduce per
    aggregate.  ``gpos``: positions of the group columns in ``cols``;
    ``funcs``: COUNT/SUM/AVG/MIN/MAX/SAMPLE; ``apos``: per-aggregate value
    column (-1 for COUNT(*)); ``distincts``: per-aggregate DISTINCT flag
    (honoured for COUNT only, as on the host).  Returns (group id columns,
    f64-or-id aggregate columns, n_groups) of length ``cap``."""
    n = valid.shape[0]
    dev = valid.device
    if gpos:
        keys = [torch.where(valid, cols[g], SENT) for g in gpos]
    else:
        # aggregate without GROUP BY: one group holding every valid row
        keys = [torch.where(valid, 0, SENT)]
    order = _stable_lexsort(keys)
    ks = [k[order] for k in keys]
    rowok = ks[0] != SENT  # invalid rows carry the sentinel in EVERY key
    isnew = torch.zeros(n, dtype=torch.bool, device=dev)
    isnew[0] = True
    for k in ks:
        isnew[1:] |= k[1:] != k[:-1]
    isnew &= rowok
    if not gpos:
        # SPARQL: an empty input still yields ONE group (COUNT() = 0)
        isnew[0] = True
    seg = torch.cumsum(isnew, 0) - 1
    n_groups = isnew.sum()
    segc = torch.where(rowok, seg, cap)
    gdest = torch.where(isnew, seg, cap)
    group_cols = [_drop_set(cap, gdest, k) for k in ks[: len(gpos)]]
    ones = torch.ones(n, dtype=torch.float64, device=dev)

    def distinct_first(vcol):
        """Mask (in ORIGINAL row order) of the first occurrence of each
        (group key, value) pair."""
        vkey = torch.where(valid, vcol, SENT)
        perm = _stable_lexsort(keys + [vkey])
        firstp = torch.zeros(n, dtype=torch.bool, device=dev)
        firstp[0] = True
        for k in keys + [vkey]:
            kp = k[perm]
            firstp[1:] |= kp[1:] != kp[:-1]
        out = torch.zeros(n, dtype=torch.bool, device=dev)
        out[perm] = firstp
        return out

    agg_out = []
    for func, ap, dst_flag in zip(funcs, apos, distincts):
        if func == "COUNT" and ap < 0:
            agg_out.append(_drop_reduce(cap, segc, ones, 0.0))
            continue
        col = cols[ap][order]
        if func == "SAMPLE":
            # stable sort: the segment's first row is the group's FIRST row
            # in plan-output order; the forced group of a no-GROUP-BY
            # aggregate can be empty, hence the row-count guard
            cnt0 = _drop_reduce(cap, segc, ones, 0.0)
            ids = _drop_set(cap, gdest, col)
            agg_out.append(torch.where(cnt0 == 0, 0, ids))
            continue
        if func == "COUNT":
            bound = (segc < cap) & (col != UNBOUND)
            if dst_flag:
                bound &= distinct_first(cols[ap])[order]
            agg_out.append(_drop_reduce(cap, torch.where(bound, segc, cap), ones, 0.0))
            continue
        vals = numf[col.clamp(max=numf.shape[0] - 1)]
        ok = (segc < cap) & ~torch.isnan(vals)
        dst = torch.where(ok, segc, cap)
        # one numeric-value count per segment: emptiness (-> NaN -> UNBOUND)
        # is decided by the count, never by the reduction's identity, so a
        # genuine +-inf literal survives
        cnt = _drop_reduce(cap, dst, ones, 0.0)
        if func in ("SUM", "AVG"):
            sums = _drop_reduce(cap, dst, torch.where(ok, vals, 0.0), 0.0)
            res = sums / torch.where(cnt == 0, 1.0, cnt) if func == "AVG" else sums
        elif func == "MIN":
            inf = torch.full_like(vals, float("inf"))
            res = _drop_reduce(cap, dst, torch.where(ok, vals, inf), float("inf"), "amin")
        else:  # MAX
            ninf = torch.full_like(vals, float("-inf"))
            res = _drop_reduce(cap, dst, torch.where(ok, vals, ninf), float("-inf"), "amax")
        agg_out.append(torch.where(cnt == 0, float("nan"), res))
    return tuple(group_cols), tuple(agg_out), n_groups


_DEVICE_AGG_FUNCS = ("COUNT", "SUM", "AVG", "MIN", "MAX", "SAMPLE")


def try_device_execute_aggregated(db, plan, q, lowered: Optional[LoweredPlan] = None):
    """Plan execution + GROUP BY/aggregation on the device; the host reads
    one row per group.  ``None`` when the aggregate shape is not
    expressible (GROUP_CONCAT, DISTINCT on a non-COUNT aggregate,
    expression items, a group key outside the plan): the caller then
    aggregates the plan's table on the host.  ``lowered``: the caller's
    lowering of ``plan``."""
    agg_items = [i for i in q.select if i.kind == "agg"]
    if not agg_items and not q.group_by:
        return None
    if any(i.kind == "expr" for i in q.select):
        return None  # host semantics drop exprs in agg queries; stay exact
    for item in agg_items:
        a = item.agg
        if a.func not in _DEVICE_AGG_FUNCS:
            return None
        if a.distinct and a.func != "COUNT":
            return None  # DISTINCT changes only COUNT on the host
    if lowered is None:
        lowered = lower_plan(db, plan)
    if not lowered.const_ok():
        return None  # empty result; the host path aggregates nothing
    out_vars = lowered.out_vars
    gpos = []
    for g in q.group_by:
        if g not in out_vars:
            return None
        gpos.append(out_vars.index(g))
    funcs, apos = [], []
    for item in agg_items:
        a = item.agg
        if a.var is None:
            apos.append(-1)
        elif a.var in out_vars:
            apos.append(out_vars.index(a.var))
        else:
            return None
        funcs.append(a.func)
    out_cols, valid = lowered.converge(lowered.run())
    return aggregate_table(db, tuple(out_cols), valid, q.group_by, agg_items, gpos, funcs, apos)


def aggregate_table(db, cols, valid, group_by, agg_items, gpos, funcs, apos) -> BindingTable:
    """Run :func:`_segment_aggregate` with the group-capacity retry and
    decode the per-group results into a host table."""
    from kolibrie_tpu_torch.query.executor import _encode_numbers

    cap = 1024
    numf_dev = device_numf(db)
    distincts = tuple(bool(i.agg.distinct) for i in agg_items)
    for _attempt in range(8):
        gcols, aggs, n_groups = _segment_aggregate(
            cols, valid, numf_dev, tuple(gpos), tuple(funcs), tuple(apos), distincts, cap
        )
        ng = int(n_groups)
        if ng <= cap:
            break
        cap = _round_cap(2 * ng)
    else:
        raise RuntimeError("group capacity failed to converge")
    table: BindingTable = {}
    for g, col in zip(group_by, gcols):
        table[g] = col[:ng].cpu().numpy().astype(np.uint32)
    enc = db.dictionary.encode
    for item, arr in zip(agg_items, aggs):
        host = arr[:ng].cpu().numpy()
        if item.agg.func == "SAMPLE":
            # the aggregate IS a term id, not a numeric result
            table[item.agg.alias] = host.astype(np.uint32)
        else:
            table[item.agg.alias] = _encode_numbers(enc, host)
    return table


# ---------------------------------------------------------------------------
# ORDER BY + LIMIT on the device (top-k readback)
# ---------------------------------------------------------------------------


def device_string_ranks(db):
    """Per-ID global string ranks (f64) for ORDER BY over non-numeric keys:
    every dictionary ID and quoted ID ranked by its RAW decoded term (the
    host ``_order_table`` ranks the result subset the same way; subset
    ranks are order-isomorphic to these).  Returns ``(dict_ranks,
    quoted_ranks)``, cached until either store grows."""
    n_d = len(db.dictionary.id_to_str)
    n_q = len(db.quoted)
    cache = db.__dict__.get("_device_strrank_cache")
    if cache is not None and cache[0] == (n_d, n_q):
        return cache[1]
    dec = db.decode_term
    strs = [dec(i) or "" for i in range(n_d)] + [dec(QUOTED_BIT | i) or "" for i in range(n_q)]
    _, inv = np.unique(np.array(strs), return_inverse=True)
    ranks = inv.astype(np.float64)
    arrs = (
        torch.from_numpy(_pad_pow2(ranks[:n_d], 0.0)).to(db.device),
        torch.from_numpy(
            _pad_pow2(ranks[n_d:] if n_q else np.zeros(1, dtype=np.float64), 0.0)
        ).to(db.device),
    )
    db.__dict__["_device_strrank_cache"] = ((n_d, n_q), arrs)
    return arrs


def _order_limit(cols, valid, numf, opos, descs, k: int, dranks=None, qranks=None):
    """ORDER BY + LIMIT on the device: sort keys gathered from the per-ID
    numeric table, or, when a key column holds ANY non-numeric valid value
    (the host ``_order_table`` per-column rule), from the global string
    ranks (two-level for quoted IDs); composed as stable argsorts, first
    ``k`` rows.  Returns ``(sliced cols, sliced valid, n_valid,
    nan_seen)``: run without ranks first, and a true ``nan_seen`` means
    run again with them."""
    n = valid.shape[0]
    perm = torch.arange(n, device=valid.device)
    nan_seen = torch.zeros((), dtype=torch.bool, device=valid.device)
    keys = []
    for pos, desc in zip(opos, descs):
        col = cols[pos]
        vals = numf[col.clamp(max=numf.shape[0] - 1)]
        col_nan = (torch.isnan(vals) & valid).any()
        nan_seen = nan_seen | col_nan
        if dranks is not None:
            isq = (col & QUOTED_BIT) != 0
            dr = dranks[col.clamp(max=dranks.shape[0] - 1)]
            qi = col & (~QUOTED_BIT & 0xFFFFFFFF)
            qr = qranks[qi.clamp(max=qranks.shape[0] - 1)]
            # one non-numeric value switches the WHOLE column to ranks
            vals = torch.where(col_nan, torch.where(isq, qr, dr), vals)
        keys.append(-vals if desc else vals)
    # lexsort: secondary keys first, primary last, then validity outermost
    # so invalid rows sink to the end
    for key in reversed(keys):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    vkey = (~valid).to(torch.int8)
    perm = perm[torch.sort(vkey[perm], stable=True).indices]
    top = perm[:k]
    return tuple(c[top] for c in cols), valid[top], valid.sum(), nan_seen


def try_device_execute_ordered(db, q) -> Optional[List[List[str]]]:
    """ORDER BY + LIMIT on the device: plan execution, top-k sort, O(limit)
    readback, formatted rows.  ``None`` when the shape is not expressible
    (the caller orders the full table on the host)."""
    from kolibrie_tpu_torch.optimizer.engine import resolve_pattern
    from kolibrie_tpu_torch.optimizer.planner import Streamertail, build_logical_plan
    from kolibrie_tpu_torch.query.executor import _clause_plans, format_results
    from kolibrie_tpu_torch.query.subquery_inline import inline_subqueries

    if q.limit is None or not q.order_by or q.distinct or q.group_by:
        return None
    if any(i.kind != "var" for i in q.select) and not q.select_all():
        return None
    w = inline_subqueries(q.where)
    if w.subqueries or w.binds or w.window_blocks or not w.patterns:
        return None
    # the host projects to the SELECT variables BEFORE ordering, so a sort
    # key outside the projection is a no-op there: leave those to it
    pattern_vars = {
        t.value
        for p in w.patterns
        for t in (p.subject, p.predicate, p.object)
        if t.kind == "var"
    }
    sel_vars = pattern_vars if q.select_all() else {i.var for i in q.select if i.kind == "var"}
    for cond in q.order_by:
        if (
            not isinstance(cond.expr, Var)
            or cond.expr.name not in pattern_vars
            or cond.expr.name not in sel_vars
        ):
            return None
    resolved = [resolve_pattern(db, p) for p in w.patterns]
    try:
        logical = build_logical_plan(resolved, list(w.filters), [], w.values)
        planner = Streamertail(db.get_or_build_stats())
        plan = planner.find_best_plan(logical)
        # UNION/OPTIONAL/MINUS/NOT fuse exactly as on the unordered path
        clauses = _clause_plans(db, planner, w)
        if clauses is None:
            return None
        union_groups, optional_plans, anti_plans = clauses
        lowered = lower_plan(db, plan, anti_plans, union_groups, optional_plans)
    except Unsupported:
        return None
    if not lowered.const_ok():
        return []  # a failed constant guard empties the result
    out_vars = lowered.out_vars
    if q.select_all():
        # ``*`` covers branch-bound vars too; internal vars stay hidden
        sel_vars = {v for v in out_vars if not v.startswith("__")}
    opos, descs = [], []
    for cond in q.order_by:
        if cond.expr.name not in out_vars:
            return None
        opos.append(out_vars.index(cond.expr.name))
        descs.append(bool(cond.descending))
    k = _round_cap((q.offset or 0) + q.limit, 8)
    numf_dev = device_numf(db)
    out_cols, valid = lowered.converge(lowered.run())
    # phase 1: numeric keys only, no host rank build
    top_cols, top_valid, _n, nan_seen = _order_limit(
        tuple(out_cols), valid, numf_dev, tuple(opos), tuple(descs), k
    )
    if bool(nan_seen):
        # phase 2: a key column holds non-numeric values — the global
        # string ranks (cached per store size), same device columns
        dranks, qranks = device_string_ranks(db)
        top_cols, top_valid, _n, _nan = _order_limit(
            tuple(out_cols), valid, numf_dev, tuple(opos), tuple(descs), k, dranks, qranks
        )
    keep = [j for j, v in enumerate(out_vars) if v in sel_vars]
    stacked = torch.stack([top_cols[j] for j in keep] + [top_valid.to(torch.int64)]).cpu().numpy()
    tv = stacked[-1].astype(bool)
    table: BindingTable = {
        out_vars[j]: stacked[i][tv].astype(np.uint32) for i, j in enumerate(keep)
    }
    rows = format_results(db, table, q)
    start = q.offset or 0
    return rows[start : start + q.limit]
