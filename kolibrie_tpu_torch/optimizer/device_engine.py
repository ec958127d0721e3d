"""Device execution of physical plans on PyTorch tensors.

Port of ``kolibrie_tpu/optimizer/device_engine.py`` for SPARQL SELECT over
basic graph patterns and FILTERs.  A physical plan from
:mod:`kolibrie_tpu_torch.optimizer.planner` is lowered to a tree of frozen
spec nodes and evaluated by :func:`_plan_body` over the store's
device-resident sorted orders (:meth:`ColumnarTripleStore.device_segment`):

- scans are windows over the frozen base order (tombstones masked) merged
  by rank with a window over the small delta order;
- joins are the merge-path kernel — :func:`merge_join_indices` when the
  right side's scan order presents the single key column sorted,
  :func:`ranked_merge_join_indices` (dense-rank prepass) otherwise;
- FILTERs are per-ID mask gathers, ID compares and numeric compares;
- cyclic BGPs run the worst-case-optimal join node, one variable per
  level, with the ``lex_probe_select``/``lex_probe_validate`` kernels.

The reference compiles the tree into one XLA program; here it runs eagerly,
one PyTorch op (or kernel) at a time.  What stays the same is the
capacity protocol: every join and WCOJ level runs at a capacity, reports
its exact match count, and :meth:`LoweredPlan.converge` re-runs with
doubled capacities until every count fits — so counts, capacities and the
per-operator stats keys (``scan{i}``, ``join{i}``, ``filter{i}``,
``wcoj{i}:cand/:dedup/:live``) agree with the reference one for one.

Shapes the slice does not lower (quoted-triple patterns, VALUES, UNION,
OPTIONAL, MINUS, cartesian joins, non-constant string patterns, UDFs)
raise :class:`Unsupported`.
"""

from __future__ import annotations

from dataclasses import dataclass
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
    "try_device_execute",
    "template_scan_cap",
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
class JoinSpec:
    left: object
    right: object
    key_vars: tuple  # shared variable names
    join_idx: int  # into the capacity table / counts output
    cap: int
    rsorted: bool = False  # right key column pre-sorted by its scan order


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


def _plan_body(spec: PlanSpec, order_arrays, scalars, masks, numf, uparams, fparams):
    """Evaluate the spec tree.  Returns ``(out_cols, valid, counts,
    stats)``: device tensors of length = the root's capacity, the exact
    per-join / per-WCOJ-level match counts (0-dim tensors, indexed by
    ``join_idx`` order of evaluation) and the per-operator row counts."""
    counts: List[torch.Tensor] = []
    # EXPLAIN ANALYZE operator stats: key -> device scalar.  Indexed nodes
    # use their plan index (scan3, join0, wcoj2:cand/:dedup/:live); filters
    # use a PRE-ORDER occurrence counter assigned at node entry.
    stats: Dict[str, torch.Tensor] = {}
    seq = {"filter": 0}

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
            lc = [lcols[v] for v in node.key_vars]
            rc = [rcols[v] for v in node.key_vars]
            if len(node.key_vars) > 2:
                # 3+ shared variables: union dense-rank composition
                lkey, rkey = pack_key_multi(lc, rc, lvalid, rvalid)
            else:
                lkey = _pack_key(lc, lvalid, _LPAD)
                rkey = _pack_key(rc, rvalid, _RPAD)
            li, ri, valid, total = ranked_merge_join_indices(lkey, rkey, node.cap)
        counts.append(total)
        stats[f"join{node.join_idx}"] = valid.sum()
        out = {v: torch.where(valid, c[li], 0) for v, c in lcols.items()}
        for v, c in rcols.items():
            if v not in out:
                out[v] = torch.where(valid, c[ri], 0)
        return out, valid, total

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

    def eval_node(node):
        if isinstance(node, ScanSpec):
            return eval_scan(node)
        if isinstance(node, JoinSpec):
            return eval_join(node)
        if isinstance(node, FilterSpec):
            return eval_filter(node)
        if isinstance(node, WcojSpec):
            return eval_wcoj(node)
        raise TypeError(f"unknown plan spec node {node!r}")

    scalars_device = order_arrays[0][2].device
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

    def __init__(self, db, plan):
        self.db = db
        self.device = db.device
        self.scan_descs: List[tuple] = []  # (order_name, (cs, cp, co)) per scan
        self.mask_arrays: List[np.ndarray] = []
        self.mask_exprs: List[tuple] = []
        self._mask_keys: Dict[tuple, int] = {}
        self._mask_dict_len: tuple = (0, 0)
        self.order_names: List[str] = []
        self._order_idx: Dict[str, int] = {}
        self.join_count = 0
        self.need_numf = False
        # query constants: one slot per syntactic constant site, traversal
        # order (the reference's parameter-vector ABI)
        self.u_params: List[int] = []  # u32 term-id constants
        self.f_params: List[float] = []  # f64 numeric comparands
        # fully-constant patterns: hoisted out of the join tree as host
        # membership guards — a failed guard empties the whole result
        self.const_checks: List[tuple] = []
        self.root, vars_ = self._lower(plan)
        if self.root is None:
            raise Unsupported("constant-only query")
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
            elif isinstance(node, JoinSpec):
                collect(node.left)
                collect(node.right)
            elif isinstance(node, FilterSpec):
                collect(node.child)
            elif isinstance(node, WcojSpec):
                for lv in node.levels:
                    for a in lv.accessors:
                        if a.order_idx not in used:
                            used.append(a.order_idx)

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
                return ScanSpec(
                    remap[node.order_idx],
                    node.scan_idx,
                    node.out_vars,
                    node.eq_pairs,
                    node.cap,
                    node.key_pos,
                )
            if isinstance(node, JoinSpec):
                return JoinSpec(
                    rebuild(node.left),
                    rebuild(node.right),
                    node.key_vars,
                    node.join_idx,
                    node.cap,
                    node.rsorted,
                )
            if isinstance(node, FilterSpec):
                return FilterSpec(rebuild(node.child), node.expr)
            if isinstance(node, WcojSpec):
                return WcojSpec(
                    tuple(
                        WcojLevel(
                            lv.var,
                            lv.join_idx,
                            lv.cap,
                            tuple(
                                WcojAccessor(
                                    remap[a.order_idx],
                                    a.key_srcs,
                                    a.key_pos,
                                    a.val_pos,
                                )
                                for a in lv.accessors
                            ),
                        )
                        for lv in node.levels
                    )
                )
            return node

        self.root = rebuild(self.root)

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
            raise Unsupported("VALUES")
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
        for t in terms:
            if t.kind == "id":
                # a constant not in the dictionary can never match: keep the
                # scan and let _scan_ranges emit an empty (lo, 0) range
                consts.append(-1 if t.value is None else int(t.value))
            elif t.kind == "var":
                consts.append(None)
            else:
                raise Unsupported("quoted-triple pattern")
        bound = frozenset(i for i, c in enumerate(consts) if c is not None)
        order_name = self._DEFAULT_ORDER[bound]
        order_idx = self._order(order_name)
        scan_idx = len(self.scan_descs)
        self.scan_descs.append((order_name, tuple(consts)))
        out_vars: List[tuple] = []
        eq_pairs: List[tuple] = []
        seen: Dict[str, int] = {}
        for pos, t in enumerate(terms):
            if t.kind != "var":
                continue
            if t.value in seen:
                eq_pairs.append((seen[t.value], pos))
            else:
                seen[t.value] = pos
                out_vars.append((t.value, pos))
        node = ScanSpec(
            order_idx,
            scan_idx,
            tuple(out_vars),
            tuple(eq_pairs),
            0,
            self._merge_key_pos(order_name, len(bound)),
        )
        return node, set(seen)

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
        """Host searchsorted over the base + delta sorted orders →
        ``(lo_base, n_base, lo_delta, n_delta)`` rows.  The base window
        INCLUDES deleted rows (the tombstone positions mask them)."""
        store = self.db.store
        pos_of = {"s": 0, "p": 1, "o": 2}
        out = np.zeros((max(len(self.scan_descs), 1), 4), dtype=np.int64)
        for i, (order_name, consts) in enumerate(self.scan_descs):
            segments = (store.base_order(order_name), store.delta_order(order_name))
            for j, order in enumerate(segments):
                keys = [
                    consts[pos_of[c]]
                    for c in order.perm
                    if consts[pos_of[c]] is not None
                ]
                if any(k < 0 for k in keys):
                    continue  # unknown constant: (0, 0) — matches nothing
                if not keys:
                    lo, hi = 0, len(order)
                elif len(keys) == 1:
                    lo, hi = order.range0(keys[0])
                else:
                    lo, hi = order.range01(keys[0], keys[1])
                out[i, 2 * j] = lo
                out[i, 2 * j + 1] = hi - lo
        return out

    def _with_caps(self, node, scan_caps: Dict[int, int], join_caps: List[int]):
        if isinstance(node, ScanSpec):
            return ScanSpec(
                node.order_idx,
                node.scan_idx,
                node.out_vars,
                node.eq_pairs,
                scan_caps[node.scan_idx],
                node.key_pos,
            )
        if isinstance(node, JoinSpec):
            return JoinSpec(
                self._with_caps(node.left, scan_caps, join_caps),
                self._with_caps(node.right, scan_caps, join_caps),
                node.key_vars,
                node.join_idx,
                join_caps[node.join_idx],
                node.rsorted,
            )
        if isinstance(node, FilterSpec):
            return FilterSpec(self._with_caps(node.child, scan_caps, join_caps), node.expr)
        if isinstance(node, WcojSpec):
            return WcojSpec(
                tuple(
                    WcojLevel(lv.var, lv.join_idx, join_caps[lv.join_idx], lv.accessors)
                    for lv in node.levels
                )
            )
        return node

    def _node_cap(self, node, scan_caps, join_caps) -> int:
        if isinstance(node, ScanSpec):
            return scan_caps[node.scan_idx]
        if isinstance(node, JoinSpec):
            return join_caps[node.join_idx]
        if isinstance(node, FilterSpec):
            return self._node_cap(node.child, scan_caps, join_caps)
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
            if isinstance(node, FilterSpec):
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
        if self.need_numf:
            numf = device_numf(self.db)
        else:
            numf = torch.zeros(1, dtype=torch.float64, device=self.device)
        return spec, (order_arrays, self._scan_ranges_np, masks, numf)

    # ------------------------------------------------------------ execution

    def run(self):
        """One evaluation at the current capacities.  Returns (out_cols,
        valid, counts, stats) — all device-resident."""
        spec, (order_arrays, scalars, masks, numf) = self.build()
        return _plan_body(
            spec, order_arrays, scalars, masks, numf, self.u_params, self.f_params
        )

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


def lower_plan(db, plan) -> LoweredPlan:
    return LoweredPlan(db, plan)


def try_device_execute(db, plan) -> BindingTable:
    """Lower and run ``plan`` on the database's device.  Raises
    :class:`Unsupported` for shapes this slice does not lower."""
    return lower_plan(db, plan).execute()
