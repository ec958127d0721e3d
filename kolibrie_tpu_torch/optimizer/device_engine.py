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

The repeated-query layer sits on top:

- :meth:`LoweredPlan.host_execute` is the numpy twin of the whole spec
  tree (the oracle, EXPLAIN's exact counts and
  :meth:`~LoweredPlan.calibrate_host`); :meth:`~LoweredPlan.describe`
  renders the plan for EXPLAIN;
- :class:`PreparedQuery` plans and lowers a SELECT once; ``run`` and
  ``run_k`` enqueue plan bodies without reading anything back
  (:func:`fetch_counters` counts every device→host read);
- :func:`execute_plan_batch` runs the constant-variants of one template
  back to back at the shared template capacities with one readback of
  every member's counts per attempt;
- :meth:`LoweredPlan.execute` routes MQO's shared prefix first
  (``optimizer/mqo.py``), then the plan-bytecode interpreter
  (``optimizer/plan_interp.py``), then the specialized spec tree, and
  records which in ``last_source``;
- converged counts feed the capacity advisor (``query/template.py``) and
  the stats advisor (``optimizer/stats_advisor.py``).

:func:`device_compile_stats` keeps the reference's per-entry compile
counters: with no compiled executables in eager PyTorch, each counts the
distinct spec trees that entry has run in this process (what one jit
cache entry is in the reference).
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kolibrie_tpu_torch.backend import SENT, _LPAD, _RPAD, key1, pack2
from kolibrie_tpu_torch.core.dictionary import QUOTED_BIT
from kolibrie_tpu_torch.core.store import ColumnarTripleStore
from kolibrie_tpu_torch.ops import round_cap as _round_cap
from kolibrie_tpu_torch.ops.device_join import pack_key_multi
from kolibrie_tpu_torch.ops.join import (
    UNBOUND,
    BindingTable,
    _pack_shared_keys,
    anti_join_tables,
)
from kolibrie_tpu_torch.ops.join import join_indices as host_join_indices
from kolibrie_tpu_torch.ops.kernels import (
    lex_probe_select,
    lex_probe_validate,
    merge_join_indices,
    ranked_merge_join_indices,
)
from kolibrie_tpu_torch.ops.wcoj import host_lex_range, lex_range
from kolibrie_tpu_torch.obs import analyze as _analyze
from kolibrie_tpu_torch.obs import metrics as _obs_metrics
from kolibrie_tpu_torch.obs.spans import get_baggage as _get_baggage
from kolibrie_tpu_torch.obs.spans import span as _obs_span
from kolibrie_tpu_torch.optimizer import plan as P
from kolibrie_tpu_torch.optimizer import stats_advisor as _sa
from kolibrie_tpu_torch.optimizer.engine import strip_literal
from kolibrie_tpu_torch.resilience.deadline import check_deadline
from kolibrie_tpu_torch.resilience.faultinject import fault_point
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
    "PreparedQuery",
    "execute_plan_batch",
    "device_compile_stats",
    "fetch_counters",
    "clause_replayable",
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


# Per-template device phase timings.  The template label is the plan
# template fingerprint carried in trace baggage by the executor —
# bounded upstream by the template cache, so cardinality is safe.
_LOWER_LAT = _obs_metrics.histogram(
    "kolibrie_device_lower_seconds",
    "plan lowering (spec assembly) time by template",
    labels=("template",),
)
_DISPATCH_LAT = _obs_metrics.histogram(
    "kolibrie_device_dispatch_seconds",
    "device dispatch + convergence time by template",
    labels=("template",),
)
_COLLECT_LAT = _obs_metrics.histogram(
    "kolibrie_device_collect_seconds",
    "device→host result materialization time",
)
_DEVICE_BATCH_SIZE = _obs_metrics.histogram(
    "kolibrie_device_batch_size",
    "members per batched dispatch",
    buckets=_obs_metrics.DEFAULT_COUNT_BUCKETS,
)
# Worst-case-optimal join instrumentation (emitted once per converged
# execution, from the host-read counts — no extra device traffic)
_WCOJ_LEVEL_ROWS = _obs_metrics.histogram(
    "kolibrie_wcoj_level_rows",
    "intermediate rows per WCOJ elimination level (exact, post-converge)",
    buckets=_obs_metrics.DEFAULT_COUNT_BUCKETS,
)
_WCOJ_CAP_OCCUPANCY = _obs_metrics.histogram(
    "kolibrie_wcoj_cap_occupancy",
    "rows/capacity ratio per WCOJ level (cap headroom health)",
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0),
)
_WCOJ_PROBES = _obs_metrics.counter(
    "kolibrie_wcoj_probes_total",
    "candidate existence probes issued by WCOJ levels (cap x accessors)",
)


# Device→host readback audit: every place the engine forces a transfer
# calls _note_fetch, so a test can pin the exact per-execute fetch count
# and show that ``PreparedQuery.run`` / ``run_k`` read nothing back.
_FETCHES: Dict[str, int] = {}


def _note_fetch(site: str) -> None:
    _FETCHES[site] = _FETCHES.get(site, 0) + 1


def fetch_counters() -> Dict[str, int]:
    return dict(_FETCHES)


# The reference's jit entry points, each keyed on the static PlanSpec:
# here the distinct specs each entry has run in this process.
_SPECS_RUN: Dict[str, set] = {"run_plan": set(), "run_plan_k": set(), "run_plan_batch": set()}


def _note_spec(entry: str, spec) -> None:
    _SPECS_RUN[entry].add(spec)


def device_compile_stats() -> Dict[str, int]:
    """Per-entry-point compile counters under the reference's keys: the
    distinct spec trees ``run_plan``, ``run_plan_k`` and
    ``run_plan_batch`` have run in this process, and the interpreter's
    distinct size classes (``run_interp``).  A constant variant of a
    template runs the same spec, so it adds nothing."""
    from kolibrie_tpu_torch.optimizer.plan_interp import interp_compile_stats

    out = {name: len(specs) for name, specs in _SPECS_RUN.items()}
    out["run_interp"] = interp_compile_stats()
    return out


def _classify_source(specs_before: int) -> str:
    """Classify a specialized dispatch after the fact: ``disk`` when it
    ran a spec new to this process and every kernel library the process
    loaded came from an existing build in the enabled compile cache;
    otherwise (a kernel built by ``nvcc`` here, or a spec run before)
    ``compiled``."""
    from kolibrie_tpu_torch.query.compile_cache import counters, enabled_dir

    if len(_SPECS_RUN["run_plan"]) <= specs_before or enabled_dir() is None:
        return "compiled"
    cc = counters()
    return "disk" if cc["hits"] > 0 and cc["misses"] == 0 else "compiled"


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
    spec: PlanSpec, order_arrays, scalars, masks, values, numf, quoted, uparams, fparams,
    carry=None,
):
    """Evaluate the spec tree.  Returns ``(out_cols, valid, counts,
    stats)``: device tensors of length = the root's capacity, the exact
    per-join / per-WCOJ-level match counts (0-dim tensors, indexed by
    ``join_idx`` order of evaluation) and the per-operator row counts.
    ``carry`` (a 0-dim device tensor, 0 at run time) is added to every
    scan's range scalars: ``run_k``'s loop-carried dependency."""
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
        if carry is not None:
            lo_b, n_b, lo_d, n_d = (lo_b + carry, n_b + carry, lo_d + carry, n_d + carry)
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
        # stats-advisor bookkeeping: canonical pattern sig per scan_idx,
        # and per-WCOJ-group (level keys, covered-sig multiset) — recorded
        # at lowering so observed counts can be keyed plan-shape-
        # independently (optimizer/stats_advisor.py)
        self.scan_sigs: List[str] = []
        self.wcoj_level_keys: List[tuple] = []  # (advisor_key, join_idx)
        self.wcoj_sig_groups: List[tuple] = []  # (sig tuple, last join_idx)
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
        # pre-actuals worthiness signal for the MQO layer: the planner's
        # leaf-scan cardinality bound (optimizer/mqo.py)
        from kolibrie_tpu_torch.optimizer.planner import estimated_prefix_rows

        self.est_prefix_rows = estimated_prefix_rows(plan)

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
        self.scan_sigs.append(_sa.pattern_sig(pattern))
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
            self.wcoj_level_keys.append((f"wcoj:?{var}", self.join_count))
            self.join_count += 1
            eliminated.add(var)
        # the last level's live count IS the output of joining exactly
        # this pattern group — the same quantity any Volcano tree over
        # the group would produce, hence the shared subset key
        self.wcoj_sig_groups.append(
            (tuple(_sa.pattern_sig(s.pattern) for s in op.scans), levels[-1].join_idx)
        )
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
        # db-cache miss (fresh db, or the cap_key moved because store
        # growth changed a scan cap bucket): seed from the process-wide
        # advisor's high-water mark for this template.  The baggage
        # fingerprint is "unknown" for direct engine construction (tests,
        # EXPLAIN) — skipped, so unrelated callers never cross-pollinate.
        from kolibrie_tpu_torch.query.template import cap_advisor

        fp = _get_baggage("template", "unknown")
        if fp != "unknown":
            advised = cap_advisor.advise("device", fp)
            if advised is not None and len(advised) == len(caps):
                caps = [max(c, a) for c, a in zip(caps, advised)]
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

    # ------------------------------------------------------- host evaluation

    def _host_scan_ranges(self) -> np.ndarray:
        """``(lo, n)`` rows over the LIVE sorted orders — the
        host-evaluation twin of :meth:`_scan_ranges` (host consumers never
        see the base/delta split)."""
        store = self.db.store
        pos_of = {"s": 0, "p": 1, "o": 2}
        out = np.zeros((max(len(self.scan_descs), 1), 2), dtype=np.int64)
        for i, (order_name, consts) in enumerate(self.scan_descs):
            order = store.order(order_name)
            keys = [consts[pos_of[c]] for c in order.perm if consts[pos_of[c]] is not None]
            if any(k < 0 for k in keys):
                continue  # unknown constant: (0, 0) — matches nothing
            if not keys:
                lo, hi = 0, len(order)
            elif len(keys) == 1:
                lo, hi = order.range0(keys[0])
            else:
                lo, hi = order.range01(keys[0], keys[1])
            out[i] = (lo, hi - lo)
        return out

    def host_execute(self) -> Tuple[BindingTable, List[int]]:
        """Evaluate the spec tree with numpy — the device-free reference
        semantics.  Returns (table, exact join counts): the counts set
        capacities without a device readback (:meth:`calibrate_host`), and
        the table is the oracle of the spec-semantics tests.  Per-operator
        row counts land in ``last_host_stats`` under the device stats'
        keys."""
        if not self.const_ok():
            self.last_host_stats = {}
            return self.empty_table(), [0] * self.join_count
        self._refresh_masks()
        scan_ranges = self._host_scan_ranges()
        numf = self.db.numeric_values() if self.need_numf else None
        counts: List[int] = [0] * self.join_count
        # numpy twin of _plan_body's analyze stats: same keys, same
        # pre-order sequence numbering for index-less nodes
        hstats: Dict[str, int] = {}
        hseq = {"filter": 0, "anti": 0, "union": 0, "quoted": 0}
        np_ops = {
            "=": np.equal,
            "!=": np.not_equal,
            "<": np.less,
            "<=": np.less_equal,
            ">": np.greater,
            ">=": np.greater_equal,
        }

        def eval_expr(expr, cols) -> np.ndarray:
            if isinstance(expr, MaskRef):
                m = self.mask_arrays[expr.mask_idx]
                return m[np.minimum(cols[expr.var], len(m) - 1)]
            if isinstance(expr, StrMaskRef):
                ids = cols[expr.var]
                dm = self.mask_arrays[expr.dict_idx]
                qm = self.mask_arrays[expr.quoted_idx]
                isq = (ids & np.uint32(QUOTED_BIT)) != 0
                dv = dm[np.minimum(ids, len(dm) - 1)]
                qidx = ids & np.uint32(~QUOTED_BIT & 0xFFFFFFFF)
                qv = qm[np.minimum(qidx, len(qm) - 1)]
                return np.where(isq, qv, dv)
            if isinstance(expr, QuotedCheck):
                return (cols[expr.var] & np.uint32(QUOTED_BIT)) != 0
            if isinstance(expr, IdCmp):
                eq = cols[expr.var] == np.uint32(self.u_params[expr.param_idx])
                return eq if expr.op == "=" else ~eq
            if isinstance(expr, NumConstCmp):
                vals = numf[np.minimum(cols[expr.var], len(numf) - 1)]
                with np.errstate(invalid="ignore"):
                    res = np_ops[expr.op](vals, self.f_params[expr.param_idx])
                return res & ~np.isnan(vals)
            if isinstance(expr, NumCmp):
                a = numf[np.minimum(cols[expr.lvar], len(numf) - 1)]
                b = numf[np.minimum(cols[expr.rvar], len(numf) - 1)]
                ok = ~(np.isnan(a) | np.isnan(b))
                with np.errstate(invalid="ignore"):
                    res = np_ops[expr.op](a, b)
                if expr.op in ("=", "!="):
                    ideq = cols[expr.lvar] == cols[expr.rvar]
                    idres = ideq if expr.op == "=" else ~ideq
                    return np.where(ok, res, idres)
                return res & ok
            if isinstance(expr, BoolNode):
                if expr.kind == "not":
                    return ~eval_expr(expr.args[0], cols)
                m = eval_expr(expr.args[0], cols)
                for a in expr.args[1:]:
                    m2 = eval_expr(a, cols)
                    m = (m & m2) if expr.kind == "and" else (m | m2)
                return m
            raise TypeError(expr)

        def eval_scan(node):
            order_name, _consts = self.scan_descs[node.scan_idx]
            order = self.db.store.order(order_name)
            lo, n = (int(x) for x in scan_ranges[node.scan_idx])
            canon = order.slice_rows(lo, lo + n)
            raw = {0: canon["s"], 1: canon["p"], 2: canon["o"]}
            mask = None
            for a, b in node.eq_pairs:
                m = raw[a] == raw[b]
                mask = m if mask is None else (mask & m)
            cols = {var: raw[pos] for var, pos in node.out_vars}
            if mask is not None:
                cols = {k: v[mask] for k, v in cols.items()}
            hstats[f"scan{node.scan_idx}"] = int(mask.sum()) if mask is not None else n
            return cols

        def eval_values(node):
            hstats[f"values{node.values_idx}"] = node.n
            return {
                v: self.values_tables[node.values_idx][i].astype(np.uint32)
                for i, v in enumerate(node.vars)
            }

        def eval_join(node):
            lcols = eval_node(node.left)
            rcols = eval_node(node.right)
            lkey, rkey = _pack_shared_keys(
                lcols, rcols, list(node.key_vars), len(next(iter(lcols.values())))
            )
            li, ri = host_join_indices(lkey, rkey)
            counts[node.join_idx] = len(li)
            hstats[f"join{node.join_idx}"] = len(li)
            out = {v: c[li] for v, c in lcols.items()}
            for v, c in rcols.items():
                if v not in out:
                    out[v] = c[ri]
            return out

        def eval_filter(node):
            skey = f"filter{hseq['filter']}"
            hseq["filter"] += 1
            cols = eval_node(node.child)
            mask = eval_expr(node.expr, cols)
            hstats[skey] = int(mask.sum())
            return {k: v[mask] for k, v in cols.items()}

        def eval_quoted(node):
            skey = f"quoted{hseq['quoted']}"
            hseq["quoted"] += 1
            cols = eval_node(node.child)
            qcol = cols.pop(node.qvar)
            qid, qs_, qp_, qo_ = host_quoted_table(self.db)
            posc = np.minimum(np.searchsorted(qid, qcol), len(qid) - 1)
            mask = (qid[posc] == qcol) & ((qcol & QUOTED_BIT) != 0)
            inner = [c[posc].astype(np.uint32) for c in (qs_, qp_, qo_)]
            for ipos, pidx in node.const_checks:
                mask = mask & (inner[ipos] == np.uint32(self.u_params[pidx]))
            for var, ipos in node.out_vars:
                cols[var] = inner[ipos]
            for ipos, var in node.eq_checks:
                mask = mask & (inner[ipos] == cols[var])
            hstats[skey] = int(mask.sum())
            return {k: v[mask] for k, v in cols.items()}

        def eval_anti(node):
            skey = f"anti{hseq['anti']}"
            hseq["anti"] += 1
            lcols = eval_node(node.left)
            rcols = eval_node(node.right)
            out = anti_join_tables(lcols, rcols)
            hstats[skey] = len(next(iter(out.values()), ()))
            return out

        def eval_union(node):
            skey = f"union{hseq['union']}"
            hseq["union"] += 1
            parts = [eval_node(ch) for ch in node.children]
            out = {}
            for v in node.vars:
                segs = []
                for ccols in parts:
                    if v in ccols:
                        segs.append(ccols[v])
                    else:
                        n = len(next(iter(ccols.values()), np.empty(0)))
                        segs.append(np.zeros(n, dtype=np.uint32))
                out[v] = np.concatenate(segs) if segs else np.empty(0, np.uint32)
            hstats[skey] = len(next(iter(out.values()), ()))
            return out

        def eval_left_outer(node):
            lcols = eval_node(node.left)
            rcols = eval_node(node.right)
            ln = len(next(iter(lcols.values())))
            rn = len(next(iter(rcols.values())))
            if ln == 0 or rn == 0:
                counts[node.join_idx] = 0
                hstats[f"optional{node.join_idx}"] = ln
                out = {k: v.copy() for k, v in lcols.items()}
                for k in rcols:
                    if k not in out:
                        out[k] = np.zeros(ln, dtype=np.uint32)
                return out
            lkey, rkey = _pack_shared_keys(lcols, rcols, list(node.key_vars), ln)
            li, ri = host_join_indices(lkey, rkey)
            counts[node.join_idx] = len(li)
            matched = np.zeros(ln, dtype=bool)
            matched[li] = True
            unmatched = np.nonzero(~matched)[0]
            hstats[f"optional{node.join_idx}"] = len(li) + len(unmatched)
            out = {k: np.concatenate([col[li], col[unmatched]]) for k, col in lcols.items()}
            for k, col in rcols.items():
                if k not in out:
                    out[k] = np.concatenate([col[ri], np.zeros(len(unmatched), dtype=np.uint32)])
            return out

        def eval_wcoj(node) -> Dict[str, np.ndarray]:
            """Numpy twin of the device WCOJ levels: the RAW-count math bit
            for bit (tombstoned and duplicate rows included in the
            candidate counts), so ``counts`` calibrates device capacities
            exactly; rows compress to the valid set after each level."""
            store = self.db.store
            sent = np.uint32(SENT)
            pos_of = {"s": 0, "p": 1, "o": 2}
            seg_cache: Dict[int, tuple] = {}

            def seg(order_idx):
                cached = seg_cache.get(order_idx)
                if cached is None:
                    name = self.order_names[order_idx]
                    bo = store.base_order(name)
                    do = store.delta_order(name)
                    bcanon = [None, None, None]
                    dcanon = [None, None, None]
                    for j, c in enumerate(bo.perm):
                        bcanon[pos_of[c]] = (bo.c0, bo.c1, bo.c2)[j]
                        dcanon[pos_of[c]] = (do.c0, do.c1, do.c2)[j]
                    cached = seg_cache[order_idx] = (
                        bcanon, dcanon, store.delta_del_positions(name)
                    )
                return cached

            cols: Dict[str, np.ndarray] = {}
            nrows = 1
            for lv in node.levels:
                per = []
                for a in lv.accessors:
                    bcanon, dcanon, dp = seg(a.order_idx)
                    keys = []
                    ksent = np.zeros(nrows, dtype=bool)
                    for src in a.key_srcs:
                        if src[0] == "u":
                            k = np.full(nrows, self.u_params[src[1]], dtype=np.uint32)
                        else:
                            k = cols[src[1]]
                        ksent |= k == sent
                        keys.append(k)
                    if keys:
                        bl, bh = host_lex_range([bcanon[p] for p in a.key_pos], keys)
                        dl, dh = host_lex_range([dcanon[p] for p in a.key_pos], keys)
                    else:
                        bl = np.zeros(nrows, dtype=np.int64)
                        dl = np.zeros(nrows, dtype=np.int64)
                        bh = np.full(nrows, len(bcanon[a.val_pos]), dtype=np.int64)
                        dh = np.full(nrows, len(dcanon[a.val_pos]), dtype=np.int64)
                    cnt = np.where(ksent, 0, (bh - bl) + (dh - dl))
                    per.append((a, bcanon, dcanon, dp, keys, ksent, bl, bh, dl, cnt))
                cntm = np.stack([p[-1] for p in per])
                choice = np.argmin(cntm, axis=0)
                cnt = np.min(cntm, axis=0)
                total = int(cnt.sum())
                counts[lv.join_idx] = total
                hstats[f"wcoj{lv.join_idx}:cand"] = total
                rows = np.repeat(np.arange(nrows), cnt)
                kk = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(cnt) - cnt, cnt)
                ch = choice[rows]
                val = np.zeros(total, dtype=np.uint32)
                first = np.zeros(total, dtype=bool)
                is_base = np.zeros(total, dtype=bool)
                for ai, (a, bcanon, dcanon, _dp, _k, _s, bl, bh, dl, _c) in enumerate(per):
                    m = ch == ai
                    if not m.any():
                        continue
                    bv = bcanon[a.val_pos]
                    dv = dcanon[a.val_pos]
                    rm, km = rows[m], kk[m]
                    nb = bh[rm] - bl[rm]
                    isb = km < nb
                    if len(bv):
                        bidx = np.clip(bl[rm] + km, 0, len(bv) - 1)
                        bval = bv[bidx]
                        bprev = bv[np.clip(bidx - 1, 0, len(bv) - 1)]
                    else:
                        bval = bprev = np.zeros(len(km), dtype=np.uint32)
                    if len(dv):
                        didx = np.clip(dl[rm] + (km - nb), 0, len(dv) - 1)
                        dval = dv[didx]
                        dprev = dv[np.clip(didx - 1, 0, len(dv) - 1)]
                    else:
                        dval = dprev = np.zeros(len(km), dtype=np.uint32)
                    val[m] = np.where(isb, bval, dval)
                    first[m] = np.where(
                        isb, (km == 0) | (bprev != bval), (km == nb) | (dprev != dval)
                    )
                    is_base[m] = isb
                vvalid = first
                # host rows are exact-length (no padding in range), so the
                # device's sentinel test is implied and first alone counts
                hstats[f"wcoj{lv.join_idx}:dedup"] = int(first.sum())
                braw_ch = np.zeros(total, dtype=bool)
                for ai, (a, bcanon, dcanon, dp, keys, ksent, *_r) in enumerate(per):
                    fkeys = [k[rows] for k in keys] + [val]
                    fl, fh = host_lex_range(
                        [bcanon[p] for p in a.key_pos] + [bcanon[a.val_pos]], fkeys
                    )
                    dl2, dh2 = host_lex_range(
                        [dcanon[p] for p in a.key_pos] + [dcanon[a.val_pos]], fkeys
                    )
                    tl = np.searchsorted(dp, fl.astype(np.uint32))
                    th = np.searchsorted(dp, fh.astype(np.uint32))
                    live = ((fh - fl) - (th - tl) + (dh2 - dl2)) > 0
                    vvalid = vvalid & live & ~ksent[rows]
                    braw_ch = np.where(ch == ai, (fh - fl) > 0, braw_ch)
                vvalid = vvalid & (is_base | ~braw_ch)
                cols = {v: c[rows][vvalid] for v, c in cols.items()}
                cols[lv.var] = val[vvalid]
                nrows = int(vvalid.sum())
                hstats[f"wcoj{lv.join_idx}:live"] = nrows
            return cols

        evaluators = {
            ScanSpec: eval_scan,
            ValuesSpec: eval_values,
            JoinSpec: eval_join,
            FilterSpec: eval_filter,
            QuotedExpandSpec: eval_quoted,
            AntiJoinSpec: eval_anti,
            UnionSpec: eval_union,
            LeftOuterSpec: eval_left_outer,
            WcojSpec: eval_wcoj,
        }

        def eval_node(node) -> Dict[str, np.ndarray]:
            fn = evaluators.get(type(node))
            if fn is None:
                raise TypeError(node)
            return fn(node)

        table = eval_node(self.root)
        self.last_host_stats = hstats
        return table, counts

    def calibrate_host(self) -> List[int]:
        """Set exact join capacities from a host evaluation (no device
        I/O); returns the exact per-join match counts (EXPLAIN annotates
        with them)."""
        self._scan_ranges_np = self._scan_ranges()
        _table, counts = self.host_execute()
        self._join_caps = [_round_cap(c) for c in counts]
        self._store_caps()
        self._join_caps = list(self.db.__dict__["_device_cap_cache"][self.cap_key])
        # calibration counts are EXACT per-join match counts: feed the
        # stats advisor before the first dispatch so a misrouted cold
        # template can already replan on its second execution
        self._advise(counts)
        return counts

    # ------------------------------------------------------------ execution

    def run(self):
        """One evaluation at the current capacities, enqueued with no
        readback.  Returns (out_cols, valid, counts, stats) — all
        device-resident."""
        spec, operands = self.build()
        _note_spec("run_plan", spec)
        return _plan_body(spec, *operands, self.u_params, self.f_params)

    def run_k(self, k: int):
        """``k`` evaluations of the same plan body with a loop-carried
        dependency (each iteration's scan ranges add the previous row count
        shifted right by 62, which is 0).  Returns per-iteration
        (checksums, row counts) as device tensors, no readback.  A checksum
        is the sum of the output columns' int64 carriers: it wraps modulo
        2^64 as the reference's ``uint64`` sum does."""
        spec, operands = self.build()
        _note_spec("run_plan_k", spec)
        carry = torch.zeros((), dtype=torch.int64, device=self.device)
        sums, rows = [], []
        for _ in range(k):
            out, valid, _counts, _stats = _plan_body(
                spec, *operands, self.u_params, self.f_params, carry=carry >> 62
            )
            checksum = torch.zeros((), dtype=torch.int64, device=self.device)
            for c in out:
                checksum = checksum + c.sum()
            carry = valid.sum()
            sums.append(checksum)
            rows.append(carry)
        if not sums:
            empty = torch.zeros(0, dtype=torch.int64, device=self.device)
            return empty, empty
        return torch.stack(sums), torch.stack(rows)

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
        ``(out_cols, valid)`` — the one readback of the counts is here.

        Every overflow retry and every converged capacity vector is fed to
        the process-wide :class:`~kolibrie_tpu_torch.query.template.CapAdvisor`
        under the current template fingerprint, so later engines for the
        same template start from the high-water mark."""
        from kolibrie_tpu_torch.query.template import cap_advisor

        fp = _get_baggage("template", "unknown")
        for _attempt in range(max_attempts):
            out_cols, valid, counts, stats = out
            self._last_stats = stats  # device-resident; fetched on demand
            counts_h = torch.stack(counts).tolist() if counts else []
            _note_fetch("converge.counts")
            overflow = [i for i, c in enumerate(counts_h) if c > self._join_caps[i]]
            if not overflow:
                self._last_counts = counts_h
                self._store_caps()
                self._emit_wcoj_obs(counts_h)
                self._advise(counts_h)
                if fp != "unknown":
                    cap_advisor.observe(
                        "device", fp, tuple(self._join_caps),
                        base_version=self.db.store.base_version,
                    )
                return out_cols, valid
            if fp != "unknown":
                cap_advisor.observe_retry("device", fp)
            for i in overflow:
                self._join_caps[i] = _round_cap(2 * counts_h[i])
            self._store_caps()
            out = self.run()
        raise RuntimeError("device plan capacities failed to converge")

    def _emit_wcoj_obs(self, counts_h: List[int]) -> None:
        """Per-level WCOJ instrumentation from the converged host-read
        counts: intermediate rows, cap occupancy, probe volume."""

        def walk(node):
            if isinstance(node, WcojSpec):
                for lv in node.levels:
                    if lv.join_idx >= len(counts_h):
                        continue
                    rows = counts_h[lv.join_idx]
                    cap = self._join_caps[lv.join_idx]
                    _WCOJ_LEVEL_ROWS.observe(rows)
                    if cap > 0:
                        _WCOJ_CAP_OCCUPANCY.observe(rows / cap)
                    _WCOJ_PROBES.inc(cap * len(lv.accessors))
            else:
                _map_children(node, walk)
            return node

        walk(self.root)

    def _advisor_sites(self) -> List[tuple]:
        """Observable operator sites for the stats advisor: a list of
        ``(source, idx, advisor_key, describe_key)`` where ``source`` is
        ``"scan"`` (rows read from :meth:`_host_scan_ranges` row ``idx``)
        or ``"count"`` (rows read from the converged counts at ``idx``).
        Advisor keys are plan-shape-independent (pattern-sig based); the
        describe keys match :meth:`describe`/``fetch_stats`` naming."""
        cached = getattr(self, "_advisor_sites_cache", None)
        if cached is not None:
            return cached
        sites: List[tuple] = []

        def sigs(node) -> Optional[List[str]]:
            if isinstance(node, ScanSpec):
                sig = self.scan_sigs[node.scan_idx]
                sites.append(("scan", node.scan_idx, "scan:" + sig, f"scan{node.scan_idx}"))
                return [sig]
            if isinstance(node, JoinSpec):
                left, right = sigs(node.left), sigs(node.right)
                if left is None or right is None:
                    return None
                got = left + right
                sites.append(("count", node.join_idx, _sa.subset_key(got), f"join{node.join_idx}"))
                return got
            if isinstance(node, (FilterSpec, QuotedExpandSpec)):
                # template-fixed transforms: the covered pattern group is
                # the child's
                return sigs(node.child)
            if isinstance(node, LeftOuterSpec):
                left, right = sigs(node.left), sigs(node.right)
                if left is not None and right is not None:
                    # the MATCHED part of a left-outer join is exactly the
                    # inner join of the covered groups
                    sites.append(("count", node.join_idx, _sa.subset_key(left + right),
                                  f"optional{node.join_idx}"))
                return None  # outer output != inner join of the leaves
            if isinstance(node, AntiJoinSpec):
                sigs(node.left)
                sigs(node.right)
                return None
            if isinstance(node, UnionSpec):
                for ch in node.children:
                    sigs(ch)
                return None
            return None  # VALUES / WCOJ (levels handled below)

        if self.root is not None:
            sigs(self.root)
        for akey, join_idx in self.wcoj_level_keys:
            sites.append(("count", join_idx, akey, f"wcoj{join_idx}:live"))
        for group, join_idx in self.wcoj_sig_groups:
            sites.append(("count", join_idx, _sa.subset_key(list(group)), f"wcoj{join_idx}:live"))
        self._advisor_sites_cache = sites
        return sites

    def advisor_actuals(self, counts_h: List[int]) -> Dict[str, float]:
        """Per-operator actual rows from one converged execution, keyed
        plan-shape-independently.  Every input is already host-resident
        (``converge`` read the counts; scan ranges are host binary
        searches): feeding the advisor adds no device I/O."""
        actuals: Dict[str, float] = {}
        scan_rows = self._host_scan_ranges()
        for source, idx, akey, _dkey in self._advisor_sites():
            if source == "scan":
                if idx < len(scan_rows):
                    actuals[akey] = float(scan_rows[idx][1])
            elif idx < len(counts_h):
                actuals[akey] = float(counts_h[idx])
        return actuals

    def _advise(self, counts_h: Optional[List[int]], rows: Optional[int] = None) -> None:
        """Feed the stats advisor (``KOLIBRIE_STATS_ADVISOR=auto``) from one
        execution's host-resident numbers; no-op when the advisor is off or
        no template fingerprint is in flight."""
        if _sa.stats_advisor_mode() == "off":
            return
        fp = _sa.current_fp()
        if fp is None:
            fp = _get_baggage("template", "unknown")
            if fp == "unknown":
                return
        actuals = self.advisor_actuals(counts_h) if counts_h else {}
        if rows is not None:
            actuals["result"] = float(rows)
        if actuals:
            _sa.stats_advisor.observe(fp, actuals, version=self.db.store.version_key())

    def to_table(self, out_cols, valid) -> BindingTable:
        _note_fetch("to_table")
        keep = torch.nonzero(valid).squeeze(1)
        if not out_cols:
            return {}
        stacked = torch.stack([c[keep] for c in out_cols]).cpu().numpy()
        return {
            var: stacked[j].astype(np.uint32) for j, var in enumerate(self.out_vars)
        }

    def fetch_stats(self) -> Dict[str, int]:
        """Host-read the per-operator stats of the last converged run (one
        extra device->host transfer; only EXPLAIN ANALYZE pays it)."""
        stats = getattr(self, "_last_stats", None)
        if not stats:
            return {}
        _note_fetch("analyze.stats")
        keys = list(stats)
        vals = torch.stack([stats[k].to(torch.int64) for k in keys]).tolist()
        return dict(zip(keys, vals))

    def describe(self, counts: Optional[List[int]] = None,
                 analyze: Optional[Dict] = None,
                 drift: Optional[Dict] = None) -> str:
        """Readable physical-plan tree for EXPLAIN: scans with their sorted
        order, bound constants and live range size, joins with key
        variables, capacities and (when given) exact match counts,
        filters, and quoted expansions.  ``counts`` is the per-join exact
        count list from :meth:`host_execute` / calibration.

        ``analyze`` is a capture record from an actual run (see
        :mod:`kolibrie_tpu_torch.obs.analyze`): its ``operators`` map
        annotates every node with ``actual=`` rows and joins / WCOJ levels
        with cap ``occ=`` percentages.  ``drift`` is a stats-advisor
        report's ``ops`` map (advisor key -> (est, actual)); matching nodes
        gain an ``est=/actual=/x-off=`` column."""
        from kolibrie_tpu_torch.query.template import occupancy_pct

        scan_ranges = self._host_scan_ranges()
        lines: List[str] = []
        ops = (analyze or {}).get("operators", {}) or {}
        acounts = (analyze or {}).get("counts", []) or []
        dseq = {"filter": 0, "anti": 0, "union": 0, "quoted": 0}
        dmap: Dict[str, tuple] = {}
        if drift:
            for _src, _idx, akey, dkey in self._advisor_sites():
                pair = drift.get(akey)
                if pair is not None:
                    dmap[dkey] = pair

        def term(c):
            return "?" if c is None else str(c)

        def drift_col(dkey):
            pair = dmap.get(dkey)
            if pair is None:
                return ""
            est, act = pair
            if est is None or act is None:
                return ""
            xoff = max(est, act) / max(min(est, act), 1.0)
            return f" est={est:.0f} actual={act:.0f} x-off={xoff:.1f}"

        def actual(key):
            base = f" actual={ops[key]}" if key in ops else ""
            return base + drift_col(key)

        def occ(join_idx, cap):
            if join_idx < len(acounts) and isinstance(cap, int) and cap > 0:
                return f" occ={occupancy_pct(acounts[join_idx], cap):.1f}%"
            return ""

        def matched(join_idx, word="matched"):
            if counts is not None and join_idx < len(counts):
                return f" {word}={counts[join_idx]}"
            return ""

        def walk(node, depth):
            pad = "  " * depth
            jcaps = getattr(self, "_join_caps", None)
            if isinstance(node, ScanSpec):
                order_name, consts = self.scan_descs[node.scan_idx]
                _lo, n = (int(x) for x in scan_ranges[node.scan_idx])
                vars_ = " ".join(f"?{v}@{p}" for v, p in node.out_vars)
                lines.append(
                    f"{pad}scan[{order_name}] ({term(consts[0])} "
                    f"{term(consts[1])} {term(consts[2])}) rows={n}"
                    f"{actual(f'scan{node.scan_idx}')} binds {vars_}"
                )
            elif isinstance(node, JoinSpec):
                cap = jcaps[node.join_idx] if jcaps else "?"
                kind = "merge(rsorted)" if node.rsorted else "sort"
                lines.append(
                    f"{pad}{kind}-join on ({', '.join(node.key_vars)})"
                    f" cap={cap}{matched(node.join_idx)}{actual(f'join{node.join_idx}')}"
                    f"{occ(node.join_idx, cap)}"
                )
                walk(node.left, depth + 1)
                walk(node.right, depth + 1)
            elif isinstance(node, AntiJoinSpec):
                key = f"anti{dseq['anti']}"
                dseq["anti"] += 1
                lines.append(
                    f"{pad}anti-join (MINUS/NOT) on ({', '.join(node.key_vars)}){actual(key)}"
                )
                walk(node.left, depth + 1)
                walk(node.right, depth + 1)
            elif isinstance(node, LeftOuterSpec):
                lines.append(
                    f"{pad}left-outer-join (OPTIONAL) on ({', '.join(node.key_vars)})"
                    f"{matched(node.join_idx)}{actual(f'optional{node.join_idx}')}"
                )
                walk(node.left, depth + 1)
                walk(node.right, depth + 1)
            elif isinstance(node, UnionSpec):
                key = f"union{dseq['union']}"
                dseq["union"] += 1
                lines.append(f"{pad}union -> ({', '.join(node.vars)}){actual(key)}")
                for ch in node.children:
                    walk(ch, depth + 1)
            elif isinstance(node, FilterSpec):
                key = f"filter{dseq['filter']}"
                dseq["filter"] += 1
                lines.append(f"{pad}filter {node.expr}{actual(key)}")
                walk(node.child, depth + 1)
            elif isinstance(node, QuotedExpandSpec):
                key = f"quoted{dseq['quoted']}"
                dseq["quoted"] += 1
                vars_ = " ".join(f"?{v}@{p}" for v, p in node.out_vars)
                lines.append(
                    f"{pad}quoted-expand {node.qvar} -> "
                    f"{vars_ or '(checks only)'}{actual(key)}"
                )
                walk(node.child, depth + 1)
            elif isinstance(node, WcojSpec):
                lines.append(
                    f"{pad}wcoj elim=[" + " ".join(f"?{lv.var}" for lv in node.levels) + "]"
                )
                for lv in node.levels:
                    cap = jcaps[lv.join_idx] if jcaps else "?"
                    accs = ", ".join(
                        f"{self.order_names[a.order_idx]}/k{len(a.key_srcs)}"
                        for a in lv.accessors
                    )
                    act = ""
                    ck = f"wcoj{lv.join_idx}:cand"
                    if ck in ops:
                        act = (
                            f" cand={ops[ck]}"
                            f" dedup={ops.get(f'wcoj{lv.join_idx}:dedup', '?')}"
                            f" live={ops.get(f'wcoj{lv.join_idx}:live', '?')}"
                        )
                    lines.append(
                        f"{pad}  level ?{lv.var} cap={cap}{matched(lv.join_idx, 'rows')}{act}"
                        f"{drift_col(f'wcoj{lv.join_idx}:live')}"
                        f"{occ(lv.join_idx, cap)} [{accs}]"
                    )
            elif isinstance(node, ValuesSpec):
                lines.append(f"{pad}values({', '.join(node.vars)}) rows={node.n}")
            else:
                lines.append(f"{pad}{type(node).__name__}")

        walk(self.root, 0)
        for s, p, o in self.const_checks:
            lines.append(f"const-guard ({s} {p} {o})")
        if self.u_params or self.f_params:
            lines.append(f"params u32={list(self.u_params)} f64={list(self.f_params)}")
        lines.append(f"project -> {' '.join('?' + v for v in self.out_vars)}")
        return "\n".join(lines)

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

    # how the last execute() produced its rows: "mqo" (shared-prefix
    # fan-out), "interp" (plan-bytecode interpreter), "compiled" (the
    # specialized spec tree), or "disk" (the specialized spec tree run
    # first with every kernel library loaded from the compile cache).
    # Plan-cache slots surface this as ``source``.
    last_source: Optional[str] = None

    def execute(self) -> BindingTable:
        """Run to completion with capacity validation; returns a host table."""
        # deadline check BEFORE the run (don't start device work the client
        # stopped waiting for) and a fault point that can inject kernel
        # latency / a simulated device OOM; both read only the host
        check_deadline("device.execute")
        fault_point("device.execute")
        if not self.const_ok():
            return self.empty_table()
        tpl = _get_baggage("template", "unknown")
        # multi-query sharing: when KOLIBRIE_MQO routes this template to a
        # shared scan/join prefix, the prefix table comes from the
        # version-keyed cache (or one interpreter run) and only the filter
        # suffix runs per member (optimizer/mqo.py)
        from kolibrie_tpu_torch.optimizer import mqo as _mqo

        if _mqo.mqo_mode() != "off":
            t0 = _time.perf_counter()
            table = _mqo.try_shared_execute(self)
            if table is not None:
                self.last_source = "mqo"
                _DISPATCH_LAT.labels(tpl).observe(_time.perf_counter() - t0)
                check_deadline("device.execute.done")
                return table
        # KOLIBRIE_PLAN_INTERP routes eligible templates through the
        # plan-bytecode interpreter; a shape it declines falls through to
        # the specialized path
        from kolibrie_tpu_torch.optimizer import plan_interp

        if plan_interp.should_interp(self):
            t0 = _time.perf_counter()
            table = plan_interp.interp_execute(self)
            if table is not None:
                self.last_source = "interp"
                _DISPATCH_LAT.labels(tpl).observe(_time.perf_counter() - t0)
                check_deadline("device.execute.done")
                return table
        specs0 = len(_SPECS_RUN["run_plan"])
        t0 = _time.perf_counter()
        with _obs_span("device.dispatch", template=tpl):
            parts = self.converge(self.run())
        _DISPATCH_LAT.labels(tpl).observe(_time.perf_counter() - t0)
        plan_interp.mark_compiled(self)
        self.last_source = _classify_source(specs0)
        t1 = _time.perf_counter()
        with _obs_span("device.collect"):
            table = self.to_table(*parts)
        _COLLECT_LAT.observe(_time.perf_counter() - t1)
        nrows = len(next(iter(table.values()))) if table else 0
        self._advise(None, rows=nrows)
        cap = _analyze.active()
        if cap is not None:
            cap.record(
                "device",
                source=self.last_source,
                operators=self.fetch_stats(),
                counts=list(getattr(self, "_last_counts", [])),
                caps=list(self._join_caps),
                rows=nrows,
            )
        check_deadline("device.execute.done")
        return table


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
    lowering raises it, never :meth:`LoweredPlan.execute`.

    Resilience hooks: an injected compile fault raises DeviceFault (NOT
    Unsupported — transient, counted by the circuit breaker, never
    recorded as a sticky lowering sentinel); an expired deadline sheds the
    request before lowering work starts."""
    check_deadline("device.lower")
    fault_point("device.lower")
    tpl = _get_baggage("template", "unknown")
    t0 = _time.perf_counter()
    with _obs_span("device.lower", template=tpl):
        lowered = LoweredPlan(db, plan, anti_plans, union_groups, optional_plans)
    _LOWER_LAT.labels(tpl).observe(_time.perf_counter() - t0)
    return lowered


def execute_plan_batch(lowereds: List[LoweredPlan], max_attempts: int = 12) -> List[BindingTable]:
    """Instrumented wrapper over :func:`_execute_plan_batch`: one
    ``device.dispatch`` span and per-template timing for the whole
    batch."""
    if not lowereds:
        return []
    tpl = _get_baggage("template", "unknown")
    _DEVICE_BATCH_SIZE.observe(len(lowereds))
    t0 = _time.perf_counter()
    with _obs_span("device.dispatch", template=tpl, batch=len(lowereds)):
        out = _execute_plan_batch(lowereds, max_attempts)
    _DISPATCH_LAT.labels(tpl).observe(_time.perf_counter() - t0)
    return out


def _execute_plan_batch(lowereds: List[LoweredPlan], max_attempts: int = 12) -> List[BindingTable]:
    """Run MANY constant-variants of ONE plan template as one batched
    dispatch.  The reference ``vmap``s the plan body over the stacked scan
    ranges and parameter vectors; the port's kernels are ``ctypes``
    launches that do not map over a batch axis, so each live member's plan
    body is enqueued back to back at the shared template capacities, every
    member's join counts are stacked and read back ONCE per attempt, and
    the capacities converge max-over-batch.  Returns one host table per
    input, each equal to that plan's own ``execute()``.

    Every member must have lowered to the same template (equal assembled
    spec — guaranteed when they share a fingerprint); members with string
    masks must carry identical patterns, and VALUES templates are not
    batchable (their rows are per-variant constants outside the parameter
    ABI)."""
    if not lowereds:
        return []
    check_deadline("device.batch")
    fault_point("device.batch")
    base = lowereds[0]
    for lp in lowereds[1:]:
        if lp.mask_exprs != base.mask_exprs:
            raise Unsupported("batch members differ in string-mask patterns")
        if lp.values_tables or base.values_tables:
            raise Unsupported("VALUES templates are not batchable")
    results: List[Optional[BindingTable]] = [None] * len(lowereds)
    live = []
    for i, lp in enumerate(lowereds):
        if lp.const_ok():
            live.append(i)
        else:
            results[i] = lp.empty_table()
    if not live:
        return results
    lp0 = lowereds[live[0]]
    for _attempt in range(max_attempts):
        spec0 = None
        outs = []
        for i in live:
            lp = lowereds[i]
            spec, operands = lp.build()
            if spec0 is None:
                spec0 = spec
            elif spec != spec0:
                raise Unsupported("batch members lowered to different templates")
            outs.append(_plan_body(spec, *operands, lp.u_params, lp.f_params))
        _note_spec("run_plan_batch", spec0)
        n_counts = len(outs[0][2])
        if n_counts:
            counts_h = torch.stack([torch.stack(o[2]) for o in outs]).tolist()
            _note_fetch("batch.counts")
        else:
            counts_h = [[] for _ in outs]
        caps = lp0._join_caps
        maxc = [max(row[j] for row in counts_h) for j in range(n_counts)]
        over = [j for j, c in enumerate(maxc) if c > caps[j]]
        if not over:
            break
        for j in over:
            lp0._join_caps[j] = _round_cap(2 * maxc[j])
        lp0._store_caps()
    else:
        raise RuntimeError("batched plan capacities failed to converge")
    cap = _analyze.active()
    if cap is not None:
        _note_fetch("analyze.batch_stats")
        for (i, out) in zip(live, outs):
            stats = out[3]
            keys = list(stats)
            vals = torch.stack([stats[k].to(torch.int64) for k in keys]).tolist() if keys else []
            cap.record("device_batch", member=i, operators=dict(zip(keys, vals)),
                       caps=list(lp0._join_caps))
    # every member's valid rows in one transfer, split by member on the host
    valid_all = torch.stack([o[1] for o in outs])
    cols_all = torch.stack([torch.stack(o[0], 1) for o in outs])
    sel = torch.nonzero(valid_all)
    got = torch.cat([sel[:, :1], cols_all[sel[:, 0], sel[:, 1]]], 1).cpu().numpy()
    _note_fetch("batch.collect")
    for b, i in enumerate(live):
        mine = got[got[:, 0] == b]
        results[i] = {
            var: mine[:, 1 + j].astype(np.uint32) for j, var in enumerate(lowereds[i].out_vars)
        }
    return results


def try_device_execute(
    db, plan, anti_plans=(), union_groups=(), optional_plans=(), capture=None
) -> Optional[BindingTable]:
    """Device path if the plan is expressible, else ``None`` (host
    fallback).  ``anti_plans`` / ``union_groups`` / ``optional_plans`` are
    the clause branch plans fused over the main tree.  ``capture``:
    plan-cache entry — records the lowered program (``False`` when this
    plan cannot lower) so the next identical query skips lowering."""
    try:
        lowered = lower_plan(db, plan, anti_plans, union_groups, optional_plans)
    except Unsupported:
        if capture is not None:
            capture["lowered"] = False
        return None
    if capture is not None:
        capture["lowered"] = lowered
    return lowered.execute()


def clause_replayable(lowered, w) -> bool:
    """True when a cached lowered program may be replayed WITHOUT the host
    clause post-passes: it either fused the WHERE's
    UNION/OPTIONAL/MINUS/NOT branches itself, or the WHERE has none.  A
    plain-BGP lowering for a clause-carrying WHERE must instead replay
    through ``eval_where`` (device BGP + host post-passes) — the shared
    eligibility rule of every cache-replay site."""
    return getattr(lowered, "fused_clauses", False) or not (
        w.unions or w.optionals or w.minus or w.not_blocks
    )


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


def try_device_execute_ordered(db, q, cache_entry=None) -> Optional[List[List[str]]]:
    """ORDER BY + LIMIT on the device: plan execution, top-k sort, O(limit)
    readback, formatted rows.  ``None`` when the shape is not expressible
    (the caller orders the full table on the host).  ``cache_entry``:
    plan-cache slot — repeat ordered queries reuse the lowered program
    instead of re-planning and re-lowering."""
    from kolibrie_tpu_torch.optimizer.engine import resolve_pattern
    from kolibrie_tpu_torch.optimizer.planner import Streamertail, build_logical_plan
    from kolibrie_tpu_torch.query.executor import _clause_plans, _device_routed, format_results
    from kolibrie_tpu_torch.query.subquery_inline import inline_subqueries

    if not _device_routed(db):
        return None
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
    lowered = None
    if cache_entry is not None and cache_entry["lowered"] not in (None, False):
        clow = cache_entry["lowered"]
        if not clause_replayable(clow, w):
            # a plain-BGP lowering in the slot for a clause-carrying WHERE
            # proves the fused attempt FAILED at this state: eval_where
            # replays the cached program with host post-passes
            return None
        lowered = clow  # repeat query: skip plan + lower
    if lowered is None:
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
            if cache_entry is not None:
                # sticky negative: re-planning this template at this store
                # state would fail identically on every call
                cache_entry["ordered_failed"] = True
            return None
        if cache_entry is not None:
            cache_entry["plan"] = plan
            cache_entry["lowered"] = lowered
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


# ---------------------------------------------------------------------------
# Prepared queries (the repeated-execution API)
# ---------------------------------------------------------------------------


class PreparedQuery:
    """Parse + plan + lower a SELECT once; run it on the device many times.

    ``calibrate()`` sets join capacities from the host twin (no device
    readback), ``run()`` enqueues the plan body without any readback,
    ``run_amortized(k)`` enqueues ``k`` of them, and ``fetch(out)``
    validates a run's counts and decodes its results to rows.
    """

    def __init__(self, db, sparql: str):
        from kolibrie_tpu_torch.optimizer.engine import resolve_pattern
        from kolibrie_tpu_torch.optimizer.planner import Streamertail, build_logical_plan
        from kolibrie_tpu_torch.query.executor import _clause_plans
        from kolibrie_tpu_torch.query.parser import parse_combined_query
        from kolibrie_tpu_torch.query.subquery_inline import inline_subqueries

        db.register_prefixes_from_query(sparql)
        cq = parse_combined_query(sparql, db.prefixes)
        if cq.select is None:
            raise Unsupported("prepared queries must be SELECTs")
        self.db = db
        self.query = cq.select
        # plain sub-SELECTs fold into the BGP; UNION/OPTIONAL/MINUS/NOT
        # fuse as clause branches like the executor's device path
        where = inline_subqueries(cq.select.where)
        if where.subqueries or where.binds or where.window_blocks:
            raise Unsupported("prepared device queries support BGP+FILTER only")
        if not where.patterns:
            raise Unsupported("prepared clause-only groups unsupported")
        planner = Streamertail(db.get_or_build_stats())
        clauses = _clause_plans(db, planner, where)
        if clauses is None:
            raise Unsupported("non-BGP clause branch in prepared query")
        union_groups, optional_plans, anti_plans = clauses
        resolved = [resolve_pattern(db, p) for p in where.patterns]
        logical = build_logical_plan(resolved, where.filters, [], where.values)
        self.plan = planner.find_best_plan(logical)
        self.lowered = lower_plan(db, self.plan, anti_plans, union_groups, optional_plans)
        if self.lowered.const_checks:
            # run() enqueues only, by contract; a store-dependent host
            # guard between runs would break that
            raise Unsupported("prepared query with fully-constant pattern")

    def calibrate(self) -> None:
        """Converge join capacities via the host twin — no device
        readback."""
        self.lowered.calibrate_host()

    def run(self):
        """Enqueue the plan body; NO host readback."""
        return self.lowered.run()

    def run_amortized(self, k: int):
        """Enqueue the plan body ``k`` times with a loop-carried dependency;
        returns (checksums, per-iteration row counts) on the device, no
        readback."""
        return self.lowered.run_k(k)

    def fetch(self, out) -> List[List[str]]:
        """Decode a ``run()`` result to sorted string rows (readback here).

        Join counts are validated against the capacities the run used; on
        overflow (the store grew past the calibrated caps) the capacities
        double and the query re-runs — no silent truncation."""
        from kolibrie_tpu_torch.query.executor import format_results

        table = self.lowered.to_table(*self.lowered.converge(out))
        return format_results(self.db, table, self.query, sort_rows=True)
