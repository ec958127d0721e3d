"""Plan-bytecode interpreter: run ANY eligible template through one generic
evaluator whose program is data.

Port of ``kolibrie_tpu/optimizer/plan_interp.py``.  The reference jits one
``fori_loop`` per *size class* that ``lax.switch``-es on each op row, so a
new template shape costs no compile.  ``compile_bytecode`` here produces
the same dense int32 op table, row for row (MQO's prefix extraction works
in this bytecode space, so its semantics stay identical); ``_run_interp``
walks the table on the host — the table is host data, so the walk reads
nothing back from the card — and runs each op's tensor operations on the
database's device.

**Machine model.**  A register file of full-width binding tables:
``regs[i]`` is the ``[cap, n_slots]`` output of op ``i`` (slot ``c`` = the
template's ``out_vars[c]``, u32 IDs in int64 carriers), with a ``[cap]``
validity row.  The file is allocated once, ``[n_ops, cap, n_slots]``, on
the device, under the reference's budgets (``_MAX_CELLS`` cells,
``_MAX_OPS`` ops, ``_MAX_SLOTS`` slots: at most 32 MiB).  Ops:

====  ============  =====================================================
  0   NOP           padding up to the size-class op count
  1   SCAN          two-segment base+delta merge with tombstone masking —
                    the same rank arithmetic as the specialized ScanSpec
  2   JOIN          generic sort-based equi-join
                    (:func:`kolibrie_tpu_torch.ops.device_join.join_indices`,
                    plain torch, as the reference's is XLA) on 1 or 2 key
                    slots; per-slot left/right source selectors
  3   FILTER_ID     ``?v =|!= uparams[k]``
  4   FILTER_NUMC   numeric compare against ``fparams[k]``
  5   FILTER_NUMV   numeric compare between two slots (with the =/!=
                    id-equality fallback the specialized path applies)
====  ============  =====================================================

The interpreter launches no custom kernel, as in the reference.

**Size classes.**  (op-count bucket, unified capacity, slot-count bucket):
:func:`interp_compile_stats` counts the distinct classes this process has
run, the port's twin of the reference's jit-cache size.  Capacities ride
the template-cap protocol shared with the specialized path.

**Eligibility.**  Plain BGP shapes: scans (no repeated-variable patterns),
1–2-key joins, Id/NumConst/NumCmp filters and AND-chains of them.
Everything else (string masks, VALUES, UNION/OPTIONAL/MINUS, quoted
expansion, WCOJ) declines with :class:`InterpUnsupported` and runs the
specialized path — routing, not failure.

Routing is ``KOLIBRIE_PLAN_INTERP=auto|off|force`` (default ``off``;
``auto`` serves a template through the interpreter until its specialized
path has run once in this process).  The mode participates in the
template fingerprint exactly like ``KOLIBRIE_WCOJ``.  ``auto`` is kept for
the reference's routing and fingerprints, not for speed: the reference
uses it to skip a template's jit compile, and eager PyTorch has no
compile to skip.  On the H100 the interpreter measured no faster than the
specialized path (PERF.md, phase 13c), so ``auto`` has no measured benefit
on the card.
"""

from __future__ import annotations

import os
import threading
import time as _time
from typing import List, Optional

import numpy as np
import torch

from kolibrie_tpu_torch.backend import _RPAD, pack2
from kolibrie_tpu_torch.ops.device_join import join_indices
from kolibrie_tpu_torch.obs import analyze as _analyze
from kolibrie_tpu_torch.obs import metrics as _metrics
from kolibrie_tpu_torch.obs.spans import span as _obs_span

__all__ = [
    "plan_interp_mode",
    "override_mode",
    "InterpUnsupported",
    "compile_bytecode",
    "interp_execute",
    "should_interp",
    "mark_compiled",
    "interp_compile_stats",
]

_INTERP_DISPATCH = _metrics.counter(
    "kolibrie_interp_dispatch_total",
    "queries executed through the plan-bytecode interpreter",
)
_INTERP_DECLINED = _metrics.counter(
    "kolibrie_interp_declined_total",
    "templates the interpreter declined (shape outside the op repertoire)",
)
_INTERP_LAT = _metrics.histogram(
    "kolibrie_interp_dispatch_seconds",
    "plan-bytecode interpreter dispatch wall time",
)

# opcodes
NOP, SCAN, JOIN, FILTER_ID, FILTER_NUMC, FILTER_NUMV = range(6)
_W = 12  # operand columns per op row

_MODES = ("auto", "off", "force")
_tl = threading.local()


def plan_interp_mode() -> str:
    """Routing mode, thread-local override first (the warmer suppresses
    the interpreter for its own specialized runs).  Default ``off``."""
    ov = getattr(_tl, "mode", None)
    if ov is not None:
        return ov
    mode = os.environ.get("KOLIBRIE_PLAN_INTERP", "off").strip().lower()
    return mode if mode in _MODES else "off"


class override_mode:
    """``with override_mode("off"): ...`` — scoped, per-thread."""

    def __init__(self, mode: str):
        self.mode = mode

    def __enter__(self):
        self.prev = getattr(_tl, "mode", None)
        _tl.mode = self.mode
        return self

    def __exit__(self, *exc):
        _tl.mode = self.prev
        return False


class InterpUnsupported(Exception):
    """Template shape outside the interpreter's op repertoire."""


def _bucket(n: int, lo: int) -> int:
    c = lo
    while c < n:
        c <<= 1
    return c


# register-file memory guard: n_ops * cap * n_slots cells
_MAX_CELLS = 2**22  # 32 MiB of int64 carriers
_MAX_OPS = 64
_MAX_SLOTS = 16


class InterpProgram:
    """Host-side compiled bytecode for one lowered plan."""

    __slots__ = (
        "code",
        "n_ops",
        "cap",
        "n_slots",
        "var_slots",
        "out_reg",
        "join_count",
        "n_real",
        "stat_keys",
    )

    def __init__(self, code, n_ops, cap, n_slots, var_slots, out_reg,
                 join_count, n_real=0, stat_keys=()):
        self.code = code  # np.int32 [n_ops, _W]
        self.n_ops = n_ops  # size-class bucket (rows incl. NOP padding)
        self.cap = cap
        self.n_slots = n_slots
        self.var_slots = var_slots  # var name -> slot index
        self.out_reg = out_reg
        self.join_count = join_count
        self.n_real = n_real  # real rows before NOP padding
        # per-row EXPLAIN ANALYZE key (shared with _plan_body's stats
        # scheme); None for intermediate AND-chain filter rows
        self.stat_keys = stat_keys


def _emit_rows(lowered):
    """Flatten ``lowered.root`` into raw op rows WITHOUT touching
    capacities or the device — safe to call before ``lowered.build()``.
    Returns ``(rows, bound, stat_keys, slots, out_reg)``; the MQO layer
    uses this for prefix splitting/fingerprinting on host-routed stores.
    Raises :class:`InterpUnsupported` for shapes outside the repertoire."""
    from kolibrie_tpu_torch.optimizer.device_engine import (
        BoolNode,
        FilterSpec,
        IdCmp,
        JoinSpec,
        NumCmp,
        NumConstCmp,
        ScanSpec,
    )

    if lowered.mask_exprs or lowered.values_tables:
        raise InterpUnsupported("string masks / VALUES")
    if getattr(lowered, "need_quoted", False):
        raise InterpUnsupported("quoted expansion")
    slots = {v: i for i, v in enumerate(lowered.out_vars)}
    if len(slots) > _MAX_SLOTS:
        raise InterpUnsupported(f"{len(slots)} variables > {_MAX_SLOTS}")
    rows: List[List[int]] = []
    bound: List[set] = []  # vars bound by each register
    stat_keys: List[Optional[str]] = []  # analyze key per row (None = sub-step)
    fseq = [0]  # pre-order FilterSpec counter (matches _plan_body's seq)

    def emit(row, vars_, key=None) -> int:
        rows.append(row + [0] * (_W - len(row)))
        bound.append(vars_)
        stat_keys.append(key)
        return len(rows) - 1

    def flatten_and(expr, out):
        if isinstance(expr, BoolNode):
            if expr.kind != "and":
                raise InterpUnsupported(f"boolean {expr.kind}")
            for a in expr.args:
                flatten_and(a, out)
        else:
            out.append(expr)

    def walk(node) -> int:
        if isinstance(node, ScanSpec):
            if node.eq_pairs:
                raise InterpUnsupported("repeated-variable pattern")
            tgt = [-1, -1, -1]
            vars_ = set()
            for var, pos in node.out_vars:
                tgt[pos] = slots[var]
                vars_.add(var)
            k0, k1 = node.key_pos
            return emit(
                [SCAN, node.order_idx, node.scan_idx, k0, k1] + tgt,
                vars_,
                key=f"scan{node.scan_idx}",
            )
        if isinstance(node, JoinSpec):
            if len(node.key_vars) > 2:
                raise InterpUnsupported("3+ key join")
            lr = walk(node.left)
            rr = walk(node.right)
            lv, rv = bound[lr], bound[rr]
            ks = [slots[v] for v in node.key_vars]
            k0 = ks[0]
            k1 = ks[1] if len(ks) > 1 else 0
            from_right = 0
            bmask = 0
            for v in lv | rv:
                bmask |= 1 << slots[v]
                if v not in lv:
                    from_right |= 1 << slots[v]
            return emit(
                [JOIN, lr, rr, len(ks), k0, k1, node.join_idx, from_right, bmask],
                lv | rv,
                key=f"join{node.join_idx}",
            )
        if isinstance(node, FilterSpec):
            # pre-order key, assigned BEFORE the child walk (same scheme
            # as the specialized path); it lands on the LAST row of the
            # AND-chain — the row whose validity is the node's output
            fkey = f"filter{fseq[0]}"
            fseq[0] += 1
            src = walk(node.child)
            exprs: List[object] = []
            flatten_and(node.expr, exprs)
            for e in exprs:
                if isinstance(e, IdCmp):
                    src = emit(
                        [
                            FILTER_ID,
                            src,
                            slots[e.var],
                            0 if e.op == "=" else 1,
                            e.param_idx,
                        ],
                        bound[src],
                    )
                elif isinstance(e, NumConstCmp):
                    src = emit(
                        [
                            FILTER_NUMC,
                            src,
                            slots[e.var],
                            _NUM_OPS.index(e.op),
                            e.param_idx,
                        ],
                        bound[src],
                    )
                elif isinstance(e, NumCmp):
                    src = emit(
                        [
                            FILTER_NUMV,
                            src,
                            slots[e.lvar],
                            _NUM_OPS.index(e.op),
                            slots[e.rvar],
                        ],
                        bound[src],
                    )
                else:
                    raise InterpUnsupported(type(e).__name__)
            stat_keys[src] = fkey
            return src
        raise InterpUnsupported(type(node).__name__)

    out_reg = walk(lowered.root)
    if len(rows) > _MAX_OPS:
        raise InterpUnsupported(f"{len(rows)} ops > {_MAX_OPS}")
    return rows, bound, stat_keys, slots, out_reg


def compile_bytecode(lowered) -> InterpProgram:
    """Flatten ``lowered.root`` into the op table.  Requires
    ``lowered.build()`` to have run (capacities populated).  Raises
    :class:`InterpUnsupported` for shapes outside the repertoire."""
    rows, bound, stat_keys, slots, out_reg = _emit_rows(lowered)
    n_real = len(rows)
    caps = list(lowered._scan_caps.values()) + list(lowered._join_caps)
    cap = _bucket(max(caps) if caps else 1, 8)
    n_ops = _bucket(n_real, 4)
    n_slots = _bucket(len(slots), 4)
    if n_ops * cap * n_slots > _MAX_CELLS:
        raise InterpUnsupported(
            f"register file {n_ops}x{cap}x{n_slots} exceeds cell budget"
        )
    code = np.zeros((n_ops, _W), dtype=np.int32)
    for i, row in enumerate(rows):
        code[i] = row
    return InterpProgram(
        code, n_ops, cap, n_slots, slots, out_reg, lowered.join_count,
        n_real=n_real, stat_keys=tuple(stat_keys),
    )


_NUM_OPS = ("=", "!=", "<", "<=", ">", ">=")


# ---------------------------------------------------------------------------
# The interpreter
# ---------------------------------------------------------------------------

# size classes run in this process: the reference's jit-cache entries
_SIZE_CLASSES: set = set()


def _run_interp(n_ops: int, cap: int, n_slots: int, code: np.ndarray, out_reg: int,
                segments, scalars: np.ndarray, numf: torch.Tensor, uparams, fparams):
    """Walk the op table.  ``segments[i]`` is the device segment triple
    ``(base cols, delta cols, tombstone positions)`` of the plan's order
    ``i`` (canonical s/p/o columns); ``scalars`` the host ``(lo_b, n_b,
    lo_d, n_d)`` rows per scan.  Returns ``(cols [cap, n_slots], valid
    [cap], counts [n_ops], oprows [n_ops])``, all on the device."""
    _SIZE_CLASSES.add((n_ops, cap, n_slots))
    dev = numf.device
    ar = torch.arange(cap, dtype=torch.int64, device=dev)
    slot_ids = torch.arange(n_slots, dtype=torch.int64, device=dev)
    regs = torch.zeros((n_ops, cap, n_slots), dtype=torch.int64, device=dev)
    rvalid = torch.zeros((n_ops, cap), dtype=torch.bool, device=dev)
    counts: List[torch.Tensor] = [torch.zeros((), dtype=torch.int64, device=dev)] * n_ops
    oprows: List[torch.Tensor] = []
    nf_last = numf.shape[0] - 1

    def numv(col):
        return numf[col.clamp(max=nf_last)]

    def op_scan(op):
        # twin of the specialized ScanSpec merge (device_engine._plan_body)
        bcols, dcols, del_pos = segments[op[1]]
        lo_b, n_b, lo_d, n_d = (int(x) for x in scalars[op[2]])
        dcap = del_pos.shape[0]
        ard = torch.arange(dcap, dtype=torch.int64, device=dev)
        src_b = (lo_b + ar).clamp_(0, bcols[0].shape[0] - 1)
        src_d = (lo_d + ard).clamp_(0, dcap - 1)
        inb = ar < n_b
        ind = ard < n_d
        jd = torch.searchsorted(del_pos, src_b).clamp_(0, dcap - 1)
        is_del = (del_pos[jd] == src_b) & inb
        bvalid = inb & ~is_del
        k0, k1 = op[3], op[4]
        bkey = torch.where(inb, pack2(bcols[k0][src_b], bcols[k1][src_b]), _RPAD)
        dkey = torch.where(ind, pack2(dcols[k0][src_d], dcols[k1][src_d]), _RPAD)
        pos_b = (torch.cumsum(bvalid, 0) - 1) + torch.searchsorted(dkey, bkey)
        cdel = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(is_del, 0)])
        ib = torch.searchsorted(bkey, dkey, right=True)
        pos_d = ard + ib - cdel[ib]
        valid = ar < (n_b - cdel[-1]) + n_d
        dst_b = torch.where(bvalid & (pos_b < cap), pos_b, cap)
        dst_d = torch.where(ind & (pos_d < cap), pos_d, cap)
        cols = torch.zeros((cap + 1, n_slots), dtype=torch.int64, device=dev)
        for p in range(3):  # canonical s/p/o
            tgt = op[5 + p]
            if tgt >= 0:
                cols[dst_b, tgt] = bcols[p][src_b]
                cols[dst_d, tgt] = dcols[p][src_d]
        return cols[:cap], valid, None

    def op_join(op):
        lcols, lval = regs[op[1]], rvalid[op[1]]
        rcols, rval = regs[op[2]], rvalid[op[2]]
        two = op[3] > 1
        lk1 = lcols[:, op[5]] if two else torch.zeros_like(lval, dtype=torch.int64)
        rk1 = rcols[:, op[5]] if two else torch.zeros_like(rval, dtype=torch.int64)
        lkey = pack2(lcols[:, op[4]], lk1)
        rkey = pack2(rcols[:, op[4]], rk1)
        li, ri, valid, total = join_indices(lkey, rkey, cap, lval, rval)
        from_right = ((op[7] >> slot_ids) & 1).bool()[None, :]
        bmask = ((op[8] >> slot_ids) & 1).bool()[None, :]
        out = torch.where(from_right, rcols[ri], lcols[li])
        out = torch.where(valid[:, None] & bmask, out, 0)
        return out, valid, total

    def op_filter_id(op):
        col = regs[op[1]][:, op[2]]
        eq = col == int(uparams[op[4]])
        return regs[op[1]], rvalid[op[1]] & (eq if op[3] == 0 else ~eq), None

    def op_filter_numc(op):
        vals = numv(regs[op[1]][:, op[2]])
        res = _TORCH_CMP[_NUM_OPS[op[3]]](vals, float(fparams[op[4]]))
        return regs[op[1]], rvalid[op[1]] & res & ~torch.isnan(vals), None

    def op_filter_numv(op):
        lcol, rcol = regs[op[1]][:, op[2]], regs[op[1]][:, op[4]]
        a, b = numv(lcol), numv(rcol)
        ok = ~(torch.isnan(a) | torch.isnan(b))
        res = _TORCH_CMP[_NUM_OPS[op[3]]](a, b)
        if op[3] <= 1:
            # =/!= fall back to id equality for non-numeric pairs
            ideq = lcol == rcol
            mask = torch.where(ok, res, ideq if op[3] == 0 else ~ideq)
        else:
            mask = res & ok
        return regs[op[1]], rvalid[op[1]] & mask, None

    branches = {
        SCAN: op_scan,
        JOIN: op_join,
        FILTER_ID: op_filter_id,
        FILTER_NUMC: op_filter_numc,
        FILTER_NUMV: op_filter_numv,
    }
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(n_ops):
        op = [int(x) for x in code[i]]
        fn = branches.get(op[0])
        if fn is None:  # NOP: an all-invalid empty register
            oprows.append(zero)
            continue
        cols, valid, total = fn(op)
        regs[i] = cols
        rvalid[i] = valid
        if total is not None:
            counts[op[6]] = total
        # per-op rows-out for EXPLAIN ANALYZE, fetched only under a capture
        oprows.append(valid.sum())
    return regs[out_reg], rvalid[out_reg], torch.stack(counts), torch.stack(oprows)


_TORCH_CMP = {
    "=": torch.eq,
    "!=": torch.ne,
    "<": torch.lt,
    "<=": torch.le,
    ">": torch.gt,
    ">=": torch.ge,
}


def interp_compile_stats() -> int:
    """Distinct interpreter size classes run in this process."""
    return len(_SIZE_CLASSES)


# ---------------------------------------------------------------------------
# Host driver
# ---------------------------------------------------------------------------


def _dispatch(lowered, prog: InterpProgram, args):
    order_arrays, scalars, _masks, _values, numf, _quoted = args
    return _run_interp(
        prog.n_ops, prog.cap, prog.n_slots, prog.code, prog.out_reg, order_arrays,
        scalars, numf, lowered.u_params, lowered.f_params,
    )


def interp_execute(lowered, max_attempts: int = 12):
    """Execute ``lowered`` through the bytecode interpreter.  Returns a
    host binding table, or ``None`` when the shape declines (the caller
    falls through to the specialized path).  Shares the capacity
    protocol: overflow doubles the template's join caps via
    ``_store_caps``."""
    from kolibrie_tpu_torch.optimizer.device_engine import _device_wait, _round_cap

    if not lowered.const_ok():
        return lowered.empty_table()
    t0 = _time.perf_counter()
    for _attempt in range(max_attempts):
        args = lowered.build()[1]
        try:
            prog = compile_bytecode(lowered)
        except InterpUnsupported:
            _INTERP_DECLINED.inc()
            return None
        sz = f"{prog.n_ops}x{prog.cap}x{prog.n_slots}"
        with _obs_span("interp.dispatch", size_class=sz):
            out_cols, out_valid, counts, oprows = _dispatch(lowered, prog, args)
        with _device_wait("interp.counts"):
            counts_h = counts[: prog.join_count].tolist()
        overflow = [i for i, c in enumerate(counts_h) if c > lowered._join_caps[i]]
        if not overflow:
            lowered._store_caps()
            with _device_wait("interp.collect"):
                keep = torch.nonzero(out_valid).squeeze(1)
                cols_h = out_cols[keep].cpu().numpy()
            nrows = len(cols_h)
            lowered._advise(counts_h, rows=nrows)
            table = {
                var: cols_h[:, prog.var_slots[var]].astype(np.uint32)
                for var in lowered.out_vars
            }
            _INTERP_DISPATCH.inc()
            _INTERP_LAT.observe(_time.perf_counter() - t0)
            cap = _analyze.active()
            if cap is not None:
                with _device_wait("analyze.oprows"):
                    rows_h = oprows.tolist()
                operators = {
                    key: int(rows_h[i]) for i, key in enumerate(prog.stat_keys) if key is not None
                }
                names = ("NOP", "SCAN", "JOIN", "FILTER_ID", "FILTER_NUMC", "FILTER_NUMV")
                opcodes = {n: 0 for n in names}
                for oc in prog.code[: prog.n_real, 0]:
                    opcodes[names[int(oc)]] += 1
                opcodes["NOP"] += prog.n_ops - prog.n_real
                cap.record(
                    "interp",
                    size_class=sz,
                    operators=operators,
                    opcodes=opcodes,
                    counts=counts_h,
                    caps=list(lowered._join_caps),
                    rows=nrows,
                )
            return table
        for i in overflow:
            lowered._join_caps[i] = _round_cap(2 * counts_h[i])
        lowered._store_caps()
    raise RuntimeError("interpreter plan capacities failed to converge")


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def _compiled_keys(db) -> set:
    keys = db.__dict__.get("_compiled_cap_keys")
    if keys is None:
        keys = db.__dict__["_compiled_cap_keys"] = set()
    return keys


def should_interp(lowered) -> bool:
    """Route this execution through the interpreter?  ``force`` always
    (eligibility still declines downstream); ``auto`` only while the
    specialized path for this template has not run in this process."""
    mode = plan_interp_mode()
    if mode == "off":
        return False
    if mode == "force":
        return True
    if lowered.cap_key in _compiled_keys(lowered.db):
        return False
    # measured admission: when the stats advisor has seen this template
    # produce intermediates past the interpreter's economical cell
    # budget, go straight to the specialized path
    from kolibrie_tpu_torch.optimizer import stats_advisor as _sa

    peak = _sa.stats_advisor.peak_rows(_sa.current_fp())
    if peak is not None and peak > _MAX_CELLS // (_MAX_OPS * 4):
        return False
    return True


def mark_compiled(lowered) -> None:
    """Record that the specialized path for this template has run
    in-process (auto mode stops interpreting it)."""
    _compiled_keys(lowered.db).add(lowered.cap_key)
