"""Multi-query optimizer of the PyTorch port: shared-prefix evaluation
across concurrent queries (port of ``kolibrie_tpu/optimizer/mqo.py``).

Kolibrie's serving story is many *concurrent* queries — the
TemplateBatcher micro-batches HTTP traffic, the RSP engine evaluates
every registered window's query on each fire — yet identical-fingerprint
dedup is the only work sharing.  This layer shares MORE: templates that
differ only in their trailing filters evaluate the common scan/join
*prefix* once and fan the binding table out to each suffix, in the
spirit of MapSQ's shared MapReduce passes (arXiv:1702.03484).

**Prefix extraction happens in bytecode space.**  ``plan_interp._emit_rows``
flattens the lowered plan into the interpreter's op table; a plan is
shareable when the table is a contiguous run of SCAN/JOIN rows (the
prefix — the join-tree root) followed only by a FILTER_* chain (the
suffix).  The prefix fingerprint hashes the canonical per-row form with
slots mapped back to *variable names* — two templates share exactly when
their scan descriptors (order, constants, key positions) and join wiring
agree under identical variable naming.

**The prefix result cache** is keyed ``(prefix_fp, base_version,
delta_epoch)`` — the two-tier store's version pair, read through
``Store.version_key()`` so pending mutations compact first.  A no-op
mutation batch (re-adding present triples, deleting absent ones — every
same-content RSP window fire after the round's first) preserves both
components, so standing windows 2..N hit the cache the round's first
window populated; any real mutation bumps ``delta_epoch`` and naturally
invalidates.

**Evaluation adds no program shape.**  The prefix runs through the
plan-bytecode interpreter on the database's device with the suffix rows
overwritten to NOP and ``out_reg`` pointed at the join-tree root — same
op-table shape, same size class.  The numpy twin of ``host_execute``'s
scan/join cases evaluates it where the reference does when the prefix
is over the interpreter's budget (``InterpUnsupported``); such host
evaluations are counted per prefix (``host_evals`` in :func:`stats`), so
a decline shows as routing.  :func:`try_shared_host` serves host-routed
stores (``execution_mode`` "auto" under the device floor, or "host"); the
reference evaluates their prefix with its numpy twin, the port on the
store's device as above, since the port's host engine runs there too.
Suffix filters always apply
host-side with ``host_execute``'s exact filter semantics (NaN guards,
=/!= id-equality fallback), so shared results are row-identical to
independent evaluation.

**Worthiness** follows EXPLAIN ANALYZE's per-operator actuals: a prefix
is shared when ``rows × (beneficiaries − 1)`` clears
``_THRESHOLD`` (first evaluation is optimistic — actuals
don't exist yet), and ALWAYS for standing (RSP) owners, where the win is
temporal: the cache carries the prefix across fires of an unchanged
store.  Routing is ``KOLIBRIE_MQO=off|auto|force`` (default ``off``),
folded into the template fingerprint and the executor's ``env_sig``
exactly like ``KOLIBRIE_WCOJ`` and ``KOLIBRIE_PLAN_INTERP`` — ``off``
reproduces pre-MQO behavior bit-for-bit.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from kolibrie_tpu_torch.obs import analyze as _analyze
from kolibrie_tpu_torch.obs import metrics as _metrics

__all__ = [
    "mqo_mode",
    "override_mqo_mode",
    "register_standing",
    "unregister_standing",
    "standing_scope",
    "transient_scope",
    "prefix_fp_for",
    "try_shared_execute",
    "try_shared_host",
    "describe_shared",
    "stats",
    "reset",
]

_MODES = ("auto", "off", "force")
_tl = threading.local()

_CACHE_MAX = 64  # prefix tables per store (LRU)
_MEMO_MAX = 256  # fingerprint / lowering memo entries per store (LRU)

_SHARED_EVALS = _metrics.counter(
    "kolibrie_mqo_shared_evals_total",
    "shared-prefix evaluations (cache misses that ran the prefix)",
)
_CACHE_HITS = _metrics.counter(
    "kolibrie_mqo_prefix_cache_hits_total",
    "queries whose shared prefix was served from the version-keyed cache",
)
_FANOUT = _metrics.counter(
    "kolibrie_mqo_fanout_total",
    "queries answered by fanning a shared prefix out through their suffix",
)
_DECLINED = _metrics.counter(
    "kolibrie_mqo_declined_total",
    "queries the MQO layer declined to share",
    labels=("reason",),
)
_PREFIX_ROWS = _metrics.histogram(
    "kolibrie_mqo_prefix_rows",
    "binding-table rows produced by shared-prefix evaluations",
    buckets=_metrics.DEFAULT_COUNT_BUCKETS,
)


def mqo_mode() -> str:
    """Sharing mode, thread-local override first.  Default ``off``: MQO
    is an opt-in serving feature; the bare library keeps the
    evaluate-every-query-independently behavior."""
    ov = getattr(_tl, "mode", None)
    if ov is not None:
        return ov
    mode = os.environ.get("KOLIBRIE_MQO", "off").strip().lower()
    return mode if mode in _MODES else "off"


class override_mqo_mode:
    """``with override_mqo_mode("force"): ...`` — scoped, per-thread."""

    def __init__(self, mode: str):
        self.mode = mode

    def __enter__(self):
        self.prev = getattr(_tl, "mode", None)
        _tl.mode = self.mode
        return self

    def __exit__(self, *exc):
        _tl.mode = self.prev
        return False


# least prefix rows times (sharers - 1) for which sharing pays
_THRESHOLD = 64


# ---------------------------------------------------------------------------
# Per-store registry: standing owners, transient batch counts, the cache
# ---------------------------------------------------------------------------


class _Registry:
    """Per-store MQO state.  ``standing`` maps an owner token (an RSP
    window IRI) to its prefix fingerprint — bound LAZILY at fire time,
    because constant resolution (hence the fingerprint) can change as the
    dictionary grows.  ``transient`` carries fan-out counts for the
    duration of one batcher dispatch."""

    __slots__ = (
        "lock",
        "standing",
        "standing_fps",
        "transient",
        "rows",
        "shared",
        "hits",
        "cache",
        "fp_memo",
        "lowered_memo",
        "host_evals",
    )

    def __init__(self):
        self.lock = threading.RLock()
        self.standing: Dict[str, Optional[str]] = {}
        self.standing_fps: Dict[str, set] = {}
        self.transient: Dict[str, int] = {}
        self.rows: Dict[str, int] = {}  # last actual prefix rows per fp
        self.shared: Dict[str, int] = {}  # shared evals per fp
        self.hits: Dict[str, int] = {}  # cache hits per fp
        self.host_evals: Dict[str, int] = {}  # prefix evals on the host twin per fp
        self.cache: "OrderedDict" = OrderedDict()
        self.fp_memo: "OrderedDict" = OrderedDict()
        self.lowered_memo: "OrderedDict" = OrderedDict()

    def active(self) -> bool:
        return bool(self.standing or self.transient)

    def beneficiaries(self, fp: str) -> int:
        return len(self.standing_fps.get(fp, ())) + self.transient.get(fp, 0)

    def bind_standing(self, owner: str, fp: str) -> None:
        old = self.standing.get(owner)
        if old == fp:
            return
        if old is not None:
            owners = self.standing_fps.get(old)
            if owners is not None:
                owners.discard(owner)
                if not owners:
                    self.standing_fps.pop(old, None)
        self.standing[owner] = fp
        self.standing_fps.setdefault(fp, set()).add(owner)


def _registry(db) -> _Registry:
    reg = db.__dict__.get("_mqo_registry")
    if reg is None:
        reg = db.__dict__.setdefault("_mqo_registry", _Registry())
    return reg


def register_standing(db, owner: str) -> None:
    """Create a standing-owner slot (RSP engine init); the fingerprint
    binds at the owner's first fire through ``standing_scope``."""
    reg = _registry(db)
    with reg.lock:
        reg.standing.setdefault(owner, None)


def unregister_standing(db, owner: str) -> None:
    reg = db.__dict__.get("_mqo_registry")
    if reg is None:
        return
    with reg.lock:
        fp = reg.standing.pop(owner, None)
        if fp is not None:
            owners = reg.standing_fps.get(fp)
            if owners is not None:
                owners.discard(owner)
                if not owners:
                    reg.standing_fps.pop(fp, None)


class standing_scope:
    """``with standing_scope(db, owner): ...`` — marks evaluations on the
    current thread as fired by a standing query.  A thread-local (NOT
    obs baggage: that channel dies with the observability kill switch,
    and this one is correctness-adjacent routing state)."""

    def __init__(self, db, owner: str):
        self.reg = _registry(db)
        self.owner = owner

    def __enter__(self):
        stack = getattr(_tl, "owners", None)
        if stack is None:
            stack = _tl.owners = []
        stack.append((self.reg, self.owner))
        return self

    def __exit__(self, *exc):
        _tl.owners.pop()
        return False


def _tl_owner(reg: _Registry) -> Optional[str]:
    stack = getattr(_tl, "owners", None)
    if stack and stack[-1][0] is reg:
        return stack[-1][1]
    return None


class transient_scope:
    """``with transient_scope(db, fps): ...`` — registers one batcher
    dispatch's prefix fingerprints as fan-out beneficiaries for the
    duration of the solo-evaluation loop."""

    def __init__(self, db, fps: List[str]):
        self.reg = _registry(db)
        self.fps = [fp for fp in fps if fp]

    def __enter__(self):
        with self.reg.lock:
            for fp in self.fps:
                self.reg.transient[fp] = self.reg.transient.get(fp, 0) + 1
        return self

    def __exit__(self, *exc):
        with self.reg.lock:
            for fp in self.fps:
                n = self.reg.transient.get(fp, 0) - 1
                if n > 0:
                    self.reg.transient[fp] = n
                else:
                    self.reg.transient.pop(fp, None)
        return False


def reset(db) -> None:
    """Drop all MQO state for a store (tests)."""
    db.__dict__.pop("_mqo_registry", None)


# ---------------------------------------------------------------------------
# Prefix extraction (bytecode space) + canonical fingerprint
# ---------------------------------------------------------------------------


class _Prefix:
    __slots__ = ("k", "n_real", "fp", "root", "exprs")

    def __init__(self, k, n_real, fp, root, exprs):
        self.k = k  # op rows in the prefix (the join tree)
        self.n_real = n_real
        self.fp = fp
        self.root = root  # IR node of the prefix (FilterSpecs peeled)
        self.exprs = exprs  # suffix filter expressions, innermost first


def _plan_prefix(lowered) -> Optional[_Prefix]:
    """Split ``lowered`` into a shareable scan/join prefix and a filter
    suffix, in bytecode space.  None ⇒ not shareable (shape outside the
    interpreter repertoire, or filters interleaved below a join)."""
    from kolibrie_tpu_torch.optimizer import plan_interp as pi
    from kolibrie_tpu_torch.optimizer.device_engine import FilterSpec

    try:
        rows, _bound, _keys, slots, out_reg = pi._emit_rows(lowered)
    except pi.InterpUnsupported:
        return None
    n_real = len(rows)
    k = 0
    while k < n_real and rows[k][0] in (pi.SCAN, pi.JOIN):
        k += 1
    if k == 0 or out_reg != n_real - 1:
        return None
    filters = (pi.FILTER_ID, pi.FILTER_NUMC, pi.FILTER_NUMV)
    for i in range(k, n_real):
        # the suffix must be ONE chain over the join-tree root: each
        # filter row consumes the previous row's validity
        if rows[i][0] not in filters or rows[i][1] != i - 1:
            return None
    fp = _prefix_fp(lowered, rows[:k], slots)
    # the IR-tree view of the same split: suffix FilterSpecs wrap the
    # pure scan/join prefix (postorder emission guarantees agreement)
    node = lowered.root
    exprs = []
    while isinstance(node, FilterSpec):
        exprs.append(node.expr)
        node = node.child
    exprs.reverse()
    return _Prefix(k, n_real, fp, node, exprs)


def _prefix_fp(lowered, prefix_rows, slots) -> str:
    """Canonical prefix fingerprint.  Slots map back to VARIABLE NAMES —
    same structure under different naming does NOT share.  Scan constants
    are resolved term ids: per-store stable (the dictionary is
    append-only), and the registry/cache are per-store anyway."""
    from kolibrie_tpu_torch.optimizer import plan_interp as pi

    inv = {i: v for v, i in slots.items()}
    sig = []
    for r in prefix_rows:
        if r[0] == pi.SCAN:
            order_name, consts = lowered.scan_descs[r[2]]
            sig.append(
                (
                    "scan",
                    order_name,
                    tuple(consts),
                    r[3],
                    r[4],
                    tuple(inv.get(t) for t in (r[5], r[6], r[7])),
                )
            )
        else:  # JOIN
            nk = r[3]
            sig.append(
                (
                    "join",
                    r[1],
                    r[2],
                    nk,
                    inv.get(r[4]),
                    inv.get(r[5]) if nk > 1 else None,
                    tuple(
                        sorted(v for s, v in inv.items() if (r[7] >> s) & 1)
                    ),
                    tuple(
                        sorted(v for s, v in inv.items() if (r[8] >> s) & 1)
                    ),
                )
            )
    return hashlib.sha1(repr(tuple(sig)).encode("utf-8")).hexdigest()


def prefix_fp_for(db, template_fp: str, lower_thunk) -> Optional[str]:
    """Prefix fingerprint for a template, memoized per store version —
    the batcher registers transient beneficiaries through this without
    re-lowering every member on every dispatch.  ``lower_thunk`` returns
    a LoweredPlan or None."""
    reg = _registry(db)
    key = (template_fp,) + db.store.version_key()
    with reg.lock:
        if key in reg.fp_memo:
            reg.fp_memo.move_to_end(key)
            return reg.fp_memo[key]
    lowered = lower_thunk()
    fp = None
    if lowered is not None:
        pfx = _plan_prefix(lowered)
        if pfx is not None:
            fp = pfx.fp
    with reg.lock:
        reg.fp_memo[key] = fp
        reg.fp_memo.move_to_end(key)
        while len(reg.fp_memo) > _MEMO_MAX:
            reg.fp_memo.popitem(last=False)
    return fp


# ---------------------------------------------------------------------------
# Prefix evaluation — device (truncated bytecode) and host (numpy twin)
# ---------------------------------------------------------------------------


def _nrows(table: Dict[str, np.ndarray]) -> int:
    return len(next(iter(table.values()))) if table else 0


def _eval_prefix_device(lowered, pfx: _Prefix) -> Tuple[Optional[dict], bool]:
    """Run the prefix through the plan-bytecode interpreter with the
    suffix rows overwritten to NOP and ``out_reg`` at the join-tree root.
    Same op-table shape ⇒ same size class as full-plan interpretation.
    Shares the capacity-doubling protocol.  Returns ``(table, on_host)``:
    ``on_host`` when the interpreter declined and the host twin ran."""
    import torch

    from kolibrie_tpu_torch.optimizer import plan_interp as pi
    from kolibrie_tpu_torch.optimizer.device_engine import _note_fetch, _round_cap

    for _attempt in range(12):
        args = lowered.build()[1]
        try:
            prog = pi.compile_bytecode(lowered)
        except pi.InterpUnsupported:
            # size-class budget (cells/ops) exceeded: the host twin is
            # always available and row-identical
            return _eval_prefix_host(lowered, pfx), True
        code = prog.code.copy()
        code[pfx.k :] = 0  # NOP out the suffix
        pprog = pi.InterpProgram(
            code,
            prog.n_ops,
            prog.cap,
            prog.n_slots,
            prog.var_slots,
            pfx.k - 1,
            prog.join_count,
            n_real=pfx.k,
            stat_keys=prog.stat_keys[: pfx.k],
        )
        out_cols, out_valid, counts, _oprows = pi._dispatch(lowered, pprog, args)
        counts_h = counts[: prog.join_count].tolist()
        _note_fetch("mqo.counts")
        overflow = [i for i, c in enumerate(counts_h) if c > lowered._join_caps[i]]
        if not overflow:
            lowered._store_caps()
            keep = torch.nonzero(out_valid).squeeze(1)
            cols_h = out_cols[keep].cpu().numpy()
            _note_fetch("mqo.collect")
            return {
                v: cols_h[:, prog.var_slots[v]].astype(np.uint32) for v in lowered.out_vars
            }, False
        for i in overflow:
            lowered._join_caps[i] = _round_cap(2 * counts_h[i])
        lowered._store_caps()
    raise RuntimeError("mqo prefix capacities failed to converge")


def _eval_prefix_host(lowered, pfx: _Prefix) -> dict:
    """Numpy twin of ``host_execute``'s scan/join cases over the prefix
    subtree — the evaluator for a prefix over the interpreter's budget."""
    from kolibrie_tpu_torch.ops.join import _pack_shared_keys, join_indices
    from kolibrie_tpu_torch.optimizer.device_engine import JoinSpec, ScanSpec

    scan_ranges = lowered._host_scan_ranges()

    def ev(node):
        if isinstance(node, ScanSpec):
            order_name, _consts = lowered.scan_descs[node.scan_idx]
            order = lowered.db.store.order(order_name)
            lo, n = (int(x) for x in scan_ranges[node.scan_idx])
            canon = order.slice_rows(lo, lo + n)
            raw = {0: canon["s"], 1: canon["p"], 2: canon["o"]}
            # no eq_pairs: _emit_rows rejects repeated-variable patterns
            return {var: raw[pos] for var, pos in node.out_vars}
        if isinstance(node, JoinSpec):
            lcols = ev(node.left)
            rcols = ev(node.right)
            lkey, rkey = _pack_shared_keys(
                lcols,
                rcols,
                list(node.key_vars),
                len(next(iter(lcols.values()))),
            )
            li, ri = join_indices(lkey, rkey)
            out = {v: c[li] for v, c in lcols.items()}
            for v, c in rcols.items():
                if v not in out:
                    out[v] = c[ri]
            return out
        raise TypeError(node)  # unreachable: the bytecode split validated

    return ev(pfx.root)


# ---------------------------------------------------------------------------
# Suffix fan-out: host filter twins (host_execute's exact semantics)
# ---------------------------------------------------------------------------

_OPS = {
    "=": np.equal,
    "!=": np.not_equal,
    "<": np.less,
    "<=": np.less_equal,
    ">": np.greater,
    ">=": np.greater_equal,
}


def _expr_mask(lowered, expr, cols, numf):
    from kolibrie_tpu_torch.optimizer.device_engine import (
        BoolNode,
        IdCmp,
        NumCmp,
        NumConstCmp,
    )

    if isinstance(expr, BoolNode):
        # AND-chains only: the bytecode split declined anything else
        m = None
        for a in expr.args:
            m2, numf = _expr_mask(lowered, a, cols, numf)
            m = m2 if m is None else (m & m2)
        return m, numf
    if isinstance(expr, IdCmp):
        eq = cols[expr.var] == np.uint32(lowered.u_params[expr.param_idx])
        return (eq if expr.op == "=" else ~eq), numf
    if numf is None:
        numf = lowered.db.numeric_values()
    if isinstance(expr, NumConstCmp):
        vals = numf[np.minimum(cols[expr.var], len(numf) - 1)]
        with np.errstate(invalid="ignore"):
            res = _OPS[expr.op](vals, lowered.f_params[expr.param_idx])
        return res & ~np.isnan(vals), numf
    if isinstance(expr, NumCmp):
        a = numf[np.minimum(cols[expr.lvar], len(numf) - 1)]
        b = numf[np.minimum(cols[expr.rvar], len(numf) - 1)]
        ok = ~(np.isnan(a) | np.isnan(b))
        with np.errstate(invalid="ignore"):
            res = _OPS[expr.op](a, b)
        if expr.op in ("=", "!="):
            ideq = cols[expr.lvar] == cols[expr.rvar]
            idres = ideq if expr.op == "=" else ~ideq
            return np.where(ok, res, idres), numf
        return res & ok, numf
    raise TypeError(expr)


def _apply_suffix(lowered, pfx: _Prefix, base: dict) -> dict:
    mask = np.ones(_nrows(base), dtype=bool)
    numf = None
    for expr in pfx.exprs:
        m, numf = _expr_mask(lowered, expr, base, numf)
        mask &= m
    # fancy indexing copies: members never alias the cached prefix table
    return {v: np.asarray(base[v])[mask] for v in lowered.out_vars}


# ---------------------------------------------------------------------------
# The sharing decision + the two execution hooks
# ---------------------------------------------------------------------------


def _decide(
    reg: _Registry,
    fp: str,
    owner: Optional[str],
    mode: str,
    est: Optional[float] = None,
) -> bool:
    """Locked by the caller.  ``force`` shares every splittable plan;
    standing owners always share (the win is temporal — the cache
    carries the prefix across fires of an unchanged store); transient
    sharing needs fan-out AND rows clearing the threshold: observed
    actuals when the prefix has run before, the planner's leaf-scan
    estimate (``estimated_prefix_rows``) until then, optimistic when
    neither exists."""
    if mode == "force":
        return True
    if owner is not None:
        return True
    benef = reg.beneficiaries(fp)
    if benef < 2:
        return False
    rows = reg.rows.get(fp)
    if rows is None:
        rows = est
    if rows is None:
        return True
    return rows * (benef - 1) >= _THRESHOLD


def _advisor_prefix_rows(lowered, pfx) -> Optional[float]:
    """Measured prefix output rows from the stats advisor, when it has
    observed the prefix's covered pattern group (under ANY join tree for
    this template) — a far better worthiness signal than the static
    pre-lowering estimate the decision otherwise falls back to."""
    from kolibrie_tpu_torch.optimizer import stats_advisor as _sa

    if _sa.stats_advisor_mode() == "off":
        return None
    view = _sa.stats_advisor.view(_sa.current_fp())
    if not view:
        return None
    from kolibrie_tpu_torch.optimizer.device_engine import JoinSpec, ScanSpec

    def sigs(node):
        if isinstance(node, ScanSpec):
            return [lowered.scan_sigs[node.scan_idx]]
        if isinstance(node, JoinSpec):
            left, right = sigs(node.left), sigs(node.right)
            if left is None or right is None:
                return None
            return left + right
        return None

    got = sigs(pfx.root)
    if got is None:
        return None
    key = "scan:" + got[0] if len(got) == 1 else _sa.subset_key(got)
    return view.get(key)


def try_shared_execute(lowered) -> Optional[dict]:
    """Serve ``lowered`` from a shared prefix.  Returns a host binding
    table, or None — the caller continues down its unchanged path."""
    mode = mqo_mode()
    if mode == "off":
        return None
    db = lowered.db
    reg = _registry(db)
    owner = _tl_owner(reg)
    if mode == "auto" and owner is None and not reg.active():
        return None  # nobody to share with: stay off the hot path
    if not lowered.const_ok():
        return None  # empty-by-constants: the normal path short-circuits
    pfx = _plan_prefix(lowered)
    if pfx is None:
        _DECLINED.labels("shape").inc()
        return None
    with reg.lock:
        if owner is not None:
            reg.bind_standing(owner, pfx.fp)
        est = getattr(lowered, "est_prefix_rows", None)
        learned = _advisor_prefix_rows(lowered, pfx)
        if learned is not None:
            est = learned
        if not _decide(reg, pfx.fp, owner, mode, est):
            _DECLINED.labels("unworthy").inc()
            return None
    key = (pfx.fp,) + db.store.version_key()
    with reg.lock:
        base = reg.cache.get(key)
        if base is not None:
            reg.cache.move_to_end(key)
            reg.hits[pfx.fp] = reg.hits.get(pfx.fp, 0) + 1
    if base is None:
        base, on_host = _eval_prefix_device(lowered, pfx)
        with reg.lock:
            if on_host:
                reg.host_evals[pfx.fp] = reg.host_evals.get(pfx.fp, 0) + 1
            reg.cache[key] = base
            reg.cache.move_to_end(key)
            while len(reg.cache) > _CACHE_MAX:
                reg.cache.popitem(last=False)
            # per-operator actuals feed the next worthiness decision
            reg.rows[pfx.fp] = _nrows(base)
            reg.shared[pfx.fp] = reg.shared.get(pfx.fp, 0) + 1
        _SHARED_EVALS.inc()
        _PREFIX_ROWS.observe(_nrows(base))
    else:
        _CACHE_HITS.inc()
    table = _apply_suffix(lowered, pfx, base)
    _FANOUT.inc()
    cap = _analyze.active()
    if cap is not None:
        with reg.lock:
            benef = reg.beneficiaries(pfx.fp)
        cap.record(
            "mqo",
            prefix=pfx.fp[:12],
            beneficiaries=benef,
            prefix_rows=_nrows(base),
            rows=_nrows(table),
        )
    return table


def try_shared_host(db, plan) -> Optional[dict]:
    """eval_where host-branch hook: lower ``plan`` (memoized per store
    version, the plan object pinned so its id can't recycle) and serve it
    from a shared prefix, evaluated on the store's device."""
    mode = mqo_mode()
    if mode == "off":
        return None
    reg = _registry(db)
    owner = _tl_owner(reg)
    if mode == "auto" and owner is None and not reg.active():
        return None
    from kolibrie_tpu_torch.optimizer.device_engine import Unsupported, lower_plan

    # the memo keys on the PLAN OBJECT's identity, pinned alive in the
    # value so the id can't recycle.  Never on the owner token: an owner
    # is a sharing scope, not a query — the same owner may evaluate
    # different templates, and serving owner A's previous lowering to a
    # different query returns wrong rows
    key = ("plan", id(plan)) + db.store.version_key()
    with reg.lock:
        hit = reg.lowered_memo.get(key)
        if hit is not None:
            reg.lowered_memo.move_to_end(key)
    if hit is not None:
        lowered = hit[1]
    else:
        try:
            lowered = lower_plan(db, plan)
        except Unsupported:
            return None
        with reg.lock:
            # the value keeps ``plan`` alive: a live entry's id is in use
            reg.lowered_memo[key] = (plan, lowered)
            reg.lowered_memo.move_to_end(key)
            while len(reg.lowered_memo) > _MEMO_MAX:
                reg.lowered_memo.popitem(last=False)
    return try_shared_execute(lowered)


# ---------------------------------------------------------------------------
# Surfaces: EXPLAIN line + /stats block
# ---------------------------------------------------------------------------


def describe_shared(db, lowered) -> Optional[str]:
    """One EXPLAIN line describing the sharing decision for this plan;
    None when MQO is off."""
    mode = mqo_mode()
    if mode == "off":
        return None
    pfx = _plan_prefix(lowered)
    if pfx is None:
        return "mqo: no shareable prefix (shape outside scan/join + filter chain)"
    reg = _registry(db)
    with reg.lock:
        benef = reg.beneficiaries(pfx.fp)
        rows = reg.rows.get(pfx.fp)
        evals = reg.shared.get(pfx.fp, 0)
        hits = reg.hits.get(pfx.fp, 0)
        share = _decide(reg, pfx.fp, None, mode) or bool(
            reg.standing_fps.get(pfx.fp)
        )
    return (
        f"mqo: shared prefix={pfx.fp[:12]} ops={pfx.k}/{pfx.n_real}"
        f" beneficiaries={benef}"
        f" rows={'?' if rows is None else rows}"
        f" evals={evals} hits={hits}"
        f" share={'yes' if share else 'no'}"
    )


def stats(db) -> dict:
    """The ``/stats`` ``mqo`` block: mode, standing registrations, and
    per-prefix beneficiary/actuals/hit counts."""
    out = {
        "mode": mqo_mode(),
        "standing": 0,
        "cache_entries": 0,
        "prefixes": {},
    }
    reg = db.__dict__.get("_mqo_registry")
    if reg is None:
        return out
    with reg.lock:
        out["standing"] = len(reg.standing)
        out["cache_entries"] = len(reg.cache)
        fps = set(reg.standing_fps) | set(reg.shared) | set(reg.transient)
        for fp in sorted(fps):
            out["prefixes"][fp[:12]] = {
                "beneficiaries": reg.beneficiaries(fp),
                "rows": reg.rows.get(fp),
                "shared_evals": reg.shared.get(fp, 0),
                "cache_hits": reg.hits.get(fp, 0),
                # port-only: prefix evaluations the interpreter declined
                # to the host twin (0 while every prefix ran on the device)
                "host_evals": reg.host_evals.get(fp, 0),
            }
    return out
