"""Sharded serving: the HTTP front door's mesh execution layer.

Port of ``kolibrie_tpu/parallel/sharded_serving.py``.  The serving path
(http_server -> TemplateBatcher -> executor) gains a
:class:`ShardedDatabase` that keeps the two-tier store (frozen base +
delta segment + tombstones, ``core/store.py``) hash-partitioned across the
shard mesh and device-RESIDENT, so a batched same-template query group
becomes ONE mesh dispatch instead of B single-device runs.

1. **Partition once, mutate by delta.**  The frozen base partitions by
   ``mix32(key) % n`` into per-shard blocks of ``base_cap`` rows, uploaded
   once per ``base_version``.  Mutation batches under ``delta_threshold``
   re-upload only the O(delta) add blocks and tombstone positions; the
   combined view is reassembled on the devices (:func:`_assemble`), so the
   shapes — and with them every serving program — survive insert/delete
   traffic.
2. **One dispatch per template group.**  Same-template queries differ only
   in constants (``query/template.py``); the batched program takes those
   constants as a ``[B, n_slots]`` parameter matrix and evaluates every
   member over the shards: shard-local seed scan (the fused ``filter_mask``
   kernel with the member's constants), fixed-cap all-to-all binding-table
   exchange, local joins against the presorted side (the merge-path
   kernel), replicated filter masks.  The host merge
   (``_finish_select_table``) is the solo path's.
3. **Cross-cutting layers ride the shard hop.**  Deadlines are checked
   before dispatch (``shard.dispatch`` is also a fault-injection site),
   per-template breakers gate the group in the executor, per-shard span
   children and ``kolibrie_shard_*`` counters make imbalance and exchange
   pressure observable, and recovery (WAL replay / snapshot restore)
   rebuilds the mirrors through :meth:`ShardedDatabase.refresh`'s
   staleness check.

The reference's ``lax.map`` over members and ``shard_map`` over shards
become host loops of the controller (batching the shards that share a
card into one launch is later work).  Its ``jit`` program cache survives
as :func:`sharded_compile_stats`: ``batched_programs`` counts the distinct
batched-program signatures (template shape, capacities, batch pad, shard
shapes) built, ``assemble_shapes`` the distinct assembled view shapes, so
mutation batches under the threshold keep both flat.

Plan-cache interaction: the executor's per-template state key carries
:attr:`ShardedDatabase.signature`, so attaching or detaching the mesh can
never replay a plan lowered for the other topology.
"""

from __future__ import annotations

import threading
import time
import weakref
from functools import lru_cache, partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kolibrie_tpu_torch.obs import analyze as _analyze
from kolibrie_tpu_torch.obs import metrics as _m
from kolibrie_tpu_torch.obs.spans import span
from kolibrie_tpu_torch.ops.kernels import filter_mask, merge_join_indices
from kolibrie_tpu_torch.parallel.dist_general import _exchange_table
from kolibrie_tpu_torch.parallel.dist_query import (
    DistQueryExecutor,
    _mask_copies,
    _materialize_masks,
    _query_filters,
)
from kolibrie_tpu_torch.parallel.dist_join import _RPAD32 as _JRPAD
from kolibrie_tpu_torch.parallel.mesh import Mesh, make_mesh, psum, shard_put
from kolibrie_tpu_torch.parallel.sharded_store import ShardedTripleStore, shard_of
from kolibrie_tpu_torch.reasoner.device_fixpoint import LoweredPremise, Unsupported, _scan_premise
from kolibrie_tpu_torch.resilience.deadline import check_deadline
from kolibrie_tpu_torch.resilience.faultinject import fault_point

__all__ = [
    "ShardedDatabase",
    "attach_sharded",
    "detach_sharded",
    "active_sharded",
    "sharded_compile_stats",
    "Unsupported",
]

# ------------------------------------------------------------------ metrics
_SHARD_DISPATCH = _m.counter(
    "kolibrie_shard_dispatch_total",
    "Mesh serving dispatches by path",
    labels=("path",),
)
_SHARD_QUERIES = _m.counter("kolibrie_shard_queries_total", "Queries served through the mesh path")
_SHARD_ROWS = _m.counter(
    "kolibrie_shard_rows_scanned_total",
    "Resident rows visited by shard-local premise scans (static bound)",
)
_SHARD_XBYTES = _m.counter(
    "kolibrie_shard_exchanged_bytes_total",
    "Bytes moved by fixed-cap all-to-all binding-table exchanges "
    "(static buffer size: int64 ID carriers, 8 bytes a column slot, plus "
    "the 1-byte validity slot)",
)
_SHARD_H2D = _m.counter(
    "kolibrie_shard_h2d_bytes_total",
    "Host->device mirror upload bytes by segment (int64 ID carriers and "
    "tombstone positions, 1-byte validity)",
    labels=("segment",),
)
_SHARD_IMBALANCE = _m.gauge(
    "kolibrie_shard_imbalance",
    "max/mean per-shard row occupancy (1.0 = perfectly balanced)",
)
_SHARD_OCCUPANCY = _m.gauge("kolibrie_shard_rows", "Live rows resident per shard", labels=("shard",))
_SHARD_CAP_HITS = _m.counter(
    "kolibrie_shard_exchange_cap_hits_total",
    "Dispatches that overflowed a join/exchange capacity and retried doubled",
)
_SHARD_FALLBACKS = _m.counter(
    "kolibrie_shard_fallback_total",
    "Template groups the mesh path declined",
    labels=("reason",),
)
_SHARD_DISPATCH_LAT = _m.histogram(
    "kolibrie_shard_dispatch_seconds", "Mesh dispatch latency (one group)"
)

# ------------------------------------------------- compile-surface tracking
# One entry per distinct batched-program / assembled-view signature ever
# built — the no-recompile regression asserts these stay flat across
# mutation batches.
_compile_stats = {"batched_programs": 0, "assemble_shapes": 0}
_ASSEMBLE_SHAPES: set = set()
_STATS_LOCK = threading.Lock()


def sharded_compile_stats() -> Dict[str, int]:
    """Counters of distinct program surfaces on the sharded serving path
    (monotonic; flat across mutation batches under ``delta_threshold``)."""
    with _STATS_LOCK:
        return dict(_compile_stats)


# ------------------------------------------------------------ device pieces


def _assemble(base_cols, base_valid, add_cols, add_valid, del_pos):
    """Combine one shard's resident base block with its O(delta) add block
    and tombstones into the view the mesh programs scan: tombstoned base
    rows flip invalid (positions at the ``base_cap`` sentinel land in a
    spare slot that is cut off), then base and delta concatenate."""
    cap = base_valid.shape[0]
    bv = torch.cat([base_valid, base_valid.new_zeros(1)])
    bv[del_pos.clamp(max=cap)] = False
    cols = tuple(torch.cat([b, a]) for b, a in zip(base_cols, add_cols))
    return cols, torch.cat([bv[:cap], add_valid])


def _join_presorted(lkey, lvalid, rsorted, order, cap):
    """:func:`dist_join.local_join_u32` against a PRE-sorted right side:
    the same ``(li, ri, valid, total)`` contract, minus the per-call sort —
    every member of a group joins against the same resident mirror, so the
    sort is hoisted to once per dispatch.  The merge-path kernel's own
    contract (``merge_join_indices``).  ``total`` counts UNFILTERED key
    matches (the side premise's constants apply post-join)."""
    li, rpos, valid, total = merge_join_indices(lkey, rsorted, cap, lvalid=lvalid)
    li, rpos, valid = li[:cap], rpos[:cap], valid[:cap]
    ri = torch.where(valid, order[rpos], 0)
    return li, ri, valid, total


def _bound(prem: LoweredPremise, prm) -> LoweredPremise:
    """A slot-parameterized premise with one member's constants bound."""
    return LoweredPremise(
        tuple(None if c is None else int(prm[c]) for c in prem.consts), prem.vars, prem.eq_pairs
    )


def _side_check(prem: LoweredPremise, side_cols, ri, prm):
    """The side premise's constants and repeated variables, checked at the
    matched rows (one fused ``filter_mask`` pass over the gathered
    columns), or None when it has neither."""
    bound = _bound(prem, prm)
    active = [pos for pos, c in enumerate(bound.consts) if c is not None]
    ok = None
    if active:
        gathered = {pos: side_cols[pos][ri] for pos in active}
        any_col = gathered[active[0]]
        cols = [gathered.get(pos, any_col) for pos in range(3)]
        s_c, p_c, o_c = (-1 if c is None else c for c in bound.consts)
        ok = filter_mask(cols[0], cols[1], cols[2], s_c, p_c, o_c)
    for a, b in prem.eq_pairs:
        eq = side_cols[a][ri] == side_cols[b][ri]
        ok = eq if ok is None else ok & eq
    return ok


def _batched_body(
    state,
    masks,
    params,
    *,
    premises,
    seed,
    steps,
    filters,
    out_vars,
    n,
    join_cap,
    bucket_cap,
    with_stats=False,
):
    """One template group in one mesh dispatch: every member (a row of
    the parameter matrix) runs the shard-local scan -> routed-join ->
    filter pipeline of ``dist_query._query_body``.  Premise ``consts``
    hold SLOT INDICES into the member's parameter row (the template's
    constant-free twin).  Returns per member ``(outs, valid, overflow,
    stats)``: per-shard projected columns and validity, the global
    overrun, and (``with_stats``) the per-shard operator row counts
    ``[seed, (exchange, join) per step, final]``."""
    fcols, fv, gcols, gv = state
    # hoisted per-step side sorts: every member joins against the same
    # resident mirror, so the right side sorts once per dispatch (ties by
    # row); the side premise's constant filters apply post-join
    sides = []
    for j, kv, kpos, extra in steps:
        per = []
        for i in range(n):
            if kpos == 0:
                side_cols, side_valid, side_key = fcols[i], fv[i], fcols[i][0]
            else:
                side_cols, side_valid, side_key = gcols[i], gv[i], gcols[i][2]
            rk = torch.where(side_valid, side_key, _JRPAD)
            order = torch.argsort(rk, stable=True)
            per.append((side_cols, order, rk[order]))
        sides.append(per)

    def count(valids):
        return [v.sum() for v in valids] if with_stats else None

    results = []
    for prm in params:
        ovfs = []
        seed_prem = _bound(premises[seed], prm)
        tables, valids = [], []
        for i in range(n):
            t, v = _scan_premise(seed_prem, fcols[i], fv[i])
            tables.append(t)
            valids.append(v)
        svec = [count(valids)]
        # exchange elision: the seed scans the subject-partitioned mirror,
        # so rows start partitioned by the seed's subject variable; a step
        # keyed on the current partition variable is already co-located
        part = next((v for v, pos in premises[seed].vars if pos == 0), None)
        for (j, kv, kpos, extra), per in zip(steps, sides):
            prem = premises[j]
            if n > 1 and kv != part:
                tables, valids, dropped = _exchange_table(tables, valids, kv, n, bucket_cap)
                ovfs.append(dropped)
                svec.append(count(valids))
            else:
                svec.append(None if not with_stats else [torch.zeros((), dtype=torch.int64)] * n)
            part = kv
            new_tables, new_valids = [], []
            for i, (side_cols, order, rsorted) in enumerate(per):
                table = tables[i]
                li, ri, jvalid, total = _join_presorted(
                    table[kv], valids[i], rsorted, order, join_cap
                )
                ovfs.append((total - join_cap).clamp(min=0))
                ok = _side_check(prem, side_cols, ri, prm)
                if ok is not None:
                    jvalid = jvalid & ok
                new_table = {v: c[li] for v, c in table.items()}
                for v, pos in prem.vars:
                    c = side_cols[pos]
                    if v not in new_table:
                        new_table[v] = c[ri]
                    elif v in extra:
                        jvalid = jvalid & (new_table[v] == c[ri])
                new_tables.append(new_table)
                new_valids.append(jvalid)
            tables, valids = new_tables, new_valids
            svec.append(count(valids))
        valids = [_query_filters(filters, tables[i], valids[i], masks[i]) for i in range(n)]
        svec.append(count(valids))
        outs = [tuple(torch.where(valids[i], tables[i][v], 0) for v in out_vars) for i in range(n)]
        overflow = psum(ovfs) if ovfs else torch.zeros((), dtype=torch.int64)
        results.append((outs, valids, overflow, svec))
    return results


@lru_cache(maxsize=64)
def _get_batched_fn(
    mesh, premises, seed, steps, filters, out_vars, n_masks, join_cap, bucket_cap, b_pad, shapes
):
    """The batched program of one signature (template shape, capacities,
    batch pad, shard shapes), counted once when first built."""
    with _STATS_LOCK:
        _compile_stats["batched_programs"] += 1
    return partial(
        _batched_body,
        premises=premises,
        seed=seed,
        steps=steps,
        filters=filters,
        out_vars=out_vars,
        n=mesh.size,
        join_cap=join_cap,
        bucket_cap=bucket_cap,
    )


def _pad_pow2_mask(m: np.ndarray) -> np.ndarray:
    """Pad a per-ID boolean mask to a power of two with False — mask SHAPES
    then move only when the dictionary doubles, not on every intern."""
    n = len(m)
    cap = max(8, 1 << max(n - 1, 1).bit_length())
    if cap == n:
        return m
    out = np.zeros(cap, dtype=bool)
    out[:n] = m
    return out


# --------------------------------------------------------------- partitioning


def _blocks(cols, dest, n: int, width: int):
    """Rows grouped by destination shard into ``[n, width]`` host blocks
    (int64 carriers) + validity, and each row's position in its block."""
    counts = np.bincount(dest, minlength=n)
    order = np.argsort(dest, kind="stable")
    offs = np.concatenate([[0], np.cumsum(counts)])
    intra = np.empty(len(dest), dtype=np.int64)
    blocks = [np.zeros((n, width), dtype=np.int64) for _ in range(len(cols))]
    valid = np.zeros((n, width), dtype=bool)
    for sh in range(n):
        rows = order[offs[sh] : offs[sh + 1]]
        intra[rows] = np.arange(len(rows))
        for blk, col in zip(blocks, cols):
            blk[sh, : len(rows)] = col[rows]
        valid[sh, : len(rows)] = True
    return blocks, valid, counts, intra


class _HashMirror:
    """One hash-partitioned two-tier mirror (key = subject or object).

    Holds the device-resident base blocks plus the host row -> shard map
    (``base_dest`` / ``base_intra``) that translates the store's global
    tombstone positions into per-shard positions in O(delta)."""

    def __init__(self, key_pos: int):
        self.key_pos = key_pos
        self.base_cols = None  # sharded [base_cap] x3
        self.base_valid = None  # sharded [base_cap], PRE-tombstone
        self.base_dest = None  # host [N] shard of each base row
        self.base_intra = None  # host [N] position within its shard block
        self.base_counts = None  # host [n]
        self.add_cols = None  # sharded [delta_cap] x3
        self.add_valid = None
        self.del_pos = None  # sharded [delta_cap] int64, sentinel = base_cap
        self.add_counts = None  # host [n]
        self.del_counts = None  # host [n]

    def rebuild_base(self, cols, mesh: Mesh, base_cap: int) -> None:
        n = mesh.size
        dest = shard_of(cols[self.key_pos], n)
        blocks, valid, counts, intra = _blocks(cols, dest, n, base_cap)
        self.base_cols = tuple(shard_put(mesh, b) for b in blocks)
        self.base_valid = shard_put(mesh, valid)
        self.base_dest = dest
        self.base_intra = intra
        self.base_counts = counts
        _SHARD_H2D.labels("base").inc(n * base_cap * (3 * 8 + 1))

    def refresh_delta(self, add_cols, del_global_pos, mesh: Mesh, base_cap: int, delta_cap: int):
        n = mesh.size
        dest = shard_of(add_cols[self.key_pos], n)
        if np.bincount(dest, minlength=n).max(initial=0) > delta_cap:
            raise OverflowError("delta shard load exceeds delta_device_cap")
        blocks, valid, counts, _intra = _blocks(add_cols, dest, n, delta_cap)
        # tombstones: global base positions -> (shard, intra) through the
        # maps recorded at base partition time; the sentinel base_cap drops
        # in _assemble
        dpos = np.full((n, delta_cap), base_cap, dtype=np.int64)
        dd = self.base_dest[del_global_pos]
        di = self.base_intra[del_global_pos]
        dcounts = np.bincount(dd, minlength=n)
        if dcounts.max(initial=0) > delta_cap:
            raise OverflowError("tombstone shard load exceeds delta_device_cap")
        dorder = np.argsort(dd, kind="stable")
        doffs = np.concatenate([[0], np.cumsum(dcounts)])
        for sh in range(n):
            rows = dorder[doffs[sh] : doffs[sh + 1]]
            dpos[sh, : len(rows)] = di[rows]
        self.add_cols = tuple(shard_put(mesh, b) for b in blocks)
        self.add_valid = shard_put(mesh, valid)
        self.del_pos = shard_put(mesh, dpos)
        self.add_counts = counts
        self.del_counts = dcounts
        _SHARD_H2D.labels("delta").inc(n * delta_cap * (3 * 8 + 1 + 8))

    def assemble(self):
        shape = (len(self.base_valid), self.base_valid[0].shape[0], self.add_valid[0].shape[0])
        with _STATS_LOCK:
            if shape not in _ASSEMBLE_SHAPES:
                _ASSEMBLE_SHAPES.add(shape)
                _compile_stats["assemble_shapes"] += 1
        per = [
            _assemble(
                tuple(c[i] for c in self.base_cols),
                self.base_valid[i],
                tuple(c[i] for c in self.add_cols),
                self.add_valid[i],
                self.del_pos[i],
            )
            for i in range(len(self.base_valid))
        ]
        cols = tuple(tuple(p[0][k] for p in per) for k in range(3))
        return cols, tuple(p[1] for p in per)

    def occupancy(self) -> np.ndarray:
        return self.base_counts + self.add_counts - self.del_counts


# -------------------------------------------------------------- the database


class ShardedDatabase:
    """Mesh-resident serving twin of one :class:`SparqlDatabase`.

    Owns the two hash mirrors (subject- and object-partitioned), the
    combined :class:`ShardedTripleStore` view the distributed executors
    scan, per-template pinned capacities, and the batched dispatch path.
    All mutating entry points hold :attr:`lock`; the executor calls them
    under the HTTP batcher's ``dispatch_lock`` as well."""

    def __init__(self, db, mesh: Optional[Mesh] = None):
        if mesh is None:
            mesh = make_mesh()
        self.db = db
        self.mesh = mesh
        self.n = mesh.size
        self.axis = mesh.axis_names[0]
        self.lock = threading.RLock()
        self._subj = _HashMirror(0)
        self._obj = _HashMirror(2)
        self.view: Optional[ShardedTripleStore] = None  # guarded by: lock
        self._sig = None  # guarded by: lock
        self._base_ref = None  # guarded by: lock
        self._base_cap_s = 0
        self._base_cap_o = 0
        self._delta_cap = 0
        self._caps: Dict[tuple, Tuple[int, int]] = {}  # guarded by: lock
        self.stats_counters = {
            "base_rebuilds": 0,
            "delta_refreshes": 0,
            "dispatches": 0,
            "batched_queries": 0,
            "fallbacks": 0,
            "cap_hits": 0,
            "last_cap_hit": None,
        }  # guarded by: lock

    @property
    def signature(self) -> tuple:
        """Hashable mesh identity for plan-cache state keys: attaching,
        detaching or resizing the mesh never replays a plan lowered for
        another topology."""
        return ("shards", self.n, self.axis)

    # ------------------------------------------------------------- mirrors

    def refresh(self, force: bool = False) -> bool:
        """Sync the device mirrors to the store's live two-tier state.
        Base blocks re-partition only when ``base_version`` moved (or the
        base arrays were swapped by ``restore()``: the identity of the base
        column is held by a weakref); otherwise only the O(delta) add and
        tombstone blocks re-upload.  Returns True when any device state
        moved."""
        with self.lock:
            st = self.db.store
            sig = st.segment_signature()
            anchor = st.base_rows("spo")[0]
            base_same = self._base_ref is not None and self._base_ref() is anchor
            if not force and sig == self._sig and base_same:
                return False
            base_changed = force or not base_same
            if base_changed:
                bs, bp, bo = st.base_rows("spo")

                # independent caps per mirror: the object partitioning is
                # skew-prone (rdf:type objects pile onto one shard) and must
                # not inflate the subject mirror's scan range
                def _cap_for(col):
                    need = np.bincount(shard_of(col, self.n), minlength=self.n).max() if len(col) else 0
                    return max(8, 1 << max(int(need) - 1, 1).bit_length())

                self._base_cap_s = _cap_for(bs)
                self._base_cap_o = _cap_for(bo)
                self._delta_cap = int(st.delta_device_cap)
                self._subj.rebuild_base((bs, bp, bo), self.mesh, self._base_cap_s)
                self._obj.rebuild_base((bs, bp, bo), self.mesh, self._base_cap_o)
                self.stats_counters["base_rebuilds"] += 1
            adds = st.delta_rows("spo")
            dels = st.delta_del_positions("spo").astype(np.int64)
            for mirror, bcap in ((self._subj, self._base_cap_s), (self._obj, self._base_cap_o)):
                mirror.refresh_delta(adds, dels, self.mesh, bcap, self._delta_cap)
            if self.view is None or base_changed:
                view = ShardedTripleStore.__new__(ShardedTripleStore)
                view.mesh = self.mesh
                view.axis = self.axis
                view.n_shards = self.n
                view.cap = self._base_cap_s + self._delta_cap
                view.subj_packed_sorted = None
                view._subj_index_src = None
                view.subj_index_parts = None
                view._subj_base_packed = None
                view._subj_base_end = None
                view.subj_index_base_builds = 0
                view.subj_index_delta_builds = 0
                self.view = view
            self.view.by_subj, self.view.by_subj_valid = self._subj.assemble()
            self.view.by_obj, self.view.by_obj_valid = self._obj.assemble()
            # two-tier probe index: the base pack survives delta refreshes
            self.view.refresh_subj_index(
                base_end=self._base_cap_s,
                base_valid=self._subj.base_valid,
                del_pos=self._subj.del_pos,
                base_unchanged=not base_changed,
            )
            self._sig = sig
            self._base_ref = weakref.ref(anchor)
            self.stats_counters["delta_refreshes"] += 1
            occ = self._subj.occupancy()
            mean = float(occ.mean()) if len(occ) else 0.0
            _SHARD_IMBALANCE.set(float(occ.max()) / mean if mean > 0 else 1.0)
            for sh in range(self.n):
                _SHARD_OCCUPANCY.labels(str(sh)).set(int(occ[sh]))
            return True

    # ------------------------------------------------------------ execution

    def _pinned_caps(self, fp: str) -> Optional[Tuple[int, int]]:  # kolint: holds[lock]
        bv = self._sig[0] if self._sig else None
        for k in [k for k in self._caps if k[1] != bv]:
            self._caps.pop(k)
        return self._caps.get((fp, bv))

    def execute(self, sparql: str) -> List[List[str]]:
        """Solo mesh execution of one SELECT (bench/diagnostic path; the
        serving integration dispatches template GROUPS through
        :meth:`execute_batch`).  Raises :class:`Unsupported` for queries
        the distributed lowering declines."""
        with self.lock:
            self.refresh()
            check_deadline("shard.dispatch")
            fault_point("shard.dispatch")
            ex = DistQueryExecutor(self.mesh, self.db, sparql, store=self.view)
            t0 = time.perf_counter()
            with span("shard.dispatch", shards=self.n, batch=1):
                rows = ex.run()
            _SHARD_DISPATCH_LAT.observe(time.perf_counter() - t0)
            _SHARD_DISPATCH.labels("solo").inc()
            _SHARD_QUERIES.inc()
            self.stats_counters["dispatches"] += 1
            return rows

    def warm(self, sparql: str) -> bool:
        """Run the mesh path for one template off the request path (the
        background warmer's entry): lowering, calibration, the kernel
        build and the first dispatch happen here.  Returns False (instead
        of raising) for templates the distributed lowering declines."""
        try:
            self.execute(sparql)
        except Unsupported:
            return False
        with self.lock:
            self.stats_counters["prewarmed"] = self.stats_counters.get("prewarmed", 0) + 1
        return True

    def execute_batch(self, fp: str, items: List[Tuple[int, str]]) -> Dict[int, List[List[str]]]:
        """One template group -> one mesh dispatch.  ``items`` is
        ``[(caller_index, sparql), ...]`` of same-fingerprint plain
        SELECTs; returns ``{caller_index: rows}`` with rows identical to
        the solo host path.  Raises :class:`Unsupported` when the group
        cannot ride the parameterized program (the caller falls through
        to the single-device paths), and lets device faults / deadline
        misses propagate for the breaker protocol."""
        from kolibrie_tpu_torch.query.executor import _finish_select_table
        from kolibrie_tpu_torch.query.template import cap_advisor

        with self.lock:
            self.refresh()
            check_deadline("shard.dispatch")
            caps = self._pinned_caps(fp)
            if caps is None:
                # a base-version bump dropped the pinned caps — start from
                # the advisor's process-wide high-water mark
                advised = cap_advisor.advise("sharded", fp)
                if advised is not None and len(advised) == 2:
                    caps = (int(advised[0]), int(advised[1]))
            kw = {"join_cap": caps[0], "bucket_cap": caps[1]} if caps else {}
            try:
                exemplar = DistQueryExecutor(self.mesh, self.db, items[0][1], store=self.view, **kw)
            except Unsupported:
                self.stats_counters["fallbacks"] += 1
                _SHARD_FALLBACKS.labels("unsupported").inc()
                raise
            if (
                exemplar.agg_items
                or exemplar.query.group_by
                or exemplar.binds
                or exemplar.union_specs
                or exemplar.optional_specs
                or exemplar.anti
                or exemplar.values_var is not None
                or exemplar.query.order_by
            ):
                # _batchable_select filters these; belt and braces for
                # direct callers
                self.stats_counters["fallbacks"] += 1
                _SHARD_FALLBACKS.labels("shape").inc()
                raise Unsupported("clause shape stays on the single-device path")
            execs = [exemplar]
            for _idx, text in items[1:]:
                execs.append(
                    DistQueryExecutor(
                        self.mesh,
                        self.db,
                        text,
                        store=self.view,
                        join_cap=exemplar.join_cap,
                        bucket_cap=exemplar.bucket_cap,
                    )
                )

            # structural agreement: the group shares one constant-free
            # shape; filter constants must MATCH (this path parameterizes
            # pattern constants, the common serving variation)
            def shape_of(ex):
                return (
                    tuple(
                        (tuple(c is not None for c in pr.consts), pr.vars, pr.eq_pairs)
                        for pr in ex.premises
                    ),
                    ex.seed,
                    ex.steps,
                    ex.filters,
                    ex.mask_exprs,
                    ex.out_vars,
                )

            shape0 = shape_of(exemplar)
            if any(shape_of(ex) != shape0 for ex in execs[1:]):
                self.stats_counters["fallbacks"] += 1
                _SHARD_FALLBACKS.labels("divergent").inc()
                raise Unsupported("group members diverge beyond pattern constants")
            # constant slots -> parameter matrix [B, n_slots]
            slots = [
                (i, pos)
                for i, pr in enumerate(exemplar.premises)
                for pos in range(3)
                if pr.consts[pos] is not None
            ]
            slot_idx = {sp: k for k, sp in enumerate(slots)}
            param_premises = tuple(
                LoweredPremise(
                    tuple(slot_idx[(i, pos)] if c is not None else None for pos, c in enumerate(pr.consts)),
                    pr.vars,
                    pr.eq_pairs,
                )
                for i, pr in enumerate(exemplar.premises)
            )
            b = len(execs)
            b_pad = max(2, 1 << max(b - 1, 1).bit_length())
            params = [
                tuple(int(ex.premises[i].consts[pos]) for i, pos in slots) for ex in execs
            ]
            host_masks = [
                _pad_pow2_mask(np.asarray(m)) for m in _materialize_masks(self.db, exemplar.mask_exprs)
            ]
            masks = _mask_copies(self.mesh, host_masks)
            state = self.view.shard_state()
            shapes = tuple(t.shape[0] for t in (*state[1], *state[3]))
            fault_point("shard.dispatch")
            join_cap, bucket_cap = exemplar.join_cap, exemplar.bucket_cap
            cap_rec = _analyze.active()
            t0 = time.perf_counter()
            with span("shard.dispatch", shards=self.n, batch=b, template=fp):
                for _attempt in range(8):
                    fn = _get_batched_fn(
                        self.mesh,
                        param_premises,
                        exemplar.seed,
                        exemplar.steps,
                        exemplar.filters,
                        exemplar.out_vars,
                        len(masks[0]),
                        join_cap,
                        bucket_cap,
                        b_pad,
                        shapes,
                    )
                    members = fn(state, masks, params, with_stats=cap_rec is not None)
                    overflow = psum([m[2] for m in members])
                    if int(overflow) == 0:
                        break
                    join_cap *= 2
                    bucket_cap *= 2
                    self.stats_counters["cap_hits"] += 1
                    self.stats_counters["last_cap_hit"] = time.time()
                    _SHARD_CAP_HITS.inc()
                    cap_advisor.observe_retry("sharded", fp)
                else:
                    raise RuntimeError("sharded batch capacities failed to converge")
                # one readback: [B, n, cap] per projected column + validity
                dev0 = self.mesh.devices[0]
                valid_np = torch.stack(
                    [torch.stack([v.to(dev0) for v in m[1]]) for m in members]
                ).cpu().numpy()
                out_np = [
                    torch.stack(
                        [torch.stack([o[k].to(dev0) for o in m[0]]) for m in members]
                    ).cpu().numpy()
                    for k in range(len(exemplar.out_vars))
                ]
                if cap_rec is not None:
                    stat_names = ["seed"]
                    for k in range(len(exemplar.steps)):
                        stat_names += [f"exchange{k}", f"join{k}"]
                    stat_names.append("final")
                    for r, m in enumerate(members):
                        # [n_stats, n] per member
                        per_shard = [[int(x) for x in col] for col in m[3]]
                        cap_rec.record(
                            "sharded",
                            member=r,
                            template=fp,
                            shards=self.n,
                            steps=[(j, kv) for (j, kv, _kp, _ex) in exemplar.steps],
                            stat_names=stat_names,
                            per_shard=per_shard,
                            operators={
                                name: int(sum(per_shard[i])) for i, name in enumerate(stat_names)
                            },
                            caps=[join_cap, bucket_cap],
                        )
                # per-shard span children: surviving rows per shard across
                # the group (the observable imbalance of THIS dispatch)
                per_shard_rows = valid_np.sum(axis=(0, 2))
                for sh in range(self.n):
                    with span("shard.partition", shard=sh, rows=int(per_shard_rows[sh])):
                        pass
            _SHARD_DISPATCH_LAT.observe(time.perf_counter() - t0)
            bv = self._sig[0]
            self._caps[(fp, bv)] = (join_cap, bucket_cap)
            cap_advisor.observe("sharded", fp, (join_cap, bucket_cap), base_version=bv)
            occ_total = int(self._subj.occupancy().sum())
            _SHARD_ROWS.inc(occ_total * (1 + len(exemplar.steps)) * b)
            width = len({v for v, _ in exemplar.premises[exemplar.seed].vars})
            xbytes = 0
            # _batched_body's elision: co-partitioned steps move no bytes
            part = next((v for v, pos in exemplar.premises[exemplar.seed].vars if pos == 0), None)
            for j, kv, _kpos, _extra in exemplar.steps:
                if self.n > 1 and kv != part:
                    xbytes += (width * 8 + 1) * self.n * self.n * bucket_cap
                part = kv
                width += len({v for v, _ in exemplar.premises[j].vars})
            _SHARD_XBYTES.inc(xbytes * b)
            _SHARD_DISPATCH.labels("batched").inc()
            _SHARD_QUERIES.inc(b)
            self.stats_counters["dispatches"] += 1
            self.stats_counters["batched_queries"] += b
            # host merge: per member, the solo path's post-pass
            results: Dict[int, List[List[str]]] = {}
            for r, ((idx, _text), ex) in enumerate(zip(items, execs)):
                v = valid_np[r].ravel()
                table = {
                    var: out_np[k][r].ravel()[v].astype(np.uint32)
                    for k, var in enumerate(exemplar.out_vars)
                }
                results[idx] = _finish_select_table(self.db, ex.query, table)
            return results

    # -------------------------------------------------------------- health

    def stats(self) -> dict:
        """Shard-level health for ``/stats`` (and the ``/metrics``
        gauges): shard count, per-shard row occupancy, imbalance, last
        exchange cap hit, rebuild/dispatch counters."""
        with self.lock:
            out = {
                "shards": self.n,
                "signature": list(self.signature),
                "base_cap": {"subj": self._base_cap_s, "obj": self._base_cap_o},
                "delta_cap": self._delta_cap,
            }
            out.update(self.stats_counters)
            if self._subj.base_counts is not None:
                occ = self._subj.occupancy()
                mean = float(occ.mean()) if len(occ) else 0.0
                out["occupancy"] = [int(x) for x in occ]
                out["imbalance"] = float(occ.max()) / mean if mean > 0 else 1.0
            out["compile_surfaces"] = sharded_compile_stats()
            return out


# ----------------------------------------------------------------- attaching


def attach_sharded(db, mesh: Optional[Mesh] = None) -> Optional[ShardedDatabase]:
    """Create (or return) the :class:`ShardedDatabase` riding ``db``.
    Without a ``mesh`` it needs a database on a CUDA card and two or more
    cards (the default mesh is every card once) and returns None otherwise,
    so callers can attach unconditionally.  The executor and the obs/stats
    exporters discover it through ``db.__dict__['_sharded_serving']``."""
    existing = db.__dict__.get("_sharded_serving")
    if existing is not None:
        return existing
    if mesh is None:
        if db.device.type != "cuda" or torch.cuda.device_count() < 2:
            return None
        mesh = make_mesh()
    sh = ShardedDatabase(db, mesh)
    db.__dict__["_sharded_serving"] = sh
    return sh


def detach_sharded(db) -> None:
    db.__dict__.pop("_sharded_serving", None)


def active_sharded(db) -> Optional[ShardedDatabase]:
    return db.__dict__.get("_sharded_serving")
