"""Columnar triple store with sorted orders and its two-tier device mirror.

Port of ``kolibrie_tpu/core/store.py``.  The host side is the reference's
unchanged: deduplicated u32 columns, six lazily built lexicographic sort
orders (SPO, POS, OSP, PSO, OPS, SOP), and incremental compaction that
keeps a frozen **base** (as of ``base_version``) plus a small **delta**
(sorted adds and base-row tombstones, advanced by ``delta_epoch``).

:meth:`ColumnarTripleStore.device_segment` mirrors one order onto the
store's torch device as int64 carriers of the u32 columns
(:mod:`kolibrie_tpu_torch.backend`): the base padded to a power of two with
``0xFFFFFFFF`` and uploaded once per ``base_version``, the delta padded to
:attr:`~ColumnarTripleStore.delta_device_cap` and uploaded once per
``delta_epoch`` together with the tombstone positions.
"""

from __future__ import annotations

import itertools
from typing import Iterator, Optional, Tuple

import numpy as np

import torch

from kolibrie_tpu_torch.backend import DeviceLike, resolve_device
from kolibrie_tpu_torch.core.triple import Triple
from kolibrie_tpu_torch.obs.metrics import counter as _obs_counter
from kolibrie_tpu_torch.obs.metrics import gauge as _obs_gauge
from kolibrie_tpu_torch.ops import round_cap

_EMPTY = np.empty(0, dtype=np.uint32)

# the reference store's metric families (``kolibrie_tpu/core/store.py``)
_H2D_BYTES = _obs_counter(
    "kolibrie_store_h2d_bytes_total",
    "Bytes uploaded host->device by the store, by segment kind.",
    labels=("segment",),
)
_DELTA_MERGES = _obs_counter(
    "kolibrie_store_delta_merges_total",
    "Delta segments folded into the base segment (rare full uploads).",
)
_ORDER_REBUILDS = _obs_counter(
    "kolibrie_store_order_rebuilds_total",
    "Full from-scratch sort-order rebuilds (non-incremental compactions).",
)
_DELTA_ROWS = _obs_gauge(
    "kolibrie_store_delta_rows",
    "Current delta occupancy (add rows + tombstones vs the base segment).",
)

_VERSION_COUNTER = itertools.count(1)

def _lex_sort_rows(s: np.ndarray, p: np.ndarray, o: np.ndarray):
    """Return row permutation sorting lexicographically by (s, p, o)."""
    return np.lexsort((o, p, s))


def _pack2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pack two u32 columns into one u64 sort/search key."""
    return (a.astype(np.uint64) << np.uint64(32)) | b.astype(np.uint64)


def _member_mask(
    key01: np.ndarray, c2: np.ndarray, d_key01: np.ndarray, d_c2: np.ndarray
) -> np.ndarray:
    """Boolean mask over sorted rows ``(key01, c2)`` marking rows present in
    the probe set ``(d_key01, d_c2)``.

    Small probe sets (the incremental-mutation steady state) probe INTO the
    store: two batched ``searchsorted`` on the delta — O(delta·log n) — plus
    an in-group refinement per candidate, so the cost scales with the delta,
    not the store.  Large probe sets (bulk evictions through the full
    compaction) flip direction: the probe rows are dense-ranked into a
    sortable u64 composite and every store row maps into that space with two
    fully-vectorized binary searches — O((n + m)·log m), no Python loop.
    """
    n = len(key01)
    m = len(d_key01)
    mask = np.zeros(n, dtype=bool)
    if m == 0 or n == 0:
        return mask
    if m * 32 <= n:
        lo = np.searchsorted(key01, d_key01, side="left")
        hi = np.searchsorted(key01, d_key01, side="right")
        for i in np.flatnonzero(hi > lo):
            l = lo[i] + int(
                np.searchsorted(c2[lo[i] : hi[i]], d_c2[i], side="left")
            )
            if l < hi[i] and c2[l] == d_c2[i]:
                mask[l] = True
        return mask
    order = np.lexsort((d_c2, d_key01))
    dk, dc = d_key01[order], d_c2[order]
    uk, inv = np.unique(dk, return_inverse=True)
    comp_d = (inv.astype(np.uint64) << np.uint64(32)) | dc.astype(np.uint64)
    g = np.searchsorted(uk, key01)
    gc = np.clip(g, 0, len(uk) - 1)
    cand = uk[gc] == key01
    comp_s = (gc.astype(np.uint64) << np.uint64(32)) | c2.astype(np.uint64)
    idx = np.clip(np.searchsorted(comp_d, comp_s), 0, len(comp_d) - 1)
    return cand & (comp_d[idx] == comp_s)


def _insert_positions(
    key01: np.ndarray, c2: np.ndarray, b_key: np.ndarray, b_c2: np.ndarray
) -> np.ndarray:
    """Insertion positions for a lexsorted batch into sorted ``(key01, c2)``
    rows.  Only batch rows landing inside an existing ``key01`` group need
    the in-group ``c2`` refinement probe."""
    lo = np.searchsorted(key01, b_key, side="left")
    hi = np.searchsorted(key01, b_key, side="right")
    pos = lo.astype(np.int64)
    for i in np.flatnonzero(hi > lo):
        pos[i] = lo[i] + int(np.searchsorted(c2[lo[i] : hi[i]], b_c2[i], side="left"))
    return pos


def _insert_positions_fresh(
    key01: np.ndarray, c2: np.ndarray, b_key: np.ndarray, b_c2: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Like :func:`_insert_positions` but also reports which batch rows are
    absent from the store (``fresh``); exact matches are duplicates."""
    lo = np.searchsorted(key01, b_key, side="left")
    hi = np.searchsorted(key01, b_key, side="right")
    pos = lo.astype(np.int64)
    fresh = np.ones(len(b_key), dtype=bool)
    for i in np.flatnonzero(hi > lo):
        sub = c2[lo[i] : hi[i]]
        l2 = int(np.searchsorted(sub, b_c2[i], side="left"))
        pos[i] = lo[i] + l2
        if l2 < len(sub) and sub[l2] == b_c2[i]:
            fresh[i] = False
    return pos, fresh


def _insert_rows(pos: np.ndarray, pairs) -> tuple:
    """Merge-insert the same row positions into several parallel arrays at
    once.  ``pairs`` is ``[(old, new), ...]`` with ``pos`` the (sorted,
    pre-shift) insertion index of each ``new`` row into every ``old`` —
    the scatter targets are computed once instead of per ``np.insert``
    call."""
    n = len(pairs[0][0])
    m = len(pos)
    outs = []
    if m <= 64:
        # contiguous slice copies (pure memcpy) beat boolean scatter by ~3x
        # for the steady-state tiny batches
        bounds = [0] + [int(x) for x in pos] + [n]
        for old, new in pairs:
            out = np.empty(n + m, dtype=old.dtype)
            for i in range(m + 1):
                lo, hi = bounds[i], bounds[i + 1]
                out[lo + i : hi + i] = old[lo:hi]
                if i < m:
                    out[bounds[i + 1] + i] = new[i]
            outs.append(out)
        return tuple(outs)
    tgt = pos + np.arange(m)
    keep = np.ones(n + m, dtype=bool)
    keep[tgt] = False
    for old, new in pairs:
        out = np.empty(n + m, dtype=old.dtype)
        out[keep] = old
        out[tgt] = new
        outs.append(out)
    return tuple(outs)


class SortedOrder:
    """One lexicographic sort order over the triple columns.

    ``perm`` names the column priority, e.g. ("s","p","o") or ("p","o","s").
    Materializes reordered copies c0,c1,c2 plus the packed (c0,c1) key for
    two-level prefix range queries.
    """

    __slots__ = ("perm", "c0", "c1", "c2", "key01")

    def __init__(self, perm: Tuple[str, str, str], cols: dict, presorted: bool = False):
        self.perm = perm
        a, b, c = (cols[perm[0]], cols[perm[1]], cols[perm[2]])
        if presorted:
            # caller guarantees (a, b, c) is already lexsorted — the store's
            # canonical columns ARE the SPO order
            self.c0, self.c1, self.c2 = a, b, c
        else:
            order = _lex_sort_rows(a, b, c)
            self.c0 = a[order]
            self.c1 = b[order]
            self.c2 = c[order]
        self.key01 = _pack2(self.c0, self.c1)

    @classmethod
    def from_parts(
        cls,
        perm: Tuple[str, str, str],
        c0: np.ndarray,
        c1: np.ndarray,
        c2: np.ndarray,
        key01: np.ndarray,
    ) -> "SortedOrder":
        """Wrap already-sorted column arrays without re-sorting — the
        incremental compaction path maintains each order by merge-insert and
        rebuilds the object around the updated arrays."""
        so = cls.__new__(cls)
        so.perm = perm
        so.c0, so.c1, so.c2 = c0, c1, c2
        so.key01 = key01
        return so

    def __len__(self) -> int:
        return len(self.c0)

    def range0(self, v0: int) -> Tuple[int, int]:
        lo = int(np.searchsorted(self.c0, v0, side="left"))
        hi = int(np.searchsorted(self.c0, v0, side="right"))
        return lo, hi

    def range01(self, v0: int, v1: int) -> Tuple[int, int]:
        k = (np.uint64(v0) << np.uint64(32)) | np.uint64(v1)
        lo = int(np.searchsorted(self.key01, k, side="left"))
        hi = int(np.searchsorted(self.key01, k, side="right"))
        return lo, hi

    def range012(self, v0: int, v1: int, v2: int) -> Tuple[int, int]:
        lo, hi = self.range01(v0, v1)
        sub = self.c2[lo:hi]
        l2 = int(np.searchsorted(sub, v2, side="left"))
        h2 = int(np.searchsorted(sub, v2, side="right"))
        return lo + l2, lo + h2

    def slice_rows(self, lo: int, hi: int) -> dict:
        """Columns for rows [lo, hi) keyed by canonical column name."""
        return {
            self.perm[0]: self.c0[lo:hi],
            self.perm[1]: self.c1[lo:hi],
            self.perm[2]: self.c2[lo:hi],
        }


def _updated_order(so: SortedOrder, ins_cols, del_cols) -> SortedOrder:
    """Incrementally maintained copy of one sort order: drop the deleted
    rows (vectorized membership probe) then merge-insert the fresh rows
    (packed-key ``searchsorted``).  O(delta·log n) probes + O(n) copies
    instead of an O(n log n) re-lexsort."""
    perm = so.perm
    c0, c1, c2, key01 = so.c0, so.c1, so.c2, so.key01
    if del_cols is not None:
        by = {"s": del_cols[0], "p": del_cols[1], "o": del_cols[2]}
        d0, d1, d2 = by[perm[0]], by[perm[1]], by[perm[2]]
        mask = _member_mask(key01, c2, _pack2(d0, d1), d2)
        if mask.any():
            keep = ~mask
            c0, c1, c2, key01 = c0[keep], c1[keep], c2[keep], key01[keep]
    if ins_cols is not None:
        by = {"s": ins_cols[0], "p": ins_cols[1], "o": ins_cols[2]}
        i0, i1, i2 = by[perm[0]], by[perm[1]], by[perm[2]]
        order = np.lexsort((i2, i1, i0))
        i0, i1, i2 = i0[order], i1[order], i2[order]
        ik = _pack2(i0, i1)
        pos = _insert_positions(key01, c2, ik, i2)
        c0, c1, c2, key01 = _insert_rows(
            pos, [(c0, i0), (c1, i1), (c2, i2), (key01, ik)]
        )
    return SortedOrder.from_parts(perm, c0, c1, c2, key01)


class ColumnarTripleStore:
    """Deduplicated triple set stored as sorted u32 columns.

    Mutations buffer host-side; any read compacts (merge + lexsort + unique).
    Mirrors the role of ``UnifiedIndex`` + ``BTreeSet<Triple>`` in the
    reference, in columnar form.

    Two-tier state: the **live** columns/orders always reflect every
    compacted mutation; alongside them the store tracks a frozen **base**
    (the live state as of the last delta→base merge, identified by
    :attr:`base_version`) plus the small symmetric difference
    ``live = base - delta_del + delta_add``.  Device consumers scan the
    base segment merged with the delta segment (:meth:`device_segment`),
    so per-batch host→device traffic is O(delta); host consumers keep using
    the live orders and never see the split.
    """

    # The three primary orders cover every bound-combination lookup (the
    # hexastore insight); the other three exist so scans can present ANY free
    # column pre-sorted to the device engine's sort-free merge joins (the
    # TPU analogue of the reference picking its PSO permutation for
    # subject-keyed merge joins, join_algorithm.rs:19-131).  All are built
    # lazily on first use.
    _ORDER_PERMS = {
        "spo": ("s", "p", "o"),
        "pos": ("p", "o", "s"),
        "osp": ("o", "s", "p"),
        "pso": ("p", "s", "o"),
        "ops": ("o", "p", "s"),
        "sop": ("s", "o", "p"),
    }

    #: Delta occupancy (adds + tombstones) above which the delta folds into
    #: the base segment.  Also fixes the device delta capacity, so changing
    #: it on a live store re-shapes (and recompiles) device plans — set it
    #: before first use.
    DELTA_THRESHOLD_DEFAULT = 1024

    def __init__(self, device: DeviceLike = None) -> None:
        #: torch device of the two-tier mirror (:meth:`device_segment`): the
        #: CUDA card unless the caller passes another
        self.device = resolve_device(device)
        self._s = _EMPTY
        self._p = _EMPTY
        self._o = _EMPTY
        self._pending_add: list = []  # list of (s,p,o) tuples or (N,3) arrays
        self._pending_del: set = set()
        #: Optional mutation journal hook ``journal(event, payload)`` set by
        #: the durability manager.  Fires at mutation BUFFER time, on the
        #: host arrays before any device upload — the exact add_batch/remove
        #: units the reference journals, so both packages write the same
        #: WAL records.  Events: ``("add", (N,3) uint32 array)``,
        #: ``("add1", (s,p,o))``, ``("del", (s,p,o))``, ``("clear", None)``.
        #: Never set on clones or snapshot/restore twins (derived stores
        #: are CONFIGURATION).
        self.journal = None
        self._orders: dict = {}
        # Globally-unique version per compacted state: two stores (or one
        # store at two times) share a version IFF they hold identical column
        # arrays.  snapshot/restore reuses the saved state's version, so a
        # post-restore compaction must never collide with a version handed
        # out before the restore — hence a process-wide counter, not +1.
        self._version = next(_VERSION_COUNTER)
        # -- base/delta segmentation (device mirror + cache keying) --------
        self._base_s = _EMPTY
        self._base_p = _EMPTY
        self._base_o = _EMPTY
        self._base_orders: dict = {}
        self._base_version = self._version  # base == live == empty
        self._delta_add_set: set = set()  # live rows absent from base
        self._delta_del_set: set = set()  # base rows absent from live
        self._delta_epoch = 0
        self._delta_orders: dict = {}  # per-epoch SortedOrder over the adds
        self._delta_del_pos: dict = {}  # per-epoch tombstone positions/order
        self._device_segments: dict = {}  # per-base_version device base cols
        self._device_delta: dict = {}  # per-epoch device delta cols + pos
        self.delta_threshold = self.DELTA_THRESHOLD_DEFAULT
        #: Kill switch: False forces every compaction down the full
        #: rebuild-and-merge path (pre-segmentation behavior; every batch
        #: bumps base_version).  The ingest bench uses it as the oracle.
        self.incremental = True

    # ------------------------------------------------------------- mutation

    def add(self, s: int, p: int, o: int) -> None:
        self._pending_add.append((int(s), int(p), int(o)))
        self._pending_del.discard((int(s), int(p), int(o)))
        if self.journal is not None:
            self.journal("add1", (int(s), int(p), int(o)))

    def add_triple(self, t: Triple) -> None:
        self.add(t.subject, t.predicate, t.object)

    def add_batch(self, s: np.ndarray, p: np.ndarray, o: np.ndarray) -> None:
        arr = np.stack(
            [
                np.asarray(s, dtype=np.uint32),
                np.asarray(p, dtype=np.uint32),
                np.asarray(o, dtype=np.uint32),
            ],
            axis=1,
        )
        if self._pending_del and len(arr):
            # Only a batch that actually re-adds a pending delete needs the
            # deletes applied first (so remove-then-readd via batch honors
            # mutation order).  Disjoint delete+insert traffic — the RSP
            # window-slide shape — stays buffered in one compaction.
            dl = np.asarray(list(self._pending_del), dtype=np.uint32)
            cand = np.flatnonzero(
                np.isin(_pack2(arr[:, 0], arr[:, 1]), np.unique(_pack2(dl[:, 0], dl[:, 1])))
            )
            if len(cand):
                rows = set(map(tuple, arr[cand].tolist()))
                if not rows.isdisjoint(self._pending_del):
                    self.compact()
        self._pending_add.append(arr)
        if self.journal is not None:
            self.journal("add", arr)

    def remove(self, s: int, p: int, o: int) -> None:
        key = (int(s), int(p), int(o))
        self._pending_del.add(key)
        if self.journal is not None:
            self.journal("del", key)

    def remove_batch(self, s: np.ndarray, p: np.ndarray, o: np.ndarray) -> None:
        """:meth:`remove` of every row of the three columns (journaled row
        by row, in order, as the reference's per-row deletes are)."""
        keys = list(
            zip(
                np.asarray(s, dtype=np.int64).tolist(),
                np.asarray(p, dtype=np.int64).tolist(),
                np.asarray(o, dtype=np.int64).tolist(),
            )
        )
        self._pending_del.update(keys)
        if self.journal is not None:
            for key in keys:
                self.journal("del", key)

    def clear(self) -> None:
        self._s = self._p = self._o = _EMPTY
        self._pending_add = []
        self._pending_del = set()
        self._invalidate()
        self._merge_base()
        if self.journal is not None:
            self.journal("clear", None)

    # ------------------------------------------------------------ compaction

    def _invalidate(self) -> None:
        self._orders = {}
        self._version = next(_VERSION_COUNTER)

    def _merge_base(self) -> None:
        """Fold the delta into the base: base := live.  The one operation
        that moves ``base_version`` (and thus re-uploads device base
        segments and invalidates plan caches keyed on it)."""
        self._base_s, self._base_p, self._base_o = self._s, self._p, self._o
        # copy: later lazy order() fill-ins must not leak into the frozen base
        self._base_orders = dict(self._orders)
        self._base_version = self._version
        self._delta_add_set = set()
        self._delta_del_set = set()
        self._delta_orders = {}
        self._delta_del_pos = {}
        self._device_segments = {}
        self._device_delta = {}
        _DELTA_ROWS.set(0)

    def compact(self) -> None:
        if not self._pending_add and not self._pending_del:
            return
        parts_s = []
        parts_p = []
        parts_o = []
        singles = []
        n_add = 0
        for item in self._pending_add:
            if isinstance(item, tuple):
                singles.append(item)
                n_add += 1
            else:
                parts_s.append(item[:, 0])
                parts_p.append(item[:, 1])
                parts_o.append(item[:, 2])
                n_add += len(item)
        if singles:
            arr = np.asarray(singles, dtype=np.uint32)
            parts_s.append(arr[:, 0])
            parts_p.append(arr[:, 1])
            parts_o.append(arr[:, 2])
        self._pending_add = []
        dels = self._pending_del
        self._pending_del = set()
        if parts_s:
            a_s = np.concatenate(parts_s)
            a_p = np.concatenate(parts_p)
            a_o = np.concatenate(parts_o)
        else:
            a_s = a_p = a_o = _EMPTY
        n = len(self._s)
        if self.incremental and n and n_add * 16 < n:
            # Small batch into a big sorted base: merge-insert by binary
            # search — O(batch·log n) probes + one O(n) copy — instead of
            # re-lexsorting the whole store (the fixpoint engines append a
            # few derived rows per round; a full O(n log n) sort per round
            # made every seeded closure cost O(store), not O(cone)).
            self._compact_incremental(a_s, a_p, a_o, dels)
        else:
            self._compact_full(a_s, a_p, a_o, dels)

    def _compact_incremental(self, a_s, a_p, a_o, dels) -> None:
        """O(delta) compaction: merge-insert the batch into the canonical
        columns and every built order, probe deletes in one vectorized
        batch, and advance ``delta_epoch`` while ``base_version`` (and with
        it the device base segment and all plan caches) stands still."""
        # The canonical columns ARE the spo order, so its packed key can be
        # carried through the same insert/keep steps below — avoiding three
        # full-store _pack2 passes (insert probe, delete probe, spo rebuild).
        spo = self._orders.get("spo")
        key01 = spo.key01 if spo is not None else _pack2(self._s, self._p)
        if len(a_s):
            order = _lex_sort_rows(a_s, a_p, a_o)
            a_s, a_p, a_o = a_s[order], a_p[order], a_o[order]
            if len(a_s) > 1:
                dup = (
                    (a_s[1:] == a_s[:-1])
                    & (a_p[1:] == a_p[:-1])
                    & (a_o[1:] == a_o[:-1])
                )
                keep = np.concatenate(([True], ~dup))
                a_s, a_p, a_o = a_s[keep], a_p[keep], a_o[keep]
            ak = _pack2(a_s, a_p)
            pos, fresh = _insert_positions_fresh(key01, self._o, ak, a_o)
            a_s, a_p, a_o = a_s[fresh], a_p[fresh], a_o[fresh]
            pos, ak = pos[fresh], ak[fresh]
        if len(a_s):
            s, p, o, key01 = _insert_rows(
                pos,
                [(self._s, a_s), (self._p, a_p), (self._o, a_o), (key01, ak)],
            )
            ins_set = set(zip(a_s.tolist(), a_p.tolist(), a_o.tolist()))
        else:
            s, p, o = self._s, self._p, self._o
            ins_set = set()
        drop_set = set()
        if dels and len(s):
            dl = np.asarray(sorted(dels), dtype=np.uint32)
            drop = _member_mask(
                key01, o, _pack2(dl[:, 0], dl[:, 1]), dl[:, 2]
            )
            if drop.any():
                drop_set = set(
                    zip(s[drop].tolist(), p[drop].tolist(), o[drop].tolist())
                )
                keep = ~drop
                s, p, o = s[keep], p[keep], o[keep]
                key01 = key01[keep]
        # rows both inserted and deleted in the same batch net out entirely
        both = ins_set & drop_set
        ins_eff = ins_set - both
        del_eff = drop_set - both
        if not ins_eff and not del_eff:
            return  # no-op mutation batch: keep caches and version
        ins_cols = None
        if ins_eff:
            ia = np.asarray(sorted(ins_eff), dtype=np.uint32)
            ins_cols = (ia[:, 0], ia[:, 1], ia[:, 2])
        del_cols = None
        if del_eff:
            da = np.asarray(sorted(del_eff), dtype=np.uint32)
            del_cols = (da[:, 0], da[:, 1], da[:, 2])
        new_orders = {}
        for name, so in self._orders.items():
            if name == "spo":
                new_orders[name] = SortedOrder.from_parts(so.perm, s, p, o, key01)
            else:
                new_orders[name] = _updated_order(so, ins_cols, del_cols)
        # delta bookkeeping — copy-then-replace so snapshots sharing the
        # old sets stay intact (COW invariant)
        add_set = set(self._delta_add_set)
        del_set = set(self._delta_del_set)
        for t in ins_eff:
            if t in del_set:
                del_set.discard(t)  # base row deleted then re-added
            else:
                add_set.add(t)
        for t in del_eff:
            if t in add_set:
                add_set.discard(t)  # delta add deleted again
            else:
                del_set.add(t)  # tombstone over a base row
        self._s, self._p, self._o = s, p, o
        self._orders = new_orders
        self._delta_orders = {}
        self._delta_del_pos = {}
        self._device_delta = {}
        self._delta_add_set = add_set
        self._delta_del_set = del_set
        self._delta_epoch += 1
        self._version = next(_VERSION_COUNTER)
        if len(add_set) + len(del_set) > self.delta_threshold:
            self._merge_base()
            _DELTA_MERGES.inc()
        else:
            _DELTA_ROWS.set(len(add_set) + len(del_set))

    def _compact_full(self, a_s, a_p, a_o, dels) -> None:
        """Full rebuild: concat + lexsort + unique, then one vectorized
        delete probe.  Always ends with base := live (a delta merge)."""
        if len(a_s):
            s = np.concatenate([self._s, a_s])
            p = np.concatenate([self._p, a_p])
            o = np.concatenate([self._o, a_o])
            if len(s):
                order = _lex_sort_rows(s, p, o)
                s, p, o = s[order], p[order], o[order]
                # unique: drop consecutive duplicate rows
                if len(s) > 1:
                    dup = (s[1:] == s[:-1]) & (p[1:] == p[:-1]) & (o[1:] == o[:-1])
                    keep = np.concatenate(([True], ~dup))
                    s, p, o = s[keep], p[keep], o[keep]
        else:
            s, p, o = self._s, self._p, self._o
        if dels and len(s):
            dl = np.asarray(sorted(dels), dtype=np.uint32)
            drop = _member_mask(
                _pack2(s, p), o, _pack2(dl[:, 0], dl[:, 1]), dl[:, 2]
            )
            if drop.any():
                keep = ~drop
                s, p, o = s[keep], p[keep], o[keep]
        if s is self._s and p is self._p and o is self._o:
            return  # no-op mutation batch: keep caches and version
        if (
            len(s) == len(self._s)
            and np.array_equal(s, self._s)
            and np.array_equal(p, self._p)
            and np.array_equal(o, self._o)
        ):
            return  # no-op mutation batch: keep caches and version
        self._s, self._p, self._o = s, p, o
        self._invalidate()
        self._merge_base()
        _ORDER_REBUILDS.inc()

    # --------------------------------------------------------------- access

    def __len__(self) -> int:
        self.compact()
        return len(self._s)

    @property
    def version(self) -> int:
        self.compact()
        return self._version

    @property
    def base_version(self) -> int:
        """Version of the frozen base segment.  Moves only on delta→base
        merges (and full compactions) — the stable key for plan caches,
        scan-cap calibration, and device base mirrors."""
        self.compact()
        return self._base_version

    @property
    def delta_epoch(self) -> int:
        """Monotonic counter of incremental compactions since the last
        merge; ``(base_version, delta_epoch)`` identifies live state."""
        self.compact()
        return self._delta_epoch

    def version_key(self) -> Tuple[int, int]:
        """``(base_version, delta_epoch)`` after one compaction — THE
        cache key for any result derived from live store state (the MQO
        prefix cache, kolint rule KL901).  One ``compact()`` call covers
        both components, so the pair is read consistently even when a
        mutation batch is pending."""
        self.compact()
        return (self._base_version, self._delta_epoch)

    @property
    def delta_device_cap(self) -> int:
        """Fixed device capacity of the delta segment (rows).  A function
        of :attr:`delta_threshold` only, so compiled plan shapes never
        depend on the current delta occupancy."""
        return round_cap(max(int(self.delta_threshold), 1), 64)

    def columns(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Canonical SPO-sorted unique columns (s, p, o)."""
        self.compact()
        return self._s, self._p, self._o

    def order(self, name: str) -> SortedOrder:
        self.compact()
        so = self._orders.get(name)
        if so is None:
            so = SortedOrder(
                self._ORDER_PERMS[name],
                {"s": self._s, "p": self._p, "o": self._o},
                presorted=(name == "spo"),
            )
            self._orders[name] = so
        return so

    # ----------------------------------------------------- base/delta access

    def base_order(self, name: str) -> SortedOrder:
        """Sort order over the frozen BASE columns (state as of
        ``base_version``).  When the delta is empty this shares the live
        order object; otherwise it is built once per merge and survives
        every incremental compaction."""
        self.compact()
        so = self._base_orders.get(name)
        if so is None:
            if not self._delta_add_set and not self._delta_del_set:
                so = self.order(name)  # base == live: share the object
            else:
                so = SortedOrder(
                    self._ORDER_PERMS[name],
                    {"s": self._base_s, "p": self._base_p, "o": self._base_o},
                    presorted=(name == "spo"),
                )
            self._base_orders[name] = so
        return so

    def delta_order(self, name: str) -> SortedOrder:
        """Sort order over the delta ADD rows only (cached per epoch)."""
        self.compact()
        so = self._delta_orders.get(name)
        if so is None:
            if self._delta_add_set:
                arr = np.asarray(sorted(self._delta_add_set), dtype=np.uint32)
                cols = {"s": arr[:, 0], "p": arr[:, 1], "o": arr[:, 2]}
            else:
                cols = {"s": _EMPTY, "p": _EMPTY, "o": _EMPTY}
            so = SortedOrder(
                self._ORDER_PERMS[name], cols, presorted=(name == "spo")
            )
            self._delta_orders[name] = so
        return so

    def delta_del_positions(self, name: str) -> np.ndarray:
        """Sorted u32 row positions WITHIN ``base_order(name)`` of the
        tombstoned (deleted-since-merge) base rows.  Single-word sorted
        membership lets the device plan mask deleted base rows with one
        ``searchsorted`` instead of matching 96-bit triples."""
        self.compact()
        pos = self._delta_del_pos.get(name)
        if pos is None:
            if self._delta_del_set:
                arr = np.asarray(sorted(self._delta_del_set), dtype=np.uint32)
                perm = self._ORDER_PERMS[name]
                by = {"s": arr[:, 0], "p": arr[:, 1], "o": arr[:, 2]}
                d0, d1, d2 = by[perm[0]], by[perm[1]], by[perm[2]]
                bo = self.base_order(name)
                mask = _member_mask(bo.key01, bo.c2, _pack2(d0, d1), d2)
                pos = np.flatnonzero(mask).astype(np.uint32)
            else:
                pos = _EMPTY
            self._delta_del_pos[name] = pos
        return pos

    def segment_signature(self) -> Tuple[int, int, int, int]:
        """Identity of the live two-tier state:
        ``(base_version, delta_epoch, n_delta_adds, n_delta_dels)``.

        ``(base_version, delta_epoch)`` alone identifies state within one
        store lineage; the delta counts make the tuple robust across
        :meth:`snapshot`/:meth:`restore` round trips that land on the same
        epoch counters with different pending deltas.  Derived mirrors
        (the sharded serving layer's per-shard device blocks) key their
        staleness checks on this tuple."""
        self.compact()
        return (
            self._base_version,
            self._delta_epoch,
            len(self._delta_add_set),
            len(self._delta_del_set),
        )

    def base_rows(self, name: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Canonical ``(s, p, o)`` host columns of the FROZEN base in
        ``name``'s row permutation, unpadded.  Row index ``i`` here is the
        coordinate space of :meth:`delta_del_positions` — partitioners that
        keep a row→shard map can translate tombstones without re-probing."""
        so = self.base_order(name)
        canon = {so.perm[0]: so.c0, so.perm[1]: so.c1, so.perm[2]: so.c2}
        return canon["s"], canon["p"], canon["o"]

    def delta_rows(self, name: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Canonical ``(s, p, o)`` host columns of the delta ADD rows in
        ``name``'s permutation, unpadded (sorted, O(delta) small)."""
        so = self.delta_order(name)
        canon = {so.perm[0]: so.c0, so.perm[1]: so.c1, so.perm[2]: so.c2}
        return canon["s"], canon["p"], canon["o"]

    def device_segment(self, name: str):
        """Two-tier device mirror of one sort order on :attr:`device`:
        ``(base_cols, delta_cols, del_pos)`` where

        - ``base_cols`` — canonical ``(s, p, o)`` int64 columns in the
          order's permutation over the FROZEN base, padded to a power of two
          with ``0xFFFFFFFF``; uploaded once per ``base_version``.
        - ``delta_cols`` — the sorted delta ADD rows, padded to the fixed
          :attr:`delta_device_cap`; re-uploaded once per ``delta_epoch``.
        - ``del_pos`` — sorted tombstone positions into the base order,
          padded to :attr:`delta_device_cap` with ``0xFFFFFFFF``.

        Shapes are a function of ``(base cap, delta cap)`` only, so
        per-batch host->device traffic is O(delta_cap).
        """
        self.compact()
        base = self._device_segments.get(name)
        if base is None:
            bo = self.base_order(name)
            n = len(bo)
            cap = round_cap(n)
            canon = {bo.perm[0]: bo.c0, bo.perm[1]: bo.c1, bo.perm[2]: bo.c2}
            # one host buffer, one transfer
            buf = np.full((3, cap), 0xFFFFFFFF, dtype=np.int64)
            for j, c in enumerate("spo"):
                buf[j, :n] = canon[c]
            dev = torch.from_numpy(buf).to(self.device)
            base = (dev[0], dev[1], dev[2])
            self._device_segments[name] = base
            _H2D_BYTES.labels("base").inc(buf.nbytes)
        delta = self._device_delta.get(name)
        if delta is None:
            dcap = self.delta_device_cap
            do_ = self.delta_order(name)
            canon = {do_.perm[0]: do_.c0, do_.perm[1]: do_.c1, do_.perm[2]: do_.c2}
            buf = np.full((4, dcap), 0xFFFFFFFF, dtype=np.int64)
            for j, col in enumerate(
                (canon["s"], canon["p"], canon["o"], self.delta_del_positions(name))
            ):
                buf[j, : len(col)] = col
            dev = torch.from_numpy(buf).to(self.device)
            delta = ((dev[0], dev[1], dev[2]), dev[3])
            self._device_delta[name] = delta
            _H2D_BYTES.labels("delta").inc(buf.nbytes)
        return base, delta[0], delta[1]

    def contains(self, s: int, p: int, o: int) -> bool:
        self.compact()
        spo = self.order("spo")
        lo, hi = spo.range012(s, p, o)
        return hi > lo

    def __iter__(self) -> Iterator[Triple]:
        s, p, o = self.columns()
        for i in range(len(s)):
            yield Triple(int(s[i]), int(p[i]), int(o[i]))

    def triples_set(self) -> set:
        """Membership set of (s, p, o) int tuples (the reference memoizes it
        per version; here it is built per call)."""
        s, p, o = self.columns()
        return set(zip(s.tolist(), p.tolist(), o.tolist()))

    # ---------------------------------------------------------------- match

    def match(
        self,
        s: Optional[int] = None,
        p: Optional[int] = None,
        o: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Pattern scan: None = wildcard.  Returns (s, p, o) column arrays of
        matching triples.  Dispatch by bound combination mirrors
        ``UnifiedIndex::query`` (``index_manager.rs:253-340``)."""
        self.compact()
        if s is not None and p is not None and o is not None:
            order = self.order("spo")
            lo, hi = order.range012(s, p, o)
        elif s is not None and p is not None:
            order = self.order("spo")
            lo, hi = order.range01(s, p)
        elif s is not None and o is not None:
            order = self.order("osp")
            lo, hi = order.range01(o, s)
        elif s is not None:
            order = self.order("spo")
            lo, hi = order.range0(s)
        elif p is not None and o is not None:
            order = self.order("pos")
            lo, hi = order.range01(p, o)
        elif p is not None:
            order = self.order("pos")
            lo, hi = order.range0(p)
        elif o is not None:
            order = self.order("osp")
            lo, hi = order.range0(o)
        else:
            return self._s, self._p, self._o
        cols = order.slice_rows(lo, hi)
        return cols["s"], cols["p"], cols["o"]

    def count(self, s=None, p=None, o=None) -> int:
        ms, _, _ = self.match(s, p, o)
        return len(ms)

    def clone(self) -> "ColumnarTripleStore":
        """O(1) copy-on-write clone on the same device.  Column arrays, sort
        orders and device mirrors are never mutated in place once compacted
        (every mutation path builds new ones and swaps them in), so the clone
        SHARES them; the first mutation on either side builds new ones
        without touching the other."""
        self.compact()
        c = ColumnarTripleStore(self.device)
        c._s, c._p, c._o = self._s, self._p, self._o
        c._orders = dict(self._orders)
        c._version = self._version  # same state => same version (see __init__)
        c._base_s, c._base_p, c._base_o = self._base_s, self._base_p, self._base_o
        c._base_orders = dict(self._base_orders)
        c._base_version = self._base_version
        c._delta_add_set = self._delta_add_set  # replaced, never mutated
        c._delta_del_set = self._delta_del_set
        c._delta_epoch = self._delta_epoch
        c._delta_orders = dict(self._delta_orders)
        c._delta_del_pos = dict(self._delta_del_pos)
        c._device_segments = dict(self._device_segments)
        c._device_delta = dict(self._device_delta)
        c.delta_threshold = self.delta_threshold
        c.incremental = self.incremental
        return c

    def snapshot(self):
        """O(1) state capture.  Compaction never mutates column arrays,
        sort orders, or delta sets in place (it builds new ones and
        reassigns — ``compact``), so holding references is enough;
        ``restore`` swaps them back.  The device mirrors are captured as
        copies of their per-state maps: a mirror uploaded after the
        snapshot never comes back with the restore, so a query after a
        restore reads only mirrors of the restored state (or uploads them
        anew)."""
        self.compact()
        return (
            self._s,
            self._p,
            self._o,
            dict(self._orders),
            self._version,
            self._base_s,
            self._base_p,
            self._base_o,
            dict(self._base_orders),
            self._base_version,
            self._delta_add_set,
            self._delta_del_set,
            self._delta_epoch,
            dict(self._delta_orders),
            dict(self._delta_del_pos),
            dict(self._device_segments),
            dict(self._device_delta),
        )

    def restore(self, snap) -> None:
        """Return to a prior ``snapshot`` state.  O(1): reassigns the saved
        references and drops any pending mutations recorded since."""
        (
            self._s,
            self._p,
            self._o,
            orders,
            self._version,
            self._base_s,
            self._base_p,
            self._base_o,
            base_orders,
            self._base_version,
            self._delta_add_set,
            self._delta_del_set,
            self._delta_epoch,
            delta_orders,
            delta_del_pos,
            segments,
            delta,
        ) = snap
        # copies again, so that filling a map lazily never reaches the
        # snapshot, which may be restored more than once
        self._orders = dict(orders)
        self._base_orders = dict(base_orders)
        self._delta_orders = dict(delta_orders)
        self._delta_del_pos = dict(delta_del_pos)
        self._device_segments = dict(segments)
        self._device_delta = dict(delta)
        self._pending_add = []
        self._pending_del = set()

    # ----------------------------------------------------------- serialization

    def save_npz(self, path: str) -> None:
        s, p, o = self.columns()
        np.savez_compressed(path, s=s, p=p, o=o)

    @staticmethod
    def load_npz(path: str, device: DeviceLike = None) -> "ColumnarTripleStore":
        """A store holding the columns :meth:`save_npz` wrote (either
        package's file), mirrored on ``device``: the CUDA card unless the
        caller passes another."""
        data = np.load(path)
        st = ColumnarTripleStore(device)
        st._s = data["s"].astype(np.uint32)
        st._p = data["p"].astype(np.uint32)
        st._o = data["o"].astype(np.uint32)
        st._merge_base()  # base := loaded columns (fresh store, empty delta)
        return st
