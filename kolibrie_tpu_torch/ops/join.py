"""Binding tables on the host: a dict var -> u32 numpy column, all columns the
same length.  The device engine reads its results back into this form and
the executor's post-passes (projection, DISTINCT, ORDER BY, formatting) run
over it.

Device binding tables (:data:`DeviceTable`: a dict var -> int64 tensor on
the database's device, u32 IDs as int64 carriers) are what the host
engine (``optimizer/engine.py``) joins for the plans the device lowering
declines: :func:`equi_join_device` is the natural join of
:func:`equi_join_tables` on the merge-path kernel, and its cartesian
product, in the same row order.

The reasoner's host semi-naive strategy (:mod:`kolibrie_tpu_torch.reasoner.
strategies`) joins binding tables here with ONE vectorized sort-based
equi-join: pack the shared-variable key columns of both sides into a single
sort key, sort the right side, ``searchsorted`` each left key for its
[lo, hi) match range, materialize the pairs with ``repeat`` + range
arithmetic.  Copy of ``kolibrie_tpu/ops/join.py``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from kolibrie_tpu_torch.backend import key1, pack2
from kolibrie_tpu_torch.ops.device_join import pack_key_multi
from kolibrie_tpu_torch.ops.kernels import ranked_merge_join_indices

BindingTable = Dict[str, np.ndarray]  # all columns same length
DeviceTable = Dict[str, torch.Tensor]  # int64 carriers, all columns same length

UNBOUND = 0  # dictionary NULL sentinel doubles as the unbound marker


def table_len(t: BindingTable) -> int:
    for v in t.values():
        return len(v)
    return 0


def multi_key_pack(cols: Sequence[np.ndarray]) -> np.ndarray:
    """Combine key columns into one sortable u64 key.

    1 column: identity (u64).  2 columns of u32 IDs: exact 64-bit pack.
    3+ columns: dense-rank composition (exact, via successive unique-inverse),
    still vectorized.
    """
    if len(cols) == 1:
        return cols[0].astype(np.uint64)
    if len(cols) == 2:
        return (cols[0].astype(np.uint64) << np.uint64(32)) | cols[1].astype(np.uint64)
    key = cols[0].astype(np.uint64)
    for c in cols[1:]:
        # dense-rank the accumulated key so the next 32-bit column fits exactly
        _, inv = np.unique(key, return_inverse=True)
        key = (inv.astype(np.uint64) << np.uint64(32)) | c.astype(np.uint64)
    return key


def equi_join_tables(left: BindingTable, right: BindingTable) -> BindingTable:
    """Natural join of two binding tables on their shared variables.

    Returns a new table with the union of columns.  No shared variables ⇒
    cartesian product.
    """
    shared = sorted(set(left.keys()) & set(right.keys()))
    ln, rn = table_len(left), table_len(right)
    if ln == 0 or rn == 0:
        out: BindingTable = {}
        for k in set(left) | set(right):
            out[k] = np.empty(0, dtype=np.uint32)
        return out
    if not shared:
        li = np.repeat(np.arange(ln), rn)
        ri = np.tile(np.arange(rn), ln)
    else:
        lkey, rkey = _pack_shared_keys(left, right, shared, ln)
        li, ri = join_indices(lkey, rkey)
    out = {}
    for k, col in left.items():
        out[k] = col[li]
    for k, col in right.items():
        if k not in out:
            out[k] = col[ri]
    return out


def join_indices(lkey: np.ndarray, rkey: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Row-index pairs (li, ri) with lkey[li] == rkey[ri] — sort-based."""
    order = np.argsort(rkey, kind="stable")
    rsorted = rkey[order]
    lo = np.searchsorted(rsorted, lkey, side="left")
    hi = np.searchsorted(rsorted, lkey, side="right")
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        z = np.empty(0, dtype=np.int64)
        return z, z
    li = np.repeat(np.arange(len(lkey)), counts)
    # right positions: for each left row, lo[i] .. hi[i]-1
    starts = np.repeat(lo, counts)
    offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    ri = order[starts + offs]
    return li, ri


def semi_join_mask(lkey: np.ndarray, rkey: np.ndarray) -> np.ndarray:
    """Boolean mask over left rows having at least one match in rkey."""
    if len(rkey) == 0:
        return np.zeros(len(lkey), dtype=bool)
    rsorted = np.sort(rkey)
    idx = np.searchsorted(rsorted, lkey)
    idx = np.clip(idx, 0, len(rsorted) - 1)
    return rsorted[idx] == lkey


def anti_join_mask(lkey: np.ndarray, rkey: np.ndarray) -> np.ndarray:
    """Boolean mask over left rows with NO match in rkey (negation-as-failure)."""
    return ~semi_join_mask(lkey, rkey)


def _pack_shared_keys(
    left: BindingTable, right: BindingTable, shared: List[str], ln: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Comparable join keys for both sides.  <=2 u32 columns pack exactly into
    u64 per side; 3+ columns use rank composition, which is only comparable
    when built over the CONCATENATED columns, hence the joint pack + split."""
    if len(shared) <= 2:
        return (
            multi_key_pack([left[v] for v in shared]),
            multi_key_pack([right[v] for v in shared]),
        )
    joint = multi_key_pack([np.concatenate([left[v], right[v]]) for v in shared])
    return joint[:ln], joint[ln:]


def left_outer_join_tables(left: BindingTable, right: BindingTable) -> BindingTable:
    """OPTIONAL semantics: keep unmatched left rows, right-only columns get
    the UNBOUND (0) sentinel."""
    shared = sorted(set(left.keys()) & set(right.keys()))
    ln, rn = table_len(left), table_len(right)
    right_only = [k for k in right if k not in left]
    if ln == 0:
        out = {k: v.copy() for k, v in left.items()}
        for k in right_only:
            out[k] = np.empty(0, dtype=np.uint32)
        return out
    if rn == 0 or not shared:
        if rn == 0:
            out = {k: v.copy() for k, v in left.items()}
            for k in right_only:
                out[k] = np.full(ln, UNBOUND, dtype=np.uint32)
            return out
        return equi_join_tables(left, right)  # no shared vars: cross join
    lkey, rkey = _pack_shared_keys(left, right, shared, ln)
    li, ri = join_indices(lkey, rkey)
    matched = np.zeros(ln, dtype=bool)
    matched[li] = True
    unmatched = np.nonzero(~matched)[0]
    out: BindingTable = {}
    for k, col in left.items():
        out[k] = np.concatenate([col[li], col[unmatched]])
    for k in right_only:
        out[k] = np.concatenate(
            [right[k][ri], np.full(len(unmatched), UNBOUND, dtype=right[k].dtype)]
        )
    return out


def anti_join_tables(left: BindingTable, right: BindingTable) -> BindingTable:
    """MINUS / NAF semantics: left rows with NO matching right row on the
    shared variables.  No shared variables ⇒ left unchanged."""
    shared = sorted(set(left.keys()) & set(right.keys()))
    ln, rn = table_len(left), table_len(right)
    if ln == 0 or rn == 0 or not shared:
        return left
    lkey, rkey = _pack_shared_keys(left, right, shared, ln)
    mask = anti_join_mask(lkey, rkey)
    return {k: v[mask] for k, v in left.items()}


def concat_tables(tables: List[BindingTable]) -> BindingTable:
    tables = [t for t in tables if table_len(t) > 0]
    if not tables:
        return {}
    keys = set(tables[0])
    out: BindingTable = {}
    for k in keys:
        out[k] = np.concatenate([t[k] for t in tables])
    return out


# ---------------------------------------------------------------------------
# Device binding tables
# ---------------------------------------------------------------------------


def device_table_len(t: DeviceTable) -> int:
    for v in t.values():
        return int(v.shape[0])
    return 0


def table_to_device(table: BindingTable, device) -> DeviceTable:
    """Upload a host binding table in one transfer."""
    if not table:
        return {}
    keys = list(table)
    stacked = np.stack([np.asarray(table[k], dtype=np.int64) for k in keys])
    dev = torch.from_numpy(stacked).to(device)
    return {k: dev[j] for j, k in enumerate(keys)}


def table_to_host(table: DeviceTable) -> BindingTable:
    """Read a device binding table back in one transfer."""
    if not table:
        return {}
    keys = list(table)
    stacked = torch.stack([table[k] for k in keys]).cpu().numpy()
    return {k: stacked[j].astype(np.uint32) for j, k in enumerate(keys)}


def take_rows(table: DeviceTable, mask: torch.Tensor) -> DeviceTable:
    """The rows of ``table`` where ``mask`` holds (one host read: the
    count)."""
    idx = torch.nonzero(mask).squeeze(1)
    return {k: v[idx] for k, v in table.items()}


def _device_keys(left: DeviceTable, right: DeviceTable, shared: List[str]):
    """Key carriers of both sides on the shared variables: one or two
    columns pack exactly; three or more dense-rank over both sides."""
    lc = [left[v] for v in shared]
    rc = [right[v] for v in shared]
    if len(shared) == 1:
        return key1(lc[0]), key1(rc[0])
    if len(shared) == 2:
        return pack2(lc[0], lc[1]), pack2(rc[0], rc[1])
    lvalid = torch.ones(lc[0].shape[0], dtype=torch.bool, device=lc[0].device)
    rvalid = torch.ones(rc[0].shape[0], dtype=torch.bool, device=rc[0].device)
    return pack_key_multi(lc, rc, lvalid, rvalid)


def equi_join_device(left: DeviceTable, right: DeviceTable) -> DeviceTable:
    """:func:`equi_join_tables` over device tables: the natural join on the
    shared variables through the merge-path kernel
    (:func:`ranked_merge_join_indices` at the exact match count), or the
    cartesian product when none are shared.  Rows come in the host join's
    order: left row by left row, each left row's matches in the right
    side's stable-sorted key order (the product: ``np.repeat`` /
    ``np.tile``)."""
    shared = sorted(set(left) & set(right))
    ln, rn = device_table_len(left), device_table_len(right)
    names = list(dict.fromkeys([*left, *right]))
    if ln == 0 or rn == 0:
        cols = [*left.values(), *right.values()]
        return {k: cols[0].new_empty(0) for k in names}
    dev = next(iter(left.values())).device
    if not shared:
        li = torch.arange(ln, device=dev).repeat_interleave(rn)
        ri = torch.arange(rn, device=dev).repeat(ln)
    else:
        lkey, rkey = _device_keys(left, right, shared)
        li, ri, _valid, _total = ranked_merge_join_indices(lkey, rkey)
    out: DeviceTable = {k: col[li] for k, col in left.items()}
    for k, col in right.items():
        if k not in out:
            out[k] = col[ri]
    return out
