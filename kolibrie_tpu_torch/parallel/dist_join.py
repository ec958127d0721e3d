"""Distributed partitioned equi-join: all-to-all repartition + local join.

Port of ``kolibrie_tpu/parallel/dist_join.py``.  The classic distributed
plan: hash-partition both sides on the join key (one :func:`all_to_all`
per repartitioned side), then sort-merge join locally per shard.  The
reference's ``shard_map`` body becomes controller code: bucketize per
shard → :func:`~kolibrie_tpu_torch.parallel.mesh.all_to_all` → local join
per shard → :func:`~kolibrie_tpu_torch.parallel.mesh.psum`.

Keys are int64 carriers of single u32 dictionary-ID columns.  Invalid-row
sentinels: IDs occupy bits 0..30 (bit 31 marks quoted triples), so
``0xFFFFFFFE`` / ``0xFFFFFFFF`` never collide with real IDs and sort after
every one of them.

Kernel: :func:`local_join_u32` runs the merge-path kernel
(``ops/kernels.py::merge_join_indices``) — on CUDA tensors the kernel, on
CPU tensors its plain version.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from kolibrie_tpu_torch.backend import _RPAD, pack2
from kolibrie_tpu_torch.ops.kernels import merge_join_indices
from kolibrie_tpu_torch.parallel.mesh import Mesh, all_to_all, psum, shard_get, shard_put

_LPAD32 = 0xFFFFFFFE
_RPAD32 = 0xFFFFFFFF
_U32 = 0xFFFFFFFF


def mix32(x: torch.Tensor) -> torch.Tensor:
    """Device twin of ``sharded_store._mix32`` — MUST stay bit-identical.
    u32 arithmetic in int64: each product is masked back to 32 bits before
    the next shift."""
    c = 0x45D9F3B
    x = x & _U32
    x = ((x ^ (x >> 16)) * c) & _U32
    x = ((x ^ (x >> 16)) * c) & _U32
    return x ^ (x >> 16)


def shard_of_dev(key: torch.Tensor, n_shards: int) -> torch.Tensor:
    return mix32(key) % n_shards


def _empty_join(cap: int, device):
    z = torch.zeros(cap, dtype=torch.int64, device=device)
    return z, z.clone(), torch.zeros(cap, dtype=torch.bool, device=device), (
        torch.zeros((), dtype=torch.int64, device=device)
    )


def local_join_u32(
    lkey: torch.Tensor,
    rkey: torch.Tensor,
    cap: int,
    lvalid: torch.Tensor,
    rvalid: torch.Tensor,
):
    """Static-capacity equi-join of two u32 key columns: ``(li, ri, valid,
    total)`` with outputs of length ``cap``, pairs left row by left row and
    each row's matches in the right side's stable sorted order, and the
    exact match count.  Sorts the right keys once, runs the merge-path
    kernel and maps ``ri`` back through the permutation (the reference's
    ``_local_join_u32_pallas`` route)."""
    lk = torch.where(lvalid, lkey, _LPAD32)
    rk = torch.where(rvalid, rkey, _RPAD32)
    if lk.shape[0] == 0 or rk.shape[0] == 0:
        return _empty_join(cap, lkey.device)
    rorder = torch.argsort(rk, stable=True)
    li, rpos, valid, total = merge_join_indices(lk, rk[rorder], cap)
    li, rpos, valid = li[:cap], rpos[:cap], valid[:cap]
    ri = torch.where(valid, rorder[rpos], 0)
    return li, ri, valid, total


def bucketize(
    cols: Sequence[torch.Tensor],
    valid: torch.Tensor,
    dest: torch.Tensor,
    n_shards: int,
    bucket_cap: int,
):
    """Scatter one shard's rows into per-destination buckets
    ``[n * bucket_cap]``.  Rows beyond a destination's capacity are
    DROPPED and counted so the host can grow ``bucket_cap`` and retry;
    they land in one spare slot past the buckets that is cut off, so no
    dropped row shares a live slot."""
    L = dest.shape[0]
    dev = valid.device
    dmask = torch.where(valid, dest, n_shards)
    order = torch.argsort(dmask, stable=True)
    sd = dmask[order]
    rank = torch.arange(L, device=dev) - torch.searchsorted(sd, sd)
    ok = (sd < n_shards) & (rank < bucket_cap)
    size = n_shards * bucket_cap
    slot = torch.where(ok, sd * bucket_cap + rank, size)
    bufs = []
    for c in cols:
        buf = torch.zeros(size + 1, dtype=c.dtype, device=dev)
        buf[slot] = c[order]
        bufs.append(buf[:size])
    bvalid = torch.zeros(size + 1, dtype=torch.bool, device=dev)
    bvalid[slot] = ok
    dropped = valid.sum() - ok.sum()
    return tuple(bufs), bvalid[:size], dropped


def exchange(
    cols: Sequence[Sequence[torch.Tensor]],
    valid: Sequence[torch.Tensor],
    dest: Sequence[torch.Tensor],
    n_shards: int,
    bucket_cap: int,
):
    """Route rows to their destination shard: bucketize every shard, then
    one :func:`all_to_all` per column.  ``cols[i]`` is shard *i*'s tuple of
    columns.  Returns the received per-shard columns ``[n * bucket_cap]``,
    their validity, and the GLOBAL dropped-row count (psum)."""
    per = [
        bucketize(c, v, d, n_shards, bucket_cap) for c, v, d in zip(cols, valid, dest)
    ]
    shape = (n_shards, bucket_cap)
    moved = [
        all_to_all([p[0][k].view(shape) for p in per]) for k in range(len(per[0][0]))
    ]
    out = [tuple(m[i] for m in moved) for i in range(n_shards)]
    out_valid = all_to_all([p[1].view(shape) for p in per])
    return out, out_valid, psum([p[2] for p in per])


def _dist_join_body(lcols, lvalid, rcols, rvalid, *, lkey_i, rkey_i, n, bucket_cap, out_cap):
    """The mesh body: repartition both sides by key hash, join locally."""
    ld = [shard_of_dev(c[lkey_i], n) for c in lcols]
    rd = [shard_of_dev(c[rkey_i], n) for c in rcols]
    lr, lrv, ldrop = exchange(lcols, lvalid, ld, n, bucket_cap)
    rr, rrv, rdrop = exchange(rcols, rvalid, rd, n, bucket_cap)
    louts: List[tuple] = []
    routs: List[tuple] = []
    valids, totals, ovfs = [], [], []
    for i in range(n):
        li, ri, jvalid, total = local_join_u32(
            lr[i][lkey_i], rr[i][rkey_i], out_cap, lrv[i], rrv[i]
        )
        louts.append(tuple(torch.where(jvalid, c[li], 0) for c in lr[i]))
        routs.append(tuple(torch.where(jvalid, c[ri], 0) for c in rr[i]))
        valids.append(jvalid)
        totals.append(total)
        # a shard whose local match count exceeds out_cap truncates its
        # output — count the overrun so the dropped > 0 retry catches it
        ovfs.append((total - out_cap).clamp(min=0))
    dropped = ldrop + rdrop.to(ldrop.device) + psum(ovfs).to(ldrop.device)
    return louts, routs, valids, psum(totals), dropped


def _host_cols(per_shard: List[tuple], k: int) -> np.ndarray:
    return shard_get([t[k] for t in per_shard]).astype(np.uint32)


def dist_equi_join(
    mesh: Mesh,
    left_cols: Sequence[np.ndarray],
    left_valid: np.ndarray,
    right_cols: Sequence[np.ndarray],
    right_valid: np.ndarray,
    lkey_i: int,
    rkey_i: int,
    bucket_cap: int = 1024,
    out_cap: int = 4096,
):
    """Distributed equi-join of two sharded row sets on one u32 key column.

    Inputs are host ``[n_shards, L]`` arrays.  Returns ``(left_out,
    right_out, valid, global_total, dropped)``: host ``[n_shards,
    out_cap]`` arrays (u32 columns, a bool mask) and two ints;
    ``dropped > 0`` means rows were lost to exchange-bucket OR join-output
    capacity — retry with larger ``bucket_cap`` / ``out_cap``."""
    n = mesh.size

    def per_shard(cols):
        sharded = [shard_put(mesh, c) for c in cols]
        return [tuple(s[i] for s in sharded) for i in range(n)]

    lo, ro, v, tot, drop = _dist_join_body(
        per_shard(left_cols),
        shard_put(mesh, left_valid),
        per_shard(right_cols),
        shard_put(mesh, right_valid),
        lkey_i=lkey_i,
        rkey_i=rkey_i,
        n=n,
        bucket_cap=bucket_cap,
        out_cap=out_cap,
    )
    left_out = tuple(_host_cols(lo, k) for k in range(len(left_cols)))
    right_out = tuple(_host_cols(ro, k) for k in range(len(right_cols)))
    return left_out, right_out, shard_get(v), int(tot), int(drop)


def dist_bgp_join_count(store, p1: int, p2: int) -> int:
    """COUNT of the 2-pattern BGP join ``(?x p1 ?y) . (?y p2 ?z)``.

    The dual partitioning of the store co-locates matching keys: the left
    side (keyed by object) lives object-hashed, the right (keyed by
    subject) subject-hashed — the join runs with zero exchange and one
    scalar psum."""
    return int(dist_bgp_join_count_device(store, p1, p2))


def dist_bgp_join_count_device(store, p1: int, p2: int) -> torch.Tensor:
    """As :func:`dist_bgp_join_count` but returns the un-read 0-dim
    tensor (on the first shard's device), so callers can time the
    dispatch before any host read."""
    store.ensure_subj_index()
    base, tombs, delta = store.subj_index_parts
    totals = []
    for i in range(store.n_shards):
        op, oo, ov = store.by_obj[1][i], store.by_obj[2][i], store.by_obj_valid[i]
        lv = ov & (op == p1)
        # invalid left rows probe with the all-ones key, beyond every real
        # packed key (IDs never reach 0xFFFFFFFF)
        lkey = torch.where(lv, pack2(oo.new_full((), p2), oo), _RPAD)

        def count(packed):
            hi = torch.searchsorted(packed, lkey, right=True)
            lo = torch.searchsorted(packed, lkey)
            return torch.where(lv, hi - lo, 0).sum()

        totals.append(count(base[i]) - count(tombs[i]) + count(delta[i]))
    return psum(totals)
