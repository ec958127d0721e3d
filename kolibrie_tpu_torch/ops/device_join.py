"""Static-capacity equi-joins as PyTorch tensor ops.

Port of ``kolibrie_tpu/ops/device_join.py``: the caller passes an output
``cap`` and gets validity masks back, plus the exact match count so it can
re-run with a larger capacity on overflow (the device engine's convergence
protocol).  Keys are int64 carriers of the reference's u64 keys (see
:mod:`kolibrie_tpu_torch.backend`), so every ``sort``/``searchsorted``
orders them exactly as the reference orders its unsigned words.

The device engine joins through the merge-path kernel
(:mod:`kolibrie_tpu_torch.ops.kernels`); :func:`join_indices` and
:func:`join_indices_presorted` are the plain sort-join formulations the
reference keeps beside its kernel, with the same ``(li, ri, valid, total)``
contract.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from kolibrie_tpu_torch.backend import _LPAD, _RPAD, key1, pack2

__all__ = [
    "pack2",
    "pack_key_multi",
    "join_indices",
    "join_indices_presorted",
    "semi_join_mask",
    "set_difference_rows",
]

Join = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def pack_key_multi(
    lcols: Sequence[torch.Tensor],
    rcols: Sequence[torch.Tensor],
    lvalid: torch.Tensor,
    rvalid: torch.Tensor,
    lpad: int = _LPAD,
    rpad: int = _RPAD,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact keys for 3+ shared join columns: iterated dense-rank
    composition over the UNION of both sides, so equal column tuples get
    equal keys across sides.  Invalid rows get the padding keys at the end.
    Returns int64 key carriers."""
    lk = key1(lcols[0])
    rk = key1(rcols[0])
    for lc, rc in zip(lcols[1:], rcols[1:]):
        union = torch.sort(torch.cat([lk, rk])).values
        lk = pack2(torch.searchsorted(union, lk), lc)
        rk = pack2(torch.searchsorted(union, rk), rc)
    lk = torch.where(lvalid, lk, lpad)
    rk = torch.where(rvalid, rk, rpad)
    return lk, rk


def _empty(cap: int, device) -> Join:
    z = torch.zeros(cap, dtype=torch.int64, device=device)
    return z, z.clone(), torch.zeros(cap, dtype=torch.bool, device=device), (
        torch.zeros((), dtype=torch.int64, device=device)
    )


def _expand(lkey, rsorted, cap: int):
    """Shared expansion: searchsorted run bounds, cumsum, and the row /
    right position of every output slot."""
    ln = lkey.shape[0]
    lo = torch.searchsorted(rsorted, lkey)
    hi = torch.searchsorted(rsorted, lkey, right=True)
    counts = hi - lo
    cum = torch.cumsum(counts, 0)
    total = counts.sum()
    idx = torch.arange(cap, dtype=torch.int64, device=lkey.device)
    row_c = torch.searchsorted(cum, idx, right=True).clamp_(0, max(ln - 1, 0))
    start = cum[row_c] - counts[row_c]
    pos = lo[row_c] + (idx - start)
    valid = idx < total
    return row_c, pos, valid, total


def join_indices(
    lkey: torch.Tensor,
    rkey: torch.Tensor,
    cap: int,
    lvalid: Optional[torch.Tensor] = None,
    rvalid: Optional[torch.Tensor] = None,
) -> Join:
    """Equi-join: all ``(li, ri)`` with ``lkey[li] == rkey[ri]``.  Returns
    ``(li, ri, valid, total)``; the first three have length ``cap`` and
    ``total`` is the true (unclipped) match count."""
    if lvalid is not None:
        lkey = torch.where(lvalid, lkey, _LPAD)
    if rvalid is not None:
        rkey = torch.where(rvalid, rkey, _RPAD)
    ln, rn = lkey.shape[0], rkey.shape[0]
    if ln == 0 or rn == 0:
        return _empty(cap, lkey.device)
    order = torch.argsort(rkey, stable=True)
    row_c, pos, valid, total = _expand(lkey, rkey[order], cap)
    li = torch.where(valid, row_c, 0)
    ri = torch.where(valid, order[pos.clamp(0, rn - 1)], 0)
    return li, ri, valid, total


def semi_join_mask(
    lkey: torch.Tensor, rkey: torch.Tensor, rvalid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mask over left rows with >= 1 match on the right (EXISTS).  Port of
    ``kolibrie_tpu/ops/device_join.py::semi_join_mask``."""
    if rkey.shape[0] == 0:
        return torch.zeros(lkey.shape[0], dtype=torch.bool, device=lkey.device)
    if rvalid is not None:
        rkey = torch.where(rvalid, rkey, _RPAD)
    rsorted = torch.sort(rkey).values
    idx = torch.searchsorted(rsorted, lkey).clamp_(0, rkey.shape[0] - 1)
    return rsorted[idx] == lkey


def _row_membership(
    ours: Sequence[torch.Tensor], theirs: Sequence[torch.Tensor]
) -> torch.Tensor:
    """For each row of ``ours`` (u32 ID columns): does an equal row exist in
    ``theirs``?  Progressive pairwise packing keeps keys exact: (a, b, c) ->
    (pack2(a, b) ranked densely over both sides, then packed with c).  Port
    of ``kolibrie_tpu/ops/device_join.py::_row_membership``."""
    if len(ours) == 1:
        return semi_join_mask(key1(ours[0]), key1(theirs[0]))
    if len(ours) == 2:
        return semi_join_mask(pack2(ours[0], ours[1]), pack2(theirs[0], theirs[1]))
    osp = pack2(ours[0], ours[1])
    tsp = pack2(theirs[0], theirs[1])
    sorted_u = torch.sort(torch.cat([osp, tsp])).values
    rank_o = torch.searchsorted(sorted_u, osp)
    rank_t = torch.searchsorted(sorted_u, tsp)
    return semi_join_mask(pack2(rank_o, ours[2]), pack2(rank_t, theirs[2]))


_U32PAD = 0xFFFFFFFF
_OURS_PAD = 0xFFFFFFFE  # invalid rows of ``ours``: never equal to _U32PAD


def set_difference_rows(
    cols: Sequence[torch.Tensor],
    valid: torch.Tensor,
    other_cols: Sequence[torch.Tensor],
    other_valid: torch.Tensor,
    cap: int,
):
    """Rows of ``cols`` not present in ``other_cols`` (u32 ID columns as
    int64), compacted to the front of ``cap``-row outputs.  Port of
    ``kolibrie_tpu/ops/device_join.py::set_difference_rows``.

    Invalid rows on the two sides carry different sentinels, so padding
    never matches padding.  Returns ``(cols, out_valid, n_out)``: survivors
    in their input order then zeros, and the exact survivor count as a 0-dim
    int64 tensor; survivors beyond ``cap`` are dropped, as the reference's
    ``mode="drop"`` scatter drops them (here: into a spare slot ``cap``
    that is cut off)."""
    dev = valid.device
    ours = [torch.where(valid, c, _OURS_PAD) for c in cols]
    theirs = [torch.where(other_valid, c, _U32PAD) for c in other_cols]
    keep = valid & ~_row_membership(ours, theirs)
    dest = torch.where(keep, torch.cumsum(keep, 0) - 1, cap).clamp_(max=cap)
    outs = []
    for c in cols:
        out = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
        out.index_put_((dest,), c)
        outs.append(out[:cap])
    n_out = keep.sum()
    return tuple(outs), torch.arange(cap, device=dev) < n_out, n_out


def _sort_unique3(cols: Sequence[torch.Tensor], valid: torch.Tensor, cap: int):
    """Sort-unique of (s, p, o) rows with compaction, in the reference's
    order.  Port of ``kolibrie_tpu/parallel/dist_fixpoint.py::_sort_unique3``
    (``lax.sort(num_keys=3)`` over u32 columns).

    torch has no multi-key sort, so the lexicographic unsigned (s, p, o)
    order takes two stable sorts over int64 carriers: by ``o``, then by
    ``pack2(s, p)``.  Invalid rows become ``0xFFFFFFFF`` and sink to the
    end.  Returns ``((us, up, uo), out_valid, n_unique)``: the first
    ``min(n_unique, cap)`` distinct rows in order, zeros after them, and
    the exact distinct count as a 0-dim int64 tensor."""
    dev = valid.device
    cs = [torch.where(valid, c, _U32PAD) for c in cols]
    by_o = torch.sort(cs[2], stable=True).indices
    by_sp = torch.sort(pack2(cs[0][by_o], cs[1][by_o]), stable=True).indices
    perm = by_o[by_sp]
    ss, sp, so = (c[perm] for c in cs)
    isnew = torch.ones_like(valid)
    isnew[1:] = (ss[1:] != ss[:-1]) | (sp[1:] != sp[:-1]) | (so[1:] != so[:-1])
    isnew &= ss != _U32PAD
    dest = torch.where(isnew, torch.cumsum(isnew, 0) - 1, cap).clamp_(max=cap)
    outs = []
    for c in (ss, sp, so):
        out = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
        out.index_put_((dest,), c)  # slot ``cap`` takes the dropped rows
        outs.append(out[:cap])
    n = isnew.sum()
    return tuple(outs), torch.arange(cap, device=dev) < n, n


def join_indices_presorted(
    lkey: torch.Tensor,
    rkey_sorted: torch.Tensor,
    cap: int,
    lvalid: Optional[torch.Tensor] = None,
    rvalid_prefix: Optional[torch.Tensor] = None,
) -> Join:
    """:func:`join_indices` for a right side that is ALREADY sorted (skips
    the argsort).  ``rvalid_prefix`` must be a prefix mask, so the masked
    tail becomes the max padding key and the column stays sorted."""
    if lvalid is not None:
        lkey = torch.where(lvalid, lkey, _LPAD)
    if rvalid_prefix is not None:
        rkey_sorted = torch.where(rvalid_prefix, rkey_sorted, _RPAD)
    ln, rn = lkey.shape[0], rkey_sorted.shape[0]
    if ln == 0 or rn == 0:
        return _empty(cap, lkey.device)
    row_c, pos, valid, total = _expand(lkey, rkey_sorted, cap)
    li = torch.where(valid, row_c, 0)
    ri = torch.where(valid, pos.clamp(0, rn - 1), 0)
    return li, ri, valid, total
