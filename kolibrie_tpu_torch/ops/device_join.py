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

__all__ = ["pack2", "pack_key_multi", "join_indices", "join_indices_presorted"]

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
