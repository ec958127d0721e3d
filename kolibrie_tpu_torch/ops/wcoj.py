"""Worst-case-optimal join primitives as PyTorch tensor ops.

Port of ``kolibrie_tpu/ops/wcoj.py``'s device half: the batched
lexicographic binary searches that navigate the store's sorted orders at
every WCOJ level.  Columns and probe keys are int64 carriers of u32 IDs
(see :mod:`kolibrie_tpu_torch.backend`), so comparisons order exactly as
the reference's unsigned columns.  The level evaluation itself lives in
``optimizer/device_engine.py`` (``WcojSpec``); its numpy twin
(``LoweredPlan.host_execute``) probes with :func:`host_lex_range`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["lex_searchsorted", "lex_range", "host_lex_range"]


def _probe(cols, keys, mid) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lt, eq) of the column tuple at ``mid`` against the probe tuples."""
    lt = torch.zeros(mid.shape[0], dtype=torch.bool, device=mid.device)
    eq = torch.ones(mid.shape[0], dtype=torch.bool, device=mid.device)
    for c, k in zip(cols, keys):
        v = c[mid]
        lt = lt | (eq & (v < k))
        eq = eq & (v == k)
    return lt, eq


def lex_searchsorted(
    cols: Sequence[torch.Tensor], keys: Sequence[torch.Tensor], side: str = "left"
) -> torch.Tensor:
    """Batched lexicographic ``searchsorted`` over 1..3 parallel sorted
    columns; one probe tuple per row of ``keys``.  A fixed-trip binary
    search (``n.bit_length() + 1`` halvings), as in the reference.  Returns
    int64 positions."""
    n = int(cols[0].shape[0])
    p = keys[0].shape[0]
    dev = keys[0].device
    lo = torch.zeros(p, dtype=torch.int64, device=dev)
    if n == 0:
        return lo
    hi = torch.full((p,), n, dtype=torch.int64, device=dev)
    right = side == "right"
    for _ in range(n.bit_length() + 1):
        active = lo < hi
        mid = ((lo + hi) >> 1).clamp_(0, n - 1)
        lt, eq = _probe(cols, keys, mid)
        go = (lt | eq) if right else lt
        lo = torch.where(active & go, mid + 1, lo)
        hi = torch.where(active & ~go, mid, hi)
    return lo


def lex_range(
    cols: Sequence[torch.Tensor], keys: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both lexicographic insertion points of each probe tuple in one loop:
    ``(lo, hi)``, equal to ``(lex_searchsorted(cols, keys, "left"),
    lex_searchsorted(cols, keys, "right"))``."""
    n = int(cols[0].shape[0])
    p = keys[0].shape[0]
    dev = keys[0].device
    llo = torch.zeros(p, dtype=torch.int64, device=dev)
    if n == 0:
        return llo, llo.clone()
    lhi = torch.full((p,), n, dtype=torch.int64, device=dev)
    rlo, rhi = llo.clone(), lhi.clone()
    for _ in range(n.bit_length() + 1):
        # left-side search: descend right while strictly less
        lact = llo < lhi
        lmid = ((llo + lhi) >> 1).clamp_(0, n - 1)
        lt, _eq = _probe(cols, keys, lmid)
        llo = torch.where(lact & lt, lmid + 1, llo)
        lhi = torch.where(lact & ~lt, lmid, lhi)
        # right-side search: descend right while less-or-equal
        ract = rlo < rhi
        rmid = ((rlo + rhi) >> 1).clamp_(0, n - 1)
        rlt, req = _probe(cols, keys, rmid)
        go = rlt | req
        rlo = torch.where(ract & go, rmid + 1, rlo)
        rhi = torch.where(ract & ~go, rmid, rhi)
    return llo, rlo


def _pack2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a.astype(np.uint64) << np.uint64(32)) | b.astype(np.uint64)


def host_lex_range(
    cols: Sequence[np.ndarray], keys: Sequence[np.ndarray]
) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy twin of two :func:`lex_searchsorted` calls: ``[lo, hi)`` row
    ranges of each probe tuple in lexicographically sorted columns.

    1/2-key probes pack into u64 words; 3-key probes ride a dense rank of
    the leading pair (run-change cumsum), replacing the pair with its rank
    so ``(rank << 32) | c2`` stays exact — an absent leading pair keeps
    the plain pair insertion point (left == right there, so the range is
    empty at the correct position).
    """
    n = len(cols[0]) if cols else 0
    k = len(keys)
    p = len(keys[0]) if k else 0
    if n == 0 or k == 0:
        z = np.zeros(p, dtype=np.int64)
        return z, z.copy()
    if k == 1:
        packed, kp = cols[0], np.asarray(keys[0])
    elif k == 2:
        packed = _pack2(cols[0], cols[1])
        kp = _pack2(np.asarray(keys[0]), np.asarray(keys[1]))
    else:
        p01 = _pack2(cols[0], cols[1])
        change = np.empty(n, dtype=bool)
        change[0] = True
        change[1:] = p01[1:] != p01[:-1]
        rank01 = np.cumsum(change) - 1
        packed = (rank01.astype(np.uint64) << np.uint64(32)) | cols[2].astype(
            np.uint64
        )
        kp01 = _pack2(np.asarray(keys[0]), np.asarray(keys[1]))
        i = np.searchsorted(p01, kp01, side="left")
        ic = np.minimum(i, n - 1)
        present = p01[ic] == kp01
        kp = (rank01[ic].astype(np.uint64) << np.uint64(32)) | np.asarray(
            keys[2]
        ).astype(np.uint64)
        lo = np.where(present, np.searchsorted(packed, kp, side="left"), i)
        hi = np.where(present, np.searchsorted(packed, kp, side="right"), i)
        return lo.astype(np.int64), hi.astype(np.int64)
    lo = np.searchsorted(packed, kp, side="left")
    hi = np.searchsorted(packed, kp, side="right")
    return lo.astype(np.int64), hi.astype(np.int64)
