"""ctypes wrapper for the native (C++, threaded) host equi-join twin.

Port of ``kolibrie_tpu/native/join_native.py`` (a copy, the imports
rewritten): the same shared library, loaded through the port's own
:mod:`kolibrie_tpu_torch.native` loader.

Same contract as :func:`kolibrie_tpu_torch.ops.join.join_indices` — row-index
pairs ``(li, ri)`` with ``lk[li] == rk[ri]``, left-major, stable in the
right side's original order — implemented as a threaded sort + binary
search in ``native/kolibrie_native.cpp::kn_join_u32``.

It stands for what the reference's SIMD+rayon join loop
(``shared/src/join_algorithm.rs:19-131``) achieves on one node: a host
baseline floor for a benchmark, so a device path is never measured against
a slow host stand-in.  The numpy engine stays the production host path (it
composes with the whole operator pipeline); tests assert the two agree.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from kolibrie_tpu_torch.native import load

_U32P = ctypes.POINTER(ctypes.c_uint32)


def _u32p(a: np.ndarray):
    return a.ctypes.data_as(_U32P)


def available() -> bool:
    return load() is not None


def join_indices_native(
    lk: np.ndarray, rk: np.ndarray
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native twin of ``ops.join.join_indices``; None if the library is
    unavailable (callers fall back to numpy)."""
    lib = load()
    if lib is None:
        return None
    lk = np.ascontiguousarray(lk, dtype=np.uint32)
    rk = np.ascontiguousarray(rk, dtype=np.uint32)
    # first guess: 2x the larger side (exact for 1:1 joins); the call
    # returns the true total when the buffers are too small
    cap = 2 * max(len(lk), len(rk), 1)
    while True:
        li = np.empty(cap, dtype=np.uint32)
        ri = np.empty(cap, dtype=np.uint32)
        total = lib.kn_join_u32(
            _u32p(lk), len(lk), _u32p(rk), len(rk), _u32p(li), _u32p(ri), cap
        )
        if total <= cap:
            return li[:total].copy(), ri[:total].copy()
        cap = int(total)


def gather_native(src: np.ndarray, idx: np.ndarray) -> Optional[np.ndarray]:
    """out[i] = src[idx[i]] via the threaded native gather."""
    lib = load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, dtype=np.uint32)
    idx = np.ascontiguousarray(idx, dtype=np.uint32)
    out = np.empty(len(idx), dtype=np.uint32)
    lib.kn_gather_u32(_u32p(src), _u32p(idx), len(idx), _u32p(out))
    return out
