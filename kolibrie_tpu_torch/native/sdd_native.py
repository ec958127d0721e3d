"""ctypes wrapper presenting the native SDD engine with the same interface
as :class:`kolibrie_tpu_torch.reasoner.sdd.SddManager` (the pure-Python twin).

Port of ``kolibrie_tpu/native/sdd_native.py`` (a copy, the imports rewritten).

Node IDs, variable indices, FALSE=0/TRUE=1 terminals, and all algebraic
semantics are identical — tests/test_native.py asserts agreement.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

from kolibrie_tpu_torch.native import load
from kolibrie_tpu_torch.reasoner.sdd import FALSE, TRUE, VarInfo

_OPS = {"and": 0, "or": 1}


class NativeSddManager:
    """Drop-in SddManager backed by libkolibrie_native."""

    def __init__(self) -> None:
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._h = self._lib.kn_sdd_new()
        # Python-side mirror for metadata consumers (seed ids, groups, kinds);
        # the native side only needs the weights.
        self.vars: List[VarInfo] = []
        self._group_members: Dict[int, List[int]] = {}

    def __del__(self):
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.kn_sdd_free(h)

    # ------------------------------------------------------------ variables

    def new_var(
        self,
        w_pos: float = 0.5,
        w_neg: Optional[float] = None,
        kind: str = "independent",
        group_id: Optional[int] = None,
        seed_id: Optional[int] = None,
    ) -> int:
        if w_neg is None:
            w_neg = 1.0 - w_pos if kind == "independent" else 1.0
        idx = int(
            self._lib.kn_sdd_new_var(
                self._h, w_pos, w_neg, 0 if kind == "independent" else 1
            )
        )
        self.vars.append(VarInfo(idx, w_pos, w_neg, kind, group_id, seed_id))
        if group_id is not None:
            self._group_members.setdefault(group_id, []).append(idx)
        return idx

    def set_weight(self, var: int, w_pos: float, w_neg: Optional[float] = None):
        vi = self.vars[var]
        vi.w_pos = w_pos
        if w_neg is not None:
            vi.w_neg = w_neg
        elif vi.kind == "independent":
            vi.w_neg = 1.0 - w_pos
        self._lib.kn_sdd_set_weight(self._h, var, vi.w_pos, vi.w_neg)

    # --------------------------------------------------------------- algebra

    def literal(self, var: int, positive: bool = True) -> int:
        return int(self._lib.kn_sdd_literal(self._h, var, 1 if positive else 0))

    def apply(self, a: int, b: int, op: str) -> int:
        return int(self._lib.kn_sdd_apply(self._h, a, b, _OPS[op]))

    def conjoin(self, a: int, b: int) -> int:
        return self.apply(a, b, "and")

    def disjoin(self, a: int, b: int) -> int:
        return self.apply(a, b, "or")

    def negate(self, a: int) -> int:
        return int(self._lib.kn_sdd_negate(self._h, a))

    # ------------------------------------------------------- batched algebra

    def apply_batch(self, a, b, op: str):
        """Element-wise ``apply`` over two int64 node-id arrays — ONE
        library crossing for a whole derivation column (the reasoner's
        batched SDD round; per-call ctypes overhead otherwise dominates)."""
        import numpy as np

        a = np.ascontiguousarray(a, dtype=np.int64)
        b = np.ascontiguousarray(b, dtype=np.int64)
        out = np.empty(len(a), dtype=np.int64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        self._lib.kn_sdd_apply_batch(
            self._h,
            a.ctypes.data_as(i64p),
            b.ctypes.data_as(i64p),
            len(a),
            _OPS[op],
            out.ctypes.data_as(i64p),
        )
        return out

    def reduce_groups(self, tags, group_ids, n_groups: int, op: str):
        """Segmented fold of node ids per group id (row order), starting
        from the fold identity.  Returns int64 array of length n_groups."""
        import numpy as np

        tags = np.ascontiguousarray(tags, dtype=np.int64)
        gids = np.ascontiguousarray(group_ids, dtype=np.int64)
        identity = 1 if op == "and" else 0  # TRUE / FALSE node ids
        out = np.full(n_groups, identity, dtype=np.int64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        self._lib.kn_sdd_reduce_groups(
            self._h,
            tags.ctypes.data_as(i64p),
            gids.ctypes.data_as(i64p),
            len(tags),
            _OPS[op],
            out.ctypes.data_as(i64p),
        )
        return out

    def exactly_one(self, var_indices: List[int]) -> int:
        n = len(var_indices)
        arr = (ctypes.c_int64 * n)(*var_indices)
        return int(self._lib.kn_sdd_exactly_one(self._h, arr, n))

    # ------------------------------------------------------------------- WMC

    def wmc(self, nid: int) -> float:
        return float(self._lib.kn_sdd_wmc(self._h, nid))

    def wmc_gradient(self, nid: int, var_indices: List[int]) -> Dict[int, float]:
        n = len(var_indices)
        arr = (ctypes.c_int64 * n)(*var_indices)
        out = (ctypes.c_double * n)()
        self._lib.kn_sdd_wmc_gradient(self._h, nid, arr, n, out)
        return {v: out[i] for i, v in enumerate(var_indices)}

    # --------------------------------------------------------------- queries

    def enumerate_models(self, nid: int, limit: int = 1000) -> List[Dict[int, bool]]:
        pair_cap = 4096
        while True:
            out_vars = (ctypes.c_int64 * pair_cap)()
            out_vals = (ctypes.c_int8 * pair_cap)()
            offsets = (ctypes.c_int64 * (limit + 1))()
            n = int(
                self._lib.kn_sdd_enumerate_models(
                    self._h, nid, limit, out_vars, out_vals, pair_cap, offsets
                )
            )
            if n >= 0:
                models = []
                for m in range(n):
                    lo, hi = offsets[m], offsets[m + 1]
                    models.append(
                        {int(out_vars[i]): bool(out_vals[i]) for i in range(lo, hi)}
                    )
                return models
            pair_cap *= 4

    def size(self, nid: int) -> int:
        return int(self._lib.kn_sdd_size(self._h, nid))
