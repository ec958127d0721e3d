"""Hash-partitioned triple columns over a shard mesh.

Port of ``kolibrie_tpu/parallel/sharded_store.py``.  Layout: per column a
sharded array (a tuple of per-shard 1-D int64 tensors of length ``cap``,
one per shard, each on its shard's device) for s/p/o plus a validity mask.
Shard ownership is ``mix32(subject) % n`` ("by_subj") — joins probing by
subject are local — and a mirrored copy partitioned by object hash
("by_obj") makes object-keyed probes local too: the distributed analogue
of the SPO/OPS permutation indexes, replication in partitioning key
instead of sort order.

The packed ``(pred << 32 | subj)`` probe keys ride as int64 carriers of
the reference's u64 words (:func:`kolibrie_tpu_torch.backend.pack2`), the
all-ones padding as ``_RPAD``.
"""

from __future__ import annotations

import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from kolibrie_tpu_torch.backend import _RPAD, pack2
from kolibrie_tpu_torch.parallel.mesh import Mesh, shard_put


def _mix32(x: np.ndarray) -> np.ndarray:
    """Cheap integer mix (finalizer-style) so consecutive dictionary IDs
    spread across shards instead of clumping.  All arithmetic is wrapping
    u32 — bit-identical to the device twin ``dist_join.mix32``."""
    x = np.asarray(x).astype(np.uint32)
    c = np.uint32(0x45D9F3B)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint32(16))) * c
        x = (x ^ (x >> np.uint32(16))) * c
    return x ^ (x >> np.uint32(16))


def shard_of(key: np.ndarray, n_shards: int) -> np.ndarray:
    return (_mix32(key) % np.uint32(n_shards)).astype(np.int32)


def partition_rows(
    cols: Tuple[np.ndarray, ...],
    key: np.ndarray,
    n_shards: int,
    cap: Optional[int] = None,
) -> Tuple[Tuple[np.ndarray, ...], np.ndarray]:
    """Host-side partition: rows → ``[n_shards, cap]`` blocks + valid mask."""
    dest = shard_of(key, n_shards)
    counts = np.bincount(dest, minlength=n_shards)
    need = int(counts.max()) if len(key) else 0
    if cap is None:
        cap = max(8, 1 << (need - 1).bit_length() if need else 3)
    if need > cap:
        raise ValueError(f"shard capacity {cap} < max shard load {need}")
    # dtype-preserving: payload columns ride the same placement as the ids
    out_cols = [np.zeros((n_shards, cap), dtype=c.dtype) for c in cols]
    valid = np.zeros((n_shards, cap), dtype=bool)
    order = np.argsort(dest, kind="stable")
    offs = np.concatenate([[0], np.cumsum(counts)])
    for sh in range(n_shards):
        rows = order[offs[sh] : offs[sh + 1]]
        for c_out, c_in in zip(out_cols, cols):
            c_out[sh, : len(rows)] = c_in[rows]
        valid[sh, : len(rows)] = True
    return tuple(out_cols), valid


class ShardedTripleStore:
    """Device-sharded (s, p, o) columns with subject- and object-hash copies."""

    def __init__(self, mesh: Mesh, cap_per_shard: int):
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.n_shards = mesh.size
        self.cap = cap_per_shard
        z = np.zeros((self.n_shards, cap_per_shard), dtype=np.int64)
        f = np.zeros((self.n_shards, cap_per_shard), dtype=bool)
        self.by_subj = tuple(shard_put(mesh, z) for _ in range(3))
        self.by_subj_valid = shard_put(mesh, f)
        self.by_obj = tuple(shard_put(mesh, z) for _ in range(3))
        self.by_obj_valid = shard_put(mesh, f)
        # built lazily by ensure_subj_index on first probe (and eagerly by
        # from_columns)
        self.subj_packed_sorted = None
        self._subj_index_src = None
        # two-tier probe index (see refresh_subj_index): (base, tombs,
        # delta) sorted packs; the full-rebuild path fills tombs/delta with
        # tiny all-sentinel packs so consumers probe uniformly
        self.subj_index_parts = None
        self._subj_base_packed = None
        self._subj_base_end = None
        self.subj_index_base_builds = 0
        self.subj_index_delta_builds = 0

    @classmethod
    def from_columns(
        cls,
        mesh: Mesh,
        s: np.ndarray,
        p: np.ndarray,
        o: np.ndarray,
        cap_per_shard: Optional[int] = None,
    ) -> "ShardedTripleStore":
        n = mesh.size
        counts = np.bincount(shard_of(s, n), minlength=n)
        counts_o = np.bincount(shard_of(o, n), minlength=n)
        need = int(max(counts.max() if len(s) else 0, counts_o.max() if len(s) else 0))
        if cap_per_shard is None:
            cap_per_shard = max(8, 1 << max(need - 1, 1).bit_length())
        st = cls(mesh, cap_per_shard)
        (ss, sp, so), sv = partition_rows((s, p, o), s, n, cap_per_shard)
        (os_, op, oo), ov = partition_rows((s, p, o), o, n, cap_per_shard)
        st.by_subj = tuple(shard_put(mesh, a) for a in (ss, sp, so))
        st.by_subj_valid = shard_put(mesh, sv)
        st.by_obj = tuple(shard_put(mesh, a) for a in (os_, op, oo))
        st.by_obj_valid = shard_put(mesh, ov)
        st.refresh_subj_index()
        return st

    def refresh_subj_index(
        self,
        *,
        base_end: Optional[int] = None,
        base_valid=None,
        del_pos=None,
        base_unchanged: bool = False,
    ) -> None:
        """(Re)build the pre-sorted ``(predicate << 32 | subject)`` probe
        index from the CURRENT subject-hashed shards, on their devices.

        With no arguments this is the monolithic full repack.  Two-tier
        callers — the serving layer's delta-segment mirrors, whose
        ``by_subj`` shards are ``cat(base, delta)`` — pass the segment
        geometry instead, and the base sort runs only when the base
        changed:

        - ``base_end``: position splitting each shard's frozen base region
          ``[:base_end]`` from its delta region ``[base_end:]``;
        - ``base_valid``: validity of the base region BEFORE tombstones
          (padding only), so the cached base pack survives delete batches;
        - ``del_pos``: per shard, int64 tombstone positions inside the base
          (``>= base_end`` for padding);
        - ``base_unchanged``: the caller vouches the base region is the
          one of the previous refresh — only the O(delta) packs rebuild.

        Consumers probe :attr:`subj_index_parts` ``(base, tombs, delta)``;
        a key's multiplicity is ``count(base) - count(tombs) +
        count(delta)``.  :meth:`ensure_subj_index` detects a stale index
        structurally (tensor identity)."""
        if base_end is None:
            self.subj_packed_sorted = _pack_sort_device(
                self.by_subj[0], self.by_subj[1], self.by_subj_valid
            )
            empty = _empty_packs(self.mesh)
            self.subj_index_parts = (self.subj_packed_sorted,) + empty
            self._subj_base_packed = None
            self._subj_base_end = None
            self.subj_index_base_builds += 1
        else:
            reuse = (
                base_unchanged
                and self._subj_base_packed is not None
                and self._subj_base_end == base_end
            )
            head = lambda sh: tuple(t[:base_end] for t in sh)  # noqa: E731
            tail = lambda sh: tuple(t[base_end:] for t in sh)  # noqa: E731
            if not reuse:
                bv = base_valid if base_valid is not None else head(self.by_subj_valid)
                self._subj_base_packed = _pack_sort_device(
                    head(self.by_subj[0]), head(self.by_subj[1]), bv
                )
                self._subj_base_end = base_end
                self.subj_index_base_builds += 1
            if del_pos is not None:
                tombs = _tomb_pack_device(head(self.by_subj[0]), head(self.by_subj[1]), del_pos)
            else:
                tombs = _empty_packs(self.mesh)[0]
            delta = _pack_sort_device(
                tail(self.by_subj[0]), tail(self.by_subj[1]), tail(self.by_subj_valid)
            )
            self.subj_index_parts = (self._subj_base_packed, tombs, delta)
            self.subj_packed_sorted = self._subj_base_packed
            self.subj_index_delta_builds += 1
        # weakrefs keep the identity check sound: a collected tensor's
        # dead ref never compares identical to a new one at its address
        self._subj_index_src = tuple(
            weakref.ref(t)
            for t in (*self.by_subj[0], *self.by_subj[1], *self.by_subj_valid)
        )

    def ensure_subj_index(self) -> None:
        """Rebuild the probe index iff ``by_subj`` was reassigned since the
        last build.  The lazy rebuild is the monolithic one; two-tier
        owners refresh explicitly at write-back time."""
        src = self._subj_index_src
        current = (*self.by_subj[0], *self.by_subj[1], *self.by_subj_valid)
        if (
            self.subj_index_parts is None
            or src is None
            or len(src) != len(current)
            or any(r() is not a for r, a in zip(src, current))
        ):
            self.refresh_subj_index()

    def shard_state(self):
        """The columns per shard, as the mesh bodies take them: ``(subject
        copy, its validity, object copy, its validity)``, each a list over
        the shards (of ``(s, p, o)`` tuples for the copies)."""
        n = self.n_shards
        return (
            [tuple(c[i] for c in self.by_subj) for i in range(n)],
            list(self.by_subj_valid),
            [tuple(c[i] for c in self.by_obj) for i in range(n)],
            list(self.by_obj_valid),
        )

    @property
    def n_triples(self) -> int:
        return int(sum(int(v.sum()) for v in self.by_subj_valid))

    def gather_host(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All triples back on host (subject-owned copy), unpadded."""
        v = np.concatenate([t.cpu().numpy() for t in self.by_subj_valid])
        s, p, o = (
            np.concatenate([t.cpu().numpy() for t in col])[v].astype(np.uint32)
            for col in self.by_subj
        )
        return s, p, o


def _pack_sort_device(ss, sp, sv) -> tuple:
    """Per-shard ``(pred << 32 | subj)`` pack + sort, on each shard's
    device; invalid rows get the all-ones key."""
    return tuple(
        torch.sort(torch.where(v, pack2(p, s), _RPAD)).values
        for s, p, v in zip(ss, sp, sv)
    )


def _tomb_pack_device(ss, sp, del_pos) -> tuple:
    """Sorted ``(pred << 32 | subj)`` keys of the tombstoned base rows:
    gather the base columns at the per-shard positions (padding positions
    past the base give the all-ones key) and sort — O(delta) work against
    the O(base) repack it replaces."""
    out = []
    for s, p, pos in zip(ss, sp, del_pos):
        inb = pos < s.shape[0]
        at = pos.clamp(max=s.shape[0] - 1)
        out.append(torch.sort(torch.where(inb, pack2(p[at], s[at]), _RPAD)).values)
    return tuple(out)


def _empty_packs(mesh: Mesh):
    """A pair of tiny all-sentinel sorted packs (tombs, delta) so
    monolithic indexes present the same three-part probe surface as
    two-tier ones."""
    e = np.full((mesh.size, 8), _RPAD, dtype=np.int64)
    arr = shard_put(mesh, e)
    return arr, arr
