"""The device engine's hand-written CUDA kernels, their plain PyTorch
versions, and the public entries that wrap them.

Port of ``kolibrie_tpu/ops/pallas_kernels.py``: the merge-path join (the
SPARQL engine's and the fixpoint's joins, and the payload entry
``merge_join``), the WCOJ lex-probe pair, the fused triple-pattern filter
(the fixpoint's premise scans) and the semiring tag combine.  Each kernel
lives in ``kolibrie_tpu_torch/csrc/`` as
CUDA C++ with a plain C interface; :func:`build_kernels` compiles every
source with ``nvcc`` for ``sm_90a`` (one process per source, all started
together) into ``kolibrie_tpu_torch/_build/`` at first use, and ``ctypes``
loads the shared libraries.

Routing has no switch: a wrapper given CPU tensors runs the kernel's plain
version (the CPU tests hold it against the JAX package); given CUDA tensors
it launches the kernel, or raises.  Each launch adds one to
``LAUNCHES[<kernel>]``; the join entries also count in ``ENTRY_LAUNCHES``
when their call reaches the kernel, so a run can show which of the two
join forms the device path went through.

Carriers: IDs, row indices and counts are int64 tensors, masks are bool
(see :mod:`kolibrie_tpu_torch.backend`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

from kolibrie_tpu_torch.backend import SENT

__all__ = [
    "LAUNCHES",
    "ENTRY_LAUNCHES",
    "reset_launches",
    "build_kernels",
    "build_log",
    "filter_mask",
    "filter_mask_plain",
    "merge_join",
    "merge_path",
    "merge_path_plain",
    "merge_join_indices",
    "ranked_merge_join_indices",
    "lex_probe_select",
    "lex_probe_select_plain",
    "lex_probe_validate",
    "lex_probe_validate_plain",
    "tag_combine",
    "tag_combine_plain",
]

# Output-length granule of the join entries: capacities round up to whole
# 1024-slot groups, the reference's (8 x 128) kernel block.
CAP_GRANULE = 1024

LAUNCHES: Dict[str, int] = {
    "merge_path_join": 0,
    "lex_probe_select": 0,
    "lex_probe_validate": 0,
    "filter_mask": 0,
    "tag_combine": 0,
}
ENTRY_LAUNCHES: Dict[str, int] = {
    "merge_join_indices": 0,
    "ranked_merge_join_indices": 0,
    "merge_join": 0,
}


def reset_launches() -> None:
    for d in (LAUNCHES, ENTRY_LAUNCHES):
        for k in d:
            d[k] = 0


# ---------------------------------------------------------------------------
# build and binding
# ---------------------------------------------------------------------------

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_SOURCES = {
    "merge_join": "merge_join.cu",
    "lex_probe": "lex_probe.cu",
    "filter_mask": "filter_mask.cu",
    "tag_combine": "tag_combine.cu",
}
_NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]
_LIBS: Dict[str, ctypes.CDLL] = {}
_BUILD_LOG: Dict[str, str] = {}
_BUILD_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    "merge_join": {
        # cum, low_c, lidx_c, total, n_rows, ln, rn, cap, li, ri, valid, stream
        "kolibrie_merge_path_join": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    },
    "lex_probe": {
        # kk, ch, in_range, host acc table, a_count, p, val, ok, is_base, stream
        "kolibrie_lex_probe_select": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _P],
        # ok, is_base, ch, host acc table, a_count, p, out, stream
        "kolibrie_lex_probe_validate": [_P, _P, _P, _P, _I, _I, _P, _P],
        "kolibrie_lex_probe_max_accessors": [],
    },
    "filter_mask": {
        # s, p, o, n, s_const, p_const, o_const, active bits, o_op, o_cmp, mask, stream
        "kolibrie_filter_mask": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    },
    "tag_combine": {
        # a, b, n, op, out, stream
        "kolibrie_tag_combine": [_P, _P, _I, _I, _P, _P],
    },
}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    src = (_CSRC / _SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD / f"lib{name}_{digest}.so"


def build_kernels() -> Dict[str, str]:
    """Compile every kernel source that has no current library yet, one
    ``nvcc`` process per source, all started together.  Returns the
    ``-Xptxas -v`` report of each source built by this call (register and
    shared-memory use per kernel).  Raises with the compiler's output when
    a build fails."""
    with _BUILD_LOCK:
        _BUILD.mkdir(exist_ok=True)
        procs = {}
        nvcc = None
        for name, src in _SOURCES.items():
            out = _lib_path(name)
            if out.exists():
                continue
            nvcc = nvcc or _nvcc()
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (
                subprocess.Popen(
                    [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC / src)],
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                    text=True,
                ),
                tmp,
                out,
            )
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            _BUILD_LOG[name] = log
            if proc.returncode != 0:
                failed.append(f"{_SOURCES[name]}:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return {name: _BUILD_LOG[name] for name in procs}


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_kernels()
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True to launch the kernel, False for the plain version (CPU
    tensors); raises for anything else or for mixed devices."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return True


def _arg(t: torch.Tensor, dtype: torch.dtype, n: Optional[int] = None) -> int:
    """Data pointer of a kernel operand after checking what the kernel
    takes: dtype, 1-D length and contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"kernel operand has dtype {t.dtype}, needs {dtype}")
    if n is not None and (t.dim() != 1 or t.shape[0] != n):
        raise ValueError(f"kernel operand has shape {tuple(t.shape)}, needs ({n},)")
    if not t.is_contiguous():
        raise ValueError("kernel operand must be contiguous")
    return t.data_ptr()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its data does not start on a 16-byte
    boundary (a view into a column): the elementwise kernels move 16 bytes
    at a time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _ptr_table(cols: Sequence[torch.Tensor], a_count: int):
    """Host array of column addresses, which the C entry copies into the
    kernel's parameter table: no device copy and no stream sync per launch.
    Raises past the table's size."""
    most = _lib("lex_probe").kolibrie_lex_probe_max_accessors()
    if not 1 <= a_count <= most:
        raise ValueError(f"{a_count} accessors; the lex-probe kernels take 1 to {most}")
    return (ctypes.c_void_p * len(cols))(*[c.data_ptr() for c in cols])


# ---------------------------------------------------------------------------
# merge-path join
# ---------------------------------------------------------------------------
#
# Replaces kolibrie_tpu/ops/pallas_kernels.py:_merge_join_kernel (driven by
# _pallas_join_core / _pallas_join_core_chunked).  For every output slot k
# it finds the compacted left row whose cumulative match range holds k and
# emits the left row index, the right position low + (k - cumprev) and the
# valid bit.
#
# Bound on the H100: bytes.  Per output slot it writes 8 + 8 + 1 bytes, and
# it reads the (cum, low, lidx) of the rows that feed the slots once; at
# 3.35 TB/s that is the floor.  Design (csrc/merge_join.cu): one launch for
# any size, reading ``total`` on the device.  Each 256-thread block owns
# 1,024 consecutive slots, 4 a thread.  A tile past ``total`` writes zeros
# and searches nothing.  Otherwise the block's two halves find its first and
# last row with 128-ary searches over cum (one or two dependent loads; the
# reference's wrapper precomputes the same partition with a searchsorted),
# copy that window into shared memory, and each thread searches it once for
# its first slot and walks forward; li and ri are staged in shared memory
# and leave as coalesced 16-byte stores.  No chunked launcher and no 2^19
# offset limit (those were Mosaic constraints).


def _join_prepass(lkey: torch.Tensor, rkey: torch.Tensor):
    """Run bounds, stable compaction of matched rows to the front, cumsum.
    ``rkey`` must be sorted.  Returns ``(lidx_c, low_c, cum, total)``: the
    original left row index and right run start of each compacted row, the
    inclusive match-count prefix, and the exact match count (a 0-dim int64
    tensor, read by the kernel on the device)."""
    ln = lkey.shape[0]
    low = torch.searchsorted(rkey, lkey)
    counts = torch.searchsorted(rkey, lkey, right=True) - low
    hit = counts > 0
    n_hit = hit.sum()
    # stable compaction without a sort: matched rows first, then the rest,
    # each in original order (== a stable argsort of counts == 0)
    dest = torch.where(
        hit, torch.cumsum(hit, 0) - 1, n_hit + torch.cumsum(~hit, 0) - 1
    )
    lidx_c = torch.empty(ln, dtype=torch.int64, device=lkey.device)
    lidx_c[dest] = torch.arange(ln, dtype=torch.int64, device=lkey.device)
    cum = torch.cumsum(counts[lidx_c], 0)
    return lidx_c, low[lidx_c], cum, cum[-1]


def merge_path_plain(lidx_c, low_c, cum, total, ln: int, rn: int, cap: int):
    """Plain PyTorch version of the merge-path kernel (same outputs)."""
    k = torch.arange(cap, dtype=torch.int64, device=cum.device)
    row = torch.searchsorted(cum, k, right=True).clamp_(max=cum.shape[0] - 1)
    cumprev = torch.where(row > 0, cum[(row - 1).clamp(min=0)], 0)
    valid = k < total
    li = torch.where(valid, lidx_c[row].clamp(0, ln - 1), 0)
    ri = torch.where(valid, (low_c[row] + (k - cumprev)).clamp(0, rn - 1), 0)
    return li, ri, valid


def merge_path(lidx_c, low_c, cum, total, ln: int, rn: int, cap: int):
    """The merge-path kernel wrapper: ``(li, ri, valid)`` of length
    ``cap`` from the :func:`_join_prepass` outputs."""
    if not _on_cuda(lidx_c, low_c, cum, total):
        return merge_path_plain(lidx_c, low_c, cum, total, ln, rn, cap)
    n = cum.shape[0]
    dev = cum.device
    li = torch.empty(cap, dtype=torch.int64, device=dev)
    ri = torch.empty(cap, dtype=torch.int64, device=dev)
    valid = torch.empty(cap, dtype=torch.bool, device=dev)
    if total.dtype != torch.int64 or total.numel() != 1:
        raise TypeError("total must be one int64 element")
    err = _lib("merge_join").kolibrie_merge_path_join(
        _arg(cum, torch.int64, n),
        _arg(low_c, torch.int64, n),
        _arg(lidx_c, torch.int64, n),
        total.data_ptr(),
        n,
        ln,
        rn,
        cap,
        li.data_ptr(),
        ri.data_ptr(),
        valid.data_ptr(),
        _stream(dev),
    )
    _check(err, "merge_path_join")
    LAUNCHES["merge_path_join"] += 1
    return li, ri, valid


def _round_out(cap: int) -> int:
    return max(1, -(-cap // CAP_GRANULE)) * CAP_GRANULE


def _merge_join_core(lkey, rkey, cap_r: Optional[int], entry: str):
    """Prepass and merge-path kernel.  ``cap_r=None``: the outputs hold
    exactly the matches, their count read from the prepass (one host
    read)."""
    ln, rn = lkey.shape[0], rkey.shape[0]
    dev = lkey.device
    if ln == 0 or rn == 0:
        cap_r = cap_r or 0
        z = torch.zeros(cap_r, dtype=torch.int64, device=dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return z, z.clone(), torch.zeros(cap_r, dtype=torch.bool, device=dev), zero
    lidx_c, low_c, cum, total = _join_prepass(lkey, rkey)
    exact = cap_r is None
    if exact:
        n = int(total)
        cap_r = _round_out(n)
    li, ri, valid = merge_path(lidx_c, low_c, cum, total, ln, rn, cap_r)
    if exact:
        li, ri, valid = li[:n], ri[:n], valid[:n]
    if dev.type == "cuda":
        ENTRY_LAUNCHES[entry] += 1
    return li, ri, valid, total


def merge_join_indices(
    lkey: torch.Tensor,
    rkey_sorted: torch.Tensor,
    cap: int,
    lvalid: Optional[torch.Tensor] = None,
    rvalid_prefix: Optional[torch.Tensor] = None,
):
    """Index-returning merge join over single u32 key columns (the device
    engine's presorted join).  Port of ``pallas_kernels.merge_join_indices``.

    Returns ``(li, ri, valid, total)``: int64 row indices into the original
    inputs with matches as a prefix, length ``cap`` rounded up to a
    multiple of 1024, and the exact match count.  ``rvalid_prefix`` must be
    a prefix mask; ``lvalid`` may have holes (left order is irrelevant)."""
    if lvalid is not None:
        lkey = torch.where(lvalid, lkey, SENT - 1)
    if rvalid_prefix is not None:
        rkey_sorted = torch.where(rvalid_prefix, rkey_sorted, SENT)
    return _merge_join_core(lkey, rkey_sorted, _round_out(cap), "merge_join_indices")


def ranked_merge_join_indices(
    lkey: torch.Tensor, rkey: torch.Tensor, cap: Optional[int] = None
):
    """Merge join for arbitrary (packed, unsorted) key carriers: dense-rank
    both sides over their sorted union (equal keys get equal ranks,
    distinct padding keys stay distinct), sort the right ranks, run the
    merge-path kernel and map ``ri`` back through the sort permutation.
    Same ``(li, ri, valid, total)`` contract as
    :func:`kolibrie_tpu_torch.ops.device_join.join_indices`, with outputs
    of exactly ``cap``; ``cap=None`` sizes them to the exact match count,
    read from the prepass (one host read).  Pairs come left row by left
    row, each left row's matches in the right side's stable-sorted order."""
    dev = lkey.device
    if lkey.shape[0] == 0 or rkey.shape[0] == 0:
        cap = cap or 0
        z = torch.zeros(cap, dtype=torch.int64, device=dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return z, z.clone(), torch.zeros(cap, dtype=torch.bool, device=dev), zero
    union = torch.sort(torch.cat([lkey, rkey])).values
    lrank = torch.searchsorted(union, lkey)
    rrank = torch.searchsorted(union, rkey)
    rorder = torch.argsort(rrank, stable=True)
    li, rpos, valid, total = _merge_join_core(
        lrank, rrank[rorder], None if cap is None else _round_out(cap),
        "ranked_merge_join_indices",
    )
    if cap is not None:
        li, rpos, valid = li[:cap], rpos[:cap], valid[:cap]
    ri = torch.where(valid, rorder[rpos], 0)
    return li, ri, valid, total


def merge_join(
    lkey: torch.Tensor, lval: torch.Tensor, rkey: torch.Tensor, rval: torch.Tensor, cap: int
):
    """Equi-join of two u32 runs with payloads, on the merge-path kernel.
    Port of ``pallas_kernels.merge_join``.

    ``rkey`` must be sorted ascending (``lkey`` in any order); keys and
    payloads are int64 carriers of u32 values.  Returns ``(key, lval, rval,
    valid, total)``: the joined key and both payloads of every match as a
    prefix, zeros past it, length ``cap`` rounded up to a multiple of 1024,
    and the exact match count.  The right payload is gathered at the
    kernel's right row index."""
    cap_r = _round_out(cap)
    dev = lkey.device
    if lkey.shape[0] == 0 or rkey.shape[0] == 0:
        z = torch.zeros(cap_r, dtype=torch.int64, device=dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return z, z.clone(), z.clone(), torch.zeros(cap_r, dtype=torch.bool, device=dev), zero
    li, ri, valid, total = _merge_join_core(lkey, rkey, cap_r, "merge_join")
    return (
        torch.where(valid, lkey[li], 0),
        torch.where(valid, lval[li], 0),
        torch.where(valid, rval[ri], 0),
        valid,
        total,
    )


# ---------------------------------------------------------------------------
# WCOJ lex-probe pair
# ---------------------------------------------------------------------------
#
# Replace kolibrie_tpu/ops/pallas_kernels.py:_lex_probe_select_kernel and
# _lex_probe_validate_kernel.  Both are elementwise over one WCOJ level's
# candidate slots, one thread per slot; the accessor count is a runtime
# argument and each accessor's column addresses arrive by value in the
# kernel's parameter table (at most 16 accessors), so a launch
# adds no host-to-device copy and no stream synchronisation.
#
# Bound on the H100: bytes.  select reads (kk, ch, in_range) and then ONLY
# the chosen accessor's nb and one side's value (plus its predecessor
# unless the slot starts its range); the reference computes every accessor
# and selects.  validate reads ok for every slot and (is_base, ch) and the
# accessors' seven columns only for slots still valid — an invalid slot
# stays invalid whatever the probes say.  chip_smoke counts exactly those
# reads and the outputs written once, at 3.35 TB/s.


def lex_probe_select_plain(kk, ch, in_range, accessors):
    """Plain PyTorch version of the select kernel (same outputs)."""
    val = torch.zeros_like(kk)
    first = torch.zeros_like(in_range)
    is_base = torch.zeros_like(in_range)
    for a, (nb, bval, dval, bprev, dprev) in enumerate(accessors):
        isb = kk < nb
        first_a = torch.where(
            isb, (kk == 0) | (bprev != bval), (kk == nb) | (dprev != dval)
        )
        pick = ch == a
        val = torch.where(pick, torch.where(isb, bval, dval), val)
        first = torch.where(pick, first_a, first)
        is_base = torch.where(pick, isb, is_base)
    ok = in_range & (val != SENT) & first
    return val, ok, is_base


def lex_probe_select(kk, ch, in_range, accessors):
    """Per-slot candidate materialization for one WCOJ level.

    ``kk``/``ch`` int64 slot vectors (rank within the chosen range, chosen
    accessor), ``in_range`` bool; ``accessors`` a sequence of ``(nb, bval,
    dval, bprev, dprev)`` int64 tuples — each accessor's base range width
    and its base/delta value and predecessor columns at every slot.
    Returns ``(val, ok, is_base)``: the merged candidate value, the
    in-range & non-sentinel & first-of-run mask, and whether the chosen
    slot came from the base segment."""
    flat = [t for acc in accessors for t in acc]
    if not _on_cuda(kk, ch, in_range, *flat):
        return lex_probe_select_plain(kk, ch, in_range, accessors)
    p = kk.shape[0]
    dev = kk.device
    for t in flat:
        _arg(t, torch.int64, p)
    table = _ptr_table(flat, len(accessors))
    val = torch.empty(p, dtype=torch.int64, device=dev)
    ok = torch.empty(p, dtype=torch.bool, device=dev)
    is_base = torch.empty(p, dtype=torch.bool, device=dev)
    err = _lib("lex_probe").kolibrie_lex_probe_select(
        _arg(kk, torch.int64, p),
        _arg(ch, torch.int64, p),
        _arg(in_range, torch.bool, p),
        ctypes.cast(table, _P),
        len(accessors),
        p,
        val.data_ptr(),
        ok.data_ptr(),
        is_base.data_ptr(),
        _stream(dev),
    )
    _check(err, "lex_probe_select")
    LAUNCHES["lex_probe_select"] += 1
    return val, ok, is_base


def lex_probe_validate_plain(ok, is_base, ch, accessors):
    """Plain PyTorch version of the validate kernel (same output)."""
    v = ok
    braw = torch.zeros_like(ok)
    for a, (fl, fh, tl, th, dl2, dh2, sent) in enumerate(accessors):
        live = ((fh - fl) - (th - tl) + (dh2 - dl2)) > 0
        v = v & live & ~sent
        braw = torch.where(ch == a, (fh - fl) > 0, braw)
    return v & (is_base | ~braw)


def lex_probe_validate(ok, is_base, ch, accessors):
    """Per-slot validation for one WCOJ level: tombstone-adjusted
    existence liveness against every accessor, the key-sentinel kill and
    the base-representative tie-break.  ``accessors`` is a sequence of
    ``(fl, fh, tl, th, dl2, dh2, sent)`` tuples (int64 ranges, bool
    ``sent``).  Returns the final bool validity mask."""
    flat = [t for acc in accessors for t in acc]
    if not _on_cuda(ok, is_base, ch, *flat):
        return lex_probe_validate_plain(ok, is_base, ch, accessors)
    p = ok.shape[0]
    dev = ok.device
    for acc in accessors:
        for t in acc[:6]:
            _arg(t, torch.int64, p)
        _arg(acc[6], torch.bool, p)
    table = _ptr_table(flat, len(accessors))
    out = torch.empty(p, dtype=torch.bool, device=dev)
    err = _lib("lex_probe").kolibrie_lex_probe_validate(
        _arg(ok, torch.bool, p),
        _arg(is_base, torch.bool, p),
        _arg(ch, torch.int64, p),
        ctypes.cast(table, _P),
        len(accessors),
        p,
        out.data_ptr(),
        _stream(dev),
    )
    _check(err, "lex_probe_validate")
    LAUNCHES["lex_probe_validate"] += 1
    return out


# ---------------------------------------------------------------------------
# fused triple-pattern filter
# ---------------------------------------------------------------------------
#
# Replaces kolibrie_tpu/ops/pallas_kernels.py:_filter_kernel.  One pass over
# the ID columns, mask out; only the columns of active clauses are read.
# Bound on the H100: bytes (8 per active column and row, plus the 1-byte
# mask).  The int64 carriers double the column bytes of the reference's u32.
# Design (csrc/filter_mask.cu): one kernel per clause pattern and o_op,
# picked by the C entry, so no branch on the pattern runs per row; each
# thread takes four rows with no loop (two 16-byte loads a column, one
# 4-byte mask store).

# o_op codes: the reference's _OPS (eq, ne, lt, le, gt, ge); -1 is no compare
_FILTER_CMP = (torch.eq, torch.ne, torch.lt, torch.le, torch.gt, torch.ge)
_U32_MAX = 0xFFFFFFFF


def _filter_args(s_const, p_const, o_const, o_op, o_cmp) -> None:
    for name, c in (("s_const", s_const), ("p_const", p_const), ("o_const", o_const)):
        if not -1 <= c <= _U32_MAX:
            raise ValueError(f"{name}={c}: a u32 ID or -1 (wildcard)")
    if not -1 <= o_op < len(_FILTER_CMP):
        raise ValueError(f"o_op={o_op}: -1 or 0..5 (eq, ne, lt, le, gt, ge)")
    if not 0 <= o_cmp <= _U32_MAX:
        raise ValueError(f"o_cmp={o_cmp}: a u32 value")


def filter_mask_plain(s, p, o, s_const=-1, p_const=-1, o_const=-1, o_op=-1, o_cmp=0):
    """Plain PyTorch version of the filter kernel (same mask)."""
    m = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    for col, c in ((s, s_const), (p, p_const), (o, o_const)):
        if c >= 0:
            m &= col == c
    if o_op >= 0:
        m &= _FILTER_CMP[o_op](o, o_cmp)
    return m


def filter_mask(
    s: torch.Tensor,
    p: torch.Tensor,
    o: torch.Tensor,
    s_const: int = -1,
    p_const: int = -1,
    o_const: int = -1,
    o_op: int = -1,
    o_cmp: int = 0,
) -> torch.Tensor:
    """Fused triple-pattern + comparison filter over ID columns.  Port of
    ``pallas_kernels.filter_mask``.

    ``s``/``p``/``o`` are int64 carriers of u32 IDs; a constant of ``-1`` is
    a wildcard, any other a u32 ID the column must equal.  ``o_op`` (0..5:
    eq, ne, lt, le, gt, ge; -1 none) adds one unsigned comparison of the
    object against ``o_cmp``.  Returns the bool mask."""
    _filter_args(s_const, p_const, o_const, o_op, o_cmp)
    if not _on_cuda(s, p, o):
        return filter_mask_plain(s, p, o, s_const, p_const, o_const, o_op, o_cmp)
    n = s.shape[0]
    s, p, o = (_aligned(c) for c in (s, p, o))
    active = int(s_const >= 0) | int(p_const >= 0) << 1 | int(o_const >= 0) << 2
    mask = torch.empty(n, dtype=torch.bool, device=s.device)
    err = _lib("filter_mask").kolibrie_filter_mask(
        _arg(s, torch.int64, n),
        _arg(p, torch.int64, n),
        _arg(o, torch.int64, n),
        n,
        max(s_const, 0),
        max(p_const, 0),
        max(o_const, 0),
        active,
        o_op,
        o_cmp,
        mask.data_ptr(),
        _stream(s.device),
    )
    _check(err, "filter_mask")
    LAUNCHES["filter_mask"] += 1
    return mask


# ---------------------------------------------------------------------------
# semiring tag combine
# ---------------------------------------------------------------------------
#
# Replaces kolibrie_tpu/ops/pallas_kernels.py:_tag_kernel_factory.
# Elementwise over f32 tag columns; bound on the H100: bytes (12 a row).
# The same bits as the reference's XLA ops: min/max propagate NaN and order
# -0 below +0; noisy-or rounds 1 - a and 1 - b, then 1 - (1 - a)(1 - b)
# once, as the fused multiply-add XLA contracts it into.

_TAG_OPS = ("min", "max", "mul", "noisy_or")


def _one_minus_product(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``1 - x*y`` of float32 columns rounded once to float32, as a fused
    multiply-add gives it.  The product is exact in float64; the
    difference is rounded to odd there (Fast2Sum recovers its rounding
    error exactly, and an even result with a nonzero error moves one step
    toward it), and rounding to odd at 53 bits and then to nearest at 24
    is the one correct rounding."""
    prod = x.double() * y.double()
    hi = 1.0 - prod
    err = -prod - (hi - 1.0)  # 1 - prod == hi + err, exactly
    # one step of the bit pattern toward err: up in magnitude when err and
    # hi share their sign (NaN and infinities stay as they are: err is NaN)
    step = (err > 0).to(torch.int64) - (err < 0).to(torch.int64)
    bits = hi.view(torch.int64)
    bits = torch.where((bits & 1) == 0, bits + torch.where(hi < 0, -step, step), bits)
    return bits.view(torch.float64).to(torch.float32)


def tag_combine_plain(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    """Plain PyTorch version of the tag kernel (same bits)."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    if op == "min":
        return torch.where((a < b) | torch.isnan(a) | ((a == b) & torch.signbit(a)), a, b)
    if op == "max":
        return torch.where((a > b) | torch.isnan(a) | ((a == b) & ~torch.signbit(a)), a, b)
    if op == "mul":
        return a * b
    if op == "noisy_or":
        return _one_minus_product(1.0 - a, 1.0 - b)
    raise ValueError(f"unknown tag op {op!r}")


def tag_combine(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    """Vectorized semiring combine on f32 tag columns.  Port of
    ``pallas_kernels.tag_combine``: ``min``/``max`` serve MinMaxProbability
    and ExpirationProvenance, ``mul``/``noisy_or`` (``1 - (1-a)(1-b)``)
    AddMultProbability.  Inputs are cast to float32; an unknown ``op``
    raises ``ValueError``."""
    if op not in _TAG_OPS:
        raise ValueError(f"unknown tag op {op!r}")
    a, b = a.to(torch.float32), b.to(torch.float32)
    if not _on_cuda(a, b):
        return tag_combine_plain(a, b, op)
    n = a.shape[0]
    a, b = _aligned(a), _aligned(b)
    out = torch.empty(n, dtype=torch.float32, device=a.device)
    err = _lib("tag_combine").kolibrie_tag_combine(
        _arg(a, torch.float32, n),
        _arg(b, torch.float32, n),
        n,
        _TAG_OPS.index(op),
        out.data_ptr(),
        _stream(a.device),
    )
    _check(err, "tag_combine")
    LAUNCHES["tag_combine"] += 1
    return out


def build_log() -> Dict[str, str]:
    """``-Xptxas -v`` output of the sources built in this process."""
    return dict(_BUILD_LOG)

