"""The device engine's hand-written CUDA kernels, their plain PyTorch
versions, and the public entries that wrap them.

Port of ``kolibrie_tpu/ops/pallas_kernels.py`` for the three kernels on the
SPARQL SELECT path.  Each kernel lives in ``kolibrie_tpu_torch/csrc/`` as
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
    "merge_path",
    "merge_path_plain",
    "merge_join_indices",
    "ranked_merge_join_indices",
    "lex_probe_select",
    "lex_probe_select_plain",
    "lex_probe_validate",
    "lex_probe_validate_plain",
]

# Output-length granule of the join entries: capacities round up to whole
# 1024-slot groups, the reference's (8 x 128) kernel block.
CAP_GRANULE = 1024

LAUNCHES: Dict[str, int] = {
    "merge_path_join": 0,
    "lex_probe_select": 0,
    "lex_probe_validate": 0,
}
ENTRY_LAUNCHES: Dict[str, int] = {
    "merge_join_indices": 0,
    "ranked_merge_join_indices": 0,
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
_SOURCES = {"merge_join": "merge_join.cu", "lex_probe": "lex_probe.cu"}
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
# Bound on the H100: bytes.  Per output slot it writes 8 + 8 + 1 bytes and
# reads the row's (cum, low, lidx) once; at 3.35 TB/s that is the floor.
# Design: one launch for any size.  Each 256-thread block owns 256 output
# slots, finds its first row with one binary search over cum (the
# merge-path partition), stages its row window (at most 257 rows, since
# every compacted row emits >= 1 output) in shared memory, and each thread
# binary-searches that window for its slot's row — no gather beyond the
# row's own attributes, no chunked launcher, no 2^19 offset limit (those were
# Mosaic constraints).


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


def _merge_join_core(lkey, rkey, cap_r: int, entry: str):
    ln, rn = lkey.shape[0], rkey.shape[0]
    dev = lkey.device
    if ln == 0 or rn == 0:
        z = torch.zeros(cap_r, dtype=torch.int64, device=dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return z, z.clone(), torch.zeros(cap_r, dtype=torch.bool, device=dev), zero
    lidx_c, low_c, cum, total = _join_prepass(lkey, rkey)
    li, ri, valid = merge_path(lidx_c, low_c, cum, total, ln, rn, cap_r)
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


def ranked_merge_join_indices(lkey: torch.Tensor, rkey: torch.Tensor, cap: int):
    """Merge join for arbitrary (packed, unsorted) key carriers: dense-rank
    both sides over their sorted union (equal keys get equal ranks,
    distinct padding keys stay distinct), sort the right ranks, run the
    merge-path kernel and map ``ri`` back through the sort permutation.
    Same ``(li, ri, valid, total)`` contract as
    :func:`kolibrie_tpu_torch.ops.device_join.join_indices`, with outputs
    of exactly ``cap``."""
    dev = lkey.device
    if lkey.shape[0] == 0 or rkey.shape[0] == 0:
        z = torch.zeros(cap, dtype=torch.int64, device=dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return z, z.clone(), torch.zeros(cap, dtype=torch.bool, device=dev), zero
    union = torch.sort(torch.cat([lkey, rkey])).values
    lrank = torch.searchsorted(union, lkey)
    rrank = torch.searchsorted(union, rkey)
    rorder = torch.argsort(rrank, stable=True)
    li, rpos, valid, total = _merge_join_core(
        lrank, rrank[rorder], _round_out(cap), "ranked_merge_join_indices"
    )
    li, rpos, valid = li[:cap], rpos[:cap], valid[:cap]
    ri = torch.where(valid, rorder[rpos], 0)
    return li, ri, valid, total


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


def build_log() -> Dict[str, str]:
    """``-Xptxas -v`` output of the sources built in this process."""
    return dict(_BUILD_LOG)

