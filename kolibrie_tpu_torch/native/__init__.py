"""Loader for the C++ native runtime (``native/kolibrie_native.cpp``).

Port of ``kolibrie_tpu/native/__init__.py``.  The library is compiled
lazily on first use from the repo's ``native/kolibrie_native.cpp`` with the
flags of ``native/Makefile`` (``-O3 -std=c++20 -fPIC -pthread -shared``)
into the git-ignored ``kolibrie_tpu_torch/_build/`` and cached there; the
source directory ``native/`` is only read.  It is host C++ (the SDD engine
among others), not a device kernel.  Everything here degrades as the
reference's loader does: if the compiler or the library is unavailable,
``load()`` returns None and callers keep using the pure-Python
implementations.  Only the entry points that ``sdd_native.py``,
``nt_native.py``, ``ttl_native.py`` and ``join_native.py`` call are
declared.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_SRC_PATH = os.path.join(_REPO, "native", "kolibrie_native.cpp")
_BUILD_DIR = os.path.join(_REPO, "kolibrie_tpu_torch", "_build")
_SO_PATH = os.path.join(_BUILD_DIR, "libkolibrie_native.so")
_CXXFLAGS = ["-O3", "-std=c++20", "-fPIC", "-pthread", "-shared"]

_lock = threading.Lock()
_lib = None
_load_attempted = False


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    i64, f64, ptr = c.c_int64, c.c_double, c.c_void_p
    sigs = {
        "kn_sdd_new": ([], ptr),
        "kn_sdd_free": ([ptr], None),
        "kn_sdd_new_var": ([ptr, f64, f64, c.c_int], i64),
        "kn_sdd_set_weight": ([ptr, i64, f64, f64], None),
        "kn_sdd_literal": ([ptr, i64, c.c_int], i64),
        "kn_sdd_apply": ([ptr, i64, i64, c.c_int], i64),
        "kn_sdd_apply_batch": (
            [ptr, c.POINTER(i64), c.POINTER(i64), i64, c.c_int, c.POINTER(i64)],
            None,
        ),
        "kn_sdd_reduce_groups": (
            [ptr, c.POINTER(i64), c.POINTER(i64), i64, c.c_int, c.POINTER(i64)],
            None,
        ),
        "kn_sdd_negate": ([ptr, i64], i64),
        "kn_sdd_exactly_one": ([ptr, c.POINTER(i64), i64], i64),
        "kn_sdd_wmc": ([ptr, i64], f64),
        "kn_sdd_wmc_gradient": ([ptr, i64, c.POINTER(i64), i64, c.POINTER(f64)], None),
        "kn_sdd_size": ([ptr, i64], i64),
        "kn_sdd_enumerate_models": (
            [ptr, i64, i64, c.POINTER(i64), c.POINTER(c.c_int8), i64, c.POINTER(i64)],
            i64,
        ),
        "kn_nt_parse_mt": ([c.c_char_p, i64, c.c_int, c.POINTER(ptr)], i64),
        "kn_nt_nterms": ([ptr], i64),
        "kn_nt_term_bytes": ([ptr], i64),
        "kn_nt_ids": ([ptr, c.POINTER(c.c_uint32)], None),
        "kn_nt_terms": ([ptr, c.c_char_p, c.POINTER(i64)], None),
        "kn_nt_free": ([ptr], None),
        "kn_rx_parse_mt": ([c.c_char_p, i64, c.c_int, c.POINTER(ptr)], i64),
        "kn_ttl_parse_mt": (
            [c.c_char_p, i64, c.c_int, c.c_char_p, i64, c.POINTER(ptr)],
            i64,
        ),
        "kn_ttl_nterms": ([ptr], i64),
        "kn_ttl_term_bytes": ([ptr], i64),
        "kn_ttl_ids": ([ptr, c.POINTER(c.c_uint32)], None),
        "kn_ttl_terms": ([ptr, c.c_char_p, c.POINTER(i64)], None),
        "kn_ttl_prefixes_len": ([ptr], i64),
        "kn_ttl_prefixes": ([ptr, c.c_char_p], None),
        "kn_ttl_free": ([ptr], None),
        "kn_join_u32": (
            [
                c.POINTER(c.c_uint32),
                i64,
                c.POINTER(c.c_uint32),
                i64,
                c.POINTER(c.c_uint32),
                c.POINTER(c.c_uint32),
                i64,
            ],
            i64,
        ),
        "kn_gather_u32": (
            [c.POINTER(c.c_uint32), c.POINTER(c.c_uint32), i64, c.POINTER(c.c_uint32)],
            None,
        ),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _build() -> bool:
    """Compile into a private file, then rename it into place, so processes
    building at the same time never load a half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(
            [os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", tmp, _SRC_PATH],
            capture_output=True,
            timeout=300,
        )
        if proc.returncode != 0 or not os.path.exists(tmp):
            return False
        os.replace(tmp, _SO_PATH)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load():
    """Return the declared CDLL, or None if native mode is unavailable."""
    global _lib, _load_attempted
    if _lib is not None:
        return _lib
    if _load_attempted:
        return None
    with _lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        stale = not os.path.exists(_SO_PATH) or (
            os.path.exists(_SRC_PATH)
            and os.path.getmtime(_SRC_PATH) > os.path.getmtime(_SO_PATH)
        )
        if stale and not _build():
            return None
        try:
            _lib = _declare(ctypes.CDLL(_SO_PATH))
        except (AttributeError, OSError):
            _lib = None
        return _lib


def available() -> bool:
    return load() is not None
