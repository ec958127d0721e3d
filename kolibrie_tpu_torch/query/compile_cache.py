"""Kernel build cache and the prewarm manifest — kill the restart tail.

Port of ``kolibrie_tpu/query/compile_cache.py``.  The reference turns on
JAX's persistent XLA compilation cache; eager PyTorch compiles no
per-template program, so what a restarted process pays here is the
``nvcc`` build of the kernel libraries (``ops/kernels.py``).  This module
points that build at a shared directory:

- **Location**: ``$KOLIBRIE_COMPILE_CACHE_DIR``, else
  ``<data_dir>/compile_cache``.  No directory → the kernels build into the
  package's git-ignored ``_build/`` as before.
- **Keying**: libraries live under ``<root>/<torch-version>-<cuda>-<arch>/``
  and each file name carries a digest of its source and ``nvcc`` flags,
  so a toolkit, PyTorch or source change never loads a stale binary.
- **Counters**: a library loaded from an existing build in the enabled
  directory is a *hit*, one that ``nvcc`` builds there a *miss*
  (:func:`counters`, ``kolibrie_compile_cache_{hits,misses}_total``).

The module also owns the **prewarm manifest**, in the reference's file
format: a small JSON file at the cache root recording, per template
fingerprint, one representative query text and its cumulative hit count,
plus the stats advisor's learned cardinalities.  On startup the warmer
(:mod:`kolibrie_tpu_torch.query.prewarm`) replays the top-N entries.  A
manifest written by either package loads in the other.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional

from kolibrie_tpu_torch.obs import metrics as _metrics

__all__ = [
    "enable",
    "enabled_dir",
    "note_library",
    "cache_namespace",
    "stats",
    "counters",
    "manifest_path",
    "load_manifest",
    "save_manifest",
    "record_template",
    "manifest_snapshot",
    "suppress_recording",
]

_HITS = _metrics.counter(
    "kolibrie_compile_cache_hits_total",
    "kernel libraries loaded from an existing build in the cache directory",
)
_MISSES = _metrics.counter(
    "kolibrie_compile_cache_misses_total",
    "kernel libraries built by nvcc into the cache directory",
)

_lock = threading.Lock()
_active_dir: Optional[str] = None
# raw tallies, independent of the obs registry being enabled
_event_counts = {"hits": 0, "misses": 0}


def cache_namespace() -> str:
    """Version/toolkit namespace segment: libraries are valid exactly as
    long as (torch version, CUDA version, target arch) all match."""
    import torch

    from kolibrie_tpu_torch.ops.kernels import TARGET_ARCH

    return f"torch{torch.__version__}-cuda{torch.version.cuda}-{TARGET_ARCH}"


def note_library(hit: bool) -> None:
    """Account one kernel library of the enabled directory: loaded from an
    existing build (hit) or built by ``nvcc`` (miss)."""
    if hit:
        _event_counts["hits"] += 1
        _HITS.inc()
    else:
        _event_counts["misses"] += 1
        _MISSES.inc()


def enable(
    data_dir: Optional[str] = None, explicit_dir: Optional[str] = None
) -> Optional[str]:
    """Idempotently point the kernel build at the cache directory.

    Resolution order: ``explicit_dir`` argument →
    ``$KOLIBRIE_COMPILE_CACHE_DIR`` → ``<data_dir>/compile_cache``.
    Returns the active namespaced directory, or ``None`` when no location
    is configured (build directory left as it is).  Libraries already
    loaded in this process stay loaded; the next build or load uses the
    new directory."""
    global _active_dir
    root = explicit_dir or os.environ.get("KOLIBRIE_COMPILE_CACHE_DIR")
    if not root and data_dir:
        root = os.path.join(data_dir, "compile_cache")
    if not root:
        return None
    target = os.path.join(os.path.abspath(root), cache_namespace())
    with _lock:
        if _active_dir == target:
            return _active_dir
        from kolibrie_tpu_torch.ops import kernels

        os.makedirs(target, exist_ok=True)
        kernels.set_build_dir(target)
        _active_dir = target
    return target


def enabled_dir() -> Optional[str]:
    return _active_dir


def counters() -> Dict[str, int]:
    """Raw (registry-independent) hit/miss tallies since process start —
    a dispatch's source is "disk" when every library came from a hit."""
    return dict(_event_counts)


def stats() -> dict:
    """Inspection block for /stats: location, entry count, bytes, and
    the hit/miss tallies."""
    out: dict = {
        "enabled": _active_dir is not None,
        "dir": _active_dir,
        "hits": _event_counts["hits"],
        "misses": _event_counts["misses"],
    }
    if _active_dir and os.path.isdir(_active_dir):
        entries = 0
        size = 0
        try:
            for name in os.listdir(_active_dir):
                p = os.path.join(_active_dir, name)
                if os.path.isfile(p):
                    entries += 1
                    size += os.path.getsize(p)
        except OSError:
            pass
        out["entries"] = entries
        out["bytes"] = size
    return out


# ---------------------------------------------------------------------------
# Pre-warm manifest: fingerprint -> representative query + hit count
# ---------------------------------------------------------------------------

_MANIFEST_NAME = "prewarm_manifest.json"
_MANIFEST_MAX = 256  # top-N by hits kept on disk

# in-memory accumulation: fp -> {"query": str, "hits": int}
_templates: Dict[str, Dict] = {}
_templates_lock = threading.Lock()
_suppress = threading.local()


class suppress_recording:
    """Context manager: executions inside do not feed the manifest.
    The warmer wraps its replays in this so warming the top-N does not
    inflate the very popularity ranking it replays."""

    def __enter__(self):
        self._prev = getattr(_suppress, "on", False)
        _suppress.on = True
        return self

    def __exit__(self, *exc):
        _suppress.on = self._prev
        return False


def manifest_path(root: Optional[str] = None) -> Optional[str]:
    """The manifest lives at the cache ROOT (not the versioned
    namespace): query texts replay across toolkit upgrades just fine."""
    base = root or _active_dir
    if base is None:
        return None
    if base == _active_dir:
        base = os.path.dirname(base)  # strip the namespace segment
    return os.path.join(base, _MANIFEST_NAME)


def record_template(fp: str, query: str) -> None:
    """Account one execution of template ``fp``; keeps the first-seen
    query text as the replayable representative.  Called from the
    executor's plan-cache bookkeeping — must stay O(1)."""
    if getattr(_suppress, "on", False):
        return
    with _templates_lock:
        ent = _templates.get(fp)
        if ent is None:
            if len(_templates) >= 4 * _MANIFEST_MAX:
                # bound the accumulator; the save path re-ranks anyway
                drop = min(_templates, key=lambda k: _templates[k]["hits"])
                _templates.pop(drop)
            _templates[fp] = {"query": query, "hits": 1}
        else:
            ent["hits"] += 1


def manifest_snapshot() -> List[dict]:
    """Current top-N, hottest first."""
    with _templates_lock:
        items = [
            {"fp": fp, "query": e["query"], "hits": e["hits"]}
            for fp, e in _templates.items()
        ]
    items.sort(key=lambda e: (-e["hits"], e["fp"]))
    return items[:_MANIFEST_MAX]


def save_manifest(root: Optional[str] = None) -> Optional[str]:
    """Atomically persist the ranked manifest (tmp + fsync + rename)."""
    path = manifest_path(root)
    if path is None:
        return None
    merged: Dict[str, dict] = {
        e["fp"]: e for e in load_manifest(root)
    }
    for e in manifest_snapshot():
        old = merged.get(e["fp"])
        if old is None or e["hits"] >= old.get("hits", 0):
            merged[e["fp"]] = e
    ranked = sorted(
        merged.values(), key=lambda e: (-e.get("hits", 0), e["fp"])
    )[:_MANIFEST_MAX]
    from kolibrie_tpu_torch.optimizer.stats_advisor import stats_advisor

    payload = json.dumps(
        {
            "version": 1,
            "templates": ranked,
            # learned per-template cardinalities ride the same manifest:
            # a restarted replica (or a follower bootstrapping from
            # snapshot) starts with tuned routing instead of re-learning
            "stats_advisor": stats_advisor.export_state(),
        }
    ).encode()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _atomic_write_bytes(path, payload)
    except OSError:
        return None  # manifest persistence is advisory: it only costs warmth
    return path


def _atomic_write_bytes(path: str, payload: bytes) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as fh:
        fh.write(payload)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def load_manifest(root: Optional[str] = None) -> List[dict]:
    path = manifest_path(root)
    if path is None or not os.path.isfile(path):
        return []
    try:
        with open(path, "rb") as f:
            doc = json.loads(f.read().decode("utf-8"))
    except (OSError, ValueError):
        return []  # torn/corrupt manifest only costs warmth
    out = []
    for e in doc.get("templates", []):
        if isinstance(e, dict) and isinstance(e.get("query"), str):
            out.append(e)
    return out


def load_advisor_state(root: Optional[str] = None) -> int:
    """Import the manifest's ``stats_advisor`` section into the
    process-wide advisor; returns templates imported.  Corruption at any
    level (file, JSON, section, entry) degrades to the static AGM model
    — the section is advisory, exactly like the template list."""
    path = manifest_path(root)
    if path is None or not os.path.isfile(path):
        return 0
    try:
        with open(path, "rb") as f:
            doc = json.loads(f.read().decode("utf-8"))
    except (OSError, ValueError):
        return 0
    if not isinstance(doc, dict):
        return 0
    from kolibrie_tpu_torch.optimizer.stats_advisor import stats_advisor

    return stats_advisor.import_state(doc.get("stats_advisor"))
