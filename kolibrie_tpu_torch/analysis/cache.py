"""kolint result cache + parallel rule execution.

kolint's engine is INTERPROCEDURAL — thread roots, call-graph
reachability, and taint summaries cross file boundaries — so a
classic per-file cache (reuse file X's findings because X didn't
change) is unsound: adding one ``Thread(target=…)`` in module A can
create race findings in module B.  The cache is therefore keyed on the
*project signature* (the multiset of every linted file's content hash
plus a hash of the analysis engine itself) with one entry per RULE:

    .kolint_cache/torch/<sig>/<rule>.json

Any edit anywhere moves the signature and cold-starts every rule —
correct by construction.  What the layout buys:

- repeated runs over an unchanged tree are near-free (lint.sh runs
  kolint three times: the main gate plus two standalone rule-family
  passes; passes two and three hit the entries pass one wrote);
- ``--changed-only`` diffs the per-file digest manifest
  (``.kolint_cache/torch/files.json``) from the previous run and reports
  only findings anchored in files that changed — the ANALYSIS still
  covers the whole project (soundness), only the report is focused.

Parallelism: rules are pure functions of the :class:`Project`, so cold
rules fan out over a fork-based process pool.  Workers inherit the
parsed project copy-on-write (the pool is created AFTER parsing), and
rules that share memoized project state (taint summaries for KL11x,
the thread model and race sites for KL31x) are bucketed into the same
worker so the shared work is done once per family, not once per rule.
Platforms without ``fork`` fall back to in-process execution.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import shutil
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# under ``torch/`` so that this linter's manifest and the JAX package's
# linter's (``.kolint_cache/files.json``) never overwrite each other
CACHE_DIRNAME = os.path.join(".kolint_cache", "torch")
_MANIFEST = "files.json"
_KEEP_SIGNATURES = 4  # GC horizon: current + a few recent branches

_engine_hash: Optional[str] = None


def cache_root(repo_root: str) -> str:
    return os.path.join(repo_root, CACHE_DIRNAME)


def engine_hash() -> str:
    """Hash of the analysis package's own sources — a rule edit must
    invalidate results computed by the old rule."""
    global _engine_hash
    if _engine_hash is None:
        pkg = os.path.dirname(os.path.abspath(__file__))
        h = hashlib.sha256()
        for name in sorted(os.listdir(pkg)):
            if not name.endswith(".py"):
                continue
            with open(os.path.join(pkg, name), "rb") as fh:
                h.update(name.encode())
                h.update(fh.read())
        _engine_hash = h.hexdigest()
    return _engine_hash


def file_digests(files) -> Dict[str, str]:
    """rel path → content sha256 for loaded :class:`SourceFile`\\ s."""
    return {
        f.rel: hashlib.sha256(f.text.encode("utf-8")).hexdigest()
        for f in files
    }


def project_signature(files) -> str:
    h = hashlib.sha256(engine_hash().encode())
    for rel, dig in sorted(file_digests(files).items()):
        h.update(rel.encode())
        h.update(dig.encode())
    return h.hexdigest()[:24]


# ------------------------------------------------------------ rule entries


def _rule_path(repo_root: str, sig: str, rule_id: str) -> str:
    return os.path.join(cache_root(repo_root), sig, f"{rule_id}.json")


def get_rule(repo_root: str, sig: str, rule_id: str) -> Optional[List[dict]]:
    path = _rule_path(repo_root, sig, rule_id)
    try:
        with open(path, "r", encoding="utf-8") as fh:
            return json.load(fh)["findings"]
    except (OSError, ValueError, KeyError):
        return None


def put_rule(
    repo_root: str, sig: str, rule_id: str, findings: List[dict]
) -> None:
    path = _rule_path(repo_root, sig, rule_id)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump({"findings": findings}, fh)
        os.replace(tmp, path)
    except OSError:
        pass  # a cache that can't write is just a slow cache


def gc(repo_root: str, keep_sig: str) -> None:
    """Drop signature dirs beyond the newest few — every edit mints a
    new signature, so the cache would otherwise grow per keystroke."""
    root = cache_root(repo_root)
    try:
        dirs = [
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)) and d != keep_sig
        ]
    except OSError:
        return
    dirs.sort(
        key=lambda d: os.path.getmtime(os.path.join(root, d)), reverse=True
    )
    for d in dirs[_KEEP_SIGNATURES - 1:]:
        shutil.rmtree(os.path.join(root, d), ignore_errors=True)


# --------------------------------------------------------- change tracking


def load_manifest(repo_root: str) -> Dict[str, str]:
    try:
        with open(
            os.path.join(cache_root(repo_root), _MANIFEST),
            "r", encoding="utf-8",
        ) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return {}


def write_manifest(repo_root: str, digests: Dict[str, str]) -> None:
    root = cache_root(repo_root)
    try:
        os.makedirs(root, exist_ok=True)
        tmp = os.path.join(root, _MANIFEST + ".tmp")
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(digests, fh, indent=0, sort_keys=True)
        os.replace(tmp, os.path.join(root, _MANIFEST))
    except OSError:
        pass


def changed_files(repo_root: str, files) -> Set[str]:
    """Files whose content differs from the previous run's manifest
    (new files count as changed; with no manifest, everything does)."""
    prev = load_manifest(repo_root)
    return {
        rel for rel, dig in file_digests(files).items()
        if prev.get(rel) != dig
    }


# ------------------------------------------------------- parallel execution

# Fork-inherited project for pool workers; set immediately before the
# pool is created so children see the fully-parsed state copy-on-write.
_WORKER_PROJECT = None


def _run_bucket(rule_ids: Sequence[str]) -> List[Tuple[str, List[dict]]]:
    from kolibrie_tpu_torch.analysis.core import RULES

    out: List[Tuple[str, List[dict]]] = []
    for rid in rule_ids:
        _, fn = RULES[rid]
        out.append((rid, [f.to_dict() for f in fn(_WORKER_PROJECT)]))
    return out


def bucket_rules(rule_ids: Iterable[str]) -> List[List[str]]:
    """Group rules so families that share memoized project state land
    in one worker (KL111+KL112 share taint summaries, KL311+KL312 the
    thread model and race sites)."""
    fams: Dict[str, List[str]] = {}
    for rid in sorted(rule_ids):
        fams.setdefault(rid[:4], []).append(rid)
    return [fams[k] for k in sorted(fams)]


def run_rules(
    project, rule_ids: Sequence[str], jobs: int = 1
) -> Dict[str, List[dict]]:
    """Run ``rule_ids`` against ``project``, fanning family buckets over
    ``jobs`` fork-pool workers when possible.  → rule id → finding
    dicts (same shape as ``Finding.to_dict``)."""
    global _WORKER_PROJECT
    buckets = bucket_rules(rule_ids)
    use_pool = (
        jobs > 1
        and len(buckets) > 1
        and "fork" in multiprocessing.get_all_start_methods()
    )
    out: Dict[str, List[dict]] = {}
    _WORKER_PROJECT = project
    if not use_pool:
        try:
            for bucket in buckets:
                for rid, dicts in _run_bucket(bucket):
                    out[rid] = dicts
        finally:
            _WORKER_PROJECT = None
        return out
    try:
        ctx = multiprocessing.get_context("fork")
        with ctx.Pool(processes=min(jobs, len(buckets))) as pool:
            for res in pool.map(_run_bucket, buckets):
                for rid, dicts in res:
                    out[rid] = dicts
    finally:
        _WORKER_PROJECT = None
    return out
