"""Rule family 31x: static race detection.

Built on :mod:`analysis.threads` (which thread roots can execute each
function) and :mod:`analysis.dataflow` (which locks are held at each
statement, from ``with`` scopes and ``# kolint: holds[...]`` claims).
For every instance attribute / module global written outside
``__init__`` and visible from ≥2 thread roots, intersect the lock sets
over all access sites:

KL311  empty intersection and NO site holds any lock — an unguarded
       shared write
KL312  empty intersection but SOME sites hold a lock — an inconsistent
       guard (the unlocked sites race with the locked ones; this also
       catches "lock released too early" shapes, where one access in a
       method sits just outside the ``with`` block)

Exemptions (the atomic idioms):

- synchronization objects themselves (``Lock``/``Event``/``Queue``/…
  assigned in the class) — they exist to be shared;
- state only written in ``__init__`` — immutable-after-construction;
- state annotated ``# guarded by:`` — KL301 already enforces every
  access lexically, and the runtime sanitizer re-checks it under
  ``KOLIBRIE_DEBUG_LOCKS=1``; double-reporting here would force double
  suppressions.

NOT exempt: append-only lists and counter ``+=`` — GIL-atomic today is
an implementation detail, and ``+=`` is a read-modify-write that drops
increments under contention.  Those need a named lock or a
``# kolint: ignore[KL311] reason`` that argues the idiom.

Blind spots (documented in docs/ANALYSIS.md): accesses from OTHER
classes (``handler.core.field``), fields on objects passed across
threads, and ``lock.acquire()`` without a ``with`` (use ``holds[...]``).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from kolibrie_tpu_torch.analysis.core import Finding, rule
from kolibrie_tpu_torch.analysis.dataflow import locks_at
from kolibrie_tpu_torch.analysis.project import (
    FuncInfo,
    Project,
    SourceFile,
    iter_own_nodes,
    terminal_name,
)
from kolibrie_tpu_torch.analysis.threads import ThreadModel

# Constructors whose instances are MEANT to be shared across threads.
_SYNC_CTORS = {
    "Lock", "RLock", "Condition", "Event", "Semaphore",
    "BoundedSemaphore", "Barrier", "local",
    "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue",
    "ThreadPoolExecutor",
}

# Container methods that mutate the receiver in place.
_MUTATORS = {
    "append", "extend", "insert", "remove", "discard", "add",
    "pop", "popleft", "appendleft", "clear", "update", "setdefault",
    "sort", "reverse",
}

_EXEMPT_METHODS = {"__init__", "__del__", "__post_init__"}

# `with` scopes that are not mutual exclusion (spans, trace scopes,
# files, fault plans) must not count as guards: a name is lock-like
# when it says so, or when an annotation/holds[] claim names it.
_LOCKISH_SUBSTRINGS = ("lock", "mutex", "cond", "_cv", "sem")


def _lock_filter(project: Project):
    annotated: Set[str] = set()
    for f in project.files:
        for g in f.guarded:
            annotated.add(g.lock.split(".")[-1])
        for info in f.functions.values():
            for h in info.holds_locks:
                annotated.add(h.split(".")[-1])

    def keep(name: str) -> bool:
        low = name.lower()
        return name in annotated or any(
            s in low for s in _LOCKISH_SUBSTRINGS
        )

    return keep


@dataclass
class _Site:
    func: FuncInfo
    line: int
    is_write: bool
    locks: FrozenSet[str]
    roots: FrozenSet[str]


def _thread_model(project: Project) -> ThreadModel:
    model = getattr(project, "_kolint_thread_model", None)
    if model is None:
        model = ThreadModel(project)
        project._kolint_thread_model = model
    return model


def _sync_attrs(f: SourceFile, class_name: Optional[str]) -> Set[str]:
    """Attributes of ``class_name`` (or module globals when None) that
    hold synchronization objects or thread handles."""
    out: Set[str] = set()
    if class_name is None:
        for node in f.tree.body:
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                if terminal_name(node.value.func) in _SYNC_CTORS:
                    for t in node.targets:
                        n = terminal_name(t)
                        if n:
                            out.add(n)
        return out
    for info in f.functions.values():
        if info.class_name != class_name:
            continue
        for node in iter_own_nodes(info.node):
            if not isinstance(node, ast.Assign):
                continue
            if not (
                isinstance(node.value, ast.Call)
                and terminal_name(node.value.func) in _SYNC_CTORS
            ):
                continue
            for t in node.targets:
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    out.add(t.attr)
    return out


def _self_attr(node: ast.AST) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _collect_attr_sites(
    f: SourceFile, model: ThreadModel, keep
) -> Dict[Tuple[str, str], List[_Site]]:
    """(class_name, attr) → access sites across the class's methods."""
    sites: Dict[Tuple[str, str], List[_Site]] = {}
    for info in f.functions.values():
        if info.class_name is None:
            continue
        meth = info.qualname.rsplit(".", 1)[-1]
        if meth in _EXEMPT_METHODS:
            continue
        roots = frozenset(model.roots_of(info.key))
        if not roots:
            continue  # not reachable from any thread — can't race
        for node in iter_own_nodes(info.node):
            attr: Optional[str] = None
            is_write = False
            anchor = node
            a = _self_attr(node)
            if a is not None:
                attr = a
                is_write = isinstance(node.ctx, (ast.Store, ast.Del))
            elif isinstance(node, ast.Subscript) and isinstance(
                node.ctx, (ast.Store, ast.Del)
            ):
                a = _self_attr(node.value)
                if a is None:
                    continue
                attr, is_write = a, True
            elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ) and node.func.attr in _MUTATORS:
                a = _self_attr(node.func.value)
                if a is None:
                    continue
                attr, is_write = a, True
            if attr is None:
                continue
            sites.setdefault((info.class_name, attr), []).append(
                _Site(
                    info,
                    anchor.lineno,
                    is_write,
                    frozenset(l for l in locks_at(info, anchor) if keep(l)),
                    roots,
                )
            )
    return sites


def _collect_global_sites(
    f: SourceFile, model: ThreadModel, keep
) -> Dict[str, List[_Site]]:
    """Module globals written via ``global`` from some function → their
    access sites across all functions in the module."""
    written: Set[str] = set()
    for info in f.functions.values():
        for node in iter_own_nodes(info.node):
            if isinstance(node, ast.Global):
                written.update(node.names)
    if not written:
        return {}
    sites: Dict[str, List[_Site]] = {}
    for info in f.functions.values():
        meth = info.qualname.rsplit(".", 1)[-1]
        if meth in _EXEMPT_METHODS:
            continue
        roots = frozenset(model.roots_of(info.key))
        if not roots:
            continue
        declared: Set[str] = set()
        for node in iter_own_nodes(info.node):
            if isinstance(node, ast.Global):
                declared.update(node.names)
        for node in iter_own_nodes(info.node):
            if not (isinstance(node, ast.Name) and node.id in written):
                continue
            is_write = (
                isinstance(node.ctx, (ast.Store, ast.Del))
                and node.id in declared
            )
            if isinstance(node.ctx, (ast.Store, ast.Del)) and not is_write:
                continue  # a local shadowing the global's name
            sites.setdefault(node.id, []).append(
                _Site(
                    info,
                    node.lineno,
                    is_write,
                    frozenset(l for l in locks_at(info, node) if keep(l)),
                    roots,
                )
            )
    return sites


def _judge(
    label: str,
    sites: List[_Site],
    model: ThreadModel,
    rel: str,
) -> List[Finding]:
    writes = [s for s in sites if s.is_write]
    if not writes:
        return []
    all_roots: Set[str] = set()
    for s in sites:
        all_roots |= s.roots
    if len(all_roots) < 2:
        return []
    common = frozenset.intersection(*(s.locks for s in sites))
    if common:
        return []
    unlocked = [s for s in sites if not s.locks]
    locked = [s for s in sites if s.locks]
    roots_desc = model.describe(all_roots)
    # anchor on a write when one is unlocked, else the first bare site
    anchor = next((s for s in unlocked if s.is_write), None) or (
        unlocked[0] if unlocked else writes[0]
    )
    if not locked:
        return [
            Finding(
                "KL311",
                rel,
                anchor.line,
                f"{label} is written with no lock held but is shared "
                f"across thread roots ({roots_desc}); guard every access "
                "with one named lock and annotate the field "
                "`# guarded by: <lock>`",
                scope=anchor.func.qualname,
            )
        ]
    held_names = sorted({l for s in locked for l in s.locks})
    return [
        Finding(
            "KL312",
            rel,
            anchor.line,
            f"{label} is guarded inconsistently: some accesses hold "
            f"{held_names} but {anchor.func.qualname}() touches it "
            f"lock-free (thread roots: {roots_desc}); hold the same lock "
            "at every access",
            scope=anchor.func.qualname,
        )
    ]


@rule(
    "KL311",
    "instance attribute or module global written from ≥2 thread roots "
    "with no lock held at any access site",
)
def unguarded_shared_write(project: Project) -> List[Finding]:
    return _race_findings(project, want="KL311")


@rule(
    "KL312",
    "shared state guarded at some access sites but accessed lock-free "
    "at others — the lock-set intersection across sites is empty",
)
def inconsistent_guard(project: Project) -> List[Finding]:
    return _race_findings(project, want="KL312")


def _race_findings(project: Project, want: str) -> List[Finding]:
    cached = getattr(project, "_kolint_race_findings", None)
    if cached is None:
        cached = _compute_races(project)
        project._kolint_race_findings = cached
    return [f for f in cached if f.rule == want]


def _compute_races(project: Project) -> List[Finding]:
    model = _thread_model(project)
    keep = _lock_filter(project)
    out: List[Finding] = []
    for f in project.files:
        if f.tree is None:
            continue
        annotated = {(g.class_name, g.attr) for g in f.guarded}
        sync_cache: Dict[Optional[str], Set[str]] = {}

        def sync_attrs(cls: Optional[str]) -> Set[str]:
            if cls not in sync_cache:
                sync_cache[cls] = _sync_attrs(f, cls)
            return sync_cache[cls]

        for (cls, attr), sites in sorted(
            _collect_attr_sites(f, model, keep).items()
        ):
            if f"{f.rel}::{cls}" in model.per_request_classes:
                # per-request handler instances never outlive their
                # thread; their self.* is thread-confined (state shared
                # via self.server/self.core is a cross-class blind spot)
                continue
            if (cls, attr) in annotated:
                continue  # KL301 + the runtime sanitizer own this field
            if attr in sync_attrs(cls):
                continue
            out.extend(_judge(f"self.{attr}", sites, model, f.rel))
        for name, sites in sorted(
            _collect_global_sites(f, model, keep).items()
        ):
            if (None, name) in annotated:
                continue
            if name in sync_attrs(None):
                continue
            out.extend(_judge(f"module global {name!r}", sites, model, f.rel))
    return out
