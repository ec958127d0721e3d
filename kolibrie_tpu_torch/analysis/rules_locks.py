"""Rule family 3: lock discipline.

The contract is the ``# guarded by: <lock>`` annotation on mutable
state (module global or instance attribute, at its defining
assignment), in the style http_server's TemplateBatcher comments
introduced.  kolint then enforces, lexically within the defining
module/class:

KL301  annotated state read/written outside a ``with <lock>`` block
       (the defining ``__init__``/module assignment is exempt; a
       function whose def line carries ``# kolint: holds[<lock>]``
       asserts the caller-holds contract and is exempt for that lock)
KL302  lock-ordering cycle: ``with A: … with B:`` nesting edges across
       the analyzed set that form a cycle → deadlock candidate

Accesses from OTHER modules/classes (e.g. obs.export reading batcher
counters at scrape time) are invisible to a name-based checker; the
annotation still documents the contract for reviewers.  docs/ANALYSIS.md
spells out the blind spots.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from kolibrie_tpu_torch.analysis.core import Finding, rule
from kolibrie_tpu_torch.analysis.project import Project, terminal_name


def _lock_terminal(lock_spec: str) -> str:
    """'self.lock' → 'lock'; '_ring_lock' → '_ring_lock'."""
    return lock_spec.split(".")[-1]


def _with_locks_held(path: List[ast.AST]) -> Set[str]:
    """Terminal lock names held at a node, given its ancestor chain.
    Covers ``with X:``, ``with X, Y:`` and ``X.acquire()``-style guards
    are NOT modeled (use # kolint: holds[...] for those)."""
    held: Set[str] = set()
    for node in path:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                t = terminal_name(item.context_expr)
                if t:
                    held.add(t)
                # dispatch_lock.acquire(blocking=False) has no with-form;
                # `with lock_fn():`-style helpers resolve by call name
                if isinstance(item.context_expr, ast.Call):
                    t2 = terminal_name(item.context_expr.func)
                    if t2:
                        held.add(t2)
    return held


def _walk_with_path(root: ast.AST):
    """Yield (node, ancestors) pairs, not descending into nested defs."""

    def rec(node: ast.AST, path: List[ast.AST]):
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda),
            ):
                continue
            yield child, path
            yield from rec(child, path + [child])

    yield from rec(root, [])


@rule(
    "KL301",
    "state annotated `# guarded by: <lock>` accessed outside a "
    "`with <lock>` block in its defining module/class",
)
def guarded_state_access(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for f in project.files:
        if f.tree is None or not f.guarded:
            continue
        # (class_name, attr) → lock terminal;  module globals: (None, name)
        guards: Dict[Tuple[Optional[str], str], str] = {}
        for g in f.guarded:
            guards[(g.class_name, g.attr)] = _lock_terminal(g.lock)
        for info in f.functions.values():
            fname = info.qualname.split(".")[-1]
            if fname == "__init__":
                continue  # construction precedes sharing
            for node, path in _walk_with_path(info.node):
                key = None
                accessed = ""
                if isinstance(node, ast.Attribute) and isinstance(
                    node.value, ast.Name
                ) and node.value.id == "self":
                    key = (info.class_name, node.attr)
                    accessed = f"self.{node.attr}"
                elif isinstance(node, ast.Name):
                    key = (None, node.id)
                    accessed = node.id
                if key is None or key not in guards:
                    continue
                lock = guards[key]
                if lock in info.holds_locks:
                    continue
                held = _with_locks_held(path + [node])
                if lock in held:
                    continue
                # writes at module scope / reads of the defining stmt are
                # not reached here (functions only)
                out.append(
                    Finding(
                        "KL301",
                        f.rel,
                        node.lineno,
                        f"{accessed} is `# guarded by: {lock}` but accessed "
                        f"without `with {lock}` (add the lock, or mark the "
                        f"function `# kolint: holds[{lock}]` if the caller "
                        "holds it)",
                        scope=info.qualname,
                    )
                )
    return out


@rule(
    "KL302",
    "lock-ordering cycle: nested `with` acquisitions form a cycle "
    "across the analyzed files — deadlock candidate",
)
def lock_ordering_cycle(project: Project) -> List[Finding]:
    # Locks are identified by terminal attribute name; names that never
    # look like locks (no 'lock' substring and not annotated) are skipped.
    annotated = {
        _lock_terminal(g.lock) for f in project.files for g in f.guarded
    }

    def is_lock_name(name: Optional[str]) -> bool:
        return bool(name) and ("lock" in name.lower() or name in annotated)

    edges: Dict[str, Set[str]] = {}
    sites: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
    for f in project.files:
        if f.tree is None:
            continue
        for info in f.functions.values():
            outer_stack: List[str] = list(
                l for l in info.holds_locks if is_lock_name(l)
            )
            for node, path in _walk_with_path(info.node):
                if not isinstance(node, (ast.With, ast.AsyncWith)):
                    continue
                held = set(outer_stack) | {
                    h for h in _with_locks_held(path) if is_lock_name(h)
                }
                for item in node.items:
                    t = terminal_name(item.context_expr)
                    if not is_lock_name(t):
                        continue
                    for h in held:
                        if h != t:
                            edges.setdefault(h, set()).add(t)
                            sites.setdefault(
                                (h, t), (f.rel, node.lineno, info.qualname)
                            )
    # cycle detection (DFS, 3-color)
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {n: WHITE for n in set(edges) | {v for vs in edges.values() for v in vs}}
    out: List[Finding] = []
    reported: Set[frozenset] = set()

    def dfs(n: str, stack: List[str]):
        color[n] = GRAY
        for m in sorted(edges.get(n, ())):
            if color[m] == GRAY:
                cyc = stack[stack.index(m):] + [m] if m in stack else [n, m]
                key = frozenset(cyc)
                if key not in reported:
                    reported.add(key)
                    edge = sites.get((n, m)) or sites.get((m, n))
                    rel, line, scope = edge if edge else ("", 1, "")
                    out.append(
                        Finding(
                            "KL302",
                            rel,
                            line,
                            "lock-ordering cycle: "
                            + " -> ".join(cyc)
                            + " (acquire these locks in one global order)",
                            scope=scope,
                        )
                    )
            elif color[m] == WHITE:
                dfs(m, stack + [m])
        color[n] = BLACK

    for n in sorted(color):
        if color[n] == WHITE:
            dfs(n, [n])
    return out
