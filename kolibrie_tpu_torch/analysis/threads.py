"""Thread-root inference for kolint's race rules.

A *thread root* is a function that some thread starts executing at —
everything reachable from it (via the project call graph) runs on that
thread.  Roots recognized:

- ``threading.Thread(target=fn)`` / ``Thread(target=self._run)``
  (positional form ``Thread(None, fn)`` too) → ``thread:`` root
- ``executor.submit(fn, …)`` / ``pool.submit`` → ``submit:`` root
- ``threading.Timer(interval, fn)`` → ``timer:`` root
- ``_thread.start_new_thread(fn, …)`` → ``thread:`` root
- ``run()`` methods of classes whose bases mention ``Thread`` →
  ``run:`` root
- ``do_GET``/``do_POST``/… handler methods (the ThreadingHTTPServer /
  ``make_server`` pool calls these from per-request threads) →
  ``handler:`` root
- one synthetic ``caller:`` root per class that spawns any of the
  above (seeded from its public methods), and per module with
  module-level spawns (seeded from public functions).  This models the
  *application* thread calling ``start()/stats()/stop()`` concurrently
  with the daemon — the pairing that makes ``stats()``-read vs
  loop-write races visible at all.

``roots_of(func_key)`` answers "which threads can be executing this
function"; a field written from ≥2 distinct roots is shared state.
Functions reachable from no root (``__init__``-only helpers, dead
code) get no roots and are never charged with a race.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from kolibrie_tpu_torch.analysis.project import (
    FuncInfo,
    Project,
    SourceFile,
    iter_own_nodes,
    terminal_name,
    walk,
)

_HANDLER_RE = re.compile(r"^do_[A-Z]+$")

# Callables that take the new thread's entry point as an argument.
_SPAWN_TERMINALS = {"Thread", "Timer", "start_new_thread"}


@dataclass
class ThreadRoot:
    rid: str  # stable id, e.g. "thread:obs/flightrec.py::FlightRecorder._run"
    kind: str  # thread | submit | timer | run | handler | caller
    entry: FuncInfo
    spawned_at: Optional[int] = None  # line of the spawn site, if any


class ThreadModel:
    """All inferred roots for a project + per-function attribution."""

    def __init__(self, project: Project):
        self.project = project
        self.roots: List[ThreadRoot] = []
        # handler classes are instantiated PER REQUEST by the server —
        # their instance attributes are thread-confined by construction
        self.per_request_classes: Set[str] = set()  # "rel::Class"
        # class/module spawn sites feeding the synthetic caller roots
        self._spawning_classes: Set[str] = set()  # "rel::Class"
        self._spawning_modules: Set[str] = set()  # rel
        self._collect_explicit_roots()
        self._collect_caller_roots()
        self._roots_of: Dict[str, Set[str]] = {}
        self._attribute()

    # ------------------------------------------------------------- explicit

    def _target_of_spawn(
        self, f: SourceFile, info: FuncInfo, call: ast.Call
    ) -> Optional[FuncInfo]:
        name = terminal_name(call.func)
        if name == "Thread" or name == "start_new_thread":
            for kw in call.keywords:
                if kw.arg == "target":
                    return self.project._resolve_callee(f, info, kw.value)
            # Thread(group, target, …) / start_new_thread(fn, args)
            pos = 1 if name == "Thread" else 0
            if len(call.args) > pos:
                return self.project._resolve_callee(f, info, call.args[pos])
            return None
        if name == "Timer":
            for kw in call.keywords:
                if kw.arg == "function":
                    return self.project._resolve_callee(f, info, kw.value)
            if len(call.args) > 1:
                return self.project._resolve_callee(f, info, call.args[1])
            return None
        return None

    def _note_spawn_scope(self, info: FuncInfo) -> None:
        if info.class_name:
            self._spawning_classes.add(f"{info.module.rel}::{info.class_name}")
        else:
            self._spawning_modules.add(info.module.rel)

    def _collect_explicit_roots(self) -> None:
        seen: Set[str] = set()

        def add(kind: str, entry: FuncInfo, line: Optional[int]) -> None:
            rid = f"{kind}:{entry.key}"
            if rid in seen:
                return
            seen.add(rid)
            self.roots.append(ThreadRoot(rid, kind, entry, line))

        for f in self.project.files:
            if f.tree is None:
                continue
            # Thread-subclass run() methods and HTTP handler methods
            for node in walk(f.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                base_names = {
                    terminal_name(b) for b in node.bases
                } - {None}
                is_thread_cls = any(
                    b and "Thread" in b for b in base_names
                )
                is_handler_cls = any(
                    b and "Handler" in b for b in base_names
                )
                if is_handler_cls:
                    self.per_request_classes.add(f"{f.rel}::{node.name}")
                for qual, info in f.functions.items():
                    if info.class_name != node.name:
                        continue
                    meth = qual.rsplit(".", 1)[-1]
                    if is_thread_cls and meth == "run":
                        add("run", info, info.node.lineno)
                        self._spawning_classes.add(
                            f"{f.rel}::{node.name}"
                        )
                    if is_handler_cls and _HANDLER_RE.match(meth):
                        add("handler", info, info.node.lineno)
            # spawn calls inside function bodies
            for info in f.functions.values():
                for node in iter_own_nodes(info.node):
                    if not isinstance(node, ast.Call):
                        continue
                    name = terminal_name(node.func)
                    if name in _SPAWN_TERMINALS:
                        target = self._target_of_spawn(f, info, node)
                        self._note_spawn_scope(info)
                        if target is not None:
                            kind = "timer" if name == "Timer" else "thread"
                            add(kind, target, node.lineno)
                    elif (
                        isinstance(node.func, ast.Attribute)
                        and node.func.attr == "submit"
                        and node.args
                    ):
                        target = self.project._resolve_callee(
                            f, info, node.args[0]
                        )
                        self._note_spawn_scope(info)
                        if target is not None:
                            add("submit", target, node.lineno)

    # --------------------------------------------------------------- caller

    def _collect_caller_roots(self) -> None:
        """One synthetic root per spawning class/module, seeded from its
        public entry points — the application thread's view."""
        for f in self.project.files:
            if f.tree is None:
                continue
            mod_spawns = f.rel in self._spawning_modules
            for info in f.functions.values():
                name = info.qualname.rsplit(".", 1)[-1]
                if name.startswith("_"):
                    continue
                if "." in info.qualname and info.class_name is None:
                    continue  # nested def, not a public entry point
                if info.class_name:
                    if info.qualname.count(".") != 1:
                        continue  # nested def inside a method
                    ckey = f"{f.rel}::{info.class_name}"
                    if ckey not in self._spawning_classes:
                        continue
                    rid = f"caller:{ckey}"
                elif mod_spawns:
                    rid = f"caller:{f.rel}"
                else:
                    continue
                # all public entries of one scope share ONE caller root
                self.roots.append(ThreadRoot(rid, "caller", info))

    # ---------------------------------------------------------- attribution

    def _attribute(self) -> None:
        for root in self.roots:
            for info in self.project.reachable_from(root.entry):
                self._roots_of.setdefault(info.key, set()).add(root.rid)

    def roots_of(self, func_key: str) -> Set[str]:
        """The thread roots that can be executing ``func_key``."""
        return self._roots_of.get(func_key, set())

    def describe(self, rids: Set[str], limit: int = 3) -> str:
        """Stable human-readable summary of a root set for messages."""
        names = sorted(r.split("::")[-1] + " [" + r.split(":", 1)[0] + "]"
                       for r in rids)
        if len(names) > limit:
            names = names[:limit] + [f"+{len(rids) - limit} more"]
        return ", ".join(names)
