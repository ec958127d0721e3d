"""Rule family 4: trace/deadline context propagation across thread hops.

Thread-locals do not cross ``threading.Thread`` / executor ``submit``
boundaries.  The repo's pattern (documented in obs/spans.py) is
capture-at-submit (``current_trace_id()`` / ``current_deadline()``) and
re-enter-on-dispatch (``trace_scope`` / ``deadline_scope``).

KL401  a Thread/submit target transitively calls span- or
       deadline-aware code, and NEITHER the submitting function captures
       context NOR the target's reachable code re-enters a scope —
       spans land in orphan traces and deadlines silently stop applying.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from kolibrie_tpu_torch.analysis.core import Finding, rule
from kolibrie_tpu_torch.analysis.project import (
    FuncInfo,
    Project,
    iter_own_nodes,
    terminal_name,
)

# (imported-from module, name) pairs; matched on the local alias too.
_AWARE = {"span", "_obs_span", "check_deadline", "current_deadline",
          "remaining_s"}
_REENTER = {"trace_scope", "deadline_scope"}
_CAPTURE = {"current_trace_id", "current_deadline"} | _REENTER


def _called_names(info: FuncInfo) -> Set[str]:
    out: Set[str] = set()
    for node in iter_own_nodes(info.node):
        if isinstance(node, ast.Call):
            t = terminal_name(node.func)
            if t:
                out.add(t)
    return out


@rule(
    "KL401",
    "Thread/executor target transitively calls span- or deadline-aware "
    "code without the capture-at-submit / re-enter-on-dispatch pattern",
)
def context_across_threads(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for f in project.files:
        if f.tree is None:
            continue
        for info in f.functions.values():
            for node in iter_own_nodes(info.node):
                if not isinstance(node, ast.Call):
                    continue
                target = _submission_target(project, f, info, node)
                if target is None:
                    continue
                reach = project.reachable_from(target)
                called = set()
                for r in reach:
                    called |= _called_names(r)
                if not (called & _AWARE):
                    continue  # target never touches span/deadline code
                if called & _REENTER:
                    continue  # re-enter-on-dispatch present
                if _called_names(info) & _CAPTURE:
                    continue  # capture-at-submit present
                out.append(
                    Finding(
                        "KL401",
                        f.rel,
                        node.lineno,
                        f"thread target {target.qualname}() reaches span/"
                        "deadline-aware code but no trace_scope/"
                        "deadline_scope is re-entered and the submitter "
                        "captures no context; capture current_trace_id()/"
                        "current_deadline() at submit and re-enter on the "
                        "worker (see obs/spans.py)",
                        scope=info.qualname,
                    )
                )
    return out


def _submission_target(
    project: Project, f, info: FuncInfo, call: ast.Call
) -> Optional[FuncInfo]:
    """Resolve Thread(target=X) / pool.submit(X, …) to a FuncInfo."""
    name = terminal_name(call.func)
    if name == "Thread":
        for kw in call.keywords:
            if kw.arg == "target":
                return project._resolve_callee(f, info, kw.value)
        return None
    if name == "submit" and isinstance(call.func, ast.Attribute):
        if call.args:
            return project._resolve_callee(f, info, call.args[0])
    return None
