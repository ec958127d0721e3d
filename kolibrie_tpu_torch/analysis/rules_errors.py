"""Rule family 6: error taxonomy discipline.

resilience/errors.py defines the KolibrieError taxonomy and its
convention: failures are either re-raised as taxonomy errors, converted
to an error response, or at minimum counted in the metrics registry.
A broad ``except Exception`` that does none of those erases the failure
— the query "succeeds", the operator sees nothing, and the degraded
mode never trips.

KL601  `except Exception:` / bare `except:` whose body neither
       re-raises, raises a taxonomy error, records an obs metric,
       logs, nor routes to an error response.
"""

from __future__ import annotations

import ast
from typing import List

from kolibrie_tpu_torch.analysis.core import Finding, rule
from kolibrie_tpu_torch.analysis.project import Project, iter_own_nodes, terminal_name, walk

# Call names that count as "the failure was surfaced somewhere".
_SURFACING_CALLS = {
    # obs metrics
    "inc", "observe", "set",
    # logging
    "debug", "info", "warning", "error", "exception", "critical", "log",
    "print",
    # http/error plumbing in frontends
    "error_response", "send_error", "_send_failure", "_fail", "record_error",
}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except
    if isinstance(t, (ast.Name, ast.Attribute)):
        return terminal_name(t) in ("Exception", "BaseException")
    if isinstance(t, ast.Tuple):
        return any(
            terminal_name(e) in ("Exception", "BaseException")
            for e in t.elts
        )
    return False


def _body_surfaces(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Return) and _mentions_exc(node, handler):
            return True
        if isinstance(node, ast.Assign) and _mentions_exc(node.value, handler):
            # `r.error = e`: stored for re-raise on another thread —
            # the async propagation pattern, not a swallow
            return True
        if isinstance(node, ast.Call):
            name = terminal_name(node.func)
            if name in _SURFACING_CALLS:
                return True
    return False


def _mentions_exc(node: ast.AST, handler: ast.ExceptHandler) -> bool:
    """``return error_payload(e)``-style returns surface the error."""
    if not handler.name:
        return False
    return any(
        isinstance(n, ast.Name) and n.id == handler.name
        for n in ast.walk(node)
    )


@rule(
    "KL601",
    "broad `except Exception` swallows the failure: no raise, no metric, "
    "no log, no error response — the taxonomy (resilience/errors.py) "
    "never sees it",
)
def swallowed_exception(project: Project) -> List[Finding]:
    out: List[Finding] = []

    def check(nodes, rel: str, scope: str) -> None:
        for node in nodes:
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad(node) or _body_surfaces(node):
                continue
            out.append(
                Finding(
                    "KL601",
                    rel,
                    node.lineno,
                    "broad except swallows the error; re-raise a "
                    "KolibrieError, count it (obs counter), or log it "
                    "— silent pass hides real failures",
                    scope=scope,
                )
            )

    for f in project.files:
        if f.tree is None:
            continue
        for info in f.functions.values():
            check(walk(info.node), f.rel, info.qualname)
        # module-level handlers (import guards etc.) — iter_own_nodes on
        # the Module skips function/class bodies already covered above
        check(iter_own_nodes(f.tree), f.rel, "<module>")
    return out
