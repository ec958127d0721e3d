"""Rule family 5: observability hygiene.

obs/metrics.py's registry enforces no cardinality bound — call sites
must (its own docstring says so).  The repo's conventions: route labels
are clamped to a known set before labeling, template fingerprints are
bounded by the plan cache upstream, and spans are only opened through
``with span(…)`` so every open has a scope exit.

KL501  metric label value not provably drawn from a bounded set
       (f-string / format / dict lookup / subscript as a label value)
KL502  span(…) opened without a `with` scope — the span never exits,
       never lands in the ring, and corrupts the parent stack
KL504  bare print() in library code — diagnostics belong in the
       structured logger (obs/log.py) where they carry level, component
       and trace id; user-facing output must name its stream with an
       explicit ``file=`` argument.  ``__main__.py`` modules, code under
       an ``if __name__ == "__main__"`` guard, and tests are exempt.
"""

from __future__ import annotations

import ast
import os
from typing import List

from kolibrie_tpu_torch.analysis.core import Finding, rule
from kolibrie_tpu_torch.analysis.project import (
    Project,
    iter_own_nodes,
    terminal_name,
    walk,
)

def _label_value_ok(expr: ast.AST) -> bool:
    """Conservatively bounded label expressions: literals, plain names/
    attributes (assumed clamped upstream — the rule targets *syntactic*
    unboundedness), str()/int() of those, `x or "fallback"`, and
    conditional picks between bounded branches."""
    if isinstance(expr, (ast.Constant, ast.Name, ast.Attribute)):
        return True
    if isinstance(expr, ast.IfExp):
        return _label_value_ok(expr.body) and _label_value_ok(expr.orelse)
    if isinstance(expr, ast.BoolOp):
        return all(_label_value_ok(v) for v in expr.values)
    if isinstance(expr, ast.Call):
        fn = terminal_name(expr.func)
        if fn in ("str", "int") and len(expr.args) == 1:
            return _label_value_ok(expr.args[0])
    return False


@rule(
    "KL501",
    "metric label value not provably bounded (f-string/format/"
    "subscript/dict-get as a .labels() argument mints unbounded series)",
)
def unbounded_label(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for f in project.files:
        if f.tree is None:
            continue
        for info in f.functions.values():
            for node in iter_own_nodes(info.node):
                if not (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "labels"
                ):
                    continue
                for arg in node.args:
                    if not _label_value_ok(arg):
                        out.append(
                            Finding(
                                "KL501",
                                f.rel,
                                node.lineno,
                                "label value is a computed string "
                                "(f-string/format/lookup); clamp it to a "
                                "bounded set first (route-clamp pattern, "
                                "frontends/http_server.py do_POST)",
                                scope=info.qualname,
                            )
                        )
                        break
    return out


@rule(
    "KL502",
    "span(...) opened outside a `with` statement — no scope exit, the "
    "span never finishes and the parent stack leaks",
)
def span_without_scope(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for f in project.files:
        if f.tree is None:
            continue
        # `span` imported from obs.spans under any local alias
        # (executor uses `span as _obs_span`)
        span_aliases = {
            alias
            for alias, (mod, name) in f.imports.items()
            if name == "span" and "spans" in mod
        }
        if not span_aliases:
            continue
        for info in f.functions.values():
            parents = {}
            for node in iter_own_nodes(info.node):
                for child in ast.iter_child_nodes(node):
                    parents[child] = node
            for node in iter_own_nodes(info.node):
                if not (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id in span_aliases
                ):
                    continue
                p = parents.get(node)
                if isinstance(p, ast.withitem):
                    continue
                out.append(
                    Finding(
                        "KL502",
                        f.rel,
                        node.lineno,
                        f"{node.func.id}(…) called outside `with`; use "
                        "`with span(name):` so the scope always exits",
                        scope=info.qualname,
                    )
                )
    return out


# ------------------------------------------------------------------ KL503

_METRIC_CTORS = {"counter", "gauge", "histogram"}
_METRIC_METHODS = {"inc", "dec", "set", "observe", "labels"}


def _metric_family_names(f) -> set:
    """Module-level names bound to obs.metrics family constructors:
    ``_LAT = metrics.histogram(…)`` / ``_REQS = counter(…)`` (under any
    import alias of the metrics module or its constructors)."""
    if f.tree is None:
        return set()
    metric_mods = {
        alias
        for alias, mod in f.module_aliases.items()
        if mod.endswith("obs.metrics")
    } | {
        alias
        for alias, (mod, name) in f.imports.items()
        if name == "metrics" and "obs" in mod
    }
    fams = set()
    for node in f.tree.body:
        if not (
            isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Call)
        ):
            continue
        fn = node.value.func
        ok = False
        if isinstance(fn, ast.Name):
            mod, orig = f.imports.get(fn.id, (None, None))
            ok = orig in _METRIC_CTORS and "metrics" in (mod or "")
        elif isinstance(fn, ast.Attribute) and isinstance(
            fn.value, ast.Name
        ):
            ok = fn.attr in _METRIC_CTORS and fn.value.id in metric_mods
        if ok:
            fams.update(
                t.id for t in node.targets if isinstance(t, ast.Name)
            )
    return fams


def _chain_base_name(expr: ast.AST):
    """``FAM.labels(x).inc`` → "FAM": peel attribute/call chains down to
    the root name."""
    while True:
        if isinstance(expr, ast.Call):
            expr = expr.func
        elif isinstance(expr, ast.Attribute):
            expr = expr.value
        elif isinstance(expr, ast.Name):
            return expr.id
        else:
            return None


# ------------------------------------------------------------------ KL504


def _main_guard_ranges(tree: ast.Module) -> List[tuple]:
    """Line spans of ``if __name__ == "__main__":`` blocks — script
    bodies are CLI territory, prints there are the interface."""
    out = []
    for node in walk(tree):
        if not isinstance(node, ast.If):
            continue
        t = node.test
        if (
            isinstance(t, ast.Compare)
            and isinstance(t.left, ast.Name)
            and t.left.id == "__name__"
        ):
            out.append((node.lineno, node.end_lineno or node.lineno))
    return out


def _kl504_exempt_file(rel: str) -> bool:
    base = os.path.basename(rel)
    if base == "__main__.py":  # CLI entry point by definition
        return True
    if base.startswith("test_") or base == "conftest.py":
        return True
    parts = rel.replace(os.sep, "/").split("/")
    return "tests" in parts


@rule(
    "KL504",
    "bare print() in library code — use the structured logger "
    "(obs/log.py) for diagnostics, or pass an explicit file= stream "
    "for user-facing output",
)
def bare_print(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for f in project.files:
        if f.tree is None or _kl504_exempt_file(f.rel):
            continue
        guards = _main_guard_ranges(f.tree)
        # innermost-enclosing-function index for the baseline scope key
        spans = sorted(
            (
                (info.node.lineno, info.node.end_lineno or info.node.lineno,
                 info.qualname)
                for info in f.functions.values()
                if hasattr(info.node, "lineno")
            ),
            key=lambda s: s[1] - s[0],
        )
        for node in walk(f.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "print"
            ):
                continue
            if any(kw.arg == "file" for kw in node.keywords):
                continue  # stream named explicitly → intentional output
            if any(lo <= node.lineno <= hi for lo, hi in guards):
                continue
            scope = next(
                (q for lo, hi, q in spans if lo <= node.lineno <= hi), ""
            )
            out.append(
                Finding(
                    "KL504",
                    f.rel,
                    node.lineno,
                    "bare print() in library code — diagnostics go through "
                    "obs.log.get_logger(component) (level + trace id + "
                    "tail ring); user-facing output must name its stream "
                    "(print(..., file=sys.stdout))",
                    scope=scope,
                )
            )
    return out


@rule(
    "KL503",
    "obs.metrics / obs.spans call inside jit-reachable code — it fires "
    "once at TRACE time, then never again for the cached executable",
)
def obs_call_in_jit(project: Project) -> List[Finding]:
    out: List[Finding] = []
    seen_files = {}
    for info in project.functions.values():
        if not info.jit_reachable:
            continue
        f = info.module
        if f.tree is None:
            continue
        if f.rel not in seen_files:
            span_aliases = {
                alias
                for alias, (mod, name) in f.imports.items()
                if name == "span" and "spans" in mod
            }
            seen_files[f.rel] = (span_aliases, _metric_family_names(f))
        span_aliases, fams = seen_files[f.rel]
        for node in iter_own_nodes(info.node):
            if not isinstance(node, ast.Call):
                continue
            if (
                isinstance(node.func, ast.Name)
                and node.func.id in span_aliases
            ):
                out.append(
                    Finding(
                        "KL503",
                        f.rel,
                        node.lineno,
                        f"{node.func.id}(…) opens a span inside "
                        "jit-reachable code: it times the TRACE, not the "
                        "dispatch, and vanishes once the executable "
                        "caches — span outside the jit boundary",
                        scope=info.qualname,
                    )
                )
                continue
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _METRIC_METHODS
                and _chain_base_name(node.func.value) in fams
            ):
                out.append(
                    Finding(
                        "KL503",
                        f.rel,
                        node.lineno,
                        f".{node.func.attr}() on metric family "
                        f"{_chain_base_name(node.func.value)!r} inside "
                        "jit-reachable code counts traces, not calls — "
                        "record the value outside the jit boundary (the "
                        "stats-vector pattern, optimizer/device_engine)",
                        scope=info.qualname,
                    )
                )
    return out
