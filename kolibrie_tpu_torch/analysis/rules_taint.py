"""Rule family 11x: dataflow taint from traced values.

KL101/KL102 pattern-match DIRECT uses of a jit root's traced
parameters.  These rules run the :mod:`analysis.dataflow` engine on
top of the same jit-site model and follow real def-use chains instead:

KL111  a value DERIVED from a traced parameter — through assignments,
       arithmetic, or calls whose param→return summary carries taint —
       reaching a host sink (``if``/``while`` test, ``range()`` bound,
       ``int()``/``float()``/``bool()``, ``np.asarray``/``np.array``)
       inside jit-reachable code.  Sites KL101/KL102 already flag
       (bare traced params at a root) are skipped, so one bug is one
       finding.
KL112  the recompile-hazard class:
       (a) a traced value used as a SHAPE — ``reshape``/``zeros``/
           ``ones``/``full``/``empty``/``arange``/``eye``/
           ``broadcast_to`` dims — inside jit code (shapes must be
           trace-time constants; a data-derived dim is either an error
           or a recompile per value), and
       (b) host-side: a local variable whose reaching definition is
           ``len(param)``/``param.shape`` of per-call data, passed as a
           DECLARED static argument of a jit root.  KL202 catches the
           lexical form (``fn(x, cap=len(rows))``); the def-use form
           (``n = len(rows); fn(x, cap=n)``) needs reaching
           definitions.  Values laundered through a capacity-class
           helper (``round_cap``/``pow2``/``bucket``) are clean — that
           is the template-cap protocol working as designed.

Taint seeding is interprocedural: every jit root's non-static params
are traced, and :func:`dataflow.propagate_traced_params` pushes taint
through resolved calls, so a helper three frames below the root still
knows which of ITS parameters are traced.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from kolibrie_tpu_torch.analysis.core import Finding, rule
from kolibrie_tpu_torch.analysis.dataflow import (
    TRACED,
    Summaries,
    TaintAnalysis,
    analysis_for,
    param_bindings,
    propagate_traced_params,
    stmt_exprs,
)
from kolibrie_tpu_torch.analysis.project import (
    FuncInfo,
    Project,
    dotted_name,
    iter_own_nodes,
    terminal_name,
)

_HOST_CONVERTERS = {"int", "float", "bool"}
_NP_CONVERTERS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}

# callable terminal → indices of its shape-position arguments
# (None → every positional argument is a shape)
_SHAPE_CALLS: Dict[str, Optional[Tuple[int, ...]]] = {
    "zeros": (0,),
    "ones": (0,),
    "empty": (0,),
    "full": (0,),
    "eye": (0, 1),
    "arange": None,
    "broadcast_to": (1,),
}

# a value passed through one of these is a capacity class, not data
_SANITIZER_MARKERS = ("cap", "pow2", "bucket")


def _contains_kl101_sync(expr: ast.AST) -> bool:
    """Does the expression contain a host-sync call KL101 already
    anchors on (``.item()``/``.tolist()``/…)?  One bug, one finding:
    ``float(y.item())`` is KL101's, not also KL111's."""
    from kolibrie_tpu_torch.analysis.rules_tracing import _SYNC_METHODS

    return any(
        isinstance(n, ast.Call)
        and isinstance(n.func, ast.Attribute)
        and n.func.attr in _SYNC_METHODS
        for n in ast.walk(expr)
    )


def _taint_state(project: Project):
    """(summaries, traced-params map), computed once per project."""
    cached = getattr(project, "_kolint_taint_state", None)
    if cached is None:
        jit_keys = {
            k for k, i in project.functions.items() if i.jit_reachable
        }
        summaries = Summaries(project, only=jit_keys)
        traced = propagate_traced_params(project, summaries)
        cached = (summaries, traced)
        project._kolint_taint_state = cached
    return cached


def _tainted_names(ana: TaintAnalysis, expr: ast.AST, env) -> Set[str]:
    return {
        n.id
        for n in ast.walk(expr)
        if isinstance(n, ast.Name)
        and env.get(n.id, (0, frozenset()))[0] & TRACED
    }


def _only_bare_params(
    ana: TaintAnalysis, expr: ast.AST, env, seeds: Set[str]
) -> bool:
    """True when every TRACED name in ``expr`` is a directly-seeded
    parameter — the case KL101/KL102 already own at jit roots."""
    names = _tainted_names(ana, expr, env)
    return bool(names) and names <= seeds


@rule(
    "KL111",
    "value derived from a traced parameter (via def-use chains and "
    "call summaries) reaching a host sink in jit-reachable code",
)
def derived_taint_to_host_sink(project: Project) -> List[Finding]:
    summaries, traced = _taint_state(project)
    out: List[Finding] = []
    for key in sorted(traced):
        info = project.functions[key]
        seeds = set(traced[key])
        ana = analysis_for(
            info, project, summaries, {p: TRACED for p in seeds}
        )
        root_owned = info.is_jit_root  # KL101/102 cover bare params there
        for stmt, env, _locks in ana.iter_states():
            sink: Optional[ast.AST] = None
            kind = ""
            if isinstance(stmt, (ast.If, ast.While)):
                sink, kind = stmt.test, type(stmt).__name__.lower()
            elif isinstance(stmt, ast.For):
                it = stmt.iter
                if isinstance(it, ast.Call) and terminal_name(it.func) in (
                    "range", "enumerate",
                ):
                    sink, kind = it, "for range(…)"
            if sink is not None and ana.expr_taint(sink, env) & TRACED:
                if root_owned and _only_bare_params(ana, sink, env, seeds):
                    continue
                name = sorted(_tainted_names(ana, sink, env) or {"<expr>"})[0]
                out.append(
                    Finding(
                        "KL111",
                        info.module.rel,
                        stmt.lineno,
                        f"`{kind}` on {name!r}, which derives from a "
                        "traced value (def-use chain from a jit "
                        "parameter); branch with jnp.where/lax.cond or "
                        "hoist the decision to the host",
                        scope=info.qualname,
                    )
                )
            # converter sinks anywhere inside the statement
            for node in stmt_exprs(stmt):
                if not isinstance(node, ast.Call) or not node.args:
                    continue
                tname = terminal_name(node.func)
                dn = dotted_name(node.func)
                is_conv = (
                    isinstance(node.func, ast.Name)
                    and tname in _HOST_CONVERTERS
                )
                is_np = dn in _NP_CONVERTERS
                if not (is_conv or is_np):
                    continue
                arg = node.args[0]
                if not (ana.expr_taint(arg, env) & TRACED):
                    continue
                if root_owned and _only_bare_params(ana, arg, env, seeds):
                    continue
                if _contains_kl101_sync(arg):
                    continue  # float(y.item()): KL101 owns the .item()
                what = dn if is_np else f"{tname}()"
                name = sorted(_tainted_names(ana, arg, env) or {"<expr>"})[0]
                out.append(
                    Finding(
                        "KL111",
                        info.module.rel,
                        node.lineno,
                        f"{what} applied to {name!r}, which derives from "
                        "a traced value — a host sync or "
                        "TracerConversionError inside jit",
                        scope=info.qualname,
                    )
                )
    return out


def _shape_args(call: ast.Call) -> List[ast.AST]:
    """The shape-position argument expressions of a shape-creating call,
    or [] when this call is not one."""
    tname = terminal_name(call.func)
    if tname == "reshape":
        if isinstance(call.func, ast.Attribute):
            return list(call.args)  # x.reshape(d0, d1)
        return list(call.args[1:])  # jnp.reshape(x, shape)
    spec = _SHAPE_CALLS.get(tname or "")
    if spec is None and tname in _SHAPE_CALLS:
        return list(call.args)  # arange: every positional arg
    if spec is None:
        return []
    return [call.args[i] for i in spec if i < len(call.args)]


@rule(
    "KL112",
    "data-derived value reaching a shape position (reshape/zeros dims "
    "in jit code) or a declared static argument via an assignment — "
    "the recompile-hazard class",
)
def data_derived_static(project: Project) -> List[Finding]:
    summaries, traced = _taint_state(project)
    out: List[Finding] = []

    # (a) traced value as a shape dim inside jit-reachable code
    for key in sorted(traced):
        info = project.functions[key]
        ana = analysis_for(
            info, project, summaries, {p: TRACED for p in traced[key]}
        )
        for stmt, env, _locks in ana.iter_states():
            for node in stmt_exprs(stmt):
                if not isinstance(node, ast.Call):
                    continue
                for arg in _shape_args(node):
                    if ana.expr_taint(arg, env) & TRACED:
                        name = sorted(
                            _tainted_names(ana, arg, env) or {"<expr>"}
                        )[0]
                        out.append(
                            Finding(
                                "KL112",
                                info.module.rel,
                                node.lineno,
                                f"{terminal_name(node.func)}(…) shape "
                                f"argument derives from traced value "
                                f"{name!r}; shapes must be trace-time "
                                "constants — use a capacity-class dim "
                                "(template-cap protocol)",
                                scope=info.qualname,
                            )
                        )
    # (b) host-side def-use extension of KL202: n = len(rows); fn(cap=n)
    jit_with_static = {
        k for k, i in project.functions.items()
        if i.is_jit_root and i.static_params
    }
    for info in project.functions.values():
        if not (set(info.callees) & jit_with_static):
            continue
        if info.jit_reachable:
            # inside jit, `.shape`/`len()` of a traced operand IS a
            # trace-time constant — exactly the capacity-class value
            # the static argument wants
            continue
        ana = TaintAnalysis(info, {})
        params = set(info.params)
        for stmt, env, _locks in ana.iter_states():
            for node in stmt_exprs(stmt):
                if not isinstance(node, ast.Call):
                    continue
                target = project._resolve_callee(
                    info.module, info, node.func
                )
                if target is None or target.key not in jit_with_static:
                    continue
                static = set(target.static_params)
                for pname, arg in param_bindings(target, node):
                    if pname not in static or not isinstance(arg, ast.Name):
                        continue
                    for d in ana.defs_of(arg.id, env):
                        bad = _per_call_def(d, params)
                        if bad:
                            out.append(
                                Finding(
                                    "KL112",
                                    info.module.rel,
                                    node.lineno,
                                    f"static argument {pname!r} of "
                                    f"{target.qualname.split('.')[-1]}() "
                                    f"is {arg.id!r}, defined as {bad} — "
                                    "every distinct value recompiles; "
                                    "round through a capacity class "
                                    "(round_cap/pow2 bucket) first",
                                    scope=info.qualname,
                                )
                            )
                            break
    return out


def _per_call_def(expr: ast.AST, params: Set[str]) -> str:
    """Non-empty description when a definition expression derives from
    per-call data (a parameter) without a capacity-class sanitizer."""
    if isinstance(expr, ast.Call):
        fn = terminal_name(expr.func)
        if fn and any(m in fn.lower() for m in _SANITIZER_MARKERS):
            return ""  # laundered through the template-cap protocol
        if fn == "len" and expr.args and _rooted_in(expr.args[0], params):
            return "len() of a per-call argument"
    if isinstance(expr, ast.Attribute) and expr.attr in ("shape", "size"):
        if _rooted_in(expr.value, params):
            return f"a .{expr.attr} read of a per-call argument"
    if isinstance(expr, ast.Subscript):
        base = expr.value
        if isinstance(base, ast.Attribute) and base.attr == "shape":
            if _rooted_in(base.value, params):
                return "a .shape read of a per-call argument"
    return ""


def _rooted_in(expr: ast.AST, params: Set[str]) -> bool:
    """Does the attribute/subscript chain bottom out at a parameter?"""
    node = expr
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return isinstance(node, ast.Name) and node.id in params
