"""Rule families 1-2: tracing hazards and recompile hazards.

Grounded in the failure modes "Optimizing Datalog for the GPU" charges
for silently: host↔device synchronization inside compiled code, and
kernel recompilation caused by shapes/static arguments that vary per
query instead of per capacity class.

KL101  host-sync call in jit-reachable code
KL102  Python control flow on a traced value in a jit root
KL201  jit wrapper constructed per call (no memoization)
KL202  static argument derived from per-call values
KL203  static argument that is not fingerprint-stable across processes
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from kolibrie_tpu_torch.analysis.core import Finding, rule
from kolibrie_tpu_torch.analysis.project import (
    FuncInfo,
    Project,
    dotted_name,
    is_jit_wrapper_call,
    iter_own_nodes,
    terminal_name,
)

# Methods that force a device→host transfer (or raise) on a tracer.
_SYNC_METHODS = {"item", "tolist", "block_until_ready"}
# numpy/host conversion callables applied to a traced parameter.
_HOST_CONVERTERS = {"float", "int", "bool"}
_NP_CONVERTERS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
_DEVICE_GET = {"jax.device_get", "device_get"}

# Attribute accesses on a traced value that stay host-side/static.
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size"}


def _jit_functions(project: Project) -> List[FuncInfo]:
    return [i for i in project.functions.values() if i.jit_reachable]


def _traced_params(info: FuncInfo) -> Set[str]:
    """Parameters of a jit ROOT that are traced (not static)."""
    if not info.is_jit_root:
        return set()
    skip = set(info.static_params) | {"self", "cls"}
    return {p for p in info.params if p not in skip}


@rule(
    "KL101",
    "host-sync call (.item()/.tolist()/np.asarray/device_get/float()) "
    "inside code reachable from a jax.jit/shard_map site",
)
def host_sync_in_jit(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for info in _jit_functions(project):
        traced = _traced_params(info)
        for node in iter_own_nodes(info.node):
            if not isinstance(node, ast.Call):
                continue
            # x.item() / x.tolist() / x.block_until_ready()
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _SYNC_METHODS
            ):
                out.append(
                    Finding(
                        "KL101",
                        info.module.rel,
                        node.lineno,
                        f".{node.func.attr}() forces a host sync; keep the "
                        "value on device or move this out of the jit region",
                        scope=info.qualname,
                    )
                )
                continue
            dn = dotted_name(node.func)
            if dn in _DEVICE_GET:
                out.append(
                    Finding(
                        "KL101",
                        info.module.rel,
                        node.lineno,
                        f"{dn}() transfers device data to host inside "
                        "jit-reachable code",
                        scope=info.qualname,
                    )
                )
                continue
            # np.asarray(x) / float(x) on a traced parameter: converting
            # a tracer is either a sync or a TracerConversionError
            name = terminal_name(node.func)
            is_np = dn in _NP_CONVERTERS
            is_conv = (
                isinstance(node.func, ast.Name) and name in _HOST_CONVERTERS
            )
            if (is_np or is_conv) and node.args:
                arg_names = {
                    n.id
                    for n in ast.walk(node.args[0])
                    if isinstance(n, ast.Name)
                }
                if arg_names & traced and not _static_only_use(
                    node.args[0], traced
                ):
                    what = dn if is_np else f"{name}()"
                    out.append(
                        Finding(
                            "KL101",
                            info.module.rel,
                            node.lineno,
                            f"{what} applied to traced parameter "
                            f"{sorted(arg_names & traced)[0]!r} inside a "
                            "jit root",
                            scope=info.qualname,
                        )
                    )
    return out


def _static_only_use(expr: ast.AST, traced: Set[str]) -> bool:
    """True when every traced-name use in ``expr`` goes through a static
    attribute (x.shape / x.ndim / …) or len()."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and node.id in traced:
            if not _is_static_context(expr, node):
                return False
    return True


def _is_static_context(root: ast.AST, target: ast.Name) -> bool:
    """Is ``target`` only consumed via .shape/.ndim/len() within root?"""
    parents = {}
    for node in ast.walk(root):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    p = parents.get(target)
    if isinstance(p, ast.Attribute) and p.attr in _STATIC_ATTRS:
        return True
    if isinstance(p, ast.Call) and terminal_name(p.func) == "len":
        return True
    return False


@rule(
    "KL102",
    "Python if/while/for on a traced value inside a jit root "
    "(trace-time branch: TracerBoolConversionError or silent unroll)",
)
def branch_on_traced(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for info in project.functions.values():
        if not info.is_jit_root:
            continue
        traced = _traced_params(info)
        if not traced:
            continue
        for node in iter_own_nodes(info.node):
            test: Optional[ast.AST] = None
            kind = ""
            if isinstance(node, (ast.If, ast.While)):
                test, kind = node.test, type(node).__name__.lower()
            elif isinstance(node, ast.For):
                # `for x in tuple_param` is a static-length unroll over a
                # pytree — the repo's idiom.  Only `range(traced)` /
                # `enumerate(traced)` force a tracer→int conversion.
                it = node.iter
                if isinstance(it, ast.Call) and terminal_name(it.func) in (
                    "range",
                    "enumerate",
                ):
                    test, kind = it, "for"
            if test is None:
                continue
            used = {
                n.id
                for n in ast.walk(test)
                if isinstance(n, ast.Name) and n.id in traced
            }
            bad = {
                n for n in used
                if not _all_uses_static(test, n)
            }
            if bad:
                out.append(
                    Finding(
                        "KL102",
                        info.module.rel,
                        node.lineno,
                        f"`{kind}` on traced parameter {sorted(bad)[0]!r}; "
                        "branch with jnp.where/lax.cond or declare it in "
                        "static_argnames",
                        scope=info.qualname,
                    )
                )
    return out


def _all_uses_static(expr: ast.AST, name: str) -> bool:
    parents = {}
    for node in ast.walk(expr):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and node.id == name:
            p = parents.get(node)
            ok = False
            if isinstance(p, ast.Attribute) and p.attr in _STATIC_ATTRS:
                ok = True
            elif isinstance(p, ast.Call) and terminal_name(p.func) == "len":
                ok = True
            elif isinstance(p, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in p.ops
            ):
                # `x is None` inspects pytree STRUCTURE, not the tracer
                ok = True
            if not ok:
                return False
    return True


_MEMO_DECORATORS = {"lru_cache", "cache", "cached_property"}


@rule(
    "KL201",
    "jax.jit/shard_map wrapper constructed inside a function without "
    "memoization — a fresh wrapper per call retraces/recompiles per call",
)
def jit_per_call(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for info in project.functions.values():
        node = info.node
        if info.qualname.split(".")[-1] == "__init__":
            continue  # one-time per instance: the builder pattern
        deco_names = set()
        for deco in node.decorator_list:
            d = deco.func if isinstance(deco, ast.Call) else deco
            n = terminal_name(d)
            if n:
                deco_names.add(n)
        if deco_names & _MEMO_DECORATORS:
            continue
        globals_declared: Set[str] = set()
        for sub in iter_own_nodes(node):
            if isinstance(sub, ast.Global):
                globals_declared.update(sub.names)
        parents = {}
        for sub in iter_own_nodes(node):
            for child in ast.iter_child_nodes(sub):
                parents[child] = sub
        for sub in iter_own_nodes(node):
            if not (isinstance(sub, ast.Call) and is_jit_wrapper_call(sub)):
                continue
            # only the OUTERMOST wrapper call counts
            p = parents.get(sub)
            chain_inner = False
            while p is not None:
                if isinstance(p, ast.Call) and is_jit_wrapper_call(p):
                    chain_inner = True
                    break
                p = parents.get(p)
            if chain_inner:
                continue
            if _memoized_assignment(sub, parents, globals_declared):
                continue
            out.append(
                Finding(
                    "KL201",
                    info.module.rel,
                    sub.lineno,
                    f"{terminal_name(sub.func)}(…) built inside "
                    f"{info.qualname}() without memoization; hoist to "
                    "module scope, @lru_cache the factory, or store the "
                    "wrapper on the instance",
                    scope=info.qualname,
                )
            )
    return out


def _memoized_assignment(call, parents, globals_declared: Set[str]) -> bool:
    """jit result assigned to a module global or an instance/class
    attribute → the wrapper survives across calls."""
    p = parents.get(call)
    while p is not None and not isinstance(p, ast.stmt):
        p = parents.get(p)
    if isinstance(p, ast.Assign):
        for t in p.targets:
            if isinstance(t, ast.Name) and t.id in globals_declared:
                return True
            if isinstance(t, ast.Attribute) and isinstance(
                t.value, ast.Name
            ) and t.value.id in ("self", "cls"):
                return True
    return False


# Expressions acceptable as a static argument: capacity-class values.
def _static_arg_ok(expr: ast.AST) -> bool:
    if isinstance(expr, (ast.Name, ast.Attribute, ast.Constant)):
        return True
    if isinstance(expr, ast.Tuple):
        return all(_static_arg_ok(e) for e in expr.elts)
    if isinstance(expr, ast.Call):
        # tuple(xs) / int(x) of a name: still a value, not a per-call
        # fingerprint; len()/str()/f-strings are handled below
        fn = terminal_name(expr.func)
        if fn in ("tuple", "frozenset", "min", "max", "round_cap"):
            return True
    if isinstance(expr, ast.BinOp):
        return _static_arg_ok(expr.left) and _static_arg_ok(expr.right)
    return False


@rule(
    "KL202",
    "static argument at a jit call site derived from per-call values "
    "(f-string / str() / len()) — every distinct value is a recompile",
)
def static_arg_from_per_call(project: Project) -> List[Finding]:
    out: List[Finding] = []
    # jit roots with declared static params, indexed by bare name
    jit_by_name = {}
    for info in project.functions.values():
        if info.is_jit_root and info.static_params:
            jit_by_name.setdefault(
                info.qualname.split(".")[-1], info
            )
    for info in project.functions.values():
        for node in iter_own_nodes(info.node):
            if not isinstance(node, ast.Call):
                continue
            callee_name = terminal_name(node.func)
            callee = jit_by_name.get(callee_name)
            if callee is None:
                continue
            static = set(callee.static_params)
            bound = []
            for i, arg in enumerate(node.args):
                if i < len(callee.params) and callee.params[i] in static:
                    bound.append((callee.params[i], arg))
            for kw in node.keywords:
                if kw.arg in static:
                    bound.append((kw.arg, kw.value))
            for pname, expr in bound:
                bad = _per_call_static_expr(expr)
                if bad:
                    out.append(
                        Finding(
                            "KL202",
                            info.module.rel,
                            node.lineno,
                            f"static argument {pname!r} of {callee_name}() "
                            f"is {bad}; pass a capacity-class value "
                            "(base_cap/delta_cap style) so shapes stay "
                            "template-stable",
                            scope=info.qualname,
                        )
                    )
    return out


def _per_call_static_expr(expr: ast.AST) -> str:
    """Non-empty description when the expression varies per call."""
    for node in ast.walk(expr):
        if isinstance(node, ast.JoinedStr):
            return "an f-string (per-call fingerprint)"
        if isinstance(node, ast.Call):
            fn = terminal_name(node.func)
            if fn in ("str", "repr", "format"):
                return f"{fn}() of a runtime value"
            if fn == "len":
                return "len() of per-call data"
        if isinstance(node, ast.Attribute) and node.attr == "shape":
            return "a .shape read of per-call data"
    return ""


# Attributes whose values are process-local counters/versions: embedding
# one in a static argument keys the executable on state no other process
# (or the persistent compilation cache) can reproduce.
_PROCESS_LOCAL_ATTRS = {"__dict__", "delta_epoch", "base_version"}


@rule(
    "KL203",
    "static argument at a jit call site that is not fingerprint-stable "
    "across processes (id()/hash()/object()/raw version counters) — "
    "it defeats the persistent compilation cache and recompiles per "
    "process or per mutation",
)
def static_arg_not_fingerprint_stable(project: Project) -> List[Finding]:
    out: List[Finding] = []
    jit_by_name = {}
    for info in project.functions.values():
        if info.is_jit_root and info.static_params:
            jit_by_name.setdefault(info.qualname.split(".")[-1], info)
    for info in project.functions.values():
        for node in iter_own_nodes(info.node):
            if not isinstance(node, ast.Call):
                continue
            callee = jit_by_name.get(terminal_name(node.func))
            if callee is None:
                continue
            static = set(callee.static_params)
            bound = []
            for i, arg in enumerate(node.args):
                if i < len(callee.params) and callee.params[i] in static:
                    bound.append((callee.params[i], arg))
            for kw in node.keywords:
                if kw.arg in static:
                    bound.append((kw.arg, kw.value))
            for pname, expr in bound:
                bad = _unstable_static_expr(expr)
                if bad:
                    out.append(
                        Finding(
                            "KL203",
                            info.module.rel,
                            node.lineno,
                            f"static argument {pname!r} of "
                            f"{callee.qualname.split('.')[-1]}() is {bad}; "
                            "key the executable on structural values "
                            "(shapes, capacity classes, fingerprints) so "
                            "two processes lowering the same template hash "
                            "to the same persistent-cache entry",
                            scope=info.qualname,
                        )
                    )
    return out


def _unstable_static_expr(expr: ast.AST) -> str:
    """Non-empty description when the expression cannot reproduce across
    processes: object identities, salted hashes, fresh sentinels, and
    raw store version counters (monotonic per process, not content-
    derived)."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            fn = terminal_name(node.func)
            if fn == "id":
                return "id() — an object address, unique to this process"
            if fn == "hash":
                return "hash() — salted per process for str/bytes"
            if fn == "object":
                return "object() — a fresh sentinel every call"
        if (
            isinstance(node, ast.Attribute)
            and node.attr in _PROCESS_LOCAL_ATTRS
        ):
            return (
                f"a raw .{node.attr} read — a process-local counter/"
                "identity, not a content fingerprint"
            )
    return ""
