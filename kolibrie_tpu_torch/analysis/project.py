"""Project model for kolint: parsed files, comment directives, the
function index, and the cross-module call graph with jit-site
reachability.

The call graph is deliberately conservative-but-name-based: a call edge
exists when the callee NAME resolves to a function definition in the
analyzed file set (same module top-level def, ``self.``-method of the
enclosing class, or an imported name whose source module is also being
analyzed).  Function names passed as ARGUMENTS (``lax.scan(body, …)``,
``partial(fn, …)``) also create edges — jitted code reaches its loop
bodies through exactly that shape.  Names that do not resolve (stdlib,
jax internals, dynamic dispatch) simply contribute no edge; rules that
consume reachability are written so a missing edge means a missed
finding, never a false one.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

_SUPPRESS_RE = re.compile(r"#\s*kolint:\s*ignore\[([^\]]*)\]\s*(.*)")
_HOLDS_RE = re.compile(r"#\s*kolint:\s*holds\[([^\]]+)\]")
_GUARDED_RE = re.compile(
    r"#\s*guarded by:\s*([A-Za-z_][\w.]*)(?:\s*\((writes|rw)\))?"
)

# Decorator / callee names that create a jit compilation boundary.
JIT_WRAPPER_NAMES = {"jit", "pjit", "shard_map", "_shard_map", "pmap"}


@dataclass
class Suppression:
    line: int  # line the directive APPLIES to (comment-only lines bind down)
    rules: Tuple[str, ...]
    reason: str
    raw_line: int  # line the comment physically sits on
    used: bool = False


@dataclass
class GuardedState:
    """One ``# guarded by: <lock>`` annotation on mutable state.

    ``mode`` tunes the RUNTIME sanitizer (:mod:`analysis.lockcheck`)
    only — the static rules treat every mode identically:

    - ``"writes"`` (default): rebinding writes must hold the lock;
      reads may be lock-free (the snapshot-read idiom).
    - ``"rw"``: reads must hold it too — use for state mutated in
      place (``list.append``/dict writes), which a descriptor can only
      see as a read of the container.
    """

    attr: str  # attribute or module-global name
    lock: str  # annotation text, e.g. "self.lock" / "_ring_lock"
    class_name: Optional[str]  # None → module-level global
    line: int
    mode: str = "writes"


@dataclass
class FuncInfo:
    module: "SourceFile"
    qualname: str  # "Class.method" or "fn" (module-relative)
    node: ast.AST  # FunctionDef / AsyncFunctionDef / Lambda
    class_name: Optional[str]
    params: Tuple[str, ...] = ()
    static_params: Tuple[str, ...] = ()  # from jit static_argnames/nums
    is_jit_root: bool = False
    jit_reachable: bool = False
    callees: Set[str] = field(default_factory=set)  # global func keys
    holds_locks: Tuple[str, ...] = ()  # kolint: holds[lock] on the def

    @property
    def key(self) -> str:
        return f"{self.module.rel}::{self.qualname}"


class SourceFile:
    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.tree: Optional[ast.Module] = None
        self.parse_error: Optional[str] = None
        self.comments: Dict[int, str] = {}
        self.suppressions: List[Suppression] = []
        self.guarded: List[GuardedState] = []
        self.imports: Dict[str, Tuple[str, str]] = {}  # alias → (module, name)
        self.module_aliases: Dict[str, str] = {}  # alias → module path
        self.functions: Dict[str, FuncInfo] = {}  # qualname → info
        try:
            self.tree = ast.parse(text)
        except SyntaxError as e:
            self.parse_error = f"{e.msg} (line {e.lineno})"
            return
        self._collect_comments()
        self._collect_imports()

    # ------------------------------------------------------------ comments

    def _collect_comments(self) -> None:
        try:
            toks = tokenize.generate_tokens(io.StringIO(self.text).readline)
            for tok in toks:
                if tok.type == tokenize.COMMENT:
                    self.comments[tok.start[0]] = tok.string
        except (tokenize.TokenError, IndentationError):
            return
        lines = self.text.splitlines()
        for lineno, comment in self.comments.items():
            m = _SUPPRESS_RE.search(comment)
            if m:
                rules = tuple(
                    r.strip() for r in m.group(1).split(",") if r.strip()
                )
                code = lines[lineno - 1][: lines[lineno - 1].index("#")]
                applies = lineno + 1 if not code.strip() else lineno
                self.suppressions.append(
                    Suppression(applies, rules, m.group(2).strip(), lineno)
                )
            m = _GUARDED_RE.search(comment)
            if m:
                # attached to guarded state by _index_functions below
                self._pending_guard = getattr(self, "_pending_guard", {})
                self._pending_guard[lineno] = (m.group(1), m.group(2) or "writes")

    def holds_for_line(self, lineno: int) -> Tuple[str, ...]:
        """``# kolint: holds[lock]`` directives on a def's line."""
        m = _HOLDS_RE.search(self.comments.get(lineno, ""))
        if not m:
            return ()
        return tuple(s.strip() for s in m.group(1).split(",") if s.strip())

    # ------------------------------------------------------------- imports

    def _collect_imports(self) -> None:
        for node in walk(self.tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    self.imports[alias.asname or alias.name] = (
                        node.module,
                        alias.name,
                    )
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    self.module_aliases[
                        alias.asname or alias.name.split(".")[0]
                    ] = alias.name


def terminal_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` → ``c``; ``name`` → ``name``; else None."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` → "a.b.c" when the chain is pure names, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _static_names_from_jit_call(call: ast.Call, params: Tuple[str, ...]) -> Tuple[str, ...]:
    """static_argnames / static_argnums keywords of a jit/partial call →
    parameter names."""
    out: List[str] = []
    for kw in call.keywords:
        if kw.arg == "static_argnames":
            v = kw.value
            vals = v.elts if isinstance(v, (ast.Tuple, ast.List)) else [v]
            for e in vals:
                if isinstance(e, ast.Constant) and isinstance(e.value, str):
                    out.append(e.value)
        elif kw.arg == "static_argnums":
            v = kw.value
            vals = v.elts if isinstance(v, (ast.Tuple, ast.List)) else [v]
            for e in vals:
                if (
                    isinstance(e, ast.Constant)
                    and isinstance(e.value, int)
                    and e.value < len(params)
                ):
                    out.append(params[e.value])
    return tuple(out)


def is_jit_wrapper_call(call: ast.Call) -> bool:
    """Is this call ``jax.jit(…)`` / ``shard_map(…)`` / a partner?"""
    name = terminal_name(call.func)
    return name in JIT_WRAPPER_NAMES


def partial_bound_params(call: ast.Call, params: Tuple[str, ...]) -> Tuple[str, ...]:
    """Parameters of the target bound by ``partial(fn, a, kw=b)`` — those
    are trace-time constants (closure-captured), not traced arguments."""
    out: List[str] = list(params[: max(0, len(call.args) - 1)])
    for kw in call.keywords:
        if kw.arg and kw.arg in params:
            out.append(kw.arg)
    return tuple(out)


class Project:
    """All analyzed files + the derived function index and call graph."""

    def __init__(self, files: List[SourceFile]):
        self.files = files
        self.functions: Dict[str, FuncInfo] = {}
        # module import path guess → SourceFile (for cross-module edges)
        self.by_modpath: Dict[str, SourceFile] = {}
        for f in files:
            self.by_modpath[_modpath_of(f.rel)] = f
        for f in files:
            if f.tree is not None:
                self._index_functions(f)
        for f in files:
            if f.tree is not None:
                self._collect_edges_and_roots(f)
        self._propagate_reachability()

    # ------------------------------------------------------------ indexing

    def _index_functions(self, f: SourceFile) -> None:
        pending_guard: Dict[int, Tuple[str, str]] = getattr(
            f, "_pending_guard", {}
        )

        def visit(node: ast.AST, class_name: Optional[str], prefix: str):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    visit(child, child.name, f"{prefix}{child.name}.")
                elif isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    qual = f"{prefix}{child.name}"
                    a = child.args
                    params = tuple(
                        p.arg
                        for p in (
                            list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)
                        )
                    )
                    holds = f.holds_for_line(child.lineno)
                    for deco in child.decorator_list:
                        holds = holds or f.holds_for_line(deco.lineno)
                    info = FuncInfo(
                        f, qual, child, class_name, params=params,
                        holds_locks=holds,
                    )
                    f.functions[qual] = info
                    self.functions[info.key] = info
                    visit(child, class_name, f"{qual}.")
                else:
                    # guarded-state annotations live on assignments
                    if isinstance(child, (ast.Assign, ast.AnnAssign)):
                        guard = pending_guard.get(child.lineno)
                        if guard:
                            lock, mode = guard
                            targets = (
                                child.targets
                                if isinstance(child, ast.Assign)
                                else [child.target]
                            )
                            for t in targets:
                                attr = terminal_name(t)
                                if attr:
                                    f.guarded.append(
                                        GuardedState(
                                            attr, lock, class_name,
                                            child.lineno, mode=mode,
                                        )
                                    )
                    visit(child, class_name, prefix)

        visit(f.tree, None, "")

    # ----------------------------------------------------- edges and roots

    def _resolve_callee(
        self, f: SourceFile, func: FuncInfo, node: ast.AST
    ) -> Optional[FuncInfo]:
        """Resolve a referenced callable to a FuncInfo in the project."""
        if isinstance(node, ast.Name):
            name = node.id
            # same-module: top-level def, or sibling nested def
            if name in f.functions:
                return f.functions[name]
            if func.class_name and f"{func.class_name}.{name}" in f.functions:
                pass  # bare name never resolves to a method
            nested = f"{func.qualname}.{name}"
            if nested in f.functions:
                return f.functions[nested]
            if name in f.imports:
                mod, orig = f.imports[name]
                src = self.by_modpath.get(mod)
                if src and orig in src.functions:
                    return src.functions[orig]
            return None
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name):
                base = node.value.id
                if base in ("self", "cls") and func.class_name:
                    qual = f"{func.class_name}.{node.attr}"
                    if qual in f.functions:
                        return f.functions[qual]
                # module alias:  import kolibrie_tpu_torch.x as y ; y.fn()
                mod = f.module_aliases.get(base)
                if mod is None and base in f.imports:
                    im_mod, im_name = f.imports[base]
                    mod = f"{im_mod}.{im_name}"
                if mod:
                    src = self.by_modpath.get(mod)
                    if src and node.attr in src.functions:
                        return src.functions[node.attr]
        return None

    def _collect_edges_and_roots(self, f: SourceFile) -> None:
        # Pre-pass: decorated jit roots.
        for info in f.functions.values():
            node = info.node
            for deco in getattr(node, "decorator_list", ()):
                dname = terminal_name(deco if not isinstance(deco, ast.Call) else deco.func)
                if dname in JIT_WRAPPER_NAMES:
                    info.is_jit_root = True
                elif isinstance(deco, ast.Call) and dname == "partial":
                    inner = deco.args[0] if deco.args else None
                    if inner is not None and terminal_name(inner) in JIT_WRAPPER_NAMES:
                        info.is_jit_root = True
                        info.static_params = _static_names_from_jit_call(
                            deco, info.params
                        )

        # Per-function: call edges; jit roots via jax.jit(fn) forms.
        for info in f.functions.values():
            own = list(iter_own_nodes(info.node))
            has_jit_call = any(
                isinstance(n, ast.Call) and is_jit_wrapper_call(n) for n in own
            )
            # local `body = partial(fn, …)` aliases: jitted code reaches
            # its round/scan bodies through exactly this indirection
            partial_targets: List[Tuple[FuncInfo, ast.Call]] = []
            for node in own:
                if (
                    isinstance(node, ast.Call)
                    and terminal_name(node.func) == "partial"
                    and node.args
                ):
                    t = self._resolve_callee(f, info, node.args[0])
                    if t is not None:
                        partial_targets.append((t, node))
            for node in own:
                if not isinstance(node, ast.Call):
                    continue
                callee = self._resolve_callee(f, info, node.func)
                if callee is not None:
                    info.callees.add(callee.key)
                in_jit = is_jit_wrapper_call(node)
                # callables passed as arguments (scan/cond bodies,
                # partial(fn, …), Thread targets) are edges too
                for arg in list(node.args) + [kw.value for kw in node.keywords]:
                    target = self._resolve_callee(f, info, arg)
                    bound: Tuple[str, ...] = ()
                    if target is None and isinstance(arg, ast.Call):
                        # partial(fn, …) → fn; bound args are constants
                        if terminal_name(arg.func) == "partial" and arg.args:
                            target = self._resolve_callee(f, info, arg.args[0])
                            if target is not None:
                                bound = partial_bound_params(
                                    arg, target.params
                                )
                    if target is not None:
                        if in_jit:
                            target.is_jit_root = True
                            target.static_params = tuple(
                                dict.fromkeys(
                                    target.static_params
                                    + _static_names_from_jit_call(
                                        node, target.params
                                    )
                                    + bound
                                )
                            )
                        else:
                            info.callees.add(target.key)
            if has_jit_call:
                # a function that builds a jit wrapper: every partial-
                # wrapped local function is (conservatively) a jit root,
                # with the partial-bound parameters as constants
                for t, pcall in partial_targets:
                    t.is_jit_root = True
                    t.static_params = tuple(
                        dict.fromkeys(
                            t.static_params
                            + partial_bound_params(pcall, t.params)
                        )
                    )

        # Lexically nested defs compile with (are reachable from) their
        # parent: closures appear without a resolvable call edge.
        for info in f.functions.values():
            parent_key = (
                info.qualname.rsplit(".", 1)[0]
                if "." in info.qualname else None
            )
            parent = f.functions.get(parent_key) if parent_key else None
            if parent is not None and parent.node is not info.node:
                parent.callees.add(info.key)

    def _propagate_reachability(self) -> None:
        work = [i for i in self.functions.values() if i.is_jit_root]
        seen: Set[str] = set()
        while work:
            info = work.pop()
            if info.key in seen:
                continue
            seen.add(info.key)
            info.jit_reachable = True
            for k in info.callees:
                nxt = self.functions.get(k)
                if nxt is not None and k not in seen:
                    work.append(nxt)

    # ------------------------------------------------------- reachability

    def reachable_from(self, root: FuncInfo) -> List[FuncInfo]:
        out: List[FuncInfo] = []
        seen: Set[str] = set()
        work = [root]
        while work:
            info = work.pop()
            if info.key in seen:
                continue
            seen.add(info.key)
            out.append(info)
            for k in info.callees:
                nxt = self.functions.get(k)
                if nxt is not None and k not in seen:
                    work.append(nxt)
        return out


def walk(node: ast.AST) -> List[ast.AST]:
    """``list(ast.walk(node))``, in the same order, memoized on the node:
    the rule families walk every module tree and many function bodies
    again and again, and one shared list per tree is most of a
    whole-package run's time."""
    cached = getattr(node, "_kolint_walk", None)
    if cached is None:
        cached = list(ast.walk(node))
        try:
            node._kolint_walk = cached
        except (AttributeError, TypeError):
            pass
    return cached


def iter_own_nodes(func_node: ast.AST):
    """Every AST node lexically inside ``func_node``'s body, excluding
    nested function/class bodies (indexed as their own FuncInfos) and
    the function's own signature/decorators.

    The walk is memoized on the node (every rule family re-walks every
    function; one shared list per function is the difference between a
    seconds-scale and a minutes-scale repo run)."""
    cached = getattr(func_node, "_kolint_own_nodes", None)
    if cached is not None:
        return cached
    out: List[ast.AST] = []
    work = list(getattr(func_node, "body", []))
    while work:
        node = work.pop()
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            continue
        out.append(node)
        if isinstance(node, ast.Lambda):
            work.append(node.body)
            continue
        work.extend(ast.iter_child_nodes(node))
    try:
        func_node._kolint_own_nodes = out
    except (AttributeError, TypeError):
        pass
    return out


def _modpath_of(rel: str) -> str:
    """'kolibrie_tpu_torch/obs/spans.py' → 'kolibrie_tpu_torch.obs.spans'."""
    p = rel[:-3] if rel.endswith(".py") else rel
    p = p.replace(os.sep, ".").replace("/", ".")
    if p.endswith(".__init__"):
        p = p[: -len(".__init__")]
    return p


def load_files(paths: List[str], root: str) -> List[SourceFile]:
    out: List[SourceFile] = []
    seen: Set[str] = set()
    for p in paths:
        ap = os.path.abspath(p)
        if os.path.isdir(ap):
            for dirpath, dirnames, filenames in os.walk(ap):
                dirnames[:] = [
                    d for d in dirnames
                    if d != "__pycache__" and not d.startswith(".")
                ]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        full = os.path.join(dirpath, fn)
                        if full not in seen:
                            seen.add(full)
                            out.append(_load_one(full, root))
        elif ap.endswith(".py") and ap not in seen:
            seen.add(ap)
            out.append(_load_one(ap, root))
    return out


def _load_one(path: str, root: str) -> SourceFile:
    try:
        rel = os.path.relpath(path, root)
        if rel.startswith(".."):
            rel = path
    except ValueError:
        rel = path
    with open(path, "r", encoding="utf-8") as fh:
        text = fh.read()
    return SourceFile(path, rel.replace(os.sep, "/"), text)
