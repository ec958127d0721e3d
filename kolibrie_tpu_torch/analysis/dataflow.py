"""kolint dataflow engine: per-function CFGs lowered from the stdlib
``ast`` module and a forward worklist solver.

Three facts flow through the CFG, all computed in one pass:

- **taint** — a small bitmask lattice per variable.  Bit 0 (``TRACED``)
  marks values derived from a jit root's traced parameters; the
  remaining bits are used internally to compute per-function
  *param→return* summaries, which is what makes the analysis
  interprocedural: ``y = helper(x)`` taints ``y`` exactly when
  ``helper``'s summary says its first parameter flows to its return
  value.  Joins are bitwise-or, so the lattice has no infinite chains
  and the worklist terminates.
- **reaching definitions** — per variable, the set of value
  expressions that may define it at a program point.  Rules use this
  to look *through* an assignment (``n = len(rows); run(x, cap=n)``)
  instead of pattern-matching the call site lexically.
- **lock-set state** — the set of ``with <lock>:`` context names
  lexically active for each block, plus the function's
  ``# kolint: holds[...]`` claims.  Python's ``with`` is strictly
  scoped, so lock state is a property of CFG *construction* rather
  than of the fixpoint; ``lock.acquire()`` without a ``with`` is out
  of model (use ``holds[...]``), exactly as in rules_locks.

The CFG is statement-granular: compound statements contribute their
header (test / iterator / context expressions) to one block and their
bodies to successor blocks, with back edges for loops, edges to a
shared exit for ``return``/``raise``, and coarse edges into ``except``
handlers from the ``try`` entry and body end.  Nested ``def``/``class``
bodies are opaque (they are indexed as their own FuncInfos).

Everything here is conservative in the direction rules want: a name
the engine cannot resolve contributes no taint and no definition, so a
missing edge means a missed finding, never a false one.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Callable, Dict, FrozenSet, List, Optional, Set, Tuple

from kolibrie_tpu_torch.analysis.project import (
    FuncInfo,
    Project,
    dotted_name,
    iter_own_nodes,
    terminal_name,
)

TRACED = 1  # taint bit 0: value derives from a traced jit parameter

# Attribute reads of a traced value that stay host-side/static.
STATIC_ATTRS = {"shape", "ndim", "dtype", "size"}

# Callables whose RESULT is host/static data regardless of argument
# taint (they are sinks, not carriers — the sink rules flag the call
# itself; its result must not cascade into more findings).
_CLEAN_RESULT_CALLS = {
    "len", "int", "float", "bool", "str", "repr", "format", "type",
    "id", "hash", "isinstance", "range", "enumerate",
}


# --------------------------------------------------------------------- CFG


@dataclass
class Block:
    bid: int
    locks: FrozenSet[str] = frozenset()
    stmts: List[ast.stmt] = field(default_factory=list)
    succs: List[int] = field(default_factory=list)
    preds: List[int] = field(default_factory=list)


class CFG:
    def __init__(self) -> None:
        self.blocks: List[Block] = []
        self.entry = 0
        self.exit = 0

    def new_block(self, locks: FrozenSet[str]) -> Block:
        b = Block(len(self.blocks), locks)
        self.blocks.append(b)
        return b

    def edge(self, src: int, dst: int) -> None:
        if dst not in self.blocks[src].succs:
            self.blocks[src].succs.append(dst)
            self.blocks[dst].preds.append(src)


def _with_lock_names(stmt: ast.stmt) -> FrozenSet[str]:
    """Terminal names acquired by a ``with`` statement's items —
    covers ``with X:``, ``with X, Y:`` and ``with lock_fn():``."""
    names: Set[str] = set()
    for item in stmt.items:  # type: ignore[attr-defined]
        t = terminal_name(item.context_expr)
        if t:
            names.add(t)
        if isinstance(item.context_expr, ast.Call):
            t2 = terminal_name(item.context_expr.func)
            if t2:
                names.add(t2)
    return frozenset(names)


class _Builder:
    def __init__(self) -> None:
        self.cfg = CFG()
        entry = self.cfg.new_block(frozenset())
        self.cfg.entry = entry.bid
        self.exit_id = self.cfg.new_block(frozenset()).bid
        self.cfg.exit = self.exit_id
        # (loop_head_bid, loop_after_bid) for break/continue targets
        self.loops: List[Tuple[int, int]] = []

    def seq(
        self, stmts: List[ast.stmt], cur: Block, locks: FrozenSet[str]
    ) -> Optional[Block]:
        """Lower a statement sequence starting in ``cur``; returns the
        open block control falls out of, or None when every path
        diverges (return/raise/break/continue)."""
        cfg = self.cfg
        for stmt in stmts:
            if cur is None:
                # dead code after a divergence still gets analyzed,
                # in an unreachable block with bottom in-state
                cur = cfg.new_block(locks)
            if isinstance(stmt, ast.If):
                cur.stmts.append(stmt)
                then_b = cfg.new_block(locks)
                cfg.edge(cur.bid, then_b.bid)
                t_end = self.seq(stmt.body, then_b, locks)
                e_end: Optional[Block] = None
                has_else = bool(stmt.orelse)
                if has_else:
                    else_b = cfg.new_block(locks)
                    cfg.edge(cur.bid, else_b.bid)
                    e_end = self.seq(stmt.orelse, else_b, locks)
                join = cfg.new_block(locks)
                if t_end is not None:
                    cfg.edge(t_end.bid, join.bid)
                if has_else:
                    if e_end is not None:
                        cfg.edge(e_end.bid, join.bid)
                else:
                    cfg.edge(cur.bid, join.bid)
                cur = join
            elif isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
                head = cfg.new_block(locks)
                cfg.edge(cur.bid, head.bid)
                head.stmts.append(stmt)
                after = cfg.new_block(locks)
                cfg.edge(head.bid, after.bid)
                body_b = cfg.new_block(locks)
                cfg.edge(head.bid, body_b.bid)
                self.loops.append((head.bid, after.bid))
                b_end = self.seq(stmt.body, body_b, locks)
                self.loops.pop()
                if b_end is not None:
                    cfg.edge(b_end.bid, head.bid)
                # loop-else is rare: lower it straight into `after`
                if stmt.orelse:
                    a_end = self.seq(stmt.orelse, after, locks)
                    cur = a_end if a_end is not None else None
                else:
                    cur = after
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                cur.stmts.append(stmt)
                inner = locks | _with_lock_names(stmt)
                body_b = cfg.new_block(inner)
                cfg.edge(cur.bid, body_b.bid)
                b_end = self.seq(stmt.body, body_b, inner)
                after = cfg.new_block(locks)
                if b_end is not None:
                    cfg.edge(b_end.bid, after.bid)
                cur = after
            elif isinstance(stmt, ast.Try):
                body_b = cfg.new_block(locks)
                cfg.edge(cur.bid, body_b.bid)
                b_end = self.seq(stmt.body, body_b, locks)
                after = cfg.new_block(locks)
                h_src = [body_b.bid] + ([b_end.bid] if b_end else [])
                for handler in stmt.handlers:
                    h_b = cfg.new_block(locks)
                    h_b.stmts.append(handler)  # binds `as name`
                    for src in h_src:
                        cfg.edge(src, h_b.bid)
                    h_end = self.seq(handler.body, h_b, locks)
                    if h_end is not None:
                        cfg.edge(h_end.bid, after.bid)
                if b_end is not None:
                    if stmt.orelse:
                        o_end = self.seq(stmt.orelse, b_end, locks)
                        if o_end is not None:
                            cfg.edge(o_end.bid, after.bid)
                    else:
                        cfg.edge(b_end.bid, after.bid)
                if stmt.finalbody:
                    f_end = self.seq(stmt.finalbody, after, locks)
                    cur = f_end
                else:
                    cur = after
            elif isinstance(stmt, (ast.Return, ast.Raise)):
                cur.stmts.append(stmt)
                cfg.edge(cur.bid, self.exit_id)
                cur = None
            elif isinstance(stmt, ast.Break):
                if self.loops:
                    cfg.edge(cur.bid, self.loops[-1][1])
                cur = None
            elif isinstance(stmt, ast.Continue):
                if self.loops:
                    cfg.edge(cur.bid, self.loops[-1][0])
                cur = None
            elif isinstance(
                stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue  # nested scopes are their own FuncInfos
            else:
                cur.stmts.append(stmt)
        return cur


def build_cfg(func_node: ast.AST) -> CFG:
    """Lower one function body to a CFG (memoized on the node)."""
    cached = getattr(func_node, "_kolint_cfg", None)
    if cached is not None:
        return cached
    b = _Builder()
    entry = b.cfg.blocks[b.cfg.entry]
    end = b.seq(list(getattr(func_node, "body", [])), entry, frozenset())
    if end is not None:
        b.cfg.edge(end.bid, b.exit_id)
    try:
        func_node._kolint_cfg = b.cfg
    except (AttributeError, TypeError):
        pass
    return b.cfg


def stmt_exprs(stmt: ast.stmt):
    """The AST nodes that belong to ``stmt`` AT ITS OWN CFG POSITION.

    Compound statements contribute only their header (test / iterator /
    context expressions) — their bodies live in successor blocks and
    are yielded when those blocks' statements are visited.  Walking the
    full subtree here would attribute body nodes to the wrong block
    (wrong lock set, stale taint env) and visit every sink twice."""
    if isinstance(stmt, (ast.If, ast.While)):
        yield from ast.walk(stmt.test)
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        yield from ast.walk(stmt.target)
        yield from ast.walk(stmt.iter)
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        for item in stmt.items:
            yield from ast.walk(item.context_expr)
            if item.optional_vars is not None:
                yield from ast.walk(item.optional_vars)
    elif isinstance(stmt, ast.Try):
        return  # body/handlers/finally are their own blocks
    elif isinstance(stmt, ast.ExceptHandler):
        if stmt.type is not None:
            yield from ast.walk(stmt.type)
    else:
        yield from ast.walk(stmt)


def locks_at(func: FuncInfo, node: ast.AST) -> FrozenSet[str]:
    """Lock terminals held at ``node`` inside ``func``: the enclosing
    ``with`` scopes (via the CFG's per-block lock sets) plus the
    function's ``# kolint: holds[...]`` claims."""
    cfg = build_cfg(func.node)
    target = id(node)
    index = getattr(func.node, "_kolint_lock_index", None)
    if index is None:
        index = {}
        for block in cfg.blocks:
            for stmt in block.stmts:
                for sub in stmt_exprs(stmt):
                    index.setdefault(id(sub), block.locks)
        try:
            func.node._kolint_lock_index = index
        except (AttributeError, TypeError):
            pass
    held = set(index.get(target, frozenset()))
    for lock in func.holds_locks:
        held.add(lock.split(".")[-1])
    return frozenset(held)


# ----------------------------------------------------------------- dataflow

# Env: name → (taint bits, frozenset of def-expression ids)
Env = Dict[str, Tuple[int, FrozenSet[int]]]


def _join(a: Env, b: Env) -> Env:
    if not a:
        return dict(b)
    out = dict(a)
    for k, (bits, defs) in b.items():
        if k in out:
            obits, odefs = out[k]
            out[k] = (obits | bits, odefs | defs)
        else:
            out[k] = (bits, defs)
    return out


def _env_eq(a: Env, b: Env) -> bool:
    return a == b


class TaintAnalysis:
    """Forward taint + reaching-defs over one function's CFG.

    ``eval_call(call, arg_bits)`` lets the caller inject
    interprocedural knowledge (summaries); it returns the taint of the
    call's result, or None to fall back to the default (union of
    argument taint, cleaned for the known host converters).
    """

    def __init__(
        self,
        func: FuncInfo,
        seed: Dict[str, int],
        eval_call: Optional[Callable[[ast.Call, List[int]], Optional[int]]] = None,
    ):
        self.func = func
        self.cfg = build_cfg(func.node)
        self.seed = seed
        self.eval_call = eval_call
        self.defs: Dict[int, ast.AST] = {}  # id → def expression
        self._in: Dict[int, Env] = {}
        self._solve()

    # -------------------------------------------------------- expressions

    def expr_taint(self, expr: ast.AST, env: Env) -> int:
        """Taint bits of ``expr`` under ``env``."""
        if isinstance(expr, ast.Name):
            return env.get(expr.id, (0, frozenset()))[0]
        if isinstance(expr, ast.Constant):
            return 0
        if isinstance(expr, ast.Attribute):
            if expr.attr in STATIC_ATTRS:
                return 0
            return self.expr_taint(expr.value, env)
        if isinstance(expr, ast.Call):
            arg_bits = [self.expr_taint(a, env) for a in expr.args]
            arg_bits += [
                self.expr_taint(kw.value, env) for kw in expr.keywords
            ]
            if self.eval_call is not None:
                bits = self.eval_call(expr, arg_bits)
                if bits is not None:
                    return bits
            name = terminal_name(expr.func)
            if name in _CLEAN_RESULT_CALLS:
                return 0
            if name == "keys" and isinstance(expr.func, ast.Attribute):
                return 0  # pytree dict keys are host data
            bits = 0
            for b in arg_bits:
                bits |= b
            # method call: the receiver's taint carries (x.sum() etc.)
            if isinstance(expr.func, ast.Attribute):
                bits |= self.expr_taint(expr.func.value, env)
            return bits
        if isinstance(expr, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
                return 0  # pytree-structure check, not a value read
            if all(isinstance(op, (ast.In, ast.NotIn)) for op in expr.ops):
                # membership tests the NEEDLE against container KEYS —
                # `var in pytree_dict` is a host-side key lookup even
                # when the dict's VALUES are traced
                return self.expr_taint(expr.left, env)
            bits = self.expr_taint(expr.left, env)
            for c in expr.comparators:
                bits |= self.expr_taint(c, env)
            return bits
        if isinstance(expr, ast.Lambda):
            return 0
        if isinstance(expr, ast.JoinedStr):
            return 0  # a string is host data; f-strings on tracers raise
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            bits = 0
            for gen in expr.generators:
                bits |= self.expr_taint(gen.iter, env)
            return bits
        bits = 0
        for child in ast.iter_child_nodes(expr):
            if isinstance(child, (ast.expr, ast.keyword)):
                inner = child.value if isinstance(child, ast.keyword) else child
                bits |= self.expr_taint(inner, env)
        return bits

    def _assign(
        self, target: ast.AST, bits: int, value: ast.AST, env: Env
    ) -> None:
        if isinstance(target, ast.Name):
            self.defs[id(value)] = value
            env[target.id] = (bits, frozenset({id(value)}))
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._assign(elt, bits, value, env)
        elif isinstance(target, ast.Starred):
            self._assign(target.value, bits, value, env)
        # attribute/subscript targets: field-level taint is out of model

    def transfer(self, stmt: ast.stmt, env: Env) -> None:
        """Apply one statement's effect to ``env`` in place."""
        if isinstance(stmt, ast.Assign):
            bits = self.expr_taint(stmt.value, env)
            for t in stmt.targets:
                self._assign(t, bits, stmt.value, env)
        elif isinstance(stmt, ast.AugAssign):
            bits = self.expr_taint(stmt.value, env)
            if isinstance(stmt.target, ast.Name):
                prev = env.get(stmt.target.id, (0, frozenset()))
                env[stmt.target.id] = (
                    prev[0] | bits,
                    prev[1] | frozenset({id(stmt.value)}),
                )
                self.defs[id(stmt.value)] = stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            bits = self.expr_taint(stmt.value, env)
            self._assign(stmt.target, bits, stmt.value, env)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            bits = self.expr_taint(stmt.iter, env)
            split = self._split_loop_target(stmt, bits, env)
            if not split:
                self._assign(stmt.target, bits, stmt.iter, env)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                if item.optional_vars is not None:
                    bits = self.expr_taint(item.context_expr, env)
                    self._assign(
                        item.optional_vars, bits, item.context_expr, env
                    )
        elif isinstance(stmt, ast.ExceptHandler):
            if stmt.name:
                env[stmt.name] = (0, frozenset())

    def _split_loop_target(
        self, stmt: ast.stmt, bits: int, env: Env
    ) -> bool:
        """Precise taint for ``for k, v in d.items()`` / ``enumerate``:
        dict keys and enumerate indices are host data even when the
        values are traced.  Returns True when handled."""
        it = stmt.iter  # type: ignore[attr-defined]
        target = stmt.target  # type: ignore[attr-defined]
        if not (
            isinstance(it, ast.Call)
            and isinstance(target, ast.Tuple)
            and len(target.elts) == 2
        ):
            return False
        name = terminal_name(it.func)
        if name == "items" and isinstance(it.func, ast.Attribute):
            key_bits, val_bits = 0, bits
        elif name == "enumerate" and it.args:
            key_bits, val_bits = 0, self.expr_taint(it.args[0], env)
        else:
            return False
        self._assign(target.elts[0], key_bits, it, env)
        self._assign(target.elts[1], val_bits, it, env)
        return True

    # ------------------------------------------------------------- solver

    def _solve(self) -> None:
        seed_env: Env = {
            name: (bits, frozenset()) for name, bits in self.seed.items()
        }
        self._in = {self.cfg.entry: seed_env}
        work = [self.cfg.entry]
        while work:
            bid = work.pop(0)
            block = self.cfg.blocks[bid]
            env = dict(self._in.get(bid, {}))
            for stmt in block.stmts:
                self.transfer(stmt, env)
            for succ in block.succs:
                prev = self._in.get(succ)
                joined = _join(prev or {}, env) if prev is not None else env
                if prev is None or not _env_eq(prev, joined):
                    self._in[succ] = dict(joined)
                    if succ not in work:
                        work.append(succ)

    # ------------------------------------------------------------ queries

    def iter_states(self):
        """Yield ``(stmt, env_before, locks)`` for every statement with
        the converged in-state — the hook sink rules walk."""
        for block in self.cfg.blocks:
            env = dict(self._in.get(block.bid, {}))
            for stmt in block.stmts:
                yield stmt, dict(env), block.locks
                self.transfer(stmt, env)

    def return_taint(self) -> int:
        bits = 0
        for stmt, env, _locks in self.iter_states():
            if isinstance(stmt, ast.Return) and stmt.value is not None:
                bits |= self.expr_taint(stmt.value, env)
        return bits

    def defs_of(self, name: str, env: Env) -> List[ast.AST]:
        """The value expressions that may define ``name`` here."""
        _bits, def_ids = env.get(name, (0, frozenset()))
        return [self.defs[d] for d in def_ids if d in self.defs]


# ------------------------------------------------------------- summaries


class Summaries:
    """Interprocedural param→return taint summaries.

    ``flows(func_key)`` → the set of parameter NAMES whose taint
    reaches the function's return value.  Computed to a bounded
    fixpoint over the project call graph (cycles converge because the
    lattice only grows)."""

    MAX_PASSES = 4

    def __init__(self, project: Project, only: Optional[Set[str]] = None):
        self.project = project
        self._flows: Dict[str, Tuple[str, ...]] = {}
        keys = [
            k for k, i in project.functions.items()
            if (only is None or k in only) and len(i.params) <= 30
        ]
        for _ in range(self.MAX_PASSES):
            changed = False
            for key in keys:
                info = self.project.functions[key]
                flows = self._compute_one(info)
                if flows != self._flows.get(key):
                    self._flows[key] = flows
                    changed = True
            if not changed:
                break

    def flows(self, func_key: str) -> Tuple[str, ...]:
        return self._flows.get(func_key, ())

    def _compute_one(self, info: FuncInfo) -> Tuple[str, ...]:
        params = [p for p in info.params if p not in ("self", "cls")]
        seed = {p: (1 << (i + 1)) for i, p in enumerate(params[:29])}
        ana = TaintAnalysis(
            info, seed, eval_call=self._make_eval(info)
        )
        bits = ana.return_taint()
        return tuple(p for p in params[:29] if bits & seed[p])

    def _make_eval(self, caller: FuncInfo):
        def eval_call(call: ast.Call, arg_bits: List[int]) -> Optional[int]:
            target = self.project._resolve_callee(
                caller.module, caller, call.func
            )
            if target is None:
                return None
            flows = self._flows.get(target.key)
            if flows is None:
                return None
            return map_args_through(target, call, arg_bits, set(flows))

        return eval_call


def map_args_through(
    callee: FuncInfo,
    call: ast.Call,
    arg_bits: List[int],
    flow_params: Set[str],
) -> int:
    """Union of taint of the arguments that land on ``flow_params``."""
    params = list(callee.params)
    if params and params[0] in ("self", "cls") and isinstance(
        call.func, ast.Attribute
    ):
        params = params[1:]
    bits = 0
    for i, _arg in enumerate(call.args):
        if i < len(params) and params[i] in flow_params and i < len(arg_bits):
            bits |= arg_bits[i]
    kw_bits = arg_bits[len(call.args):]
    for j, kw in enumerate(call.keywords):
        if kw.arg in flow_params and j < len(kw_bits):
            bits |= kw_bits[j]
    return bits


def param_bindings(
    callee: FuncInfo, call: ast.Call
) -> List[Tuple[str, ast.AST]]:
    """(param_name, argument_expression) pairs for a resolved call."""
    params = list(callee.params)
    if params and params[0] in ("self", "cls") and isinstance(
        call.func, ast.Attribute
    ):
        params = params[1:]
    out: List[Tuple[str, ast.AST]] = []
    for i, arg in enumerate(call.args):
        if i < len(params):
            out.append((params[i], arg))
    for kw in call.keywords:
        if kw.arg:
            out.append((kw.arg, kw.value))
    return out


def propagate_traced_params(
    project: Project, summaries: Summaries
) -> Dict[str, Set[str]]:
    """Which parameters of which functions may carry TRACED values —
    the interprocedural seeding KL11x runs on.

    Starts from every jit root's non-static parameters and pushes
    taint through resolved calls: if a jit-reachable caller passes a
    tainted argument into ``helper(v)``, then ``v`` is traced inside
    ``helper`` too.  Monotonic, so the worklist terminates."""
    traced: Dict[str, Set[str]] = {}
    work: List[str] = []
    for key, info in project.functions.items():
        if info.is_jit_root:
            skip = set(info.static_params) | {"self", "cls"}
            t = {p for p in info.params if p not in skip}
            if t:
                traced[key] = t
                work.append(key)
    while work:
        key = work.pop()
        info = project.functions[key]
        seed = {p: TRACED for p in traced.get(key, ())}
        if not seed:
            continue
        ana = analysis_for(info, project, summaries, seed)
        for stmt, env, _locks in ana.iter_states():
            for sub in stmt_exprs(stmt):
                if not isinstance(sub, ast.Call):
                    continue
                target = project._resolve_callee(info.module, info, sub.func)
                if target is None or target.key == key:
                    continue
                grew = False
                for pname, arg in param_bindings(target, sub):
                    if pname in ("self", "cls"):
                        continue
                    if ana.expr_taint(arg, env) & TRACED:
                        cur = traced.setdefault(target.key, set())
                        if pname not in cur:
                            cur.add(pname)
                            grew = True
                if grew and target.key not in work:
                    work.append(target.key)
    return traced


def analysis_for(
    info: FuncInfo,
    project: Project,
    summaries: Summaries,
    seed: Dict[str, int],
) -> TaintAnalysis:
    """A TaintAnalysis wired to the project summaries for call taint."""

    def eval_call(call: ast.Call, arg_bits: List[int]) -> Optional[int]:
        target = project._resolve_callee(info.module, info, call.func)
        if target is None:
            return None
        flows = summaries.flows(target.key)
        if not flows:
            return 0 if target.key in summaries._flows else None
        return map_args_through(target, call, arg_bits, set(flows))

    return TaintAnalysis(info, seed, eval_call=eval_call)
