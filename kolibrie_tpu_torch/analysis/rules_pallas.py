"""Rule family 8: Pallas kernel discipline.

Every Mosaic kernel in the tree lives in ``kolibrie_tpu_torch/ops/`` behind the
``_pallas_call`` wrapper (x64 promotion off at trace time, interpret mode
off-TPU) — that containment is what lets the interpreter fallback, the
KOLIBRIE_PALLAS routing and the sublane/lane layout rules be audited in
one place.  A ``pl.pallas_call`` elsewhere escapes all three.

KL801  (a) a ``pallas_call`` call site outside ``kolibrie_tpu_torch/ops/`` —
       kernels belong in the ops package, launched through its
       ``_pallas_call`` wrapper;
       (b) a ``pl.BlockSpec`` whose block-shape tuple has a sublane
       dimension (second-to-last element, rank >= 2) that is not a
       multiple of 8 — Mosaic tiles f32/i32 as (8, 128), so a stray
       sublane size pads or miscompiles on real hardware while the
       CPU interpreter happily accepts it.  Dimensions that are not
       integer literals (after resolving module-level constant names)
       are invisible: conservative, no finding.

The port's counterpart: every hand-written CUDA kernel of
``kolibrie_tpu_torch/`` lives in ``ops/kernels.py`` behind a wrapper
that launches the kernel for a CUDA tensor, takes the kernel's plain
PyTorch version only for a CPU tensor, and counts each launch.  Package
code that reaches past the wrapper bypasses the kernel on the card and
its launch count.  Outside ``kolibrie_tpu_torch/ops/``, in package code
(test files — ``test_*.py``, ``conftest.py``, anything under ``tests/``
— hold kernels against their plain versions and are exempt), KL801 also
fires on:

       (a) a call to a kernel's plain version, the ``*_plain`` functions
       of ``ops/kernels.py`` (``merge_path_plain``,
       ``lex_probe_select_plain``, ``lex_probe_validate_plain``,
       ``filter_mask_plain``, ``tag_combine_plain``) — call the wrapper;
       (b) a call to a launch internal of ``ops/kernels.py`` (``_lib``,
       ``_arg``, ``_stream``, ``_check``, ``_ptr_table``) named through
       an import of that module — the public ``build_kernels`` and
       ``set_build_dir`` stay allowed;
       (c) a ``ctypes.CDLL`` or ``ctypes.cdll.LoadLibrary`` call outside
       ``ops/`` and ``native/``, the two sanctioned loaders.
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional

from kolibrie_tpu_torch.analysis.core import Finding, rule
from kolibrie_tpu_torch.analysis.project import (
    Project,
    SourceFile,
    dotted_name,
    walk,
)

_SUBLANE = 8

# ops/kernels.py: each kernel's plain PyTorch version, and the launch
# internals its wrappers share
_PLAIN_VERSIONS = frozenset({
    "merge_path_plain",
    "lex_probe_select_plain",
    "lex_probe_validate_plain",
    "filter_mask_plain",
    "tag_combine_plain",
})
_LAUNCH_INTERNALS = frozenset({"_lib", "_arg", "_stream", "_check", "_ptr_table"})
_LOADERS = frozenset({"ctypes.CDLL", "ctypes.cdll.LoadLibrary"})


def _in_dir(rel: str, name: str) -> bool:
    return f"/{name}/" in rel or rel.startswith(f"{name}/")


def _in_ops(rel: str) -> bool:
    return _in_dir(rel, "ops")


def _module_int_consts(tree: ast.Module) -> dict:
    """Module-level ``NAME = <int literal>`` bindings (the ``TILE = 128``
    idiom) — the only name resolution the shape check performs."""
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt, val = node.targets[0], node.value
            if isinstance(tgt, ast.Name):
                try:
                    v = ast.literal_eval(val)
                except (ValueError, TypeError, SyntaxError):
                    continue
                if isinstance(v, int) and not isinstance(v, bool):
                    out[tgt.id] = v
    return out


def _dim_value(node: ast.AST, consts: dict) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return None if isinstance(node.value, bool) else node.value
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    return None


def _is_pallas_call(call: ast.Call) -> bool:
    fn = call.func
    if isinstance(fn, ast.Name) and fn.id == "pallas_call":
        return True
    return isinstance(fn, ast.Attribute) and fn.attr == "pallas_call"


def _block_shape(call: ast.Call) -> Optional[ast.Tuple]:
    """The BlockSpec block-shape tuple literal, positional or keyword."""
    if call.args and isinstance(call.args[0], ast.Tuple):
        return call.args[0]
    for kw in call.keywords:
        if kw.arg == "block_shape" and isinstance(kw.value, ast.Tuple):
            return kw.value
    return None


def _is_test_file(rel: str) -> bool:
    base = os.path.basename(rel)
    if base.startswith("test_") or base == "conftest.py":
        return True
    return "tests" in rel.replace(os.sep, "/").split("/")


def _is_kernels_module(mod: Optional[str]) -> bool:
    return mod is not None and (
        mod == "ops.kernels" or mod.endswith(".ops.kernels")
    )


def _qualified(f: SourceFile, fn: ast.AST) -> Optional[str]:
    """A dotted callee with its head replaced by what an import binds it
    to (``K._lib`` after ``from kolibrie_tpu_torch.ops import kernels as
    K`` → ``kolibrie_tpu_torch.ops.kernels._lib``)."""
    name = dotted_name(fn)
    if name is None:
        return None
    head, _, rest = name.partition(".")
    if head in f.imports:
        bound = ".".join(f.imports[head])
    elif head in f.module_aliases and not (
        f.module_aliases[head] + "."
    ).startswith(head + "."):
        bound = f.module_aliases[head]
    else:
        return name  # unbound, or ``import a.b`` binding ``a`` itself
    return f"{bound}.{rest}" if rest else bound


def _port_containment(f: SourceFile, node: ast.Call) -> Optional[str]:
    """The port's KL801 message for a call outside ``ops/``, or None."""
    name = _qualified(f, node.func)
    if name is None:
        return None
    mod, _, callee = name.rpartition(".")
    if callee in _PLAIN_VERSIONS:
        return (
            f"{callee}() called outside kolibrie_tpu_torch/ops/ — a "
            "kernel's plain version bypasses the kernel on the card; call "
            "its wrapper, which takes the plain version only for CPU "
            "tensors"
        )
    if callee in _LAUNCH_INTERNALS and _is_kernels_module(mod):
        return (
            f"ops/kernels.py launch internal {callee}() called outside "
            "kolibrie_tpu_torch/ops/ — kernels launch through their "
            "wrappers, which count each launch"
        )
    if name in _LOADERS and not _in_dir(f.rel, "native"):
        return (
            f"{name}() outside kolibrie_tpu_torch/ops/ and native/ — "
            "shared libraries load only through those two loaders"
        )
    return None


@rule(
    "KL801",
    "Pallas containment: pallas_call outside kolibrie_tpu_torch/ops/, or a "
    "BlockSpec sublane dimension that is not a multiple of 8",
)
def pallas_discipline(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for f in project.files:
        if f.tree is None:
            continue
        consts = _module_int_consts(f.tree)
        port_checked = not (_in_ops(f.rel) or _is_test_file(f.rel))
        for node in walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            if _is_pallas_call(node) and not _in_ops(f.rel):
                out.append(
                    Finding(
                        "KL801",
                        f.rel,
                        node.lineno,
                        "pallas_call outside kolibrie_tpu_torch/ops/ — kernels "
                        "live in the ops package and launch through its "
                        "_pallas_call wrapper (x64-off trace, interpret "
                        "fallback, KOLIBRIE_PALLAS routing)",
                    )
                )
                continue
            msg = _port_containment(f, node) if port_checked else None
            if msg is not None:
                out.append(Finding("KL801", f.rel, node.lineno, msg))
                continue
            fn = node.func
            is_blockspec = (
                isinstance(fn, ast.Name) and fn.id == "BlockSpec"
            ) or (isinstance(fn, ast.Attribute) and fn.attr == "BlockSpec")
            if not is_blockspec:
                continue
            shape = _block_shape(node)
            if shape is None or len(shape.elts) < 2:
                continue  # 1-D / dynamic shapes: no sublane dimension
            sub = _dim_value(shape.elts[-2], consts)
            if sub is not None and sub % _SUBLANE != 0:
                out.append(
                    Finding(
                        "KL801",
                        f.rel,
                        node.lineno,
                        f"BlockSpec sublane dimension {sub} is not a "
                        "multiple of 8 — Mosaic tiles i32/f32 as "
                        "(8, 128); this block shape pads or miscompiles "
                        "on TPU even though the interpreter accepts it",
                    )
                )
    return out
