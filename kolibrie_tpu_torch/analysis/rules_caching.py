"""Rule family 9: cache-key versioning discipline.

The store mutates in place (delta appends, base rebuilds), so any result
cache keyed on store *identity* — ``id(db)``, ``id(store)``, or the db /
store object itself — silently serves stale rows the moment a mutation
lands.  The sanctioned idiom (docs/MQO.md) is to fold the store's
version coordinates into the key: both ``base_version`` and
``delta_epoch``, or equivalently one ``store.version_key()`` call (which
compacts first and returns exactly that pair).  MQO's shared-prefix
cache was the motivating case; this rule keeps the next cache honest.

KL901  a cache/memo container subscript, ``.get`` or ``.setdefault``
       whose key expression carries store identity but neither both
       version components (``base_version`` AND ``delta_epoch``) nor a
       ``version_key()`` call.  Containers are recognized by name
       (``*cache*`` / ``*memo*``); identity is ``id(<db/store>)`` or a
       bare db/store object inside the key.  Keys that are plain
       strings/texts (no identity) are out of scope — identity-free
       keys cannot pin a stale store.

KL902  a learned-state ``*Advisor`` class keyed on the template
       fingerprint whose module defines an env-read mode flag
       (``*_mode()``) that participates in NO template fingerprint —
       not called inside any ``template_key``/``env_sig`` function and
       absent from every ``env_sig = (...)`` assignment.  A mode flag
       that gates *which plan a template gets* but stays out of the
       fingerprint lets an off-mode process replay a plan the advisor
       tuned (or vice versa) from a shared cache/manifest; the plan and
       the key disagree (docs/OPTIMIZER.md).  Advisors whose module has
       no mode function escape — state that is always-on (CapAdvisor's
       capacity high-water marks) cannot desync a fingerprint.
       Participation is checked across the analyzed file set, so run
       kolint over the package root, not a single file.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from kolibrie_tpu_torch.analysis.core import Finding, rule
from kolibrie_tpu_torch.analysis.project import Project, terminal_name, walk

_CONTAINER_HINTS = ("cache", "memo")
_STORE_NAMES = ("db", "store")
_KEYED_METHODS = ("get", "setdefault", "pop")


def _container_name(node: ast.AST) -> str:
    """Terminal name of a subscripted/called container, lowercased."""
    name = terminal_name(node)
    return (name or "").lower()


def _is_store_ref(node: ast.AST) -> bool:
    """A db/store object reference: ``db``, ``self.db``, ``x.store``…"""
    name = terminal_name(node)
    return name in _STORE_NAMES


def _key_has_identity(key: ast.AST) -> bool:
    """Does the key expression carry store identity?  Only DIRECT object
    references count: ``id(db)`` or the db/store object itself as a key
    element.  ``db.expand_term(x)`` / ``store.base_version`` read an
    attribute OF the store — the key holds the attribute's value, not
    the object, so they are not identity."""
    derived = set()  # nodes whose value is derived from, not equal to, db
    for node in ast.walk(key):
        if isinstance(node, ast.Attribute):
            derived.add(id(node.value))
        elif isinstance(node, ast.Call):
            derived.add(id(node.func))
    for node in ast.walk(key):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "id"
            and node.args
            and _is_store_ref(node.args[0])
        ):
            return True
        if isinstance(node, (ast.Name, ast.Attribute)) and _is_store_ref(
            node
        ):
            # the object itself as a key element hashes by identity
            # unless it defines content-based __hash__ — none of ours do
            if id(node) not in derived:
                return True
    return False


def _key_is_versioned(key: ast.AST) -> bool:
    """Both version components present, or a version_key() call."""
    names = set()
    for node in ast.walk(key):
        if isinstance(node, ast.Call):
            if terminal_name(node.func) == "version_key":
                return True
        if isinstance(node, (ast.Name, ast.Attribute)):
            names.add(terminal_name(node))
    return "base_version" in names and "delta_epoch" in names


def _key_expr(node: ast.AST) -> Optional[ast.AST]:
    """The key expression of a cache access, or None when ``node`` is
    not a recognized cache access."""
    if isinstance(node, ast.Subscript):
        if any(h in _container_name(node.value) for h in _CONTAINER_HINTS):
            return node.slice
        return None
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        if node.func.attr in _KEYED_METHODS and node.args:
            if any(
                h in _container_name(node.func.value)
                for h in _CONTAINER_HINTS
            ):
                return node.args[0]
    return None


@rule(
    "KL901",
    "cache keyed on store identity without (base_version, delta_epoch) "
    "— serves stale rows after any mutation; fold store.version_key() "
    "into the key (docs/MQO.md)",
)
def unversioned_store_cache_key(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for f in project.files:
        if f.tree is None:
            continue
        for info in f.functions.values():
            # one level of local-binding resolution: `key = (id(db), fp)`
            # then `cache[key]` — the common shape.  Multiple assignments
            # to one name are merged conservatively (any unversioned
            # identity-carrying binding flags the access).
            bindings = {}
            for node in walk(info.node):
                if isinstance(node, ast.Assign):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            bindings.setdefault(tgt.id, []).append(
                                node.value
                            )
            for node in walk(info.node):
                key = _key_expr(node)
                if key is None:
                    continue
                if isinstance(key, ast.Name) and key.id in bindings:
                    exprs = bindings[key.id]
                    if any(
                        _key_has_identity(e) and not _key_is_versioned(e)
                        for e in exprs
                    ):
                        key = next(
                            e for e in exprs if _key_has_identity(e)
                        )
                    else:
                        continue
                if not _key_has_identity(key):
                    continue
                if _key_is_versioned(key):
                    continue
                out.append(
                    Finding(
                        "KL901",
                        f.rel,
                        node.lineno,
                        "cache key carries store identity but no "
                        "(base_version, delta_epoch) — a mutation leaves "
                        "the entry live and stale; append "
                        "store.version_key() to the key",
                        scope=info.qualname,
                    )
                )
    return out


# --------------------------------------------------------------- KL902

_FP_PARAMS = ("fp", "fingerprint", "template_fp")


def _reads_env(fn_node: ast.AST) -> bool:
    """Does this function read process environment (``os.environ`` /
    ``getenv``)?  That is what makes a ``*_mode()`` a routing flag."""
    for node in walk(fn_node):
        if isinstance(node, (ast.Name, ast.Attribute)):
            if terminal_name(node) == "environ":
                return True
        if isinstance(node, ast.Call):
            if terminal_name(node.func) == "getenv":
                return True
    return False


def _module_mode_functions(f) -> dict:
    """Module-level env-reading ``*_mode`` defs: name → lineno."""
    out = {}
    for qual, info in f.functions.items():
        if "." in qual or not qual.endswith("_mode"):
            continue
        if _reads_env(info.node):
            out[qual] = info.node.lineno
    return out


def _participating_names(project: Project) -> set:
    """Call names that ride a template fingerprint anywhere in the
    analyzed set: calls inside a ``template_key``/``env_sig`` function,
    or inside the value of an ``env_sig = (...)`` assignment."""
    names = set()

    def collect_calls(node: ast.AST) -> None:
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                t = terminal_name(n.func)
                if t:
                    names.add(t)

    for f in project.files:
        if f.tree is None:
            continue
        for qual, info in f.functions.items():
            if qual.rsplit(".", 1)[-1] in ("template_key", "env_sig"):
                collect_calls(info.node)
        for node in walk(f.tree):
            if isinstance(node, ast.Assign):
                if any(
                    "env_sig" in (terminal_name(t) or "")
                    for t in node.targets
                ):
                    collect_calls(node.value)
    return names


def _fp_keyed_advisors(f) -> list:
    """ClassDefs named ``*Advisor*`` with a method taking a
    fingerprint-ish parameter: (name, lineno) pairs."""
    out = []
    for node in walk(f.tree):
        if not isinstance(node, ast.ClassDef) or "Advisor" not in node.name:
            continue
        keyed = any(
            info.class_name == node.name
            and any(p in _FP_PARAMS for p in info.params)
            for info in f.functions.values()
        )
        if keyed:
            out.append((node.name, node.lineno))
    return out


@rule(
    "KL902",
    "learned-state advisor keyed on template fingerprint whose mode "
    "flag is outside the fingerprint — an off-mode process replays "
    "tuned plans (or tuned processes replay static ones) from shared "
    "caches; call the *_mode() inside template_key / env_sig "
    "(docs/OPTIMIZER.md)",
)
def advisor_mode_outside_fingerprint(project: Project) -> List[Finding]:
    out: List[Finding] = []
    participating = _participating_names(project)
    for f in project.files:
        if f.tree is None:
            continue
        advisors = _fp_keyed_advisors(f)
        if not advisors:
            continue
        modes = _module_mode_functions(f)
        if not modes or any(name in participating for name in modes):
            continue
        mode_names = ", ".join(sorted(modes))
        for cls, lineno in advisors:
            out.append(
                Finding(
                    "KL902",
                    f.rel,
                    lineno,
                    f"{cls} keys learned state on the template "
                    f"fingerprint but its mode flag ({mode_names}) "
                    "participates in no fingerprint — fold the mode "
                    "into template_key/env_sig so off-mode processes "
                    "never replay tuned plans",
                    scope=cls,
                )
            )
    return out
