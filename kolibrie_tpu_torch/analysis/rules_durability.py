"""Rule family 7: durable-write discipline.

Crash safety (docs/DURABILITY.md) hinges on one idiom: durable files
are written temp → fsync → rename, never in place.  The sanctioned
choke points live in ``kolibrie_tpu_torch/durability/fsio.py``
(``atomic_write`` / ``atomic_write_bytes`` / ``atomic_rename_dir``); a
bare ``open(path, "wb")`` on a durable path is exactly the torn-write
bug the WAL scanner exists to clean up after — except snapshots and
manifests get no CRC-scan second chance.

KL701  a write-mode ``open()`` call in a durability-tagged module
       (anything under ``kolibrie_tpu_torch/durability/`` or any module
       carrying a ``# kolint: durable-path`` marker comment).
       ``fsio.py`` itself is exempt — it IS the idiom.  Append-mode
       WAL segment streams carry an explicit suppression with the
       reason (``# kolint: ignore[KL701] ...``).

KL702  WAL frame parsing outside the sanctioned packages.  The
       ``KWALSEG1`` frame layout (u32 len | u32 crc | payload) is owned
       by ``durability/wal.py`` and shared with ``replication/`` (the
       ship protocol IS the frame format); everyone else goes through
       the frame API — ``wal.read_frame`` / ``wal.encode_record`` /
       ``wal.scan_segment_file`` — so a layout change (or the CRC/
       truncation discipline) has exactly one home.  Flagged: importing
       underscore internals from ``durability.wal``, and raw
       ``struct.unpack``/``Struct(...)`` calls in a module that names
       the ``KWALSEG`` magic.
"""

from __future__ import annotations

import ast
from typing import List

from kolibrie_tpu_torch.analysis.core import Finding, rule
from kolibrie_tpu_torch.analysis.project import Project, terminal_name, walk

_MARKER = "durable-path"
_WRITE_CHARS = ("w", "a", "x", "+")


def _is_durability_tagged(f) -> bool:
    if f.rel.endswith("/fsio.py") or f.rel == "fsio.py":
        return False  # the sanctioned choke point itself
    if "/durability/" in f.rel or f.rel.startswith("durability/"):
        return True
    # `# kolint: durable-path` anywhere in the module opts it in
    return any(
        "kolint:" in c and _MARKER in c for c in f.comments.values()
    )


def _write_mode(call: ast.Call) -> str:
    """The mode-string literal of an ``open()`` call if it requests
    writing, else ''.  Non-literal modes are invisible (conservative:
    no finding)."""
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    else:
        for kw in call.keywords:
            if kw.arg == "mode":
                mode = kw.value
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        if any(ch in mode.value for ch in _WRITE_CHARS):
            return mode.value
    return ""


@rule(
    "KL701",
    "bare write-mode open() in a durability-tagged module — durable "
    "files must go temp → fsync → rename via durability/fsio.py",
)
def durable_write_path(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for f in project.files:
        if f.tree is None or not _is_durability_tagged(f):
            continue
        for node in walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            is_open = (isinstance(fn, ast.Name) and fn.id == "open") or (
                isinstance(fn, ast.Attribute)
                and fn.attr == "open"
                and isinstance(fn.value, ast.Name)
                and fn.value.id in ("io", "os")
            )
            if not is_open:
                continue
            mode = _write_mode(node)
            if not mode:
                continue
            out.append(
                Finding(
                    "KL701",
                    f.rel,
                    node.lineno,
                    f"open(..., {mode!r}) writes a durable path in place "
                    "— use fsio.atomic_write/atomic_write_bytes "
                    "(temp → fsync → rename) so a crash never tears it",
                )
            )
    return out


_FRAME_ZONE = ("durability/", "replication/")
_UNPACK_NAMES = ("unpack", "unpack_from", "iter_unpack", "Struct")


def _in_frame_zone(f) -> bool:
    return any(
        f"/{zone}" in f.rel or f.rel.startswith(zone) for zone in _FRAME_ZONE
    )


def _names_wal_magic(f) -> bool:
    """The module mentions the ``KWALSEG`` segment magic in a literal —
    the telltale of hand-rolled frame parsing."""
    for node in walk(f.tree):
        if isinstance(node, ast.Constant):
            v = node.value
            if isinstance(v, bytes):
                try:
                    v = v.decode("ascii")
                except UnicodeDecodeError:
                    continue
            if isinstance(v, str) and "KWALSEG" in v:
                return True
    return False


@rule(
    "KL702",
    "WAL frame bytes parsed outside durability/ + replication/ — go "
    "through the frame API (wal.read_frame / wal.encode_record / "
    "wal.scan_segment_file) so the KWALSEG1 layout has one owner",
)
def wal_frame_api(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for f in project.files:
        if f.tree is None or _in_frame_zone(f):
            continue
        # (a) importing the wal module's underscore internals (_FRAME,
        # _META_LEN, _scan_segment, ...) couples the importer to layout
        for node in walk(f.tree):
            if (
                isinstance(node, ast.ImportFrom)
                and node.module
                and node.module.endswith("durability.wal")
            ):
                for alias in node.names:
                    if alias.name.startswith("_"):
                        out.append(
                            Finding(
                                "KL702",
                                f.rel,
                                node.lineno,
                                f"importing frame internal "
                                f"{alias.name!r} from durability.wal — "
                                "use the public frame API "
                                "(read_frame/encode_record/"
                                "scan_segment_file)",
                            )
                        )
        # (b) raw struct unpacking in a module that names the magic:
        # hand-rolled KWALSEG1 parsing that will rot when the layout,
        # CRC, or truncation discipline changes
        if not _names_wal_magic(f):
            continue
        for node in walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            name = terminal_name(node.func)
            if name in _UNPACK_NAMES:
                out.append(
                    Finding(
                        "KL702",
                        f.rel,
                        node.lineno,
                        f"raw struct {name}() beside the KWALSEG magic — "
                        "WAL frames are read via wal.read_frame / "
                        "wal.scan_segment_file, never unpacked by hand "
                        "outside durability/ + replication/",
                    )
                )
    return out
