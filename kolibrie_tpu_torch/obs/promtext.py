"""Prometheus text exposition (v0.0.4): render and merge.

Extracted from :mod:`kolibrie_tpu_torch.obs.export` so the router — which
deliberately imports no query-engine code — can render its own registry
and merge scraped fleet exposition without pulling in the engine.
:mod:`export` re-exports :func:`render_prometheus` unchanged.

:func:`merge_prometheus` is the ``GET /fleet/metrics`` core: it takes
one exposition text per node, stamps every sample with a ``node`` label,
and regroups families so each appears once with a single HELP/TYPE pair
even when families overlap across nodes or carry disjoint label sets.

Copy of ``kolibrie_tpu/obs/promtext.py`` for the PyTorch port, its imports
rewritten.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List

from kolibrie_tpu_torch.obs import metrics
from kolibrie_tpu_torch.obs.metrics import Registry


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return (
        s.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')
    )


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def _labels_str(names, values, extra=()) -> str:
    pairs = [
        f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)
    ] + [f'{n}="{_escape_label(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def render_prometheus(registry: Registry = metrics.REGISTRY) -> str:
    """The registry in Prometheus text exposition format v0.0.4.
    Runs registered collectors first so pull-style gauges are fresh."""
    registry.run_collectors()
    lines: List[str] = []
    for fam in registry.families():
        lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for values, child in fam.children():
            if fam.kind in ("counter", "gauge"):
                lines.append(
                    f"{fam.name}{_labels_str(fam.label_names, values)} "
                    f"{_fmt_value(child.value)}"
                )
            else:  # histogram
                for le, acc in child.cumulative():
                    ls = _labels_str(
                        fam.label_names, values, extra=[("le", _fmt_value(le))]
                    )
                    lines.append(f"{fam.name}_bucket{ls} {acc}")
                base = _labels_str(fam.label_names, values)
                with child._lock:
                    s, c = child.sum, child.count
                lines.append(f"{fam.name}_sum{base} {_fmt_value(s)}")
                lines.append(f"{fam.name}_count{base} {c}")
    return "\n".join(lines) + "\n"


# -------------------------------------------------------------- fleet merge

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)(\s+\d+)?$"
)
_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def _family_of(sample_name: str, typed: Dict[str, str]) -> str:
    """Histogram/summary series names carry suffixes; map them back to
    the family that HELP/TYPE described."""
    if sample_name in typed:
        return sample_name
    for suf in _HIST_SUFFIXES:
        if sample_name.endswith(suf) and sample_name[: -len(suf)] in typed:
            return sample_name[: -len(suf)]
    return sample_name


def merge_prometheus(per_node: Dict[str, str]) -> str:
    """Merge one exposition text per node into a single text, stamping
    every sample with ``node="<name>"``.

    Families present on several nodes collapse to one HELP/TYPE header
    (first node's wording wins); families unique to one node pass
    through; samples with disjoint label sets coexist because each line
    keeps its own label string — the ``node`` label is prepended, which
    also disambiguates identical series scraped from different nodes.
    Unparseable lines are dropped rather than corrupting the merge.
    """
    order: List[str] = []  # family emission order, first-seen
    helps: Dict[str, str] = {}
    types: Dict[str, str] = {}
    samples: Dict[str, List[str]] = {}
    for node in sorted(per_node):
        text = per_node[node]
        typed: Dict[str, str] = {}
        for line in text.splitlines():
            line = line.strip()
            if line.startswith("# HELP "):
                rest = line[len("# HELP "):]
                name, _, help_text = rest.partition(" ")
                typed.setdefault(name, "")
                if name not in helps:
                    helps[name] = help_text
                continue
            if line.startswith("# TYPE "):
                rest = line[len("# TYPE "):]
                name, _, kind = rest.partition(" ")
                typed[name] = kind.strip()
                if name not in types:
                    types[name] = kind.strip()
                continue
            if not line or line.startswith("#"):
                continue
            m = _SAMPLE_RE.match(line)
            if m is None:
                continue
            sname, labels, value = m.group(1), m.group(2), m.group(3)
            fam = _family_of(sname, typed)
            node_pair = f'node="{_escape_label(node)}"'
            inner = labels[1:-1].strip() if labels else ""
            if inner:
                stamped = f"{sname}{{{node_pair},{inner}}} {value}"
            else:
                stamped = f"{sname}{{{node_pair}}} {value}"
            if fam not in samples:
                samples[fam] = []
                order.append(fam)
            samples[fam].append(stamped)
    lines: List[str] = []
    for fam in order:
        if fam in helps:
            lines.append(f"# HELP {fam} {helps[fam]}")
        if fam in types:
            lines.append(f"# TYPE {fam} {types[fam]}")
        lines.extend(samples[fam])
    return "\n".join(lines) + "\n"
