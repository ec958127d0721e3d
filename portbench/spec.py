"""Everything a cell is made of, found by name: the entry of
``BENCHMARK.json``, its configuration file, its traffic file, the loop
that the traffic file names (``loops/<loop>.py``), the rule file and the
query files.  A new configuration, mix, loop or metric is a new file and
a new entry; no file here changes for it."""

from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    """The workload ``name`` with its configuration and traffic mix
    loaded: ``{"workload", "config", "traffic"}``."""
    bench = benchmark()
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    return {
        "workload": work,
        "config": load_json(ROOT / conf["file"]),
        "traffic": load_json(HERE / "traffic" / f"{work['traffic']}.json"),
        "bench": bench,
    }


def loop(name: str):
    """The loop module ``loops/<name>.py``: ``run(c, seed, seconds, traced,
    dev)``, ``judge(c, out, ref)``, ``control(c, out)``, ``CONTROL``."""
    if not (HERE / "loops" / f"{name}.py").exists():
        raise KeyError(f"no loop {name!r} under portbench/loops/")
    return importlib.import_module(f"portbench.loops.{name}")


def expand(term: str, prefixes: Dict[str, str]) -> str:
    """A rule term as the store holds it: ``?x`` stays, ``a`` is rdf:type,
    ``pre:local`` expands."""
    if term.startswith("?"):
        return term
    if term == "a":
        return prefixes["rdf"] + "type"
    pre, sep, local = term.partition(":")
    if sep and pre in prefixes:
        return prefixes[pre] + local
    return term


def rules(config: dict) -> List[dict]:
    """The configuration's rules with every term expanded (empty without
    reasoning)."""
    if not config.get("rules"):
        return []
    doc = load_json(ROOT / config["rules"])
    pre = doc["prefixes"]
    return [
        {"if": [[expand(t, pre) for t in pt] for pt in r["if"]],
         "then": [expand(t, pre) for t in r["then"]], "axiom": r["axiom"]}
        for r in doc["rules"]
    ]


def query_text(name: str) -> str:
    return (HERE / "queries" / f"{name}.rq").read_text()


def constants(config: dict, query_names=()) -> List[str]:
    """Every IRI the rules and the queries name, placeholders aside."""
    from portbench.reference.bgp import parse

    out: List[str] = []
    for r in rules(config):
        for t in [*(x for pt in r["if"] for x in pt), *r["then"]]:
            if not t.startswith("?"):
                out.append(t)
    for q in query_names:
        for pt in parse(query_text(q))[1]:
            out.extend(v for k, v in pt if k == "iri" and "{" not in v)
    return list(dict.fromkeys(out))
