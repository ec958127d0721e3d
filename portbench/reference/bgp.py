"""Plain NumPy evaluation of a SELECT over one basic graph pattern, the
reference for the query cells: the answers as rows of display strings, one
row a solution (bag semantics)."""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from portbench.reference.store import ByPredicate, display_form, evaluate

_RDF_TYPE = "http://www.w3.org/1999/02/22-rdf-syntax-ns#type"
_TOKEN = re.compile(r'<[^>]*>|"[^"]*"|\?\w+|[A-Za-z][\w-]*:[\w-]*|\ba\b|\.')


def parse(text: str) -> Tuple[List[str], List[tuple]]:
    """``(projected variables, patterns)`` of a plain ``SELECT ?v ... WHERE
    { s p o . ... }``; pattern terms are ``("var", name)`` or ``("iri",
    text)``."""
    prefixes = dict(re.findall(r"PREFIX\s+([\w-]*):\s*<([^>]*)>", text))
    head, _, body = text.partition("WHERE")
    out = re.findall(r"\?(\w+)", head.split("SELECT", 1)[1])
    body = body[body.index("{") + 1: body.rindex("}")]
    terms: List[tuple] = []
    patterns: List[tuple] = []
    for tok in _TOKEN.findall(body):
        if tok == ".":
            continue
        if tok.startswith("?"):
            terms.append(("var", tok[1:]))
        elif tok.startswith("<"):
            terms.append(("iri", tok[1:-1]))
        elif tok.startswith('"'):
            terms.append(("iri", tok))
        elif tok == "a":
            terms.append(("iri", _RDF_TYPE))
        else:
            pre, _, local = tok.partition(":")
            terms.append(("iri", prefixes[pre] + local))
        if len(terms) == 3:
            patterns.append(tuple(terms))
            terms = []
    if terms:
        raise ValueError(f"a pattern with {len(terms)} terms")
    return out, patterns


def answer(text: str, source: ByPredicate, ids: Dict[str, int],
           terms: List[Optional[str]]) -> List[tuple]:
    """The rows of the SELECT ``text`` over ``source``."""
    out, patterns = parse(text)
    lowered = []
    for pt in patterns:
        low = []
        for kind, val in pt:
            if kind == "var":
                low.append(("var", val))
            elif val in ids:
                low.append(("id", ids[val]))
            else:
                return []  # a constant the data never holds: no solution
        lowered.append(tuple(low))
    b = evaluate(lowered, source)
    if not b or not len(next(iter(b.values()))):
        return []
    cols = [b[v] for v in out]
    uniq = np.unique(np.concatenate(cols))
    disp = {int(i): display_form(terms[int(i)]) for i in uniq}
    return [tuple(disp[int(x)] for x in row) for row in zip(*(c.tolist() for c in cols))]
