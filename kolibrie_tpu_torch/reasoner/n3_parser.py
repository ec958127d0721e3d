"""N3 logic rule parser: ``{ premises } => { conclusions } .`` documents.

Parity: ``datalog/src/parser_n3_logic.rs`` — ``parse_n3_rule`` (:135),
``parse_n3_document`` multi-rule documents with a shared prefix block and
EOF validation (:227), and ``parse_n3_rules_for_sds`` (:286-360) which maps
predicate constants to their owning window IRIs (longest-prefix match) and
discovers output component IRIs for cross-window reasoning.

Copy of ``kolibrie_tpu/reasoner/n3_parser.py`` for the PyTorch port.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kolibrie_tpu_torch.core.rule import Rule
from kolibrie_tpu_torch.core.terms import Term, TriplePattern

_PREFIX_RE = re.compile(r"@prefix\s+([\w-]*):\s*<([^>]*)>\s*\.")
# Trailing '.' after a rule is optional, as in the reference's nom parser
# (its own benches write rules without one, parser_n3_logic.rs:135).
_RULE_RE = re.compile(r"\{(.*?)\}\s*=>\s*\{(.*?)\}\s*\.?", re.S)
_TERM_RE = re.compile(
    r"""\?(?P<var>[\w-]+)
      | <(?P<iri>[^>]*)>
      | "(?P<lit>(?:[^"\\]|\\.)*)"
      | (?P<pname>[\w-]*:[\w.-]+|a)
    """,
    re.VERBOSE,
)


class N3ParseError(ValueError):
    pass


def _strip_comments(text: str) -> str:
    """Remove ``# ...`` comments, but never a '#' inside ``<...>`` (fragment
    IRIs like rdf-syntax-ns#) or inside string literals."""
    out: List[str] = []
    in_iri = in_str = False
    skip = False
    for i, c in enumerate(text):
        if skip:
            if c == "\n":
                skip = False
                out.append(c)
            continue
        if in_str:
            out.append(c)
            if c == '"' and (i == 0 or text[i - 1] != "\\"):
                in_str = False
            continue
        if in_iri:
            out.append(c)
            if c == ">":
                in_iri = False
            continue
        if c == '"':
            in_str = True
        elif c == "<":
            in_iri = True
        elif c == "#":
            skip = True
            continue
        out.append(c)
    return "".join(out)


RDF_TYPE = "http://www.w3.org/1999/02/22-rdf-syntax-ns#type"


def _parse_term_str(text: str, prefixes: Dict[str, str]) -> Tuple[str, str]:
    """Returns (kind, value): kind 'var' or 'const' (value = full string)."""
    m = _TERM_RE.fullmatch(text.strip())
    if m is None:
        raise N3ParseError(f"bad N3 term {text!r}")
    if m.group("var") is not None:
        return "var", m.group("var")
    if m.group("iri") is not None:
        return "const", m.group("iri")
    if m.group("lit") is not None:
        return "const", f'"{m.group("lit")}"'
    pname = m.group("pname")
    if pname == "a":
        return "const", RDF_TYPE
    pfx, local = pname.split(":", 1)
    ns = prefixes.get(pfx)
    if ns is None:
        raise N3ParseError(f"undefined prefix {pfx + ':'!r}")
    return "const", ns + local


def _split_statements(block: str) -> List[str]:
    """Split on statement-terminating dots only — a '.' inside ``<...>`` or
    ``"..."`` (IRIs like foaf/0.1/, decimals) is NOT a separator; neither is
    a dot not followed by whitespace/end (prefixed-name internals)."""
    stmts: List[str] = []
    buf: List[str] = []
    in_iri = in_str = False
    n = len(block)
    for i, c in enumerate(block):
        if in_str:
            buf.append(c)
            if c == '"' and (i == 0 or block[i - 1] != "\\"):
                in_str = False
            continue
        if in_iri:
            buf.append(c)
            if c == ">":
                in_iri = False
            continue
        if c == '"':
            in_str = True
            buf.append(c)
            continue
        if c == "<":
            in_iri = True
            buf.append(c)
            continue
        if c == "." and (i + 1 >= n or block[i + 1] in " \t\r\n"):
            stmts.append("".join(buf))
            buf = []
            continue
        buf.append(c)
    if buf and "".join(buf).strip():
        stmts.append("".join(buf))
    return stmts


def _parse_patterns(
    block: str, prefixes: Dict[str, str]
) -> List[Tuple[Tuple[str, str], Tuple[str, str], Tuple[str, str]]]:
    out = []
    for stmt in _split_statements(block):
        stmt = stmt.strip()
        if not stmt:
            continue
        terms = []
        for m in _TERM_RE.finditer(stmt):
            if m.group("var") is not None:
                terms.append(("var", m.group("var")))
            elif m.group("iri") is not None:
                terms.append(("const", m.group("iri")))
            elif m.group("lit") is not None:
                terms.append(("const", f'"{m.group("lit")}"'))
            else:
                pname = m.group("pname")
                if pname == "a":
                    terms.append(("const", RDF_TYPE))
                else:
                    pfx, local = pname.split(":", 1)
                    ns = prefixes.get(pfx)
                    if ns is None:
                        raise N3ParseError(f"undefined prefix {pfx + ':'!r}")
                    terms.append(("const", ns + local))
        if len(terms) % 3 != 0:
            raise N3ParseError(f"statement {stmt!r} is not a triple")
        for i in range(0, len(terms), 3):
            out.append((terms[i], terms[i + 1], terms[i + 2]))
    return out


def _to_rule(reasoner_dict, premises, conclusions) -> Rule:
    def term(kv: Tuple[str, str]) -> Term:
        kind, val = kv
        if kind == "var":
            return Term.variable(val)
        return Term.constant(reasoner_dict.encode(val))

    def pat(t) -> TriplePattern:
        return TriplePattern(term(t[0]), term(t[1]), term(t[2]))

    return Rule(
        premise=[pat(p) for p in premises],
        conclusion=[pat(c) for c in conclusions],
    )


def parse_n3_rule(text: str, dictionary) -> Rule:
    """Parse a single ``{ ... } => { ... } .`` rule (with optional @prefix
    block) into an ID-space Rule."""
    rules = parse_n3_document(text, dictionary)
    if not rules:
        raise N3ParseError("no rule found")
    return rules[0]


def parse_n3_document(text: str, dictionary) -> List[Rule]:
    """Parse a multi-rule N3 document.  Validates that nothing but prefixes,
    comments, and rules appear (EOF validation, parser_n3_logic.rs:227)."""
    prefixes: Dict[str, str] = {}
    rest = _strip_comments(text)
    for m in _PREFIX_RE.finditer(rest):
        prefixes[m.group(1)] = m.group(2)
    rest_wo = _PREFIX_RE.sub("", rest)
    rules: List[Rule] = []
    for m in _RULE_RE.finditer(rest_wo):
        premises = _parse_patterns(m.group(1), prefixes)
        conclusions = _parse_patterns(m.group(2), prefixes)
        rules.append(_to_rule(dictionary, premises, conclusions))
    leftover = _RULE_RE.sub("", rest_wo).strip()
    if leftover:
        raise N3ParseError(f"unexpected content in N3 document: {leftover[:60]!r}")
    return rules


# --------------------------------------------------------------------------
# SDS (cross-window) variant
# --------------------------------------------------------------------------


@dataclass
class WindowContext:
    """Annotation context for cross-window reasoning: which window owns each
    predicate and which output components exist (parser_n3_logic.rs:286-360)."""

    window_iris: List[str] = field(default_factory=list)
    predicate_windows: Dict[str, str] = field(default_factory=dict)
    output_iris: List[str] = field(default_factory=list)


def parse_n3_rules_for_sds(
    text: str, dictionary, window_iris: List[str]
) -> Tuple[List[Rule], WindowContext]:
    """Parse rules whose predicate IRIs are prefixed by window IRIs; maps
    each predicate constant to its owning window (longest-prefix match) and
    collects non-window IRIs as output components."""
    prefixes: Dict[str, str] = {}
    clean = _strip_comments(text)
    for m in _PREFIX_RE.finditer(clean):
        prefixes[m.group(1)] = m.group(2)
    rest = _PREFIX_RE.sub("", clean)
    ctx = WindowContext(window_iris=list(window_iris))
    rules: List[Rule] = []
    for m in _RULE_RE.finditer(rest):
        premises = _parse_patterns(m.group(1), prefixes)
        conclusions = _parse_patterns(m.group(2), prefixes)
        rules.append(_to_rule(dictionary, premises, conclusions))
        for (sk, sv), (pk, pv), (ok_, ov) in premises + conclusions:
            if pk != "const":
                continue
            owner = None
            for w in sorted(window_iris, key=len, reverse=True):
                if pv.startswith(w):
                    owner = w
                    break
            if owner is not None:
                ctx.predicate_windows[pv] = owner
            else:
                # non-window component: candidate output IRI namespace
                base = pv.rsplit("/", 1)[0] + "/" if "/" in pv else pv
                if base not in ctx.output_iris and base not in window_iris:
                    ctx.output_iris.append(base)
    return rules, ctx
