"""RDF data-format parsers (host-side): N-Triples(-star), Turtle(-star), N3
data, RDF/XML, and the N-Triples, Turtle and RDF/XML serializers — a copy
of ``kolibrie_tpu/query/rdf_parsers.py`` for the PyTorch port.

Parity: the reference's hand-rolled parsers in
``kolibrie/src/sparql_database.rs`` — ``parse_rdf`` (RDF/XML via quick-xml,
:401), ``parse_turtle`` (line-based with ``;``/``,`` shorthand + Turtle-star,
:729), ``parse_n3`` (:1015), ``parse_ntriples`` (-star, :1076-1141).

Terms are produced as strings and dictionary-encoded by the caller
(:class:`~kolibrie_tpu_torch.query.sparql_database.SparqlDatabase`):

- IRIs are stored **expanded, without angle brackets**;
- literals keep their quoted lexical form incl. ``@lang`` / ``^^datatype``
  suffix (datatype IRI expanded, unbracketed), e.g. ``"30"`` or
  ``"5.2"^^http://www.w3.org/2001/XMLSchema#decimal``;
- blank nodes as ``_:label``;
- quoted triples as nested ``("qt", s, p, o)`` tuples (RDF-star).
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from typing import Dict, Iterator, List, Optional, Tuple, Union

RDF_TYPE = "http://www.w3.org/1999/02/22-rdf-syntax-ns#type"
RDF_NS = "http://www.w3.org/1999/02/22-rdf-syntax-ns#"

# A parsed term: plain string, or ("qt", s, p, o) for a quoted triple.
ParsedTerm = Union[str, Tuple]
ParsedTriple = Tuple[ParsedTerm, ParsedTerm, ParsedTerm]


class RdfParseError(ValueError):
    def __init__(self, message: str, line: Optional[int] = None):
        super().__init__(f"line {line}: {message}" if line else message)
        self.line = line


# --------------------------------------------------------------------------
# Tokenizer shared by the Turtle-family parsers
# --------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
      (?P<comment>\#[^\n]*)
    | (?P<qt_open><<)
    | (?P<qt_close>>>)
    | (?P<iri><[^<>\s]*>)
    | (?P<literal>"(?:[^"\\]|\\.)*"(?:@[A-Za-z][A-Za-z0-9-]*|\^\^(?:<[^<>\s]*>|[A-Za-z_][\w.-]*:[\w.-]*))?)
    | (?P<sliteral>'(?:[^'\\]|\\.)*'(?:@[A-Za-z][A-Za-z0-9-]*|\^\^(?:<[^<>\s]*>|[A-Za-z_][\w.-]*:[\w.-]*))?)
    | (?P<blank>_:[\w-]+)
    | (?P<punct>[;,.\[\]()])
    | (?P<keyword>(?:@prefix|@base|[Pp][Rr][Ee][Ff][Ii][Xx]|[Bb][Aa][Ss][Ee])(?![\w:.-]))
    | (?P<num>[+-]?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)
    | (?P<bool>(?:true|false)(?![\w:.-]))
    | (?P<pname>[A-Za-z_][\w.-]*?:[\w.%-]*|:[\w.%-]*|[A-Za-z_][\w-]*)
    """,
    re.VERBOSE,
)

XSD = "http://www.w3.org/2001/XMLSchema#"


def _tokenize(data: str) -> Iterator[Tuple[str, str, int]]:
    """Yield (kind, text, line_no)."""
    line = 1
    pos = 0
    n = len(data)
    while pos < n:
        ch = data[pos]
        if ch in " \t\r":
            pos += 1
            continue
        if ch == "\n":
            line += 1
            pos += 1
            continue
        m = _TOKEN_RE.match(data, pos)
        if m is None:
            raise RdfParseError(f"unexpected character {data[pos]!r}", line)
        kind = m.lastgroup
        text = m.group()
        pos = m.end()
        line += text.count("\n")
        if kind == "comment":
            continue
        yield kind, text, line  # type: ignore[misc]


_ESCAPES = {
    "t": "\t",
    "n": "\n",
    "r": "\r",
    '"': '"',
    "'": "'",
    "\\": "\\",
    "b": "\b",
    "f": "\f",
}


def _unescape(s: str) -> str:
    if "\\" not in s:
        return s
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            if nxt in _ESCAPES:
                out.append(_ESCAPES[nxt])
                i += 2
                continue
            if nxt == "u" and i + 6 <= len(s):
                out.append(chr(int(s[i + 2 : i + 6], 16)))
                i += 6
                continue
            if nxt == "U" and i + 10 <= len(s):
                out.append(chr(int(s[i + 2 : i + 10], 16)))
                i += 10
                continue
        out.append(c)
        i += 1
    return "".join(out)


class _TurtleParser:
    """Recursive-descent Turtle(-star) parser producing ParsedTriples.

    Supports: @prefix/@base (and SPARQL-style PREFIX/BASE), prefixed names,
    IRIs, literals (lang tags, datatypes, numeric/boolean shorthand), ``a``,
    ``;`` / ``,`` predicate/object lists, blank nodes ``_:x`` and anonymous
    ``[]`` (incl. property lists), quoted triples ``<< s p o >>`` in subject
    or object position.
    """

    def __init__(self, data: str, prefixes: Optional[Dict[str, str]] = None):
        self.tokens = list(_tokenize(data))
        self.i = 0
        self.prefixes: Dict[str, str] = dict(prefixes or {})
        self.base = ""
        self.triples: List[ParsedTriple] = []
        self._bnode_counter = 0

    # --- token helpers

    def _peek(self):
        return self.tokens[self.i] if self.i < len(self.tokens) else (None, None, -1)

    def _next(self):
        tok = self._peek()
        self.i += 1
        return tok

    def _expect_punct(self, p: str):
        kind, text, line = self._next()
        if kind != "punct" or text != p:
            raise RdfParseError(f"expected {p!r}, got {text!r}", line)

    # --- term productions

    def _expand_iri(self, text: str) -> str:
        iri = text[1:-1]
        if self.base and not re.match(r"^[A-Za-z][\w+.-]*:", iri):
            return self.base + iri
        return iri

    def _expand_pname(self, text: str, line: int) -> str:
        if ":" in text:
            pfx, local = text.split(":", 1)
        else:
            raise RdfParseError(f"unknown keyword {text!r}", line)
        ns = self.prefixes.get(pfx)
        if ns is None:
            raise RdfParseError(f"undefined prefix {pfx + ':'!r}", line)
        return ns + local

    def _literal_value(self, text: str) -> str:
        quote = text[0]
        # find closing quote (respecting escapes)
        j = 1
        while j < len(text):
            if text[j] == "\\":
                j += 2
                continue
            if text[j] == quote:
                break
            j += 1
        lex = _unescape(text[1:j])
        suffix = text[j + 1 :]
        if suffix.startswith("^^"):
            dt = suffix[2:]
            if dt.startswith("<"):
                dt = self._expand_iri(dt)
            else:
                dt = self._expand_pname(dt, 0)
            return f'"{lex}"^^{dt}'
        if suffix.startswith("@"):
            return f'"{lex}"{suffix}'
        return f'"{lex}"'

    def _fresh_bnode(self) -> str:
        self._bnode_counter += 1
        return f"_:anon{self._bnode_counter}"

    def _parse_term(self, position: str) -> ParsedTerm:
        kind, text, line = self._next()
        if kind == "iri":
            return self._expand_iri(text)
        if kind in ("literal", "sliteral"):
            return self._literal_value(text)
        if kind == "blank":
            return text
        if kind == "num":
            dt = "integer" if re.fullmatch(r"[+-]?\d+", text) else "decimal"
            if "e" in text.lower():
                dt = "double"
            return f'"{text}"^^{XSD}{dt}'
        if kind == "bool":
            return f'"{text}"^^{XSD}boolean'
        if kind == "qt_open":
            s = self._parse_term("subject")
            p = self._parse_term("predicate")
            o = self._parse_term("object")
            k, t, l = self._next()
            if k != "qt_close":
                raise RdfParseError(f"expected '>>', got {t!r}", l)
            return ("qt", s, p, o)
        if kind == "punct" and text == "[":
            bnode = self._fresh_bnode()
            nk, nt, _ = self._peek()
            if nk == "punct" and nt == "]":
                self._next()
                return bnode
            self._parse_predicate_object_list(bnode)
            self._expect_punct("]")
            return bnode
        if kind == "pname":
            if text == "a" and position == "predicate":
                return RDF_TYPE
            return self._expand_pname(text, line)
        raise RdfParseError(f"unexpected token {text!r} in {position}", line)

    # --- statement productions

    def _parse_predicate_object_list(self, subject: ParsedTerm):
        while True:
            pred = self._parse_term("predicate")
            while True:
                obj = self._parse_term("object")
                self.triples.append((subject, pred, obj))
                k, t, _ = self._peek()
                if k == "punct" and t == ",":
                    self._next()
                    continue
                break
            k, t, _ = self._peek()
            if k == "punct" and t == ";":
                self._next()
                # allow trailing ';' before '.' or ']'
                k2, t2, _ = self._peek()
                if k2 == "punct" and t2 in (".", "]"):
                    break
                continue
            break

    def _parse_directive(self, keyword: str):
        kw = keyword.lower().lstrip("@")
        if kw == "prefix":
            k, t, line = self._next()
            if k != "pname" or not t.endswith(":"):
                # pname token may carry the local part; prefix decl needs "pfx:"
                if k == "pname" and ":" in t:
                    pass
                else:
                    raise RdfParseError(f"bad @prefix declaration near {t!r}", line)
            pfx = t[:-1] if t.endswith(":") else t.split(":", 1)[0]
            k2, iri, line2 = self._next()
            if k2 != "iri":
                raise RdfParseError(f"expected IRI in @prefix, got {iri!r}", line2)
            self.prefixes[pfx] = iri[1:-1]
        elif kw == "base":
            k2, iri, line2 = self._next()
            if k2 != "iri":
                raise RdfParseError(f"expected IRI in @base, got {iri!r}", line2)
            self.base = iri[1:-1]
        else:
            raise RdfParseError(f"unknown directive {keyword!r}")
        # optional trailing '.' (required for @prefix, absent for SPARQL PREFIX)
        k, t, _ = self._peek()
        if k == "punct" and t == ".":
            self._next()

    def parse(self) -> List[ParsedTriple]:
        while self.i < len(self.tokens):
            kind, text, line = self._peek()
            if kind == "keyword":
                self._next()
                self._parse_directive(text)
                continue
            subject = self._parse_term("subject")
            self._parse_predicate_object_list(subject)
            k, t, l = self._peek()
            if k == "punct" and t == ".":
                self._next()
            elif k is None:
                break
            else:
                raise RdfParseError(f"expected '.', got {t!r}", l)
        return self.triples


def parse_turtle(
    data: str, prefixes: Optional[Dict[str, str]] = None
) -> Tuple[List[ParsedTriple], Dict[str, str]]:
    """Parse Turtle(-star); returns (triples, prefix map)."""
    p = _TurtleParser(data, prefixes)
    triples = p.parse()
    return triples, p.prefixes


def parse_n3(
    data: str, prefixes: Optional[Dict[str, str]] = None
) -> Tuple[List[ParsedTriple], Dict[str, str]]:
    """Parse N3 *data* (the Turtle-compatible subset; rule blocks are handled
    by :mod:`kolibrie_tpu_torch.reasoner.n3_parser`)."""
    return parse_turtle(data, prefixes)


def parse_ntriples(data: str) -> List[ParsedTriple]:
    """Parse N-Triples(-star).  Line-oriented; full-IRI terms only."""
    p = _TurtleParser(data)
    return p.parse()


# --------------------------------------------------------------------------
# RDF/XML
# --------------------------------------------------------------------------


def _split_qname(tag: str) -> Tuple[str, str]:
    if tag.startswith("{"):
        ns, local = tag[1:].split("}", 1)
        return ns, local
    return "", tag


def parse_rdf_xml(data: str) -> List[ParsedTriple]:
    """Parse RDF/XML (streamed).  Supports rdf:Description / typed node
    elements, rdf:about / rdf:ID / rdf:nodeID, property elements with
    rdf:resource, literal content (rdf:datatype, xml:lang), and nested node
    elements.  Parity: ``sparql_database.rs:401-571`` (quick-xml streaming).
    """
    triples: List[ParsedTriple] = []
    root = ET.fromstring(data)
    rns, rlocal = _split_qname(root.tag)
    counter = [0]

    def fresh() -> str:
        counter[0] += 1
        return f"_:xml{counter[0]}"

    def node_subject(el: ET.Element) -> str:
        about = el.get(f"{{{RDF_NS}}}about")
        if about is not None:
            return about
        rid = el.get(f"{{{RDF_NS}}}ID")
        if rid is not None:
            return "#" + rid
        nid = el.get(f"{{{RDF_NS}}}nodeID")
        if nid is not None:
            return "_:" + nid
        return fresh()

    def parse_node(el: ET.Element) -> str:
        subj = node_subject(el)
        ns, local = _split_qname(el.tag)
        if not (ns == RDF_NS and local == "Description"):
            triples.append((subj, RDF_TYPE, ns + local))
        # non-rdf attributes are literal properties
        for attr, val in el.attrib.items():
            ans, alocal = _split_qname(attr)
            if ans in (RDF_NS, "http://www.w3.org/XML/1998/namespace") or ans == "":
                continue
            triples.append((subj, ans + alocal, f'"{val}"'))
        for prop in el:
            pns, plocal = _split_qname(prop.tag)
            pred = pns + plocal
            res = prop.get(f"{{{RDF_NS}}}resource")
            nid = prop.get(f"{{{RDF_NS}}}nodeID")
            if res is not None:
                triples.append((subj, pred, res))
            elif nid is not None:
                triples.append((subj, pred, "_:" + nid))
            elif len(prop):
                for child in prop:
                    triples.append((subj, pred, parse_node(child)))
            else:
                text = (prop.text or "").strip()
                dt = prop.get(f"{{{RDF_NS}}}datatype")
                lang = prop.get("{http://www.w3.org/XML/1998/namespace}lang")
                if dt:
                    triples.append((subj, pred, f'"{text}"^^{dt}'))
                elif lang:
                    triples.append((subj, pred, f'"{text}"@{lang}'))
                else:
                    triples.append((subj, pred, f'"{text}"'))
        return subj

    if rns == RDF_NS and rlocal == "RDF":
        for el in root:
            parse_node(el)
    else:
        parse_node(root)
    return triples


# --------------------------------------------------------------------------
# Serialization (store -> text); parity: sparql_database.rs:277-400
# --------------------------------------------------------------------------


def _escape_lex(lex: str) -> str:
    """N-Triples/Turtle string escaping for a raw lexical form."""
    return (
        lex.replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
        .replace("\r", "\\r")
        .replace("\t", "\\t")
    )


def format_term_nt(term: str) -> str:
    """Render a stored term string in N-Triples syntax.

    Stored literal lexical forms are raw/unescaped (see module docstring),
    so they are re-escaped here — otherwise a literal containing a quote or
    newline produces output no Turtle parser accepts.  Quoted triples
    re-bracket recursively: the decoded form carries bare inner IRIs
    (``<< http://a http://p http://o >>``), the syntactic form needs
    ``<< <http://a> <http://p> <http://o> >>``.
    """
    if term.startswith("_:"):
        return term
    if term.startswith('"'):
        lex, dt, lang = _parse_stored_literal(term)
        esc = _escape_lex(lex)
        if dt:
            return f'"{esc}"^^<{dt}>'
        if lang:
            return f'"{esc}"@{lang}'
        return f'"{esc}"'
    if term.startswith("<<"):
        from kolibrie_tpu_torch.query.sparql_database import split_quoted_triple_content

        parts = split_quoted_triple_content(term[2:-2].strip())
        if len(parts) == 3:
            return "<< " + " ".join(format_term_nt(p) for p in parts) + " >>"
        return term
    return f"<{term}>"


_LANG_TAG_RE = re.compile(r"^[A-Za-z]{1,8}(-[A-Za-z0-9]{1,8})*$")


def _parse_stored_literal(term: str) -> Tuple[str, Optional[str], Optional[str]]:
    """Split a stored literal ``"lex"``, ``"lex"^^dt`` or ``"lex"@lang`` into
    (lexical form, datatype IRI or None, language tag or None).

    The stored lexical form is raw/unescaped and may itself contain ``"``,
    ``@`` or ``^^`` — so suffixes are recognized only when anchored at the
    END of the term: a plain literal always ends with its closing quote, and
    a candidate datatype/lang suffix must itself be well-formed.
    """
    if term.endswith('"') and len(term) >= 2:
        return term[1:-1], None, None
    if '"^^' in term:
        lex, dt = term.rsplit('"^^', 1)
        if '"' not in dt and " " not in dt:
            return lex[1:], dt.strip("<>"), None
    if '"@' in term:
        lex, lang = term.rsplit('"@', 1)
        if _LANG_TAG_RE.match(lang):
            return lex[1:], None, lang
    return term[1:] if term.startswith('"') else term, None, None


_NCNAME_START_RE = re.compile(r"[A-Za-z_]")
# XML NCName (dots allowed anywhere after the first char)
_PN_LOCAL_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_.\-]*$")
# Turtle PN_LOCAL may not END with '.' (a trailing dot terminates the
# statement for conformant parsers)
_TTL_LOCAL_RE = re.compile(r"^[A-Za-z_]([A-Za-z0-9_.\-]*[A-Za-z0-9_\-])?$")


def _split_iri_qname(iri: str) -> Optional[Tuple[str, str]]:
    """Split an IRI into (namespace, NCName local part) for XML QName use.
    Prefers the fragment/last-slash boundary, then backs up until the local
    part starts with an NCName start char.  None if no valid split exists."""
    for sep in ("#", "/", ":"):
        idx = iri.rfind(sep)
        if idx < 0 or idx == len(iri) - 1:
            continue
        local = iri[idx + 1 :]
        if _PN_LOCAL_RE.match(local):
            return iri[: idx + 1], local
        # back up past leading non-NCName-start chars (e.g. digits)
        m = _NCNAME_START_RE.search(local)
        if m and _PN_LOCAL_RE.match(local[m.start() :]):
            cut = idx + 1 + m.start()
            return iri[:cut], iri[cut:]
    return None


def serialize_rdfxml(
    decoded_triples, prefixes: Optional[Dict[str, str]] = None
) -> str:
    """RDF/XML writer over decoded (s, p, o) term strings.

    Parity: ``kolibrie/src/sparql_database.rs:277-317`` ``generate_rdf_xml``
    — subject-grouped ``rdf:Description`` blocks with the database's prefix
    table as namespace declarations — but emits spec-valid XML the
    reference's string-template writer does not: predicate QName splitting
    with auto-declared namespaces, ``rdf:resource`` for IRI objects,
    ``rdf:nodeID`` for blank nodes, ``rdf:datatype``/``xml:lang`` literal
    attributes, and XML escaping.  Triples touching a quoted triple are
    skipped (RDF/XML has no RDF-star syntax; N-Triples/Turtle carry those).
    """
    from xml.sax.saxutils import escape, quoteattr

    ns_to_prefix: Dict[str, str] = {RDF_NS: "rdf"}
    iri_to_prefix = {v: k for k, v in (prefixes or {}).items() if k}
    auto = [0]

    def prefix_for(ns: str) -> str:
        pfx = ns_to_prefix.get(ns)
        if pfx is None:
            taken = set(ns_to_prefix.values())
            pfx = iri_to_prefix.get(ns)
            if pfx is not None and (pfx in taken or not _PN_LOCAL_RE.match(pfx)):
                pfx = None  # registered name unusable as an XML prefix here
            if pfx is None:
                # auto names must not collide with registered prefixes either
                while True:
                    auto[0] += 1
                    pfx = f"ns{auto[0]}"
                    if pfx not in taken and pfx not in iri_to_prefix.values():
                        break
            ns_to_prefix[ns] = pfx
        return pfx

    subjects: Dict[str, List[Tuple[str, str]]] = {}
    for s, p, o in decoded_triples:
        if "<<" in (s[:2], p[:2], o[:2]) or s.startswith('"'):
            continue  # not expressible in RDF/XML
        subjects.setdefault(s, []).append((p, o))

    body: List[str] = []
    for s in sorted(subjects):
        if s.startswith("_:"):
            body.append(f"  <rdf:Description rdf:nodeID={quoteattr(s[2:])}>")
        else:
            body.append(f"  <rdf:Description rdf:about={quoteattr(s)}>")
        for p, o in subjects[s]:
            split = _split_iri_qname(p)
            if split is None:
                # RDF/XML requires every predicate to be an XML QName; a
                # silent drop would lose data, so refuse (rdflib does too)
                raise ValueError(
                    f"predicate IRI not serializable as an XML QName: {p!r}"
                )
            ns, local = split
            qn = f"{prefix_for(ns)}:{local}"
            if o.startswith('"'):
                lex, dt, lang = _parse_stored_literal(o)
                attrs = ""
                if dt:
                    attrs = f" rdf:datatype={quoteattr(dt)}"
                elif lang:
                    attrs = f" xml:lang={quoteattr(lang)}"
                body.append(f"    <{qn}{attrs}>{escape(lex)}</{qn}>")
            elif o.startswith("_:"):
                body.append(f"    <{qn} rdf:nodeID={quoteattr(o[2:])}/>")
            else:
                body.append(f"    <{qn} rdf:resource={quoteattr(o)}/>")
        body.append("  </rdf:Description>")

    decls = [
        f"xmlns:{pfx}={quoteattr(ns)}"
        for ns, pfx in sorted(ns_to_prefix.items(), key=lambda kv: kv[1])
    ]
    head = "<rdf:RDF " + " ".join(decls) + ">"
    return "\n".join(['<?xml version="1.0" encoding="utf-8"?>', head, *body, "</rdf:RDF>"]) + "\n"


def serialize_turtle(
    decoded_triples, prefixes: Optional[Dict[str, str]] = None
) -> str:
    """Subject/predicate-grouped Turtle-star writer with prefix compaction
    and ``a`` for rdf:type.  Parity: ``sparql_database.rs:343-400``
    ``generate_turtle`` (BTreeMap grouping with ``;`` / ``,``)."""
    prefixes = prefixes or {}
    # longest-namespace-first so the most specific prefix wins
    by_len = sorted(
        ((v, k) for k, v in prefixes.items() if k), key=lambda kv: -len(kv[0])
    )

    def compact(term: str) -> str:
        if term.startswith('"') or term.startswith("_:") or term.startswith("<<"):
            return format_term_nt(term)
        for ns, pfx in by_len:
            if term.startswith(ns):
                local = term[len(ns):]
                if _TTL_LOCAL_RE.match(local):
                    return f"{pfx}:{local}"
        return f"<{term}>"

    subjects: Dict[str, Dict[str, List[str]]] = {}
    order: List[str] = []
    for s, p, o in decoded_triples:
        if s not in subjects:
            subjects[s] = {}
            order.append(s)
        subjects[s].setdefault(p, []).append(o)

    lines = [f"@prefix {k}: <{v}> ." for k, v in sorted(prefixes.items()) if k]
    if lines:
        lines.append("")
    for s in order:
        s_str = compact(s)
        parts = []
        for p, objs in subjects[s].items():
            p_str = "a" if p == RDF_TYPE else compact(p)
            o_str = " , ".join(compact(o) for o in objs)
            parts.append(f"{p_str} {o_str}")
        lines.append(f"{s_str} " + " ;\n    ".join(parts) + " .")
    return "\n".join(lines) + "\n"
