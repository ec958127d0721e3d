"""RDF data-format parsers (host-side): N-Triples(-star), Turtle(-star) and
N3 data — a copy of the pure-Python parse path of
``kolibrie_tpu/query/rdf_parsers.py`` (RDF/XML and the serializers are not
ported yet).

Parity: the reference's hand-rolled parsers in
``kolibrie/src/sparql_database.rs`` — ``parse_turtle`` (line-based with
``;``/``,`` shorthand + Turtle-star, :729), ``parse_n3`` (:1015),
``parse_ntriples`` (-star, :1076-1141).

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
from typing import Dict, Iterator, List, Optional, Tuple, Union

RDF_TYPE = "http://www.w3.org/1999/02/22-rdf-syntax-ns#type"

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
