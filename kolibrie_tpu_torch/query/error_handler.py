"""Annotated rendering of SPARQL parse errors.

Parity: ``kolibrie/src/error_handler.rs:14-259`` — converts a parse failure
into a compiler-style annotated snippet with line/column, a caret marking the
failing position, and a HELP footer when a common SPARQL mistake is detected:
SELECT without WHERE, unbalanced braces, unterminated string literal,
undefined prefix, and missing `.`/`;` separators between triple patterns.

Copy of ``kolibrie_tpu/query/error_handler.py`` for the PyTorch port.
"""

from __future__ import annotations

from typing import Optional, Tuple

from kolibrie_tpu_torch.query.parser import SparqlParseError

#: prefixes the reference treats as well-known (error_handler.rs:188)
_WELL_KNOWN_PREFIXES = {"rdf", "rdfs", "owl", "xsd", "foaf", "dc"}


def format_parse_error(source: str, err: SparqlParseError) -> str:
    """Render ``err`` (raised while parsing ``source``) as an annotated,
    multi-line message. Mirrors ``format_parse_error`` (error_handler.rs:14)."""
    line_no = max(err.line, 1)
    col_no = max(err.col, 1)
    lines = source.split("\n")
    error_line = (
        lines[line_no - 1] if line_no <= len(lines) else "[end of input]"
    )
    offset = sum(len(l) + 1 for l in lines[: line_no - 1]) + (col_no - 1)
    offset = min(offset, len(source))

    title = f"{err.message} at line {line_no}, column {col_no}"
    label = err.message
    footer = err.hint or None

    specific = detect_specific_sparql_error(source, offset)
    if specific is not None:
        title, label, footer = specific

    gutter = len(str(line_no))
    pad = " " * gutter
    caret_col = min(col_no, len(error_line) + 1)
    out = [
        f"error: {title}",
        f"{pad}--> query:{line_no}:{col_no}",
        f"{pad} |",
        f"{line_no} | {error_line}",
        f"{pad} | {' ' * (caret_col - 1)}^ {label}",
    ]
    if footer:
        out.append(f"{pad} = help: {footer}")
    return "\n".join(out)


def detect_specific_sparql_error(
    source: str, offset: int
) -> Optional[Tuple[str, str, str]]:
    """Heuristic detection of common SPARQL mistakes
    (error_handler.rs:135-180). Returns (title, label, help) or None."""
    lower = source.lower()

    if (
        "select" in lower
        and "where" not in lower
        and "insert" not in lower
    ):
        return (
            "SELECT query missing WHERE clause",
            "SELECT statement found but no WHERE clause",
            "SPARQL SELECT queries typically require a WHERE clause. "
            "Example: SELECT ?var WHERE { ?var ?pred ?obj }",
        )

    open_braces = source.count("{")
    close_braces = source.count("}")
    if open_braces != close_braces:
        return (
            "Unclosed brace in SPARQL query",
            "missing closing '}'" if open_braces > close_braces else "extra '}'",
            f"Found {open_braces} opening '{{' but {close_braces} "
            "closing '}' in the query",
        )

    before = source[:offset]
    if before.count('"') % 2 != 0:
        return (
            "Unterminated string literal",
            "string not closed with matching quote",
            "Make sure all string literals are properly closed with "
            "matching double quotes",
        )

    prefix_error = _check_missing_prefix(source, offset)
    if prefix_error is not None:
        return prefix_error

    return _check_missing_triple_separator(source, offset)


def _check_missing_prefix(
    source: str, offset: int
) -> Optional[Tuple[str, str, str]]:
    """error_handler.rs:183-216 — last token before the error uses an
    undeclared prefix."""
    declared = set(_WELL_KNOWN_PREFIXES)
    for line in source.split("\n"):
        stripped = line.strip()
        if stripped.upper().startswith("PREFIX "):
            parts = stripped.split()
            if len(parts) >= 2 and ":" in parts[1]:
                declared.add(parts[1][: parts[1].index(":")])

    words = source[:offset].split()
    if words:
        last = words[-1]
        if ":" in last and not last.startswith("<") and not last.startswith('"'):
            potential = last.split(":", 1)[0]
            if potential and not potential.startswith("?") and potential not in declared:
                return (
                    f"Undefined prefix '{potential}'",
                    f"prefix '{potential}' is not declared",
                    f"Add a PREFIX declaration like: PREFIX {potential}: "
                    "<http://example.org/>",
                )
    return None


def _check_missing_triple_separator(
    source: str, offset: int
) -> Optional[Tuple[str, str, str]]:
    """error_handler.rs:219-247 — two variables in a row with no `.`/`;`
    between pattern boundaries."""
    trimmed = source[:offset].rstrip()
    if "?" not in trimmed or not trimmed:
        return None
    last_char = trimmed[-1]
    if not (last_char.isalnum() or last_char == "_"):
        return None
    tail = trimmed[-10:]
    if "?" in tail and not any(c in tail for c in ".;{"):
        return (
            "Missing separator between triple patterns",
            "expected '.' or ';' to separate triple patterns",
            "Triple patterns in SPARQL should be separated by '.' or ';'",
        )
    return None
