"""Terms and triple patterns — the atoms of the rule ASTs.

Parity: ``shared/src/terms.rs:14-43`` — ``Term::{Variable, Constant, QuotedTriple}``
(RDF-star: a pattern position may hold a nested triple pattern) and
``TriplePattern``.  Copy of ``kolibrie_tpu/core/terms.py``, trimmed to what
the reasoner uses.
"""

from __future__ import annotations

from typing import NamedTuple, Set


class Term:
    """Tagged union: Variable(name) | Constant(u32 id) | QuotedTriple(pattern)."""

    __slots__ = ("kind", "value")

    VARIABLE = "var"
    CONSTANT = "const"
    QUOTED = "quoted"

    def __init__(self, kind: str, value):
        self.kind = kind
        self.value = value

    @staticmethod
    def variable(name: str) -> "Term":
        return Term(Term.VARIABLE, name)

    @staticmethod
    def constant(term_id: int) -> "Term":
        return Term(Term.CONSTANT, term_id)

    @staticmethod
    def quoted(pattern: "TriplePattern") -> "Term":
        return Term(Term.QUOTED, pattern)

    @property
    def is_variable(self) -> bool:
        return self.kind == Term.VARIABLE

    @property
    def is_constant(self) -> bool:
        return self.kind == Term.CONSTANT

    @property
    def is_quoted(self) -> bool:
        return self.kind == Term.QUOTED

    def variables(self) -> Set[str]:
        if self.kind == Term.VARIABLE:
            return {self.value}
        if self.kind == Term.QUOTED:
            return self.value.variables()
        return set()

    def __eq__(self, other):
        return (
            isinstance(other, Term)
            and self.kind == other.kind
            and self.value == other.value
        )

    def __hash__(self):
        return hash((self.kind, self.value))

    def __repr__(self):
        if self.kind == Term.VARIABLE:
            return f"?{self.value}"
        if self.kind == Term.CONSTANT:
            return f"#{self.value}"
        return f"<<{self.value!r}>>"


class TriplePattern(NamedTuple):
    subject: Term
    predicate: Term
    object: Term

    def variables(self) -> Set[str]:
        return self.subject.variables() | self.predicate.variables() | self.object.variables()

    def terms(self):
        return (self.subject, self.predicate, self.object)
