"""Graphviz DOT export of a Reasoner's facts and rules.

Port of ``kolibrie_tpu/reasoner/to_dot.py`` (a copy, the imports rewritten).

Parity: ``datalog/src/reasoning/to_dot.rs:9-114`` — one node per distinct
subject/object ID (sorted, labelled with the decoded string), one ``shape=box``
node pair per rule (premise patterns / conclusion patterns), an edge per fact
labelled with its predicate, and a premise→conclusion edge per rule.
"""

from __future__ import annotations

from typing import List

from kolibrie_tpu_torch.core.terms import Term, TriplePattern


def _term_to_string(term: Term, dictionary, quoted_store=None) -> str:
    if term.is_variable:
        return str(term.value)
    if term.is_quoted:
        inner: TriplePattern = term.value
        parts = [
            _term_to_string(t, dictionary, quoted_store) for t in inner.terms()
        ]
        return "<< {} {} {} >>".format(*parts)
    return dictionary.decode_term(int(term.value), quoted_store) or ""


def _patterns_to_dot(patterns: List[TriplePattern], reasoner) -> str:
    lines = []
    for pat in patterns:
        s, p, o = (
            _term_to_string(t, reasoner.dictionary, reasoner.quoted)
            for t in pat.terms()
        )
        lines.append(f"({s}, {p}, {o})")
    return "\n".join(lines)


def _escape(label: str) -> str:
    return label.replace("\\", "\\\\").replace('"', '\\"')


def to_dot(reasoner) -> str:
    """Render the knowledge graph as a DOT digraph string."""
    out = ["digraph {\n"]
    dict_ = reasoner.dictionary
    facts = list(reasoner.facts)

    node_ids = sorted({t.subject for t in facts} | {t.object for t in facts})
    for node_id in node_ids:
        label = dict_.decode_term(node_id, reasoner.quoted) or str(node_id)
        out.append(f'{node_id} [label="{_escape(label)}"]\n')

    for i, rule in enumerate(reasoner.rules):
        out.append(
            f'Rule{i}_premise [label="{_escape(_patterns_to_dot(rule.premise, reasoner))}", shape=box]\n'
        )
        out.append(
            f'Rule{i}_conclusion [label="{_escape(_patterns_to_dot(rule.conclusion, reasoner))}", shape=box]\n'
        )

    out.append("\n")

    for t in facts:
        label = dict_.decode_term(t.predicate, reasoner.quoted) or str(t.predicate)
        out.append(f'{t.subject} -> {t.object} [label="{_escape(label)}"]\n')
    for i in range(len(reasoner.rules)):
        out.append(f"Rule{i}_premise -> Rule{i}_conclusion\n")

    out.append("}")
    return "".join(out)
