"""The Reasoner (knowledge graph): facts + rules + inference entry points.

Port of ``kolibrie_tpu/reasoner/reasoner.py`` (parity:
``datalog/src/reasoning.rs:33-186`` and
``datalog/src/reasoning/materialisation/``).  The fact and rule API and the
forward fixpoints are here; the device fixpoint runs on ``device``, the CUDA
card unless the caller passes another.  Provenance, repairs, backward
chaining and constraints are later slices of the port and raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kolibrie_tpu_torch.backend import DeviceLike, resolve_device
from kolibrie_tpu_torch.core.dictionary import Dictionary
from kolibrie_tpu_torch.core.quoted import QuotedTripleStore
from kolibrie_tpu_torch.core.rule import Rule, check_rule_safety
from kolibrie_tpu_torch.core.rule_index import RuleIndex
from kolibrie_tpu_torch.core.store import ColumnarTripleStore
from kolibrie_tpu_torch.core.terms import Term, TriplePattern
from kolibrie_tpu_torch.core.triple import Triple


def _not_ported(name: str):
    raise NotImplementedError(f"{name} is not ported to kolibrie_tpu_torch yet")


class Reasoner:
    """Knowledge graph with forward inference.

    ``device`` is where the device fixpoint runs: the CUDA card unless the
    caller passes another (``device="cpu"`` in the tests)."""

    def __init__(
        self, dictionary: Optional[Dictionary] = None, device: DeviceLike = None
    ) -> None:
        self.device: torch.device = resolve_device(device)
        self.dictionary = dictionary if dictionary is not None else Dictionary()
        self.quoted = QuotedTripleStore()
        self.facts = ColumnarTripleStore(self.device)
        self.rules: List[Rule] = []
        self.rule_index = RuleIndex()
        self.probability_seeds: Dict[Tuple[int, int, int], float] = {}
        self._numeric_cache: Dict[int, Optional[float]] = {}

    @classmethod
    def from_arrays(
        cls, terms, s, p, o, quoted=None, device: DeviceLike = None
    ) -> "Reasoner":
        """A reasoner holding another's state: ``terms`` is the dictionary's
        term list in ID order (index 0 the NULL slot, ``None``), ``s``/``p``/
        ``o`` are the u32 fact columns and ``quoted`` an optional mapping
        quoted-triple ID -> ``(s, p, o)``.  Every ID keeps its value.  Rules
        are not carried: add them with :meth:`add_rule`."""
        r = cls(Dictionary.from_terms(terms), device=device)
        for qid, (qs, qp, qo) in sorted((quoted or {}).items()):
            if r.quoted.intern(int(qs), int(qp), int(qo)) != qid:
                raise ValueError(f"quoted-triple ID {qid:#x} is not dense")
        r.facts.add_batch(
            np.asarray(s, np.uint32), np.asarray(p, np.uint32), np.asarray(o, np.uint32)
        )
        return r

    # ------------------------------------------------------------ fact API

    def add_abox_triple(self, subject: str, predicate: str, object: str) -> Triple:
        t = Triple(
            self.dictionary.encode(subject),
            self.dictionary.encode(predicate),
            self.dictionary.encode(object),
        )
        self.facts.add_triple(t)
        return t

    def add_tagged_triple(
        self, subject: str, predicate: str, object: str, probability: float
    ) -> Triple:
        """Fact with an input probability, stored for provenance seeding
        (reasoning.rs:70)."""
        t = self.add_abox_triple(subject, predicate, object)
        self.probability_seeds[tuple(t)] = probability
        return t

    def insert_ground_triple(self, t: Triple) -> None:
        self.facts.add_triple(t)

    def query_abox(
        self,
        subject: Optional[str] = None,
        predicate: Optional[str] = None,
        object: Optional[str] = None,
    ) -> List[Triple]:
        def enc(x):
            if x is None:
                return None
            return self.dictionary.lookup(x)

        ids = [enc(subject), enc(predicate), enc(object)]
        if any(x is None and orig is not None for x, orig in zip(ids, (subject, predicate, object))):
            return []
        s, p, o = self.facts.match(s=ids[0], p=ids[1], o=ids[2])
        return [Triple(int(a), int(b), int(c)) for a, b, c in zip(s, p, o)]

    def decode_triple(self, t: Triple) -> Tuple[str, str, str]:
        d = self.dictionary
        return (
            d.decode_term(t.subject, self.quoted) or "",
            d.decode_term(t.predicate, self.quoted) or "",
            d.decode_term(t.object, self.quoted) or "",
        )

    # ------------------------------------------------------------ rule API

    def add_rule(self, rule: Rule) -> None:
        """Register without safety check (legacy API)."""
        self.rules.append(rule)
        self.rule_index.add_rule(rule)

    def try_add_rule(self, rule: Rule) -> bool:
        """Safety-checked registration (rules.rs:182-205)."""
        if not check_rule_safety(rule):
            return False
        self.add_rule(rule)
        return True

    def rule_from_strings(
        self,
        premises: List[Tuple[str, str, str]],
        conclusions: List[Tuple[str, str, str]],
        negative: Optional[List[Tuple[str, str, str]]] = None,
        filters: Optional[list] = None,
    ) -> Rule:
        """Convenience: build an ID-space rule from string patterns where
        terms starting with '?' are variables."""

        def term(x: str) -> Term:
            if x.startswith("?"):
                return Term.variable(x[1:])
            return Term.constant(self.dictionary.encode(x))

        def pat(t):
            return TriplePattern(term(t[0]), term(t[1]), term(t[2]))

        return Rule(
            premise=[pat(p) for p in premises],
            negative_premise=[pat(p) for p in (negative or [])],
            filters=list(filters or []),
            conclusion=[pat(c) for c in conclusions],
        )

    # ----------------------------------------------------------- inference

    def infer_new_facts(self) -> int:
        """Naive fixpoint (my_naive.rs:79-82 alias)."""
        from kolibrie_tpu_torch.reasoner.strategies import infer_naive

        return infer_naive(self)

    def infer_new_facts_semi_naive(self) -> int:
        from kolibrie_tpu_torch.reasoner.strategies import infer_semi_naive

        return infer_semi_naive(self)

    # facts below this size run the host path — a device round trip
    # outweighs a small numpy fixpoint
    _DEVICE_AUTO_MIN_FACTS = 50_000

    def infer_new_facts_semi_naive_parallel(self) -> int:
        """The vectorized strategy (the rebuild's analogue of
        semi_naive_parallel.rs).  Above a size threshold the fixpoint runs on
        the device (:mod:`kolibrie_tpu_torch.reasoner.device_fixpoint`);
        rules the device path can't express run the host strategy."""
        if len(self.facts) >= self._DEVICE_AUTO_MIN_FACTS:
            derived = self.infer_new_facts_device()
            if derived is not None:
                return derived
        from kolibrie_tpu_torch.reasoner.strategies import infer_semi_naive

        return infer_semi_naive(self)

    def infer_new_facts_device(self) -> Optional[int]:
        """Semi-naive fixpoint on :attr:`device`; ``None`` if the rule set
        can't be lowered."""
        from kolibrie_tpu_torch.reasoner.device_fixpoint import (
            infer_semi_naive_device,
        )

        return infer_semi_naive_device(self)

    def infer_new_facts_with_repairs(self) -> int:
        _not_ported("Reasoner.infer_new_facts_with_repairs")

    def infer_new_facts_with_provenance(self, provenance, tag_store=None):
        _not_ported("Reasoner.infer_new_facts_with_provenance")

    def backward_chaining(self, pattern: TriplePattern, max_depth: int = 10):
        _not_ported("Reasoner.backward_chaining")

    # ---------------------------------------------------------- constraints

    def add_constraint(self, constraint: Rule) -> None:
        _not_ported("Reasoner.add_constraint")

    def violates_constraints(self, facts=None) -> bool:
        _not_ported("Reasoner.violates_constraints")

    def compute_repairs(self):
        _not_ported("Reasoner.compute_repairs")

    def query_with_repairs(self, subject=None, predicate=None, object=None):
        _not_ported("Reasoner.query_with_repairs")

    def materialize_tags_as_rdf_star(self, tag_store, db=None) -> int:
        _not_ported("Reasoner.materialize_tags_as_rdf_star")

    # --------------------------------------------------------------- misc

    def numeric_value(self, term_id: int) -> Optional[float]:
        """Literal numeric value of a term (cached) for rule filters."""
        if term_id in self._numeric_cache:
            return self._numeric_cache[term_id]
        s = self.dictionary.decode(term_id)
        val: Optional[float] = None
        if s is not None:
            text = s
            if text.startswith('"'):
                end = text.find('"', 1)
                if end > 0:
                    text = text[1:end]
            try:
                val = float(text)
            except ValueError:
                val = None
        self._numeric_cache[term_id] = val
        return val

    def clone(self) -> "Reasoner":
        r = Reasoner(self.dictionary.clone(), device=self.device)
        r.quoted = self.quoted.clone()
        r.facts = self.facts.clone()
        r.rules = list(self.rules)
        for rule in r.rules:
            r.rule_index.add_rule(rule)
        r.probability_seeds = dict(self.probability_seeds)
        return r

    def __len__(self) -> int:
        return len(self.facts)
