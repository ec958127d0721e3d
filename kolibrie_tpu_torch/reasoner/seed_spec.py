"""Probabilistic input-fact specifications.

Port of ``kolibrie_tpu/reasoner/seed_spec.py`` (a copy, the imports rewritten).

Parity: ``shared/src/seed_spec.rs:14-31`` — ``Independent{triple, prob,
seed_id}`` and ``ExclusiveGroup{group_id, choices}``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from kolibrie_tpu_torch.core.triple import Triple


@dataclass
class IndependentSeed:
    triple: Triple
    prob: float
    seed_id: Optional[int] = None


@dataclass
class ExclusiveGroupSeed:
    """Annotated disjunction: exactly one of the choices holds."""

    group_id: int
    choices: List[Tuple[Triple, float, Optional[int]]] = field(default_factory=list)
    # each choice: (triple, prob, seed_id)


SeedSpec = object  # IndependentSeed | ExclusiveGroupSeed
