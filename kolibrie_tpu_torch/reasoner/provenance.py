"""Provenance semirings: how derived facts combine evidence.

Port of ``kolibrie_tpu/reasoner/provenance.py`` (a copy, the imports rewritten).

Parity: ``shared/src/provenance.rs`` — the ``Provenance`` trait (:18-59) and
its six implementations: MinMaxProbability (:69-104), AddMultProbability
(:111-146), BooleanProvenance (:153-188), TopKProofs (:203-320),
DnfWmcProvenance (:336-456, alias WmcProvenance), ExpirationProvenance
(:460-479).

Device note: the four scalar semirings (MinMax, AddMult, Boolean,
Expiration) have f64/u64 tags and run on the device as float64 columns
(:mod:`kolibrie_tpu_torch.reasoner.device_provenance`); TopK/DNF/SDD tags
are set/pointer structures and stay host-side.
"""

from __future__ import annotations

import itertools
from typing import FrozenSet, List, Optional, Set, Tuple


class Provenance:
    """Semiring interface.  Tags are immutable values; operations return new
    tags.  ``saturate``/``is_saturated`` short-circuit fixpoints for
    absorbing tags (e.g. probability 1.0)."""

    name = "abstract"

    def zero(self):
        raise NotImplementedError

    def one(self):
        raise NotImplementedError

    def disjunction(self, a, b):  # ⊕
        raise NotImplementedError

    def conjunction(self, a, b):  # ⊗
        raise NotImplementedError

    def negate(self, a):  # ⊖ (NAF)
        raise NotImplementedError

    def saturate(self, a):
        return a

    def is_saturated(self, a) -> bool:
        return False

    def tag_from_probability(self, p: float):
        raise NotImplementedError

    def tag_from_probability_with_id(self, p: float, seed_id: int):
        return self.tag_from_probability(p)

    def recover_probability(self, tag) -> float:
        raise NotImplementedError

    def tag_eq(self, a, b) -> bool:
        return a == b

    def is_zero(self, tag) -> bool:
        return self.tag_eq(tag, self.zero())


class MinMaxProbability(Provenance):
    """Fuzzy / possibilistic: ⊕ = max, ⊗ = min, ⊖ = 1 - p."""

    name = "minmax"

    def zero(self):
        return 0.0

    def one(self):
        return 1.0

    def disjunction(self, a, b):
        return max(a, b)

    def conjunction(self, a, b):
        return min(a, b)

    def negate(self, a):
        return 1.0 - a

    def is_saturated(self, a):
        return a >= 1.0

    def tag_from_probability(self, p):
        return float(p)

    def recover_probability(self, tag):
        return float(tag)


class AddMultProbability(Provenance):
    """Independence assumption: ⊗ = product, ⊕ = noisy-OR (a+b-ab)."""

    name = "addmult"

    def zero(self):
        return 0.0

    def one(self):
        return 1.0

    def disjunction(self, a, b):
        return a + b - a * b

    def conjunction(self, a, b):
        return a * b

    def negate(self, a):
        return 1.0 - a

    def is_saturated(self, a):
        return a >= 1.0

    def tag_from_probability(self, p):
        return float(p)

    def recover_probability(self, tag):
        return float(tag)

    def tag_eq(self, a, b):
        return abs(a - b) < 1e-12


class BooleanProvenance(Provenance):
    """Classical two-valued logic."""

    name = "boolean"

    def zero(self):
        return False

    def one(self):
        return True

    def disjunction(self, a, b):
        return a or b

    def conjunction(self, a, b):
        return a and b

    def negate(self, a):
        return not a

    def is_saturated(self, a):
        return a is True

    def tag_from_probability(self, p):
        return p > 0.0

    def recover_probability(self, tag):
        return 1.0 if tag else 0.0


class ExpirationProvenance(Provenance):
    """Tags are expiry timestamps: ⊕ = max (latest evidence wins), ⊗ = min
    (a derivation lives as long as its shortest-lived premise).  Powers
    cross-window incremental SDS+ (provenance.rs:460-479)."""

    name = "expiration"

    NEVER = 0  # zero: already expired
    FOREVER = 0xFFFF_FFFF_FFFF_FFFF  # one: static facts

    def zero(self):
        return ExpirationProvenance.NEVER

    def one(self):
        return ExpirationProvenance.FOREVER

    def disjunction(self, a, b):
        return max(a, b)

    def conjunction(self, a, b):
        return min(a, b)

    def negate(self, a):
        return ExpirationProvenance.FOREVER if a == ExpirationProvenance.NEVER else ExpirationProvenance.NEVER

    def is_saturated(self, a):
        return a == ExpirationProvenance.FOREVER

    def tag_from_probability(self, p):
        return ExpirationProvenance.FOREVER if p > 0 else ExpirationProvenance.NEVER

    def recover_probability(self, tag):
        return 1.0 if tag > 0 else 0.0


# --------------------------------------------------------------------------
# Proof-set semirings
# --------------------------------------------------------------------------

# A literal: (seed_id, polarity).  A proof (monomial): frozenset of literals.
Literal = Tuple[int, bool]
Proof = FrozenSet[Literal]


class _SeedWeighted:
    """Shared helper: seed probability registry for WMC over proof sets."""

    def __init__(self):
        self.seed_probs: dict = {}
        self._next_seed = 0

    def _alloc_seed(self, p: float, seed_id: Optional[int] = None) -> int:
        if seed_id is None:
            seed_id = self._next_seed
        self._next_seed = max(self._next_seed, seed_id + 1)
        self.seed_probs[seed_id] = p
        return seed_id


class TopKProofs(Provenance, _SeedWeighted):
    """Keep the k best proofs (by product probability); WMC by
    inclusion–exclusion over subsets of the kept proofs (k ≤ 63, ≤ 2^m
    subsets; provenance.rs:203-320).

    Tag = frozenset of proofs (each a frozenset of (seed_id, polarity)).
    """

    name = "topk"

    def __init__(self, k: int = 8):
        Provenance.__init__(self)
        _SeedWeighted.__init__(self)
        self.k = min(k, 63)

    def zero(self):
        return frozenset()

    def one(self):
        return frozenset([frozenset()])

    def _proof_prob(self, proof: Proof) -> float:
        p = 1.0
        for sid, pos in proof:
            sp = self.seed_probs.get(sid, 1.0)
            p *= sp if pos else (1.0 - sp)
        return p

    def _trim(self, proofs: Set[Proof]) -> FrozenSet[Proof]:
        # subsumption pruning: drop proofs that are supersets of another
        kept = [
            pr
            for pr in proofs
            if not any(other < pr for other in proofs)
        ]
        kept.sort(key=self._proof_prob, reverse=True)
        return frozenset(kept[: self.k])

    def disjunction(self, a, b):
        return self._trim(set(a) | set(b))

    def conjunction(self, a, b):
        out: Set[Proof] = set()
        for pa in a:
            for pb in b:
                merged = pa | pb
                # contradiction pruning: x and ¬x in one monomial
                seeds = {}
                contradict = False
                for sid, pos in merged:
                    if seeds.setdefault(sid, pos) != pos:
                        contradict = True
                        break
                if not contradict:
                    out.add(merged)
        return self._trim(out)

    def negate(self, a):
        # De Morgan over the kept proofs (bounded by k after each step)
        result = self.one()
        for proof in a:
            if not proof:
                return self.zero()
            alt = frozenset(frozenset([(sid, not pos)]) for sid, pos in proof)
            result = self.conjunction(result, self._trim(set(alt)))
        return result

    def tag_from_probability(self, p):
        sid = self._alloc_seed(p)
        return frozenset([frozenset([(sid, True)])])

    def tag_from_probability_with_id(self, p, seed_id):
        sid = self._alloc_seed(p, seed_id)
        return frozenset([frozenset([(sid, True)])])

    def recover_probability(self, tag) -> float:
        """Inclusion–exclusion over subsets of kept proofs (exact for the
        kept set).  P(∪ proofs) = Σ_{∅≠S} (-1)^{|S|+1} P(∧ S)."""
        proofs = list(tag)
        m = len(proofs)
        if m == 0:
            return 0.0
        total = 0.0
        for r in range(1, m + 1):
            for combo in itertools.combinations(range(m), r):
                merged: dict = {}
                contradict = False
                for i in combo:
                    for sid, pos in proofs[i]:
                        if merged.setdefault(sid, pos) != pos:
                            contradict = True
                            break
                    if contradict:
                        break
                if contradict:
                    continue
                p = 1.0
                for sid, pos in merged.items():
                    sp = self.seed_probs.get(sid, 1.0)
                    p *= sp if pos else (1.0 - sp)
                total += p if r % 2 == 1 else -p
        return min(max(total, 0.0), 1.0)


class DnfWmcProvenance(TopKProofs):
    """Exact DNF provenance with Shannon-expansion weighted model counting
    (provenance.rs:336-456; alias ``WmcProvenance``).  Same proof-set tag
    representation as TopK but untrimmed, with exact WMC."""

    name = "wmc"

    def __init__(self):
        super().__init__(k=10**9)
        self.k = 10**9
        self._wmc_memo: dict = {}

    def _trim(self, proofs: Set[Proof]) -> FrozenSet[Proof]:
        kept = [pr for pr in proofs if not any(o < pr for o in proofs)]
        return frozenset(kept)

    def recover_probability(self, tag) -> float:
        proofs = frozenset(tag)
        return self._wmc(proofs)

    def _wmc(self, proofs: FrozenSet[Proof]) -> float:
        """Shannon expansion on the most frequent variable, with memoization
        and subsumption/contradiction pruning."""
        if not proofs:
            return 0.0
        if frozenset() in proofs:
            return 1.0
        memo = self._wmc_memo.get(proofs)
        if memo is not None:
            return memo
        counts: dict = {}
        for pr in proofs:
            for sid, _pos in pr:
                counts[sid] = counts.get(sid, 0) + 1
        var = max(counts, key=lambda s: counts[s])
        p = self.seed_probs.get(var, 1.0)
        pos_branch: Set[Proof] = set()
        neg_branch: Set[Proof] = set()
        for pr in proofs:
            lits = dict(pr)
            if var in lits:
                rest = frozenset((s, b) for s, b in pr if s != var)
                if lits[var]:
                    pos_branch.add(rest)
                else:
                    neg_branch.add(rest)
            else:
                pos_branch.add(pr)
                neg_branch.add(pr)
        val = p * self._wmc(self._trim(pos_branch)) + (1 - p) * self._wmc(
            self._trim(neg_branch)
        )
        self._wmc_memo[frozenset(proofs)] = val
        return val

    def negate(self, a):
        """De Morgan: ¬(∨ monomials) = ∧ ¬monomial — expand to DNF."""
        result = self.one()
        for proof in a:
            if not proof:
                return self.zero()
            alt = frozenset(frozenset([(sid, not pos)]) for sid, pos in proof)
            result = self.conjunction(result, alt)
        return result


WmcProvenance = DnfWmcProvenance


def make_provenance(name: str, k: int = 8) -> Provenance:
    """Factory keyed by PROB combination names (post-normalization)."""
    if name == "minmax":
        return MinMaxProbability()
    if name == "addmult":
        return AddMultProbability()
    if name == "boolean":
        return BooleanProvenance()
    if name == "expiration":
        return ExpirationProvenance()
    if name == "topk":
        return TopKProofs(k)
    if name in ("wmc", "dnf"):
        return DnfWmcProvenance()
    if name == "sdd":
        from kolibrie_tpu_torch.reasoner.sdd import SddProvenance

        return SddProvenance()
    raise ValueError(f"unknown provenance semiring {name!r}")
