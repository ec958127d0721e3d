"""Sentential Decision Diagram engine with a right-linear vtree.

Port of ``kolibrie_tpu/reasoner/sdd.py`` (a copy, the imports rewritten).

Parity: ``shared/src/sdd.rs`` — arena ``SddManager`` with unique table +
apply/negate caches (:85-167), compression (:276-352), ``apply`` (:390-500),
``negate`` (:598-620), ``wmc`` (:623-655), ``enumerate_models`` (:661-692),
``exactly_one`` annotated-disjunction encoding (:175-193), ``VarKind``
Independent/ExclusiveGroup with separate pos/neg literal weights (:75-79,
125-167), and ``SddProvenance`` (tags = node IDs, :705-777).

An SDD over a right-linear vtree is structurally an ordered decision diagram,
so the manager is implemented as a reduced OBDD arena: decision nodes
``(var, hi, lo)`` hash-consed in a unique table.  WMC applies the
(w_pos + w_neg) correction for variables skipped between decision levels so
ExclusiveGroup weights (pos=p_i, neg=1) count correctly.

This pointer-chasing structure is inherently host-side (SURVEY §7 "hard
parts"); the device sees only the resulting probabilities/gradients.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

FALSE = 0
TRUE = 1


@dataclass
class VarInfo:
    """Weight + grouping info for one SDD variable."""

    index: int  # decision order
    w_pos: float
    w_neg: float
    kind: str = "independent"  # "independent" | "exclusive"
    group_id: Optional[int] = None
    seed_id: Optional[int] = None


class SddManager:
    """Hash-consed decision-diagram arena."""

    def __init__(self) -> None:
        # nodes[i] = (var, hi, lo); ids 0/1 reserved for terminals
        self.nodes: List[Tuple[int, int, int]] = [(-1, 0, 0), (-1, 1, 1)]
        self.unique: Dict[Tuple[int, int, int], int] = {}
        self.apply_cache: Dict[Tuple[int, int, str], int] = {}
        self.negate_cache: Dict[int, int] = {}
        self.vars: List[VarInfo] = []
        self._group_members: Dict[int, List[int]] = {}

    # ------------------------------------------------------------ variables

    def new_var(
        self,
        w_pos: float = 0.5,
        w_neg: Optional[float] = None,
        kind: str = "independent",
        group_id: Optional[int] = None,
        seed_id: Optional[int] = None,
    ) -> int:
        """Allocate a variable; returns its var index (decision order)."""
        idx = len(self.vars)
        if w_neg is None:
            w_neg = 1.0 - w_pos if kind == "independent" else 1.0
        self.vars.append(VarInfo(idx, w_pos, w_neg, kind, group_id, seed_id))
        if group_id is not None:
            self._group_members.setdefault(group_id, []).append(idx)
        return idx

    def literal(self, var: int, positive: bool = True) -> int:
        if positive:
            return self._mk(var, TRUE, FALSE)
        return self._mk(var, FALSE, TRUE)

    # ---------------------------------------------------------- construction

    def _mk(self, var: int, hi: int, lo: int) -> int:
        if hi == lo:  # trimming rule
            return hi
        key = (var, hi, lo)
        nid = self.unique.get(key)
        if nid is None:
            nid = len(self.nodes)
            self.nodes.append(key)
            self.unique[key] = nid
        return nid

    def _var_of(self, nid: int) -> int:
        return self.nodes[nid][0]

    def apply(self, a: int, b: int, op: str) -> int:
        """op in {"and", "or"} — O(|a||b|) with memoization (sdd.rs:390)."""
        if op == "and":
            if a == FALSE or b == FALSE:
                return FALSE
            if a == TRUE:
                return b
            if b == TRUE:
                return a
        else:
            if a == TRUE or b == TRUE:
                return TRUE
            if a == FALSE:
                return b
            if b == FALSE:
                return a
        if a == b:
            return a
        if a > b:
            a, b = b, a
        key = (a, b, op)
        hit = self.apply_cache.get(key)
        if hit is not None:
            return hit
        va, vb = self._var_of(a), self._var_of(b)
        if va == vb:
            _, ahi, alo = self.nodes[a]
            _, bhi, blo = self.nodes[b]
            res = self._mk(va, self.apply(ahi, bhi, op), self.apply(alo, blo, op))
        elif va < vb:
            _, ahi, alo = self.nodes[a]
            res = self._mk(va, self.apply(ahi, b, op), self.apply(alo, b, op))
        else:
            _, bhi, blo = self.nodes[b]
            res = self._mk(vb, self.apply(a, bhi, op), self.apply(a, blo, op))
        self.apply_cache[key] = res
        return res

    def conjoin(self, a: int, b: int) -> int:
        return self.apply(a, b, "and")

    def disjoin(self, a: int, b: int) -> int:
        return self.apply(a, b, "or")

    def negate(self, a: int) -> int:
        """O(|SDD|) with caching (sdd.rs:598)."""
        if a == FALSE:
            return TRUE
        if a == TRUE:
            return FALSE
        hit = self.negate_cache.get(a)
        if hit is not None:
            return hit
        var, hi, lo = self.nodes[a]
        res = self._mk(var, self.negate(hi), self.negate(lo))
        self.negate_cache[a] = res
        self.negate_cache[res] = a
        return res

    def exactly_one(self, var_indices: List[int]) -> int:
        """Annotated-disjunction constraint: exactly one of the variables is
        true (sdd.rs:175-193)."""
        result = FALSE
        for chosen in var_indices:
            term = TRUE
            for v in var_indices:
                term = self.conjoin(term, self.literal(v, v == chosen))
            result = self.disjoin(result, term)
        return result

    # ------------------------------------------------------------------ WMC

    def wmc(self, nid: int) -> float:
        """Weighted model count over ALL allocated variables (sdd.rs:623).

        Skipped decision levels contribute (w_pos + w_neg) each; for
        independent vars that is 1 so only exclusive-group weights need it.
        """
        n_vars = len(self.vars)
        memo: Dict[int, float] = {}

        def level_weight(lo_level: int, hi_level: int) -> float:
            w = 1.0
            for v in range(lo_level, hi_level):
                vi = self.vars[v]
                w *= vi.w_pos + vi.w_neg
            return w

        def rec(node: int) -> Tuple[float, int]:
            """Returns (wmc below this node incl. its level, node's level)."""
            if node == TRUE:
                return 1.0, n_vars
            if node == FALSE:
                return 0.0, n_vars
            if node in memo:
                return memo[node], self._var_of(node)
            var, hi, lo = self.nodes[node]
            vi = self.vars[var]
            whi, lhi = rec(hi)
            wlo, llo = rec(lo)
            val = vi.w_pos * whi * level_weight(var + 1, lhi) + vi.w_neg * wlo * level_weight(var + 1, llo)
            memo[node] = val
            return val, var
        val, lvl = rec(nid)
        return val * level_weight(0, lvl)

    def set_weight(self, var: int, w_pos: float, w_neg: Optional[float] = None):
        vi = self.vars[var]
        vi.w_pos = w_pos
        if w_neg is not None:
            vi.w_neg = w_neg
        elif vi.kind == "independent":
            vi.w_neg = 1.0 - w_pos

    # ----------------------------------------------------- model enumeration

    def enumerate_models(self, nid: int, limit: int = 1000) -> List[Dict[int, bool]]:
        """Paths to TRUE as partial assignments var->bool (sdd.rs:661) —
        used for proof-path explanations."""
        out: List[Dict[int, bool]] = []

        def walk(node: int, assignment: Dict[int, bool]):
            if len(out) >= limit:
                return
            if node == FALSE:
                return
            if node == TRUE:
                out.append(dict(assignment))
                return
            var, hi, lo = self.nodes[node]
            assignment[var] = True
            walk(hi, assignment)
            assignment[var] = False
            walk(lo, assignment)
            del assignment[var]

        walk(nid, {})
        return out

    def size(self, nid: int) -> int:
        seen = set()

        def walk(n):
            if n in (TRUE, FALSE) or n in seen:
                return
            seen.add(n)
            _, hi, lo = self.nodes[n]
            walk(hi)
            walk(lo)

        walk(nid)
        return len(seen)


def make_sdd_manager():
    """SddManager factory: native C++ engine when available (the
    neurosymbolic training hot path), pure-Python otherwise.  Both expose
    the identical interface and node semantics (tests/test_native.py)."""
    try:
        from kolibrie_tpu_torch.native.sdd_native import NativeSddManager

        return NativeSddManager()
    except (ImportError, RuntimeError):
        return SddManager()


class SddProvenance:
    """Provenance semiring with SDD-node tags (sdd.rs:705-777)."""

    name = "sdd"

    def __init__(self, manager: Optional[SddManager] = None):
        self.manager = manager if manager is not None else make_sdd_manager()
        self.seed_vars: Dict[int, int] = {}  # seed_id -> var index

    def zero(self):
        return FALSE

    def one(self):
        return TRUE

    def disjunction(self, a, b):
        return self.manager.disjoin(a, b)

    def conjunction(self, a, b):
        return self.manager.conjoin(a, b)

    def negate(self, a):
        return self.manager.negate(a)

    def saturate(self, a):
        return a

    def is_saturated(self, a):
        return a == TRUE

    def tag_from_probability(self, p: float):
        var = self.manager.new_var(w_pos=p)
        return self.manager.literal(var, True)

    def tag_from_probability_with_id(self, p: float, seed_id: int):
        var = self.seed_vars.get(seed_id)
        if var is None:
            var = self.manager.new_var(w_pos=p, seed_id=seed_id)
            self.seed_vars[seed_id] = var
        else:
            self.manager.set_weight(var, p)
        return self.manager.literal(var, True)

    def recover_probability(self, tag) -> float:
        return self.manager.wmc(tag)

    def tag_eq(self, a, b) -> bool:
        return a == b

    def is_zero(self, tag) -> bool:
        return tag == FALSE
