"""Logical and physical plan nodes.

Parity: ``streamertail_optimizer/operators/logical.rs:16-56`` and
``operators/physical.rs:16-76``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from kolibrie_tpu_torch.query.ast import (
    BindClause,
    FilterExpression,
    PatternTriple,
    SubQuery,
    ValuesClause,
)


# ----------------------------------------------------------------- logical


@dataclass
class LogicalScan:
    pattern: PatternTriple


@dataclass
class LogicalJoin:
    left: "LogicalOp"
    right: "LogicalOp"


@dataclass
class LogicalStarJoin:
    """Star query: one shared variable joined across many patterns
    (optimizer.rs:84-152)."""

    center_var: str
    scans: List[LogicalScan]


@dataclass
class LogicalFilter:
    expr: FilterExpression
    child: "LogicalOp"


@dataclass
class LogicalBind:
    bind: BindClause
    child: "LogicalOp"


@dataclass
class LogicalValues:
    values: ValuesClause


@dataclass
class LogicalSubquery:
    subquery: SubQuery


@dataclass
class LogicalProjection:
    variables: List[str]
    child: "LogicalOp"


LogicalOp = object  # union of the above


# ----------------------------------------------------------------- physical


@dataclass
class PhysIndexScan:
    """Sorted-order range scan (the UnifiedIndex-permutation equivalent)."""

    pattern: PatternTriple
    estimated_rows: float = 0.0


@dataclass
class PhysTableScan:
    pattern: PatternTriple
    estimated_rows: float = 0.0


@dataclass
class PhysHashJoin:
    left: "PhysOp"
    right: "PhysOp"
    join_vars: List[str] = field(default_factory=list)
    optimized: bool = False  # OptimizedHashJoin vs plain (physical.rs)


@dataclass
class PhysMergeJoin:
    left: "PhysOp"
    right: "PhysOp"
    join_vars: List[str] = field(default_factory=list)


@dataclass
class PhysNestedLoopJoin:
    left: "PhysOp"
    right: "PhysOp"


@dataclass
class PhysParallelJoin:
    """Device-partitioned join: on TPU this is the pjit/shard_map path."""

    left: "PhysOp"
    right: "PhysOp"
    join_vars: List[str] = field(default_factory=list)


@dataclass
class PhysStarJoin:
    center_var: str
    scans: List["PhysOp"] = field(default_factory=list)


@dataclass
class WcojNode:
    """Worst-case-optimal multiway join: ALL patterns of a (cyclic) basic
    graph pattern joined at once, one variable eliminated per level in
    ``elim_order`` (leapfrog-triejoin over the store's sorted orders).
    ``scans`` are the per-pattern physical scan nodes — kept as scans so
    host fallback, EXPLAIN, and variable accounting reuse the existing
    machinery; the device lowering reads only their patterns."""

    scans: List["PhysOp"] = field(default_factory=list)
    elim_order: List[str] = field(default_factory=list)
    estimated_rows: float = 0.0


@dataclass
class PhysFilter:
    expr: FilterExpression
    child: "PhysOp"


@dataclass
class PhysBind:
    bind: BindClause
    child: "PhysOp"


@dataclass
class PhysValues:
    values: ValuesClause


@dataclass
class PhysSubquery:
    subquery: SubQuery


@dataclass
class PhysProjection:
    variables: List[str]
    child: "PhysOp"


PhysOp = object  # union of the above


def logical_variables(op) -> set:
    """Output variable set of a logical node."""
    if isinstance(op, LogicalScan):
        return set(op.pattern.variables())
    if isinstance(op, LogicalJoin):
        return logical_variables(op.left) | logical_variables(op.right)
    if isinstance(op, LogicalStarJoin):
        out = set()
        for s in op.scans:
            out |= set(s.pattern.variables())
        return out
    if isinstance(op, (LogicalFilter, LogicalBind)):
        extra = {op.bind.var} if isinstance(op, LogicalBind) else set()
        return logical_variables(op.child) | extra
    if isinstance(op, LogicalValues):
        return set(op.values.variables)
    if isinstance(op, LogicalProjection):
        return set(op.variables)
    return set()
