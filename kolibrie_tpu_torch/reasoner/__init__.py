"""Datalog reasoner of the PyTorch port: the fact and rule API, the host
semi-naive strategies and the device semi-naive fixpoint, provenance
semirings with the device tagged fixpoint, SDD-based exact inference,
stratified negation, backward chaining, constraints and repairs,
hierarchical reasoning, the DOT export and cross-window streaming
reasoning (SDS+, :mod:`.cross_window`).

Port of ``kolibrie_tpu/reasoner/`` (parity: the reference's ``datalog/``
crate plus ``shared/src/{provenance,sdd,diff_sdd,tag_store,seed_spec}.rs``).
"""

from kolibrie_tpu_torch.reasoner.reasoner import Reasoner
from kolibrie_tpu_torch.reasoner.hierarchy import (
    HierarchicalRule,
    ReasoningHierarchy,
    ReasoningLevel,
)
from kolibrie_tpu_torch.reasoner.to_dot import to_dot

__all__ = [
    "Reasoner",
    "ReasoningHierarchy",
    "ReasoningLevel",
    "HierarchicalRule",
    "to_dot",
]
