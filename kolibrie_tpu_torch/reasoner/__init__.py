"""Datalog reasoner of the PyTorch port: the fact and rule API, the host
semi-naive strategies and the device semi-naive fixpoint.

Port of ``kolibrie_tpu/reasoner/`` (parity: the reference's ``datalog/``
crate); provenance, repairs, backward chaining and cross-window reasoning
are later slices.
"""

from kolibrie_tpu_torch.reasoner.reasoner import Reasoner

__all__ = ["Reasoner"]
