"""RSP (RDF Stream Processing) of the PyTorch port: C-SPARQL windows (S2R),
per-window query + reasoning on the device (R2R), stream operators (R2S),
the multi-window engine with sync policies, and the RSP-QL builder.

Port of ``kolibrie_tpu/rsp/`` (parity: ``kolibrie/src/rsp/`` +
``rsp_engine.rs``).
"""

from kolibrie_tpu_torch.rsp.s2r import CSPARQLWindow, ContentContainer, ReportStrategy, Tick, WindowTriple
from kolibrie_tpu_torch.rsp.r2s import Relation2StreamOperator, StreamOperator
from kolibrie_tpu_torch.rsp.builder import RSPBuilder
from kolibrie_tpu_torch.rsp.engine import RSPEngine

__all__ = [
    "CSPARQLWindow",
    "ContentContainer",
    "ReportStrategy",
    "Tick",
    "WindowTriple",
    "Relation2StreamOperator",
    "StreamOperator",
    "RSPBuilder",
    "RSPEngine",
]
