"""kolibrie_tpu_torch — the PyTorch / CUDA port of ``kolibrie_tpu``.

SPARQL SELECT over basic graph patterns and FILTERs runs on the device
engine (scans over the two-tier sorted store, merge-path joins, FILTER
masks, the worst-case-optimal join for cyclic patterns), the Datalog
reasoner's semi-naive fixpoint runs as device rounds (fused triple-pattern
scans, merge-path premise joins, sort-unique dedup), so does its tagged
(provenance) fixpoint under the scalar semirings, and the RSP engine
closes and queries each window firing on the device, with hand-written CUDA
kernels for the NVIDIA H100; cross-window SDS+ and the incremental R2R carry
expiration-tagged closures across windows and firings.  The database
surface (bulk load through the native parsers, checkpoints, clone / union,
serializers, ``QueryBuilder``, the ``QueryEngine`` facade) sits around it.
Every entry point runs on the CUDA card unless the caller passes
``device="cpu"``.

    from kolibrie_tpu_torch import SparqlDatabase, execute_query_volcano
    db = SparqlDatabase(device="cpu")
    db.parse_ntriples(...)
    rows = execute_query_volcano("SELECT ...", db)
    execute_query_volcano("INSERT DATA { ... }", db)  # and DELETE, RULE

    from kolibrie_tpu_torch import Reasoner
    r = Reasoner(device="cpu")
    r.add_abox_triple("a", "next", "b")
    r.add_rule(r.rule_from_strings([...], [...]))
    r.infer_new_facts_semi_naive_parallel()
    r.infer_new_facts_with_provenance(MinMaxProbability())  # reasoner.provenance

    from kolibrie_tpu_torch import RSPBuilder, WindowTriple
    engine = RSPBuilder("REGISTER RSTREAM ...", device="cpu").add_rules(...).build()
    engine.add_to_stream("http://stream", WindowTriple(s, p, o), ts)
    # cross-window rules: .set_cross_window_rules(n3).set_cross_window_reasoning_mode("auto")

    db.checkpoint("db.npz"); SparqlDatabase.from_checkpoint("db.npz", device="cpu")
    db.load_file("data.nt"); db.to_turtle(); db.query().with_predicate(...).get_decoded_triples()
"""

from kolibrie_tpu_torch.core.dictionary import Dictionary
from kolibrie_tpu_torch.core.rule import FilterCondition, Rule
from kolibrie_tpu_torch.core.terms import Term, TriplePattern
from kolibrie_tpu_torch.core.triple import Triple
from kolibrie_tpu_torch.query.builder import QueryBuilder
from kolibrie_tpu_torch.query.engine import QueryEngine
from kolibrie_tpu_torch.query.executor import Unsupported, execute_query, execute_query_volcano
from kolibrie_tpu_torch.query.sparql_database import SparqlDatabase
from kolibrie_tpu_torch.reasoner.cross_window import (
    Sds,
    WindowData,
    WindowedTriple,
    incremental_sds_plus,
    naive_sds_plus,
)
from kolibrie_tpu_torch.reasoner.reasoner import Reasoner
from kolibrie_tpu_torch.rsp import RSPBuilder, RSPEngine, WindowTriple
from kolibrie_tpu_torch.rsp.engine import CrossWindowReasoningMode

__all__ = [
    "CrossWindowReasoningMode",
    "Dictionary",
    "FilterCondition",
    "QueryBuilder",
    "QueryEngine",
    "RSPBuilder",
    "RSPEngine",
    "Reasoner",
    "Rule",
    "Sds",
    "SparqlDatabase",
    "Term",
    "Triple",
    "TriplePattern",
    "Unsupported",
    "WindowData",
    "WindowTriple",
    "WindowedTriple",
    "execute_query",
    "execute_query_volcano",
    "incremental_sds_plus",
    "naive_sds_plus",
]
