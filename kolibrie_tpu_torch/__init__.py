"""kolibrie_tpu_torch — the PyTorch / CUDA port of ``kolibrie_tpu``.

SPARQL SELECT over basic graph patterns and FILTERs runs on the device
engine (scans over the two-tier sorted store, merge-path joins, FILTER
masks, the worst-case-optimal join for cyclic patterns), the Datalog
reasoner's semi-naive fixpoint runs as device rounds (fused triple-pattern
scans, merge-path premise joins, sort-unique dedup), and the RSP engine
closes and queries each window firing on the device, with hand-written CUDA
kernels for the NVIDIA H100.  Every entry point runs on the CUDA card
unless the caller passes ``device="cpu"``.

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

    from kolibrie_tpu_torch import RSPBuilder, WindowTriple
    engine = RSPBuilder("REGISTER RSTREAM ...", device="cpu").add_rules(...).build()
    engine.add_to_stream("http://stream", WindowTriple(s, p, o), ts)
"""

from kolibrie_tpu_torch.core.dictionary import Dictionary
from kolibrie_tpu_torch.core.rule import FilterCondition, Rule
from kolibrie_tpu_torch.core.terms import Term, TriplePattern
from kolibrie_tpu_torch.core.triple import Triple
from kolibrie_tpu_torch.query.executor import Unsupported, execute_query, execute_query_volcano
from kolibrie_tpu_torch.query.sparql_database import SparqlDatabase
from kolibrie_tpu_torch.reasoner.reasoner import Reasoner
from kolibrie_tpu_torch.rsp import RSPBuilder, RSPEngine, WindowTriple

__all__ = [
    "Dictionary",
    "FilterCondition",
    "RSPBuilder",
    "RSPEngine",
    "Reasoner",
    "Rule",
    "SparqlDatabase",
    "Term",
    "Triple",
    "TriplePattern",
    "Unsupported",
    "WindowTriple",
    "execute_query",
    "execute_query_volcano",
]
