"""kolibrie_tpu_torch — the PyTorch / CUDA port of ``kolibrie_tpu``.

SPARQL SELECT over basic graph patterns and FILTERs runs on the device
engine (scans over the two-tier sorted store, merge-path joins, FILTER
masks, the worst-case-optimal join for cyclic patterns) with hand-written
CUDA kernels for the NVIDIA H100.  Every entry point runs on the CUDA card
unless the caller passes ``device="cpu"``.

    from kolibrie_tpu_torch import SparqlDatabase, execute_query_volcano
    db = SparqlDatabase(device="cpu")
    db.parse_ntriples(...)
    rows = execute_query_volcano("SELECT ...", db)
"""

from kolibrie_tpu_torch.query.executor import Unsupported, execute_query_volcano
from kolibrie_tpu_torch.query.sparql_database import SparqlDatabase

__all__ = ["SparqlDatabase", "Unsupported", "execute_query_volcano"]
