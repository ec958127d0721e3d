"""Multi-device layer of the PyTorch port: a shard mesh driven from one
controller.

Port of ``kolibrie_tpu/parallel/``:

- triple columns hash-partitioned across the shards (:mod:`sharded_store`),
- partitioned equi-joins with all-to-all repartitioning (:mod:`dist_join`),
- distributed semi-naive fixpoints with psum termination: a fast path for
  unary/binary-chain rules (:mod:`dist_fixpoint`) and a general path for
  arbitrary premise counts, constants, filters and NAF
  (:mod:`dist_general`),
- full SPARQL plans over the mesh (:mod:`dist_query`) and mesh serving of
  batched template groups (:mod:`sharded_serving`),
- the one-device neural-predicate training step (:mod:`train_step`).

A :class:`~kolibrie_tpu_torch.parallel.mesh.Mesh` is a tuple of
``torch.device`` (entries may repeat: several shards on one card, or
``[torch.device("cpu")] * 8`` in the tests); the reference's ``shard_map``
bodies are controller loops over the shards, split at each collective.
The data-parallel training step, the step fused with a reasoning round and
the distributed provenance fixpoint come with the next slice.
"""

from kolibrie_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_axis
from kolibrie_tpu_torch.parallel.sharded_store import ShardedTripleStore
from kolibrie_tpu_torch.parallel.dist_join import dist_bgp_join_count, dist_equi_join
from kolibrie_tpu_torch.parallel.dist_fixpoint import (
    DistRuleSet,
    DistributedReasoner,
    distributed_seminaive,
)
from kolibrie_tpu_torch.parallel.dist_general import (
    DistGeneralReasoner,
    distributed_seminaive_general,
)
from kolibrie_tpu_torch.parallel.dist_query import (
    DistQueryExecutor,
    execute_query_distributed,
)
from kolibrie_tpu_torch.parallel.sharded_serving import (
    ShardedDatabase,
    active_sharded,
    attach_sharded,
    detach_sharded,
    sharded_compile_stats,
)
from kolibrie_tpu_torch.parallel.train_step import make_train_state

__all__ = [
    "Mesh",
    "make_mesh",
    "mesh_axis",
    "ShardedTripleStore",
    "dist_equi_join",
    "dist_bgp_join_count",
    "DistRuleSet",
    "DistributedReasoner",
    "DistGeneralReasoner",
    "distributed_seminaive",
    "distributed_seminaive_general",
    "DistQueryExecutor",
    "execute_query_distributed",
    "ShardedDatabase",
    "attach_sharded",
    "detach_sharded",
    "active_sharded",
    "sharded_compile_stats",
    "make_train_state",
]
