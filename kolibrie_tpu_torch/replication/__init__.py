"""WAL-shipping replication: a primary seals and streams WAL segments
to read-only followers; a thin router load-balances reads with
template affinity and promotes the most-caught-up follower when the
primary dies (docs/REPLICATION.md).

Layers:

- :mod:`protocol`  — length-prefixed checksummed messages over TCP,
  reusing the WAL frame format (``durability/wal.py``), with sequence
  ids so duplicated deliveries are detectable.
- :mod:`primary`   — ``ShipServer``: serves manifest / snapshot files /
  sealed segments off a live :class:`DurabilityManager`.
- :mod:`follower`  — ``ReplicationFollower``: bootstraps from the newest
  valid snapshot generation, replays shipped segments idempotently,
  tracks the ``(base_version, delta_epoch)`` watermark, and can be
  promoted to primary (fresh WAL segment, attach stores, accept writes).
- :mod:`router`    — ``AffinityRouter``: template-affinity read
  balancing, health probes, deadline-aware retry with backoff,
  dead-replica eviction, and the promotion supervisor.

Copy of ``kolibrie_tpu/replication/__init__.py`` for the PyTorch port, its imports
rewritten.
"""

from kolibrie_tpu_torch.replication.protocol import (  # noqa: F401
    ProtocolError,
    ShipClient,
    recv_msg,
    send_msg,
)
