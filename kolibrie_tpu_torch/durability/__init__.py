"""Crash-safe durability of the PyTorch port (``kolibrie_tpu/durability/``):
write-ahead log, atomic snapshots, recovery.

- :mod:`~kolibrie_tpu_torch.durability.fsio` — temp-write → fsync → rename
  primitives
- :mod:`~kolibrie_tpu_torch.durability.wal` — checksummed segmented WAL
- :mod:`~kolibrie_tpu_torch.durability.manager` — snapshot generations,
  startup recovery, and the store-journal attachment

The on-disk formats are the reference's, byte for byte (its
docs/DURABILITY.md has the record format, fsync policies, recovery
semantics, and the ops runbook): a data directory written by either
package recovers in the other.
"""

from kolibrie_tpu_torch.durability.manager import DurabilityManager, RecoveryResult
from kolibrie_tpu_torch.durability.wal import WalWriter, scan_wal

__all__ = ["DurabilityManager", "RecoveryResult", "WalWriter", "scan_wal"]
