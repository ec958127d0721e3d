"""Crash-safe durable writes of the PyTorch port.

Port of ``kolibrie_tpu/durability/``, trimmed to :mod:`.fsio`'s
temp-write → fsync → rename primitive, which ``SparqlDatabase.checkpoint``
writes through.  The write-ahead log and the snapshot manager come with
the serving slice (ROADMAP A10).
"""
