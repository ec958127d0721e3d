"""RDF triple as three u32 dictionary IDs.

Parity: ``shared/src/triple.rs:14-31``.
"""

from __future__ import annotations

from typing import NamedTuple


class Triple(NamedTuple):
    subject: int
    predicate: int
    object: int
