"""Binding tables on the host: a dict var -> u32 numpy column, all columns the
same length.  The device engine reads its results back into this form and
the executor's post-passes (projection, DISTINCT, ORDER BY, formatting) run
over it."""

from __future__ import annotations

from typing import Dict

import numpy as np

BindingTable = Dict[str, np.ndarray]  # all columns same length

UNBOUND = 0  # dictionary NULL sentinel doubles as the unbound marker


def table_len(t: BindingTable) -> int:
    for v in t.values():
        return len(v)
    return 0
