"""Row deduplication over binding tables (sort-unique — the device-friendly
dedup; parity with ``shared/src/join_algorithm.rs:446`` ``compact_results``)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def unique_rows(cols: Sequence[np.ndarray]) -> Tuple[List[np.ndarray], np.ndarray]:
    """Deduplicate parallel columns row-wise.  Returns (unique_cols, keep_idx).

    Sort-based: lexsort over columns then drop consecutive duplicates —
    identical shape to a device sort-unique kernel.
    """
    n = len(cols[0])
    if n == 0:
        return list(cols), np.empty(0, dtype=np.int64)
    order = np.lexsort(tuple(reversed([np.asarray(c) for c in cols])))
    sorted_cols = [np.asarray(c)[order] for c in cols]
    if n == 1:
        return sorted_cols, order
    dup = np.ones(n, dtype=bool)
    dup[0] = False
    same = np.ones(n - 1, dtype=bool)
    for c in sorted_cols:
        same &= c[1:] == c[:-1]
    dup[1:] = same
    keep = ~dup
    return [c[keep] for c in sorted_cols], order[keep]


def unique_table(table: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    keys = sorted(table.keys())
    if not keys:
        return table
    cols, _ = unique_rows([table[k] for k in keys])
    return dict(zip(keys, cols))
