"""Copy of ``kolibrie_tpu/rsp/r2s.py`` for the PyTorch port.

R2S: relation-to-stream operators.

Parity: ``kolibrie/src/rsp/r2s.rs:37-58`` — RSTREAM emits the whole current
relation, ISTREAM the additions vs the previous evaluation, DSTREAM the
deletions.
"""

from __future__ import annotations

from typing import List, Set


class StreamOperator:
    RSTREAM = "RSTREAM"
    ISTREAM = "ISTREAM"
    DSTREAM = "DSTREAM"


class Relation2StreamOperator:
    def __init__(self, stream_operator: str = StreamOperator.RSTREAM, start_time: int = 0):
        self.stream_operator = stream_operator
        self.last_result: Set = set()

    def eval(self, new_response: List, ts: int) -> List:
        if self.stream_operator == StreamOperator.RSTREAM:
            return list(new_response)
        if self.stream_operator == StreamOperator.ISTREAM:
            new_set = set(new_response)
            emitted = [b for b in new_response if b not in self.last_result]
            self.last_result = new_set
            return emitted
        # DSTREAM
        new_set = set(new_response)
        emitted = [b for b in self.last_result if b not in new_set]
        self.last_result = new_set
        return emitted
