"""The port's two-tier store mirror against the reference's, on the CPU.

Both stores replay the same sequence of ``add_batch`` / ``add`` /
``remove`` / ``compact`` calls, so their base/delta split is the same; then
``device_segment`` must give the same base columns, delta columns and
tombstone positions for every sort order (the port's int64 carriers hold
the reference's u32 values), and re-upload only what the reference's
version keys say changed.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kolibrie_tpu.core.store import ColumnarTripleStore as RefStore
from kolibrie_tpu_torch.core.store import ColumnarTripleStore as PortStore
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

ORDERS = ("spo", "pos", "osp", "pso", "ops", "sop")


def assert_segments_equal(ref: RefStore, port: PortStore):
    assert port.delta_epoch == ref.delta_epoch
    for name in ORDERS:
        (rb, rd, rdel) = ref.device_segment(name)
        (pb, pd, pdel) = port.device_segment(name)
        for r, p in zip(list(rb) + list(rd) + [rdel], list(pb) + list(pd) + [pdel]):
            assert p.dtype == torch.int64 and p.device.type == "cpu"
            np.testing.assert_array_equal(p.numpy(), np.asarray(r).astype(np.int64))


def replay(stores, op, *args):
    for st in stores:
        getattr(st, op)(*args)


def _rows(rng, n, hi=40):
    s = rng.integers(1, hi, n).astype(np.uint32)
    p = rng.integers(1, 5, n).astype(np.uint32)
    o = rng.integers(1, hi, n).astype(np.uint32)
    o[: n // 10] |= np.uint32(1 << 31)  # quoted-triple object IDs
    return s, p, o


@pytest.mark.parametrize("seed", [0, 1])
def test_device_segment_matches_reference_across_states(seed):
    rng = np.random.default_rng(seed)
    ref, port = RefStore(), PortStore(torch.device("cpu"))
    stores = (ref, port)
    # base: one bulk load
    replay(stores, "add_batch", *_rows(rng, 3000))
    assert_segments_equal(ref, port)
    base_version = ref.base_version
    base_before = port.device_segment("pos")[0]
    # delta: a few fresh rows (incremental compaction, base frozen)
    s, p, o = _rows(rng, 20, hi=60)
    replay(stores, "add_batch", s, p, o)
    replay(stores, "add", 70, 2, 71)
    assert_segments_equal(ref, port)
    assert ref.base_version == base_version
    assert ref.segment_signature()[2] > 0  # rows really sit in the delta
    assert port.device_segment("pos")[0] is base_before  # base not re-uploaded
    # tombstones over base rows, and a delta row removed again
    bs, bp, bo = ref.columns()
    for i in rng.choice(len(bs), 15, replace=False):
        replay(stores, "remove", int(bs[i]), int(bp[i]), int(bo[i]))
    replay(stores, "remove", 70, 2, 71)
    replay(stores, "compact")
    assert ref.segment_signature()[3] > 0  # tombstones over base rows
    assert_segments_equal(ref, port)
    # reinsert a tombstoned base row
    i = int(rng.integers(0, len(bs)))
    replay(stores, "remove", int(bs[i]), int(bp[i]), int(bo[i]))
    replay(stores, "compact")
    replay(stores, "add", int(bs[i]), int(bp[i]), int(bo[i]))
    assert_segments_equal(ref, port)
    assert ref.base_version == base_version
    # a batch past the delta threshold folds the delta into a new base
    replay(stores, "add_batch", *_rows(rng, 1500, hi=90))
    assert_segments_equal(ref, port)
    assert ref.base_version != base_version
    assert port.device_segment("pos")[0] is not base_before


def test_delta_capacity_and_padding():
    ref, port = RefStore(), PortStore(torch.device("cpu"))
    for st in (ref, port):
        st.delta_threshold = 100
    replay((ref, port), "add_batch", *_rows(np.random.default_rng(5), 2000))
    replay((ref, port), "add", 1, 1, 2**31 + 3)
    assert port.delta_device_cap == ref.delta_device_cap == 128
    base, delta, del_pos = port.device_segment("osp")
    assert delta[0].shape[0] == del_pos.shape[0] == 128
    assert int(base[0][-1]) == 0xFFFFFFFF  # power-of-two padding sorts last
    assert_segments_equal(ref, port)
