"""The frozen byte functions against hand counts at small shapes: each
counts what its inputs need (the slots a join fills, the columns a filter
reads over the rows that hold facts), not the capacity it was handed."""

import pytest
import torch

from portbench.metrics import kernel_bytes as KB


def _i64(*v):
    return torch.tensor(v, dtype=torch.int64)


@pytest.mark.parametrize("total,cap,want", [
    (6, 8, 24 * 3 + 17 * 6),   # three compacted rows feed six filled slots
    (6, 4, 24 * 3 + 17 * 4),   # a short capacity: four slots, from rows 0-2
    (2, 1024, 24 * 1 + 17 * 2),  # a large capacity counts no empty slot
    (0, 16, 0),
])
def test_merge_path_counts_filled_slots(total, cap, want):
    cum = _i64(2, 3, 6)
    args = (_i64(0, 1, 2), _i64(0, 0, 0), cum, torch.tensor(total), 3, 6, cap)
    assert int(KB.merge_path_bytes(args)) == want


@pytest.mark.parametrize("consts,want", [
    ((-1, 7, -1, -1), 10 * 9),      # predicate only: one column read
    ((3, -1, 9, -1), 10 * 17),      # subject and object
    ((-1, -1, -1, 2), 10 * 9),      # an object comparison reads the object
    ((-1, 7, 9, 2), 10 * 17),       # object constant and comparison: read once
    ((-1, -1, -1, -1), 10),         # no clause: the mask alone
])
def test_filter_counts_active_columns(consts, want):
    col = torch.zeros(10, dtype=torch.int64)
    args = (col, col, col, *consts)
    assert KB.filter_bytes(args) == want
    kw = dict(zip(("s_const", "p_const", "o_const", "o_op"), consts))
    assert KB.filter_bytes((col, col, col), kw) == want


def test_filter_counts_the_rows_given():
    col = torch.zeros(10, dtype=torch.int64)
    assert int(KB.filter_bytes((col, col, col, -1, 7, -1, -1), rows=torch.tensor(4))) == 4 * 9


def test_a_premise_scan_counts_its_valid_rows(monkeypatch):
    """The fixpoint scans a padded fact buffer: only its valid rows count,
    while a filter launched outside a premise scan counts every row."""
    from kolibrie_tpu_torch.ops import kernels as K
    from kolibrie_tpu_torch.reasoner import device_fixpoint as FX

    from portbench import trace

    monkeypatch.setattr(trace, "_on_card", lambda args: True)
    n, live = 64, 5
    cols = tuple(torch.arange(n, dtype=torch.int64) for _ in range(3))
    valid = torch.arange(n) < live
    originals = (FX._scan_premise, FX.filter_mask, K.filter_mask)
    prem = FX.LoweredPremise(consts=(None, 3, None), vars=(("x", 0), ("y", 2)), eq_pairs=())
    with trace.KernelBytes() as kb:
        _table, m = FX._scan_premise(prem, cols, valid)
        K.filter_mask(cols[0], cols[1], cols[2], -1, 3, -1)
    assert int(m.sum()) == 1
    assert kb.totals()["filter_mask"] == (2, live * 9 + n * 9)
    assert (FX._scan_premise, FX.filter_mask, K.filter_mask) == originals


def test_validate_counts_live_slots():
    ok = torch.tensor([True, False, True, True])
    acc = [tuple(torch.zeros(4, dtype=torch.int64) for _ in range(6)) + (torch.zeros(4, dtype=torch.bool),)] * 2
    assert int(KB.validate_bytes((ok, ok, _i64(0, 0, 1, 1), acc))) == 4 * 2 + 3 * 9 + 3 * 49 * 2


def test_select_counts_predecessor_reads():
    kk, ch = _i64(0, 1, 2, 0), _i64(0, 0, 1, 1)
    z = torch.zeros(4, dtype=torch.int64)
    acc = [(_i64(2, 2, 2, 2), z, z, z, z), (_i64(0, 0, 0, 0), z, z, z, z)]
    # slots 1 (within its base range, not its first) and 2 (delta, past nb)
    assert int(KB.select_bytes((kk, ch, torch.ones(4, dtype=torch.bool), acc))) == 4 * 43 + 8 * 2


def test_tag_bytes():
    assert KB.tag_bytes((torch.zeros(5), torch.zeros(5), "min")) == 60


def test_roofline_share():
    ctx = {"kernels": {"merge_path_join": (3, 3_350_000_000), "filter_mask": (0, 0)},
           "timeline": {"kernel_s": {"merge_path_join": 2e-3, "filter_mask": 0.0}},
           "peaks": {"hbm_bytes_per_s": 3.35e12}}
    assert KB.roofline_pct(ctx) == pytest.approx(50.0)
    assert KB.roofline_pct(dict(ctx, kernels={"filter_mask": (0, 0)})) is None
