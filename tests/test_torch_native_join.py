"""The port's native host equi-join twin against the JAX package's and the
port's numpy ``join_indices``, at the reference's ``TestNativeJoin`` shapes
(``tests/test_native.py``).  Skipped where the native library cannot be
built, as the reference's tests are."""

from __future__ import annotations

import numpy as np
import pytest

from kolibrie_tpu.native.join_native import gather_native as ref_gather
from kolibrie_tpu.native.join_native import join_indices_native as ref_join
from kolibrie_tpu_torch import native as port_native
from kolibrie_tpu_torch.native.join_native import available, gather_native, join_indices_native
from kolibrie_tpu_torch.ops.join import join_indices
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)


@pytest.fixture(autouse=True)
def _native_library():
    # decided when a test runs, not when the module is imported: the load
    # builds the library on first use
    if not port_native.available():
        pytest.skip("the native library does not build here (no C++ compiler)")


SHAPES = [
    (0, 5, 3),
    (5, 0, 3),
    (1, 1, 1),
    (7, 3, 4),
    (1000, 1000, 50),  # heavy duplication
    (20000, 20000, 20000),  # near 1:1
    (30000, 10000, 700),  # skewed
]


def both(lk, rk):
    """The port's native pairs, after checking them against numpy's and the
    reference's native ones."""
    li_n, ri_n = join_indices_native(lk, rk)
    li, ri = join_indices(lk, rk)
    assert np.array_equal(li_n, li) and np.array_equal(ri_n, ri)
    want = ref_join(lk, rk)
    if want is not None:  # the reference's loader builds its own library
        assert np.array_equal(li_n, want[0]) and np.array_equal(ri_n, want[1])
    return li_n, ri_n


def test_parity_random_shapes():
    assert available()
    rng = np.random.default_rng(11)
    for ln, rn, kspace in SHAPES:
        lk = rng.integers(0, max(kspace, 1), ln, dtype=np.uint32)
        rk = rng.integers(0, max(kspace, 1), rn, dtype=np.uint32)
        _li, ri = both(lk, rk)
        if len(ri):
            got = gather_native(rk, ri)
            assert np.array_equal(got, rk[ri])
            ref = ref_gather(rk, ri)
            assert ref is None or np.array_equal(got, ref)


def test_buffer_regrow_on_fanout():
    # every left row matches every right row: 90,000 pairs, far past the
    # first 2 * max(n) guess, so the call retries with the true total
    lk = np.full(300, 9, dtype=np.uint32)
    rk = np.full(300, 9, dtype=np.uint32)
    li, _ri = both(lk, rk)
    assert len(li) == 90_000


def test_extreme_key_values():
    lk = np.array([0, 0xFFFFFFFF, 0x7FFFFFFF, 0x80000000], dtype=np.uint32)
    rk = np.array([0xFFFFFFFF, 0x80000000, 0, 123], dtype=np.uint32)
    li, ri = both(lk, rk)
    assert len(li) == 3
