"""The PyTorch port's kernel modules against the JAX package, on the CPU.

On CPU tensors every kernel wrapper of ``kolibrie_tpu_torch.ops.kernels``
runs its plain PyTorch version; the JAX entries run their Pallas kernels
in interpret mode (called directly, as ``test_pallas_kernels.py`` does).
Inputs are made from seeds with numpy and fed to both; results must be
exactly equal — indices, masks and counts are integers, so there is no
tolerance.  The CUDA kernels themselves are held against these plain
versions on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kolibrie_tpu.ops import device_join as jdj
from kolibrie_tpu.ops import pallas_kernels as jpk
from kolibrie_tpu.ops import wcoj as jwcoj
from kolibrie_tpu.ops.jax_compat import enable_x64
from kolibrie_tpu_torch.backend import _LPAD, _RPAD, key1
from kolibrie_tpu_torch.ops import device_join as tdj
from kolibrie_tpu_torch.ops import kernels as tk
from kolibrie_tpu_torch.ops import wcoj as twcoj

SENT = 0xFFFFFFFF
U64_LPAD = np.uint64(0xFFFFFFFFFFFFFFFE)
U64_RPAD = np.uint64(0xFFFFFFFFFFFFFFFF)


def t64(x) -> torch.Tensor:
    """numpy u32/int column -> the port's int64 carrier tensor."""
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def carrier(u64: np.ndarray) -> torch.Tensor:
    """numpy u64 keys -> the port's int64 key carriers."""
    u = np.asarray(u64, np.uint64) ^ np.uint64(1 << 63)
    return torch.from_numpy(u.view(np.int64).copy())


def assert_join_equal(jout, tout):
    jli, jri, jv, jtot = (np.asarray(x) for x in jout)
    tli, tri, tv, ttot = tout
    assert int(jtot) == int(ttot)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tli.numpy(), jli.astype(np.int64))
    np.testing.assert_array_equal(tri.numpy(), jri.astype(np.int64))


# ------------------------------------------------------------ merge join


def _case(name):
    rng = np.random.default_rng(MERGE_CASES.index(name))
    lvalid = rvalid = None
    if name == "nm_gaps":
        lk = rng.integers(0, 60, 40).astype(np.uint32)
        rk = np.sort(rng.integers(0, 60, 50)).astype(np.uint32)
        cap = 512
    elif name == "multi_tile":
        lk = rng.integers(0, 400, 700).astype(np.uint32)
        rk = np.sort(rng.integers(0, 400, 600)).astype(np.uint32)
        cap = 4096
    elif name == "heavy_fanout":
        lk = np.array([5, 5, 5], np.uint32)
        rk = np.full(300, 5, np.uint32)
        cap = 1024
    elif name == "no_matches":
        lk = np.array([1, 2, 3], np.uint32)
        rk = np.array([10, 20], np.uint32)
        cap = 128
    elif name == "empty_left":
        lk = np.zeros(0, np.uint32)
        rk = np.array([1, 2], np.uint32)
        cap = 128
    elif name == "empty_right":
        lk = np.array([1, 2], np.uint32)
        rk = np.zeros(0, np.uint32)
        cap = 128
    elif name == "overflow":
        lk = np.full(20, 9, np.uint32)
        rk = np.full(20, 9, np.uint32)
        cap = 128  # 400 matches: outputs hold a prefix, total is exact
    elif name == "keys_above_2_31":
        lk = np.array([10, 2**31 + 5, 2**31 + 9, 7], np.uint32)
        rk = np.array([7, 2**31 + 5, 2**31 + 9, 2**31 + 9], np.uint32)
        cap = 128
    elif name == "sentinel_rows":
        lk = rng.integers(0, 50, 300).astype(np.uint32)
        rk = np.sort(rng.integers(0, 50, 200)).astype(np.uint32)
        lvalid = rng.random(300) < 0.7  # holes anywhere on the left
        rvalid = np.arange(200) < 150  # prefix validity on the right
        cap = 2048
    elif name == "sparse":
        lk = np.arange(0, 2000, 2).astype(np.uint32)
        rk = np.array([100, 1000, 1998], np.uint32)
        cap = 256
    elif name == "fanout_beyond_tile":
        # one left row matches 2,500 right rows: over three of the merge-path
        # kernel's 1,024-slot tiles
        lk = np.array([2, 5, 9, 5], np.uint32)
        rk = np.sort(np.concatenate([np.full(3, 2), np.full(2500, 5), np.full(4, 9),
                                     rng.integers(10, 40, 50)])).astype(np.uint32)
        cap = 6144
    elif name == "overflow_cap_not_tile":
        # ~4,000 matches into 3,000 slots: not a multiple of the tile (nor of
        # 1024: merge_join_indices rounds it to 3,072, ranked keeps it)
        lk = rng.integers(0, 30, 400).astype(np.uint32)
        rk = np.sort(rng.integers(0, 30, 300)).astype(np.uint32)
        cap = 3000
    else:
        raise KeyError(name)
    return lk, rk, cap, lvalid, rvalid


MERGE_CASES = [
    "nm_gaps",
    "multi_tile",
    "heavy_fanout",
    "no_matches",
    "empty_left",
    "empty_right",
    "overflow",
    "keys_above_2_31",
    "sentinel_rows",
    "sparse",
    "fanout_beyond_tile",
    "overflow_cap_not_tile",
]


@pytest.mark.parametrize("name", MERGE_CASES)
def test_merge_join_indices_matches_jax(name):
    lk, rk, cap, lvalid, rvalid = _case(name)
    jargs = [jnp.asarray(lk), jnp.asarray(rk), cap]
    targs = [t64(lk), t64(rk), cap]
    if lvalid is not None:
        jargs += [jnp.asarray(lvalid), jnp.asarray(rvalid)]
        targs += [torch.from_numpy(lvalid), torch.from_numpy(rvalid)]
    assert_join_equal(jpk.merge_join_indices(*jargs), tk.merge_join_indices(*targs))


def _u64_keys(rng, n, lo_range, valid_frac, pad):
    a = rng.integers(0, lo_range, n).astype(np.uint64)
    b = rng.integers(0, 4, n).astype(np.uint64)
    a[rng.random(n) < 0.1] |= np.uint64(1 << 31)  # quoted-triple IDs
    k = (a << np.uint64(32)) | b
    valid = rng.random(n) < valid_frac
    return np.where(valid, k, pad), valid


@pytest.mark.parametrize("seed,cap", [(0, 128), (1, 1000), (2, 4096)])
def test_ranked_merge_join_indices_matches_jax(seed, cap):
    rng = np.random.default_rng(seed)
    lk, _ = _u64_keys(rng, 400, 40, 0.8, U64_LPAD)
    rk, _ = _u64_keys(rng, 300, 40, 0.8, U64_RPAD)
    with enable_x64(True):
        jout = jpk.ranked_merge_join_indices(jnp.asarray(lk), jnp.asarray(rk), cap)
        jout = tuple(np.asarray(x) for x in jout)
    assert_join_equal(jout, tk.ranked_merge_join_indices(carrier(lk), carrier(rk), cap))


@pytest.mark.parametrize("name", ["fanout_beyond_tile", "overflow_cap_not_tile"])
def test_ranked_merge_join_indices_at_tile_edges_matches_jax(name):
    lk, rk, cap, _, _ = _case(name)
    lk, rk = lk.astype(np.uint64), rk[::-1].astype(np.uint64)  # the right side unsorted
    with enable_x64(True):
        jout = jpk.ranked_merge_join_indices(jnp.asarray(lk), jnp.asarray(rk), cap)
        jout = tuple(np.asarray(x) for x in jout)
    tout = tk.ranked_merge_join_indices(carrier(lk), carrier(rk), cap)
    assert tout[0].shape[0] == cap
    assert_join_equal(jout, tout)


def test_merge_path_wrapper_takes_plain_version_on_cpu():
    before = dict(tk.LAUNCHES)
    lk, rk, cap, _, _ = _case("nm_gaps")
    tk.merge_join_indices(t64(lk), t64(rk), cap)
    assert tk.LAUNCHES == before  # the CPU route launches no kernel


# ------------------------------------------------------- device_join twins


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_join_indices_matches_jax(seed, masked):
    rng = np.random.default_rng(seed)
    lk, lv = _u64_keys(rng, 300, 30, 0.9, U64_LPAD)
    rk, rv = _u64_keys(rng, 250, 30, 0.9, U64_RPAD)
    cap = 1024
    jk = {"lvalid": lv, "rvalid": rv} if masked else {}
    tkw = (
        {"lvalid": torch.from_numpy(lv), "rvalid": torch.from_numpy(rv)}
        if masked
        else {}
    )
    jout = tuple(np.asarray(x) for x in jdj.join_indices(lk, rk, cap, **jk))
    assert_join_equal(jout, tdj.join_indices(carrier(lk), carrier(rk), cap, **tkw))


@pytest.mark.parametrize("seed", [5, 6])
def test_join_indices_presorted_matches_jax(seed):
    rng = np.random.default_rng(seed)
    lk, lv = _u64_keys(rng, 300, 30, 0.85, U64_LPAD)
    rk = np.sort(_u64_keys(rng, 250, 30, 1.0, U64_RPAD)[0])
    rv = np.arange(250) < 200
    cap = 1024
    jout = tuple(
        np.asarray(x)
        for x in jdj.join_indices_presorted(lk, rk, cap, lvalid=lv, rvalid_prefix=rv)
    )
    tout = tdj.join_indices_presorted(
        carrier(lk),
        carrier(rk),
        cap,
        lvalid=torch.from_numpy(lv),
        rvalid_prefix=torch.from_numpy(rv),
    )
    assert_join_equal(jout, tout)


def test_pack_key_multi_matches_jax():
    rng = np.random.default_rng(9)
    lcols = [rng.integers(0, 6, 200).astype(np.uint32) for _ in range(3)]
    rcols = [rng.integers(0, 6, 150).astype(np.uint32) for _ in range(3)]
    lcols[0][:5] |= np.uint32(1 << 31)
    lv = rng.random(200) < 0.8
    rv = rng.random(150) < 0.8
    with enable_x64(True):
        jl, jr = jdj.pack_key_multi(
            [jnp.asarray(c) for c in lcols],
            [jnp.asarray(c) for c in rcols],
            jnp.asarray(lv),
            jnp.asarray(rv),
        )
        jl, jr = np.asarray(jl), np.asarray(jr)
    tl, tr = tdj.pack_key_multi(
        [t64(c) for c in lcols],
        [t64(c) for c in rcols],
        torch.from_numpy(lv),
        torch.from_numpy(rv),
    )
    np.testing.assert_array_equal(tl.numpy(), carrier(jl).numpy())
    np.testing.assert_array_equal(tr.numpy(), carrier(jr).numpy())


def test_padding_carriers_keep_unsigned_order():
    assert _LPAD == int(carrier(np.array([U64_LPAD]))[0])
    assert _RPAD == int(carrier(np.array([U64_RPAD]))[0])
    ids = np.array([0, 5, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)
    assert torch.equal(torch.argsort(key1(t64(ids))), torch.arange(5))


# ---------------------------------------------------------------- lex_range


def _lex_cols(rng, n, k):
    cols = [rng.integers(0, 5, n).astype(np.uint32) for _ in range(k)]
    cols[0][: n // 8] = SENT  # sentinel padding sorts last
    order = np.lexsort(tuple(reversed(cols)))
    return [c[order] for c in cols]


@pytest.mark.parametrize("k", [1, 2, 3])
def test_lex_range_matches_jax(k):
    rng = np.random.default_rng(20 + k)
    cols = _lex_cols(rng, 257, k)
    keys = [rng.integers(0, 6, 90).astype(np.uint32) for _ in range(k)]
    keys[0][:4] = SENT
    jlo, jhi = jwcoj.lex_range(
        tuple(jnp.asarray(c) for c in cols), tuple(jnp.asarray(x) for x in keys)
    )
    tlo, thi = twcoj.lex_range([t64(c) for c in cols], [t64(x) for x in keys])
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    for side, ref in (("left", jlo), ("right", jhi)):
        got = twcoj.lex_searchsorted([t64(c) for c in cols], [t64(x) for x in keys], side)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------------------ lex-probe pair


def _probe_inputs(seed, a_count, p=300):
    rng = np.random.default_rng(seed)
    kk = rng.integers(0, 12, p).astype(np.int32)
    ch = rng.integers(0, a_count, p).astype(np.int32)
    in_range = rng.random(p) < 0.8
    sel = []
    for _ in range(a_count):
        nb = rng.integers(0, 12, p).astype(np.int32)
        vals = [rng.integers(0, 4, p).astype(np.uint32) for _ in range(4)]
        for v in vals:
            v[rng.random(p) < 0.05] = SENT
            v[rng.random(p) < 0.05] |= np.uint32(1 << 31)
        sel.append((nb, *vals))
    ex = []
    for _ in range(a_count):
        fl = rng.integers(0, 8, p).astype(np.int32)
        fh = fl + rng.integers(0, 3, p).astype(np.int32)
        tl = rng.integers(0, 4, p).astype(np.int32)
        th = tl + rng.integers(0, 3, p).astype(np.int32)
        dl2 = rng.integers(0, 4, p).astype(np.int32)
        dh2 = dl2 + rng.integers(0, 2, p).astype(np.int32)
        sent = rng.random(p) < 0.1
        ex.append((fl, fh, tl, th, dl2, dh2, sent))
    return kk, ch, in_range, sel, ex


@pytest.mark.parametrize("a_count", [1, 2, 3])
def test_lex_probe_select_matches_jax(a_count):
    kk, ch, in_range, sel, _ = _probe_inputs(30 + a_count, a_count)
    jval, jok, jisb = jpk.lex_probe_select(
        jnp.asarray(kk),
        jnp.asarray(ch),
        jnp.asarray(in_range),
        [tuple(jnp.asarray(x) for x in acc) for acc in sel],
    )
    tval, tok, tisb = tk.lex_probe_select(
        t64(kk),
        t64(ch),
        torch.from_numpy(in_range),
        [tuple(t64(x) for x in acc) for acc in sel],
    )
    np.testing.assert_array_equal(tval.numpy(), np.asarray(jval).astype(np.int64))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tisb.numpy(), np.asarray(jisb))


@pytest.mark.parametrize("a_count", [1, 2, 3])
def test_lex_probe_validate_matches_jax(a_count):
    rng = np.random.default_rng(40 + a_count)
    _, ch, _, _, ex = _probe_inputs(40 + a_count, a_count)
    ok = rng.random(ch.shape[0]) < 0.7
    isb = rng.random(ch.shape[0]) < 0.5
    jv = jpk.lex_probe_validate(
        jnp.asarray(ok),
        jnp.asarray(isb),
        jnp.asarray(ch),
        [tuple(jnp.asarray(x) for x in acc) for acc in ex],
    )
    tv = tk.lex_probe_validate(
        torch.from_numpy(ok),
        torch.from_numpy(isb),
        t64(ch),
        [
            tuple(t64(x) for x in acc[:6]) + (torch.from_numpy(acc[6]),)
            for acc in ex
        ],
    )
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ------------------------------------------------------------ merge_join (payload)


@pytest.mark.parametrize("name", MERGE_CASES)
def test_merge_join_matches_jax(name):
    lk, rk, cap, _, _ = _case(name)
    rng = np.random.default_rng(50 + MERGE_CASES.index(name))
    lv = rng.integers(0, 2**32, lk.shape[0], dtype=np.uint64).astype(np.uint32)
    rv = rng.integers(0, 2**32, rk.shape[0], dtype=np.uint64).astype(np.uint32)
    jout = [np.asarray(x) for x in jpk.merge_join(*map(jnp.asarray, (lk, lv, rk, rv)), cap)]
    tout = tk.merge_join(t64(lk), t64(lv), t64(rk), t64(rv), cap)
    assert int(tout[4]) == int(jout[4])
    np.testing.assert_array_equal(tout[3].numpy(), jout[3])
    for t, j in zip(tout[:3], jout[:3]):
        np.testing.assert_array_equal(t.numpy(), j.astype(np.int64))


# --------------------------------------------------------------- filter_mask

_HIGH = [0, 5, 0x7FFFFFFF, 0x80000000, 0x90000001, 0xFFFFFFFE, 0xFFFFFFFF]


def _filter_cols(seed, n=700):
    rng = np.random.default_rng(seed)
    cols = [rng.choice(np.array(_HIGH, np.uint32), n) for _ in range(3)]
    cols[1][::3] = rng.integers(0, 4, len(cols[1][::3]))
    return cols


FILTER_CASES = [
    dict(),  # every clause a wildcard
    dict(s_const=0x90000001),
    dict(p_const=2, o_const=0x80000000),
    dict(s_const=5, p_const=1, o_const=0xFFFFFFFE),
    dict(s_const=0xFFFFFFFF),  # the never-match constant
    *[dict(o_op=op, o_cmp=0x80000000) for op in range(6)],
    *[dict(p_const=3, o_op=op, o_cmp=5) for op in range(6)],
    dict(s_const=0, o_op=5, o_cmp=0xFFFFFFFF),
]


@pytest.mark.parametrize("case", range(len(FILTER_CASES)))
def test_filter_mask_matches_jax(case):
    kw = FILTER_CASES[case]
    s, p, o = _filter_cols(60 + case)
    jm = np.asarray(jpk.filter_mask(*map(jnp.asarray, (s, p, o)), **kw))
    tm = tk.filter_mask(t64(s), t64(p), t64(o), **kw)
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_array_equal(tk.filter_mask_plain(t64(s), t64(p), t64(o), **kw).numpy(), jm)


@pytest.mark.parametrize("case", range(len(FILTER_CASES)))
@pytest.mark.parametrize("n", [1, 3, 5, 6, 1023, 1025, 4097])
def test_filter_mask_plain_matches_jax_at_group_tails(n, case):
    """Row counts that leave each tail (1, 2, 3 rows) past the CUDA kernel's
    4-row groups."""
    kw = FILTER_CASES[case]
    s, p, o = _filter_cols(80 + case, n)
    jm = np.asarray(jpk.filter_mask(*map(jnp.asarray, (s, p, o)), **kw))
    assert jm.shape == (n,)
    np.testing.assert_array_equal(tk.filter_mask_plain(t64(s), t64(p), t64(o), **kw).numpy(), jm)


@pytest.mark.parametrize(
    "kw", [dict(s_const=2**32), dict(p_const=-2), dict(o_op=6), dict(o_op=1, o_cmp=-1)]
)
def test_filter_mask_rejects_out_of_range_arguments(kw):
    z = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        tk.filter_mask(z, z, z, **kw)


# --------------------------------------------------------------- tag_combine


def _tags(seed, n=1000):
    rng = np.random.default_rng(seed)
    a = rng.random(n).astype(np.float32)
    b = rng.random(n).astype(np.float32)
    # NaN on either side, 0 and 1, and both orders of -0.0 against 0.0
    special = np.array([0.0, 1.0, np.nan, -0.0, 0.5, 1.0, np.nan, 0.0, -0.0, 0.0], np.float32)
    a[:10], b[:10] = special, np.array(
        [0.0, np.nan, 1.0, 0.5, -0.0, np.nan, 1.0, -0.0, 0.0, -0.0], np.float32
    )
    return a, b


def _ulps(x, y):
    """Distance in units in the last place between float32 arrays (NaN
    against NaN is 0): their int32 patterns on one monotone scale."""
    def key(v):
        i = v.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    both_nan = np.isnan(x) & np.isnan(y)
    return np.where(both_nan, 0, np.abs(key(x) - key(y)))


@pytest.mark.parametrize("op", ["min", "max", "mul", "noisy_or"])
def test_tag_combine_matches_jax(op):
    a, b = _tags(70 + ["min", "max", "mul", "noisy_or"].index(op))
    want = np.asarray(jpk.tag_combine(jnp.asarray(a), jnp.asarray(b), op))
    got = tk.tag_combine(torch.from_numpy(a), torch.from_numpy(b), op).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(a) | np.isnan(b))
    # every op bit for bit, the sign of a zero included (min(0, -0) and
    # min(-0, 0) are -0, max of them +0): 0 ulp
    assert _ulps(got, want).max() == 0
    np.testing.assert_array_equal(np.signbit(got[~np.isnan(got)]), np.signbit(want[~np.isnan(want)]))
    if op == "noisy_or":
        # the reference's XLA form rounds 1 - (1-a)(1-b) once (a fused
        # multiply-add); rounding the product first, as separate float32
        # operations do, is up to 7 ulp away on these inputs
        one = np.float32(1.0)
        assert _ulps(one - (one - a) * (one - b), want).max() == 7
    # f64 inputs are cast to float32 first
    got64 = tk.tag_combine(torch.from_numpy(a.astype(np.float64)), torch.from_numpy(b), op)
    assert got64.dtype == torch.float32
    np.testing.assert_array_equal(got64.numpy().view(np.int32), got.view(np.int32))


def test_one_minus_product_rounds_once():
    """Products whose float64 value leaves ``1 - x*y`` exactly on a
    float32 midpoint that the exact value is not on: rounding through
    float64 to nearest and then to float32 goes wrong about half the time;
    the port's round-to-odd gives the one correct rounding throughout."""
    from fractions import Fraction

    xs, ys = [], []
    for m1 in range(2**23 + 1, 2**24, 2):
        inv = pow(m1, -1, 2**30)  # m1 * inv = A * 2^30 + 1
        if 2**23 <= inv < 2**24 and (m1 * inv >> 30) & 1:
            xs.append(m1 * 2.0**-24)
            ys.append(inv * 2.0**-31)
            if len(xs) == 64:
                break
    x, y = np.array(xs, np.float32), np.array(ys, np.float32)
    got = tk._one_minus_product(torch.from_numpy(x), torch.from_numpy(y)).numpy()

    def nearest(fr):
        c = np.float32(float(fr))
        near = [np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf))]
        return min(near, key=lambda v: (abs(Fraction(float(v)) - fr), int(v.view(np.int32)) & 1))

    want = np.array(
        [nearest(1 - Fraction(float(u)) * Fraction(float(v))) for u, v in zip(x, y)], np.float32
    )
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    twice = (1.0 - x.astype(np.float64) * y.astype(np.float64)).astype(np.float32)
    assert (twice.view(np.int32) != want.view(np.int32)).sum() > 16


def test_tag_combine_unknown_op_raises():
    z = torch.zeros(4)
    with pytest.raises(ValueError):
        tk.tag_combine(z, z, "xor")


# ---------------------------------------------- fixpoint dedup and membership

from kolibrie_tpu.parallel import dist_fixpoint as jdist  # noqa: E402


def _rows(rng, n, hi):
    cols = [rng.integers(0, hi, n).astype(np.uint32) for _ in range(3)]
    cols[0][rng.random(n) < 0.1] |= np.uint32(1 << 31)
    cols[2][rng.random(n) < 0.1] |= np.uint32(1 << 31)
    return cols


@pytest.mark.parametrize("cap", [16, 64, 512])
def test_sort_unique3_matches_jax(cap):
    rng = np.random.default_rng(80 + cap)
    cols = _rows(rng, 300, 4)
    valid = rng.random(300) < 0.8
    (js, jp, jo), jv, jn = jdist._sort_unique3(
        tuple(jnp.asarray(c) for c in cols), jnp.asarray(valid), cap
    )
    (ts, tp, to), tv, tn = tdj._sort_unique3([t64(c) for c in cols], torch.from_numpy(valid), cap)
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for t, j in zip((ts, tp, to), (js, jp, jo)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(np.int64))


@pytest.mark.parametrize("width", [1, 2, 3])
def test_row_membership_matches_jax(width):
    rng = np.random.default_rng(90 + width)
    ours = _rows(rng, 400, 3)[:width]
    theirs = _rows(rng, 250, 3)[:width]
    ours[0][:20] = 0xFFFFFFFE
    theirs[0][:20] = SENT
    with enable_x64(True):
        jm = np.asarray(jdj._row_membership([jnp.asarray(c) for c in ours],
                                            [jnp.asarray(c) for c in theirs]))
    tm = tdj._row_membership([t64(c) for c in ours], [t64(c) for c in theirs])
    np.testing.assert_array_equal(tm.numpy(), jm)
    assert jm.any() and not jm.all()


def test_semi_join_mask_matches_jax():
    rng = np.random.default_rng(99)
    lk, _ = _u64_keys(rng, 300, 20, 0.9, U64_LPAD)
    rk, rv = _u64_keys(rng, 200, 20, 1.0, U64_RPAD)
    rv = rng.random(200) < 0.7
    jm = np.asarray(jdj.semi_join_mask(lk, rk, rv))
    tm = tdj.semi_join_mask(carrier(lk), carrier(rk), torch.from_numpy(rv))
    np.testing.assert_array_equal(tm.numpy(), jm)
