"""The port's mesh layer against the JAX package's, on an 8-shard CPU mesh.

The reference runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port on ``make_mesh(8, devices=[torch.device("cpu")] * 8)``.  With
equal shard counts the per-shard layout is equal, so every comparison is
per shard and exact: the shard hash on 100,000 random u32 keys (bit 31
included), the partitioned store and its probe index (monolithic and
two-tier, after adds and deletes), the distributed equi-join with and
without bucket / output overflow and the doubling retry, the co-located
BGP count at LUBM-2, and both distributed fixpoints — their closures equal
to the reference's and to the port's single-device host reasoner, their
overflow protocols raising or converging as the reference's do.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import kolibrie_tpu.parallel as R
import kolibrie_tpu_torch.parallel as P
from benches.lubm import UB, generate_fast
from kolibrie_tpu.core.rule import FilterCondition as RefFilter
from kolibrie_tpu.core.rule import Rule as RefRule
from kolibrie_tpu.core.terms import Term as RefTerm
from kolibrie_tpu.core.terms import TriplePattern as RefPattern
from kolibrie_tpu.parallel.sharded_store import partition_rows as ref_partition
from kolibrie_tpu.parallel.sharded_store import shard_of as ref_shard_of
from kolibrie_tpu.reasoner.reasoner import Reasoner as RefReasoner
from kolibrie_tpu_torch.core.rule import FilterCondition as PortFilter
from kolibrie_tpu_torch.core.rule import Rule as PortRule
from kolibrie_tpu_torch.core.terms import Term as PortTerm
from kolibrie_tpu_torch.core.terms import TriplePattern as PortPattern
from kolibrie_tpu_torch.parallel.dist_join import shard_of_dev
from kolibrie_tpu_torch.parallel.sharded_store import partition_rows as port_partition
from kolibrie_tpu_torch.parallel.sharded_store import shard_of as port_shard_of
from kolibrie_tpu_torch.reasoner.reasoner import Reasoner as PortReasoner

N = 8
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def meshes(mesh8):
    return mesh8, P.make_mesh(N, devices=[CPU] * N)


def host(sharded) -> np.ndarray:
    """A port sharded array as host ``[n, L]``."""
    return np.stack([t.numpy() for t in sharded])


def u64(carrier: np.ndarray) -> np.ndarray:
    """The reference's u64 words of int64 key carriers."""
    return carrier.view(np.uint64) ^ np.uint64(1 << 63)


def same_store(ref, port) -> None:
    for name in ("by_subj", "by_obj"):
        for k in range(3):
            np.testing.assert_array_equal(host(getattr(port, name)[k]), np.asarray(getattr(ref, name)[k]))
        np.testing.assert_array_equal(host(getattr(port, name + "_valid")),
                                      np.asarray(getattr(ref, name + "_valid")))


def same_index(ref, port) -> None:
    for r, p in zip(ref.subj_index_parts, port.subj_index_parts):
        np.testing.assert_array_equal(u64(host(p)), np.asarray(r).astype(np.uint64))


def chain_cols(n, pred=100):
    s = np.arange(1, n, dtype=np.uint32)
    return s, np.full(n - 1, pred, dtype=np.uint32), s + 1


def trans_rule(Rule, Term, Pattern, pred=100):
    V, C = Term.variable, Term.constant
    return Rule(
        premise=[Pattern(V("x"), C(pred), V("y")), Pattern(V("y"), C(pred), V("z"))],
        conclusion=[Pattern(V("x"), C(pred), V("z"))],
    )


# ------------------------------------------------------------ hash + store


def test_shard_of_matches_reference_on_random_u32():
    rng = np.random.default_rng(13)
    keys = rng.integers(0, 1 << 32, 100_000, dtype=np.uint64).astype(np.uint32)
    keys[:4] = (0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF)
    assert (keys >= 0x80000000).sum() > 40_000  # quoted (bit 31) IDs
    for n in (1, 3, 4, 8):
        want = ref_shard_of(keys, n)
        np.testing.assert_array_equal(port_shard_of(keys, n), want)
        dev = shard_of_dev(torch.from_numpy(keys.astype(np.int64)), n)
        np.testing.assert_array_equal(dev.numpy(), want)


def test_partition_rows_and_store_occupancy(meshes):
    rmesh, pmesh = meshes
    s, p, o = generate_fast(2, _Interner())
    cols, valid = ref_partition((s, p, o), s, N)
    pcols, pvalid = port_partition((s, p, o), s, N)
    for a, b in zip(cols + (valid,), pcols + (pvalid,)):
        np.testing.assert_array_equal(a, b)
    ref = R.ShardedTripleStore.from_columns(rmesh, s, p, o)
    port = P.ShardedTripleStore.from_columns(pmesh, s, p, o)
    assert port.cap == ref.cap and port.n_triples == ref.n_triples == len(s)
    same_store(ref, port)
    same_index(ref, port)
    assert port.subj_index_base_builds == ref.subj_index_base_builds == 1
    for a, b in zip(port.gather_host(), ref.gather_host()):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        port_partition((s,), s, N, cap=8)


class _Interner:
    """A dictionary stand-in for ``generate_fast``: consecutive IDs."""

    def __init__(self):
        self.ids = {}

    def encode(self, term):
        return self.ids.setdefault(term, len(self.ids) + 1)


def test_two_tier_subj_index_after_adds_and_deletes(meshes):
    """The serving layer's two-tier probe index, built by hand on both
    sides: a frozen base block, a delta block of adds, tombstones inside
    the base; then a delta-only rebuild reusing the base pack."""
    import jax.numpy as jnp

    rmesh, pmesh = meshes
    rng = np.random.default_rng(5)
    bcap, dcap = 64, 16
    base = rng.integers(1, 50, (3, N, bcap)).astype(np.uint32)
    bvalid = np.zeros((N, bcap), dtype=bool)
    bvalid[:, :48] = True
    delta = rng.integers(1, 50, (3, N, dcap)).astype(np.uint32)
    dvalid = np.zeros((N, dcap), dtype=bool)
    dvalid[:, :5] = True
    del_pos = np.full((N, dcap), bcap, dtype=np.int32)
    del_pos[:, :3] = rng.integers(0, 48, (N, 3))
    live = bvalid.copy()
    np.put_along_axis(live, np.minimum(del_pos, bcap - 1), False, axis=1)
    ref = R.ShardedTripleStore(rmesh, bcap + dcap)
    port = P.ShardedTripleStore(pmesh, bcap + dcap)
    cols = [np.concatenate([base[k], delta[k]], axis=1) for k in range(3)]
    valid = np.concatenate([live, dvalid], axis=1)
    ref.by_subj = tuple(jnp.asarray(c) for c in cols)
    ref.by_subj_valid = jnp.asarray(valid)
    port.by_subj = tuple(P.mesh.shard_put(pmesh, c) for c in cols)
    port.by_subj_valid = P.mesh.shard_put(pmesh, valid)
    ref.refresh_subj_index(base_end=bcap, base_valid=jnp.asarray(bvalid), del_pos=jnp.asarray(del_pos))
    port.refresh_subj_index(base_end=bcap, base_valid=P.mesh.shard_put(pmesh, bvalid),
                            del_pos=P.mesh.shard_put(pmesh, del_pos))
    same_index(ref, port)
    # a delta-only refresh: the base pack is reused
    dvalid[:, 5:9] = True
    valid = np.concatenate([live, dvalid], axis=1)
    ref.by_subj_valid = jnp.asarray(valid)
    port.by_subj_valid = P.mesh.shard_put(pmesh, valid)
    for st, put in ((ref, jnp.asarray), (port, lambda a: P.mesh.shard_put(pmesh, a))):
        st.refresh_subj_index(base_end=bcap, base_valid=put(bvalid), del_pos=put(del_pos),
                              base_unchanged=True)
    same_index(ref, port)
    assert (port.subj_index_base_builds, port.subj_index_delta_builds) == (
        ref.subj_index_base_builds, ref.subj_index_delta_builds) == (1, 2)
    # the probe surface counts base - tombstones + delta on both sides
    port.by_obj, port.by_obj_valid = port.by_subj, port.by_subj_valid
    ref.by_obj, ref.by_obj_valid = ref.by_subj, ref.by_subj_valid
    for p1, p2 in ((7, 9), (11, 11), (3, 40)):
        assert P.dist_bgp_join_count(port, p1, p2) == R.dist_bgp_join_count(ref, p1, p2)


# ------------------------------------------------------------------- joins


@pytest.mark.parametrize("bucket_cap,out_cap", [(64, 512), (4, 512), (64, 16)],
                         ids=["fits", "bucket_overflow", "output_overflow"])
def test_dist_equi_join_matches_reference(meshes, bucket_cap, out_cap):
    rmesh, pmesh = meshes
    rng = np.random.default_rng(1)
    lk = rng.integers(1, 30, 100).astype(np.uint32)
    la = rng.integers(1, 1000, 100).astype(np.uint32)
    rk = rng.integers(1, 30, 80).astype(np.uint32)
    rb = rng.integers(1, 1000, 80).astype(np.uint32)
    lcols, lvalid = ref_partition((la, lk), la, N, 64)
    rcols, rvalid = ref_partition((rk, rb), rb, N, 64)
    args = (lcols, lvalid, rcols, rvalid)
    kw = dict(lkey_i=1, rkey_i=0, bucket_cap=bucket_cap, out_cap=out_cap)
    want = R.dist_equi_join(rmesh, *args, **kw)
    got = P.dist_equi_join(pmesh, *args, **kw)
    assert got[3:] == want[3:]
    for a, b in zip(want[0] + want[1] + (want[2],), got[0] + got[1] + (got[2],)):
        np.testing.assert_array_equal(b, np.asarray(a))
    if bucket_cap == 64 and out_cap == 512:
        assert got[4] == 0 and got[3] == int((lk[:, None] == rk[None, :]).sum())
    else:
        assert got[4] > 0
        # the overflow protocol: double and retry until nothing drops
        while got[4] > 0:
            kw["bucket_cap"] *= 2
            kw["out_cap"] *= 2
            got = P.dist_equi_join(pmesh, *args, **kw)
        assert got[3] == int((lk[:, None] == rk[None, :]).sum())
        v = got[2]
        assert (got[0][1][v] == got[1][0][v]).all()


def test_dist_bgp_join_count_lubm2(meshes):
    rmesh, pmesh = meshes
    interner = _Interner()
    s, p, o = generate_fast(2, interner)
    p1, p2 = interner.ids[UB + "advisor"], interner.ids[UB + "teacherOf"]
    ref = R.ShardedTripleStore.from_columns(rmesh, s, p, o)
    port = P.ShardedTripleStore.from_columns(pmesh, s, p, o)
    lv, lc = np.unique(o[p == p1], return_counts=True)
    rv, rc = np.unique(s[p == p2], return_counts=True)
    _, li, ri = np.intersect1d(lv, rv, return_indices=True)
    want = int((lc[li] * rc[ri]).sum())
    assert want > 0
    assert P.dist_bgp_join_count(port, p1, p2) == R.dist_bgp_join_count(ref, p1, p2) == want


# -------------------------------------------------------------- fixpoints


def test_distributed_reasoner_closure_matches_reference(meshes):
    rmesh, pmesh = meshes
    n = 40
    ref = R.ShardedTripleStore.from_columns(rmesh, *chain_cols(n), cap_per_shard=1024)
    port = P.ShardedTripleStore.from_columns(pmesh, *chain_cols(n), cap_per_shard=1024)
    caps = dict(fact_cap=1024, delta_cap=1024, join_cap=2048, bucket_cap=512)
    rs = R.DistRuleSet.from_rules([trans_rule(RefRule, RefTerm, RefPattern)])
    ps = P.DistRuleSet.from_rules([trans_rule(PortRule, PortTerm, PortPattern)])
    assert ps.binary == rs.binary == [(100, 100, 100)]
    rounds = P.DistributedReasoner(pmesh, ps, **caps).infer(port)
    assert rounds == R.DistributedReasoner(rmesh, rs, **caps).infer(ref)
    same_store(ref, port)
    s, _p, o = port.gather_host()
    assert set(zip(s.tolist(), o.tolist())) == {
        (i, j) for i in range(1, n + 1) for j in range(i + 1, n + 1)}
    # the probe index follows the fixpoint's write-back
    assert P.dist_bgp_join_count(port, 100, 100) == sum((j - 1) * (n - j) for j in range(1, n + 1))


def test_distributed_reasoner_agrees_with_host_reasoner(meshes):
    _rmesh, pmesh = meshes
    rng = np.random.default_rng(3)
    edges = {(int(a), int(b)) for a, b in zip(rng.integers(1, 25, 60), rng.integers(1, 25, 60))
             if a != b}
    host = PortReasoner(device="cpu")
    for a, b in edges:
        host.facts.add(a, 100, b)
    host.add_rule(trans_rule(PortRule, PortTerm, PortPattern))
    host.infer_new_facts_semi_naive()
    hs, _hp, ho = host.facts.match(p=100)
    s = np.array([e[0] for e in edges], dtype=np.uint32)
    o = np.array([e[1] for e in edges], dtype=np.uint32)
    st = P.ShardedTripleStore.from_columns(pmesh, s, np.full(len(s), 100, np.uint32), o,
                                           cap_per_shard=2048)
    P.distributed_seminaive(pmesh, st, [trans_rule(PortRule, PortTerm, PortPattern)],
                            delta_cap=2048, join_cap=8192, bucket_cap=1024)
    gs, _gp, go = st.gather_host()
    assert set(zip(gs.tolist(), go.tolist())) == set(zip(hs.tolist(), ho.tolist()))


def test_distributed_reasoner_unary_and_unsupported(meshes):
    _rmesh, pmesh = meshes
    V, C = PortTerm.variable, PortTerm.constant
    st = P.ShardedTripleStore.from_columns(pmesh, *chain_cols(10, 5), cap_per_shard=512)
    unary = PortRule(premise=[PortPattern(V("x"), C(5), V("y"))],
                     conclusion=[PortPattern(V("x"), C(6), V("y"))])
    P.distributed_seminaive(pmesh, st, [unary], delta_cap=512, join_cap=512, bucket_cap=256)
    _s, p, _o = st.gather_host()
    assert (p == 6).sum() == 9 and (p == 5).sum() == 9
    bad = PortRule(premise=[PortPattern(V("x"), V("p"), V("y"))],
                   conclusion=[PortPattern(V("x"), C(6), V("y"))])
    assert P.DistRuleSet.from_rules([bad]) is None
    with pytest.raises(NotImplementedError):
        P.distributed_seminaive(pmesh, P.ShardedTripleStore.from_columns(
            pmesh, *chain_cols(4), cap_per_shard=64), [bad])


@pytest.mark.parametrize("case", ["fact_cap", "join_cap", "initial_delta"])
def test_distributed_reasoner_overflow_raises(meshes, case):
    _rmesh, pmesh = meshes
    rule = P.DistRuleSet.from_rules([trans_rule(PortRule, PortTerm, PortPattern)])
    if case == "fact_cap":
        st = P.ShardedTripleStore.from_columns(pmesh, *chain_cols(64), cap_per_shard=16)
        caps = dict(fact_cap=16, delta_cap=16, join_cap=32, bucket_cap=8)
    elif case == "join_cap":
        # hub -> leaves + leaves -> hub: a quadratic join output
        k = 40
        s = np.concatenate([np.full(k, 1), np.arange(2, k + 2)]).astype(np.uint32)
        o = np.concatenate([np.arange(2, k + 2), np.full(k, 1)]).astype(np.uint32)
        st = P.ShardedTripleStore.from_columns(pmesh, s, np.full(2 * k, 100, np.uint32), o,
                                               cap_per_shard=4096)
        caps = dict(fact_cap=4096, delta_cap=4096, join_cap=8, bucket_cap=4096)
    else:
        st = P.ShardedTripleStore.from_columns(pmesh, *chain_cols(200), cap_per_shard=64)
        caps = dict(fact_cap=64, delta_cap=8, join_cap=64, bucket_cap=64)
    with pytest.raises(OverflowError):
        P.DistributedReasoner(pmesh, rule, **caps).infer(st)


def base_facts(r, n=24):
    for i in range(n):
        r.add_abox_triple(f"p{i}", "worksAt", f"org{i % 5}")
        r.add_abox_triple(f"org{i % 5}", "partOf", f"corp{i % 2}")
        r.add_abox_triple(f"corp{i % 2}", "locatedIn", "city")
        r.add_abox_triple(f"p{i}", "age", f'"{20 + i}"')
        r.add_abox_triple(f"p{i}", "knows", f"p{(i + 1) % n}")
        if i % 4 == 0:
            r.add_abox_triple(f"p{i}", "retired", "yes")
    r.add_abox_triple("org1", "suspended", "yes")


# a program of interacting rules: a 3-premise rule with a numeric filter
# and a negated premise, a cascade, a recursive rule, a multi-head rule
PROGRAM = [
    ([("?x", "knows", "?y"), ("?y", "knows", "?z"), ("?x", "worksAt", "?o")],
     [("?z", "reachableFrom", "?o")], [("?x", "retired", "yes")], ("age", ">=", 25.0)),
    ([("?x", "worksAt", "?o"), ("?o", "partOf", "?c")], [("?x", "memberOf", "?c")], None, None),
    ([("?x", "memberOf", "?c"), ("?c", "locatedIn", "?l")], [("?x", "cityWorker", "?l")],
     None, None),
    ([("?a", "partOf", "?b"), ("?b", "locatedIn", "?c")], [("?a", "locatedIn", "?c")], None, None),
    ([("?x", "worksAt", "?o")], [("?x", "stable", "yes"), ("?o", "hasStaff", "?x")],
     [("?o", "suspended", "yes")], None),
]


def program_reasoner(Reasoner, Filter, **kw):
    r = Reasoner(**kw)
    base_facts(r)
    for prems, concls, negs, flt in PROGRAM:
        prems = list(prems)
        filters = None
        if flt is not None:
            # the filter reads ?a, bound by an extra age premise on ?x
            prems = prems + [("?x", flt[0], "?a")]
            filters = [Filter("a", flt[1], flt[2])]
        r.add_rule(r.rule_from_strings(prems, concls, negative=negs, filters=filters))
    return r


def test_dist_general_program_matches_reference_and_host(meshes):
    rmesh, pmesh = meshes
    ref = program_reasoner(RefReasoner, RefFilter)
    R.distributed_seminaive_general(rmesh, ref)
    port = program_reasoner(PortReasoner, PortFilter, device="cpu")
    derived = P.distributed_seminaive_general(pmesh, port)
    host = program_reasoner(PortReasoner, PortFilter, device="cpu")
    host.infer_new_facts_semi_naive()
    assert derived > 0
    assert port.facts.triples_set() == ref.facts.triples_set() == host.facts.triples_set()
    assert any(host.dictionary.decode(t[1]) == "reachableFrom" for t in host.facts.triples_set())


def test_dist_general_capacity_doubling_converges(meshes):
    _rmesh, pmesh = meshes
    port = program_reasoner(PortReasoner, PortFilter, device="cpu")
    dr = P.DistGeneralReasoner(pmesh, port, fact_cap=64, delta_cap=16, join_cap=16, bucket_cap=8)
    dr.infer()
    assert dr.attempts > 1
    host = program_reasoner(PortReasoner, PortFilter, device="cpu")
    host.infer_new_facts_semi_naive()
    assert port.facts.triples_set() == host.facts.triples_set()


@pytest.mark.parametrize("prems", [
    [("?x", "worksAt", "?o"), ("?y", "partOf", "?c")],  # cartesian
    [("?x", "?p", "?o"), ("?y", "?p", "?c")],  # joined only at the predicate
], ids=["cartesian", "predicate_position"])
def test_dist_general_unsupported_shapes(meshes, prems):
    _rmesh, pmesh = meshes
    r = PortReasoner(device="cpu")
    base_facts(r)
    r.add_rule(r.rule_from_strings(prems, [("?x", "linked", "?o")]))
    with pytest.raises(P.dist_general.Unsupported):
        P.distributed_seminaive_general(pmesh, r)
