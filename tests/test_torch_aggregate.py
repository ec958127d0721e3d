"""GROUP BY aggregates: the PyTorch port against the JAX package's device
engine.

End to end, the reference's aggregate corpus (``tests/test_device_
engine.py``: shapes, COUNT(DISTINCT), three group variables, SAMPLE, an
infinite literal, aggregates over UNION / OPTIONAL / MINUS, GROUP_CONCAT
over a fused MINUS) runs through both ``execute_query_volcano``: rows equal
exactly (SAMPLE's pick included), and the port takes the reference's
route (device segment-reduce, or host aggregation over the device table).

The segment-reduce itself (``_segment_aggregate``) is held against the
reference's on the same random inputs, output for output: group IDs,
counts, and SUM / AVG / MIN / MAX bit for bit in float64 (non-integer
values, NaN for non-numeric, +-inf literals), SAMPLE's ID, the group
count, and the drop of groups past the capacity.  No tolerance is used:
on the CPU both add in row order.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke as CS
import kolibrie_tpu_torch as port
from kolibrie_tpu.ops.jax_compat import enable_x64
from kolibrie_tpu.query.executor import execute_query_volcano as ref_execute
from test_torch_clauses import PREFIXES, employee_db, pair


@pytest.fixture(scope="module")
def employees():
    return pair(employee_db())


AGG_QUERIES = {
    "multi_agg": "SELECT ?d (COUNT(?e) AS ?n) (SUM(?s) AS ?sum) (MIN(?s) AS ?lo) "
    "(MAX(?s) AS ?hi) WHERE { ?e ex:dept ?d . ?e ex:salary ?s } GROUP BY ?d",
    "two_group_vars": "SELECT ?d ?w (COUNT(?e) AS ?n) WHERE { ?e ex:dept ?d . "
    "?e foaf:workplaceHomepage ?w } GROUP BY ?d ?w",
    "no_group_by": "SELECT (COUNT(?e) AS ?n) (AVG(?s) AS ?avg) WHERE { ?e ex:salary ?s }",
    "count": "SELECT ?d (COUNT(?e) AS ?n) WHERE { ?e ex:dept ?d } GROUP BY ?d",
    "count_star": "SELECT ?d (COUNT(*) AS ?n) WHERE { ?e ex:dept ?d } GROUP BY ?d",
    "filtered": "SELECT ?d (COUNT(?e) AS ?n) WHERE { ?e ex:dept ?d . ?e ex:salary ?s . "
    "FILTER(?s > 50000) } GROUP BY ?d",
    "count_distinct": "SELECT ?d (COUNT(DISTINCT ?w) AS ?n) WHERE { ?e ex:dept ?d . "
    "?e foaf:workplaceHomepage ?w } GROUP BY ?d",
    "three_group_vars": "SELECT ?d ?w ?s (COUNT(?e) AS ?n) WHERE { ?e ex:dept ?d . "
    "?e foaf:workplaceHomepage ?w . ?e ex:salary ?s } GROUP BY ?d ?w ?s",
    "sample": "SELECT ?d (SAMPLE(?w) AS ?any) (SAMPLE(?e) AS ?who) WHERE { ?e ex:dept ?d . "
    "?e foaf:workplaceHomepage ?w } GROUP BY ?d",
    "over_union": "SELECT ?d (COUNT(?e) AS ?c) WHERE { ?e ex:dept ?d "
    "{ ?e ex:salary ?s } UNION { ?e ex:knows ?y } } GROUP BY ?d",
    "over_optional": "SELECT ?d (COUNT(?y) AS ?c) WHERE { ?e ex:dept ?d . "
    "OPTIONAL { ?e ex:knows ?y } } GROUP BY ?d",
    "over_minus": "SELECT ?d (COUNT(?e) AS ?c) WHERE { ?e ex:dept ?d "
    "MINUS { ?e ex:knows ?y } } GROUP BY ?d",
    "empty_no_group_by": "SELECT (COUNT(?e) AS ?n) (SUM(?s) AS ?t) (SAMPLE(?e) AS ?x) WHERE { "
    "?e ex:salary ?s . FILTER(?s > 999999) }",
    "empty_groups": "SELECT ?d (COUNT(?e) AS ?n) WHERE { ?e ex:dept ?d . ?e ex:salary ?s . "
    "FILTER(?s > 999999) } GROUP BY ?d",
    "distinct_groups": "SELECT DISTINCT (COUNT(?e) AS ?n) WHERE { ?e ex:dept ?d } GROUP BY ?d",
}
# aggregates the reference leaves to its host aggregation over the device
# table (fused when the WHERE has clauses)
HOST_AGGREGATION = {
    "group_concat_over_minus": ("SELECT ?d (GROUP_CONCAT(?e) AS ?c) WHERE { ?e ex:dept ?d "
                                "MINUS { ?e ex:knows ?y } } GROUP BY ?d", "fused"),
    "sum_distinct": ("SELECT ?d (SUM(DISTINCT ?s) AS ?t) WHERE { ?e ex:dept ?d . "
                     "?e ex:salary ?s } GROUP BY ?d", "device"),
    "expression_item": ("SELECT ?d (COUNT(?e) AS ?n) (?d AS ?dd) WHERE { ?e ex:dept ?d } "
                        "GROUP BY ?d", "device"),
}


@pytest.mark.parametrize("name", sorted(AGG_QUERIES))
def test_device_aggregates_match_reference(employees, name):
    ref, tdb = employees
    q = PREFIXES + AGG_QUERIES[name]
    want = ref_execute(q, ref)
    with CS.RouteSpy() as spy:
        got = port.execute_query_volcano(q, tdb)
    assert got == want
    assert spy.route() == "aggregated"


@pytest.mark.parametrize("name", sorted(HOST_AGGREGATION))
def test_host_aggregation_routes_match_reference(employees, name):
    ref, tdb = employees
    q, route = HOST_AGGREGATION[name]
    q = PREFIXES + q
    want = ref_execute(q, ref)
    with CS.RouteSpy() as spy:
        got = port.execute_query_volcano(q, tdb)
    assert got == want
    assert spy.route() == route


def test_infinite_literal_survives(employees):
    """"1e999" is +inf: MAX keeps it, MIN is unaffected; emptiness comes
    from the count, not the reduction's identity."""
    ref, tdb = pair(employee_db())
    line = '<http://example.org/e0> <http://example.org/salary> "1e999" .'
    ref.parse_ntriples(line)
    tdb.parse_ntriples(line)
    for func in ("MAX", "MIN"):
        q = PREFIXES + (f"SELECT ?d ({func}(?s) AS ?m) WHERE {{ ?e ex:dept ?d . "
                        "?e ex:salary ?s } GROUP BY ?d")
        got = port.execute_query_volcano(q, tdb)
        assert got == ref_execute(q, ref)
        assert any("inf" in r[1] for r in got) == (func == "MAX")


def test_aggregate_tables_match_reference_ids(employees):
    """The aggregate route's host table, ID for ID (both dictionaries
    intern the same number literals in the same order)."""
    from kolibrie_tpu.query.executor import _try_device_aggregate as ref_agg
    from kolibrie_tpu.query.parser import parse_sparql_query as ref_parse
    from kolibrie_tpu_torch.query.executor import _try_device_aggregate as port_agg
    from kolibrie_tpu_torch.query.parser import parse_sparql_query as port_parse

    ref, tdb = pair(employee_db())
    for name in ("multi_agg", "sample", "count_distinct", "over_optional"):
        q = PREFIXES + AGG_QUERIES[name]
        ref.register_prefixes_from_query(q)
        tdb.register_prefixes_from_query(q)
        want, _p, _l = ref_agg(ref, ref_parse(q, ref.prefixes), True)
        got, _p, _l = port_agg(tdb, port_parse(q, tdb.prefixes))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        assert ref.dictionary.id_to_str == tdb.dictionary.id_to_str


# ------------------------------------------------------- _segment_aggregate

FUNCS = ("COUNT", "COUNT", "COUNT", "SUM", "AVG", "MIN", "MAX", "SAMPLE")


def _segment_case(seed: int, n: int, n_keys: int, cap: int):
    rng = np.random.default_rng(seed)
    n_ids = 64
    numf = rng.normal(50.0, 30.0, n_ids)  # non-integer values
    numf[rng.random(n_ids) < 0.2] = np.nan  # non-numeric terms
    numf[5], numf[6] = np.inf, -np.inf
    numf = np.concatenate([numf, np.full(64, np.nan)])  # padded, as on the card
    keys = [rng.integers(1, 7, n).astype(np.uint32) for _ in range(n_keys)]
    vals = rng.integers(0, n_ids, n).astype(np.uint32)  # 0 = UNBOUND
    ids = rng.integers(1, 1 << 31, n).astype(np.uint32)
    valid = rng.random(n) < 0.8
    cols = keys + [vals, ids]
    gpos = tuple(range(n_keys))
    v, i = n_keys, n_keys + 1
    apos = (-1, v, v, v, v, v, v, i)
    distincts = (False, False, True, False, False, False, False, False)
    return cols, valid, numf, gpos, apos, distincts, cap


@pytest.mark.parametrize(
    "seed,n,n_keys,cap",
    [(1, 3000, 2, 1024), (2, 3000, 1, 1024), (3, 500, 0, 1024), (4, 4000, 3, 64), (5, 1, 1, 8)],
)
def test_segment_aggregate_matches_reference_bit_for_bit(seed, n, n_keys, cap):
    from kolibrie_tpu.optimizer.device_engine import _segment_aggregate as ref_seg
    from kolibrie_tpu_torch.optimizer.device_engine import _segment_aggregate as port_seg

    cols, valid, numf, gpos, apos, distincts, cap = _segment_case(seed, n, n_keys, cap)
    if seed == 5:
        valid[:] = False  # an empty input
    with enable_x64(True):
        import jax.numpy as jnp

        rg, ra, rn = ref_seg(
            tuple(jnp.asarray(c) for c in cols), jnp.asarray(valid),
            jnp.asarray(numf, dtype=jnp.float64), gpos, FUNCS, apos, distincts, cap,
        )
        rg = [np.asarray(c) for c in rg]
        ra = [np.asarray(a) for a in ra]
        rn = int(rn)
    tg, ta, tn = port_seg(
        tuple(torch.from_numpy(c.astype(np.int64)) for c in cols), torch.from_numpy(valid),
        torch.from_numpy(numf), gpos, FUNCS, apos, distincts, cap,
    )
    assert int(tn) == rn
    if n_keys and seed != 5:
        assert rn > 1
    for a, b in zip(rg, tg):
        np.testing.assert_array_equal(a.astype(np.int64), b.numpy())
    for func, a, b in zip(FUNCS, ra, ta):
        b = b.numpy()
        if func == "SAMPLE":
            np.testing.assert_array_equal(a.astype(np.int64), b)
        else:  # float64, bit for bit (NaN payloads aside)
            a64 = np.where(np.isnan(a), np.nan, a).view(np.int64)
            b64 = np.where(np.isnan(b), np.nan, b).view(np.int64)
            np.testing.assert_array_equal(a64, b64, err_msg=func)
