"""ORDER BY … LIMIT: the PyTorch port's device top-k against the JAX
package's.

End to end, the reference's ordered corpus (``tests/test_device_
engine.py``: numeric keys with DESC and OFFSET, string keys through the
global string ranks, mixed directions, a failed constant guard, fused
OPTIONAL / MINUS, an inlined subquery) runs through both
``execute_query_volcano``: the rows equal in order, and the port serves
each through ``try_device_execute_ordered`` as the reference does.

``_order_limit`` itself is held against the reference's on the same random
columns (ties, invalid rows, non-numeric keys, quoted IDs, both
directions): the selected rows and the non-numeric flag, exactly.  The
string ranks (``device_string_ranks``) equal the reference's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke as CS
import kolibrie_tpu_torch as port
from kolibrie_tpu.ops.jax_compat import enable_x64
from kolibrie_tpu.query.executor import execute_query_volcano as ref_execute
from kolibrie_tpu.query.sparql_database import SparqlDatabase as RefDatabase
from test_torch_clauses import PREFIXES, employee_db, pair
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)


@pytest.fixture(scope="module")
def employees():
    return pair(employee_db())


@pytest.fixture(scope="module")
def unique_salaries():
    ref = RefDatabase()
    lines = []
    for i in range(97):
        e = f"<http://example.org/e{i}>"
        lines.append(f'{e} <http://example.org/salary> "{1000 * i}" .')
        lines.append(f'{e} <http://example.org/dept> "dept{i % 5}" .')
    ref.parse_ntriples("\n".join(lines))
    return pair(ref)


@pytest.fixture(scope="module")
def people():
    ref = RefDatabase()
    lines = []
    for i in range(150):
        lines.append(f'<http://e/p{i}> <http://e/name> "person {i:03d}" .')
        lines.append(f'<http://e/p{i}> <http://e/dept> "d{i % 7}" .')
        lines.append(f'<http://e/p{i}> <http://e/salary> "{1000 + i * 3}" .')
    ref.parse_ntriples("\n".join(lines))
    return pair(ref)


ORDERED = {
    # (database fixture, query, whether the device top-k serves it)
    "numeric_desc": ("unique_salaries", "SELECT ?e ?s WHERE { ?e ex:salary ?s . ?e ex:dept ?d } "
                     "ORDER BY DESC(?s) LIMIT 7", True),
    "numeric_offset": ("unique_salaries", "SELECT ?e ?s WHERE { ?e ex:salary ?s . ?e ex:dept ?d } "
                       "ORDER BY ?s LIMIT 5 OFFSET 3", True),
    "string_keys": ("employees", "SELECT ?e ?d WHERE { ?e ex:dept ?d . ?e ex:salary ?s } "
                    "ORDER BY ?d ?e LIMIT 9", True),
    "ties_in_plan_order": ("employees", "SELECT ?e ?s ?w WHERE { ?e ex:salary ?s . "
                           "?e foaf:workplaceHomepage ?w } ORDER BY DESC(?s) LIMIT 23", True),
    "constant_absent": ("employees", 'SELECT ?e ?s WHERE { ?e ex:salary ?s . '
                        '<http://example.org/e0> ex:dept "no-such-dept" . } ORDER BY ?s LIMIT 5',
                        True),
    "string_desc": ("people", "SELECT ?p ?n WHERE { ?p <http://e/name> ?n . ?p <http://e/dept> ?d }"
                    " ORDER BY DESC(?n) LIMIT 9", True),
    "string_asc": ("people", "SELECT ?p ?n ?s WHERE { ?p <http://e/name> ?n . "
                   "?p <http://e/salary> ?s } ORDER BY ?n LIMIT 6", True),
    "string_then_numeric": ("people", "SELECT ?p ?d ?s WHERE { ?p <http://e/dept> ?d . "
                            "?p <http://e/salary> ?s } ORDER BY ?d DESC(?s) LIMIT 8", True),
    "with_minus_optional": ("employees", "SELECT ?e ?s WHERE { ?e ex:salary ?s . "
                            "OPTIONAL { ?e ex:knows ?y } MINUS { ?e ex:dept \"dept4\" } } "
                            "ORDER BY DESC(?s) LIMIT 7", True),
    "with_subquery": ("employees", "SELECT ?e ?s WHERE { ?e ex:salary ?s . "
                      "{ SELECT ?e WHERE { ?e ex:dept \"dept2\" } } } ORDER BY ?s LIMIT 5", True),
    # shapes the top-k declines: the host orders the device table
    "key_not_projected": ("employees", "SELECT ?e WHERE { ?e ex:salary ?s } "
                          "ORDER BY DESC(?s) ?e LIMIT 4", False),
    "distinct": ("employees", "SELECT DISTINCT ?s WHERE { ?e ex:salary ?s } "
                 "ORDER BY DESC(?s) LIMIT 4", False),
}


@pytest.mark.parametrize("name", sorted(ORDERED))
def test_ordered_queries_match_reference(request, name):
    fixture, q, on_device = ORDERED[name]
    ref, tdb = request.getfixturevalue(fixture)
    q = PREFIXES + q
    want = ref_execute(q, ref)
    with CS.RouteSpy() as spy:
        got = port.execute_query_volcano(q, tdb)
    assert got == want
    if name != "constant_absent":
        assert got
    assert (spy.route() == "ordered") == on_device


def test_string_ranks_match_reference(people):
    from kolibrie_tpu.optimizer.device_engine import device_string_ranks as ref_ranks
    from kolibrie_tpu_torch.optimizer.device_engine import device_string_ranks as port_ranks

    ref, tdb = people
    with enable_x64(True):
        want = [np.asarray(a) for a in ref_ranks(ref)]
    for a, b in zip(want, port_ranks(tdb)):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("seed", range(4))
def test_order_limit_matches_reference(seed):
    from kolibrie_tpu.optimizer.device_engine import _order_limit as ref_topk
    from kolibrie_tpu_torch.optimizer.device_engine import _order_limit as port_topk

    rng = np.random.default_rng(seed)
    n, n_ids, k = 2000, 300, 64
    numf = np.round(rng.normal(0, 5, n_ids))  # many ties
    if seed % 2:
        numf[rng.random(n_ids) < 0.1] = np.nan  # a non-numeric key value
    numf = np.concatenate([numf, np.full(212, np.nan)])
    dranks = rng.permutation(n_ids + 212).astype(np.float64)
    qranks = rng.permutation(16).astype(np.float64)
    a = rng.integers(0, n_ids, n).astype(np.uint32)
    b = rng.integers(0, n_ids, n).astype(np.uint32)
    quoted = rng.random(n) < 0.05  # quoted IDs: bit 31 over a qid below 16
    b[quoted] = np.uint32(0x80000000) | (b[quoted] & 15)
    c = np.arange(n, dtype=np.uint32)
    valid = rng.random(n) < 0.9
    cols = (a, b, c)
    opos, descs = (0, 1), (bool(seed & 2), not seed & 2)
    for ranks in (False, True):
        with enable_x64(True):
            import jax.numpy as jnp

            extra = (jnp.asarray(dranks), jnp.asarray(qranks)) if ranks else ()
            rc, rv, rn, rnan = ref_topk(
                tuple(jnp.asarray(x) for x in cols), jnp.asarray(valid),
                jnp.asarray(numf), opos, descs, k, *extra,
            )
            rc = [np.asarray(x).astype(np.int64) for x in rc]
            rv, rn, rnan = np.asarray(rv), int(rn), bool(rnan)
        extra = (torch.from_numpy(dranks), torch.from_numpy(qranks)) if ranks else ()
        tc, tv, tn, tnan = port_topk(
            tuple(torch.from_numpy(x.astype(np.int64)) for x in cols), torch.from_numpy(valid),
            torch.from_numpy(numf), opos, descs, k, *extra,
        )
        assert (int(tn), bool(tnan)) == (rn, rnan)
        np.testing.assert_array_equal(tv.numpy(), rv)
        for x, y in zip(rc, tc):
            np.testing.assert_array_equal(x[rv], y.numpy()[rv])
