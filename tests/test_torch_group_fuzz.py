"""Whole group patterns: the PyTorch port against the JAX package's device
engine on the reference's interaction fuzz (``tests/test_group_pattern_
fuzz.py``, seeds 20260734 and 20260735): random SELECTs mixing BGPs,
FILTERs, inlined sub-SELECTs, UNION, OPTIONAL, MINUS, NOT, ORDER BY +
LIMIT and GROUP BY counts, so the clause fusions compose with each other
and with the aggregate and top-k routes.  The first ``N_TRIALS`` queries
of the generator run (the reference runs 40).

Compared exactly: sorted rows, and for ORDER BY + LIMIT the rows in order
(both packages take the device top-k, so ties resolve alike).
"""

from __future__ import annotations

import random

import pytest

import kolibrie_tpu_torch as port
from kolibrie_tpu.query.executor import execute_query_volcano as ref_execute
from kolibrie_tpu.query.sparql_database import SparqlDatabase as RefDatabase
from test_torch_clauses import pair

SEED = 20260734
N_TRIALS = 16


@pytest.fixture(scope="module")
def dbs():
    rng = random.Random(SEED)
    lines = []
    preds = [f"<http://g.e/p{k}>" for k in range(5)]
    for _i in range(500):
        s = f"<http://g.e/s{rng.randrange(70)}>"
        pr = rng.choice(preds)
        o = (
            f"<http://g.e/s{rng.randrange(70)}>" if rng.random() < 0.5
            else f'"{rng.randrange(0, 4000)}"'
        )
        lines.append(f"{s} {pr} {o} .")
    ref = RefDatabase()
    ref.parse_ntriples("\n".join(lines))
    return pair(ref)


def _rand_bgp(rng, preds, vars_pool, anchor=None, max_pats=2):
    pats, used = [], []
    for j in range(rng.randrange(1, max_pats + 1)):
        s = anchor if j == 0 and anchor else (
            rng.choice(used) if used and rng.random() < 0.7 else rng.choice(vars_pool)
        )
        o = rng.choice(vars_pool + [f"<http://g.e/s{rng.randrange(70)}>"])
        pats.append(f"{s} {rng.choice(preds)} {o} .")
        for t in (s, o):
            if t.startswith("?") and t not in used:
                used.append(t)
    return pats, used


def _queries():
    """The reference generator's queries, in order, with their mode."""
    rng = random.Random(SEED + 1)
    preds = [f"<http://g.e/p{k}>" for k in range(5)]
    vars_pool = ["?a", "?b", "?c", "?d"]
    for _trial in range(N_TRIALS):
        pats, used = _rand_bgp(rng, preds, vars_pool, max_pats=3)
        parts = [" ".join(pats)]
        if rng.random() < 0.4:
            v = rng.choice(used)
            parts.append(
                f"FILTER({v} {rng.choice(['>', '<', '>=', '!='])} {rng.randrange(0, 4000)})"
            )
        anchor = rng.choice(used)
        bound_out = set(used)
        if rng.random() < 0.45:
            ipats, iused = _rand_bgp(rng, preds, ["?u", "?v"], anchor=anchor)
            proj = {anchor} | ({rng.choice(iused)} if rng.random() < 0.5 else set())
            proj &= set(iused)
            if proj:
                parts.append(
                    f"{{ SELECT {' '.join(sorted(proj))} WHERE {{ {' '.join(ipats)} }} }}"
                )
                bound_out |= proj
        if rng.random() < 0.45:
            b1, u1 = _rand_bgp(rng, preds, ["?m"], anchor=anchor, max_pats=1)
            b2, u2 = _rand_bgp(rng, preds, ["?m"], anchor=anchor, max_pats=1)
            parts.append(f"{{ {' '.join(b1)} }} UNION {{ {' '.join(b2)} }}")
            bound_out |= set(u1) | set(u2)
        if rng.random() < 0.45:
            op, ou = _rand_bgp(rng, preds, ["?w"], anchor=anchor, max_pats=1)
            parts.append(f"OPTIONAL {{ {' '.join(op)} }}")
            bound_out |= set(ou)
        if rng.random() < 0.45:
            mp, _mu = _rand_bgp(rng, preds, [anchor], anchor=anchor, max_pats=1)
            parts.append(f"{rng.choice(['MINUS', 'NOT'])} {{ {' '.join(mp)} }}")
        mode = rng.randrange(3)
        if mode == 0:
            q = f"SELECT {' '.join(sorted(bound_out))} WHERE {{ {' '.join(parts)} }}"
        elif mode == 1:
            key = rng.choice(sorted(used))
            q = (
                f"SELECT {' '.join(sorted(used))} WHERE {{ {' '.join(parts)} }} "
                f"ORDER BY {key} LIMIT {rng.randrange(3, 12)}"
            )
        else:
            key = rng.choice(sorted(used))
            q = (
                f"SELECT {key} (COUNT(*) AS ?n) WHERE {{ {' '.join(parts)} }} GROUP BY {key}"
            )
        yield mode, q


def test_group_pattern_fuzz_matches_reference(dbs):
    ref, tdb = dbs
    checked = 0
    for mode, q in _queries():
        try:
            got = port.execute_query_volcano(q, tdb)
        except port.Unsupported as e:
            # a cartesian product, which the reference runs on its host
            # engine and the port does not run
            assert "cartesian" in str(e), q
            continue
        want = ref_execute(q, ref)
        if mode == 1:
            assert got == want, q
        else:
            assert sorted(got) == sorted(want), q
        checked += 1
    assert checked >= N_TRIALS * 2 // 3
