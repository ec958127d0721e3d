"""Sub-SELECTs: the PyTorch port against the JAX package's device engine
on the reference's subquery fuzz (``tests/test_subquery_inline.py``, seed
20260731): random outer BGPs joined with a projected sub-SELECT, which
both packages inline before planning.  Sorted rows are compared exactly.
"""

from __future__ import annotations

import random

import kolibrie_tpu_torch as port
from kolibrie_tpu.query.executor import execute_query_volcano as ref_execute
from kolibrie_tpu.query.sparql_database import SparqlDatabase as RefDatabase
from test_torch_clauses import pair, rows


def test_subquery_fuzz_matches_reference():
    """The reference's subquery fuzz (seed 20260731): random outer BGPs
    with a projected sub-SELECT, inlined by both packages."""
    rng = random.Random(20260731)
    lines = []
    preds = [f"<http://f.e/p{k}>" for k in range(4)]
    for _i in range(400):
        s = f"<http://f.e/s{rng.randrange(60)}>"
        pr = rng.choice(preds)
        o = (
            f"<http://f.e/s{rng.randrange(60)}>" if rng.random() < 0.5
            else f'"{rng.randrange(0, 3000)}"'
        )
        lines.append(f"{s} {pr} {o} .")
    ref = RefDatabase()
    ref.parse_ntriples("\n".join(lines))
    ref, tdb = pair(ref)
    vars_pool = ["?a", "?b", "?c"]

    def rand_bgp(shared_var):
        pats, used = [], []
        for j in range(rng.randrange(1, 3)):
            s = shared_var if j == 0 and shared_var else rng.choice(vars_pool)
            o = rng.choice(vars_pool + [f"<http://f.e/s{rng.randrange(60)}>"])
            pats.append(f"{s} {rng.choice(preds)} {o} .")
            for t in (s, o):
                if t.startswith("?") and t not in used:
                    used.append(t)
        filt = ""
        if used and rng.random() < 0.4:
            v = rng.choice(used)
            filt = f"FILTER({v} {rng.choice(['>', '<', '>=', '!='])} {rng.randrange(0, 3000)})"
        return pats, used, filt

    checked = 0
    for _trial in range(25):
        opats, oused, ofilt = rand_bgp(None)
        share = rng.choice(oused) if oused and rng.random() < 0.8 else None
        ipats, iused, ifilt = rand_bgp(share)
        proj = sorted(
            set(rng.sample(iused, rng.randrange(1, len(iused) + 1)))
            | ({share} if share else set())
        )
        sub = f"{{ SELECT {' '.join(proj)} WHERE {{ {' '.join(ipats)} {ifilt} }} }}"
        sel_vars = sorted(set(oused) | set(proj))
        q = f"SELECT {' '.join(sel_vars)} WHERE {{ {' '.join(opats)} {ofilt} {sub} }}"
        try:
            got = rows(port.execute_query_volcano, tdb, q)
        except port.Unsupported as e:
            # a cartesian product, which the reference runs on its host
            # engine and the port does not run
            assert "cartesian" in str(e), q
            continue
        assert got == rows(ref_execute, ref, q), q
        checked += 1
    assert checked >= 15
