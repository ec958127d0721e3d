"""Randomized group patterns: the PyTorch port against the JAX package's
device engine on the reference's own fuzz corpora and query generators
(``tests/test_device_engine.py`` MINUS/NOT and UNION/OPTIONAL fuzz),
with the same seeds.
Every query runs through both ``execute_query_volcano``; sorted rows are
compared exactly.
"""

from __future__ import annotations

import random

from kolibrie_tpu.query.sparql_database import SparqlDatabase as RefDatabase
from test_torch_clauses import assert_same, pair
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)


def test_clause_fuzz_matches_reference():
    """The reference's MINUS/NOT and UNION/OPTIONAL fuzz corpora (seeds
    20260732 and 20260733), queries run through both engines."""
    for seed in (20260732, 20260733):
        rng = random.Random(seed)
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
        for _trial in range(8):
            pats, used = [], []
            for _ in range(rng.randrange(1, 3)):
                s = rng.choice(used) if used and rng.random() < 0.8 else rng.choice(vars_pool)
                o = rng.choice(vars_pool + [f"<http://f.e/s{rng.randrange(60)}>"])
                pats.append(f"{s} {rng.choice(preds)} {o} .")
                for t in (s, o):
                    if t.startswith("?") and t not in used:
                        used.append(t)
            share = rng.choice(used)
            kind = rng.randrange(4)
            if kind == 0:
                b1 = f"{{ {share} {rng.choice(preds)} <http://f.e/s{rng.randrange(60)}> }}"
                b2 = f"{{ {share} {rng.choice(preds)} ?u }}"
                clauses = f"{b1} UNION {b2}"
            elif kind == 1:
                clauses = f"OPTIONAL {{ {share} {rng.choice(preds)} ?v }}"
            elif kind == 2:
                clauses = (
                    f"OPTIONAL {{ {share} {rng.choice(preds)} ?v }} "
                    f"MINUS {{ {share} {rng.choice(preds)} <http://f.e/s{rng.randrange(60)}> }}"
                )
            else:
                bo = rng.choice(vars_pool + [f"<http://f.e/s{rng.randrange(60)}>"])
                kw = rng.choice(["MINUS", "NOT"])
                filt = (
                    f"FILTER({bo} > {rng.randrange(0, 3000)})"
                    if kw == "MINUS" and bo.startswith("?") and rng.random() < 0.4
                    else ""
                )
                clauses = f"{kw} {{ {share} {rng.choice(preds)} {bo} . {filt} }}"
            q = f"SELECT {' '.join(used)} WHERE {{ {' '.join(pats)} {clauses} }}"
            assert_same(ref, tdb, q)
