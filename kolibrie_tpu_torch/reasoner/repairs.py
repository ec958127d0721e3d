"""Inconsistency-tolerant inference: repairs + constraint-guarded semi-naive.

Port of ``kolibrie_tpu/reasoner/repairs.py`` (a copy, the imports rewritten).

Parity: ``datalog/src/reasoning/materialisation/semi_naive_with_repairs.rs``
(:11-73) — pre-repair the inconsistent base (largest repair wins), then run
semi-naive where each candidate inference is checked against the constraints
before commit — and ``reasoning/repairs.rs`` IAR querying (handled by
``Reasoner.query_with_repairs``).
"""

from __future__ import annotations

from typing import List

import numpy as np

from kolibrie_tpu_torch.reasoner.strategies import (
    eval_rule_body,
    instantiate_conclusions,
    subtract_existing,
    table_len,
)


def infer_semi_naive_with_repairs(reasoner) -> int:
    # 1. pre-repair: if the base is inconsistent, replace it with the largest
    #    repair (semi_naive_with_repairs.rs:11-30)
    if reasoner.constraints and reasoner.violates_constraints():
        repairs = reasoner.compute_repairs()
        if repairs:
            best = max(repairs, key=len)
            reasoner.facts.clear()
            if best:
                arr = np.asarray(sorted(best), dtype=np.uint32)
                reasoner.facts.add_batch(arr[:, 0], arr[:, 1], arr[:, 2])
    # 2. semi-naive where each candidate batch is constraint-checked before
    #    commit; violating candidates are dropped individually
    total = 0
    s, p, o = reasoner.facts.columns()
    delta = (s, p, o)
    while len(delta[0]) > 0:
        accepted: List = []
        # one shared test set per round; accepted candidates stay in,
        # violating ones are removed again.  COPY: triples_set() returns the
        # store's per-version memo, which must stay unmutated.
        test = set(reasoner.facts.triples_set())
        for rule in reasoner.rules:
            table = eval_rule_body(reasoner, rule, reasoner.facts, delta=delta)
            if table_len(table) == 0:
                continue
            cols = instantiate_conclusions(rule, table, reasoner.quoted)
            cols = subtract_existing(reasoner.facts, cols)
            cs, cp, co = cols
            for i in range(len(cs)):
                cand = (int(cs[i]), int(cp[i]), int(co[i]))
                if cand in test:
                    continue
                test.add(cand)
                if reasoner.violates_constraints(test):
                    test.discard(cand)
                else:
                    accepted.append(cand)
        if not accepted:
            break
        arr = np.asarray(accepted, dtype=np.uint32)
        before = len(reasoner.facts)
        reasoner.facts.add_batch(arr[:, 0], arr[:, 1], arr[:, 2])
        added = len(reasoner.facts) - before
        if added == 0:
            break
        total += added
        delta = (arr[:, 0], arr[:, 1], arr[:, 2])
    return total
