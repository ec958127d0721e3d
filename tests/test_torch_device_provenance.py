"""The port's device provenance fixpoint against the JAX package, on the
CPU.

Replays the cases of ``tests/test_device_provenance.py`` as parametrised
tests.  Each case is built as a JAX ``Reasoner`` and carried into the port
with ``Reasoner.from_arrays`` (same dictionary IDs, facts, probability
seeds and rules) and its seeded ``TagStore`` with ``TagStore.from_items``.
The JAX ``infer_provenance_device`` runs jitted on JAX's CPU, the port's on
torch's CPU with its kernels' plain versions.  Both must give the same
facts, the same TagStore (exact for the idempotent semirings, within 1e-9
per tag for AddMult), the same dispatches — each round and NAF pass with
its capacities and overflow code, so the same rounds and attempts — and
``None`` exactly where JAX returns ``None``.  The port's host loop is held
against its device path on every accepted case, and against the JAX host
loop where the device declines.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from kolibrie_tpu.core.rule import FilterCondition
from kolibrie_tpu.core.triple import Triple
from kolibrie_tpu.ops import device_join as jdj
from kolibrie_tpu.reasoner import device_provenance as jdp
from kolibrie_tpu.reasoner import provenance as jprov
from kolibrie_tpu.reasoner import provenance_seminaive as jps
from kolibrie_tpu.reasoner.reasoner import Reasoner as JaxReasoner
from kolibrie_tpu_torch.ops import device_join as tdj
from kolibrie_tpu_torch.ops import kernels as K
from kolibrie_tpu_torch.reasoner import device_provenance as tdp
from kolibrie_tpu_torch.reasoner import provenance as tprov
from kolibrie_tpu_torch.reasoner import provenance_seminaive as tps
from kolibrie_tpu_torch.reasoner.tag_store import TagStore
from test_torch_reasoner import port_rule
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

SEMIRINGS = {
    "minmax": (jprov.MinMaxProbability, tprov.MinMaxProbability),
    "boolean": (jprov.BooleanProvenance, tprov.BooleanProvenance),
    "expiration": (jprov.ExpirationProvenance, tprov.ExpirationProvenance),
    "addmult": (jprov.AddMultProbability, tprov.AddMultProbability),
}


def carry(jr: JaxReasoner):
    """The port's reasoner on the CPU holding ``jr``'s state, seeds and
    rules."""
    from kolibrie_tpu_torch import Reasoner

    pr = Reasoner.from_arrays(
        jr.dictionary.id_to_str, *jr.facts.columns(), quoted=jr.quoted.id_to_triple,
        device="cpu", probability_seeds=jr.probability_seeds,
    )
    for r in jr.rules:
        pr.add_rule(port_rule(r))
    return pr


def assert_same_tags(want: dict, got: dict, addmult: bool, tol: float = 1e-9):
    assert set(want) == set(got)
    for k, v in want.items():
        if addmult:
            assert abs(v - got[k]) <= tol, (k, v, got[k])
        else:
            assert got[k] == v and type(got[k]) is type(v), (k, v, got[k])


class JaxDispatches:
    """Records the JAX driver's dispatches as the port's ``LAST_RUN`` does:
    ``(kind, caps, overflow code)``."""

    KINDS = {"_prov_round": ("round", 10), "_prov_naf_pass": ("naf", 10),
             "_prov_round_addmult": ("round_addmult", 7),
             "_prov_naf_pass_addmult": ("naf_addmult", 9)}

    def __init__(self, monkeypatch):
        self.log = []
        for attr, (kind, at) in self.KINDS.items():
            orig = getattr(jdp, attr)

            def rec(*a, _orig=orig, _kind=kind, _at=at, **k):
                out = _orig(*a, **k)
                c = a[1]
                caps = (c.fact, c.delta, c.join) + ((a[2],) if _kind == "naf_addmult" else ())
                self.log.append((_kind, caps, int(out[_at])))
                return out

            monkeypatch.setattr(jdp, attr, rec)


# ------------------------------------------------------------------ cases
# Each builder returns a JAX reasoner; ``tags`` sets explicit TagStore
# entries after seeding (the S2R window feed's expiries), ``delta`` names
# the initial delta, ``late_rules`` are added after seeding.


def _chain(n=20, prob=True):
    r = JaxReasoner()
    for i in range(n):
        if prob:
            r.add_tagged_triple(f"n{i}", "next", f"n{i + 1}", 0.5 + 0.02 * (i % 20))
        else:
            r.add_abox_triple(f"n{i}", "next", f"n{i + 1}")
    r.add_rule(r.rule_from_strings(
        [("?x", "next", "?y"), ("?y", "next", "?z")], [("?x", "next", "?z")]))
    return r


def _boolean():
    r = JaxReasoner()
    for i in range(12):
        r.add_abox_triple(f"p{i}", "worksAt", f"org{i % 3}")
        r.add_abox_triple(f"org{i % 3}", "partOf", "corp")
    r.add_rule(r.rule_from_strings(
        [("?x", "worksAt", "?o"), ("?o", "partOf", "?c")], [("?x", "memberOf", "?c")]))
    return r


def _observes():
    r = JaxReasoner()
    for i in range(15):
        r.add_abox_triple(f"s{i}", "observes", f"s{i + 1}")
    return r


def _observes_rule(r):
    r.add_rule(r.rule_from_strings(
        [("?x", "observes", "?y"), ("?y", "observes", "?z")], [("?x", "reaches", "?z")]))


def _expiries(base, step):
    def tags(r, store):
        s, p, o = r.facts.columns()
        for j, k in enumerate(zip(s.tolist(), p.tolist(), o.tolist())):
            store.tags[Triple(*k)] = base + step * j
    return tags


def _improvement():
    r = JaxReasoner()
    r.add_tagged_triple("a", "next", "c", 0.1)
    r.add_tagged_triple("a", "next", "b", 0.9)
    r.add_tagged_triple("b", "next", "c", 0.8)
    r.add_tagged_triple("c", "next", "d", 0.7)
    r.add_rule(r.rule_from_strings(
        [("?x", "next", "?y"), ("?y", "next", "?z")], [("?x", "next", "?z")]))
    return r


def _delta_pair(r):
    d = r.dictionary
    return {(d.encode("n3"), d.encode("next"), d.encode("n4")),
            (d.encode("n7"), d.encode("next"), d.encode("n8"))}


def _filter_rule():
    r = JaxReasoner()
    for i in range(14):
        r.add_tagged_triple(f"item{i}", "price", f'"{i * 10}"', 0.3 + 0.05 * (i % 10))
    r.add_rule(r.rule_from_strings(
        [("?x", "price", "?v")], [("?x", "expensive", "yes")],
        filters=[FilterCondition("v", ">", 60.0)]))
    return r


def _rederived():
    r = JaxReasoner()
    r.add_abox_triple("a", "next", "c")
    r.add_tagged_triple("a", "next", "b", 0.6)
    r.add_tagged_triple("b", "next", "c", 0.5)
    r.add_rule(r.rule_from_strings(
        [("?x", "next", "?y"), ("?y", "next", "?z")], [("?x", "next", "?z")]))
    return r


def _diamond():
    r = JaxReasoner()
    r.add_tagged_triple("a", "left", "m1", 0.8)
    r.add_tagged_triple("m1", "right", "z", 0.7)
    r.add_tagged_triple("a", "left", "m2", 0.6)
    r.add_tagged_triple("m2", "right", "z", 0.5)
    r.add_rule(r.rule_from_strings(
        [("?x", "left", "?y"), ("?y", "right", "?z")], [("?x", "reaches", "?z")]))
    return r


def _cyclic():
    r = JaxReasoner()
    r.add_tagged_triple("a", "p", "b", 0.9)
    r.add_tagged_triple("b", "p", "c", 0.8)
    r.add_tagged_triple("c", "p", "a", 0.7)
    r.add_rule(r.rule_from_strings(
        [("?x", "p", "?y"), ("?y", "p", "?z")], [("?x", "p", "?z")]))
    return r


def _filters_constants():
    r = JaxReasoner()
    for i in range(8):
        r.add_tagged_triple(f"s{i}", "score", f"v{i}", 0.3 + 0.05 * i)
        r.add_abox_triple(f"s{i}", "kind", "sensor")
    r.add_rule(r.rule_from_strings(
        [("?x", "score", "?v"), ("?x", "kind", "sensor")], [("?x", "flagged", "yes")],
        filters=[FilterCondition("x", "!=", r.dictionary.encode("s0"))]))
    return r


def _order_sensitive():
    r = JaxReasoner()
    for i in range(5):
        r.add_tagged_triple(f"n{i}", "next", f"n{i + 1}", 0.9)
        r.add_tagged_triple(f"n{i}", "alt", f"n{i + 1}", 0.4)
    r.add_rule(r.rule_from_strings(
        [("?x", "next", "?y"), ("?y", "next", "?z")], [("?x", "next", "?z")]))
    r.add_rule(r.rule_from_strings(
        [("?x", "alt", "?y"), ("?y", "next", "?z")], [("?x", "next", "?z")]))
    return r


def _independent_rules():
    r = JaxReasoner()
    for i in range(12):
        r.add_tagged_triple(f"n{i}", "next", f"n{i + 1}", 0.8)
        r.add_tagged_triple(f"n{i}", "alt", f"n{i + 1}", 0.4)
    r.add_rule(r.rule_from_strings(
        [("?x", "alt", "?y"), ("?y", "next", "?z")], [("?x", "near", "?z")]))
    r.add_rule(r.rule_from_strings(
        [("?x", "next", "?y"), ("?y", "next", "?z")], [("?x", "hop2", "?z")]))
    return r


def _first_fact(r):
    s, p, o = r.facts.columns()
    return {(int(s[0]), int(p[0]), int(o[0]))}


def _naf_blocked(tagged=False):
    def build():
        r = JaxReasoner()
        add = (lambda s, p, o, t: r.add_tagged_triple(s, p, o, t)) if tagged else (
            lambda s, p, o, t: r.add_abox_triple(s, p, o))
        add("a", "p", "b", 0.9)
        add("c", "p", "d", 0.8)
        add("b", "broken", "yes", 0.3)
        r.add_rule(r.rule_from_strings(
            [("?x", "p", "?y")], [("?x", "ok", "?y")], negative=[("?y", "broken", "yes")]))
        return r
    return build


def _naf_feed():
    r = JaxReasoner()
    r.add_abox_triple("a", "p", "x")
    r.add_rule(r.rule_from_strings(
        [("?v", "p", "?w")], [("?v", "q", "?w")], negative=[("missing", "r", "z")]))
    r.add_rule(r.rule_from_strings([("?v", "q", "?w")], [("?v", "s", "?w")]))
    return r


def _naf_only():
    r = JaxReasoner()
    r.add_tagged_triple("a", "type", "P", 0.9)
    r.add_tagged_triple("b", "type", "P", 0.8)
    r.add_tagged_triple("b", "blocked", "y", 0.4)
    r.add_rule(r.rule_from_strings(
        [("?x", "type", "P")], [("?x", "ok", "y")], negative=[("?x", "blocked", "y")]))
    return r


def _naf_expiration():
    r = JaxReasoner()
    r.add_abox_triple("a", "obs", "b")
    r.add_abox_triple("c", "obs", "d")
    r.add_abox_triple("b", "down", "yes")
    r.add_abox_triple("d", "down", "yes")
    return r


def _naf_expiration_tags(r, store):
    d = r.dictionary
    for (es, ep, eo), exp in {("a", "obs", "b"): 5000, ("c", "obs", "d"): 6000,
                              ("b", "down", "yes"): 4000, ("d", "down", "yes"): 0}.items():
        store.tags[Triple(d.encode(es), d.encode(ep), d.encode(eo))] = exp


def _naf_expiration_rule(r):
    r.add_rule(r.rule_from_strings(
        [("?x", "obs", "?y")], [("?x", "live", "?y")], negative=[("?y", "down", "yes")]))


def _three_shared():
    r = JaxReasoner()
    r.add_tagged_triple("a", "sym", "b", 0.9)
    r.add_tagged_triple("b", "sym", "a", 0.8)
    r.add_tagged_triple("z", "sym", "a", 0.7)
    r.add_rule(r.rule_from_strings(
        [("?x", "?p", "?y"), ("?y", "?p", "?x")], [("?x", "mutual", "?y")]))
    return r


def _cross_blocking():
    r = JaxReasoner()
    r.add_abox_triple("a", "p", "b")
    r.add_abox_triple("c", "p", "d")
    r.add_rule(r.rule_from_strings(
        [("?x", "p", "?y")], [("?y", "blocked", "yes")], negative=[("dummy", "d", "d")]))
    r.add_rule(r.rule_from_strings(
        [("?x", "p", "?y")], [("?x", "ok", "?y")], negative=[("?y", "blocked", "yes")]))
    return r


def _self_blocking():
    r = JaxReasoner()
    r.add_abox_triple("a", "p", "b")
    r.add_abox_triple("b", "p", "c")
    r.add_rule(r.rule_from_strings(
        [("?x", "p", "?y")], [("?y", "blocked", "yes")], negative=[("?x", "blocked", "yes")]))
    return r


def _naf_improves_existing():
    r = JaxReasoner()
    r.add_tagged_triple("a", "strong", "b", 0.9)
    r.add_tagged_triple("a", "q", "b", 0.3)
    r.add_rule(r.rule_from_strings([("?x", "q", "?y")], [("?x", "s", "?y")]))
    r.add_rule(r.rule_from_strings(
        [("?x", "strong", "?y")], [("?x", "q", "?y")], negative=[("?y", "broken", "yes")]))
    return r


def _naf_derived_final():
    r = JaxReasoner()
    r.add_tagged_triple("a", "p", "b", 0.5)
    r.add_tagged_triple("c", "p", "d", 0.9)
    r.add_tagged_triple("d", "broken", "yes", 0.4)
    r.add_rule(r.rule_from_strings([("?x", "p", "?y")], [("?x", "q", "?y")]))
    r.add_rule(r.rule_from_strings(
        [("?x", "q", "?y")], [("?x", "ok", "?y")], negative=[("?y", "broken", "yes")]))
    return r


def _naf_drift():
    r = JaxReasoner()
    r.add_tagged_triple("a", "p", "b", 0.5)
    r.add_rule(r.rule_from_strings(
        [("?x", "p", "?y")], [("?x", "q", "?y")], negative=[("nowhere", "broken", "yes")]))
    r.add_rule(r.rule_from_strings([("?x", "q", "?y")], [("?x", "p", "?y")]))
    return r


def _naf_addmult():
    r = JaxReasoner()
    r.add_tagged_triple("a", "p", "b", 0.9)
    r.add_tagged_triple("b", "p", "c", 0.8)
    r.add_tagged_triple("c", "broken", "yes", 0.4)
    for i in range(6):
        r.add_tagged_triple(f"u{i}", "p", f"v{i % 3}", 0.3 + 0.1 * i)
    r.add_tagged_triple("v1", "broken", "yes", 0.25)
    r.add_rule(r.rule_from_strings(
        [("?x", "p", "?y")], [("?x", "ok", "?y")], negative=[("?y", "broken", "yes")]))
    return r


def _naf_addmult_passes():
    r = JaxReasoner()
    r.add_tagged_triple("a", "p", "b", 0.6)
    r.add_tagged_triple("c", "p", "d", 0.5)
    r.add_tagged_triple("d", "blocked", "yes", 0.3)
    r.add_tagged_triple("a", "r", "b", 0.7)
    r.add_tagged_triple("e", "r", "f", 0.4)
    r.add_rule(r.rule_from_strings(
        [("?x", "p", "?y")], [("?x", "q", "?y")], negative=[("?y", "blocked", "yes")]))
    r.add_rule(r.rule_from_strings([("?x", "q", "?y")], [("?x", "s", "?y")]))
    r.add_rule(r.rule_from_strings(
        [("?x", "r", "?y")], [("?x", "w", "?y")], negative=[("?x", "s", "?y")]))
    return r


def _naf_addmult_existing():
    r = JaxReasoner()
    r.add_tagged_triple("a", "p", "b", 0.6)
    r.add_tagged_triple("a", "q", "b", 0.5)
    r.add_rule(r.rule_from_strings(
        [("?x", "p", "?y")], [("?x", "q", "?y")], negative=[("?y", "broken", "yes")]))
    r.add_rule(r.rule_from_strings([("?x", "q", "?y")], [("?x", "s", "?y")]))
    return r


def _naf_sequential_merge():
    r = JaxReasoner()
    r.add_tagged_triple("a", "p", "b", 0.3)
    r.add_tagged_triple("c", "r", "b", 0.9)
    r.add_tagged_triple("m", "q", "n", 0.8)
    r.add_rule(r.rule_from_strings(
        [("?x", "p", "?y")], [("?y", "f", "hit")], negative=[("k", "d", "k")]))
    r.add_rule(r.rule_from_strings(
        [("?x", "r", "?y")], [("?y", "f", "hit")], negative=[("k", "d", "k")]))
    r.add_rule(r.rule_from_strings(
        [("?x", "q", "?y")], [("?x", "out", "?y")], negative=[("?x", "f", "hit")]))
    r.add_rule(r.rule_from_strings([("?y", "f", "hit")], [("?y", "g", "hit")]))
    return r


def _fuzz_cases():
    """The two seeded fuzz loops of the reference file, replayed draw for
    draw: ``(name, builder, semiring)``."""
    out = []
    rng = random.Random(20260730)
    for trial in range(10):
        n_nodes = rng.randrange(6, 20)
        base = [(f"n{rng.randrange(n_nodes)}", rng.choice(["p", "r"]),
                 f"n{rng.randrange(n_nodes)}", round(rng.uniform(0.2, 1.0), 2))
                for _ in range(rng.randrange(10, 40))]
        blockers = [(f"n{rng.randrange(n_nodes)}", "broken", "yes",
                     round(rng.uniform(0.1, 1.0), 2)) for _ in range(rng.randrange(0, 6))]
        two_premise = rng.random() < 0.5
        neg_const = rng.random() < 0.3

        def build(base=base, blockers=blockers, two_premise=two_premise, neg_const=neg_const):
            r = JaxReasoner()
            for s, p, o, t in base + blockers:
                r.add_tagged_triple(s, p, o, t)
            body = [("?x", "p", "?y")]
            if two_premise:
                body.append(("?y", "r", "?z"))
                concl_v = ("?x", "derived", "?z")
            else:
                concl_v = ("?x", "derived", "?y")
            neg = [("nowhere", "broken", "yes")] if neg_const else [(concl_v[2], "broken", "yes")]
            r.add_rule(r.rule_from_strings(body, [concl_v], negative=neg))
            r.add_rule(r.rule_from_strings([("?a", "derived", "?b")], [("?a", "down", "?b")]))
            return r

        out.append((f"naf_fuzz{trial}", build, ("minmax", "boolean")[trial % 2]))
    rng = random.Random(20260731)
    for trial in range(12):
        n_nodes = rng.randrange(5, 16)
        base = [(f"n{rng.randrange(n_nodes)}", rng.choice(["p", "r"]),
                 f"n{rng.randrange(n_nodes)}", round(rng.uniform(0.2, 1.0), 2))
                for _ in range(rng.randrange(8, 30))]
        blockers = [(f"n{rng.randrange(n_nodes)}", "broken", "yes",
                     round(rng.uniform(0.1, 1.0), 2)) for _ in range(rng.randrange(0, 5))]
        cross = rng.random() < 0.6

        def build(base=base, blockers=blockers, cross=cross):
            r = JaxReasoner()
            for s, p, o, t in base + blockers:
                r.add_tagged_triple(s, p, o, t)
            r.add_rule(r.rule_from_strings(
                [("?x", "p", "?y")],
                [("?y", "flag", "yes")] if cross else [("?x", "d1", "?y")],
                negative=[("?y", "broken", "yes")]))
            r.add_rule(r.rule_from_strings(
                [("?x", "r", "?y")], [("?x", "d2", "?y")],
                negative=[("?y", "flag", "yes") if cross else ("?x", "broken", "yes")]))
            return r

        out.append((f"naf_round5_fuzz{trial}", build,
                    ("addmult", "minmax", "boolean")[trial % 3]))
    return out


def _late(build, late):
    def b():
        r = build()
        late(r)
        return r
    return b


# (name, builder, semiring, tags, delta, rules added after seeding, declines)
CASES = [
    ("minmax_chain", _chain, "minmax", None, None, None, False),
    ("boolean", _boolean, "boolean", None, None, None, False),
    ("expiration_sds", _observes, "expiration", _expiries(1000, 37), None, _observes_rule, False),
    ("tag_improvement", _improvement, "minmax", None, None, None, False),
    ("initial_delta", lambda: _chain(10, prob=False), "expiration", _expiries(5000, 13),
     _delta_pair, None, False),
    ("filter_rule", _filter_rule, "minmax", None, None, None, False),
    ("rederived_untagged", _rederived, "minmax", None, None, None, False),
    ("addmult_chain", _chain, "addmult", None, None, None, False),
    ("addmult_diamond", _diamond, "addmult", None, None, None, False),
    ("addmult_cyclic", _cyclic, "addmult", None, None, None, False),
    ("addmult_filters", _filters_constants, "addmult", None, None, None, False),
    ("addmult_order_sensitive", _order_sensitive, "addmult", None, None, None, True),
    ("addmult_independent_rules", _independent_rules, "addmult", None, None, None, False),
    ("addmult_initial_delta", lambda: _chain(10, prob=True), "addmult", None, _first_fact,
     None, False),
    ("naf_boolean", _naf_blocked(), "boolean", None, None, None, False),
    ("naf_minmax", _naf_blocked(tagged=True), "minmax", None, None, None, False),
    ("naf_feed_positive", _naf_feed, "boolean", None, None, None, False),
    ("naf_only", _naf_only, "minmax", None, None, None, False),
    ("naf_expiration", _naf_expiration, "expiration", _naf_expiration_tags, None,
     _naf_expiration_rule, False),
    ("three_shared_vars", _three_shared, "minmax", None, None, None, False),
    ("naf_cross_blocking_boolean", _cross_blocking, "boolean", None, None, None, False),
    ("naf_cross_blocking_minmax", _cross_blocking, "minmax", None, None, None, False),
    ("naf_self_blocking", _self_blocking, "boolean", None, None, None, True),
    ("naf_improves_existing", _naf_improves_existing, "minmax", None, None, None, False),
    ("naf_derived_final", _naf_derived_final, "minmax", None, None, None, False),
    ("naf_feedback_drift", _naf_drift, "minmax", None, None, None, True),
    ("naf_addmult", _naf_addmult, "addmult", None, None, None, False),
    ("naf_addmult_passes", _naf_addmult_passes, "addmult", None, None, None, False),
    ("naf_addmult_existing", _naf_addmult_existing, "addmult", None, None, None, False),
    ("naf_sequential_merge", _naf_sequential_merge, "minmax", None, None, None, False),
    ("naf_addmult_drift", _naf_drift, "addmult", None, None, None, True),
] + [(name, b, sr, None, None, None, None) for name, b, sr in _fuzz_cases()]


def _jax_run(build, sr, tags, delta, late, device: bool):
    jr = build()
    prov = SEMIRINGS[sr][0]()
    store = jps.seed_tag_store(jr, prov)
    if tags:
        tags(jr, store)
    seeded = dict(store.tags)
    if late:
        late(jr)
    d = delta(jr) if delta else None
    if device:
        out = jdp.infer_provenance_device(jr, prov, store, initial_delta=d)
    else:
        out = jps.infer_with_provenance(jr, prov, store, initial_delta=d)
    return jr, store, seeded, d, out


def _port_run(build, sr, tags, delta, late, seeded, device: bool):
    jr = build()
    if tags:
        tags(jr, jps.seed_tag_store(jr, SEMIRINGS[sr][0]()))
    if late:
        late(jr)
    pr = carry(jr)
    prov = SEMIRINGS[sr][1]()
    store = TagStore.from_items(prov, seeded.items())
    d = delta(jr) if delta else None
    if device:
        out = tdp.infer_provenance_device(pr, prov, store, initial_delta=d)
    else:
        out = tps.infer_with_provenance(pr, prov, store, initial_delta=d)
    return pr, store, out


@pytest.mark.parametrize("name,build,sr,tags,delta,late,declines", CASES,
                         ids=[c[0] for c in CASES])
def test_device_provenance_matches_jax(monkeypatch, name, build, sr, tags, delta, late, declines):
    jd = JaxDispatches(monkeypatch)
    jr, jstore, seeded, _d, jout = _jax_run(build, sr, tags, delta, late, device=True)
    pr, pstore, pout = _port_run(build, sr, tags, delta, late, seeded, device=True)
    addmult = sr == "addmult"
    assert (pout is None) == (jout is None), (jout, pout)
    if declines is not None:
        assert (jout is None) == declines
    host, hstore, _ = _port_run(build, sr, tags, delta, late, seeded, device=False)
    if jout is None:
        # declined: the port's host loop against the JAX host loop
        jh, jhstore, *_ = _jax_run(build, sr, tags, delta, late, device=False)
        assert host.facts.triples_set() == jh.facts.triples_set()
        assert_same_tags(dict(jhstore.tags), dict(hstore.tags), addmult)
        return
    assert pr.facts.triples_set() == jr.facts.triples_set()
    assert_same_tags(dict(jstore.tags), dict(pstore.tags), addmult)
    assert tdp.LAST_RUN["dispatches"] == jd.log
    assert tdp.LAST_RUN["rounds"] == sum(1 for _k, _c, code in jd.log if code == 0)
    # the port's host loop reproduces its device path
    assert host.facts.triples_set() == pr.facts.triples_set()
    assert_same_tags(dict(pstore.tags), dict(hstore.tags), addmult)


def test_seed_tag_store_matches_jax():
    jr = _naf_addmult()
    pr = carry(jr)
    for sr, (jcls, tcls) in SEMIRINGS.items():
        want = dict(jps.seed_tag_store(jr, jcls()).tags)
        assert dict(tps.seed_tag_store(pr, tcls()).tags) == want, sr


def test_expiration_forever_stays_exact():
    """FOREVER (2^64 - 1) rides as +inf and decodes back exactly; expiries
    up to 2^53 stay exact."""
    prov = tprov.ExpirationProvenance()
    vals = [0, 1, 2 ** 53, prov.FOREVER]
    enc = tdp._encode_tags(prov, vals)
    assert np.isinf(enc[-1]) and tdp._decode_tags(prov, enc) == vals


def test_auto_route_takes_the_card_only(monkeypatch):
    """``infer_with_provenance`` routes to the device path when the
    reasoner's device is CUDA and the store holds ``AUTO_MIN_FACTS``
    facts; on the CPU it runs the host loop."""
    calls = []
    orig = tdp.infer_provenance_device

    def spy(reasoner, provenance, tag_store, initial_delta=None):
        calls.append(reasoner.device.type)
        reasoner.device = torch.device("cpu")
        return orig(reasoner, provenance, tag_store, initial_delta)

    monkeypatch.setattr(tdp, "AUTO_MIN_FACTS", 0)
    monkeypatch.setattr(tdp, "infer_provenance_device", spy)
    r = carry(_chain(10))
    tps.infer_with_provenance(r, tprov.MinMaxProbability())
    assert calls == []

    class Card:
        type = "cuda"

    r = carry(_chain(10))
    r.device = Card()
    store = tps.infer_with_provenance(r, tprov.MinMaxProbability())
    assert calls == ["cuda"] and len(store.tags) > 10
    # below the threshold the card runs the host loop (stopped at its entry)
    monkeypatch.setattr(tdp, "AUTO_MIN_FACTS", 10 ** 9)

    class HostLoop(Exception):
        pass

    def host_loop(*a, **k):
        raise HostLoop

    monkeypatch.setattr(tps, "infer_with_provenance_host", host_loop)
    r = carry(_chain(10))
    r.device = Card()
    with pytest.raises(HostLoop):
        tps.infer_with_provenance(r, tprov.MinMaxProbability())
    assert calls == ["cuda"]


def test_failures_raise_instead_of_declining(monkeypatch):
    """A capacity that never converges raises; nothing reruns on the
    host."""
    monkeypatch.setattr(tdp, "_round_cap", lambda n, lo=128: 1)
    r = carry(_chain(20))
    with pytest.raises(RuntimeError, match="converge"):
        tdp.infer_provenance_device(r, tprov.MinMaxProbability(),
                                    tps.seed_tag_store(r, tprov.MinMaxProbability()),
                                    max_attempts=1)


def _u64(k: torch.Tensor) -> np.ndarray:
    return (k.numpy().astype(np.uint64) ^ np.uint64(1 << 63))


@pytest.mark.parametrize("sr,build", [("minmax", _chain), ("addmult", _independent_rules),
                                      ("minmax", _three_shared)])
def test_merge_path_pairs_equal_join_indices(monkeypatch, sr, build):
    """``ranked_merge_join_indices`` gives the pairs of the reference's
    ``join_indices`` in the same order on the provenance path's own join
    inputs (recorded from a run)."""
    calls = []
    orig = K.ranked_merge_join_indices

    def rec(lkey, rkey, cap=None):
        calls.append((lkey.clone(), rkey.clone(), cap))
        return orig(lkey, rkey, cap)

    monkeypatch.setattr(tdp, "ranked_merge_join_indices", rec)
    r = carry(build())
    prov = SEMIRINGS[sr][1]()
    assert tdp.infer_provenance_device(r, prov, tps.seed_tag_store(r, prov)) is not None
    assert calls
    for lkey, rkey, cap in calls:
        li, ri, valid, total = orig(lkey, rkey, cap)
        jli, jri, jvalid, jtotal = jdj.join_indices(_u64(lkey), _u64(rkey), cap)
        tli, tri, tvalid, ttotal = tdj.join_indices(lkey, rkey, cap)
        assert int(total) == int(jtotal) == int(ttotal)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(li.numpy(), np.asarray(jli))
        np.testing.assert_array_equal(ri.numpy(), np.asarray(jri))
        np.testing.assert_array_equal(li.numpy(), tli.numpy())
        np.testing.assert_array_equal(ri.numpy(), tri.numpy())
