"""The port's distributed tagged fixpoint against the JAX package's and the
port's host loop, on an 8-shard CPU mesh.

One case for each of the reference's ``tests/test_dist_provenance.py``
tests.  Every case builds the same program in both packages (the same
dictionary IDs), runs the port's ``DistProvenanceReasoner`` on
``make_mesh(8, devices=[cpu] * 8)`` and holds its fact set and TagStore to
the reference's host provenance loop ``infer_with_provenance`` (the oracle
of the reference's own tests) and to the port's: exact for Boolean, MinMax
and Expiration, within 1e-9 a tag for AddMult.  The reference's
``DistProvenanceReasoner`` is built for every program: it takes or refuses
the same programs, with the same NAF dispatch and first capacities, and
the port's final capacities are those doubled once a failed attempt.  One
program, Expiration transitive, also runs the reference's mesh closure on
the 8 virtual CPU devices, its final capacities equal to the port's; its
mesh programs cost about 13 s to compile cold, so the others do not.
The NAF programs that ``chip_smoke.py`` phase 17b runs are built by its
``naf_program``.
"""

from __future__ import annotations

import random
import types

import pytest
import torch

import chip_smoke as CS
import kolibrie_tpu.core.rule as ref_rule
import kolibrie_tpu.core.terms as ref_terms
import kolibrie_tpu.reasoner.provenance as ref_prov
import kolibrie_tpu.reasoner.provenance_seminaive as ref_psn
import kolibrie_tpu_torch.core.rule as port_rule
import kolibrie_tpu_torch.core.terms as port_terms
import kolibrie_tpu_torch.parallel as P
import kolibrie_tpu_torch.reasoner.provenance as port_prov
import kolibrie_tpu_torch.reasoner.provenance_seminaive as port_psn
from kolibrie_tpu.parallel.dist_provenance import DistProvenanceReasoner as RefDist
from kolibrie_tpu.parallel.dist_provenance import Unsupported as RefUnsupported
from kolibrie_tpu.reasoner.reasoner import Reasoner as RefReasoner
from kolibrie_tpu_torch.parallel.dist_provenance import Unsupported as PortUnsupported
from kolibrie_tpu_torch.reasoner.reasoner import Reasoner as PortReasoner
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

N = 8
CPU = torch.device("cpu")
TOL = 1e-9  # per AddMult tag, the reference tests' _close_tags tolerance

REF = types.SimpleNamespace(
    Reasoner=RefReasoner, kw={}, Rule=ref_rule.Rule, Filter=ref_rule.FilterCondition,
    Term=ref_terms.Term, Pattern=ref_terms.TriplePattern, prov=ref_prov, psn=ref_psn,
)
PORT = types.SimpleNamespace(
    Reasoner=PortReasoner, kw={"device": "cpu"}, Rule=port_rule.Rule,
    Filter=port_rule.FilterCondition, Term=port_terms.Term, Pattern=port_terms.TriplePattern,
    prov=port_prov, psn=port_psn,
)


@pytest.fixture(scope="module")
def pmesh():
    return P.make_mesh(N, devices=[CPU] * N)


def provenance(ns, name):
    return ns.prov.make_provenance(name, k=3)


# ------------------------------------------------------------------ programs
# each builds one program of the reference's tests in either package


def minmax_two_premise(ns):
    r = ns.Reasoner(**ns.kw)
    for i in range(24):
        r.add_tagged_triple(f"p{i}", "worksAt", f"org{i % 5}", 0.4 + 0.02 * i)
        r.add_tagged_triple(f"org{i % 5}", "partOf", "corp", 0.6 + 0.01 * (i % 5))
    r.add_rule(r.rule_from_strings([("?x", "worksAt", "?o"), ("?o", "partOf", "?c")],
                                   [("?x", "memberOf", "?c")]))
    return r


def expiration_transitive(ns):
    r = ns.Reasoner(**ns.kw)
    for i in range(20):
        r.add_abox_triple(f"n{i}", "next", f"n{i + 1}")
    r.add_rule(r.rule_from_strings([("?x", "next", "?y"), ("?y", "next", "?z")],
                                   [("?x", "next", "?z")]))
    return r


def expiry_seeds(r, store):
    """Per-fact expiries in column order, as the reference test sets them."""
    s, p, o = r.facts.columns()
    for j, k in enumerate(zip(s.tolist(), p.tolist(), o.tolist())):
        store.tags[k] = 10_000 + 101 * j


def boolean_filter(ns):
    r = ns.Reasoner(**ns.kw)
    for i in range(18):
        r.add_abox_triple(f"item{i}", "price", f'"{i * 10}"')
        r.add_abox_triple(f"item{i}", "inStock", "yes")
    r.add_rule(r.rule_from_strings([("?x", "price", "?v"), ("?x", "inStock", "yes")],
                                   [("?x", "sellable", "yes")],
                                   filters=[ns.Filter("v", ">", 50.0)]))
    return r


def three_premise(ns):
    r = ns.Reasoner(**ns.kw)
    for i in range(15):
        r.add_tagged_triple(f"a{i}", "p", f"b{i % 4}", 0.5 + 0.03 * i)
        r.add_tagged_triple(f"b{i % 4}", "q", f"c{i % 3}", 0.7)
        r.add_tagged_triple(f"c{i % 3}", "r", f"d{i % 2}", 0.9)
    r.add_rule(r.rule_from_strings(
        [("?x", "p", "?y"), ("?y", "q", "?z"), ("?z", "r", "?w")], [("?x", "reach", "?w")]))
    return r


def chain30(ns):
    r = ns.Reasoner(**ns.kw)
    for i in range(30):
        r.add_tagged_triple(f"n{i}", "next", f"n{i + 1}", 0.9)
    r.add_rule(r.rule_from_strings([("?x", "next", "?y"), ("?y", "next", "?z")],
                                   [("?x", "next", "?z")]))
    return r


def naf_only(ns):
    r = ns.Reasoner(**ns.kw)
    for i in range(9):
        r.add_tagged_triple(f"x{i}", "type", "P", 0.9)
    r.add_tagged_triple("x4", "blocked", "y", 1.0)
    r.add_rule(r.rule_from_strings([("?x", "type", "P")], [("?x", "ok", "y")],
                                   negative=[("?x", "blocked", "y")]))
    return r


def naf_addmult_improves_existing(ns):
    r = ns.Reasoner(**ns.kw)
    r.add_tagged_triple("a", "p", "b", 0.6)
    r.add_tagged_triple("a", "q", "b", 0.5)
    r.add_rule(r.rule_from_strings([("?x", "p", "?y")], [("?x", "q", "?y")],
                                   negative=[("?y", "broken", "yes")]))
    r.add_rule(r.rule_from_strings([("?x", "q", "?y")], [("?x", "s", "?y")]))
    return r


def sequential_improves_fresh(ns):
    r = ns.Reasoner(**ns.kw)
    r.add_tagged_triple("a", "p", "b", 0.3)
    r.add_tagged_triple("c", "r", "b", 0.9)
    r.add_tagged_triple("m", "q", "n", 0.8)
    r.add_rule(r.rule_from_strings([("?x", "p", "?y")], [("?y", "f", "hit")],
                                   negative=[("k", "d", "k")]))
    r.add_rule(r.rule_from_strings([("?x", "r", "?y")], [("?y", "f", "hit")],
                                   negative=[("k", "d", "k")]))
    r.add_rule(r.rule_from_strings([("?x", "q", "?y")], [("?x", "out", "?y")],
                                   negative=[("?x", "f", "hit")]))
    r.add_rule(r.rule_from_strings([("?y", "f", "hit")], [("?y", "g", "hit")]))
    return r


def addmult_chain(ns):
    r = ns.Reasoner(**ns.kw)
    for i in range(24):
        r.add_tagged_triple(f"n{i}", "next", f"n{i + 1}", 0.5 + 0.01 * i)
    r.add_rule(r.rule_from_strings([("?x", "next", "?y"), ("?y", "next", "?z")],
                                   [("?x", "next", "?z")]))
    return r


def addmult_diamond(ns):
    r = ns.Reasoner(**ns.kw)
    for i in range(10):
        r.add_tagged_triple(f"a{i}", "left", f"m{2 * i}", 0.8)
        r.add_tagged_triple(f"m{2 * i}", "right", f"z{i}", 0.7)
        r.add_tagged_triple(f"a{i}", "left", f"m{2 * i + 1}", 0.6)
        r.add_tagged_triple(f"m{2 * i + 1}", "right", f"z{i}", 0.5)
    r.add_rule(r.rule_from_strings([("?x", "left", "?y"), ("?y", "right", "?z")],
                                   [("?x", "reaches", "?z")]))
    return r


def guard_rule(ns):
    r = ns.Reasoner(**ns.kw)
    d = r.dictionary
    C, V = ns.Term.constant, ns.Term.variable
    r.add_tagged_triple(":mode", ":is", ":strict", 0.6)
    for i in range(10):
        r.add_tagged_triple(f":a{i}", ":edge", f":b{i}", 0.9 - 0.05 * i)
    r.add_rule(ns.Rule(
        premise=[ns.Pattern(C(d.encode(":mode")), C(d.encode(":is")), C(d.encode(":strict"))),
                 ns.Pattern(V("x"), C(d.encode(":edge")), V("y"))],
        conclusion=[ns.Pattern(V("x"), C(d.encode(":ok")), V("y"))],
    ))
    return r


def smoke(name, semiring):
    """``chip_smoke.py``'s 17b program ``name``, built in either package;
    ``semiring`` is the one the smoke runs it under."""
    def build(ns):
        r, prov = CS.naf_program(name, lambda: ns.Reasoner(**ns.kw))
        assert prov == semiring
        return r

    return build


# ------------------------------------------------------------------ runners


def run(ns, build, prov_name, mesh=None, seed=None, **caps):
    """The program's closure through ``ns``'s mesh reasoner (with ``mesh``)
    or its host loop: ``(facts, tags, reasoner)``."""
    r = build(ns)
    prov = provenance(ns, prov_name)
    store = ns.psn.seed_tag_store(r, prov)
    if seed is not None:
        seed(r, store)
    dr = None
    if mesh is None:
        (ns.psn.infer_with_provenance_host if ns is PORT else ns.psn.infer_with_provenance)(
            r, prov, store)
    else:
        dist = P.DistProvenanceReasoner if ns is PORT else RefDist
        dr = dist(mesh, r, prov, store, **caps)
        dr.infer()
    return r.facts.triples_set(), dict(store.tags), dr


def same(want, got, addmult: bool) -> None:
    wf, wt = want[:2]
    gf, gt = got[:2]
    assert gf == wf
    assert set(gt) == set(wt)
    for k, v in wt.items():
        if addmult:
            assert abs(v - gt[k]) <= TOL, (k, v, gt[k])
        else:
            assert gt[k] == v, (k, v, gt[k])


def agrees(mesh8, build, prov_name, got, seed=None, **caps) -> None:
    """``got`` (the port's mesh run) equals both packages' host loops, and
    the reference's ``DistProvenanceReasoner`` sets the program up as the
    port's did: the same gate, NAF dispatch and first capacities (its
    constructor compiles nothing)."""
    addmult = prov_name == "addmult"
    same(run(REF, build, prov_name, None, seed), got, addmult)
    same(run(PORT, build, prov_name, None, seed), got, addmult)
    r = build(REF)
    prov = provenance(REF, prov_name)
    ref = RefDist(mesh8, r, prov, REF.psn.seed_tag_store(r, prov), **caps)
    port = got[2]
    assert (ref.kind, ref.naf_sequential) == (port.kind, port.naf_sequential)
    # every cap, the seen relations' too, doubles after a failed attempt
    assert (*caps_of(ref), ref.seen_cap) == tuple(
        c >> (port.attempts - 1) for c in (*caps_of(port), port.seen_cap))


def caps_of(dr) -> tuple:
    return dr.fact_cap, dr.delta_cap, dr.join_cap, dr.bucket_cap


# (name, program, semiring, tag seeding, run the reference's mesh reasoner
# here too: Expiration transitive, a multi-round idempotent closure with
# cross-shard improvement, whose mesh programs cost about 13 s to compile
# cold; the host loops hold every case)
AGREEMENT = [
    ("minmax_two_premise", minmax_two_premise, "minmax", None, False),
    ("expiration_transitive", expiration_transitive, "expiration", expiry_seeds, True),
    ("boolean_filter", boolean_filter, "boolean", None, False),
    ("three_premise", three_premise, "minmax", None, False),
    ("naf_minmax", smoke("naf_minmax", "minmax"), "minmax", None, False),
    ("naf_feeds_positive_stratum", smoke("naf_boolean_feeds_positive", "boolean"), "boolean",
     None, False),
    ("naf_only_program", naf_only, "minmax", None, False),
    ("naf_addmult", smoke("naf_addmult", "addmult"), "addmult", None, False),
    ("naf_addmult_exactly_once_across_passes", smoke("naf_addmult_across_passes", "addmult"),
     "addmult", None, False),
    ("naf_addmult_improved_existing_stays_out_of_delta", naf_addmult_improves_existing,
     "addmult", None, False),
    ("naf_cross_blocking_sequential_boolean", smoke("cross_blocking_boolean", "boolean"),
     "boolean", None, False),
    ("naf_cross_blocking_sequential_minmax", smoke("cross_blocking_minmax", "minmax"), "minmax",
     None, False),
    ("naf_sequential_later_rule_improves_fresh_fact", sequential_improves_fresh, "minmax", None,
     False),
    ("addmult_chain", addmult_chain, "addmult", None, False),
    ("addmult_diamond", addmult_diamond, "addmult", None, False),
    ("guard_rule_tag_folding", guard_rule, "minmax", None, False),
]


@pytest.mark.parametrize("name,build,prov_name,seed,on_ref", AGREEMENT,
                         ids=[a[0] for a in AGREEMENT])
def test_agrees_with_host_loop_and_reference(pmesh, mesh8, name, build, prov_name, seed,
                                             on_ref):
    addmult = prov_name == "addmult"
    got = run(PORT, build, prov_name, pmesh, seed)
    agrees(mesh8, build, prov_name, got, seed)
    assert got[2].rounds > 0
    if on_ref:
        want = run(REF, build, prov_name, mesh8, seed)
        same(want, got, addmult)
        assert caps_of(got[2]) == caps_of(want[2])
    d = build(PORT).dictionary
    if name == "naf_addmult_improved_existing_stays_out_of_delta":
        key = tuple(d.encode(t) for t in ("a", "s", "b"))
        assert abs(got[1][key] - 0.5) < TOL
    if name.startswith("naf_cross_blocking"):
        # rule 1's blocking commits reached rule 2: no ok facts
        assert len(got[0]) == 4
    if name == "naf_sequential_later_rule_improves_fresh_fact":
        key = tuple(d.encode(t) for t in ("b", "g", "hit"))
        assert abs(got[1][key] - 0.9) < TOL
    if name == "addmult_diamond":
        assert any(v == pytest.approx(0.692) for v in got[1].values())


def test_capacity_doubling_converges(pmesh, mesh8):
    """The reference test's small caps overflow: every cap doubles together
    after each failed attempt, from the caps the reference's reasoner takes
    for the same arguments, and the closure equals both host loops.  (The
    reference's own mesh run of this program compiles once an attempt,
    about a minute cold, so it is not run here.)"""
    caps = dict(fact_cap=512, delta_cap=64, join_cap=64, bucket_cap=64)
    got = run(PORT, chain30, "minmax", pmesh, **caps)
    assert got[2].attempts > 1
    agrees(mesh8, chain30, "minmax", got, **caps)


def test_refusals_match_the_reference(pmesh, mesh8):
    for build, prov_name in ((smoke("self_blocking", "boolean"), "boolean"),
                             (smoke("order_sensitive", "addmult"), "addmult"),
                             (smoke("structural", "topk"), "topk")):
        for ns, mesh, dist, err in ((PORT, pmesh, P.DistProvenanceReasoner, PortUnsupported),
                                    (REF, mesh8, RefDist, RefUnsupported)):
            r = build(ns)
            prov = provenance(ns, prov_name)
            with pytest.raises(err):
                dist(mesh, r, prov, ns.psn.seed_tag_store(r, prov))


def test_naf_round5_fuzz_agreement(pmesh, mesh8):
    """The reference's mesh fuzz: AddMult NAF and cross-blocking rule pairs
    over random tagged graphs — the mesh's facts and tags equal both host
    loops, or both packages' mesh reasoners decline."""
    rng = random.Random(20260732)
    provs = ["addmult", "minmax", "boolean"]
    accepted = 0
    for trial in range(6):
        n_nodes = rng.randrange(5, 14)
        base = [(f"n{rng.randrange(n_nodes)}", rng.choice(["p", "r"]),
                 f"n{rng.randrange(n_nodes)}", round(rng.uniform(0.2, 1.0), 2))
                for _ in range(rng.randrange(8, 24))]
        blockers = [(f"n{rng.randrange(n_nodes)}", "broken", "yes",
                     round(rng.uniform(0.1, 1.0), 2)) for _ in range(rng.randrange(0, 4))]
        cross = rng.random() < 0.6

        def build(ns, base=base, blockers=blockers, cross=cross):
            r = ns.Reasoner(**ns.kw)
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

        prov_name = provs[trial % len(provs)]
        try:
            got = run(PORT, build, prov_name, pmesh)
        except PortUnsupported:
            r = build(REF)
            prov = provenance(REF, prov_name)
            with pytest.raises(RefUnsupported):
                RefDist(mesh8, r, prov, REF.psn.seed_tag_store(r, prov))
            continue
        accepted += 1
        agrees(mesh8, build, prov_name, got)
    assert accepted >= 5, f"only {accepted} fuzz trials took the mesh path"


def test_chip_smoke_phase17_rehearsal(monkeypatch):
    """``chip_smoke.py`` phase 17 on four CPU shards: 17a at 4,000 facts
    against 9a's single-device run there (sent to ``infer_provenance_device``
    on torch's CPU, as ``test_torch_prov_smoke.py`` does), 17b's programs,
    17c over 1,000 digit samples and LUBM-2.  On the CPU the launch floors
    are not checked (the counters count the card's launches only)."""
    from benches.lubm import generate_fast
    from kolibrie_tpu_torch import SparqlDatabase
    from kolibrie_tpu_torch.reasoner import device_provenance as DP

    def on_device(kg, prov, store=None):
        store = store if store is not None else port_psn.seed_tag_store(kg, prov)
        assert DP.infer_provenance_device(kg, prov, store) is not None
        return store

    monkeypatch.setattr(PortReasoner, "infer_new_facts_with_provenance", on_device)
    monkeypatch.setattr(CS, "PROV_FACTS", 4000)
    monkeypatch.setattr(CS, "ML_SAMPLES", 1000)
    closures = CS.run_prov_closures(CPU, CS.prov_workload(CS.PROV_FACTS, CS.PROV_SEED), {})
    results = {name: rec.pop("result") for name, rec in closures.items()}
    lubm = SparqlDatabase(device=CPU)
    lubm.store.add_batch(*generate_fast(2, lubm.dictionary))
    out = CS.run_prov_mesh_phase(CPU, {"queries": [("q2", lubm, None, None)]},
                                 {"results": results})
    rep = out["report"]
    for name in CS.PROV_SEMIRINGS:
        warm = rep["17a"][name]["warm"]
        assert warm["derived"] == results[name]["derived"] > 2000 and warm["rounds"] == 2
    assert set(rep["17b"]) == set(CS.NAF_PROGRAMS)
    assert rep["17b"]["naf_addmult"]["sequential"]
    assert rep["17c"]["dp"]["loss_last"] < rep["17c"]["dp"]["loss_first"]
    assert rep["17c"]["neurosymbolic_subOrganizationOf"]["count"] == 0  # no 2-hop chain
    assert rep["17c"]["neurosymbolic_memberOf"]["count"] == 1280
    assert {"merge_path_join", "filter_mask"} <= set(out["captured"])
