"""The port's SDD engine (Python twin and native library), SddProvenance
closures, WMC and ``diff_sdd`` gradients against the JAX package, on the
CPU (``tests/test_reasoner.py`` :369-473 and the native agreement of
``tests/test_native.py``).  SDD tags are node IDs inside one manager, so
closures are compared through their WMC values and gradients."""

from __future__ import annotations

import random

import pytest

from kolibrie_tpu.core.triple import Triple as JTriple
from kolibrie_tpu.reasoner import sdd as jsdd
from kolibrie_tpu.reasoner.diff_sdd import wmc_gradient as j_grad
from kolibrie_tpu.reasoner.diff_sdd import wmc_gradient_by_seed as j_grad_seed
from kolibrie_tpu.reasoner.provenance_seminaive import infer_with_provenance as j_infer
from kolibrie_tpu.reasoner.reasoner import Reasoner as JaxReasoner
from kolibrie_tpu.reasoner.sdd_seed import infer_new_facts_with_sdd_seed_specs as j_seeded
from kolibrie_tpu.reasoner.seed_spec import ExclusiveGroupSeed as JExclusive
from kolibrie_tpu.reasoner.seed_spec import IndependentSeed as JIndependent
from kolibrie_tpu_torch import Reasoner, native
from kolibrie_tpu_torch.core.triple import Triple
from kolibrie_tpu_torch.reasoner import sdd as tsdd
from kolibrie_tpu_torch.reasoner.diff_sdd import wmc_gradient, wmc_gradient_by_seed
from kolibrie_tpu_torch.reasoner.provenance_seminaive import infer_with_provenance
from kolibrie_tpu_torch.reasoner.sdd_seed import infer_new_facts_with_sdd_seed_specs
from kolibrie_tpu_torch.reasoner.seed_spec import ExclusiveGroupSeed, IndependentSeed
from test_torch_device_provenance import carry
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)


def _native():
    if not native.available():
        pytest.skip("the native library does not build here (no C++ compiler)")
    from kolibrie_tpu_torch.native.sdd_native import NativeSddManager

    return NativeSddManager()


MANAGERS = {"python": tsdd.SddManager, "native": _native}


def random_formula(mgr, n_vars, rng, n_ops=40):
    """The same random formula against any manager; returns its node."""
    vars_ = [mgr.new_var(w_pos=rng.uniform(0.1, 0.9)) for _ in range(n_vars)]
    pool = [mgr.literal(v, rng.random() < 0.5) for v in vars_]
    for _ in range(n_ops):
        a, b = rng.choice(pool), rng.choice(pool)
        node = mgr.apply(a, b, rng.choice(["and", "or"]))
        if rng.random() < 0.3:
            node = mgr.negate(node)
        pool.append(node)
    return pool[-1]


@pytest.mark.parametrize("kind", sorted(MANAGERS))
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_formulas_match_jax(kind, seed):
    """Identical construction order gives identical node IDs, WMC,
    gradients, sizes and models in the port's managers and the JAX
    package's Python manager."""
    ref, mgr = jsdd.SddManager(), MANAGERS[kind]()
    node_ref = random_formula(ref, 6, random.Random(seed))
    node = random_formula(mgr, 6, random.Random(seed))
    assert node == node_ref
    assert mgr.wmc(node) == pytest.approx(ref.wmc(node_ref), abs=1e-12)
    assert mgr.size(node) == ref.size(node_ref)
    assert mgr.enumerate_models(node) == ref.enumerate_models(node_ref)
    g, g_ref = wmc_gradient(mgr, node), j_grad(ref, node_ref)
    assert set(g) == set(g_ref)
    for v in g:
        assert g[v] == pytest.approx(g_ref[v], abs=1e-12)


@pytest.mark.parametrize("kind", sorted(MANAGERS))
def test_manager_basics(kind):
    """apply / negate / exactly_one / set_weight with the reference's
    values, and the gradient against finite differences."""
    m = MANAGERS[kind]()
    x, y = m.new_var(0.5), m.new_var(0.5)
    lx, ly = m.literal(x), m.literal(y)
    assert m.conjoin(lx, tsdd.FALSE) == tsdd.FALSE and m.disjoin(lx, tsdd.TRUE) == tsdd.TRUE
    assert abs(m.wmc(m.conjoin(lx, ly)) - 0.25) < 1e-12
    assert abs(m.wmc(m.disjoin(lx, ly)) - 0.75) < 1e-12
    assert m.negate(m.negate(lx)) == lx and m.disjoin(lx, m.negate(lx)) == tsdd.TRUE
    vs = [m.new_var(p, 1.0, kind="exclusive", group_id=0) for p in (0.2, 0.3, 0.5)]
    c = m.exactly_one(vs)
    assert abs(m.wmc(c) - 1.0) < 1e-12
    assert abs(m.wmc(m.conjoin(c, m.literal(vs[1]))) - 0.3) < 1e-12
    assert abs(wmc_gradient(m, m.conjoin(c, m.literal(vs[0])), vs)[vs[0]] - 1.0) < 1e-9
    f = m.disjoin(m.conjoin(lx, ly), lx)
    m.set_weight(x, 0.4)
    grads = wmc_gradient(m, f)
    eps = 1e-6
    m.set_weight(x, 0.4 + eps)
    up = m.wmc(f)
    m.set_weight(x, 0.4 - eps)
    down = m.wmc(f)
    assert abs(grads[x] - (up - down) / (2 * eps)) < 1e-5


def test_factory_takes_the_native_manager():
    """``make_sdd_manager`` returns the native manager when the library
    loads and the Python twin otherwise, as the reference's does."""
    want = "NativeSddManager" if native.available() else "SddManager"
    assert type(tsdd.make_sdd_manager()).__name__ == want


def _two_paths(n=1):
    r = JaxReasoner()
    for i in range(n):
        r.add_tagged_triple(f":s{i}", ":p1", ":m", 0.5 + 0.01 * (i % 40))
        r.add_tagged_triple(f":s{i}", ":p2", ":m", 0.5)
        r.add_tagged_triple(f":s{i}", ":p3", f":n{i % 3}", 0.3 + 0.1 * (i % 5))
    r.add_rule(r.rule_from_strings([("?x", ":p1", "?y")], [("?x", ":g", '"t"')]))
    r.add_rule(r.rule_from_strings([("?x", ":p2", "?y")], [("?x", ":g", '"t"')]))
    r.add_rule(r.rule_from_strings(
        [("?x", ":g", '"t"'), ("?x", ":p3", "?z")], [("?z", ":hit", '"t"')]))
    return r


@pytest.mark.parametrize("kind", sorted(MANAGERS))
@pytest.mark.parametrize("n", [1, 40])
def test_sdd_closure_matches_jax(kind, n):
    """SddProvenance closures (40 subjects take the batched native round,
    from 32 derivations a rule) give the JAX package's facts, and every
    tag's WMC and per-seed gradient."""
    jr = _two_paths(n)
    pr = carry(jr)
    jprov = jsdd.SddProvenance(jsdd.SddManager())
    tprov_ = tsdd.SddProvenance(MANAGERS[kind]())
    jstore, tstore = j_infer(jr, jprov), infer_with_provenance(pr, tprov_)
    assert pr.facts.triples_set() == jr.facts.triples_set()
    assert set(tstore.tags) == set(jstore.tags)
    assert tprov_.seed_vars == jprov.seed_vars
    for k, tag in jstore.tags.items():
        ours = tstore.tags[k]
        assert tprov_.recover_probability(ours) == pytest.approx(
            jprov.recover_probability(tag), abs=1e-12)
        g = wmc_gradient_by_seed(tprov_.manager, ours, tprov_.seed_vars)
        g_ref = j_grad_seed(jprov.manager, tag, jprov.seed_vars)
        assert g == pytest.approx(g_ref, abs=1e-12)
    if n == 1:
        goal = tuple(pr.dictionary.encode(x) for x in (":s0", ":g", '"t"'))
        assert abs(tprov_.recover_probability(tstore.get(goal)) - 0.75) < 1e-9


def test_seed_specs_match_jax():
    """Independent and exclusive-group seeds (sdd_seed) on both packages:
    P(win) = 0.3 * 0.5, with equal gradients by seed."""
    def build(R):
        r = R()
        d = r.dictionary
        t = [(d.encode(":a"), d.encode(":p"), d.encode(":x")),
             (d.encode(":a"), d.encode(":p"), d.encode(":y")),
             (d.encode(":b"), d.encode(":q"), d.encode(":z"))]
        r.add_rule(r.rule_from_strings(
            [("?s", ":p", ":x"), ("?b", ":q", "?z")], [("?s", ":win", '"t"')]))
        return r, d, t

    jr, jd, jt = build(JaxReasoner)
    jstore, jprov = j_seeded(jr, [JExclusive(0, [(JTriple(*jt[0]), 0.3, 0),
                                                 (JTriple(*jt[1]), 0.7, 1)]),
                                  JIndependent(JTriple(*jt[2]), 0.5, 2)])
    pr, td, tt = build(lambda: Reasoner(device="cpu"))
    assert tt == jt
    tstore, tprov_ = infer_new_facts_with_sdd_seed_specs(
        pr, [ExclusiveGroupSeed(0, [(Triple(*tt[0]), 0.3, 0), (Triple(*tt[1]), 0.7, 1)]),
             IndependentSeed(Triple(*tt[2]), 0.5, 2)])
    goal = (td.encode(":a"), td.encode(":win"), td.encode('"t"'))
    assert goal == (jd.encode(":a"), jd.encode(":win"), jd.encode('"t"'))
    got = tprov_.recover_probability(tstore.get(goal))
    assert abs(got - 0.15) < 1e-9
    assert got == pytest.approx(jprov.recover_probability(jstore.get(goal)), abs=1e-12)
    assert wmc_gradient_by_seed(tprov_.manager, tstore.get(goal), tprov_.seed_vars) == \
        pytest.approx(j_grad_seed(jprov.manager, jstore.get(goal), jprov.seed_vars), abs=1e-12)
