"""The PyTorch port's R2R layer against the JAX package, on the CPU.

``set_difference_rows`` and the window-maintenance step run on the same
seeded inputs in both packages and must agree exactly (columns, validity,
counts).  ``DeviceR2R`` is driven through the same sliding firings as the
JAX ``DeviceR2R``: the derived facts of every firing in their device order,
the database's triple set and the mirror's live rows, all decoded, must be
equal.  The port's host ``SimpleR2R`` is held against its ``DeviceR2R``,
and the replayed cases of ``tests/test_rsp.py::TestDeviceR2R`` and
``TestDeviceR2RGroundGuard`` run on both packages.  A device failure must
propagate: the port never reruns a firing on the host.
"""

from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kolibrie_tpu.ops.device_join import set_difference_rows as jax_set_difference
from kolibrie_tpu.rsp import r2r as jr2r
from kolibrie_tpu.rsp.s2r import WindowTriple as JaxWindowTriple
from kolibrie_tpu_torch.core.rule import Rule
from kolibrie_tpu_torch.core.terms import Term, TriplePattern
from kolibrie_tpu_torch.ops.device_join import set_difference_rows
from kolibrie_tpu_torch.reasoner import device_fixpoint as tfx
from kolibrie_tpu_torch.rsp import r2r as tr2r
from kolibrie_tpu_torch.rsp.s2r import WindowTriple
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

# IDs with bit 31 set and the largest plain ID sit beside small ones
_ID_POOL = np.array([0, 1, 2, 3, 5, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFD], np.uint32)


def _rows(rng: np.random.Generator, n: int) -> np.ndarray:
    return _ID_POOL[rng.integers(0, len(_ID_POOL), (3, n))]


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.uint32).astype(np.int64))


def _np(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


# (n ours, n valid ours, n theirs, n valid theirs, cap)
SET_DIFF_CASES = [
    (64, 50, 40, 30, 64),
    (64, 64, 0, 0, 64),  # nothing to remove
    (32, 0, 16, 16, 32),  # nothing valid
    (128, 100, 200, 150, 48),  # survivors past the capacity are dropped
    (1, 1, 1, 1, 1),
]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", SET_DIFF_CASES)
def test_set_difference_rows_matches_jax(case, seed):
    n, nv, m, mv, cap = case
    rng = np.random.default_rng(seed)
    ours = _rows(rng, n)
    theirs = _rows(rng, m)
    # half of their valid rows are copies of ours, so membership is exercised
    k = min(mv // 2, n)
    if k:
        theirs[:, :k] = ours[:, rng.permutation(n)[:k]]
    valid = np.arange(n) < nv
    rng.shuffle(valid)
    ovalid = np.arange(m) < mv
    want = jax_set_difference(
        [jnp.asarray(c) for c in ours], jnp.asarray(valid),
        [jnp.asarray(c) for c in theirs], jnp.asarray(ovalid), cap,
    )
    got = set_difference_rows(
        [_t(c) for c in ours], torch.from_numpy(valid),
        [_t(c) for c in theirs], torch.from_numpy(ovalid), cap,
    )
    for g, w in zip(got[0], want[0]):
        assert np.array_equal(g.numpy(), _np(w))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])


# (cap, n before, removed, added): rows removed are drawn from the live rows
MAINTAIN_CASES = [
    (64, 40, 10, 12),
    (64, 40, 0, 7),  # empty removal
    (64, 40, 9, 0),  # empty add
    (64, 54, 6, 16),  # fills the capacity exactly
    (64, 60, 2, 16),  # arrivals past the capacity are dropped
    (1024, 0, 0, 300),  # first fill of an empty mirror
]


@pytest.mark.parametrize("case", MAINTAIN_CASES)
def test_window_maintain_matches_jax(case):
    cap, n, k_rem, k_add = case
    rng = np.random.default_rng(cap + n + k_rem + k_add)
    # distinct live rows (the host twin guarantees it), padded with zeros
    live = rng.choice(1 << 20, size=n + k_add, replace=False).astype(np.uint32)
    fcols = np.zeros((3, cap), np.uint32)
    fcols[:, :n] = np.stack([live[:n], live[:n] % 7, live[:n] % 5 + 0x80000000])
    rem = fcols[:, rng.permutation(n)[:k_rem]] if n else np.zeros((3, 0), np.uint32)
    add = np.stack([live[n:], live[n:] % 7, live[n:] % 5 + 0x80000000])
    rcap = max(16, 1 << int(np.ceil(np.log2(max(k_rem, 1)))))
    acap = max(16, 1 << int(np.ceil(np.log2(max(k_add, 1)))))
    rpad = np.zeros((3, rcap), np.uint32)
    rpad[:, :k_rem] = rem
    apad = np.zeros((3, acap), np.uint32)
    apad[:, :k_add] = add
    want = jr2r._window_maintain(
        *(jnp.asarray(c) for c in fcols), jnp.int32(n),
        *(jnp.asarray(c) for c in rpad), jnp.int32(k_rem),
        *(jnp.asarray(c) for c in apad), jnp.int32(k_add),
    )
    got = tr2r._window_maintain_impl(
        *(_t(c) for c in fcols), n,
        *(_t(c) for c in rpad), k_rem,
        *(_t(c) for c in apad), k_add,
    )
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), _np(w))
    # the same step with 0-dim tensor counts
    got_t = tr2r._window_maintain_impl(
        *(_t(c) for c in fcols), torch.tensor(n),
        *(_t(c) for c in rpad), torch.tensor(k_rem),
        *(_t(c) for c in apad), torch.tensor(k_add),
    )
    assert all(torch.equal(a, b) for a, b in zip(got, got_t))


# ------------------------------------------------------------- DeviceR2R

KNOWS_RULES = """@prefix ex: <http://ex/> .
{ ?a ex:knows ?b . ?b ex:knows ?c . } => { ?a ex:reach ?c . } .
"""


def _new(cls):
    """An R2R of either package (the port's on the CPU)."""
    return cls(device="cpu") if cls.__module__.startswith("kolibrie_tpu_torch") else cls()


def _pair(a, b, rules=KNOWS_RULES, seed_triple=True):
    ref, port = _new(a), _new(b)
    for r in (ref, port):
        if seed_triple:
            r.load_triples("@prefix ex: <http://ex/> .\nex:root ex:knows ex:p0 .", "turtle")
        r.load_rules(rules)
    return ref, port


def _decode(r, triples):
    d = r.db.dictionary
    return [(d.decode(t[0]), d.decode(t[1]), d.decode(t[2])) for t in triples]


def _db_set(r):
    d = r.db.dictionary
    return {tuple(d.decode(x) for x in k) for k in r.db.store.triples_set()}


def _mirror(r, n):
    cols = [np.asarray(c)[:n].astype(np.int64) for c in r._mir]
    return _decode(r, list(zip(*cols)))


def _slide(rng, window, n_new, people):
    """Evict the older half of ``window``, draw ``n_new`` arrivals."""
    evict, window = window[: len(window) // 2], window[len(window) // 2 :]
    new = [
        (f"http://ex/p{rng.randrange(people)}", "http://ex/knows", f"http://ex/p{rng.randrange(people)}")
        for _ in range(n_new)
    ]
    return evict, window + new, new


@pytest.mark.parametrize("people,n_new", [(6, 8), (40, 30)])
def test_device_r2r_matches_jax_device_r2r(people, n_new):
    ref, port = _pair(jr2r.DeviceR2R, tr2r.DeviceR2R)
    rng = random.Random(people)
    window = []
    for firing in range(10):
        evict, window, new = _slide(rng, window, n_new, people)
        for s, p, o in evict:
            ref.remove(JaxWindowTriple(s, p, o))
            port.remove(WindowTriple(s, p, o))
        for s, p, o in new:
            ref.add(JaxWindowTriple(s, p, o))
            port.add(WindowTriple(s, p, o))
        dr, dp = ref.materialize(), port.materialize()
        assert _decode(port, dp) == _decode(ref, dr), firing
        assert _db_set(port) == _db_set(ref), firing
        n = len(ref._base)
        assert len(port._base) == n and port._cap == ref._cap
        assert _mirror(port, n) == _mirror(ref, n), firing
    assert ref._device_ok and port._device_ok


def test_simple_r2r_matches_device_r2r():
    host, dev = _pair(tr2r.SimpleR2R, tr2r.DeviceR2R)
    rng = random.Random(3)
    window = []
    for firing in range(10):
        evict, window, new = _slide(rng, window, 12, 10)
        for r in (host, dev):
            for s, p, o in evict:
                r.remove(WindowTriple(s, p, o))
            for s, p, o in new:
                r.add(WindowTriple(s, p, o))
        dh, dd = host.materialize(), dev.materialize()
        assert sorted(_decode(host, dh)) == sorted(_decode(dev, dd)), firing
        assert _db_set(host) == _db_set(dev), firing
    assert dev._device_ok


def test_derived_fact_streamed_in_matches_host():
    """``TestDeviceR2R.test_derived_fact_streamed_in_matches_host``, on the
    port's two R2Rs and the JAX DeviceR2R."""
    ref, _ = _pair(jr2r.DeviceR2R, tr2r.DeviceR2R)
    host, dev = _pair(tr2r.SimpleR2R, tr2r.DeviceR2R)
    chain = [("http://ex/p0", "http://ex/knows", "http://ex/p1"),
             ("http://ex/p1", "http://ex/knows", "http://ex/p2")]
    for s, p, o in chain:
        ref.add(JaxWindowTriple(s, p, o))
        for r in (host, dev):
            r.add(WindowTriple(s, p, o))
    want = sorted(_decode(ref, ref.materialize()))
    assert sorted(_decode(host, host.materialize())) == want
    assert sorted(_decode(dev, dev.materialize())) == want
    streamed = ("http://ex/p0", "http://ex/reach", "http://ex/p2")
    ref.add(JaxWindowTriple(*streamed))
    for r in (host, dev):
        r.add(WindowTriple(*streamed))
    for _ in range(2):
        want = sorted(_decode(ref, ref.materialize()))
        assert sorted(_decode(host, host.materialize())) == want
        assert sorted(_decode(dev, dev.materialize())) == want
        assert _db_set(host) == _db_set(dev) == _db_set(ref)


def _bad_rule(r):
    """Head variable unbound in the premises: the fixpoint cannot lower it."""
    p = r.db.dictionary.encode("<http://ex/knows>")
    return Rule(
        premise=[TriplePattern(Term.variable("a"), Term.constant(p), Term.variable("b"))],
        filters=[],
        conclusion=[TriplePattern(Term.variable("a"), Term.constant(p), Term.variable("z"))],
    )


def test_unsupported_rules_take_the_host_closure():
    host, dev = _pair(tr2r.SimpleR2R, tr2r.DeviceR2R)
    for r in (host, dev):
        r.rules.append(_bad_rule(r))
        r.add(WindowTriple("http://ex/p0", "http://ex/knows", "http://ex/p1"))
    dev._fx = None
    dh, dd = host.materialize(), dev.materialize()
    assert not dev._device_ok  # the reference's routing, visible
    assert sorted(_decode(host, dh)) == sorted(_decode(dev, dd))


def test_device_failure_propagates(monkeypatch):
    """No hidden fallback: a fixpoint failure raises out of materialize,
    leaves the device route on and reruns nothing on the host."""
    _, dev = _pair(jr2r.DeviceR2R, tr2r.DeviceR2R)
    for s in range(4):
        dev.add(WindowTriple(f"http://ex/p{s}", "http://ex/knows", f"http://ex/p{s + 1}"))

    def boom(*a, **k):
        raise RuntimeError("device fixpoint capacities failed to converge")

    host_runs = []
    monkeypatch.setattr(tfx.DeviceFixpoint, "infer_padded", boom)
    monkeypatch.setattr(tr2r.SimpleR2R, "materialize", lambda self: host_runs.append(1))
    with pytest.raises(RuntimeError, match="converge"):
        dev.materialize()
    assert dev._device_ok and not host_runs


@pytest.mark.parametrize("site", ["infer_padded", "maintenance"])
def test_failed_firing_is_not_covered_by_the_previous_closure(monkeypatch, site):
    """A firing that fails after a good one leaves no stale closure behind.
    The engine's retry (the same content removed and re-added, so no net
    delta) rebuilds the mirror from the db instead of reinstating the
    previous firing's derived facts: a broken fixpoint fails again, while a
    failed maintenance step is bypassed by the rebuild.  Once the device
    works the firing equals the host R2R."""
    host, dev = _pair(tr2r.SimpleR2R, tr2r.DeviceR2R)
    first = [WindowTriple(f"http://ex/p{i}", "http://ex/knows", f"http://ex/p{i + 1}") for i in range(4)]
    second = first[2:] + [WindowTriple("http://ex/p4", "http://ex/knows", "http://ex/p9"),
                          WindowTriple("http://ex/p9", "http://ex/knows", "http://ex/p2")]
    for r in (host, dev):
        for t in first:
            r.add(t)
    assert sorted(_decode(dev, dev.materialize())) == sorted(_decode(host, host.materialize()))

    def boom(*a, **k):
        raise RuntimeError("device lost")

    if site == "infer_padded":
        monkeypatch.setattr(tfx.DeviceFixpoint, "infer_padded", boom)
    else:
        monkeypatch.setattr(tr2r, "_window_maintain_impl", boom)
    for r in (host, dev):
        for t in first:
            r.remove(t)
        for t in second:
            r.add(t)
    with pytest.raises(RuntimeError, match="device lost"):
        dev.materialize()
    want = sorted(_decode(host, host.materialize()))
    for t in second:  # the retry of the same firing
        dev.remove(t)
        dev.add(t)
    if site == "infer_padded":
        with pytest.raises(RuntimeError, match="device lost"):
            dev.materialize()
        monkeypatch.undo()
        for t in second:
            dev.remove(t)
            dev.add(t)
    assert want and sorted(_decode(dev, dev.materialize())) == want
    assert _db_set(dev) == _db_set(host) and dev._device_ok


GUARD_RULES = """@prefix ex: <http://ex/> .
{ ex:net ex:mode ex:strict . ?x ex:reading ?v . } => { ?x ex:valid ?v . } .
"""


@pytest.mark.parametrize("guard", [True, False])
def test_ground_guard_is_evaluated_per_window(guard):
    """``TestDeviceR2RGroundGuard``: the guard premise is checked against
    each window's facts at run time, on both packages."""
    ref, port = _pair(jr2r.DeviceR2R, tr2r.DeviceR2R, GUARD_RULES, seed_triple=False)
    _, host = _pair(jr2r.SimpleR2R, tr2r.SimpleR2R, GUARD_RULES, seed_triple=False)
    items = [(f"http://ex/s{i}", "http://ex/reading", f"http://ex/v{i}") for i in range(4)]
    if guard:
        items.insert(0, ("http://ex/net", "http://ex/mode", "http://ex/strict"))
    for s, p, o in items:
        ref.add(JaxWindowTriple(s, p, o))
        for r in (port, host):
            r.add(WindowTriple(s, p, o))
    want = _decode(ref, ref.materialize())
    got = _decode(port, port.materialize())
    assert got == want
    assert sorted(_decode(host, host.materialize())) == sorted(want)
    assert any("valid" in p for _s, p, _o in got) == guard
    assert port._device_ok
