"""The port's MLP neural predicate and its one-device training step against
the JAX package's.

Both models hold the same weights: the JAX model draws them with
``jax.random`` and the port takes them through ``from_params`` (the two
packages' random streams differ, so freshly initialised models are never
compared).  The port runs on ``device="cpu"``, JAX on its CPU backend.
Tolerances: probabilities within 1e-6 absolute; gradients within 1e-5
relative to the largest gradient of their array; parameters after 20
optimiser steps, and the training step's outputs, within 1e-5 absolute.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kolibrie_tpu.ml.mlp import MlpNeuralPredicate as RefMlp
from kolibrie_tpu.parallel import train_step as ref_ts
from kolibrie_tpu_torch.ml.mlp import MlpNeuralPredicate
from kolibrie_tpu_torch.parallel import train_step as port_ts

KINDS = {
    "binary": dict(in_dim=3, hidden=[8], output_kind="binary", labels=None),
    "exclusive": dict(in_dim=2, hidden=[16, 4], output_kind="exclusive", labels=["0", "1", "2"]),
}


def pair(kind: str, seed: int = 0, **kw):
    spec = KINDS[kind]
    ref = RefMlp(spec["in_dim"], spec["hidden"], spec["output_kind"], spec["labels"],
                 seed=seed, **kw)
    params = [(np.asarray(w), np.asarray(b)) for w, b in ref.params]
    tm = MlpNeuralPredicate.from_params(params, spec["output_kind"], spec["labels"],
                                        device="cpu", **kw)
    rng = np.random.default_rng(seed + 5)
    mean, std = rng.normal(size=spec["in_dim"]), rng.uniform(0.5, 2.0, spec["in_dim"])
    ref.set_normalization(mean, std)
    tm.set_normalization(mean, std)
    return ref, tm


def features(kind: str, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, KINDS[kind]["in_dim"])) * 2.0


def cotangent(probs: np.ndarray, seed: int) -> np.ndarray:
    """A BCE-style cotangent for random labels (binary: one column)."""
    rng = np.random.default_rng(seed)
    p = np.clip(probs, 1e-7, 1 - 1e-7)
    y = rng.integers(0, 2, size=p.shape).astype(np.float64)
    return (-(y / p) + (1 - y) / (1 - p)) / len(p)


def assert_grads(got, want):
    for (gw, gb), (rw, rb) in zip(got, want):
        for g, r in ((gw, rw), (gb, rb)):
            g, r = g.detach().numpy(), np.asarray(r)
            assert g.shape == r.shape
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * max(np.abs(r).max(), 1e-12))


def assert_params(tm: MlpNeuralPredicate, ref, atol: float):
    for (tw, tb), (rw, rb) in zip(tm.params_numpy(), ref.params):
        np.testing.assert_allclose(tw, np.asarray(rw), rtol=0, atol=atol)
        np.testing.assert_allclose(tb, np.asarray(rb), rtol=0, atol=atol)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_forward_labels_and_vjp(kind):
    ref, tm = pair(kind)
    x = features(kind, 64, 1)
    np.testing.assert_allclose(tm.predict(x), ref.predict(x), rtol=0, atol=1e-6)
    assert tm.predict_labels(x) == ref.predict_labels(x)
    probs, backward = tm.forward_with_vjp(x)
    rprobs, rbackward = ref.forward_with_vjp(x)
    assert isinstance(probs, np.ndarray) and probs.dtype == np.float32
    np.testing.assert_allclose(probs, rprobs, rtol=0, atol=1e-6)
    cot = cotangent(rprobs, 2)
    assert_grads(backward(cot), rbackward(cot))
    # the reference's VJP is jax.vjp of the forward: hold it directly too
    xj = ref._norm(x)
    _, vjp_fn = jax.vjp(lambda p: ref_forward(p, xj, kind), ref.params)
    assert_grads(tm.forward_with_vjp(x)[1](cot), vjp_fn(jnp.asarray(cot, jnp.float32))[0])


def ref_forward(params, x, kind):
    from kolibrie_tpu.ml.mlp import _forward

    return _forward(params, x, KINDS[kind]["output_kind"])


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_twenty_optimiser_steps(kind, optimizer):
    ref, tm = pair(kind, seed=3, learning_rate=0.05, optimizer=optimizer)
    for step in range(20):
        x = features(kind, 32, 100 + step)
        probs, backward = tm.forward_with_vjp(x)
        rprobs, rbackward = ref.forward_with_vjp(x)
        cot = cotangent(rprobs, 200 + step)
        tm.apply_gradients(backward(cot))
        ref.apply_gradients(rbackward(cot))
    assert tm._t == ref._t
    assert_params(tm, ref, 1e-5)
    x = features(kind, 16, 9)
    np.testing.assert_allclose(tm.predict(x), ref.predict(x), rtol=0, atol=1e-5)


def test_adam_is_the_references_not_torch_optim():
    """ε sits beside √v with both bias corrections in the step size; a
    step of ``torch.optim.Adam`` (ε beside √(v/(1−β2^t))) lands elsewhere
    when the gradient is tiny."""
    ref, tm = pair("binary", learning_rate=0.1)
    grads = [(np.full(w.shape, 1e-9, np.float32), np.full(b.shape, 1e-9, np.float32))
             for w, b in tm.params_numpy()]
    tm.apply_gradients([(torch.from_numpy(w), torch.from_numpy(b)) for w, b in grads])
    ref.apply_gradients([(jnp.asarray(w), jnp.asarray(b)) for w, b in grads])
    assert_params(tm, ref, 1e-7)
    other = MlpNeuralPredicate.from_params(pair("binary")[1].params_numpy(), device="cpu")
    opt = torch.optim.Adam(other._flat(), lr=0.1)
    for p, g in zip(other._flat(), [torch.from_numpy(a) for wb in grads for a in wb]):
        p.grad = g
    opt.step()
    moved = max(float(np.abs(a - b).max()) for (a, _), (b, _) in
                zip(other.params_numpy(), tm.params_numpy()))
    assert moved > 1e-3


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_save_in_one_package_load_in_the_other(tmp_path, kind, direction):
    ref, tm = pair(kind, seed=4)
    path = str(tmp_path / "model.json")
    x = features(kind, 8, 11)
    if direction == "jax_to_port":
        ref.save(path)
        back = MlpNeuralPredicate.load(path, device="cpu")
        want, got = ref, back
    else:
        tm.save(path)
        back = RefMlp.load(path)
        want, got = tm, back
    np.testing.assert_allclose(got.predict(x), want.predict(x), rtol=0, atol=1e-6)
    assert got.labels == want.labels and got.hidden == want.hidden
    np.testing.assert_array_equal(got.feature_std, want.feature_std)


def carried_state(ref_state):
    """The reference's train state as the port's (tensors on the CPU)."""
    def t(a):
        return torch.from_numpy(np.array(a))

    return {
        "params": [(t(w), t(b)) for w, b in ref_state["params"]],
        "m": [(t(w), t(b)) for w, b in ref_state["m"]],
        "v": [(t(w), t(b)) for w, b in ref_state["v"]],
        "t": torch.tensor(int(ref_state["t"]), dtype=torch.int32),
    }


def assert_state(got, want, atol):
    for key in ("params", "m", "v"):
        for (gw, gb), (rw, rb) in zip(got[key], want[key]):
            np.testing.assert_allclose(gw.numpy(), np.asarray(rw), rtol=0, atol=atol)
            np.testing.assert_allclose(gb.numpy(), np.asarray(rb), rtol=0, atol=atol)
    assert int(got["t"]) == int(want["t"])


def test_make_train_state_shapes():
    ref = ref_ts.make_train_state(jax.random.PRNGKey(0), 5, (16, 8), 1)
    got = port_ts.make_train_state(torch.Generator().manual_seed(0), 5, (16, 8), 1, device="cpu")
    for key in ("params", "m", "v"):
        assert [(tuple(w.shape), tuple(b.shape)) for w, b in got[key]] == [
            (tuple(w.shape), tuple(b.shape)) for w, b in ref[key]]
        assert all(w.dtype == torch.float32 for w, _ in got[key])
    assert int(got["t"]) == 0 and got["t"].dtype == torch.int32
    assert all(not bool(w.any()) for w, _ in got["m"])
    # He init: the first layer's spread follows sqrt(2 / in)
    assert 0.3 < float(got["params"][0][0].std()) / np.sqrt(2 / 5) < 1.7


def test_bce_adam_update_and_dp_step():
    ref = ref_ts.make_train_state(jax.random.PRNGKey(1), 4, (16,), 1)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    st = carried_state(ref)
    np.testing.assert_allclose(
        float(port_ts._bce(st["params"], xt, yt)),
        float(ref_ts._bce(ref["params"], jnp.asarray(x), jnp.asarray(y))), rtol=1e-6)
    grads = [(rng.normal(size=w.shape).astype(np.float32), rng.normal(size=b.shape).astype(np.float32))
             for w, b in ref["params"]]
    got = port_ts._adam_update(st, [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in grads],
                               lr=0.01)
    want = ref_ts._adam_update(ref, [(jnp.asarray(w), jnp.asarray(b)) for w, b in grads], lr=0.01)
    assert_state(got, want, 1e-6)
    st, rst = carried_state(ref), ref
    for _ in range(5):
        st, loss = port_ts._dp_step(st, xt, yt, 0.05)
        rst, rloss = ref_ts._dp_step(rst, jnp.asarray(x), jnp.asarray(y), jnp.float32(0.05))
        np.testing.assert_allclose(float(loss), float(rloss), rtol=0, atol=1e-5)
    assert_state(st, rst, 1e-5)
