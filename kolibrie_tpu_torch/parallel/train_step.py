"""Neural-predicate training steps: one device and data-parallel over the mesh.

Port of ``kolibrie_tpu/parallel/train_step.py``: ``make_train_state`` (MLP
parameters + Adam moments, the same layer shapes as
:mod:`kolibrie_tpu_torch.ml.mlp`), the forward, the clipped BCE loss, the
bias-corrected Adam update and one step of all three on one device
(``value_and_grad`` becomes autograd); then :func:`dp_train_step`, the
batch split over the shards of a :class:`~kolibrie_tpu_torch.parallel.mesh.
Mesh` with the gradients all-reduced by a :func:`~kolibrie_tpu_torch.
parallel.mesh.psum`, and :func:`neurosymbolic_step`, that step followed by
one distributed reasoning round on the same mesh.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from kolibrie_tpu_torch.backend import DeviceLike, resolve_device
from kolibrie_tpu_torch.parallel.dist_fixpoint import adopt_state
from kolibrie_tpu_torch.parallel.mesh import psum


def make_train_state(
    generator: torch.Generator,
    in_dim: int,
    hidden: Tuple[int, ...] = (16,),
    out_dim: int = 1,
    device: DeviceLike = None,
) -> Dict:
    """MLP params + Adam moments (matches ml.mlp layer shapes); the He
    init draws from ``generator`` and lands on ``device`` (the CUDA card
    unless the caller passes another)."""
    dev = resolve_device(device)
    dims = (in_dim, *hidden, out_dim)
    params = []
    for i in range(len(dims) - 1):
        w = torch.randn(dims[i], dims[i + 1], generator=generator, dtype=torch.float32,
                        device=generator.device)
        w = w * np.sqrt(2.0 / max(dims[i], 1))
        params.append((w.to(dev), torch.zeros(dims[i + 1], dtype=torch.float32, device=dev)))
    zeros = [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in params]
    return {"params": params, "m": zeros, "v": zeros,
            "t": torch.zeros((), dtype=torch.int32, device=dev)}


def _forward(params: List[Tuple[torch.Tensor, torch.Tensor]], x: torch.Tensor):
    h = x
    for w, b in params[:-1]:
        h = torch.relu(h @ w + b)
    w, b = params[-1]
    return torch.sigmoid((h @ w + b)[..., 0])


def _bce(params, x, y):
    p = torch.clamp(_forward(params, x), 1e-7, 1.0 - 1e-7)
    return -torch.mean(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))


def _adam_update(state, grads, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
    """Adam with both bias corrections on the moments,
    ``(m/(1−β1^t)) / (√(v/(1−β2^t)) + ε)`` — the reference's form here,
    which differs from :meth:`MlpNeuralPredicate.apply_gradients`."""
    t = state["t"] + 1
    m = [(b1 * mw + (1 - b1) * gw, b1 * mb + (1 - b1) * gb)
         for (mw, mb), (gw, gb) in zip(state["m"], grads)]
    v = [(b2 * vw + (1 - b2) * gw * gw, b2 * vb + (1 - b2) * gb * gb)
         for (vw, vb), (gw, gb) in zip(state["v"], grads)]
    tf = t.to(torch.float32)
    c1, c2 = 1 - b1**tf, 1 - b2**tf

    def step(p, m_, v_):
        return p - lr * (m_ / c1) / (torch.sqrt(v_ / c2) + eps)

    params = [(step(pw, mw, vw), step(pb, mb, vb))
              for (pw, pb), (mw, mb), (vw, vb) in zip(state["params"], m, v)]
    return {"params": params, "m": m, "v": v, "t": t}


def _dp_step(st, xb, yb, lr):
    """One step on one device: the BCE loss and its gradients by autograd,
    then the Adam update.  Returns ``(new_state, loss)``."""
    params = [(w.detach().requires_grad_(), b.detach().requires_grad_())
              for w, b in st["params"]]
    with torch.enable_grad():
        loss = _bce(params, xb, yb)
        flat = torch.autograd.grad(loss, [t for wb in params for t in wb])
    grads = list(zip(flat[0::2], flat[1::2]))
    with torch.no_grad():
        return _adam_update(st, grads, lr=lr), loss.detach()


def _state_on(st, dev):
    """The train state's tensors on ``dev`` (copies only where needed)."""
    def mv(pairs):
        return [(w.to(dev), b.to(dev)) for w, b in pairs]

    return {"params": mv(st["params"]), "m": mv(st["m"]), "v": mv(st["v"]), "t": st["t"].to(dev)}


def dp_train_step(mesh, state: Dict, x: np.ndarray, y: np.ndarray, lr=1e-3):
    """One data-parallel Adam step: the batch split into one equal slice
    per shard on the shard's device, the parameters replicated.  Each shard
    takes the gradient of its own mean loss; the gradients' :func:`psum`
    divided by the shard count is the gradient of the whole batch's mean
    loss (equal slices), and the one Adam update runs on the replicated
    state.  The loss is the mean of the shard losses.  A batch that does
    not split evenly raises ``ValueError``, as the reference's sharded
    ``device_put`` does.  Returns ``(new_state, loss)`` on the first
    shard's device."""
    n = mesh.size
    x = np.asarray(x, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32)
    if x.shape[0] % n or y.shape[0] % n:
        raise ValueError(
            f"the batch's {x.shape[0]} rows do not split into {n} equal shards"
        )
    state = _state_on(state, mesh.devices[0])
    losses, grads = [], []
    for dev, xs, ys in zip(mesh.devices, np.split(x, n), np.split(y, n)):
        params = [(w.to(dev).detach().requires_grad_(), b.to(dev).detach().requires_grad_())
                  for w, b in state["params"]]
        xb, yb = torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)
        with torch.enable_grad():
            loss = _bce(params, xb, yb)
            grads.append(torch.autograd.grad(loss, [t for wb in params for t in wb]))
        losses.append(loss.detach())
    with torch.no_grad():
        flat = [psum([g[k] for g in grads]) / n for k in range(len(grads[0]))]
        new = _adam_update(state, list(zip(flat[0::2], flat[1::2])), lr=lr)
        return new, psum(losses) / n


def neurosymbolic_step(mesh, state: Dict, x: np.ndarray, y: np.ndarray, reasoner, store,
                       lr: float = 1e-3):
    """One :func:`dp_train_step` and one distributed semi-naive round
    (``reasoner._round``, a :class:`~kolibrie_tpu_torch.parallel.
    dist_fixpoint.DistributedReasoner`) over the store's state, on the same
    mesh.  The round's delta is the store's whole subject block.  The
    reference fuses both halves into one jitted program; here they run
    back to back on the mesh, and the round's count and overflow are read
    with one host sync.  On overflow raises ``OverflowError`` and leaves
    the store as it was; else writes the round's columns back into
    ``store.by_subj`` / ``by_obj`` and their valid masks.  Returns
    ``(new_state, loss, new_fact_count)``."""
    new_state, loss = dp_train_step(mesh, state, x, y, lr=lr)
    fcols, fv, gcols, gv = store.shard_state()
    out_state, count, overflow = reasoner._round((fcols, fv, gcols, gv, fcols, fv))
    first = count.device
    ovf, cnt, loss_h = torch.stack(
        [overflow.to(first).double(), count.to(first).double(), loss.to(first).double()]
    ).tolist()
    if ovf > 0:
        raise OverflowError(
            "fixpoint round buffer overflow inside neurosymbolic_step — "
            "grow the reasoner's fact_cap/delta_cap/join_cap/bucket_cap"
        )
    adopt_state(store, out_state)
    return new_state, float(loss_h), int(cnt)
