"""One device's neural-predicate training step.

Port of the single-device half of ``kolibrie_tpu/parallel/train_step.py``:
``make_train_state`` (MLP parameters + Adam moments, the same layer shapes
as :mod:`kolibrie_tpu_torch.ml.mlp`), the forward, the clipped BCE loss, the
bias-corrected Adam update and one step of all three (``value_and_grad``
becomes autograd).  The data-parallel step and the step fused with a
distributed reasoning round need a mesh and come with the multi-device
slice.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from kolibrie_tpu_torch.backend import DeviceLike, resolve_device


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
