"""MLP neural predicate on ``torch.nn``.

Port of ``kolibrie_tpu/ml/mlp.py`` (parity: ``ml/src/candle_model.rs`` —
``MlpNeuralPredicate``: He init, ReLU hidden layers, sigmoid (binary) /
softmax (exclusive) output, Adam & SGD update rules, serde-JSON save/load).
The forward is ``h @ W + b`` with each weight in the reference's
``(in, out)`` layout, so a saved model is the same JSON file in either
package; the VJP is ``torch.autograd.grad``.  He init draws from a
``torch.Generator`` seeded by ``seed`` (it cannot reproduce
``jax.random``: carry weights across packages with :meth:`from_params`).
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from kolibrie_tpu_torch.backend import DeviceLike, resolve_device

Params = List[Tuple[torch.Tensor, torch.Tensor]]


def _forward(params: Params, x: torch.Tensor, output: str) -> torch.Tensor:
    h = x
    for w, b in params[:-1]:
        h = torch.relu(h @ w + b)
    w, b = params[-1]
    logits = h @ w + b
    if output == "binary":
        return torch.sigmoid(logits[..., 0])
    return torch.softmax(logits, dim=-1)


class MlpNeuralPredicate(torch.nn.Module):
    """MLP with probabilistic output, trained through WMC gradients.  Its
    parameters are f32 on ``device`` (the CUDA card unless the caller
    passes another)."""

    def __init__(
        self,
        in_dim: int,
        hidden: Optional[List[int]] = None,
        output_kind: str = "binary",
        labels: Optional[List[str]] = None,
        learning_rate: float = 0.01,
        optimizer: str = "adam",
        seed: int = 0,
        device: DeviceLike = None,
    ):
        super().__init__()
        self.device = resolve_device(device)
        self.in_dim = in_dim
        self.hidden = list(hidden or [16])
        self.output_kind = output_kind
        self.labels = list(labels or [])
        self.out_dim = 1 if output_kind == "binary" else max(len(self.labels), 2)
        self.learning_rate = learning_rate
        self.optimizer = optimizer
        # drawn on a CPU generator, so a seed gives the same weights on
        # every device
        gen = torch.Generator().manual_seed(seed)
        dims = [in_dim] + self.hidden + [self.out_dim]
        self.weights = torch.nn.ParameterList()
        self.biases = torch.nn.ParameterList()
        for i in range(len(dims) - 1):
            w = torch.randn(dims[i], dims[i + 1], generator=gen) * np.sqrt(
                2.0 / max(dims[i], 1)
            )
            self.weights.append(torch.nn.Parameter(w.to(self.device)))
            self.biases.append(
                torch.nn.Parameter(torch.zeros(dims[i + 1], device=self.device))
            )
        self._reset_adam()
        # feature standardization (StandardScaler parity, ml/examples/predictor.py)
        self.feature_mean = np.zeros(in_dim)
        self.feature_std = np.ones(in_dim)

    @classmethod
    def from_params(
        cls,
        params: Sequence[Tuple[np.ndarray, np.ndarray]],
        output_kind: str = "binary",
        labels: Optional[List[str]] = None,
        learning_rate: float = 0.01,
        optimizer: str = "adam",
        device: DeviceLike = None,
    ) -> "MlpNeuralPredicate":
        """A model holding ``params``, the reference's ``[(W, b), ...]``
        with each ``W`` of shape ``(in, out)`` (numpy or anything
        ``np.asarray`` reads), as f32 on ``device``."""
        params = [(np.asarray(w, np.float32), np.asarray(b, np.float32)) for w, b in params]
        hidden = [w.shape[1] for w, _b in params[:-1]]
        model = cls(params[0][0].shape[0], hidden, output_kind, labels, learning_rate,
                    optimizer, device=device)
        model._set_params(params)
        return model

    def _set_params(self, params) -> None:
        with torch.no_grad():
            for (w, b), pw, pb in zip(params, self.weights, self.biases):
                pw.copy_(torch.tensor(np.asarray(w, np.float32)))
                pb.copy_(torch.tensor(np.asarray(b, np.float32)))
        self._reset_adam()

    def _reset_adam(self) -> None:
        self._m = [torch.zeros_like(p) for p in self._flat()]
        self._v = [torch.zeros_like(p) for p in self._flat()]
        self._t = 0

    def _flat(self) -> List[torch.nn.Parameter]:
        return [t for wb in zip(self.weights, self.biases) for t in wb]

    @property
    def params(self) -> Params:
        """``[(W, b), ...]`` per layer, the reference's layout."""
        return list(zip(self.weights, self.biases))

    def params_numpy(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """A copy of the parameters as the reference's ``[(W, b), ...]``
        numpy f32."""
        return [
            (w.detach().cpu().numpy().copy(), b.detach().cpu().numpy().copy())
            for w, b in self.params
        ]

    def set_normalization(self, mean: np.ndarray, std: np.ndarray) -> None:
        self.feature_mean = np.asarray(mean, dtype=np.float64)
        std = np.asarray(std, dtype=np.float64)
        self.feature_std = np.where(std > 1e-9, std, 1.0)

    def _norm(self, x: np.ndarray) -> torch.Tensor:
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        z = ((x - self.feature_mean) / self.feature_std).astype(np.float32)
        return torch.from_numpy(z).to(self.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Probabilities of normalised features ``x`` (a tensor on the
        model's device)."""
        return _forward(self.params, x, self.output_kind)

    # ------------------------------------------------------------- inference

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Probabilities: (n,) for binary, (n, k) for exclusive."""
        with torch.no_grad():
            return self(self._norm(x)).cpu().numpy()

    def predict_labels(self, x: np.ndarray) -> List[str]:
        probs = self.predict(x)
        if self.output_kind == "binary":
            return ["true" if p >= 0.5 else "false" for p in probs]
        idx = probs.argmax(axis=-1)
        return [self.labels[i] if i < len(self.labels) else str(i) for i in idx]

    # -------------------------------------------------------------- training

    def forward_with_vjp(self, x: np.ndarray):
        """Returns ``(probs, backward)``: the probabilities as numpy (one
        readback), and ``backward(prob_cotangents)``, which gives the
        parameter gradients ``[(dW, db), ...]`` — the bridge from WMC seed
        gradients back into the network (candle_model.rs forward_with_grads
        parity)."""
        with torch.enable_grad():
            probs = self(self._norm(x))
        host = probs.detach().cpu().numpy()

        def backward(prob_cotangents: np.ndarray):
            g = torch.as_tensor(
                np.asarray(prob_cotangents), dtype=probs.dtype
            ).reshape(probs.shape).to(self.device)
            grads = torch.autograd.grad(probs, self._flat(), g)
            return list(zip(grads[0::2], grads[1::2]))

        return host, backward

    def apply_gradients(self, grads) -> None:
        """One step of the reference's SGD or Adam (candle_model.rs Adam
        state parity): Adam folds both bias corrections into the step size,
        ``lr·√(1−β2^t)/(1−β1^t)``, and adds ε to ``√v``."""
        flat = [g for gw_gb in grads for g in gw_gb]
        with torch.no_grad():
            if self.optimizer == "sgd":
                for p, g in zip(self._flat(), flat):
                    p.sub_(self.learning_rate * g)
                return
            self._t += 1
            b1, b2, eps = 0.9, 0.999, 1e-8
            t = self._t
            lr = float(self.learning_rate * np.sqrt(1 - b2**t) / (1 - b1**t))
            for i, (p, g) in enumerate(zip(self._flat(), flat)):
                self._m[i] = b1 * self._m[i] + (1 - b1) * g
                self._v[i] = b2 * self._v[i] + (1 - b2) * g * g
                p.sub_(lr * self._m[i] / (torch.sqrt(self._v[i]) + eps))

    # ------------------------------------------------------------- save/load

    def save(self, path: str) -> None:
        data = {
            "in_dim": self.in_dim,
            "hidden": self.hidden,
            "output_kind": self.output_kind,
            "labels": self.labels,
            "learning_rate": self.learning_rate,
            "optimizer": self.optimizer,
            "params": [{"w": w.tolist(), "b": b.tolist()} for w, b in self.params_numpy()],
            "feature_mean": self.feature_mean.tolist(),
            "feature_std": self.feature_std.tolist(),
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(data, f)

    @staticmethod
    def load(path: str, device: DeviceLike = None) -> "MlpNeuralPredicate":
        """A model saved by either package, on ``device`` (the CUDA card
        unless the caller passes another)."""
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        model = MlpNeuralPredicate(
            data["in_dim"],
            data["hidden"],
            data["output_kind"],
            data.get("labels"),
            data.get("learning_rate", 0.01),
            data.get("optimizer", "adam"),
            device=device,
        )
        model._set_params([(p["w"], p["b"]) for p in data["params"]])
        if "feature_mean" in data:
            model.set_normalization(
                np.asarray(data["feature_mean"]), np.asarray(data["feature_std"])
            )
        return model
