"""Train states shared by the port's training-step tests: the JAX
package's state carried into the port, and the comparison of the two."""

from __future__ import annotations

import numpy as np
import torch


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
