"""Differentiable weighted model counting: ∂WMC/∂p_v per seed variable.

Port of ``kolibrie_tpu/reasoner/diff_sdd.py`` (a copy, the imports rewritten).

Parity: ``shared/src/diff_sdd.rs:15-46`` — weight-substitution method: WMC is
multilinear, so WMC = w_pos(v)·A + w_neg(v)·B for any variable v; evaluate A
(set w_pos=1, w_neg=0) and B (w_pos=0, w_neg=1) and combine per ``VarKind``:

- independent (w_neg = 1 − p):  ∂WMC/∂p = A − B
- exclusive-group (w_neg = 1):  ∂WMC/∂p = A

Validated against finite differences in tests (diff_sdd.rs:84-111 parity).
This is the bridge between the host SDD engine and a training loop: the
gradients are the seed probabilities' cotangents.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

from kolibrie_tpu_torch.reasoner.sdd import SddManager


def wmc_gradient(
    manager: SddManager, nid: int, var_indices: Optional[Iterable[int]] = None
) -> Dict[int, float]:
    """Gradient of WMC(nid) w.r.t. each variable's success probability."""
    if var_indices is None:
        var_indices = range(len(manager.vars))
    native = getattr(manager, "wmc_gradient", None)
    if native is not None:
        # native engine computes the substitution sweep in C++
        return native(nid, list(var_indices))
    grads: Dict[int, float] = {}
    for v in var_indices:
        vi = manager.vars[v]
        saved = (vi.w_pos, vi.w_neg)
        vi.w_pos, vi.w_neg = 1.0, 0.0
        a = manager.wmc(nid)
        vi.w_pos, vi.w_neg = 0.0, 1.0
        b = manager.wmc(nid)
        vi.w_pos, vi.w_neg = saved
        if vi.kind == "independent":
            grads[v] = a - b
        else:  # exclusive group: w_neg pinned at 1
            grads[v] = a
    return grads


def wmc_gradient_by_seed(
    manager: SddManager, nid: int, seed_vars: Dict[int, int]
) -> Dict[int, float]:
    """Gradient keyed by seed_id (as used by the neurosymbolic trainer)."""
    per_var = wmc_gradient(manager, nid, seed_vars.values())
    return {sid: per_var[v] for sid, v in seed_vars.items()}
