"""kolint for the PyTorch port — repo-native static analysis of
``kolibrie_tpu_torch/``, and the runtime lock-discipline sanitizer
(:mod:`lockcheck`).

The serving stack's correctness invariants (template-stable compiled
shapes, deadline/trace context across thread hops, bounded metric
cardinality, the shared error taxonomy, lock discipline around shared
mutable state, kernels contained in ``ops/``) are enforced by
convention; this package machine-checks them.  Stdlib
``ast``/``tokenize`` only — no new dependencies.

Entry points:

- ``python -m kolibrie_tpu_torch.analysis [--json] [--baseline PATH] [paths…]``
  (default path ``kolibrie_tpu_torch/``, default baseline
  ``kolibrie_tpu_torch/analysis/kolint_baseline.json``);
- :func:`run` — programmatic API used by ``tests/test_torch_kolint.py``.

Rule catalog: ``--list-rules`` and ``--explain KLxxx``; the
suppression/baseline workflow is ``docs/ANALYSIS.md``'s.
"""

from kolibrie_tpu_torch.analysis.core import (
    Finding,
    RULES,
    default_baseline_path,
    load_baseline,
    run,
    write_baseline,
)

__all__ = [
    "Finding",
    "RULES",
    "default_baseline_path",
    "load_baseline",
    "run",
    "write_baseline",
]
