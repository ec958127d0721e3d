"""kolibrie_tpu_torch.analysis — the runtime lock-discipline sanitizer
(:mod:`lockcheck`), copied from ``kolibrie_tpu/analysis/``."""
