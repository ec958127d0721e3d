"""A helper for the port's parity tests: the JAX package compiles into an
empty persistent cache for the scope of a test (not a test module)."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def fresh_jax_compile_cache(path):
    """The JAX package compiles into an empty persistent cache at ``path``
    for the scope, then gets its earlier settings back.

    A template's ``source`` in ``plan_cache_info()`` is "disk" when JAX
    loaded its program from the persistent cache.  Once any module in the
    process has called the reference's ``compile_cache.enable`` (its
    ``DurabilityManager.recover`` does, and so do the durability tests),
    every later compile is written to that cache, and a program compiled
    by an earlier module reloads from it after the per-module
    ``jax.clear_caches()``: the reference then says "disk" where the port
    says "compiled".  An empty cache makes the reference's source depend
    on this module alone."""
    import jax
    from jax.experimental.compilation_cache import compilation_cache as jcc

    from kolibrie_tpu.query import compile_cache as ref_cc

    names = (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_entry_size_bytes",
        "jax_persistent_cache_min_compile_time_secs",
    )
    saved = {n: getattr(jax.config, n) for n in names}
    saved_active = ref_cc._active_dir
    jax.config.update("jax_compilation_cache_dir", str(path))
    jcc.reset_cache()  # the cache object binds its directory once
    try:
        yield
    finally:
        for n, v in saved.items():
            jax.config.update(n, v)
        ref_cc._active_dir = saved_active
        jcc.reset_cache()
