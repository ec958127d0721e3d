"""Compute operators of the PyTorch port: host numpy helpers (``join``,
``unique``), torch tensor ops (``device_join``, ``wcoj``) and the hand-written
CUDA kernels with their plain PyTorch versions (``kernels``).

The kernel entries ``merge_join``, ``filter_mask`` and ``tag_combine`` are
exported here, loaded on first use, as ``kolibrie_tpu/ops/__init__.py`` does.
"""

_LAZY_KERNELS = ("merge_join", "filter_mask", "tag_combine")

__all__ = ["round_cap", *_LAZY_KERNELS]


def round_cap(n: int, lo: int = 128) -> int:
    """Round a buffer size up to a power of two (>= ``lo``) — the shared
    capacity-rounding rule for every static-shape buffer, so buffer shapes
    stay stable across nearby sizes."""
    c = lo
    while c < n:
        c <<= 1
    return c


def __getattr__(name):
    if name in _LAZY_KERNELS:
        from kolibrie_tpu_torch.ops import kernels

        return getattr(kernels, name)
    raise AttributeError(name)
