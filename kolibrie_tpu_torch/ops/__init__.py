"""Compute operators of the PyTorch port: host numpy helpers (``join``,
``unique``), torch tensor ops (``device_join``, ``wcoj``) and the hand-written
CUDA kernels with their plain PyTorch versions (``kernels``)."""

__all__ = ["round_cap"]


def round_cap(n: int, lo: int = 128) -> int:
    """Round a buffer size up to a power of two (>= ``lo``) — the shared
    capacity-rounding rule for every static-shape buffer, so buffer shapes
    stay stable across nearby sizes."""
    c = lo
    while c < n:
        c <<= 1
    return c
