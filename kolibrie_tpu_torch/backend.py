"""Device resolution and the integer carriers of the PyTorch port.

Device
------
Every entry point takes an explicit ``device``.  ``None`` means the CUDA
card; without one it raises instead of carrying on quietly on the CPU.
Tests and host-only callers pass ``device="cpu"``, where every kernel
wrapper takes its plain PyTorch version.

Carriers
--------
PyTorch has no ``searchsorted``, shifts or comparisons for ``uint32`` /
``uint64`` tensors, so the port carries the reference's unsigned words in
``int64``:

- a u32 dictionary ID rides as an ``int64`` tensor holding the same value
  (0 .. 2^32-1).  IDs with bit 31 set (quoted triples) and the
  ``0xFFFFFFFF`` never-an-ID sentinel stay positive, so they sort exactly
  as the reference's u32 columns do: quoted IDs after plain ones, the
  sentinel last;
- a packed two-column u64 key ``(a << 32) | b`` rides as that value XOR
  ``1 << 63`` reinterpreted as a signed word, i.e. ``u - 2^63``.  The map
  is monotone from ``[0, 2^64)`` onto ``[-2^63, 2^63)``, so signed order
  equals the reference's unsigned order; :func:`pack2` builds it without
  overflow as ``(a - 2^31) * 2^32 + b``;
- the join padding keys ``_LPAD = 0xFFFF_FFFF_FFFF_FFFE`` and
  ``_RPAD = 0xFFFF_FFFF_FFFF_FFFF`` map to ``2^63 - 2`` and ``2^63 - 1``:
  still the two largest keys, still distinct, so padding never joins with
  padding and sorts after every real key.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]

SENT = 0xFFFFFFFF  # u32 never-an-ID sentinel; also the padding fill
_MIN64 = -(1 << 63)  # carrier of the u64 zero: u - 2^63 == u + _MIN64
_LPAD = 0xFFFFFFFFFFFFFFFE + _MIN64  # carrier of the left padding key
_RPAD = 0xFFFFFFFFFFFFFFFF + _MIN64  # carrier of the right padding key


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    CUDA card.  Raises when no device is given and there is no card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def key1(a: torch.Tensor) -> torch.Tensor:
    """Carrier of a one-column u64 key (the u32 value widened)."""
    return a + _MIN64


def pack2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Carrier of the packed u64 key ``(a << 32) | b`` of two u32 columns."""
    return (a - (1 << 31)) * (1 << 32) + b
