"""The shard mesh and the two collectives of the mesh bodies.

Port of ``kolibrie_tpu/parallel/mesh.py``.  The reference drives a
``jax.sharding.Mesh`` from one controller, and its ``shard_map`` bodies
exchange rows with ``lax.all_to_all`` and reduce with ``lax.psum``.  The
port keeps the single controller: a :class:`Mesh` is a tuple of
``torch.device`` (one entry per shard; entries may repeat, so several
shards can share one card), a sharded array is a tuple of per-shard 1-D
tensors, each on its shard's device, and a body is controller code that
loops over the shards, split at every collective point.

:func:`all_to_all` and :func:`psum` are those collectives over per-shard
lists.  No process group is involved: the server keeps its sharded
database in its own process, and one card can hold several shards.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

AXIS_SHARDS = "shards"  # the triple-store partitioning axis


def mesh_axis() -> str:
    return AXIS_SHARDS


class Mesh:
    """One-dimensional mesh: ``devices`` holds one ``torch.device`` per
    shard (repeats allowed), ``axis_names`` the one axis, ``size`` the
    shard count.  Hashable, so program caches may key on it."""

    def __init__(self, devices: Sequence, axis_name: str = AXIS_SHARDS):
        self.devices: Tuple[torch.device, ...] = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = (axis_name,)
        self.size = len(self.devices)

    def _key(self):
        return (tuple(str(d) for d in self.devices), self.axis_names)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis_names[0]!r})"


def make_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence] = None,
    axis_name: str = AXIS_SHARDS,
) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (default: every
    CUDA card once).  Without a card and without ``devices`` it raises, as
    every entry point of the port does; ``devices=[torch.device("cpu")] * 8``
    gives eight CPU shards."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass devices=[torch.device('cpu')] * n to run on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"requested {n_devices} devices, only {len(devices)} present")
        devices = devices[:n_devices]
    return Mesh(devices, axis_name)


# ---------------------------------------------------------------------------
# collectives over per-shard lists
# ---------------------------------------------------------------------------


def all_to_all(bufs: Sequence[torch.Tensor]) -> list:
    """``lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)``: shard
    *i* holds ``bufs[i]`` of shape ``[n, cap]``; destination *j* receives
    row *j* of every source, in source order, as one ``[n * cap]`` tensor on
    its own device (``bufs[j].device``)."""
    out = []
    for j, dst in enumerate(bufs):
        out.append(torch.cat([b[j].to(dst.device) for b in bufs]))
    return out


def psum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of per-shard scalars, on the first shard's device."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(total.device)
    return total


# ---------------------------------------------------------------------------
# host <-> sharded arrays
# ---------------------------------------------------------------------------


def _carrier(a: np.ndarray) -> np.ndarray:
    """ID columns ride as int64 (see :mod:`kolibrie_tpu_torch.backend`);
    masks and float payloads keep their dtype."""
    a = np.asarray(a)
    if a.dtype == np.bool_ or a.dtype.kind == "f":
        return np.ascontiguousarray(a)
    return np.ascontiguousarray(a.astype(np.int64))


def shard_put(mesh: Mesh, a: np.ndarray) -> tuple:
    """A host ``[n_shards, L]`` array as a sharded array: row *i* on
    ``mesh.devices[i]``."""
    a = _carrier(a)
    if a.shape[0] != mesh.size:
        raise ValueError(f"leading dimension {a.shape[0]} != {mesh.size} shards")
    return tuple(torch.from_numpy(a[i].copy()).to(dev) for i, dev in enumerate(mesh.devices))


def shard_get(sharded: Sequence[torch.Tensor]) -> np.ndarray:
    """A sharded array of equal-length shards back as host ``[n, L]``."""
    return np.stack([t.cpu().numpy() for t in sharded])


def replicate(mesh: Mesh, t: torch.Tensor) -> tuple:
    """One copy of ``t`` per shard, on the shard's device (copies on one
    device are shared)."""
    copies = {}
    out = []
    for dev in mesh.devices:
        key = str(dev)
        if key not in copies:
            copies[key] = t.to(dev)
        out.append(copies[key])
    return tuple(out)
