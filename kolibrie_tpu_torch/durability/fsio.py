"""Durable filesystem primitives: temp-write → fsync → rename.

The payload lands in a same-directory temp file, is fsynced, and is then
atomically renamed over the target (``os.replace``), after which the
DIRECTORY is fsynced so the rename itself survives a crash.  A reader can
therefore only ever observe the old complete file or the new complete
file — never a torn half-write.

Port of ``kolibrie_tpu/durability/fsio.py`` (``fsync_dir`` and
``atomic_write``, copied).
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Iterator


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so a rename/creation inside it is durable.

    Some filesystems (and all of POSIX-pedantry) require this for the
    directory entry itself to survive power loss.  Platforms that cannot
    open a directory read-only (Windows) are a no-op."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


@contextmanager
def atomic_write(path: str, fsync: bool = True) -> Iterator:
    """Write ``path`` atomically: yield a binary file object backed by a
    same-directory temp file; on clean exit flush + fsync it, rename it
    over ``path``, and fsync the parent directory.  On error the temp
    file is removed and the old ``path`` (if any) is untouched."""
    path = os.fspath(path)
    d = os.path.dirname(os.path.abspath(path))
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
    fh = open(tmp, "wb")
    try:
        yield fh
        fh.flush()
        if fsync:
            os.fsync(fh.fileno())
        fh.close()
        os.replace(tmp, path)
        if fsync:
            fsync_dir(d)
    except BaseException:
        try:
            fh.close()
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        raise
