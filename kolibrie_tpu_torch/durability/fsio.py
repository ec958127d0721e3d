"""Durable filesystem primitives: temp-write → fsync → rename.

The payload lands in a same-directory temp file, is fsynced, and is then
atomically renamed over the target (``os.replace``), after which the
DIRECTORY is fsynced so the rename itself survives a crash.  A reader can
therefore only ever observe the old complete file or the new complete
file — never a torn half-write.

Port of ``kolibrie_tpu/durability/fsio.py`` (copied).
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


def atomic_write_bytes(path: str, data: bytes, fsync: bool = True) -> None:
    with atomic_write(path, fsync=fsync) as fh:
        fh.write(data)


def atomic_rename_dir(tmp_dir: str, final_dir: str) -> None:
    """Atomically publish a fully-written directory: fsync the tree's
    files' directory entries, rename, fsync the parent.  Used for
    snapshot generations — a crash leaves either no ``final_dir`` or a
    complete one, never a partial."""
    fsync_dir(tmp_dir)
    os.rename(tmp_dir, final_dir)
    fsync_dir(os.path.dirname(os.path.abspath(final_dir)))
