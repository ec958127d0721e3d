"""Primary-side segment shipping: :class:`ShipServer`.

A tiny TCP service bound to a live :class:`DurabilityManager`.  It
serves three things, all pull-driven by followers (the primary never
tracks follower state — a dead follower costs nothing):

- ``manifest`` — current snapshot generation + its file list, the sealed
  segment range, and the primary's durable WAL position.
- ``file``     — one snapshot-generation file, whole, CRC-stamped.
- ``seg``      — one SEALED WAL segment, whole, CRC-stamped.  Sealed
  segments are immutable (the writer only ever appends to the newest),
  which is what makes whole-file shipping + retry trivially idempotent.
- ``poll``     — seal the active segment if it holds records (rate
  limited by ``seal_interval_s`` so a chatty follower cannot force
  per-append rotation), then report sealed segments past the follower's
  watermark.

The poll-driven seal is the replication/durability contract in one
place: an acknowledged write sits in the active segment at position
``(seg, off)``; the next poll seals ``seg``; a follower that has applied
``seg`` therefore holds every acknowledged write up to that token —
the read-your-writes check in the HTTP layer is just
``applied_segment >= token.segment``.

Copy of ``kolibrie_tpu/replication/primary.py`` for the PyTorch port, its imports
rewritten.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Optional

from kolibrie_tpu_torch.durability.wal import list_segments, segment_path
from kolibrie_tpu_torch.obs import metrics as obs_metrics
from kolibrie_tpu_torch.replication.protocol import (
    ProtocolError,
    file_crc,
    recv_msg,
    send_msg,
)

_SEGS_SHIPPED = obs_metrics.counter(
    "kolibrie_repl_segments_shipped_total", "sealed WAL segments shipped"
)
_SHIP_BYTES = obs_metrics.counter(
    "kolibrie_repl_ship_bytes_total", "bytes shipped (segments + snapshots)"
)
_SEALS = obs_metrics.counter(
    "kolibrie_repl_seals_total", "poll-driven seals of the active segment"
)
_POLLS = obs_metrics.counter(
    "kolibrie_repl_polls_total", "follower poll requests served"
)
_SNAP_FILES_SHIPPED = obs_metrics.counter(
    "kolibrie_repl_snapshot_files_shipped_total",
    "snapshot generation files shipped to bootstrapping followers",
)


class ShipServer:
    """Streams the durability directory to followers.  One listener
    thread + one thread per follower connection; all state it serves is
    the manager's on-disk state, so there is nothing to lock against the
    ingest path except the seal rate limiter."""

    def __init__(
        self,
        manager,
        host: str = "127.0.0.1",
        port: int = 0,
        seal_interval_s: float = 0.25,
    ):
        self.manager = manager
        self.seal_interval_s = seal_interval_s
        self._last_seal = 0.0
        self._seal_lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.host, self.port = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._threads = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="repl-ship-accept", daemon=True
        )
        self._accept_thread.start()

    # ------------------------------------------------------------- serving

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return  # listener closed
            t = threading.Thread(
                target=self._serve_conn,
                args=(conn,),
                name="repl-ship-conn",
                daemon=True,
            )
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        conn.settimeout(30.0)
        rfile = conn.makefile("rb")
        try:
            while not self._stop.is_set():
                try:
                    got = recv_msg(rfile)
                except (ProtocolError, OSError):
                    return
                if got is None:
                    return
                meta, _tail = got
                try:
                    self._dispatch(conn, meta)
                except (ProtocolError, OSError):
                    return  # injected tear / peer gone: drop the conn
        finally:
            try:
                rfile.close()
                conn.close()
            except OSError:
                pass

    def _dispatch(self, conn: socket.socket, meta: dict) -> None:
        t = meta.get("t")
        q = meta.get("q")
        if t == "manifest":
            send_msg(conn, self._manifest_meta(q))
        elif t == "poll":
            _POLLS.inc()
            self._maybe_seal()
            send_msg(conn, self._poll_meta(q, int(meta.get("after", 0))))
        elif t == "file":
            self._send_snap_file(
                conn, q, int(meta.get("gen", 0)), str(meta.get("name", ""))
            )
        elif t == "seg":
            self._send_segment(conn, q, int(meta.get("seg", 0)))
        else:
            send_msg(conn, {"t": "err", "q": q, "reason": f"unknown type {t!r}"})

    # ------------------------------------------------------------- replies

    def _wal_state(self):
        """(sealed_segments, wal_start, position, records) — all from
        disk + the live writer, consistent enough for pull-style
        shipping.  ``records`` is the writer's process-lifetime append
        count: the follower differences it against its own apply count
        for the ``kolibrie_repl_lag_records`` SLO gauge."""
        wal = self.manager.wal
        segs = list_segments(self.manager.wal_dir)
        if wal is not None:
            active, off = wal.position()
            records = wal.appended_records
        else:
            active, off = (segs[-1] + 1) if segs else 1, 0
            records = 0
        sealed = [i for i in segs if i < active]
        wal_start = segs[0] if segs else active
        return sealed, wal_start, (active, off), records

    def _manifest_meta(self, q) -> dict:
        gen = self.manager.generation
        files = []
        if gen > 0:
            root = self.manager.generation_dir(gen)
            for name in sorted(os.listdir(root)):
                path = os.path.join(root, name)
                if os.path.isfile(path):
                    files.append({"name": name, "size": os.path.getsize(path)})
        sealed, wal_start, pos, records = self._wal_state()
        return {
            "t": "manifest",
            "q": q,
            "gen": gen,
            "files": files,
            "sealed": sealed,
            "wal_start": wal_start,
            "pos": list(pos),
            "records": records,
        }

    def _maybe_seal(self) -> None:
        wal = self.manager.wal
        if wal is None:
            return
        with self._seal_lock:
            now = time.monotonic()
            if now - self._last_seal < self.seal_interval_s:
                return
            self._last_seal = now
        if wal.seal_if_dirty() is not None:
            _SEALS.inc()

    def _poll_meta(self, q, after: int) -> dict:
        sealed, wal_start, pos, records = self._wal_state()
        return {
            "t": "poll",
            "q": q,
            "sealed": [i for i in sealed if i > after],
            "wal_start": wal_start,
            "gen": self.manager.generation,
            "pos": list(pos),
            "records": records,
            "now": time.time(),
        }

    def _send_snap_file(self, conn, q, gen: int, name: str) -> None:
        if gen <= 0 or not name or os.path.basename(name) != name:
            send_msg(conn, {"t": "err", "q": q, "reason": "bad file request"})
            return
        path = os.path.join(self.manager.generation_dir(gen), name)
        try:
            with open(path, "rb") as fh:
                data = fh.read()
        except OSError as exc:
            send_msg(conn, {"t": "err", "q": q, "reason": repr(exc)})
            return
        _SNAP_FILES_SHIPPED.inc()
        _SHIP_BYTES.inc(len(data))
        send_msg(
            conn,
            {"t": "file", "q": q, "name": name, "crc": file_crc(data)},
            data,
        )

    def _send_segment(self, conn, q, seg: int) -> None:
        sealed, wal_start, _pos, _records = self._wal_state()
        if seg not in sealed:
            # pruned by a snapshot (bootstrap again) or not sealed yet
            send_msg(
                conn, {"t": "gone", "q": q, "seg": seg, "wal_start": wal_start}
            )
            return
        path = segment_path(self.manager.wal_dir, seg)
        try:
            with open(path, "rb") as fh:
                data = fh.read()
        except OSError as exc:
            send_msg(conn, {"t": "err", "q": q, "reason": repr(exc)})
            return
        _SEGS_SHIPPED.inc()
        _SHIP_BYTES.inc(len(data))
        send_msg(
            conn,
            {"t": "seg", "q": q, "seg": seg, "crc": file_crc(data)},
            data,
        )

    # -------------------------------------------------------------- admin

    def stats(self) -> dict:
        sealed, wal_start, pos, _records = self._wal_state()
        return {
            "role": "primary",
            "addr": f"{self.host}:{self.port}",
            "sealed_segments": len(sealed),
            "wal_start": wal_start,
            "position": list(pos),
            "seal_interval_s": self.seal_interval_s,
        }

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
