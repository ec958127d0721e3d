"""Replication wire protocol: WAL frames over TCP.

A message is exactly one WAL record frame (``durability/wal.py``)::

    u32 payload_len | u32 crc32(payload) | u32 meta_len | meta JSON | tail

so the ship path reuses :func:`~kolibrie_tpu_torch.durability.wal.encode_record`
/ :func:`~kolibrie_tpu_torch.durability.wal.read_frame` verbatim — one frame
format on disk and on the wire, one CRC discipline, one torn-delivery
story.  ``meta`` is the message (``{"t": "...", "q": seq, ...}``); bulk
bytes (snapshot files, whole sealed segments) ride in the tail.

The protocol is strict request/response, but every request carries a
client-chosen sequence id ``q`` which the server echoes.  That makes the
three injected delivery faults (site ``repl.send``) detectable:

- **torn** — the sender transmits a prefix and drops the connection; the
  receiver's ``read_frame`` raises (short read / CRC) and the client
  reconnects and re-requests.
- **dropped** — the frame never leaves the sender; the receiver's socket
  timeout fires and the client reconnects and re-requests.
- **duplicated** — the frame arrives twice; the second copy's stale
  ``q`` identifies it and the receiver discards it (and the replication
  layer additionally skips already-applied segments by watermark, so
  even a re-APPLIED segment is a no-op).

Copy of ``kolibrie_tpu/replication/protocol.py`` for the PyTorch port, its imports
rewritten.
"""

from __future__ import annotations

import socket
import threading
import zlib
from typing import Optional, Tuple

from kolibrie_tpu_torch.durability.wal import encode_record, read_frame
from kolibrie_tpu_torch.obs import metrics as obs_metrics
from kolibrie_tpu_torch.resilience.errors import DurabilityError
from kolibrie_tpu_torch.resilience.faultinject import (
    InjectedShipDrop,
    InjectedShipDuplicate,
    InjectedShipTorn,
    fault_point,
)

#: default per-request socket timeout — a dropped frame must turn into a
#: reconnect quickly enough that replication lag stays bounded
DEFAULT_TIMEOUT_S = 5.0

_SHIP_FAULTS = obs_metrics.counter(
    "kolibrie_repl_ship_faults_total",
    "injected/observed delivery faults at the ship layer",
    labels=("kind",),
)
_DUP_DISCARDS = obs_metrics.counter(
    "kolibrie_repl_duplicate_frames_discarded_total",
    "stale-sequence frames discarded by the ship client",
)


class ProtocolError(DurabilityError):
    """The ship stream desynchronised (torn frame, bad CRC, unexpected
    sequence id).  The remedy is always the same: drop the connection,
    reconnect, re-request — sealed segments are immutable so a retry is
    never wrong."""


def send_msg(sock: socket.socket, meta: dict, tail: bytes = b"") -> None:
    """Send one message; the ``repl.send`` fault site may tear, drop, or
    duplicate the delivery (chaos tests arm it)."""
    frame = encode_record(meta, tail)
    try:
        fault_point("repl.send")
    except InjectedShipTorn:
        _SHIP_FAULTS.labels("torn").inc()
        try:
            sock.sendall(frame[: max(1, len(frame) // 2)])
        finally:
            # the tear IS the connection dying mid-frame
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        raise ProtocolError("injected torn ship delivery")
    except InjectedShipDrop:
        _SHIP_FAULTS.labels("dropped").inc()
        return  # silently never sent; the peer's timeout handles it
    except InjectedShipDuplicate:
        _SHIP_FAULTS.labels("duplicated").inc()
        sock.sendall(frame)
        sock.sendall(frame)
        return
    sock.sendall(frame)


def recv_msg(rfile) -> Optional[Tuple[dict, bytes]]:
    """Read one message from a buffered socket file (``makefile("rb")``).
    Returns ``(meta, tail)`` or None on clean EOF; raises
    :class:`ProtocolError` on a torn/corrupt frame."""
    try:
        return read_frame(rfile)
    except DurabilityError as exc:
        raise ProtocolError(f"ship stream corrupt: {exc}") from exc


def file_crc(data: bytes) -> int:
    """Whole-payload CRC for shipped files/segments — checked end to end
    on top of the per-frame CRC (defence in depth: a duplicated or
    reordered delivery must not splice two valid frames into one bad
    file)."""
    return zlib.crc32(data) & 0xFFFFFFFF


class ShipClient:
    """Request/response client over one persistent connection, with
    sequence-id bookkeeping and reconnect-on-fault.  Thread-safe for one
    caller at a time (the follower's poll loop); a lock guards against
    accidental concurrent use."""

    def __init__(
        self,
        host: str,
        port: int,
        timeout_s: float = DEFAULT_TIMEOUT_S,
    ):
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self._sock: Optional[socket.socket] = None
        self._rfile = None
        self._seq = 0
        self._lock = threading.Lock()

    # ------------------------------------------------------------- wiring

    def _connect(self) -> None:
        self.close()
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout_s
        )
        sock.settimeout(self.timeout_s)
        self._sock = sock
        self._rfile = sock.makefile("rb")

    def close(self) -> None:
        if self._rfile is not None:
            try:
                self._rfile.close()
            except OSError:
                pass
            self._rfile = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # ------------------------------------------------------------ request

    def request(self, meta: dict, tail: bytes = b"") -> Tuple[dict, bytes]:
        """Send ``meta`` (a fresh ``q`` is stamped in) and return the
        matching response.  Stale-``q`` frames (duplicated deliveries)
        are discarded; timeouts, tears, and desyncs raise
        :class:`ProtocolError` after tearing the connection down so the
        next call reconnects."""
        with self._lock:
            if self._sock is None:
                self._connect()
            self._seq += 1
            q = self._seq
            req = dict(meta)
            req["q"] = q
            try:
                send_msg(self._sock, req, tail)
                while True:
                    got = recv_msg(self._rfile)
                    if got is None:
                        raise ProtocolError("ship connection closed")
                    rmeta, rtail = got
                    rq = rmeta.get("q")
                    if rq == q:
                        if rmeta.get("t") == "err":
                            raise ProtocolError(
                                f"ship server error: {rmeta.get('reason')}"
                            )
                        return rmeta, rtail
                    if isinstance(rq, int) and rq < q:
                        # duplicated delivery of an earlier reply
                        _DUP_DISCARDS.inc()
                        continue
                    raise ProtocolError(
                        f"ship stream desync: expected q={q} got q={rq!r}"
                    )
            except (OSError, ProtocolError):
                self.close()
                raise
            except Exception:
                self.close()
                raise
