"""Copy of ``kolibrie_tpu/durability/wal.py`` for the PyTorch port: the
same frame, the same bytes.

Checksummed, segmented write-ahead log.

Layout (``<data_dir>/wal/``)::

    wal-00000001.log
    wal-00000002.log
    ...

Each segment starts with an 8-byte magic (``KWALSEG1``) followed by a
stream of self-describing records.  A record frame is::

    u32 payload_len | u32 crc32(payload) | payload

and the payload is::

    u32 meta_len | meta (UTF-8 JSON) | binary tail

``meta`` carries the record kind and small structured fields (delete
lists, session ids, term-block offsets); the binary tail carries bulk
data (the newly interned term/quoted growth block followed by uint32
little-endian s/p/o arrays for mutation batches — see
``manager._StoreAttachment._dict_growth`` — and UTF-8 JSON blobs for
RSP session checkpoints).  All integers are little-endian.

Torn-write / corruption semantics (the reference's docs/DURABILITY.md): the recovery
scanner replays records in order and STOPS at the first frame that is
short (torn write at crash), fails its CRC (bit rot / torn mid-frame),
or is structurally invalid.  The bad suffix is physically truncated from
the segment and any later segments are discarded — a record is only ever
replayed if every record before it was intact.

Fault sites (resilience.faultinject): ``wal.append`` may inject
:class:`~kolibrie_tpu_torch.resilience.faultinject.InjectedTornWrite` (half the
frame reaches the file, then the append fails — a simulated crash
mid-write) or ``InjectedBitFlip`` (the frame is silently corrupted on
disk; only recovery's CRC check notices); ``wal.fsync`` may inject
``InjectedFsyncFault`` (the fsync fails after the write — a simulated
partial fsync / dying disk).
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

from kolibrie_tpu_torch.durability.fsio import fsync_dir
from kolibrie_tpu_torch.obs import metrics as obs_metrics
from kolibrie_tpu_torch.resilience.errors import DurabilityError
from kolibrie_tpu_torch.resilience.faultinject import (
    InjectedBitFlip,
    InjectedFsyncFault,
    InjectedTornWrite,
    fault_point,
)

SEG_MAGIC = b"KWALSEG1"
_FRAME = struct.Struct("<II")  # payload_len, crc32
_META_LEN = struct.Struct("<I")
#: sanity bound on a single record; a corrupt length field must not make
#: the scanner try to allocate gigabytes
MAX_RECORD_BYTES = 1 << 30

FSYNC_POLICIES = ("always", "group", "never")

_WAL_APPEND_BYTES = obs_metrics.counter(
    "kolibrie_wal_append_bytes_total", "bytes appended to the WAL"
)
_WAL_RECORDS = obs_metrics.counter(
    "kolibrie_wal_records_total", "WAL records appended by kind", labels=("kind",)
)
_WAL_APPEND_LAT = obs_metrics.histogram(
    "kolibrie_wal_append_seconds", "WAL append (encode+write) wall time"
)
_WAL_FSYNC_LAT = obs_metrics.histogram(
    "kolibrie_wal_fsync_seconds", "WAL fsync wall time"
)
_WAL_FSYNCS = obs_metrics.counter(
    "kolibrie_wal_fsyncs_total", "WAL fsync calls"
)
_WAL_GROUP_FSYNC_ERRORS = obs_metrics.counter(
    "kolibrie_wal_group_fsync_errors_total",
    "background group-commit fsyncs that failed (retried at next flush)",
)


def segment_path(wal_dir: str, index: int) -> str:
    return os.path.join(wal_dir, f"wal-{index:08d}.log")


def list_segments(wal_dir: str) -> List[int]:
    """Sorted segment indices present on disk."""
    out = []
    try:
        names = os.listdir(wal_dir)
    except FileNotFoundError:
        return out
    for name in names:
        if name.startswith("wal-") and name.endswith(".log"):
            try:
                out.append(int(name[4:-4]))
            except ValueError:
                continue
    out.sort()
    return out


def encode_record(meta: dict, tail: bytes = b"") -> bytes:
    # incremental crc + a single join: a bulk-load record's tail is
    # ~100KB+ and this path runs per mutation, so no intermediate
    # payload copies
    mb = json.dumps(meta, separators=(",", ":")).encode("utf-8")
    head = _META_LEN.pack(len(mb))
    crc = zlib.crc32(tail, zlib.crc32(mb, zlib.crc32(head)))
    plen = len(head) + len(mb) + len(tail)
    return b"".join((_FRAME.pack(plen, crc), head, mb, tail))


def _flip_bit(frame: bytes) -> bytes:
    """Deterministically corrupt one payload bit (past the 8-byte frame
    header, so the CRC check — not the length field — catches it)."""
    b = bytearray(frame)
    i = _FRAME.size + (len(b) - _FRAME.size) // 2
    b[i] ^= 0x40
    return bytes(b)


class WalWriter:
    """Appender over the active segment.  Thread-safe; one per process.

    ``fsync_policy``:

    - ``always`` — fsync after every append; an acknowledged append is
      durable (the chaos kill tests run under this).
    - ``group``  — group commit: appends are flushed to the OS
      immediately; a background flusher thread fsyncs the segment once
      per ``group_interval_s`` while dirty (plus inline at flush /
      rotation / close), so the ingest path never blocks on fsync.  The
      default: bounded data loss (~one group window) for near-zero
      overhead.
    - ``never``  — no explicit fsync (OS writeback only); crash-unsafe,
      for benchmarking the fsync cost itself.
    """

    def __init__(
        self,
        wal_dir: str,
        start_segment: int = 1,
        fsync_policy: str = "group",
        segment_bytes: int = 64 * 1024 * 1024,
        group_interval_s: float = 0.05,
    ):
        if fsync_policy not in FSYNC_POLICIES:
            raise ValueError(f"unknown fsync policy: {fsync_policy!r}")
        os.makedirs(wal_dir, exist_ok=True)
        self.wal_dir = wal_dir
        self.fsync_policy = fsync_policy
        self.segment_bytes = segment_bytes
        self.group_interval_s = group_interval_s
        self._lock = threading.Lock()
        self.segment = start_segment  # guarded by: _lock
        self._fh = None  # guarded by: _lock
        self._size = 0  # guarded by: _lock
        self._last_fsync = 0.0  # guarded by: _lock
        self._dirty = False  # guarded by: _lock
        self.appended_records = 0  # guarded by: _lock
        self.appended_bytes = 0  # guarded by: _lock
        self._stop = threading.Event()
        self._flusher: Optional[threading.Thread] = None
        self._open_segment(start_segment)
        if fsync_policy == "group":
            self._flusher = threading.Thread(
                target=self._group_flush_loop,
                name="wal-group-commit",
                daemon=True,
            )
            self._flusher.start()

    def _group_flush_loop(self) -> None:
        """Group-commit flusher: fsync the dirty segment once per
        interval, off the append path.  The fsync itself runs OUTSIDE
        the lock so appends never stall behind it; records landing while
        the sync is in flight re-mark the segment dirty and are covered
        by the next interval."""
        while not self._stop.wait(self.group_interval_s):
            with self._lock:
                if self._fh is None:
                    return
                if not self._dirty:
                    continue
                fh = self._fh
                self._dirty = False
            t0 = time.perf_counter()
            try:
                fault_point("wal.fsync")  # may raise InjectedFsyncFault
                os.fsync(fh.fileno())
            except (OSError, ValueError, InjectedFsyncFault):
                # failed (or raced a rotation closing fh, which fsyncs
                # itself): the loss window extends one interval; the
                # next foreground flush/rotate/close retries and
                # surfaces a real failure to the caller
                _WAL_GROUP_FSYNC_ERRORS.inc()
                with self._lock:
                    self._dirty = True
                continue
            with self._lock:
                self._last_fsync = time.monotonic()
            _WAL_FSYNCS.inc()
            _WAL_FSYNC_LAT.observe(time.perf_counter() - t0)

    def _open_segment(self, index: int) -> None:  # kolint: holds[_lock]
        # Append-only stream, not an atomic-rename artifact: segments are
        # the one durable file class that is EXTENDED in place, with
        # torn tails handled by the CRC scanner instead of rename.
        path = segment_path(self.wal_dir, index)
        fh = open(path, "ab")  # kolint: ignore[KL701] WAL segments are append-only streams; torn tails are the scanner's job, not rename's
        if fh.tell() == 0:
            fh.write(SEG_MAGIC)
            fh.flush()
            os.fsync(fh.fileno())
            fsync_dir(self.wal_dir)
        self._fh = fh
        self._size = fh.tell()
        self.segment = index
        self._last_fsync = time.monotonic()

    # ---------------------------------------------------------------- append

    def append(self, meta: dict, tail: bytes = b"") -> Tuple[int, int]:
        """Append one record; returns ``(segment, offset_after)``.

        Durability of the returned position depends on the fsync policy
        (see class docstring)."""
        t0 = time.perf_counter()
        frame = encode_record(meta, tail)
        with self._lock:
            if self._fh is None:
                raise DurabilityError("WAL writer is closed")
            try:
                fault_point("wal.append")
            except InjectedTornWrite:
                # simulated crash mid-write: half the frame reaches the
                # file, the append itself fails upward
                self._fh.write(frame[: max(1, len(frame) // 2)])
                self._fh.flush()
                self._dirty = True
                raise DurabilityError("injected torn write at wal.append")
            except InjectedBitFlip:
                # silent corruption: the full-length frame lands with a
                # flipped payload bit; only recovery's CRC notices
                frame = _flip_bit(frame)
            self._fh.write(frame)
            self._fh.flush()
            self._dirty = True
            self._size += len(frame)
            self.appended_records += 1
            self.appended_bytes += len(frame)
            if self.fsync_policy == "always":
                self._fsync_locked()
            # "group" is handled by the background flusher thread
            if self._size >= self.segment_bytes:
                self._rotate_locked()
            pos = (self.segment, self._size)
        _WAL_APPEND_BYTES.inc(len(frame))
        # clamp the label to the known record kinds: a future/unknown kind
        # must not mint unbounded label values
        kind = meta.get("k")
        _WAL_RECORDS.labels(
            kind if kind in ("mut", "store", "sess", "sck", "sdel") else "other"
        ).inc()
        _WAL_APPEND_LAT.observe(time.perf_counter() - t0)
        return pos

    def _fsync_locked(self) -> None:  # kolint: holds[_lock]
        fault_point("wal.fsync")  # may raise InjectedFsyncFault
        t0 = time.perf_counter()
        os.fsync(self._fh.fileno())
        self._last_fsync = time.monotonic()
        self._dirty = False
        _WAL_FSYNCS.inc()
        _WAL_FSYNC_LAT.observe(time.perf_counter() - t0)

    def flush(self) -> None:
        """Force flush + fsync (graceful shutdown, pre-snapshot
        barrier).  Unconditional: under ``group`` the background flusher
        may have cleared ``_dirty`` while its fsync is still in flight,
        so the barrier may not trust the flag."""
        with self._lock:
            if self._fh is None:
                return
            self._fh.flush()
            if self.fsync_policy != "never":
                self._fsync_locked()

    def rotate(self) -> int:
        """Close the active segment (fsynced) and start the next; returns
        the NEW segment index.  Snapshots rotate first so the manifest's
        ``wal_start`` cleanly bounds what must be replayed."""
        with self._lock:
            self._rotate_locked()
            return self.segment

    def seal_if_dirty(self) -> Optional[int]:
        """Rotate ONLY if the active segment holds records; returns the
        sealed (now-immutable) segment index, or None if there was
        nothing to seal.  The replication shipper calls this so followers
        can pull the tail of the log without shipping half-open files —
        sealed segments never change, which is what makes whole-file CRC
        shipping sound."""
        with self._lock:
            if self._fh is None or self._size <= len(SEG_MAGIC):
                return None
            sealed = self.segment
            self._rotate_locked()
            return sealed

    def position(self) -> Tuple[int, int]:
        """Durable high-water mark ``(segment, byte_offset)`` of the
        active segment — the watermark token handed to clients for
        read-your-writes and shown in ``/healthz``."""
        with self._lock:
            return self.segment, self._size

    def write_token(self) -> Tuple[int, int]:
        """``(segment, byte_offset)`` just past the last record appended:
        the segment a follower must have applied to hold every write so
        far.  Equal to :meth:`position` unless the active segment holds
        no record yet — a follower's poll sealed it, or an append rotated
        it, after the last append — in which case the records end in the
        sealed segment before it, and a token naming the empty one would
        wait for a segment no seal ships until the next write."""
        with self._lock:
            seg, size = self.segment, self._size
        if size > len(SEG_MAGIC) or seg <= 1:
            return seg, size
        try:
            return seg - 1, os.path.getsize(segment_path(self.wal_dir, seg - 1))
        except OSError:  # pruned: the snapshot that pruned it holds it
            return seg - 1, 0

    def _rotate_locked(self) -> None:  # kolint: holds[_lock]
        self._fh.flush()
        if self.fsync_policy != "never":
            self._fsync_locked()
        self._fh.close()
        self._open_segment(self.segment + 1)

    def close(self) -> None:
        self._stop.set()
        with self._lock:
            if self._fh is None:
                return
            self._fh.flush()
            if self.fsync_policy != "never":
                try:
                    self._fsync_locked()
                except InjectedFsyncFault:
                    pass
            self._fh.close()
            self._fh = None
        if self._flusher is not None:
            self._flusher.join(timeout=2.0)
            self._flusher = None


# ------------------------------------------------------------------ scanning


class ScanStats:
    __slots__ = (
        "records",
        "bytes",
        "truncated_records",
        "truncated_bytes",
        "dropped_segments",
        "segments",
        "corrupt_reason",
    )

    def __init__(self) -> None:
        self.records = 0
        self.bytes = 0
        self.truncated_records = 0
        self.truncated_bytes = 0
        self.dropped_segments = 0
        self.segments = 0
        self.corrupt_reason: Optional[str] = None

    def as_dict(self) -> Dict[str, object]:
        return {
            "records": self.records,
            "bytes": self.bytes,
            "truncated_records": self.truncated_records,
            "truncated_bytes": self.truncated_bytes,
            "dropped_segments": self.dropped_segments,
            "segments": self.segments,
            "corrupt_reason": self.corrupt_reason,
        }


def read_frame(fh) -> Optional[Tuple[dict, bytes]]:
    """THE frame API (with :func:`encode_record`): read one record frame
    from a binary stream positioned at a frame boundary and return
    ``(meta, tail)``, or ``None`` at clean EOF.

    Raises :class:`DurabilityError` naming the corruption (torn header,
    torn payload, crc mismatch, …) — callers that can retry (the
    replication shipper reconnects and re-requests) handle it; the
    recovery scanner uses :func:`scan_wal`, which truncates instead.
    Works over any blocking binary stream — segment files and
    ``socket.makefile("rb")`` alike (``BufferedReader.read(n)`` returns
    exactly ``n`` bytes unless the stream ends).  Code outside
    ``durability/`` must come through here rather than unpacking
    ``KWALSEG1`` frames by hand."""
    hdr = fh.read(_FRAME.size)
    if not hdr:
        return None  # clean EOF
    if len(hdr) < _FRAME.size:
        raise DurabilityError("torn frame header")
    plen, crc = _FRAME.unpack(hdr)
    if plen > MAX_RECORD_BYTES:
        raise DurabilityError("implausible record length")
    payload = fh.read(plen)
    if len(payload) < plen:
        raise DurabilityError("torn record payload")
    if zlib.crc32(payload) != crc:
        raise DurabilityError("crc mismatch")
    if plen < _META_LEN.size:
        raise DurabilityError("short payload")
    (mlen,) = _META_LEN.unpack_from(payload)
    if _META_LEN.size + mlen > plen:
        raise DurabilityError("meta overruns payload")
    try:
        meta = json.loads(
            payload[_META_LEN.size : _META_LEN.size + mlen].decode("utf-8")
        )
    except (UnicodeDecodeError, json.JSONDecodeError):
        raise DurabilityError("undecodable meta")
    return meta, payload[_META_LEN.size + mlen :]


def _scan_segment(path: str) -> Tuple[List[Tuple[dict, bytes]], int, Optional[str]]:
    """Read one segment; returns ``(records, good_end_offset, corrupt_reason)``.
    ``corrupt_reason`` is None iff the file ended cleanly on a record
    boundary."""
    records: List[Tuple[dict, bytes]] = []
    with open(path, "rb") as fh:
        head = fh.read(len(SEG_MAGIC))
        if head != SEG_MAGIC:
            return records, 0, "bad segment magic"
        good = fh.tell()
        while True:
            try:
                rec = read_frame(fh)
            except DurabilityError as exc:
                return records, good, str(exc)
            if rec is None:
                return records, good, None  # clean EOF
            records.append(rec)
            good = fh.tell()


def scan_segment_file(
    path: str,
) -> Tuple[List[Tuple[dict, bytes]], int, Optional[str]]:
    """Public per-segment scan for replication: ``(records,
    good_end_offset, corrupt_reason)``.  Unlike :func:`scan_wal` this
    inspects exactly one file and never truncates — the follower decides
    whether a torn tail means "refetch the whole segment" (shipped files
    land atomically, so local tears are pre-crash debris)."""
    return _scan_segment(path)


def scan_wal(
    wal_dir: str, start_segment: int = 1, truncate: bool = True
) -> Tuple[List[Tuple[dict, bytes]], ScanStats]:
    """Replay scan: records from every segment >= ``start_segment``, in
    order, stopping at the first torn/corrupt record.  With ``truncate``
    the corrupt suffix is physically removed (file truncated at the last
    good offset, later segments deleted) so the writer can resume onto a
    clean log."""
    stats = ScanStats()
    out: List[Tuple[dict, bytes]] = []
    segs = [i for i in list_segments(wal_dir) if i >= start_segment]
    for pos, idx in enumerate(segs):
        path = segment_path(wal_dir, idx)
        size = os.path.getsize(path)
        records, good, reason = _scan_segment(path)
        out.extend(records)
        stats.records += len(records)
        stats.bytes += good
        stats.segments += 1
        if reason is not None:
            stats.corrupt_reason = f"segment {idx}: {reason}"
            # the bad record plus everything after it is unreplayable
            stats.truncated_records += 1
            stats.truncated_bytes += size - good
            later = segs[pos + 1 :]
            stats.dropped_segments = len(later)
            if truncate:
                # recovery truncates the torn tail IN PLACE by design: the
                # good prefix must keep its inode (the writer's segment
                # numbering references it) and truncate+fsync is atomic
                # enough for a shrink
                # kolint: ignore[KL701] in-place truncation of the torn WAL tail
                with open(path, "r+b") as fh:
                    fh.truncate(good)
                    fh.flush()
                    os.fsync(fh.fileno())
                for j in later:
                    stats.truncated_bytes += os.path.getsize(
                        segment_path(wal_dir, j)
                    )
                    os.unlink(segment_path(wal_dir, j))
                fsync_dir(wal_dir)
            break
    return out, stats


def iter_segment_records(path: str) -> Iterator[Tuple[dict, bytes]]:
    """Debug/inspection helper: records of one segment, stopping silently
    at the first corruption."""
    records, _good, _reason = _scan_segment(path)
    return iter(records)
