"""Copy of ``kolibrie_tpu/durability/manager.py`` for the PyTorch port:
the same data directory layout, so a directory written by either package
recovers in the other.  Recovered databases live on the manager's device
(``device=``; the CUDA card unless the caller passes another): replay goes
through ``store.add_batch`` / ``remove`` / ``clear`` on the host columns,
and the first query after recovery compacts the store and uploads its
device mirror.

DurabilityManager: WAL + atomic snapshot generations + startup recovery.

On-disk layout (``<data_dir>``)::

    wal/wal-00000001.log            segmented WAL (wal.py)
    snapshots/gen-00000003/
        manifest.json               generation metadata + per-file CRCs
        store-0.npz                 one SparqlDatabase.checkpoint per store
        sessions.json               RSP session CONFIGURATION + last blob

Invariants (the reference's docs/DURABILITY.md):

- A snapshot generation is published by an atomic directory rename: a
  crash mid-snapshot leaves a ``.tmp-gen-*`` directory that recovery
  ignores (and cleans), never a half generation.
- ``manifest.json.wal_start`` bounds replay: the WAL is rotated BEFORE
  store state is captured, so every mutation missing from the snapshot
  is in segment >= ``wal_start``.  A mutation that lands between the
  rotation and a store's capture appears in both — harmless, because
  store mutations are set-semantic and replay is idempotent
  (``_compact_incremental`` drops already-present inserts; absent
  deletes no-op; a newer session blob simply overwrites).
- Recovery loads the NEWEST generation whose manifest parses and whose
  files match their recorded CRCs, falling back to older generations,
  then replays the WAL from ``wal_start`` and truncates at the first
  torn or CRC-corrupt record (wal.scan_wal).
- The writer resumes on a FRESH segment after recovery — it never
  appends into a file that was truncated mid-scan.
"""

from __future__ import annotations

import base64
import io
import json
import os
import shutil
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from kolibrie_tpu_torch.backend import DeviceLike, resolve_device
from kolibrie_tpu_torch.core.dictionary import QUOTED_BIT, display_form
from kolibrie_tpu_torch.durability.fsio import (
    atomic_rename_dir,
    atomic_write_bytes,
    fsync_dir,
)
from kolibrie_tpu_torch.durability.wal import WalWriter, list_segments, scan_wal
from kolibrie_tpu_torch.obs import metrics as obs_metrics
from kolibrie_tpu_torch.resilience.errors import DurabilityError

_RECOVERY_DURATION = obs_metrics.gauge(
    "kolibrie_recovery_duration_seconds",
    "wall time of the last startup recovery (snapshot load + WAL replay)",
)
_RECOVERY_REPLAYED = obs_metrics.counter(
    "kolibrie_recovery_records_replayed_total",
    "WAL records replayed during recovery",
)
_RECOVERY_TRUNCATED = obs_metrics.counter(
    "kolibrie_recovery_records_truncated_total",
    "corrupt/torn WAL records truncated during recovery",
)
_SNAPSHOT_GEN = obs_metrics.gauge(
    "kolibrie_snapshot_generation", "latest committed snapshot generation"
)
_SNAPSHOTS = obs_metrics.counter(
    "kolibrie_snapshots_total", "snapshot generations committed"
)
_SNAPSHOT_LAT = obs_metrics.histogram(
    "kolibrie_snapshot_seconds", "snapshot capture+commit wall time"
)

_GEN_PREFIX = "gen-"
_GEN_TMP_PREFIX = ".tmp-gen-"


def _default_fsync_policy() -> str:
    return os.environ.get("KOLIBRIE_FSYNC", "group")


# --------------------------------------------------------------- attachment


class _StoreAttachment:
    """Bridges one SparqlDatabase's store journal into WAL records.

    Tracks dictionary / quoted-table high-water marks so each mutation
    record carries exactly the terms interned since the previous record
    — replay re-places them at the same ids (alignment-checked) before
    applying the column data.

    Term growth rides in the BINARY tail, not the JSON meta: a bulk load
    interns ~2 fresh terms per triple, and JSON-encoding thousands of
    strings per record is what pushed WAL overhead past the <15% ingest
    budget.  Ids are implicit (consecutive from ``ts``/``qs``), so the
    tail is just length-prefixed UTF-8 for terms and raw ``<u4`` s/p/o
    rows for quoted triples, both ahead of the column data."""

    __slots__ = ("manager", "store_id", "db", "terms_hw", "quoted_hw")

    def __init__(self, manager: "DurabilityManager", store_id: str, db):
        self.manager = manager
        self.store_id = store_id
        self.db = db
        self.terms_hw = len(db.dictionary.id_to_str)
        self.quoted_hw = len(db.quoted.triple_to_id)

    def _dict_growth(self, meta: dict) -> bytes:
        """→ tail prefix carrying the terms/quoted interned since the
        previous record; meta gains their start ids and counts.

        A bulk load interns ~2-3 fresh terms per triple, so this path
        must stay vectorized: the common case is one NUL-joined
        ``encode`` for the whole block (NUL cannot appear in an IRI and
        never does in lexical forms we intern).  When a term DOES
        contain NUL the join would be ambiguous, so those rare records
        fall back to a length-prefixed layout flagged ``tl``."""
        parts = []
        its = self.db.dictionary.id_to_str
        if len(its) > self.terms_hw:
            new = its[self.terms_hw :]
            meta["ts"] = self.terms_hw
            meta["tn"] = len(new)
            joined = "\x00".join(new)
            if joined.count("\x00") == len(new) - 1:
                blob = joined.encode("utf-8")
            else:
                meta["tl"] = 1
                encs = [s.encode("utf-8") for s in new]
                lens = np.fromiter(
                    (len(b) for b in encs), dtype="<u4", count=len(encs)
                )
                blob = lens.tobytes() + b"".join(encs)
            meta["tb"] = len(blob)
            parts.append(blob)
            self.terms_hw = len(its)
        q = self.db.quoted
        n = len(q.triple_to_id)
        if n > self.quoted_hw:
            meta["qs"] = self.quoted_hw
            meta["qn"] = n - self.quoted_hw
            arr = np.empty((n - self.quoted_hw, 3), dtype="<u4")
            for k, count in enumerate(range(self.quoted_hw, n)):
                arr[k] = q.id_to_triple[QUOTED_BIT | count]
            parts.append(arr.tobytes())
            self.quoted_hw = n
        return b"".join(parts)

    def __call__(self, event: str, payload) -> None:
        meta: dict = {"k": "mut", "st": self.store_id}
        growth = self._dict_growth(meta)
        if event == "add":
            arr = np.asarray(payload, dtype="<u4")
            meta["ev"] = "add"
            meta["n"] = int(arr.shape[0])
            tail = b"".join(
                (
                    growth,
                    arr[:, 0].tobytes(),
                    arr[:, 1].tobytes(),
                    arr[:, 2].tobytes(),
                )
            )
        elif event == "add1":
            s, p, o = payload
            meta["ev"] = "add"
            meta["n"] = 1
            tail = growth + np.asarray([s, p, o], dtype="<u4").tobytes()
        elif event == "del":
            meta["ev"] = "del"
            meta["dels"] = [list(payload)]
            tail = growth
        elif event == "clear":
            meta["ev"] = "clear"
            tail = growth
        else:  # pragma: no cover - future event kinds fail loudly
            raise DurabilityError(f"unknown journal event {event!r}")
        self.manager.wal.append(meta, tail)


# ------------------------------------------------------------------- replay


def _consume_growth(db, meta: dict, tail: bytes) -> int:
    """Replay the binary terms/quoted prefix of a mutation tail (see
    ``_StoreAttachment._dict_growth``); returns the offset where the
    column data starts.  A block whose ids overlap what a snapshot
    already made durable is skipped up to the overlap; a gap is a
    misalignment and fails the replay."""
    off = 0
    tn = int(meta.get("tn") or 0)
    if tn:
        ts = int(meta.get("ts") or 0)
        tb = int(meta.get("tb") or 0)
        if off + tb > len(tail):
            raise DurabilityError("mutation tail shorter than term block")
        blob = tail[off : off + tb]
        off += tb
        if meta.get("tl"):
            if tb < 4 * tn:
                raise DurabilityError("term block shorter than length table")
            lens = np.frombuffer(blob, dtype="<u4", count=tn)
            body = blob[4 * tn :]
            terms, p = [], 0
            for ln in lens.tolist():
                terms.append(body[p : p + ln].decode("utf-8"))
                p += ln
            if p != len(body):
                raise DurabilityError("term block length table mismatch")
        else:
            terms = blob.decode("utf-8").split("\x00")
        if len(terms) != tn:
            raise DurabilityError("term block count mismatch on replay")
        d = db.dictionary
        nxt = len(d.id_to_str)
        if ts > nxt:
            raise DurabilityError(
                f"dictionary misalignment on replay: block starts at {ts} "
                f"vs next {nxt}"
            )
        fresh = terms[nxt - ts :]  # overlap prefix already durable
        for s in fresh:
            tid = len(d.id_to_str)
            d.id_to_str.append(s)
            d.display.append(display_form(s))
            d.str_to_id[s] = tid
        if fresh:
            d._next_id = len(d.id_to_str)
    qn = int(meta.get("qn") or 0)
    if qn:
        qs = int(meta.get("qs") or 0)
        if off + 12 * qn > len(tail):
            raise DurabilityError("mutation tail shorter than quoted block")
        arr = np.frombuffer(tail, dtype="<u4", count=3 * qn, offset=off)
        arr = arr.reshape(qn, 3)
        off += 12 * qn
        q = db.quoted
        for k in range(qn):
            qid = QUOTED_BIT | (qs + k)
            if qid in q.id_to_triple:
                continue
            expect = QUOTED_BIT | len(q.triple_to_id)
            if qid != expect:
                raise DurabilityError(
                    f"quoted-table misalignment on replay: id {qid:#x} vs "
                    f"expected {expect:#x}"
                )
            key = (int(arr[k, 0]), int(arr[k, 1]), int(arr[k, 2]))
            q.triple_to_id[key] = qid
            q.id_to_triple[qid] = key
    return off


def _apply_mutation(db, meta: dict, tail: bytes) -> None:
    off = _consume_growth(db, meta, tail)
    ev = meta.get("ev")
    if ev == "add":
        n = int(meta["n"])
        if len(tail) - off < 12 * n:
            raise DurabilityError("mutation tail shorter than declared rows")
        cols = np.frombuffer(tail, dtype="<u4", count=3 * n, offset=off)
        db.store.add_batch(cols[:n], cols[n : 2 * n], cols[2 * n : 3 * n])
    elif ev == "del":
        for s, p, o in meta.get("dels") or []:
            db.store.remove(int(s), int(p), int(o))
    elif ev == "clear":
        db.store.clear()
    else:
        raise DurabilityError(f"unknown mutation event {ev!r} in WAL")


class RecoveryResult:
    """What came back from disk: recovered databases keyed by store id
    (execution modes in ``modes``), RSP session records keyed by session
    id (``{"register": cfg, "state": Optional[bytes]}``), and a stats
    dict for /stats + logs."""

    __slots__ = ("stores", "modes", "sessions", "stats")

    def __init__(self):
        self.stores: Dict[str, object] = {}
        self.modes: Dict[str, str] = {}
        self.sessions: Dict[str, dict] = {}
        self.stats: Dict[str, object] = {}


def replay_records(res: "RecoveryResult", records, device: DeviceLike = None) -> None:
    """Apply WAL records (``(meta, tail)`` pairs, in order) onto a
    :class:`RecoveryResult`.  Shared by crash recovery and the
    replication follower's shipped-segment apply path — the record-kind
    dispatch must never fork between the two.

    Replay is IDEMPOTENT: adds are set-semantic, deletes of absent rows
    no-op, and dictionary growth blocks skip the already-applied overlap
    — so overlapping or duplicated delivery of a segment is safe.  A
    store the records create lives on ``device`` (the CUDA card unless
    the caller passes another)."""
    from kolibrie_tpu_torch.query.sparql_database import SparqlDatabase

    for meta, tail in records:
        kind = meta.get("k")
        if kind == "mut":
            sid = str(meta.get("st"))
            db = res.stores.get(sid)
            if db is None:
                db = SparqlDatabase(device=device)
                db.execution_mode = res.modes.get(sid, "auto")
                res.stores[sid] = db
            _apply_mutation(db, meta, tail)
        elif kind == "store":
            sid = str(meta.get("st"))
            res.modes[sid] = meta.get("mode") or "auto"
            if sid in res.stores:
                res.stores[sid].execution_mode = res.modes[sid]
            else:
                db = SparqlDatabase(device=device)
                db.execution_mode = res.modes[sid]
                res.stores[sid] = db
        elif kind == "sess":
            res.sessions[str(meta.get("sid"))] = {
                "register": meta.get("cfg") or {},
                "state": None,
            }
        elif kind == "sck":
            rec = res.sessions.setdefault(
                str(meta.get("sid")), {"register": {}, "state": None}
            )
            rec["state"] = tail
        elif kind == "sdel":
            res.sessions.pop(str(meta.get("sid")), None)
        # unknown kinds are skipped: forward-compatible replay


# ------------------------------------------------------------------ manager


class DurabilityManager:
    """Owns one data directory: the WAL writer, snapshot generations, and
    the recovery routine.  Thread-safe for concurrent log_* calls (the
    WAL writer serializes); ``snapshot`` callers must prevent concurrent
    mutations per store (hold each store's dispatch lock during its
    capture)."""

    def __init__(
        self,
        data_dir: str,
        fsync_policy: Optional[str] = None,
        segment_bytes: int = 64 * 1024 * 1024,
        group_interval_s: float = 0.05,
        snapshot_wal_bytes: int = 256 * 1024 * 1024,
        device: DeviceLike = None,
    ):
        #: where recovered databases live: the CUDA card unless the caller
        #: passes another
        self.device = resolve_device(device)
        self.data_dir = data_dir
        self.wal_dir = os.path.join(data_dir, "wal")
        self.snap_dir = os.path.join(data_dir, "snapshots")
        os.makedirs(self.wal_dir, exist_ok=True)
        os.makedirs(self.snap_dir, exist_ok=True)
        self.fsync_policy = fsync_policy or _default_fsync_policy()
        self.segment_bytes = segment_bytes
        self.group_interval_s = group_interval_s
        self.snapshot_wal_bytes = snapshot_wal_bytes
        self.wal: Optional[WalWriter] = None  # created by recover()/start()
        self._attachments: Dict[str, _StoreAttachment] = {}
        self._snap_lock = threading.Lock()
        self.generation = self._latest_generation()
        self.last_recovery: Optional[dict] = None
        self._bytes_at_snapshot = 0
        # invoked as on_store_recovered(store_id, db) per store at the END
        # of recover(), after snapshot restore + WAL replay + compact —
        # the hook the serving layer uses to rebuild device-resident
        # state from recovered stores
        self.on_store_recovered = None

    # ------------------------------------------------------------ generations

    def _generations(self) -> List[int]:
        out = []
        for name in os.listdir(self.snap_dir):
            if name.startswith(_GEN_PREFIX):
                try:
                    out.append(int(name[len(_GEN_PREFIX) :]))
                except ValueError:
                    continue
        out.sort()
        return out

    def _latest_generation(self) -> int:
        gens = self._generations()
        return gens[-1] if gens else 0

    def _gen_path(self, gen: int) -> str:
        return os.path.join(self.snap_dir, f"{_GEN_PREFIX}{gen:08d}")

    def _load_generation(self, gen: int) -> Tuple[dict, Dict[str, object], Dict[str, dict]]:
        """Load one generation, CRC-verifying every file against the
        manifest.  Raises on any mismatch — the caller falls back."""
        from kolibrie_tpu_torch.query.sparql_database import SparqlDatabase

        root = self._gen_path(gen)
        with open(os.path.join(root, "manifest.json"), "rb") as fh:
            manifest = json.loads(fh.read().decode("utf-8"))
        stores: Dict[str, object] = {}
        for ent in manifest.get("stores") or []:
            path = os.path.join(root, ent["file"])
            with open(path, "rb") as fh:
                raw = fh.read()
            if zlib.crc32(raw) != int(ent["crc32"]):
                raise DurabilityError(
                    f"snapshot gen {gen}: {ent['file']} fails CRC"
                )
            db = SparqlDatabase.from_checkpoint(io.BytesIO(raw), device=self.device)
            db.execution_mode = ent.get("mode") or "auto"
            stores[str(ent["id"])] = db
        sessions: Dict[str, dict] = {}
        sess_path = os.path.join(root, "sessions.json")
        if os.path.exists(sess_path):
            with open(sess_path, "rb") as fh:
                raw = fh.read()
            if "sessions_crc32" in manifest and zlib.crc32(raw) != int(
                manifest["sessions_crc32"]
            ):
                raise DurabilityError(
                    f"snapshot gen {gen}: sessions.json fails CRC"
                )
            for sid, rec in json.loads(raw.decode("utf-8")).items():
                blob = rec.get("state")
                sessions[str(sid)] = {
                    "register": rec.get("register") or {},
                    "state": base64.b64decode(blob) if blob else None,
                }
        return manifest, stores, sessions

    def load_generation(
        self, gen: int
    ) -> Tuple[dict, Dict[str, object], Dict[str, dict]]:
        """Public CRC-verified generation load — the replication follower
        restores from a just-shipped generation through this."""
        return self._load_generation(gen)

    def generation_dir(self, gen: int) -> str:
        """Path of one generation's directory (ship source/target)."""
        return self._gen_path(gen)

    # -------------------------------------------------------------- recovery

    def recover(self) -> RecoveryResult:
        """Load the latest valid snapshot, replay the WAL, truncate the
        corrupt tail, and start the writer on a fresh segment.  Always
        returns (an empty directory recovers to an empty result)."""
        from kolibrie_tpu_torch.query.sparql_database import SparqlDatabase

        # re-attach the kernel compile cache BEFORE replay: the first
        # queries after recovery load the kernel libraries a previous
        # incarnation built under <data_dir>/compile_cache instead of
        # rebuilding them
        from kolibrie_tpu_torch.query import compile_cache

        compile_cache.enable(data_dir=self.data_dir)

        t0 = time.perf_counter()
        res = RecoveryResult()
        manifest = None
        used_gen = 0
        invalid_gens: List[int] = []
        for gen in reversed(self._generations()):
            try:
                manifest, res.stores, res.sessions = self._load_generation(gen)
                used_gen = gen
                break
            except Exception as e:
                invalid_gens.append(gen)
                res.stats[f"gen_{gen}_error"] = repr(e)
        # a crash mid-snapshot leaves .tmp-gen-* debris: never loadable,
        # always removable
        for name in os.listdir(self.snap_dir):
            if name.startswith(_GEN_TMP_PREFIX):
                shutil.rmtree(os.path.join(self.snap_dir, name), ignore_errors=True)
        wal_start = int(manifest.get("wal_start", 1)) if manifest else 1
        records, scan = scan_wal(self.wal_dir, start_segment=wal_start)
        replay_records(res, records, self.device)
        for sid, db in res.stores.items():
            db.store.compact()
            res.modes.setdefault(sid, db.execution_mode)
            if self.on_store_recovered is not None:
                # derived device state is NOT in the snapshot/WAL — it
                # rebuilds from the recovered host store here, before the
                # store starts serving
                self.on_store_recovered(sid, db)
        # resume appends on a FRESH segment — never into a truncated file
        segs = list_segments(self.wal_dir)
        next_seg = (segs[-1] + 1) if segs else max(wal_start, 1)
        self.wal = WalWriter(
            self.wal_dir,
            start_segment=next_seg,
            fsync_policy=self.fsync_policy,
            segment_bytes=self.segment_bytes,
            group_interval_s=self.group_interval_s,
        )
        duration = time.perf_counter() - t0
        self.generation = used_gen
        res.stats.update(
            {
                "duration_s": duration,
                "snapshot_generation": used_gen,
                "invalid_generations": invalid_gens,
                "wal_start": wal_start,
                "replayed_records": scan.records,
                "replayed_bytes": scan.bytes,
                "truncated_records": scan.truncated_records,
                "truncated_bytes": scan.truncated_bytes,
                "dropped_segments": scan.dropped_segments,
                "corrupt_reason": scan.corrupt_reason,
                "stores": sorted(res.stores),
                "sessions": sorted(res.sessions),
            }
        )
        self.last_recovery = dict(res.stats)
        _RECOVERY_DURATION.set(duration)
        _RECOVERY_REPLAYED.inc(scan.records)
        _RECOVERY_TRUNCATED.inc(scan.truncated_records)
        _SNAPSHOT_GEN.set(used_gen)
        return res

    def start(self) -> None:
        """Open the WAL writer without running recovery (fresh data dir,
        or a caller that already recovered by hand)."""
        if self.wal is None:
            segs = list_segments(self.wal_dir)
            self.wal = WalWriter(
                self.wal_dir,
                start_segment=(segs[-1] + 1) if segs else 1,
                fsync_policy=self.fsync_policy,
                segment_bytes=self.segment_bytes,
                group_interval_s=self.group_interval_s,
            )

    # ------------------------------------------------------------- journaling

    def _require_wal(self) -> WalWriter:
        if self.wal is None:
            self.start()
        return self.wal

    def attach(self, store_id: str, db, log_create: bool = True) -> None:
        """Journal every future mutation of ``db`` under ``store_id``.
        Attach BEFORE mutating (a fresh or just-recovered database):
        pre-existing rows are covered by the snapshot/WAL that produced
        them, not re-logged."""
        wal = self._require_wal()
        att = _StoreAttachment(self, store_id, db)
        self._attachments[store_id] = att
        db.store.journal = att
        if log_create:
            wal.append(
                {"k": "store", "st": store_id, "mode": db.execution_mode}
            )

    def detach(self, store_id: str) -> None:
        att = self._attachments.pop(store_id, None)
        if att is not None and att.db.store.journal is att:
            att.db.store.journal = None

    def log_session_register(self, session_id: str, config: dict) -> None:
        self._require_wal().append(
            {"k": "sess", "sid": str(session_id), "cfg": config or {}}
        )

    def log_session_checkpoint(self, session_id: str, blob: bytes) -> None:
        self._require_wal().append(
            {"k": "sck", "sid": str(session_id)}, bytes(blob)
        )

    def log_session_close(self, session_id: str) -> None:
        self._require_wal().append({"k": "sdel", "sid": str(session_id)})

    def flush(self) -> None:
        if self.wal is not None:
            self.wal.flush()

    # -------------------------------------------------------------- snapshot

    def should_snapshot(self) -> bool:
        """Has the WAL grown enough since the last snapshot to be worth
        folding?  (Advisory; the server checks after loads.)"""
        if self.wal is None:
            return False
        return (
            self.wal.appended_bytes - self._bytes_at_snapshot
            >= self.snapshot_wal_bytes
        )

    def snapshot(
        self,
        stores: Dict[str, object],
        sessions: Optional[Dict[str, dict]] = None,
        locks: Optional[Dict[str, object]] = None,
    ) -> int:
        """Commit a new generation and prune the WAL behind it.

        ``stores`` maps store id → SparqlDatabase; ``sessions`` maps
        session id → ``{"register": cfg, "state": Optional[bytes]}``;
        ``locks`` optionally maps store id → a lock held around that
        store's capture (per-store atomicity is all that is required —
        see the module docstring's idempotent-overlap argument)."""
        t0 = time.perf_counter()
        with self._snap_lock:
            wal = self._require_wal()
            wal.flush()
            wal_start = wal.rotate()
            gen = max(self.generation, self._latest_generation()) + 1
            tmp = os.path.join(self.snap_dir, f"{_GEN_TMP_PREFIX}{gen:08d}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            store_entries = []
            for i, (sid, db) in enumerate(sorted(stores.items())):
                lock = (locks or {}).get(sid)
                buf = io.BytesIO()
                if lock is not None:
                    with lock:
                        self._capture_store(db, buf)
                else:
                    self._capture_store(db, buf)
                raw = buf.getvalue()
                fname = f"store-{i}.npz"
                atomic_write_bytes(os.path.join(tmp, fname), raw)
                store_entries.append(
                    {
                        "id": sid,
                        "file": fname,
                        "crc32": zlib.crc32(raw),
                        "mode": db.execution_mode,
                        "triples": len(db.store),
                    }
                )
            sess_out = {}
            for sid, rec in (sessions or {}).items():
                blob = rec.get("state")
                sess_out[str(sid)] = {
                    "register": rec.get("register") or {},
                    "state": base64.b64encode(blob).decode("ascii")
                    if blob
                    else None,
                }
            sess_raw = json.dumps(sess_out, separators=(",", ":")).encode()
            atomic_write_bytes(os.path.join(tmp, "sessions.json"), sess_raw)
            manifest = {
                "generation": gen,
                "wal_start": wal_start,
                "stores": store_entries,
                "sessions_crc32": zlib.crc32(sess_raw),
                "created_unix": time.time(),
            }
            atomic_write_bytes(
                os.path.join(tmp, "manifest.json"),
                json.dumps(manifest, separators=(",", ":")).encode(),
            )
            atomic_rename_dir(tmp, self._gen_path(gen))
            self.generation = gen
            self._bytes_at_snapshot = wal.appended_bytes
            # prune: older generations and fully-snapshotted WAL segments
            for old in self._generations():
                if old < gen:
                    shutil.rmtree(self._gen_path(old), ignore_errors=True)
            for idx in list_segments(self.wal_dir):
                if idx < wal_start:
                    try:
                        os.unlink(os.path.join(self.wal_dir, f"wal-{idx:08d}.log"))
                    except OSError:
                        pass
            fsync_dir(self.wal_dir)
        _SNAPSHOTS.inc()
        _SNAPSHOT_GEN.set(gen)
        _SNAPSHOT_LAT.observe(time.perf_counter() - t0)
        return gen

    @staticmethod
    def _capture_store(db, buf: io.BytesIO) -> None:
        s, p, o = db.store.columns()
        db._checkpoint_to(buf, s, p, o, db.probability_seeds)

    def close(self) -> None:
        """Final flush + writer close (graceful shutdown tail)."""
        for sid in list(self._attachments):
            self.detach(sid)
        if self.wal is not None:
            self.wal.flush()
            self.wal.close()
            self.wal = None

    # ----------------------------------------------------------------- stats

    def stats(self) -> dict:
        out = {
            "data_dir": self.data_dir,
            "fsync_policy": self.fsync_policy,
            "generation": self.generation,
        }
        if self.wal is not None:
            out["wal"] = {
                "segment": self.wal.segment,
                "appended_records": self.wal.appended_records,
                "appended_bytes": self.wal.appended_bytes,
            }
        if self.last_recovery is not None:
            out["last_recovery"] = self.last_recovery
        return out
