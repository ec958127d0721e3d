"""Follower-side replication: :class:`ReplicationFollower`.

Port of ``kolibrie_tpu/replication/follower.py``: the follower's stores
live on ``device`` (the CUDA card unless the caller passes another), and
shipped segments replay through the port's
:func:`~kolibrie_tpu_torch.durability.manager.replay_records` into them.
The first query after a catch-up pays the store's compaction and the
device mirror's upload.

A follower owns its OWN durability directory, laid out identically to a
primary's (``wal/`` + ``snapshots/``), and keeps it a byte-faithful
mirror: snapshot generations and sealed WAL segments arrive whole,
CRC-verified, and land via the atomic temp-write → rename discipline
(:mod:`durability.fsio`).  That symmetry is the whole failover story —
a promoted follower's data dir IS a valid primary data dir, and a later
crash-recovery on it replays exactly like any other.

Lifecycle:

1. **bootstrap** — clean local debris (``.tmp-gen-*`` leftovers, torn
   tail segments: both are pre-crash junk, never replayed), fetch the
   primary's newest snapshot generation if it is ahead of ours, load it,
   then replay whatever locally-shipped segments continue it.
2. **poll loop** — ask the primary to seal + list new segments, fetch
   each in order, store durably, replay into the live stores under the
   serving layer's per-store dispatch locks.  Duplicated deliveries are
   skipped by the applied-segment watermark (and replay itself is
   idempotent — :func:`durability.manager.replay_records`); torn and
   dropped deliveries surface as :class:`ProtocolError`/timeouts and are
   simply re-requested, which is safe because sealed segments are
   immutable.
3. **promote** — stop polling, discard any local segment past the
   applied watermark (valid bytes that were never applied must not
   resurface as acknowledged state), open a fresh WAL segment, attach
   the stores.  From that point the node journals like any primary.

Staleness is bounded by ``poll_interval_s`` + the primary's seal
interval; the watermark (applied segment + per-store
``(base_version, delta_epoch)``) is exported for ``/healthz``, the
router's promotion decision, and read-your-writes tokens.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Callable, Dict, Optional

from kolibrie_tpu_torch.backend import DeviceLike

from kolibrie_tpu_torch.durability.fsio import atomic_rename_dir, atomic_write_bytes
from kolibrie_tpu_torch.durability.manager import (
    DurabilityManager,
    RecoveryResult,
    replay_records,
)
from kolibrie_tpu_torch.durability.wal import (
    WalWriter,
    list_segments,
    scan_segment_file,
    segment_path,
)
from kolibrie_tpu_torch.obs import log as obslog
from kolibrie_tpu_torch.obs import metrics as obs_metrics
from kolibrie_tpu_torch.obs import spans as obs_spans
from kolibrie_tpu_torch.replication.protocol import (
    ProtocolError,
    ShipClient,
    file_crc,
)

_GEN_PREFIX = "gen-"
_GEN_TMP_PREFIX = ".tmp-gen-"

_SEGS_APPLIED = obs_metrics.counter(
    "kolibrie_repl_segments_applied_total", "shipped segments applied"
)
_RECORDS_APPLIED = obs_metrics.counter(
    "kolibrie_repl_records_applied_total", "WAL records replayed from ship"
)
_POLL_ERRORS = obs_metrics.counter(
    "kolibrie_repl_poll_errors_total",
    "poll-loop failures (timeouts, tears, desyncs) — each one reconnects",
)
_BOOTSTRAPS = obs_metrics.counter(
    "kolibrie_repl_bootstraps_total", "snapshot bootstraps (initial + re-)"
)
_LAG_SEGMENTS = obs_metrics.gauge(
    "kolibrie_repl_lag_segments",
    "sealed segments the follower has not applied yet",
)
_LAG_RECORDS = obs_metrics.gauge(
    "kolibrie_repl_lag_records",
    "primary-appended WAL records not yet applied here "
    "(same-epoch estimate, re-baselined at bootstrap)",
)
_APPLIED_SEGMENT = obs_metrics.gauge(
    "kolibrie_repl_applied_segment", "highest fully-applied segment index"
)
_APPLIED_RECORDS = obs_metrics.gauge(
    "kolibrie_repl_applied_records",
    "WAL records applied since the last bootstrap (watermark component)",
)
_APPLY_SECONDS = obs_metrics.histogram(
    "kolibrie_repl_apply_seconds",
    "per-segment replay (scan-to-applied) wall time",
)

_log = obslog.get_logger("replication.follower")


class ReplicationFollower:
    """Pulls a primary's durability state into ``data_dir`` and keeps
    live stores in sync.

    ``on_store_update(sid, db, created)`` is called (outside any lock)
    whenever a store object appears or is replaced — the serving layer
    registers/replaces its batcher there.  ``lock_for(sid)`` returns the
    lock to hold while records mutate that store (the batcher's dispatch
    lock), or None before the store is being served.
    """

    def __init__(
        self,
        data_dir: str,
        source_host: str,
        source_port: int,
        poll_interval_s: float = 0.15,
        timeout_s: float = 5.0,
        on_store_update: Optional[Callable] = None,
        lock_for: Optional[Callable] = None,
        device: DeviceLike = None,
    ):
        self.data_dir = data_dir
        self.source_host = source_host
        self.source_port = source_port
        self.poll_interval_s = poll_interval_s
        self.on_store_update = on_store_update or (lambda sid, db, created: None)
        self.lock_for = lock_for or (lambda sid: None)
        # a never-started manager: supplies paths, generation loading,
        # and (after promotion) the WAL writer + attachments
        self.manager = DurabilityManager(data_dir, device=device)
        self.client = ShipClient(source_host, source_port, timeout_s=timeout_s)
        self.res = RecoveryResult()
        self.applied_segment = 0  # guarded by: _lock
        self.applied_records = 0  # guarded by: _lock
        # last seen (active_segment, offset)
        self.primary_pos = (0, 0)  # guarded by: _lock
        # primary's process-lifetime append count, and its value at our
        # last bootstrap: the difference minus our own applies is the
        # lag-in-records SLO estimate (clamped — the counters live in
        # different processes and reset on different events)
        self.primary_records = 0  # guarded by: _lock
        self.records_baseline = 0  # guarded by: _lock
        self.last_applied_unix = 0.0  # guarded by: _lock
        self.bootstrapped = False
        self.promoted = False
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats_counters = {  # guarded by: _lock (rw)
            "polls": 0,
            "poll_errors": 0,
            "segments_applied": 0,
            "bootstraps": 0,
            "duplicate_segments_skipped": 0,
        }

    # ----------------------------------------------------------- local fs

    def _clean_local_debris(self) -> Dict[str, int]:
        """Remove what a crashed follower leaves behind: ``.tmp-gen-*``
        snapshot debris and torn-tail WAL segments.  Shipped segments
        land atomically, so ANY invalid local segment is pre-crash junk
        — deleted whole and re-fetched, never truncated-and-replayed."""
        removed = {"tmp_gens": 0, "bad_segments": 0}
        snap_dir = self.manager.snap_dir
        for name in os.listdir(snap_dir):
            if name.startswith(_GEN_TMP_PREFIX):
                shutil.rmtree(os.path.join(snap_dir, name), ignore_errors=True)
                removed["tmp_gens"] += 1
        for idx in list_segments(self.manager.wal_dir):
            path = segment_path(self.manager.wal_dir, idx)
            _records, _good, reason = scan_segment_file(path)
            if reason is not None:
                os.unlink(path)
                removed["bad_segments"] += 1
        return removed

    def _fetch_generation(self, gen: int, files) -> None:
        """Ship one snapshot generation into a ``.tmp-gen-*`` staging dir
        and publish it atomically — a crash mid-fetch leaves only debris
        that the next bootstrap cleans."""
        snap_dir = self.manager.snap_dir
        tmp = os.path.join(snap_dir, f"{_GEN_TMP_PREFIX}{gen:08d}")
        final = os.path.join(snap_dir, f"{_GEN_PREFIX}{gen:08d}")
        if os.path.isdir(final):
            return
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for ent in files:
            name = ent["name"]
            meta, data = self.client.request(
                {"t": "file", "gen": gen, "name": name}
            )
            if meta.get("crc") != file_crc(data):
                raise ProtocolError(f"snapshot file {name} fails ship CRC")
            atomic_write_bytes(os.path.join(tmp, name), data)
        atomic_rename_dir(tmp, final)

    def _store_segment(self, idx: int, data: bytes) -> None:
        atomic_write_bytes(segment_path(self.manager.wal_dir, idx), data)

    # ------------------------------------------------------------ replay

    def _apply_records(self, records) -> None:
        """Replay records into the live result set, serialized against
        the serving layer per store.  Records are grouped into runs per
        store so a bulk segment doesn't take/drop a dispatch lock per
        record."""
        i, n = 0, len(records)
        while i < n:
            meta, _tail = records[i]
            sid = str(meta.get("st")) if meta.get("k") in ("mut", "store") else None
            j = i + 1
            while j < n:
                m2 = records[j][0]
                s2 = str(m2.get("st")) if m2.get("k") in ("mut", "store") else None
                if s2 != sid:
                    break
                j += 1
            run = records[i:j]
            known = sid is not None and sid in self.res.stores
            lock = self.lock_for(sid) if known else None
            if lock is not None:
                with lock:
                    replay_records(self.res, run, device=self.manager.device)
            else:
                replay_records(self.res, run, device=self.manager.device)
            if sid is not None:
                db = self.res.stores.get(sid)
                if db is not None:
                    self.on_store_update(sid, db, created=not known)
            i = j
        with self._lock:
            self.applied_records += len(records)
            total = self.applied_records
        _RECORDS_APPLIED.inc(len(records))
        _APPLIED_RECORDS.set(total)

    def _advance_from_local(self) -> None:
        """Replay locally-present segments that directly continue the
        applied watermark.  Valid-but-non-contiguous files stay on disk
        and apply once the gap fills."""
        while True:
            with self._lock:
                nxt = self.applied_segment + 1
            path = segment_path(self.manager.wal_dir, nxt)
            if not os.path.exists(path):
                return
            t0 = time.perf_counter()
            with obs_spans.span(
                "repl.apply_segment", segment=nxt, node=obslog.node()
            ) as sp:
                records, _good, reason = scan_segment_file(path)
                if reason is not None:
                    os.unlink(path)  # torn local copy: refetch whole
                    return
                if sp is not None:
                    sp.attrs["records"] = len(records)
                self._apply_records(records)
            _APPLY_SECONDS.observe(time.perf_counter() - t0)
            with self._lock:
                self.applied_segment = nxt
                self.last_applied_unix = time.time()
                self.stats_counters["segments_applied"] += 1
            _SEGS_APPLIED.inc()
            _APPLIED_SEGMENT.set(nxt)

    # --------------------------------------------------------- bootstrap

    def bootstrap(self) -> dict:
        """Initial (or re-) bootstrap from the primary's newest valid
        snapshot generation."""
        removed = self._clean_local_debris()
        manifest, _tail = self.client.request({"t": "manifest"})
        gen = int(manifest.get("gen", 0))
        wal_start = int(manifest.get("wal_start", 1))
        if gen > 0:
            self._fetch_generation(gen, manifest.get("files") or [])
            _gen_manifest, stores, sessions = self.manager.load_generation(gen)
            res = RecoveryResult()
            res.stores = stores
            res.sessions = sessions
            for sid, db in stores.items():
                res.modes[sid] = db.execution_mode
            wal_start = int(_gen_manifest.get("wal_start", wal_start))
        else:
            res = RecoveryResult()
        old = set(self.res.stores)
        # kolint: ignore[KL312] bootstrap publishes a fully-built RecoveryResult by one atomic rebind; replay is idempotent and concurrent readers tolerate either generation
        self.res = res
        self.manager.generation = max(self.manager.generation, gen)
        # segments below the generation's replay horizon are dead weight
        for idx in list_segments(self.manager.wal_dir):
            if idx < wal_start:
                os.unlink(segment_path(self.manager.wal_dir, idx))
        with self._lock:
            self.applied_segment = wal_start - 1
            self.applied_records = 0
            pos = manifest.get("pos") or [0, 0]
            self.primary_pos = (int(pos[0]), int(pos[1]))
            self.primary_records = int(manifest.get("records", 0))
            self.records_baseline = self.primary_records
        for sid, db in res.stores.items():
            self.on_store_update(sid, db, created=sid not in old)
        self._advance_from_local()
        with self._lock:
            self.bootstrapped = True
            self.stats_counters["bootstraps"] += 1
        _BOOTSTRAPS.inc()
        _log.info(
            "bootstrap complete",
            generation=gen,
            wal_start=wal_start,
            source=f"{self.source_host}:{self.source_port}",
            **removed,
        )
        return {"generation": gen, "wal_start": wal_start, **removed}

    # --------------------------------------------------------- poll loop

    def _fetch_segment(self, idx: int) -> bool:
        """Fetch + durably store + apply one sealed segment; False when
        the primary pruned it (snapshot passed us — re-bootstrap)."""
        meta, data = self.client.request({"t": "seg", "seg": idx})
        if meta.get("t") == "gone":
            return False
        if meta.get("crc") != file_crc(data):
            raise ProtocolError(f"segment {idx} fails ship CRC")
        self._store_segment(idx, data)
        self._advance_from_local()
        return True

    def poll_once(self) -> None:
        """One poll round: seal + list on the primary, then fetch/apply
        everything past our watermark in order."""
        with self._lock:
            after = self.applied_segment
        meta, _tail = self.client.request({"t": "poll", "after": after})
        pos = meta.get("pos") or [0, 0]
        with self._lock:
            self.primary_pos = (int(pos[0]), int(pos[1]))
            self.primary_records = int(meta.get("records", 0))
            self.stats_counters["polls"] += 1
        for idx in sorted(int(i) for i in meta.get("sealed") or ()):
            with self._lock:
                applied = self.applied_segment
            if idx <= applied:
                # duplicated delivery (injected or raced): watermark says
                # it is already applied — skip, don't re-replay
                with self._lock:
                    self.stats_counters["duplicate_segments_skipped"] += 1
                continue
            if idx != applied + 1 or not self._fetch_segment(idx):
                # gap (pruned by a snapshot) — start over from the
                # primary's current generation
                self.bootstrap()
                break
        _LAG_SEGMENTS.set(self.lag_segments())
        _LAG_RECORDS.set(self.lag_records())

    def _poll_loop(self) -> None:
        backoff = self.poll_interval_s
        while not self._stop.is_set():
            try:
                # each poll round is a root activity on this node: mint a
                # fresh trace so apply spans group per-round in the ring
                with obs_spans.trace_scope(None):
                    with self._lock:
                        booted = self.bootstrapped
                    if not booted:
                        self.bootstrap()
                    self.poll_once()
                backoff = self.poll_interval_s
            except (ProtocolError, OSError):
                with self._lock:
                    self.stats_counters["poll_errors"] += 1
                _POLL_ERRORS.inc()
                self.client.close()
                backoff = min(backoff * 2.0, 2.0)
            self._stop.wait(backoff)

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._poll_loop, name="repl-follower", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self.client.close()

    # -------------------------------------------------------- promotion

    def promote(self) -> dict:
        """Become the primary: stop replicating, drop local segments past
        the applied watermark (never acknowledge bytes that were never
        applied), open a fresh WAL segment, attach the stores so new
        writes journal.  Returns the promotion watermark."""
        self.stop()
        with self._lock:
            applied = self.applied_segment
        for idx in list_segments(self.manager.wal_dir):
            if idx > applied:
                os.unlink(segment_path(self.manager.wal_dir, idx))
        self.manager.wal = WalWriter(
            self.manager.wal_dir,
            start_segment=applied + 1,
            fsync_policy=self.manager.fsync_policy,
            segment_bytes=self.manager.segment_bytes,
            group_interval_s=self.manager.group_interval_s,
        )
        for sid, db in self.res.stores.items():
            self.manager.attach(sid, db, log_create=False)
        self.promoted = True
        wm = self.watermark()
        _log.info(
            "promoted to primary",
            applied_segment=wm["applied_segment"],
            applied_records=wm["applied_records"],
        )
        return wm

    # ------------------------------------------------------------- state

    def lag_segments(self) -> int:
        with self._lock:
            active = self.primary_pos[0]
            # the newest sealed segment is active-1; clamp for a fresh
            # primary that has sealed nothing yet
            return max(0, (active - 1) - self.applied_segment)

    def lag_records(self) -> int:
        """Records the primary appended (in this epoch) that we have not
        applied.  An estimate: both counters are process-local, so the
        clamp absorbs restarts and snapshot re-baselines."""
        with self._lock:
            behind = (
                self.primary_records
                - self.records_baseline
                - self.applied_records
            )
            return max(0, behind)

    def refresh_gauges(self) -> None:
        """Pull the watermark/lag state into the SLO gauges — called by
        the exporter at scrape time so ``/metrics`` stays truthful even
        when the poll loop is wedged (exactly when lag matters)."""
        _LAG_SEGMENTS.set(self.lag_segments())
        _LAG_RECORDS.set(self.lag_records())
        with self._lock:
            _APPLIED_SEGMENT.set(self.applied_segment)
            _APPLIED_RECORDS.set(self.applied_records)

    def watermark(self) -> dict:
        with self._lock:
            wm = {
                "applied_segment": self.applied_segment,
                "applied_records": self.applied_records,
                "primary_position": list(self.primary_pos),
                "last_applied_unix": self.last_applied_unix,
            }
        wm["stores"] = {
            sid: list(db.store.version_key())
            for sid, db in self.res.stores.items()
        }
        return wm

    def stats(self) -> dict:
        lag_seg = self.lag_segments()
        lag_rec = self.lag_records()
        with self._lock:
            out = {
                "role": "primary" if self.promoted else "follower",
                "source": f"{self.source_host}:{self.source_port}",
                "bootstrapped": self.bootstrapped,
                "lag_segments": lag_seg,
                "lag_records": lag_rec,
                **self.stats_counters,
            }
        out["watermark"] = self.watermark()
        return out


# Debug-build runtime check of the # guarded by: annotations above
# (no-op unless KOLIBRIE_DEBUG_LOCKS=1 — see analysis/lockcheck.py)
from kolibrie_tpu_torch.analysis import lockcheck as _lockcheck

_lockcheck.auto_instrument(globals())
