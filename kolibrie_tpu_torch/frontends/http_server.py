"""HTTP frontend: /query, /rsp-query, /rsp/register, /rsp/push, SSE events.

Port of ``kolibrie_tpu/frontends/http_server.py``.  The server serves on an
explicit device: every database, RSP engine and follower store it builds
lives on ``make_server(device=...)`` — the CUDA card unless the caller
passes another (no card and no device: it raises).  ``/debug/profile``
captures with ``torch.profiler``.  ``KOLIBRIE_SHARDED`` (or an explicit
``make_server(mesh=...)``) attaches the mesh serving layer to every
persistent store (``parallel/sharded_serving.py``).

Parity: ``kolibrie-http-server/src/main.rs`` — routes (:593-624), request/
response JSON shapes (:55-158), results table with first-seen header order
(:189-213), persistent RSP sessions in a locked map with a monotone counter
(:32-40, :743-756), SSE result streaming (:306-307, :828-878), 64MB request
cap (:42-44), CORS headers, and the playground served at ``/``.

Rebuild notes: built on stdlib ``ThreadingHTTPServer`` (one thread per
connection, like the reference's thread-per-conn TCP loop); sessions hold an
``RSPEngine`` plus per-subscriber SSE queues.
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from kolibrie_tpu_torch.backend import DeviceLike, resolve_device
from kolibrie_tpu_torch.frontends.rules import (
    apply_n3_logic,
    apply_sparql_rules,
    strip_hash_comments,
)
from kolibrie_tpu_torch.obs import export as obs_export
from kolibrie_tpu_torch.obs import flightrec
from kolibrie_tpu_torch.obs import log as obslog
from kolibrie_tpu_torch.obs import metrics as obs_metrics
from kolibrie_tpu_torch.obs.spans import (
    current_trace_id,
    export_jsonl,
    span,
    trace_scope,
)
from kolibrie_tpu_torch.resilience.admission import AdmissionController
from kolibrie_tpu_torch.resilience.deadline import (
    Deadline,
    check_deadline,
    current_deadline,
    deadline_scope,
)
from kolibrie_tpu_torch.resilience.errors import (
    BadRequest,
    DeadlineExceeded,
    KolibrieError,
    NotFound,
    NotPrimary,
    Overloaded,
    QueryError,
    RequestTooLarge,
    Unavailable,
    WindowCrash,
    error_response,
)

MAX_REQUEST_BYTES = 64 * 1024 * 1024  # main.rs:42-44
SSE_KEEPALIVE_SECONDS = 15.0

# Resilience knobs (docs/RESILIENCE.md).  deadline <= 0 disables deadlines.
DEFAULT_DEADLINE_MS = float(os.environ.get("KOLIBRIE_DEADLINE_MS", "30000"))
MAX_INFLIGHT = int(os.environ.get("KOLIBRIE_MAX_INFLIGHT", "64"))
MAX_QUEUE_DEPTH = int(os.environ.get("KOLIBRIE_MAX_QUEUE_DEPTH", "256"))
SSE_SUBSCRIBER_QUEUE_MAX = int(
    os.environ.get("KOLIBRIE_SSE_QUEUE_MAX", "1024")
)


# Opt-in mesh serving: persistent stores attach a ShardedDatabase so
# batched same-template groups run as one mesh dispatch.  Without an
# explicit mesh it needs two or more cards; otherwise the store stays
# single-device (the degraded path).
SHARDED_SERVING = os.environ.get("KOLIBRIE_SHARDED", "").strip().lower() not in (
    "", "0", "off", "false",
)

# ------------------------------------------------------- serving metrics
# (docs/OBSERVABILITY.md has the full catalog)

_HTTP_REQS = obs_metrics.counter(
    "kolibrie_http_requests_total",
    "HTTP responses by route and status code",
    labels=("route", "code"),
)
_HTTP_LAT = obs_metrics.histogram(
    "kolibrie_http_request_seconds",
    "request wall time by route",
    labels=("route",),
)
_BATCH_REQS = obs_metrics.counter(
    "kolibrie_batcher_requests_total", "queries submitted to a batcher"
)
_BATCH_DISPATCHES = obs_metrics.counter(
    "kolibrie_batcher_dispatches_total", "batch dispatches drained"
)
_BATCH_DEDUP = obs_metrics.counter(
    "kolibrie_batcher_dedup_hits_total",
    "in-flight identical-text queries answered by one execution",
)
_BATCH_SHED = obs_metrics.counter(
    "kolibrie_batcher_shed_total",
    "requests shed by the batcher",
    labels=("reason",),
)
_BATCH_SIZE = obs_metrics.histogram(
    "kolibrie_batcher_batch_size",
    "requests riding one dispatch",
    buckets=obs_metrics.DEFAULT_COUNT_BUCKETS,
)
_BATCH_QUEUE_AT_DISPATCH = obs_metrics.histogram(
    "kolibrie_batcher_queue_depth_at_dispatch",
    "pending-queue depth observed at the moment a leader drained it "
    "(distinct from the scrape-time kolibrie_batcher_queue_depth gauge: "
    "this one is sampled exactly when dispatch decisions are made, so "
    "its distribution shows what the MQO sharing layer actually sees)",
    buckets=obs_metrics.DEFAULT_COUNT_BUCKETS,
)
_BATCH_DISTINCT_TEMPLATES = obs_metrics.histogram(
    "kolibrie_batcher_distinct_templates_per_dispatch",
    "distinct template fingerprints riding one dispatch — values >= 2 "
    "are the mixed-template groups eligible for shared-prefix "
    "evaluation (docs/MQO.md)",
    buckets=obs_metrics.DEFAULT_COUNT_BUCKETS,
)
_BATCH_FALLBACKS = obs_metrics.counter(
    "kolibrie_batcher_fallback_total",
    "batched dispatches that failed and fell back to solo retries",
)
_SESSION_CKPT_FAILURES = obs_metrics.counter(
    "kolibrie_session_checkpoint_failures_total",
    "RSP session checkpoint/restore attempts that failed",
    labels=("op",),
)
_DURABILITY_ERRORS = obs_metrics.counter(
    "kolibrie_durability_errors_total",
    "background durability operations that failed (non-fatal: the WAL "
    "still covers the data; watch this climbing)",
    labels=("op",),
)
_BATCH_DISPATCH_LAT = obs_metrics.histogram(
    "kolibrie_batcher_dispatch_seconds",
    "batch dispatch wall time by template fingerprint",
    labels=("template",),
)
_SHARDED_ATTACH_ERRORS = obs_metrics.counter(
    "kolibrie_shard_attach_errors_total",
    "sharded-serving attach/refresh attempts that failed (store keeps "
    "serving single-device — the degraded path)",
)
_READS_SHED_CATCHING_UP = obs_metrics.counter(
    "kolibrie_reads_shed_catching_up_total",
    "reads refused because this follower was behind the client's "
    "read-your-writes watermark (the router retries the next replica) — "
    "a replication-SLO burn counter",
)
_PROMOTE_FINALIZE_SECONDS = obs_metrics.histogram(
    "kolibrie_promote_finalize_seconds",
    "follower-side promotion finalize (stop poll, truncate, reattach, "
    "rebuild sessions) wall time — the node-local share of failover",
)

_log = obslog.get_logger("http_server")


class BurstHTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a listen backlog for a burst of
    concurrent clients: past socketserver's default of 5 pending
    connections, a loaded host resets the rest."""

    request_queue_size = 128

_PLAYGROUND_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "web",
    "playground.html",
)


def results_to_table(results: List[Tuple[Tuple[str, str], ...]]) -> List[List[str]]:
    """Binding rows → [header, row, row...] with first-seen var order
    (main.rs:189-213)."""
    if not results:
        return []
    headers: List[str] = []
    for row in results:
        for key, _ in row:
            if key not in headers:
                headers.append(key)
    table = [list(headers)]
    for row in results:
        m = dict(row)
        table.append([m.get(h, "") for h in headers])
    return table


def _parsed_term_to_str(term) -> str:
    """ParsedTerm → text form an RSP WindowTriple carries (<< >> for quoted)."""
    if isinstance(term, tuple):
        _, s, p, o = term
        return (
            f"<< {_parsed_term_to_str(s)} {_parsed_term_to_str(p)} "
            f"{_parsed_term_to_str(o)} >>"
        )
    return term


def _maybe_attach_sharded(db, mesh=None) -> None:
    """Attach (or refresh) the mesh serving layer for one store when
    KOLIBRIE_SHARDED is on or the server was given a ``mesh``.  Never
    fails the surrounding request: a one-device runtime, or an
    attach/refresh fault, leaves the store serving on the single-device
    path (that IS the degraded mode)."""
    if not SHARDED_SERVING and mesh is None:
        return
    try:
        from kolibrie_tpu_torch.parallel.sharded_serving import attach_sharded

        sh = attach_sharded(db, mesh)
        if sh is not None:
            sh.refresh()
    except Exception:
        _SHARDED_ATTACH_ERRORS.inc()


def _load_rdf_into(db, data: str, fmt: str) -> int:
    data = data or ""
    if not data.strip():
        return 0
    if fmt in ("ntriples", "turtle"):
        data = strip_hash_comments(data)
    if fmt == "ntriples":
        return db.parse_ntriples(data)
    if fmt == "turtle":
        return db.parse_turtle(data)
    if fmt == "n3":
        return db.parse_n3(data)
    return db.parse_rdf(data)


class EngineSession:
    """One persistent RSP session: engine + result log + SSE subscribers."""

    def __init__(self, engine, streams: List[str]):
        self.engine = engine
        self.streams = streams
        self.results: List[List[List[str]]] = []  # guarded by: lock
        self.subscribers: List["queue.Queue[str]"] = []  # guarded by: lock
        self.lock = threading.Lock()
        # serializes engine mutation: the RSP engine's single-thread drain
        # path is not safe under concurrent /rsp/push handler threads
        self.push_lock = threading.Lock()
        self.dropped_subscribers = 0  # guarded by: lock
        self.crash_recoveries = 0  # guarded by: push_lock
        self.last_checkpoint: Optional[bytes] = None  # guarded by: push_lock
        # set by startup recovery: this session was rebuilt from its
        # logged CONFIGURATION + last durable checkpoint after a crash
        self.recovered = False

    def emit(self, row: Tuple[Tuple[str, str], ...]) -> None:
        table = results_to_table([row])
        payload = json.dumps({"results": table})
        with self.lock:
            self.results.append(table)
            dead = []
            for q in self.subscribers:
                try:
                    q.put_nowait(payload)
                except queue.Full:
                    # subscriber stopped draining — a broken pipe whose
                    # handler thread already died, or a stalled client.
                    # Prune it here; un-pruned it would pin its queue (and
                    # every future payload) forever.
                    dead.append(q)
            for q in dead:
                self.subscribers.remove(q)
                self.dropped_subscribers += 1

    def subscribe_with_backlog(self) -> Tuple["queue.Queue[str]", List[str]]:
        """Atomically add a subscriber and snapshot prior results — a row
        emitted between the two would otherwise be delivered twice."""
        q: "queue.Queue[str]" = queue.Queue(maxsize=SSE_SUBSCRIBER_QUEUE_MAX)
        with self.lock:
            self.subscribers.append(q)
            backlog = [json.dumps({"results": t}) for t in self.results]
        return q, backlog

    def unsubscribe(self, q) -> None:
        with self.lock:
            if q in self.subscribers:
                self.subscribers.remove(q)

    # --------------------------------------------------- crash recovery

    def maybe_checkpoint(self) -> None:
        """Snapshot engine state after a successful push (caller holds
        ``push_lock``).  Failures are non-fatal: a stale checkpoint only
        widens the at-least-once replay window on the next recovery."""
        try:
            self.last_checkpoint = self.engine.checkpoint_state()
        except Exception:
            # non-fatal, but never silent: an operator watching this
            # counter climb knows recovery will replay a widening window
            _SESSION_CKPT_FAILURES.labels("checkpoint").inc()

    def recover(self) -> bool:
        """Restore the engine from the last good checkpoint after a
        WindowCrash (caller holds ``push_lock``).  Returns whether the
        session is serving again."""
        if self.last_checkpoint is None:
            return False
        try:
            self.engine.restore_state(self.last_checkpoint)
        except Exception:
            _SESSION_CKPT_FAILURES.labels("restore").inc()
            return False
        self.crash_recoveries += 1
        return True


class _BatchRequest:
    __slots__ = ("text", "done", "result", "error", "deadline", "trace_id")

    def __init__(
        self,
        text: str,
        deadline: Optional[Deadline] = None,
        trace_id: Optional[str] = None,
    ):
        self.text = text
        self.done = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None
        # captured at submit time: the leader dispatches on ANOTHER
        # thread, where the submitter's thread-local scope is invisible
        self.deadline = deadline
        self.trace_id = trace_id


class TemplateBatcher:
    """Serving-side micro-batcher over one persistent store.

    Handler threads call :meth:`submit`; requests that land within the
    batching window ride one dispatch.  Inside a dispatch, identical
    query texts are deduplicated (one execution, shared result) and
    same-template queries are stacked into a single vmap program by
    ``execute_queries_batched`` — under load, N constant-variants of one
    query shape cost one device call, not N.

    The first waiter whose window expires claims ``dispatch_lock`` and
    drains the whole pending list (leader election); followers just wait
    on their request event.  All database access — dispatch, loads,
    stats — serializes on ``dispatch_lock``, so the engine itself never
    sees concurrency."""

    def __init__(
        self, db, window_ms: float = 5.0, max_queue_depth: int = MAX_QUEUE_DEPTH
    ):
        self.db = db
        self.window = window_ms / 1000.0
        self.max_queue_depth = max_queue_depth
        self.lock = threading.Lock()  # guards pending + counters
        self.dispatch_lock = threading.Lock()  # serializes db access
        self.pending: List[_BatchRequest] = []  # guarded by: lock
        self.requests = 0  # guarded by: lock
        self.dispatches = 0  # guarded by: lock
        self.dedup_hits = 0  # guarded by: lock
        self.max_batch = 0  # guarded by: lock
        self.shed_queue_full = 0  # guarded by: lock
        self.shed_deadline = 0  # guarded by: lock
        # fp -> {"requests", "dedup_hits", "lat": [dispatch ms, ...]}
        self.templates: Dict[str, dict] = {}  # guarded by: lock
        # bounded per-dispatch samples backing the /stats percentiles:
        # queue depth the leader drained, and how many distinct templates
        # rode the dispatch (>= 2 ⇒ MQO shared-prefix candidates)
        self.depth_at_dispatch: List[int] = []  # guarded by: lock
        self.distinct_per_dispatch: List[int] = []  # guarded by: lock

    # ------------------------------------------------------------- dispatch

    def submit(self, text: str):
        check_deadline("batcher.submit")
        req = _BatchRequest(
            text, deadline=current_deadline(), trace_id=current_trace_id()
        )
        with span("batcher.submit"):
            return self._submit(req)

    def _submit(self, req: _BatchRequest):
        with self.lock:
            if len(self.pending) >= self.max_queue_depth:
                # queue depth is the best single predictor of blowing the
                # deadline anyway: shed at the door, structured 429
                self.shed_queue_full += 1
                _BATCH_SHED.labels("queue_full").inc()
                raise Overloaded(
                    f"store queue full ({len(self.pending)} pending)",
                    retry_after_s=max(self.window * 4, 0.05),
                )
            self.pending.append(req)
            self.requests += 1
        _BATCH_REQS.inc()
        # collect followers for one window, then elect a dispatcher; loop
        # covers the race where a drain happened between append and wait
        while not req.done.wait(timeout=self.window):
            if req.deadline is not None and req.deadline.expired():
                # a waiter never blocks past its deadline: drop out even
                # if a leader is mid-dispatch (its result goes unread)
                with self.lock:
                    if req in self.pending:
                        self.pending.remove(req)
                    self.shed_deadline += 1
                _BATCH_SHED.labels("deadline").inc()
                raise DeadlineExceeded(
                    "deadline exceeded at batcher.queue", site="batcher.queue"
                )
            if self.dispatch_lock.acquire(blocking=False):
                try:
                    with self.lock:
                        batch, self.pending = self.pending, []
                    if batch:
                        self._run_batch(batch)
                finally:
                    self.dispatch_lock.release()
            if req.done.is_set():
                break
        if req.error is not None:
            raise req.error
        return req.result

    @staticmethod
    def _batch_deadline(batch: List[_BatchRequest]) -> Optional[Deadline]:
        """The LOOSEST member deadline (None if any member has none): one
        tight straggler must not kill the shared dispatch its batch-mates
        are riding.  The straggler itself sheds in its own wait loop."""
        loosest: Optional[Deadline] = None
        for r in batch:
            if r.deadline is None:
                return None
            if loosest is None or r.deadline.expires_at > loosest.expires_at:
                loosest = r.deadline
        return loosest

    def _run_batch(self, batch: List[_BatchRequest]) -> None:
        from kolibrie_tpu_torch.query.executor import (
            execute_queries_batched,
            execute_query_volcano,
        )

        texts = [r.text for r in batch]
        uniq = list(dict.fromkeys(texts))
        start = time.perf_counter()
        # the dispatch span lands in the LEADER's trace (followers' spans
        # would need span links, which this tracer doesn't model); solo
        # retries below re-enter each member's own captured trace
        with span("batcher.dispatch", batch=len(batch), uniq=len(uniq)):
            try:
                with deadline_scope(self._batch_deadline(batch)):
                    by_text = dict(
                        zip(uniq, execute_queries_batched(self.db, uniq))
                    )
            except Exception:
                # one bad member must not fail its batch-mates: solo
                # retries, each under its OWN deadline and trace (None
                # masks the leader's scope)
                _BATCH_FALLBACKS.inc()
                for r in batch:
                    try:
                        with trace_scope(r.trace_id), deadline_scope(
                            r.deadline
                        ), span("batcher.solo_retry"):
                            r.result = execute_query_volcano(r.text, self.db)
                    except Exception as e:
                        r.error = e
                    r.done.set()
                self._count(batch, texts, uniq, time.perf_counter() - start)
                return
        for r in batch:
            r.result = by_text[r.text]
            r.done.set()
        self._count(batch, texts, uniq, time.perf_counter() - start)

    def _count(self, batch, texts, uniq, elapsed: float) -> None:
        ms = elapsed * 1000.0
        parse_cache = self.db.__dict__.get("_plan_cache", {})
        by_fp: Dict[str, List[str]] = {}
        for text in uniq:
            ent = parse_cache.get(text)
            by_fp.setdefault((ent or {}).get("fp") or "unparsed", []).append(text)
        with self.lock:
            self.dispatches += 1
            self.dedup_hits += len(texts) - len(uniq)
            self.max_batch = max(self.max_batch, len(batch))
            for fp, members in by_fp.items():
                rec = self.templates.setdefault(
                    fp, {"requests": 0, "dedup_hits": 0, "lat": []}
                )
                for text in members:
                    rec["requests"] += texts.count(text)
                    rec["dedup_hits"] += texts.count(text) - 1
                rec["lat"].append(ms)
                del rec["lat"][:-256]  # bounded latency window
            self.depth_at_dispatch.append(len(batch))
            del self.depth_at_dispatch[:-256]
            self.distinct_per_dispatch.append(len(by_fp))
            del self.distinct_per_dispatch[:-256]
        _BATCH_QUEUE_AT_DISPATCH.observe(len(batch))
        _BATCH_DISTINCT_TEMPLATES.observe(len(by_fp))
        _BATCH_DISPATCHES.inc()
        _BATCH_DEDUP.inc(len(texts) - len(uniq))
        _BATCH_SIZE.observe(len(batch))
        for fp in by_fp:
            _BATCH_DISPATCH_LAT.labels(fp).observe(elapsed)

    # ---------------------------------------------------------------- stats

    def stats(self) -> dict:
        """Single source of truth lives in obs.export (the /stats handler
        renders through the same function)."""
        return obs_export.store_stats(self)


class _ServerState:
    def __init__(
        self,
        data_dir: Optional[str] = None,
        role: str = "primary",
        device: DeviceLike = None,
        mesh=None,
    ):
        #: where every database, RSP engine and follower store lives
        self.device = resolve_device(device)
        #: the shard mesh persistent stores attach to (None: only with
        #: KOLIBRIE_SHARDED, over every card)
        self.mesh = mesh
        self.sessions: Dict[str, EngineSession] = {}  # guarded by: lock
        self.stores: Dict[str, TemplateBatcher] = {}  # guarded by: lock
        self.lock = threading.Lock()
        self.counter = itertools.count(1)  # guarded by: lock
        self.admission = AdmissionController(max_inflight=MAX_INFLIGHT)
        # serving phase (guarded by: lock for writes; reads are racy-ok
        # single-word loads): "recovering" -> "ready" -> "draining"
        self.status = "ready"
        self.durability = None
        self.recovery_stats: dict = {}
        self.prewarmer = None  # set by make_server
        # replication role lifecycle: "primary" | "follower"; a follower
        # becomes primary via /admin/promote.  ``replication`` is the
        # ShipServer (primary) or ReplicationFollower (follower), or None
        # when this node is a plain single-process server.
        self.role = role
        self.replication = None
        self.primary_hint = ""  # follower: where writes should go
        self.repl_port: Optional[int] = None  # ship port (this or promoted)
        self.repl_seal_interval_s = 0.25
        self.data_dir = data_dir
        self.flightrec = None  # rolling blackbox recorder (durable nodes)
        self.http_port: Optional[int] = None  # bound port, for identity
        # the persistent compilation cache must be live BEFORE the first
        # lowering this process performs — including recovery's own WAL
        # replay dispatches, which should hit artifacts a previous
        # incarnation (or a fleet peer) compiled
        from kolibrie_tpu_torch.query import compile_cache

        compile_cache.enable(data_dir=data_dir)
        if data_dir and role == "primary":
            from kolibrie_tpu_torch.durability import DurabilityManager

            self.durability = DurabilityManager(data_dir, device=self.device)
            self.status = "recovering"
        elif role == "follower":
            # the follower's OWN DurabilityManager lives inside the
            # ReplicationFollower (it is never started — the follower
            # journals nothing until promotion); the gate stays closed
            # until the first bootstrap completes
            self.status = "recovering"


def _recover_server_state(state: _ServerState) -> None:
    """Startup recovery: latest valid snapshot + WAL replay → rebuild the
    persistent stores and /rsp sessions, then open the gate.  Runs on a
    background thread so the socket binds (and /healthz answers
    ``recovering``) while replay is in flight; mutating routes 503 with
    Retry-After until this flips status to ``ready``."""
    # fresh trace: recovery spans land in one queryable /debug/traces id
    # (thread-locals do not cross the make_server -> worker hop)
    with trace_scope(None):
        _recover_server_state_traced(state)


def _rebuild_sessions(
    state: _ServerState, sessions: Dict[str, dict]
) -> Tuple[Dict[str, str], int]:
    """Rebuild live /rsp sessions from recovered CONFIGURATION + state
    blobs (shared by startup recovery and follower promotion).  Returns
    (per-session failures, highest numeric session id seen)."""
    failures: Dict[str, str] = {}
    max_id = 0
    for sid, rec in sessions.items():
        reg = rec.get("register") or {}
        if not reg.get("query"):
            failures[sid] = "no CONFIGURATION logged (checkpoint only)"
            continue
        try:
            _, session, _ = _build_session(
                state, reg, restore_blob=rec.get("state"), session_id=sid
            )
            session.recovered = True
            session.last_checkpoint = rec.get("state")
        except Exception as e:
            failures[sid] = repr(e)
            continue
        if sid.isdigit():
            max_id = max(max_id, int(sid))
    return failures, max_id


def _recover_server_state_traced(state: _ServerState) -> None:
    import re

    failures: Dict[str, str] = {}
    max_id = 0
    try:
        # recovered stores come back mesh-attached: snapshot restore + WAL
        # replay rebuild the host store, then this hook rebuilds the
        # device-resident sharded mirrors before the store starts serving
        state.durability.on_store_recovered = (
            lambda _sid, db: _maybe_attach_sharded(db, state.mesh)
        )
        result = state.durability.recover()
        batchers: Dict[str, TemplateBatcher] = {}
        for sid, db in result.stores.items():
            # attach BEFORE serving: mutations from here on re-journal
            # (log_create=False — the store's existence is already durable)
            state.durability.attach(sid, db, log_create=False)
            batchers[sid] = TemplateBatcher(db)
            m = re.fullmatch(r"store-(\d+)", sid)
            if m:
                max_id = max(max_id, int(m.group(1)))
        with state.lock:
            state.stores.update(batchers)
        failures, max_sess = _rebuild_sessions(state, result.sessions)
        max_id = max(max_id, max_sess)
        stats = dict(result.stats)
    except Exception as e:
        # recovery must never wedge the server closed: serve empty, but
        # leave a loud trace in /healthz and /stats
        stats = {"error": repr(e)}
        try:
            state.durability.start()
        except Exception:
            _DURABILITY_ERRORS.labels("recovery_start").inc()
    if failures:
        stats["session_failures"] = failures
    with state.lock:
        # resume ids PAST everything recovered: a fresh register must
        # never collide with a recovered session or store id
        state.counter = itertools.count(max_id + 1)
        state.recovery_stats = stats
        state.status = "ready"


def _snapshot_now(state: _ServerState) -> int:
    """Commit a snapshot generation of every store and session.  Stores
    are captured under their dispatch_lock (per-store atomicity is
    sufficient: replay of overlapping WAL records is idempotent —
    see durability/manager.py); session blobs under their push_lock."""
    with state.lock:
        batchers = dict(state.stores)
        sessions = dict(state.sessions)
    sess_payload: Dict[str, dict] = {}
    for sid, session in sessions.items():
        with session.push_lock:
            blob = session.last_checkpoint
            try:
                blob = session.engine.checkpoint_state()
            except Exception:
                # stale blob is safe: recovery just replays a wider window
                _SESSION_CKPT_FAILURES.labels("checkpoint").inc()
        sess_payload[sid] = {
            "register": getattr(session, "register_request", {}) or {},
            "state": blob,
        }
    return state.durability.snapshot(
        {sid: b.db for sid, b in batchers.items()},
        sess_payload,
        locks={sid: b.dispatch_lock for sid, b in batchers.items()},
    )


def _maybe_snapshot(state: _ServerState) -> None:
    """Fold the WAL into a new generation when it has grown past the
    threshold (advisory check — cheap on every mutating request)."""
    if state.durability is None or not state.durability.should_snapshot():
        return
    try:
        _snapshot_now(state)
    except Exception:
        # a failed snapshot never fails the request that tripped it; the
        # WAL keeps growing and the next request retries
        _DURABILITY_ERRORS.labels("snapshot").inc()


def _make_follower(
    state: _ServerState,
    data_dir: str,
    source: str,
    poll_interval_s: float = 0.15,
):
    """Wire a :class:`ReplicationFollower` into the serving state: every
    store the replay surfaces gets a TemplateBatcher (or its db refreshed
    after a re-bootstrap), and replay serializes against the batcher's
    dispatch lock so reads never observe a half-applied segment."""
    from kolibrie_tpu_torch.replication.follower import ReplicationFollower

    host, _, port = source.rpartition(":")

    def _lock_for(sid):
        with state.lock:
            b = state.stores.get(sid)
        return b.dispatch_lock if b is not None else None

    def _on_store_update(sid, db, created):
        with state.lock:
            b = state.stores.get(sid)
            if b is None:
                state.stores[sid] = TemplateBatcher(db)
                b = None
        if b is not None and b.db is not db:
            # re-bootstrap replaced the store object: swap it in under
            # the dispatch lock so in-flight queries finish on the old db
            with b.dispatch_lock:
                b.db = db
        _maybe_attach_sharded(db, state.mesh)

    follower = ReplicationFollower(
        data_dir,
        host or "127.0.0.1",
        int(port),
        poll_interval_s=poll_interval_s,
        on_store_update=_on_store_update,
        lock_for=_lock_for,
        device=state.device,
    )
    state.replication = follower
    state.primary_hint = source
    return follower


def _build_rsp_engine(
    query: str,
    static_rdf: Optional[str],
    static_format: str,
    n3logic: Optional[str],
    sparql_rules: Optional[List[str]],
    consumer,
    device: DeviceLike = None,
):
    """Build an RSPEngine for /rsp-query and /rsp/register (main.rs:648-756),
    on ``device``."""
    from kolibrie_tpu_torch.query.sparql_database import SparqlDatabase
    from kolibrie_tpu_torch.rsp.builder import RSPBuilder
    from kolibrie_tpu_torch.rsp.engine import OperationMode

    builder = (
        RSPBuilder(strip_hash_comments(query), device=device)
        .set_operation_mode(OperationMode.SINGLE_THREAD)
        .with_consumer(consumer)
    )
    if n3logic and n3logic.strip():
        builder.add_rules(strip_hash_comments(n3logic))
    engine = builder.build()
    if static_rdf and static_rdf.strip():
        if static_format == "turtle":
            engine.static_db.parse_turtle(strip_hash_comments(static_rdf))
        else:
            tmp = SparqlDatabase(device=device)
            _load_rdf_into(tmp, static_rdf, static_format)
            engine.static_db.parse_ntriples(tmp.to_ntriples())
    if sparql_rules:
        apply_sparql_rules(engine.static_db, sparql_rules)
    return engine


def _build_session(
    state: _ServerState,
    reg: dict,
    restore_blob: Optional[bytes] = None,
    session_id: Optional[str] = None,
) -> Tuple[str, EngineSession, List[str]]:
    """Session factory shared by the /rsp handlers and startup recovery:
    build the engine from its CONFIGURATION, optionally restore
    checkpointed state, and register the session under ``session_id``
    (recovery preserves ids) or a fresh counter id."""
    holder: List[EngineSession] = []

    def consumer(row):
        if holder:
            holder[0].emit(row)

    engine = _build_rsp_engine(
        reg["query"],
        reg.get("static_rdf"),
        reg.get("static_format") or "rdfxml",
        reg.get("n3logic"),
        reg.get("sparql_rules"),
        consumer,
        device=state.device,
    )
    if restore_blob is not None:
        engine.restore_state(restore_blob)
    streams = [cfg.stream_iri for cfg in engine.window_configs]
    session = EngineSession(engine, streams)
    # keep the CONFIGURATION so /rsp/checkpoint blobs are restorable
    session.register_request = {
        k: reg.get(k)
        for k in (
            "query",
            "static_rdf",
            "static_format",
            "n3logic",
            "sparql_rules",
        )
    }
    holder.append(session)
    with state.lock:
        if session_id is None:
            session_id = str(next(state.counter))
        state.sessions[session_id] = session
    return session_id, session, streams


def _push_event(engine, stream: str, timestamp: int, ntriples: str) -> int:
    """Parse N-Triples and route each triple to the stream's windows."""
    from kolibrie_tpu_torch.query.rdf_parsers import parse_ntriples
    from kolibrie_tpu_torch.rsp.s2r import WindowTriple

    cleaned = strip_hash_comments(ntriples)
    if not cleaned.strip():
        return 0
    triples = parse_ntriples(cleaned)
    for s, p, o in triples:
        engine.add_to_stream(
            stream,
            WindowTriple(
                _parsed_term_to_str(s),
                _parsed_term_to_str(p),
                _parsed_term_to_str(o),
            ),
            timestamp,
        )
    engine.process_single_thread_window_results()
    return len(triples)


class KolibrieHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    state: _ServerState = None  # set by serve()
    quiet = False
    _trace_id: Optional[str] = None
    _route_label: Optional[str] = None
    _retry_after: Optional[float] = None

    # ------------------------------------------------------------- plumbing

    def log_message(self, fmt, *args):
        if not self.quiet:
            super().log_message(fmt, *args)

    def _send(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Access-Control-Allow-Methods", "GET, POST, OPTIONS")
        self.send_header(
            "Access-Control-Allow-Headers", "Content-Type, X-Kolibrie-Trace-Id"
        )
        if self._trace_id:
            self.send_header("X-Kolibrie-Trace-Id", self._trace_id)
        if self._retry_after is not None:
            # RFC 9110 delay-seconds is an integer; round UP so a client
            # honoring it never comes back early
            self.send_header(
                "Retry-After", str(max(1, int(-(-self._retry_after // 1))))
            )
            self._retry_after = None
        self.end_headers()
        self.wfile.write(body)
        if self._route_label is not None:
            _HTTP_REQS.labels(self._route_label, str(code)).inc()

    def _send_json(self, payload, code: int = 200) -> None:
        self._send(code, json.dumps(payload).encode(), "application/json")

    def _send_error_json(self, message: str, code: int = 400) -> None:
        self._send_json({"error": message}, code)

    def _send_failure(self, exc: Exception) -> None:
        """Map an exception through the shared taxonomy to a structured
        JSON response.  BaseExceptions outside Exception (KeyboardInterrupt,
        SystemExit) never reach here — the dispatch wrappers catch only
        ``Exception`` and :func:`error_response` re-raises them anyway."""
        status, payload = error_response(exc, context=self.path)
        if isinstance(payload, dict) and payload.get("retry_after_s"):
            self._retry_after = float(payload["retry_after_s"])
        self._send_json(payload, status)

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0))
        if length > MAX_REQUEST_BYTES:
            raise RequestTooLarge("request too large")
        return self.rfile.read(length)

    def _read_json(self) -> dict:
        body = self._read_body()
        try:
            payload = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise BadRequest(f"Invalid JSON: {e}") from e
        if not isinstance(payload, dict):
            raise BadRequest("Invalid JSON: expected an object")
        return payload

    def _request_deadline(self, req: Optional[dict] = None) -> Optional[Deadline]:
        """The request's deadline budget: ``deadline_ms`` body field, then
        ``X-Kolibrie-Deadline-Ms`` header, then the server default.
        ``<= 0`` disables the deadline for this request."""
        raw = req.get("deadline_ms") if req else None
        if raw is None:
            raw = self.headers.get("X-Kolibrie-Deadline-Ms")
        if raw is None:
            raw = DEFAULT_DEADLINE_MS
        try:
            ms = float(raw)
        except (TypeError, ValueError):
            raise BadRequest(f"invalid deadline_ms: {raw!r}")
        return Deadline.from_ms(ms) if ms > 0 else None

    # --------------------------------------------------------------- routes

    def do_OPTIONS(self):
        self._route_label = "OPTIONS"
        self._send(204, b"", "text/plain")

    def do_GET(self):
        path, _, qs = self.path.partition("?")
        known = ("/", "/playground", "/stats", "/metrics", "/healthz",
                 "/debug/traces", "/debug/timeline")
        if path.startswith("/rsp/events/"):
            self._route_label = "/rsp/events"
        elif path.startswith("/rsp/results/"):
            self._route_label = "/rsp/results"
        else:
            self._route_label = path if path in known else "unknown"
        if path == "/" or path == "/playground":
            try:
                with open(_PLAYGROUND_PATH, "rb") as f:
                    self._send(200, f.read(), "text/html; charset=utf-8")
            except OSError:
                self._send_error_json("playground not available", 404)
            return
        if path.startswith("/rsp/events/"):
            # SSE is long-lived: no trace scope, no request span
            self._handle_sse(path[len("/rsp/events/"):])
            return
        routes = {
            "/stats": lambda: self._handle_stats(),
            "/metrics": lambda: self._handle_metrics(),
            "/healthz": lambda: self._handle_healthz(),
            "/debug/traces": lambda: self._handle_debug_traces(qs),
            "/debug/timeline": lambda: self._handle_debug_timeline(qs),
        }
        if path.startswith("/rsp/results/"):
            sid = path[len("/rsp/results/"):]
            routes[path] = lambda: self._handle_rsp_results(sid)
        with trace_scope(
            self.headers.get("X-Kolibrie-Trace-Id") or None
        ) as tid:
            self._trace_id = tid
            with span(
                "http.request", route=path, method="GET", node=obslog.node()
            ):
                try:
                    handler = routes.get(path)
                    if handler is None:
                        raise NotFound("not found")
                    handler()
                except Exception as e:
                    self._send_failure(e)

    _POST_ROUTES = {
        "/query": "_handle_query",
        "/store/load": "_handle_store_load",
        "/store/query": "_handle_store_query",
        "/explain": "_handle_explain",
        "/rsp-query": "_handle_rsp_query",
        "/rsp/register": "_handle_rsp_register",
        "/rsp/push": "_handle_rsp_push",
        "/rsp/checkpoint": "_handle_rsp_checkpoint",
        "/rsp/restore": "_handle_rsp_restore",
        "/admin/promote": "_handle_admin_promote",
        "/debug/profile": "_handle_debug_profile",
        "/debug/prewarm": "_handle_debug_prewarm",
        "/debug/explain": "_handle_debug_explain",
        "/debug/bundle": "_handle_debug_bundle",
    }

    # routes that must answer regardless of recovering/draining — the
    # flight recorder exists precisely for the moments the gate is shut
    _ALWAYS_OPEN_ROUTES = frozenset({"/debug/bundle"})

    # a follower serves reads at bounded staleness; writes belong on the
    # primary (409 not_primary re-aims the router's role map)
    _MUTATING_ROUTES = frozenset(
        {
            "/store/load",
            "/rsp-query",
            "/rsp/register",
            "/rsp/push",
            "/rsp/checkpoint",
            "/rsp/restore",
        }
    )

    def do_POST(self):
        path = self.path.partition("?")[0]
        name = self._POST_ROUTES.get(path)
        # unknown paths share one label: client typos must not mint
        # unbounded label values
        self._route_label = path if name else "unknown"
        start = time.perf_counter()
        # the client's trace id (or a fresh one) scopes the whole request;
        # _send echoes it back via X-Kolibrie-Trace-Id and error payloads
        # pick it up in errors.py
        with trace_scope(
            self.headers.get("X-Kolibrie-Trace-Id") or None
        ) as tid:
            self._trace_id = tid
            with span(
                "http.request", route=path, method="POST", node=obslog.node()
            ):
                try:
                    if name is None:
                        raise NotFound("not found")
                    # mutating routes wait out recovery (503 + Retry-After)
                    # and are refused outright during drain; observability
                    # GETs (/healthz, /stats, /metrics) stay open throughout
                    phase = self.state.status
                    if (
                        phase != "ready"
                        and path not in self._ALWAYS_OPEN_ROUTES
                    ):
                        raise Unavailable(phase=phase)
                    if (
                        self.state.role != "primary"
                        and path in self._MUTATING_ROUTES
                    ):
                        # follower (or mid-promotion candidate): writes
                        # re-aim at the primary via the router's role map
                        raise NotPrimary(
                            primary_hint=self.state.primary_hint
                        )
                    getattr(self, name)()
                except Exception as e:
                    # single choke point: handlers raise taxonomy errors
                    # (or plain exceptions, conservatively mapped);
                    # KeyboardInterrupt and SystemExit are BaseException
                    # and sail straight through
                    self._send_failure(e)
        _HTTP_LAT.labels(path if name else "unknown").observe(
            time.perf_counter() - start
        )

    # -------------------------------------------------------------- /explain

    def _handle_explain(self):
        """Device physical-plan EXPLAIN: {"sparql": ..., "rdf"?: ...,
        "format"?: ...} → {"plan": tree string} (scan orders, join keys +
        exact counts, or an honest 'host path: <reason>' line)."""
        from kolibrie_tpu_torch.query.engine import QueryEngine
        from kolibrie_tpu_torch.query.sparql_database import SparqlDatabase

        req = self._read_json()
        if not req.get("sparql"):
            raise BadRequest("No query provided")
        db = SparqlDatabase(device=self.state.device)
        try:
            _load_rdf_into(db, req.get("rdf") or "", req.get("format", "rdfxml"))
        except Exception as e:
            raise BadRequest(f"RDF parse error: {e}") from e
        with deadline_scope(self._request_deadline(req)):
            try:
                plan = QueryEngine(db).explain_device(
                    strip_hash_comments(req["sparql"])
                )
            except KolibrieError:
                raise
            except Exception as e:
                raise QueryError(f"Explain failed: {e}") from e
        self._send_json({"plan": plan})

    # ---------------------------------------------------------------- /query

    def _handle_query(self):
        from kolibrie_tpu_torch.query.executor import (
            execute_query,
            execute_query_volcano,
        )
        from kolibrie_tpu_torch.query.sparql_database import SparqlDatabase

        req = self._read_json()
        queries: List[str] = []
        if req.get("sparql"):
            queries.append(req["sparql"])
        queries.extend(req.get("queries") or [])
        if not queries:
            raise BadRequest("No queries provided")
        rules: List[str] = []
        if req.get("rule"):
            rules.append(req["rule"])
        rules.extend(req.get("rules") or [])
        fmt = req.get("format", "rdfxml")

        deadline = self._request_deadline(req)
        with self.state.admission.admitted_scope(), deadline_scope(deadline):
            db = SparqlDatabase(device=self.state.device)
            try:
                _load_rdf_into(db, req.get("rdf") or "", fmt)
            except Exception as e:
                raise BadRequest(f"RDF parse error: {e}") from e

            n3logic = req.get("n3logic")
            if n3logic:
                try:
                    apply_n3_logic(db, n3logic)
                except Exception as e:
                    raise BadRequest(f"N3 rule error: {e}") from e
            if rules:
                try:
                    apply_sparql_rules(db, rules)
                except Exception as e:
                    raise BadRequest(f"Rule error: {e}") from e

            results = []
            # The reference routes only pre-indexed ntriples loads through
            # the Volcano optimizer (main.rs:941); here Volcano IS the
            # default path and {"legacy": true} opts into the sequential
            # agreement path.
            run = execute_query if req.get("legacy") else execute_query_volcano
            for idx, q in enumerate(queries):
                start = time.perf_counter()
                try:
                    rows = run(strip_hash_comments(q), db)
                except KolibrieError:
                    raise
                except Exception as e:
                    raise QueryError(f"Query {idx} failed: {e}") from e
                results.append(
                    {
                        "query_index": idx,
                        "query": q,
                        "data": rows,
                        "execution_time_ms": (time.perf_counter() - start)
                        * 1000.0,
                    }
                )
        self._send_json({"results": results})

    # ----------------------------------------------------- persistent stores

    def _handle_store_load(self):
        """Create or extend a persistent store: {"store_id"?, "rdf",
        "format"?, "mode"?} → {"store_id", "loaded", "triples"}.  Unlike
        /query (fresh database per request), the store survives across
        requests so repeat queries hit the warm plan-template cache and
        concurrent same-template queries micro-batch."""
        from kolibrie_tpu_torch.query.sparql_database import SparqlDatabase

        req = self._read_json()
        state = self.state
        sid = str(req.get("store_id") or "")
        with state.lock:
            if not sid:
                sid = f"store-{next(state.counter)}"
            batcher = state.stores.get(sid)
            if batcher is None:
                db = SparqlDatabase(device=state.device)
                db.execution_mode = req.get("mode") or "device"
                batcher = TemplateBatcher(db)
                state.stores[sid] = batcher
                if state.durability is not None:
                    # attach before the first mutation: every add/delete
                    # from here on lands in the WAL as a "mut" record
                    state.durability.attach(sid, db)
        try:
            with batcher.dispatch_lock:
                if req.get("mode"):
                    batcher.db.execution_mode = req["mode"]
                n = _load_rdf_into(
                    batcher.db, req.get("rdf") or "", req.get("format", "ntriples")
                )
                # eager mirror upload while the lock is held: the first
                # query after a load pays dispatch, not partitioning
                _maybe_attach_sharded(batcher.db, state.mesh)
        except Exception as e:
            raise BadRequest(f"RDF parse error: {e}") from e
        _maybe_snapshot(state)
        body = {
            "store_id": sid,
            "loaded": n,
            "triples": len(batcher.db.store),
        }
        if state.durability is not None and state.durability.wal is not None:
            # read-your-writes token: a follower that has applied this
            # segment holds this write (segments seal whole — see
            # replication/primary.py)
            seg, off = state.durability.wal.position()
            body["watermark"] = {"segment": seg, "offset": off}
        self._send_json(body)

    def _handle_store_query(self):
        """Query a persistent store through the template batcher:
        {"store_id", "sparql"} → {"data", "execution_time_ms"}.  In-flight
        identical queries are answered by one execution; same-template
        variants within the batching window share one device dispatch.

        ``?explain=analyze`` is the one-off debug variant: the query runs
        SOLO under the dispatch lock with an analyze capture active, and
        the response gains an ``"explain"`` key carrying the raw
        per-operator records (device / interp)."""
        from urllib.parse import parse_qs

        req = self._read_json()
        if not req.get("sparql"):
            raise BadRequest("No query provided")
        explain = (
            parse_qs(self.path.partition("?")[2]).get("explain") or [""]
        )[0]
        if explain not in ("", "analyze"):
            raise BadRequest(f"unknown explain mode: {explain!r}")
        state = self.state
        with state.lock:
            batcher = state.stores.get(str(req.get("store_id") or ""))
        if batcher is None:
            raise NotFound("store not found")
        self._check_min_watermark(req.get("min_watermark"))
        start = time.perf_counter()
        analysis = None
        with state.admission.admitted_scope(), deadline_scope(
            self._request_deadline(req)
        ):
            try:
                text = strip_hash_comments(req["sparql"])
                if explain == "analyze":
                    # the batch leader may be ANOTHER thread, and the
                    # analyze capture is thread-local — run solo so the
                    # records land here
                    from kolibrie_tpu_torch.obs import analyze as obs_analyze
                    from kolibrie_tpu_torch.query.executor import (
                        execute_queries_batched,
                    )

                    with batcher.dispatch_lock, obs_analyze.capture() as c:
                        rows = execute_queries_batched(batcher.db, [text])[0]
                    analysis = c.records
                else:
                    rows = batcher.submit(text)
            except KolibrieError:
                raise
            except Exception as e:
                raise QueryError(f"Query failed: {e}") from e
        body = {
            "data": rows,
            "execution_time_ms": (time.perf_counter() - start) * 1000.0,
        }
        if analysis is not None:
            body["explain"] = analysis
        self._send_json(body)

    def _handle_stats(self):
        """Serving metrics per store: request/dedup/batch counters, per-
        template dispatch latency percentiles, the two-level plan-cache
        snapshot, and jit compile counts.  Rendered by obs.export — the
        same source of truth as TemplateBatcher.stats()."""
        self._send_json(obs_export.build_stats(self.state))

    def _check_min_watermark(self, min_wm) -> None:
        """Read-your-writes: the client passes back the ``watermark``
        token a write returned; a follower that has not yet applied that
        segment answers 503 ``catching_up`` (+ jittered Retry-After) so
        the router tries the next replica instead of serving stale
        rows.  The primary trivially satisfies its own tokens."""
        if min_wm is None:
            return
        try:
            want = (
                int(min_wm.get("segment", 0))
                if isinstance(min_wm, dict)
                else int(min_wm)
            )
        except (TypeError, ValueError, AttributeError):
            raise BadRequest(f"invalid min_watermark: {min_wm!r}")
        state = self.state
        if state.role != "follower":
            return
        repl = state.replication
        applied = repl.applied_segment if repl is not None else -1
        if applied < want:
            _READS_SHED_CATCHING_UP.inc()
            raise Unavailable(
                "follower behind requested watermark "
                f"(applied={applied} < {want})",
                phase="catching_up",
            )

    def _handle_admin_promote(self):
        """Promote this follower to primary (the router's supervisor, or
        an operator, POSTs here after the old primary dies).  Highest
        durable watermark wins ACROSS candidates — that choice is the
        caller's; this node just finalizes: stop replicating, truncate
        unapplied local segments, open a fresh WAL segment, attach the
        stores, rebuild /rsp sessions, and (if configured) start shipping
        to the next generation of followers."""
        state = self.state
        with state.lock:
            repl = state.replication
            eligible = state.role == "follower" and repl is not None
            if eligible:
                # claim the transition under the lock: concurrent
                # /admin/promote posts must not double-finalize
                state.role = "candidate"
        if not eligible:
            self._send_json(
                {
                    "role": state.role,
                    "promoted": False,
                    "watermark": (
                        repl.watermark() if repl is not None else {}
                    ),
                }
            )
            return
        t0 = time.perf_counter()
        wm = repl.promote()
        state.durability = repl.manager
        failures, max_sess = _rebuild_sessions(state, repl.res.sessions)
        import re

        max_id = max_sess
        with state.lock:
            for sid in state.stores:
                m = re.fullmatch(r"store-(\d+)", sid)
                if m:
                    max_id = max(max_id, int(m.group(1)))
            state.counter = itertools.count(max_id + 1)
            state.role = "primary"
            state.primary_hint = ""
            if failures:
                state.recovery_stats = dict(
                    state.recovery_stats, session_failures=failures
                )
        if state.repl_port is not None:
            from kolibrie_tpu_torch.replication.primary import ShipServer

            state.replication = ShipServer(
                state.durability,
                port=state.repl_port,
                seal_interval_s=state.repl_seal_interval_s,
            )
        else:
            state.replication = None
        elapsed = time.perf_counter() - t0
        _PROMOTE_FINALIZE_SECONDS.observe(elapsed)
        obslog.set_identity("primary", getattr(state, "http_port", None))
        _log.info(
            "promotion finalized",
            finalize_ms=round(elapsed * 1000.0, 1),
            applied_segment=wm.get("applied_segment"),
            applied_records=wm.get("applied_records"),
            session_failures=failures,
        )
        self._send_json(
            {"role": "primary", "promoted": True, "watermark": wm}
        )

    def _handle_healthz(self):
        """Readiness probe: 200 ``ready`` / 503 ``recovering``/``draining``
        (Docker HEALTHCHECK, the router's prober, and the chaos harness
        poll this).  Always carries the role and the store/WAL watermark —
        single-process servers included, so one curl answers 'what have
        you durably got' everywhere."""
        state = self.state
        body = {"status": state.status, "role": state.role}
        with state.lock:
            batchers = dict(state.stores)
        wm: dict = {
            "stores": {
                sid: list(b.db.store.version_key())
                for sid, b in sorted(batchers.items())
            }
        }
        if state.durability is not None:
            body["durability"] = state.durability.stats()
            body["recovery"] = state.recovery_stats
            if state.durability.wal is not None:
                seg, off = state.durability.wal.position()
                wm["durable_wal"] = {"segment": seg, "offset": off}
        body["watermark"] = wm
        if state.replication is not None:
            body["replication"] = state.replication.stats()
        self._send_json(body, 200 if state.status == "ready" else 503)

    def _handle_rsp_results(self, session_id: str):
        """The session's server-side result log (what SSE subscribers got),
        plus its recovery lineage — the chaos harness compares this against
        the oracle after a kill-restart."""
        with self.state.lock:
            session = self.state.sessions.get(session_id)
        if session is None:
            raise NotFound("session not found")
        with session.lock:
            results = list(session.results)
        self._send_json(
            {
                "results": results,
                "recovered": session.recovered,
                "crash_recoveries": session.crash_recoveries,
            }
        )

    def _handle_metrics(self):
        """Prometheus text exposition of the process-wide registry."""
        obs_export.refresh_server_gauges(self.state)
        self._send(
            200,
            obs_export.render_prometheus().encode("utf-8"),
            "text/plain; version=0.0.4; charset=utf-8",
        )

    def _handle_debug_traces(self, qs: str):
        """The span ring as JSONL; ``?trace_id=`` filters to one trace."""
        from urllib.parse import parse_qs

        trace_id = (parse_qs(qs).get("trace_id") or [None])[0]
        body = export_jsonl(trace_id)
        self._send(200, body.encode("utf-8"), "application/x-ndjson")

    def _handle_debug_timeline(self, qs: str):
        """``GET /debug/timeline``: the metrics time-series ring rendered
        as per-metric series — counter deltas, gauge samples, histogram
        count/sum deltas + interpolated quantiles.  ``?metric=`` narrows
        to one family, ``?n=`` to the trailing N samples."""
        from urllib.parse import parse_qs

        from kolibrie_tpu_torch.obs import timeseries

        p = parse_qs(qs)
        metric = (p.get("metric") or [None])[0]
        try:
            n = int((p.get("n") or ["0"])[0]) or None
        except ValueError:
            raise BadRequest("invalid n")
        ring = timeseries.default_ring()
        body = ring.series(metric=metric, n=n)
        body["interval_s"] = timeseries.DEFAULT_INTERVAL_S
        body["capacity"] = ring.capacity
        self._send_json(body)

    def _handle_debug_bundle(self):
        """``POST /debug/bundle``: dump a postmortem bundle on demand —
        the operator's 'grab everything before I poke it' button.  Open
        even while recovering/draining (that is when it matters)."""
        state = self.state
        if state.data_dir is None:
            raise BadRequest("no data_dir: nowhere to write a bundle")
        path = flightrec.dump(
            state.data_dir,
            "manual",
            stats_fn=lambda: obs_export.build_stats(state),
        )
        self._send_json({"ok": True, "path": path})

    def _handle_debug_explain(self):
        """``POST /debug/explain``: EXPLAIN ANALYZE against a registered
        store ({"store_id", "sparql"}) or an inline dataset ({"sparql",
        "rdf"?, "format"?}) — the plan tree with per-operator actuals,
        occupancy and per-stage device time, as rendered by
        :meth:`QueryEngine.explain_device(analyze=True)`."""
        import contextlib

        from kolibrie_tpu_torch.query.engine import QueryEngine
        from kolibrie_tpu_torch.query.sparql_database import SparqlDatabase

        req = self._read_json()
        if not req.get("sparql"):
            raise BadRequest("No query provided")
        store_id = str(req.get("store_id") or "")
        if store_id:
            with self.state.lock:
                batcher = self.state.stores.get(store_id)
            if batcher is None:
                raise NotFound("store not found")
            db, lock = batcher.db, batcher.dispatch_lock
        else:
            db, lock = SparqlDatabase(device=self.state.device), contextlib.nullcontext()
            try:
                _load_rdf_into(
                    db, req.get("rdf") or "", req.get("format", "rdfxml")
                )
            except Exception as e:
                raise BadRequest(f"RDF parse error: {e}") from e
        with deadline_scope(self._request_deadline(req)), lock:
            try:
                plan = QueryEngine(db).explain_device(
                    strip_hash_comments(req["sparql"]), analyze=True
                )
            except KolibrieError:
                raise
            except Exception as e:
                raise QueryError(f"Explain failed: {e}") from e
        self._send_json({"plan": plan})

    def _handle_debug_prewarm(self):
        """``POST /debug/prewarm``: one synchronous warm sweep — the
        manifest's top-N templates compiled (or disk-loaded) against
        every registered store, off the normal admission path.  Returns
        per-template compile wall-ms and the executable's source
        (``compiled`` = real XLA compile, ``disk`` = persistent-cache
        hit); operators call this after a deploy to pre-pay the tail."""
        from urllib.parse import parse_qs

        from kolibrie_tpu_torch.query import compile_cache

        warmer = self.state.prewarmer
        if warmer is None:
            raise NotFound("prewarm not configured")
        qs = parse_qs(self.path.partition("?")[2])
        top_n = int((qs.get("top_n") or [0])[0]) or None
        results = warmer.run_once(top_n=top_n)
        self._send_json(
            {
                "warmed": results,
                "manifest": compile_cache.manifest_path(warmer.root),
                "compile_cache": compile_cache.stats(),
            }
        )

    def _handle_debug_profile(self):
        """``POST /debug/profile?seconds=N``: capture a ``torch.profiler``
        trace (host ops, and the card's kernels on a card server) for N
        wall seconds.  No-ops (``profiled: false``) on a CPU server so CI
        never pays for — or breaks on — the profiler; set
        ``KOLIBRIE_PROFILE_FORCE=1`` to capture anyway (the CPU trace is
        real and viewable, just not what the gate protects against)."""
        from urllib.parse import parse_qs

        qs = parse_qs(self.path.partition("?")[2])
        try:
            seconds = float((qs.get("seconds") or ["1"])[0])
        except ValueError:
            raise BadRequest("invalid seconds")
        if not 0 < seconds <= 30:
            raise BadRequest("seconds must be in (0, 30]")
        backend = "gpu" if self.state.device.type == "cuda" else "cpu"
        forced = os.environ.get("KOLIBRIE_PROFILE_FORCE", "") == "1"
        if backend != "gpu" and not forced:
            self._send_json(
                {
                    "profiled": False,
                    "backend": backend,
                    "reason": "profiler capture is gated to accelerator "
                    "backends (CPU CI no-op); KOLIBRIE_PROFILE_FORCE=1 "
                    "overrides",
                }
            )
            return
        import tempfile

        from torch.profiler import ProfilerActivity, profile

        out_dir = os.environ.get("KOLIBRIE_PROFILE_DIR") or tempfile.mkdtemp(
            prefix="kolibrie-profile-"
        )
        activities = [ProfilerActivity.CPU]
        if backend == "gpu":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        try:
            time.sleep(seconds)
        finally:
            prof.stop()
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
        n_files = sum(len(fs) for _, _, fs in os.walk(out_dir))
        self._send_json(
            {"profiled": True, "backend": backend, "forced": forced,
             "trace_dir": out_dir, "trace_files": n_files,
             "seconds": seconds}
        )

    # ------------------------------------------------------------ /rsp-query

    def _handle_rsp_query(self):
        req = self._read_json()
        if not req.get("query"):
            raise BadRequest("No query provided")
        collected: List = []
        start = time.perf_counter()
        try:
            engine = _build_rsp_engine(
                req["query"],
                req.get("static_rdf"),
                req.get("static_format", "rdfxml"),
                None,
                None,
                collected.append,
                device=self.state.device,
            )
        except Exception as e:
            raise BadRequest(f"Failed to build RSP engine: {e}") from e
        events = [e for e in (req.get("events") or []) if isinstance(e, dict)]
        events.sort(key=lambda e: e.get("timestamp", 0))
        try:
            for ev in events:
                _push_event(
                    engine,
                    ev.get("stream", ""),
                    int(ev.get("timestamp", 0)),
                    ev.get("ntriples", ""),
                )
        except KolibrieError:
            raise
        except Exception as e:
            raise QueryError(f"Event error: {e}") from e
        engine.stop()
        table = results_to_table(collected)
        self._send_json(
            {
                "data": table,
                "total_results": max(0, len(table) - 1),
                "execution_time_ms": (time.perf_counter() - start) * 1000.0,
            }
        )

    # --------------------------------------------------------- /rsp sessions

    def _create_session(self, reg: dict, restore_blob: Optional[bytes] = None):
        """Shared register/restore core: build the engine from its
        CONFIGURATION, optionally restore checkpointed state, register the
        session, and answer with its id.  (docs/PREEMPTION.md: a restore is
        a re-register plus state.)"""
        state = self.state
        try:
            session_id, session, streams = _build_session(
                state, reg, restore_blob=restore_blob
            )
        except Exception as e:
            verb = "restore" if restore_blob is not None else "build"
            raise BadRequest(f"Failed to {verb} RSP engine: {e}") from e
        if state.durability is not None:
            # CONFIGURATION first, then state: replay order mirrors this
            state.durability.log_session_register(
                session_id, session.register_request
            )
            if restore_blob is not None:
                state.durability.log_session_checkpoint(
                    session_id, restore_blob
                )
        self._send_json({"session_id": session_id, "streams": streams})

    def _handle_rsp_register(self):
        req = self._read_json()
        if not req.get("query"):
            raise BadRequest("No query provided")
        self._create_session(req)

    def _handle_rsp_checkpoint(self):
        """Snapshot a live session: configuration (the original register
        request) + resumable engine state (base64 pickle blob).  POST the
        SAME payload to /rsp/restore to resume after a restart
        (docs/PREEMPTION.md)."""
        import base64

        req = self._read_json()
        state = self.state
        with state.lock:
            session = state.sessions.get(str(req.get("session_id")))
        if session is None:
            raise NotFound("session not found")
        with session.push_lock:
            blob = session.engine.checkpoint_state()
        self._send_json(
            {
                "register": getattr(session, "register_request", {}),
                "state": base64.b64encode(blob).decode("ascii"),
            }
        )

    def _handle_rsp_restore(self):
        """Rebuild a session from a /rsp/checkpoint payload: re-register
        the configuration, then restore the engine state; returns a fresh
        session_id continuing the stream exactly where the snapshot was.
        The state blob is JSON (safe on untrusted input — see
        RSPEngine.checkpoint_state), never pickle."""
        import base64

        req = self._read_json()
        reg = req.get("register") or {}
        if not reg.get("query"):
            raise BadRequest("No query in register payload")
        try:
            blob = base64.b64decode(req.get("state", ""), validate=True)
        except Exception as e:
            raise BadRequest("Invalid base64 state") from e
        self._create_session(reg, restore_blob=blob)

    def _handle_rsp_push(self):
        req = self._read_json()
        state = self.state
        sid = str(req.get("session_id"))
        with state.lock:
            session = state.sessions.get(sid)
        if session is None:
            raise NotFound("session not found")
        with session.push_lock, deadline_scope(self._request_deadline(req)):
            try:
                prev_blob = session.last_checkpoint
                n = _push_event(
                    session.engine,
                    req.get("stream", ""),
                    int(req.get("timestamp", 0)),
                    req.get("ntriples", ""),
                )
                # checkpoint AFTER the event is fully processed: a crash
                # on a later push rolls back to this consistent state and
                # the client replays from here (at-least-once)
                session.maybe_checkpoint()
                if (
                    state.durability is not None
                    and session.last_checkpoint is not None
                    and session.last_checkpoint is not prev_blob
                ):
                    # the durable mirror of maybe_checkpoint: a kill -9
                    # resumes this session from exactly this blob
                    state.durability.log_session_checkpoint(
                        sid, session.last_checkpoint
                    )
            except WindowCrash as e:
                recovered = session.recover()
                payload = e.payload(context=self.path)
                payload["recovered"] = recovered
                payload["crash_recoveries"] = session.crash_recoveries
                self._send_json(payload, e.http_status)
                return
            except KolibrieError:
                raise
            except Exception as e:
                raise QueryError(f"Push error: {e}") from e
        _maybe_snapshot(state)
        self._send_json({"ok": True, "triples": n, "recovered": session.recovered})

    def _handle_sse(self, session_id: str):
        state = self.state
        if state.status != "ready":
            # a subscriber arriving mid-recovery would race session
            # rebuild — 503 with Retry-After like the mutating routes
            status, payload = error_response(
                Unavailable(phase=state.status), context=self.path
            )
            if payload.get("retry_after_s"):
                self._retry_after = float(payload["retry_after_s"])
            self._send_json(payload, status)
            return
        with state.lock:
            session = state.sessions.get(session_id)
        if session is None:
            self._send_error_json("session not found", 404)
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Access-Control-Allow-Origin", "*")
        # SSE is an unbounded stream: no Content-Length, close to terminate.
        self.send_header("Connection", "close")
        self.end_headers()
        q, backlog = session.subscribe_with_backlog()
        try:
            # replay results that arrived before the client connected
            for payload in backlog:
                self.wfile.write(f"data: {payload}\n\n".encode())
            self.wfile.flush()
            while True:
                try:
                    payload = q.get(timeout=SSE_KEEPALIVE_SECONDS)
                    self.wfile.write(f"data: {payload}\n\n".encode())
                except queue.Empty:
                    self.wfile.write(b": keepalive\n\n")
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError, ValueError):
            # ValueError covers "I/O operation on closed file", which is
            # not an OSError subclass.  A subscriber that dies WITHOUT
            # reaching this finally (killed daemon thread) is pruned by
            # EngineSession.emit when its bounded queue fills.
            pass
        finally:
            session.unsubscribe(q)


_TIMELINE_SAMPLER = None  # guarded by: _TIMELINE_LOCK
_TIMELINE_LOCK = threading.Lock()


def make_server(
    host: str = "127.0.0.1",
    port: int = 7878,
    quiet: bool = False,
    data_dir: Optional[str] = None,
    recover_async: bool = True,
    repl_port: Optional[int] = None,
    repl_source: Optional[str] = None,
    repl_poll_interval_s: float = 0.15,
    repl_seal_interval_s: float = 0.25,
    device: DeviceLike = None,
    mesh=None,
):
    """Build the HTTP server, serving on ``device`` (the CUDA card unless
    the caller passes another; no card and no device: it raises).

    With ``data_dir`` the server is durable:
    every store mutation batch and session checkpoint rides the WAL, and
    boot runs crash recovery (latest valid snapshot + WAL replay) before
    the gate opens — on a background thread by default so the socket
    binds immediately and serves 503 + Retry-After while replaying.

    Replication (docs/REPLICATION.md): ``repl_port`` starts a WAL-segment
    ship server on a durable primary (followers pull from it);
    ``repl_source`` ("host:port" of a primary's ship server) boots this
    node as a read-only follower of that primary instead — ``data_dir``
    is then the follower's own mirror directory.

    Mesh serving: with ``mesh`` (a ``parallel.mesh.Mesh``) every
    persistent store attaches a ``ShardedDatabase`` over it, so batched
    same-template groups run as one mesh dispatch; ``KOLIBRIE_SHARDED``
    does the same over every card, and on a one-device runtime attaches
    nothing."""
    role = "follower" if repl_source else "primary"
    state = _ServerState(data_dir=data_dir, role=role, device=device, mesh=mesh)
    state.repl_port = repl_port
    state.repl_seal_interval_s = repl_seal_interval_s
    handler = type(
        "BoundHandler", (KolibrieHandler,), {"state": state, "quiet": quiet}
    )
    httpd = BurstHTTPServer((host, port), handler)
    state.http_port = httpd.server_address[1]
    # node identity (role:port) stamps every span and log record so a
    # cross-process trace names which node each hop ran on
    obslog.set_identity(role, state.http_port)

    def _targets():
        with state.lock:
            batchers = dict(state.stores)
        return [
            (sid, b.db, b.dispatch_lock) for sid, b in sorted(batchers.items())
        ]

    from kolibrie_tpu_torch.query.prewarm import PrewarmManager

    # a follower's dictionary may only grow by replay (a warm read that
    # interns, such as an aggregate's numbers, would misalign every later
    # shipped segment): it warms once promoted
    state.prewarmer = PrewarmManager(
        get_targets=_targets,
        is_idle=lambda: state.admission.inflight == 0,
        is_ready=lambda: state.status == "ready" and state.role == "primary",
    )
    state.prewarmer.start()
    # /debug/timeline's data source: sample the metrics registry into the
    # default ring for the life of the process (daemon thread, started
    # once — test suites build many servers and must not stack samplers)
    from kolibrie_tpu_torch.obs import timeseries

    global _TIMELINE_SAMPLER
    with _TIMELINE_LOCK:
        if _TIMELINE_SAMPLER is None:
            _TIMELINE_SAMPLER = timeseries.Sampler(timeseries.default_ring())
            _TIMELINE_SAMPLER.start()
    # rolling blackbox: durable nodes keep a recent postmortem bundle on
    # disk at all times, so even kill -9 leaves evidence (the SIGTERM and
    # fatal-error paths write a final, uniquely-named bundle on top)
    if data_dir and os.environ.get("KOLIBRIE_FLIGHTREC_DISABLED") != "1":
        state.flightrec = flightrec.FlightRecorder(
            data_dir,
            interval_s=float(
                os.environ.get("KOLIBRIE_FLIGHTREC_INTERVAL_S", "5.0")
            ),
            stats_fn=lambda: obs_export.build_stats(state),
        )
        state.flightrec.start()
    if state.durability is not None:
        if recover_async:
            threading.Thread(
                target=_recover_server_state,
                args=(state,),
                daemon=True,
                name="kolibrie-recovery",
            ).start()
        else:
            _recover_server_state(state)
        if repl_port is not None:
            # the ship server serves on-disk state only, so it can start
            # before recovery finishes — followers just see the segments
            # and generation the recovering primary already has
            from kolibrie_tpu_torch.replication.primary import ShipServer

            state.replication = ShipServer(
                state.durability,
                port=repl_port,
                seal_interval_s=repl_seal_interval_s,
            )
    elif role == "follower":
        if not data_dir:
            raise ValueError("a follower needs data_dir (its mirror)")
        follower = _make_follower(
            state, data_dir, repl_source,
            poll_interval_s=repl_poll_interval_s,
        )

        def _follower_gate():
            # the poll loop runs bootstrap; the gate opens on the first
            # completed one and the server starts serving reads
            follower.start()
            while state.status == "recovering" and not follower.promoted:
                if follower.bootstrapped:
                    with state.lock:
                        if state.status == "recovering":
                            state.status = "ready"
                    return
                time.sleep(0.05)

        threading.Thread(
            target=_follower_gate, daemon=True, name="kolibrie-follower"
        ).start()
    return httpd


def shutdown_gracefully(httpd, timeout_s: float = 30.0) -> None:
    """SIGTERM path: gate admissions (``draining`` → new requests 503),
    wait for in-flight requests to finish, commit a final snapshot, flush
    and close the WAL, then stop the listener.  Safe to call on a
    non-durable server (drain + stop only)."""
    state = httpd.RequestHandlerClass.state
    with state.lock:
        state.status = "draining"
    _log.info("draining", timeout_s=timeout_s)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline and state.admission.inflight > 0:
        time.sleep(0.05)
    if state.flightrec is not None:
        # final bundle BEFORE teardown: it captures the still-live stats
        # surface; the rolling blackbox stays behind as well
        state.flightrec.stop()
        flightrec.try_dump(
            state.data_dir,
            "sigterm",
            stats_fn=lambda: obs_export.build_stats(state),
        )
    if state.prewarmer is not None:
        # stop the warmer before the final snapshot: it persists the
        # manifest so the NEXT incarnation knows this one's hot set
        state.prewarmer.stop()
    repl = state.replication
    if repl is not None:
        # follower: stop the poll loop; primary: close the ship listener
        closer = getattr(repl, "stop", None) or getattr(repl, "close")
        closer()
    if state.durability is not None:
        try:
            _snapshot_now(state)
        except Exception:
            # WAL replay covers everything the snapshot would have; close
            # still flushes + fsyncs the tail below
            _DURABILITY_ERRORS.labels("final_snapshot").inc()
        state.durability.close()
    httpd.shutdown()


def serve(
    host: str = "127.0.0.1", port: int = 7878, device: DeviceLike = None
) -> None:
    """Serve until SIGTERM on ``device`` (the CUDA card unless the caller
    passes another), configured by ``KOLIBRIE_*`` environment variables."""
    import signal

    data_dir = os.environ.get("KOLIBRIE_DATA_DIR") or None
    repl_port_raw = os.environ.get("KOLIBRIE_REPL_PORT") or ""
    repl_source = os.environ.get("KOLIBRIE_REPL_SOURCE") or None
    # chaos harnesses arm delivery faults in child processes via env
    # (KOLIBRIE_FAULT_PLAN JSON); a no-op in production where it is unset
    from kolibrie_tpu_torch.resilience import faultinject

    plan = faultinject.plan_from_env()
    if plan is not None:
        faultinject.install(plan)
    httpd = make_server(
        host,
        port,
        data_dir=data_dir,
        repl_port=int(repl_port_raw) if repl_port_raw else None,
        repl_source=repl_source,
        repl_poll_interval_s=float(
            os.environ.get("KOLIBRIE_REPL_POLL_INTERVAL_S", "0.15")
        ),
        repl_seal_interval_s=float(
            os.environ.get("KOLIBRIE_REPL_SEAL_INTERVAL_S", "0.25")
        ),
        device=device,
    )

    def _on_sigterm(signum, frame):
        # drain on a worker thread: the handler itself must return fast,
        # and serve_forever unblocks when shutdown() is called
        threading.Thread(
            target=shutdown_gracefully, args=(httpd,), daemon=True
        ).start()

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        pass  # not the main thread (embedded in tests)
    state = httpd.RequestHandlerClass.state
    if data_dir:
        # an uncaught fatal error on the serving process leaves a bundle
        flightrec.install_excepthook(
            data_dir, stats_fn=lambda: obs_export.build_stats(state)
        )
    _log.info("listening", host=host, port=port, url=f"http://{host}:{port}")
    if data_dir:
        _log.info("durable data dir", data_dir=data_dir)
    if repl_source:
        _log.info("replicating (read-only follower)", source=repl_source)
    elif state.replication is not None:
        _log.info("shipping WAL segments", port=state.replication.port)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        shutdown_gracefully(httpd)


if __name__ == "__main__":
    import sys

    serve(
        sys.argv[1] if len(sys.argv) > 1 else "127.0.0.1",
        int(sys.argv[2]) if len(sys.argv) > 2 else 7878,
    )
