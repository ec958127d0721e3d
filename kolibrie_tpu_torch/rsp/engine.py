"""RSPEngine — the streaming orchestrator.

Parity: ``kolibrie/src/rsp_engine.rs`` — per-window processors (evict the
previous firing, add content, materialize, execute the window plan;
``create_window_processor!`` :102-188), SingleThread (callback) vs
MultiThread (queue + thread) registration (:191-212), the multi-window
coordinator joining the latest window results + static data under the
``SyncPolicy`` (Steal / Wait / Timeout{Steal,Drop}; :488-660), shared
dictionary between query plans and the R2R store (:272-293), a separate
static background database (:296-300), opt-in cross-window SDS+ mode where
raw (Triple, ts) window contents are routed to the coordinator which runs
``incremental_sds_plus`` / ``naive_sds_plus`` per cycle (:114-135, :1059+),
and R2S applied at emission (:449-460).

Port of ``kolibrie_tpu/rsp/engine.py``.  The engine runs on ``device``
(the CUDA card unless the caller passes another): the R2R store and the
static database live there, and every window query runs there (the
device program from 100,000 window triples, the host engine below, as
``execution_mode`` "auto" routes it).  ``r2r_mode`` None or ``"auto"`` means ``"device"``
(:class:`DeviceR2R`); ``"host"`` closes each firing with the host strategy
(:class:`SimpleR2R`); ``"incremental"`` carries the closure across firings
as expiration provenance (:class:`IncrementalR2R`, one window; several
windows take :class:`SimpleR2R`, as in the reference).  Cross-window SDS+
cycles build their reasoners and per-window databases on the same device.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from kolibrie_tpu_torch.backend import DeviceLike
from kolibrie_tpu_torch.core.rule import Rule
from kolibrie_tpu_torch.core.triple import Triple
from kolibrie_tpu_torch.obs import metrics as _obs_metrics
from kolibrie_tpu_torch.obs.spans import span as _obs_span
from kolibrie_tpu_torch.query.ast import (
    SelectQuery,
    SyncPolicy,
    SyncPolicyKind,
    TimeoutFallback,
)
from kolibrie_tpu_torch.query.executor import eval_select_to_table, format_results, table_header
from kolibrie_tpu_torch.query.sparql_database import SparqlDatabase
from kolibrie_tpu_torch.reasoner.cross_window import (
    Sds,
    SdsWithExpiry,
    WindowData,
    WindowedTriple,
    all_component_iris,
    incremental_sds_plus,
    naive_sds_plus,
    sds_with_expiry_to_external,
)
from kolibrie_tpu_torch.reasoner.n3_parser import WindowContext
from kolibrie_tpu_torch.rsp.r2r import DeviceR2R, IncrementalR2R, SimpleR2R
from kolibrie_tpu_torch.rsp.r2s import Relation2StreamOperator, StreamOperator
from kolibrie_tpu_torch.rsp.s2r import ContentContainer, WindowTriple
from kolibrie_tpu_torch.rsp.window_runner import WindowRunner, WindowSpec

# Streaming health metrics (docs/OBSERVABILITY.md).  Window IRIs come
# from registered queries, so the label set is bounded by configuration.
_WINDOW_FIRE_LAT = _obs_metrics.histogram(
    "kolibrie_rsp_window_fire_seconds",
    "window firing (R2R materialize + query) wall time",
    labels=("window",),
)
_EVENT_LAG = _obs_metrics.histogram(
    "kolibrie_rsp_event_lag",
    "event-time lag at firing: engine high-water timestamp minus the "
    "firing's last-changed timestamp (logical time units)",
    labels=("window",),
    buckets=_obs_metrics.DEFAULT_COUNT_BUCKETS,
)
_CLOSE_TO_EMIT = _obs_metrics.histogram(
    "kolibrie_rsp_close_to_emit_seconds",
    "wall time from the earliest pending window firing to result emission",
)

ResultRow = Tuple[Tuple[str, str], ...]  # sorted (var, value) pairs


class OperationMode:
    SINGLE_THREAD = "single"
    MULTI_THREAD = "multi"


class CrossWindowReasoningMode:
    INCREMENTAL = "incremental"
    NAIVE = "naive"
    # AUTO picks per cycle: incremental maintenance when the fraction of
    # window content not seen last cycle is small, full recomputation
    # otherwise.  The reference offers only a static choice
    # (rsp_engine.rs CrossWindowReasoningMode); the measured crossover
    # makes the per-cycle decision automatic here.
    AUTO = "auto"


# AUTO threshold, carried from the JAX package (its own sweep,
# benches/bench_cross_window.py + bench_family_tree.py: incremental won
# 1.4-2x at 1-2% updates and broke even at 10%).  PERF.md records the
# port's sweep on the H100 (chip_profile.py::profile_churn_sweep).
_AUTO_MAX_CHURN = 0.08


@dataclass
class RSPWindowConfig:
    window_iri: str
    stream_iri: str
    width: int
    slide: int
    report: str
    tick: str
    query: SelectQuery  # per-window plan


@dataclass
class WindowResult:
    window_iri: str
    results: List[Dict[str, str]]
    timestamp: int
    raw_triples: List[Tuple[Triple, int]] = field(default_factory=list)


def natural_join_maps(
    left: List[Dict[str, str]], right: List[Dict[str, str]]
) -> List[Dict[str, str]]:
    """Natural join of binding-map sets (rsp_engine.rs:900-934).

    Window result rows share uniform headers, so the join keys are fixed
    per call and the pairing is a HASH join (build on right, probe left) —
    this is the multi-window coordinator's hot loop; the naive pairwise
    scan made it O(|left|·|right|) per firing.  Heterogeneous rows (not
    produced by the engine, but allowed by the signature) keep the exact
    pairwise semantics via the fallback."""
    if not left or not right:
        return []
    lkeys, rkeys = left[0].keys(), right[0].keys()
    if any(b.keys() != lkeys for b in left) or any(
        b.keys() != rkeys for b in right
    ):
        out = []
        for lb in left:
            for rb in right:
                if all(rb.get(k, v) == v for k, v in lb.items()):
                    merged = dict(lb)
                    merged.update(rb)
                    out.append(merged)
        return out
    shared = tuple(k for k in lkeys if k in rkeys)
    if not shared:
        return [{**lb, **rb} for lb in left for rb in right]
    index: Dict[tuple, List[Dict[str, str]]] = {}
    for rb in right:
        index.setdefault(tuple(rb[k] for k in shared), []).append(rb)
    out = []
    for lb in left:
        for rb in index.get(tuple(lb[k] for k in shared), ()):
            merged = dict(lb)
            merged.update(rb)
            out.append(merged)
    return out


def join_window_results(
    buffers: Dict[str, List[Dict[str, str]]]
) -> List[Dict[str, str]]:
    if not buffers:
        return []
    parts = list(buffers.values())
    joined = parts[0]
    for p in parts[1:]:
        joined = natural_join_maps(joined, p)
    return joined


def _ckpt_encode(x):
    """Checkpoint-blob value encoding (the reference's format): JSON-safe
    tagged forms for the types that flow through window/R2S/SDS+ state.  Fails LOUD on anything
    else — a silently lossy checkpoint is worse than no checkpoint."""
    if isinstance(x, WindowTriple):
        return ["wt", x.s, x.p, x.o]
    if isinstance(x, Triple):
        return ["tr", x.subject, x.predicate, x.object]
    if isinstance(x, tuple):
        return ["u", [_ckpt_encode(v) for v in x]]
    if isinstance(x, list):
        return ["l", [_ckpt_encode(v) for v in x]]
    if isinstance(x, (set, frozenset)):
        return ["set", [_ckpt_encode(v) for v in x]]
    if isinstance(x, dict):
        return ["d", [[_ckpt_encode(k), _ckpt_encode(v)] for k, v in x.items()]]
    if x is None or isinstance(x, (str, int, float, bool)):
        return ["v", x]
    raise TypeError(f"unsupported checkpoint value type {type(x).__name__}")


def _ckpt_decode(x):
    tag, *rest = x
    if tag == "wt":
        return WindowTriple(*rest)
    if tag == "tr":
        return Triple(*rest)
    if tag == "u":
        return tuple(_ckpt_decode(v) for v in rest[0])
    if tag == "l":
        return [_ckpt_decode(v) for v in rest[0]]
    if tag == "set":
        return {_ckpt_decode(v) for v in rest[0]}
    if tag == "d":
        return {_ckpt_decode(k): _ckpt_decode(v) for k, v in rest[0]}
    if tag == "v":
        return rest[0]
    raise ValueError(f"unknown checkpoint tag {tag!r}")


class RSPEngine:
    def __init__(
        self,
        window_configs: List[RSPWindowConfig],
        stream_type: str = StreamOperator.RSTREAM,
        consumer: Optional[Callable[[ResultRow], None]] = None,
        operation_mode: str = OperationMode.SINGLE_THREAD,
        sync_policy: Optional[SyncPolicy] = None,
        static_query: Optional[SelectQuery] = None,
        static_data: str = "",
        initial_triples: str = "",
        syntax: str = "turtle",
        rules: str = "",
        cross_window_rules: Optional[List[Rule]] = None,
        cross_window_context: Optional[WindowContext] = None,
        cross_window_mode: str = CrossWindowReasoningMode.INCREMENTAL,
        cross_window_rules_text: Optional[str] = None,
        r2r_mode: Optional[str] = None,
        supervision=None,
        device: DeviceLike = None,
    ):
        self.window_configs = window_configs
        self.operation_mode = operation_mode
        # window supervision policy (resilience.supervisor): None uses the
        # defaults (retry-once + dead-letter, bounded restarts, no
        # supervisor-driven checkpoints)
        self.supervision = supervision
        self.sync_policy = sync_policy or SyncPolicy(SyncPolicyKind.STEAL)
        self.consumer = consumer or (lambda row: None)

        # R2R store; one dictionary shared across store, static db, plans.
        # r2r_mode: "device" (None, "auto") = device-resident window columns
        # + device fixpoint (DeviceR2R); "host" = host closure per firing;
        # "incremental" = expiration-provenance closure carried across
        # firings (IncrementalR2R).
        if r2r_mode in (None, "auto", "device"):
            self.r2r = DeviceR2R(SparqlDatabase(device=device))
        elif r2r_mode == "host":
            self.r2r = SimpleR2R(SparqlDatabase(device=device))
        elif r2r_mode == "incremental":
            if len(window_configs) > 1:
                # the single prune clock is only exact for one window;
                # multi-window incremental reasoning is the cross-window
                # SDS+ path's job (per-window expiries) — see
                # IncrementalR2R's exactness-domain note
                self.r2r = SimpleR2R(SparqlDatabase(device=device))
            else:
                self.r2r = IncrementalR2R(SparqlDatabase(device=device))
        else:
            raise ValueError(f"unknown r2r_mode {r2r_mode!r}")
        self.dictionary = self.r2r.db.dictionary
        self.static_db = SparqlDatabase(device=self.r2r.db.device)
        self.static_db.dictionary = self.dictionary
        self.static_db.quoted = self.r2r.db.quoted
        if static_data:
            self.static_db.parse_turtle(static_data)
        if initial_triples:
            self.r2r.load_triples(initial_triples, syntax)
        if rules:
            self.r2r.load_rules(rules)

        self.static_query = static_query
        self.r2s = Relation2StreamOperator(stream_type, 0)
        self._store_lock = threading.Lock()
        self._result_queue: "queue.Queue[WindowResult]" = queue.Queue()
        # observability: engine-wide event-time high water (drives the
        # per-window lag metric) and start times of window firings whose
        # results are still queued (drives close-to-emit latency); races
        # on these only skew a metric, never a result
        self._max_event_ts = 0
        self._fire_t0: Dict[str, float] = {}  # guarded by: _cw_lock
        self._cw_lock = threading.Lock()

        # single-thread coordination state
        self._st_last_materialized: Dict[str, List[Dict[str, str]]] = {}
        # cross-window state (rules may arrive pre-parsed or as N3 text,
        # which is parsed against THIS engine's dictionary so IDs align)
        if cross_window_rules_text:
            from kolibrie_tpu_torch.reasoner.n3_parser import parse_n3_rules_for_sds

            window_iris = [c.window_iri for c in window_configs]
            cross_window_rules, cross_window_context = parse_n3_rules_for_sds(
                cross_window_rules_text, self.dictionary, window_iris
            )
        self.cross_window_enabled = cross_window_rules is not None
        self.cross_window_rules = cross_window_rules or []
        self.cross_window_context = cross_window_context
        self.cross_window_mode = cross_window_mode
        self._sds_plus_state: SdsWithExpiry = {}  # guarded by: _cw_lock
        self._latest_contents: Dict[str, List[Tuple[Triple, int]]] = {}  # guarded by: _cw_lock
        self._cw_lock = threading.Lock()
        # AUTO-mode churn baseline: written by the coordinator each
        # cross-window cycle and reset by restore_state
        self._auto_prev_alive: Optional[frozenset] = None  # guarded by: _cw_lock

        self._has_joins = (
            len(window_configs) > 1
            or self.static_query is not None
            or self.cross_window_enabled
        )

        from kolibrie_tpu_torch.optimizer import mqo as _mqo

        self.windows: List[WindowRunner] = []
        for cfg in window_configs:
            # every standing window registers with the store's MQO
            # registry; the runner's on_stop unregisters it
            _mqo.register_standing(self.r2r.db, cfg.window_iri)
            runner = WindowRunner(
                WindowSpec(
                    cfg.window_iri,
                    cfg.stream_iri,
                    cfg.width,
                    cfg.slide,
                    cfg.report,
                    cfg.tick,
                    standing_owner=cfg.window_iri,
                    on_stop=(
                        lambda db=self.r2r.db, owner=cfg.window_iri: (
                            _mqo.unregister_standing(db, owner)
                        )
                    ),
                )
            )
            self.windows.append(runner)
        self._register_windows()
        if self.operation_mode == OperationMode.MULTI_THREAD and self._has_joins:
            self._start_coordinator()

    # ---------------------------------------------------------- registration

    def _make_processor(self, cfg: RSPWindowConfig):
        """Window processor closure (create_window_processor! parity)."""
        prev_window_triples: List = []

        def fire(content: ContentContainer, ts: int):
            if self.cross_window_enabled:
                raw: List[Tuple[Triple, int]] = []
                for item, event_ts in content.iter_with_timestamps():
                    raw.append((self._item_to_triple(item), event_ts))
                self._result_queue.put(
                    WindowResult(cfg.window_iri, [], ts, raw)
                )
                return
            with self._store_lock:
                if isinstance(self.r2r, IncrementalR2R):
                    # delta-incremental: reconcile full content (overlap is
                    # O(1) per re-fed item), closure seeded with the delta
                    self.r2r.feed_window(
                        cfg.window_iri,
                        cfg.width,
                        content.iter_with_timestamps(),
                    )
                    self.r2r.materialize_incremental()
                else:
                    for t in prev_window_triples:
                        self.r2r.remove(t)
                    prev_window_triples.clear()
                    for item in content:
                        prev_window_triples.append(item)
                        self.r2r.add(item)
                    self.r2r.materialize()
                # fire-time registration scope (bookkeeping with MQO off)
                from kolibrie_tpu_torch.optimizer import mqo as _mqo

                with _mqo.standing_scope(self.r2r.db, cfg.window_iri):
                    results = self.r2r.execute_query(cfg.query)
            if self._has_joins:
                mapped = [dict(row) for row in results]
                self._result_queue.put(WindowResult(cfg.window_iri, mapped, ts))
            else:
                filtered = self.r2s.eval(results, ts)
                for row in filtered:
                    self.consumer(row)

        def processor(content: ContentContainer):
            ts = content.get_last_timestamp_changed()
            _EVENT_LAG.labels(cfg.window_iri).observe(
                max(0, self._max_event_ts - ts)
            )
            if self.cross_window_enabled or self._has_joins:
                # result rides _result_queue: emission happens later, in
                # _emit — remember the EARLIEST pending fire start
                with self._cw_lock:
                    self._fire_t0.setdefault(
                        cfg.window_iri, time.perf_counter()
                    )
            t0 = time.perf_counter()
            with _obs_span("rsp.window.fire", window=cfg.window_iri):
                fire(content, ts)
            _WINDOW_FIRE_LAT.labels(cfg.window_iri).observe(
                time.perf_counter() - t0
            )

        return processor

    def _item_to_triple(self, item) -> Triple:
        if isinstance(item, Triple):
            return item
        if isinstance(item, WindowTriple):
            return Triple(
                self.r2r.db.encode_term_str(item.s),
                self.r2r.db.encode_term_str(item.p),
                self.r2r.db.encode_term_str(item.o),
            )
        raise TypeError(f"unsupported stream item {item!r}")

    def _register_windows(self) -> None:
        """Register per-window processors UNDER SUPERVISION
        (resilience.supervisor): a processor exception is retried then
        dead-lettered instead of killing the window; a WindowCrash in
        multi-thread mode restarts the worker loop with bounded
        exponential backoff, restoring the engine from the supervisor's
        last checkpoint when one exists.  In single-thread mode a crash
        propagates to the pusher."""
        from kolibrie_tpu_torch.resilience.supervisor import WindowSupervisor

        self._window_receivers: List[queue.Queue] = []
        self.supervisors: List[WindowSupervisor] = []
        self._window_threads: List[threading.Thread] = []
        for cfg, runner in zip(self.window_configs, self.windows):
            processor = self._make_processor(cfg)
            sup = WindowSupervisor(
                cfg.window_iri,
                config=self.supervision,
                checkpoint_fn=self.checkpoint_state,
                restore_fn=self.restore_state,
            )
            self.supervisors.append(sup)
            if self.operation_mode == OperationMode.SINGLE_THREAD:
                runner.register_callback(sup.wrap(processor))
            else:
                receiver = runner.register()
                self._window_receivers.append(receiver)
                self._window_threads.append(sup.spawn(receiver, processor))

    # ------------------------------------------------------------ streaming

    @staticmethod
    def _normalize_stream_iri(s: str) -> str:
        s = s.strip().lstrip("<").rstrip(">")
        return s[1:] if s.startswith(":") else s

    def add_to_stream(self, stream_iri: str, item, ts: int) -> None:
        """Route an event to the windows listening on this stream
        (rsp_engine.rs:693-731)."""
        if self.operation_mode == OperationMode.SINGLE_THREAD and self._has_joins:
            self.process_single_thread_window_results()
        if ts > self._max_event_ts:
            self._max_event_ts = ts
        input_norm = self._normalize_stream_iri(stream_iri)
        for cfg, runner in zip(self.window_configs, self.windows):
            if cfg.stream_iri.startswith("?"):
                runner.add_to_window(item, ts)
                continue
            if self._normalize_stream_iri(cfg.stream_iri) == input_norm:
                runner.add_to_window(item, ts)

    def add(self, item, ts: int) -> None:
        """Convenience: feed every window (single-stream engines)."""
        if self.operation_mode == OperationMode.SINGLE_THREAD and self._has_joins:
            self.process_single_thread_window_results()
        if ts > self._max_event_ts:
            self._max_event_ts = ts
        for runner in self.windows:
            runner.add_to_window(item, ts)

    def flush_windows(self) -> None:
        for runner in self.windows:
            runner.flush()
        if self.operation_mode == OperationMode.SINGLE_THREAD and self._has_joins:
            self.process_single_thread_window_results()

    # --------------------------------------------------- single-thread drain

    def process_single_thread_window_results(self) -> None:
        """Drain pending window results and emit when every window has
        materialized (rsp_engine.rs:735-800; note the reference ACCUMULATES
        single-thread results per window rather than replacing)."""
        had_new = False
        max_ts = 0
        while True:
            try:
                wr = self._result_queue.get_nowait()
            except queue.Empty:
                break
            had_new = True
            max_ts = max(max_ts, wr.timestamp)
            self._st_last_materialized.setdefault(wr.window_iri, []).extend(
                wr.results
            )
            if self.cross_window_enabled:
                with self._cw_lock:
                    self._latest_contents[wr.window_iri] = list(wr.raw_triples)
        if not had_new:
            return
        if len(self._st_last_materialized) == len(self.windows):
            if self.cross_window_enabled:
                self._emit_cross_window(max_ts)
            else:
                self._emit(self._st_last_materialized, max_ts)
            self._st_last_materialized = {}

    # ------------------------------------------------------------ coordinator

    def _start_coordinator(self) -> None:
        def run():
            last_materialized: Dict[str, List[Dict[str, str]]] = {}
            cycle_triggered: set = set()
            cycle_start: Optional[float] = None
            max_ts = 0
            num_windows = len(self.windows)
            policy = self.sync_policy
            while True:
                timeout: Optional[float] = None
                if policy.kind == SyncPolicyKind.TIMEOUT and cycle_start is not None:
                    timeout = max(
                        policy.timeout_ms / 1000.0 - (time.monotonic() - cycle_start),
                        0.0,
                    )
                try:
                    wr = self._result_queue.get(timeout=timeout)
                except queue.Empty:
                    # deadline elapsed
                    if cycle_triggered:
                        if policy.fallback == TimeoutFallback.STEAL:
                            if len(last_materialized) == num_windows:
                                if self.cross_window_enabled:
                                    self._emit_cross_window(max_ts)
                                else:
                                    self._emit(last_materialized, max_ts)
                        # Drop: discard the cycle
                        cycle_triggered.clear()
                        cycle_start = None
                        max_ts = 0
                    continue
                if wr is None:
                    break
                max_ts = max(max_ts, wr.timestamp)
                last_materialized[wr.window_iri] = list(wr.results)
                if self.cross_window_enabled:
                    with self._cw_lock:
                        self._latest_contents[wr.window_iri] = list(wr.raw_triples)
                if not cycle_triggered:
                    cycle_start = time.monotonic()
                cycle_triggered.add(wr.window_iri)
                # drain pending
                while True:
                    try:
                        extra = self._result_queue.get_nowait()
                    except queue.Empty:
                        break
                    if extra is None:
                        return
                    max_ts = max(max_ts, extra.timestamp)
                    last_materialized[extra.window_iri] = list(extra.results)
                    if self.cross_window_enabled:
                        with self._cw_lock:
                            self._latest_contents[extra.window_iri] = list(
                                extra.raw_triples
                            )
                    cycle_triggered.add(extra.window_iri)
                if len(cycle_triggered) == num_windows:
                    if self.cross_window_enabled:
                        self._emit_cross_window(max_ts)
                    else:
                        self._emit(last_materialized, max_ts)
                    cycle_triggered.clear()
                    cycle_start = None
                    max_ts = 0
                elif policy.kind == SyncPolicyKind.STEAL:
                    # emit immediately with stale data from non-firing windows
                    if len(last_materialized) == num_windows:
                        if self.cross_window_enabled:
                            self._emit_cross_window(max_ts)
                        else:
                            self._emit(last_materialized, max_ts)
                    cycle_triggered.clear()
                    cycle_start = None
                    max_ts = 0
                # Wait / Timeout: keep waiting for remaining windows

        # kolint: ignore[KL401] the coordinator is engine-lifetime, not per-request: its emissions aggregate many pushes, so no single submitter trace/deadline is the right scope
        self._coordinator = threading.Thread(target=run, daemon=True)
        self._coordinator.start()

    # -------------------------------------------------------------- emission

    def _static_bindings(self) -> List[Dict[str, str]]:
        if self.static_query is None:
            return []
        table = eval_select_to_table(self.static_db, self.static_query)
        header = table_header(table, self.static_query)
        rows = format_results(self.static_db, table, self.static_query)
        return [dict(zip(header, row)) for row in rows]

    def _emit(
        self, last_materialized: Dict[str, List[Dict[str, str]]], ts: int
    ) -> None:
        """Join windows (+static), apply R2S, feed the consumer
        (emit_results, rsp_engine.rs:864-897)."""
        joined = join_window_results(last_materialized)
        if self.static_query is not None:
            static = self._static_bindings()
            joined = natural_join_maps(joined, static)
        outputs: List[ResultRow] = [
            tuple(sorted(b.items())) for b in joined
        ]
        for row in self.r2s.eval(outputs, ts):
            self.consumer(row)
        with self._cw_lock:
            pending = list(self._fire_t0.values())
            self._fire_t0.clear()
        if pending:
            _CLOSE_TO_EMIT.observe(time.perf_counter() - min(pending))

    # ---------------------------------------------------------- cross-window

    def _build_sds(self) -> Sds:
        sds = Sds()
        dec = self.dictionary.decode
        enc = self.dictionary.encode
        with self._cw_lock:
            latest = {k: list(v) for k, v in self._latest_contents.items()}
        # Per-cycle wrapper memo: window contents evolve incrementally, so
        # reusing each event's WindowedTriple (with its pre-computed encode
        # memo) makes the SDS translation cost track NEW arrivals, not
        # window size.  Rebuilt from live entries each cycle -> bounded.
        old_cache = getattr(self, "_wt_cache", {})
        new_cache = {}
        annot = getattr(self, "_annot_pred_cache", {})
        # kolint: ignore[KL311] per-cycle memo confined to the emission path: _build_sds runs only on the coordinator (or the sole pusher in callback mode), never both in one engine
        self._annot_pred_cache = annot
        for cfg in self.window_configs:
            triples: List[WindowedTriple] = []
            for t, event_time in latest.get(cfg.window_iri, []):
                key = (cfg.window_iri, t, event_time)
                wt = old_cache.get(key)
                if wt is None:
                    s = dec(t.subject)
                    p = dec(t.predicate)
                    o = dec(t.object)
                    if s is None or p is None or o is None:
                        continue
                    wt = WindowedTriple(s, p, o, event_time)
                    pkey = (cfg.window_iri, t.predicate)
                    pid = annot.get(pkey)
                    if pid is None:
                        from kolibrie_tpu_torch.reasoner.cross_window import (
                            annotate_predicate,
                        )

                        pid = enc(annotate_predicate(cfg.window_iri, p))
                        annot[pkey] = pid
                    # pre-seed the translation memo: ids are already known
                    wt._enc = (
                        self.dictionary,
                        cfg.window_iri,
                        t.subject,
                        pid,
                        t.object,
                    )
                new_cache[key] = wt
                triples.append(wt)
            sds.windows[cfg.window_iri] = WindowData(cfg.width, triples)
        # kolint: ignore[KL311] same emission-path confinement as _annot_pred_cache above
        self._wt_cache = new_cache
        if self.cross_window_context is not None:
            for iri in self.cross_window_context.output_iris:
                sds.output_iris.add(iri)
        static_triples = [
            (s, p, o)
            for s, p, o in self.static_db.iter_decoded()
            if s is not None and p is not None and o is not None
        ]
        if static_triples:
            sds.static_graphs["urn:kolibrie:static:"] = static_triples
        return sds

    def _auto_mode(self, sds) -> str:
        """Per-cycle mode choice for AUTO: measure churn (window content
        unseen last cycle) against the crossover threshold.  A naive cycle
        clears the incremental state; re-entering incremental from empty
        state pays one full provenance recompute (semantically identical
        to naive — the agreement tests start incremental from empty) and
        then resumes cheap maintenance.

        Cost note: the snapshot walk is O(window contents) per cycle —
        the same order as ``_build_sds``'s unconditional SDS rebuild that
        every mode already pays; incremental's savings are in the
        REASONING, which dominates both."""
        # identity EXCLUDES event_time: a re-observed triple with a newer
        # timestamp is an expiry improvement, which incremental maintenance
        # handles cheaply — only genuinely new content counts as churn
        cur = frozenset(
            (iri, wt.subject, wt.predicate, wt.object)
            for iri, wd in sds.windows.items()
            for wt in wd.triples
        )
        with self._cw_lock:
            prev = self._auto_prev_alive
            self._auto_prev_alive = cur
        if prev is None or not cur:
            return CrossWindowReasoningMode.INCREMENTAL
        churn = len(cur - prev) / len(cur)
        return (
            CrossWindowReasoningMode.INCREMENTAL
            if churn <= _AUTO_MAX_CHURN
            else CrossWindowReasoningMode.NAIVE
        )

    def _emit_cross_window(self, ts: int) -> None:
        """SDS+ cycle + per-window plans over derived buckets
        (emit_cross_window_results, rsp_engine.rs:1059-1112)."""
        sds = self._build_sds()
        mode = self.cross_window_mode
        if mode == CrossWindowReasoningMode.AUTO:
            mode = self._auto_mode(sds)
        if mode == CrossWindowReasoningMode.INCREMENTAL:
            # checkpoint_state() snapshots _sds_plus_state under _cw_lock
            # from pusher threads; read and publish under the same lock so
            # a checkpoint never sees a half-written cycle
            with self._cw_lock:
                prev_state = self._sds_plus_state
            new_state = incremental_sds_plus(
                self.cross_window_rules, sds, prev_state, self.dictionary, ts,
                device=self.r2r.db.device,
            )
            with self._cw_lock:
                self._sds_plus_state = new_state
            buckets = sds_with_expiry_to_external(
                new_state, self.dictionary, all_component_iris(sds)
            )
        else:
            with self._cw_lock:
                self._sds_plus_state = {}  # stale for later incremental cycles
            buckets = naive_sds_plus(
                self.cross_window_rules, sds, self.dictionary, ts,
                device=self.r2r.db.device,
            )
        materialized: Dict[str, List[Dict[str, str]]] = {}
        for cfg in self.window_configs:
            db = SparqlDatabase(device=self.r2r.db.device)
            db.dictionary = self.dictionary
            db.quoted = self.r2r.db.quoted
            for t in buckets.get(cfg.window_iri, []):
                db.add_triple(t)
            table = eval_select_to_table(db, cfg.query)
            header = table_header(table, cfg.query)
            rows = format_results(db, table, cfg.query)
            materialized[cfg.window_iri] = [dict(zip(header, row)) for row in rows]
        self._emit(materialized, ts)

    # -------------------------------------------------- preemption/restart

    def checkpoint_state(self) -> bytes:
        """Serialize the engine's RESUMABLE state in the reference's format
        (version 2): per-window S2R operator state (t_0, app_time,
        open-window contents), the R2S stream-operator memory
        (``last_result`` — what ISTREAM/DSTREAM diff against), the
        cross-window SDS+ expiry state, and the coordinator's latest raw
        window contents.  NOT captured (configuration,
        re-supplied when the engine is rebuilt): queries, rules, static
        data, sync policy, and the R2R store — window materializations are
        recomputed at the next firing from the restored window contents.

        The blob is JSON (``_ckpt_encode``), NOT pickle: unpickling
        untrusted bytes is arbitrary code execution.  Callers must quiesce
        event pushes for the duration; ``_cw_lock`` covers only the
        cross-window state."""
        import json

        with self._cw_lock:
            state = {
                "version": 2,
                "windows": [
                    {
                        "t_0": r.window.t_0,
                        "app_time": r.window.app_time,
                        "active": [
                            [
                                w.open,
                                w.close,
                                [
                                    [_ckpt_encode(item), ts]
                                    for item, ts in c.elements.items()
                                ],
                                c.last_timestamp_changed,
                                c.origin,
                            ]
                            for w, c in r.window.active_windows.items()
                        ],
                    }
                    for r in self.windows
                ],
                "r2s_last": [_ckpt_encode(x) for x in self.r2s.last_result],
                "sds_plus": [
                    [_ckpt_encode(k), _ckpt_encode(v)]
                    for k, v in self._sds_plus_state.items()
                ],
                "latest_contents": {
                    k: [[_ckpt_encode(t), ts] for t, ts in v]
                    for k, v in self._latest_contents.items()
                },
            }
        return json.dumps(state).encode("utf-8")

    def restore_state(self, blob: bytes) -> None:
        """Restore a :meth:`checkpoint_state` snapshot (this engine's or
        the reference's) into THIS engine (built with the same window
        configs / queries / rules).  Events added afterwards continue the
        stream exactly where the snapshot left off.  Safe on untrusted
        input (pure JSON, no pickle)."""
        import json

        from kolibrie_tpu_torch.rsp.s2r import Window

        state = json.loads(blob.decode("utf-8"))
        if state.get("version") != 2:
            raise ValueError(f"unknown checkpoint version {state.get('version')!r}")
        if len(state["windows"]) != len(self.windows):
            raise ValueError("checkpoint window count != engine window count")
        with self._cw_lock:
            for r, ws in zip(self.windows, state["windows"]):
                win = r.window
                win.t_0 = ws["t_0"]
                win.app_time = ws["app_time"]
                win.active_windows = {}
                for open_, close, elements, last_ts, origin in ws["active"]:
                    c = ContentContainer(origin)
                    c.elements = {
                        _ckpt_decode(item): ts for item, ts in elements
                    }
                    c.last_timestamp_changed = last_ts
                    win.active_windows[Window(open_, close)] = c
            self.r2s.last_result = {
                _ckpt_decode(x) for x in state["r2s_last"]
            }
            self._sds_plus_state = {
                _ckpt_decode(k): _ckpt_decode(v)
                for k, v in state["sds_plus"]
            }
            self._latest_contents = {
                k: [(_ckpt_decode(t), ts) for t, ts in v]
                for k, v in state["latest_contents"].items()
            }
            # AUTO churn baseline is post-checkpoint transient state — a
            # stale baseline would mis-classify the first restored cycle
            self._auto_prev_alive = None

    # ----------------------------------------------------------------- misc

    @property
    def dead_letters(self):
        """All dead-lettered window firings, across windows."""
        out = []
        for sup in getattr(self, "supervisors", []):
            out.extend(sup.dead_letters)
        return out

    def resilience_stats(self) -> dict:
        """Per-window supervisor snapshot (processed / retried / restarts
        / dead-letter counts)."""
        return {
            "windows": [s.snapshot() for s in getattr(self, "supervisors", [])]
        }

    def mqo_stats(self) -> dict:
        """Standing-query registry snapshot for this engine's store."""
        from kolibrie_tpu_torch.optimizer import mqo as _mqo

        return _mqo.stats(self.r2r.db)

    def stop(self) -> None:
        for runner in self.windows:
            runner.stop()
        # unblock per-window worker threads (multi-thread mode) and the
        # coordinator with shutdown sentinels
        for recv in getattr(self, "_window_receivers", []):
            recv.put(None)
        self._result_queue.put(None)  # type: ignore[arg-type]


# Debug-build runtime check of the # guarded by: annotations above
# (no-op unless KOLIBRIE_DEBUG_LOCKS=1 — see analysis/lockcheck.py)
from kolibrie_tpu_torch.analysis import lockcheck as _lockcheck  # noqa: E402

_lockcheck.auto_instrument(globals())
