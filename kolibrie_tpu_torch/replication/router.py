"""Template-affinity front router for a replica fleet.

A thin stdlib HTTP proxy that knows three things about the fleet:

- **who is healthy** — a probe thread polls every replica's ``/healthz``
  (role, status, replication watermark); ``evict_after`` consecutive
  failures evicts a replica from routing until a probe succeeds again.
- **where a template lives** — read queries are placed by rendezvous
  (highest-random-weight) hashing over a TEMPLATE key: the query text
  with literals/IRIs/numbers masked.  Two instantiations of the same
  template always land on the same replica, so that replica's plan
  cache, compile cache, and MQO shared-prefix registry stay hot for the
  template while other replicas never pay its warmup (docs/MQO.md,
  docs/COMPILE_CACHE.md).  Rendezvous hashing keeps the map stable under
  eviction: only the evicted replica's templates move.
- **who is primary** — writes forward to the primary; a follower
  answering 409 ``not_primary`` re-aims the request.  When the primary
  stays unprobeable the promotion supervisor picks the follower with the
  HIGHEST DURABLE WATERMARK ``(applied_segment, applied_records)`` and
  POSTs ``/admin/promote`` — highest watermark wins, because a follower
  can only apply whole sealed segments and the acked-write token for any
  acknowledged mutation is covered by some sealed segment.

Retries are deadline-aware: each request carries a budget
(``X-Kolibrie-Deadline-Ms`` or the router default) and failed attempts
back off exponentially but never past the remaining budget.

Copy of ``kolibrie_tpu/replication/router.py`` for the PyTorch port, its imports
rewritten.
"""

from __future__ import annotations

import hashlib
import json
import re
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from kolibrie_tpu_torch.obs import log as obslog
from kolibrie_tpu_torch.obs import metrics as obs_metrics
from kolibrie_tpu_torch.obs import promtext
from kolibrie_tpu_torch.obs import spans as obs_spans

DEFAULT_BUDGET_MS = 10_000.0
MAX_BODY_BYTES = 64 * 1024 * 1024
DEFAULT_FLEET_CACHE_TTL_S = 1.0

_log = obslog.get_logger("router")

_ROUTER_REQS = obs_metrics.counter(
    "kolibrie_router_requests_total",
    "requests routed, by route and outcome",
    labels=("route", "outcome"),
)
_ROUTER_RETRIES = obs_metrics.counter(
    "kolibrie_router_retries_total", "upstream attempts beyond the first"
)
_ROUTER_EVICTIONS = obs_metrics.counter(
    "kolibrie_router_evictions_total", "replicas evicted by the prober"
)
_ROUTER_PROMOTIONS = obs_metrics.counter(
    "kolibrie_router_promotions_total", "follower promotions ordered"
)
_ROUTER_UPSTREAM_LAT = obs_metrics.histogram(
    "kolibrie_router_upstream_seconds",
    "upstream request wall time per replica",
    labels=("replica",),
)
_ROUTER_PROBE_FAILURES = obs_metrics.counter(
    "kolibrie_router_probe_failures_total",
    "health probes that failed (connect/parse), per replica",
    labels=("replica",),
)
_ROUTER_UPSTREAM_ERRORS = obs_metrics.counter(
    "kolibrie_router_upstream_errors_total",
    "forward attempts that failed at the transport layer, per replica",
    labels=("replica",),
)
_ROUTER_PROMOTE_FAILURES = obs_metrics.counter(
    "kolibrie_router_promote_failures_total",
    "promotion orders that failed (the supervisor retries next round)",
)
_ROUTER_FAILOVER_SECONDS = obs_metrics.histogram(
    "kolibrie_router_failover_seconds",
    "primary-unroutable to promotion-acknowledged wall time",
    buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0),
)
# per-replica health gauges: label cardinality is the configured fleet
# size, bounded at router construction
_REPLICA_UP = obs_metrics.gauge(
    "kolibrie_router_replica_up",
    "1 when the replica is healthy and routable, else 0",
    labels=("replica",),
)
_REPLICA_APPLIED_SEGMENT = obs_metrics.gauge(
    "kolibrie_router_replica_applied_segment",
    "replica's applied-segment watermark as last probed",
    labels=("replica",),
)
_REPLICA_FAILURES = obs_metrics.gauge(
    "kolibrie_router_replica_consecutive_failures",
    "consecutive probe failures (evicts at the configured threshold)",
    labels=("replica",),
)

# bounded route-label set (route-clamp pattern — client typos must not
# mint unbounded label values)
_KNOWN_ROUTES = frozenset(
    {
        "/query",
        "/store/load",
        "/store/query",
        "/explain",
        "/rsp-query",
        "/rsp/register",
        "/rsp/push",
        "/rsp/checkpoint",
        "/rsp/restore",
        "/stats",
        "/metrics",
        "/healthz",
        "/admin/promote",
    }
)


def _route_label(path: str) -> str:
    p = path.partition("?")[0]
    return p if p in _KNOWN_ROUTES else "other"

# routes whose POST bodies are reads — affinity-balanced across the
# fleet; every other POST is a mutation and goes to the primary
READ_POST_ROUTES = frozenset(
    {"/store/query", "/query", "/explain", "/debug/explain"}
)

_MASK_RE = re.compile(
    r"""("(?:[^"\\]|\\.)*")|(<[^>\s]*>)|(\b\d+(?:\.\d+)?\b)""",
)


def template_affinity_key(text: str) -> str:
    """A cheap router-side approximation of the engine's template
    fingerprint: quoted literals, IRIs, and numbers mask to placeholders
    so instantiations of one template share a key.  It need not match
    the engine's fingerprint exactly — it only has to be STABLE, so a
    template's traffic keeps hitting the replica whose caches it
    already warmed."""
    masked = _MASK_RE.sub("?", text)
    return hashlib.sha1(" ".join(masked.split()).encode("utf-8")).hexdigest()


def _wm_segment(wm: Optional[dict]) -> int:
    """A node's durable segment position regardless of role: followers
    report ``applied_segment``, primaries report their open WAL position
    under ``durable_wal.segment`` (/healthz shape)."""
    wm = wm or {}
    if wm.get("applied_segment") is not None:
        return int(wm["applied_segment"])
    return int((wm.get("durable_wal") or {}).get("segment") or 0)


class Replica:
    """Probe-maintained view of one backend."""

    def __init__(self, name: str, url: str):
        self.name = name
        self.url = url.rstrip("/")
        self.role = "unknown"
        self.status = "unknown"
        self.healthy = False
        self.watermark: dict = {}
        self.consecutive_failures = 0
        self.evicted = False
        self.last_probe_unix = 0.0

    def snapshot(self) -> dict:
        return {
            "url": self.url,
            "role": self.role,
            "status": self.status,
            "healthy": self.healthy,
            "evicted": self.evicted,
            "consecutive_failures": self.consecutive_failures,
            "watermark": self.watermark,
            "last_probe_unix": self.last_probe_unix,
        }


class RouterCore:
    """Fleet state + placement + promotion.  Owns the probe thread; the
    HTTP handler class below is a thin shell over this."""

    def __init__(
        self,
        replicas: List[Tuple[str, str]],
        probe_interval_s: float = 0.5,
        probe_timeout_s: float = 2.0,
        evict_after: int = 3,
        promote_after: int = 3,
        promote_cooldown_s: float = 5.0,
        auto_promote: bool = True,
        fleet_cache_ttl_s: float = DEFAULT_FLEET_CACHE_TTL_S,
    ):
        self.replicas: Dict[str, Replica] = {
            name: Replica(name, url) for name, url in replicas
        }
        self.lock = threading.Lock()
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.evict_after = evict_after
        self.promote_after = promote_after
        self.promote_cooldown_s = promote_cooldown_s
        self.auto_promote = auto_promote
        self.fleet_cache_ttl_s = fleet_cache_ttl_s
        self.promotions = 0
        self.last_promotion_unix = 0.0
        self.node_id = "router"  # refined to router:<port> by make_router
        self.last_failover_ms = 0.0
        self._failover_started: Optional[float] = None  # guarded by: lock
        self._fleet_lock = threading.Lock()
        # TTL caches for the fleet aggregation endpoints: (monotonic, data)
        self._fleet_metrics_cache: Tuple[float, str] = (0.0, "")
        self._fleet_status_cache: Tuple[float, Optional[dict]] = (0.0, None)
        self._stop = threading.Event()
        self._probe_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- probing

    def probe_once(self) -> None:
        # one trace id per probe round: every probed replica records the
        # same id, so a fleet-state transition reads as one stitched
        # trace across the router and all nodes.  A probe fired from
        # inside a request (the unroutable wait loop) keeps that
        # request's trace instead.
        with obs_spans.trace_scope(obs_spans.current_trace_id()) as tid:
            for rep in list(self.replicas.values()):
                with obs_spans.span(
                    "router.probe", replica=rep.name, node=self.node_id
                ):
                    self._probe_replica(rep, tid)
        if self.auto_promote:
            self._maybe_promote()

    def _probe_replica(self, rep: Replica, trace_id: Optional[str]) -> None:
        req = urllib.request.Request(rep.url + "/healthz")
        if trace_id:
            req.add_header("X-Kolibrie-Trace-Id", trace_id)
        try:
            with urllib.request.urlopen(
                req, timeout=self.probe_timeout_s
            ) as resp:
                body = json.loads(resp.read().decode("utf-8"))
            ok, code = True, resp.status
        except urllib.error.HTTPError as e:
            # 503 recovering still carries a parseable body — the
            # node is ALIVE but not ready; that is not an eviction
            try:
                body = json.loads(e.read().decode("utf-8"))
                ok, code = True, e.code
            except Exception:
                _ROUTER_PROBE_FAILURES.labels(rep.name).inc()
                body, ok, code = {}, False, e.code
        except Exception:
            # connect refused / timeout / reset — the probe's whole
            # job is turning these into liveness state below
            _ROUTER_PROBE_FAILURES.labels(rep.name).inc()
            body, ok, code = {}, False, 0
        with self.lock:
            rep.last_probe_unix = time.time()
            if ok:
                rep.consecutive_failures = 0
                if rep.evicted:
                    rep.evicted = False
                    _log.info("replica restored", replica=rep.name)
                rep.status = str(body.get("status", "unknown"))
                rep.role = str(body.get("role", rep.role))
                repl = body.get("replication") or {}
                rep.watermark = repl.get("watermark") or body.get(
                    "watermark"
                ) or {}
                rep.healthy = code == 200 and rep.status == "ready"
            else:
                rep.consecutive_failures += 1
                rep.healthy = False
                if (
                    not rep.evicted
                    and rep.consecutive_failures >= self.evict_after
                ):
                    rep.evicted = True
                    _ROUTER_EVICTIONS.inc()
                    _log.warn(
                        "replica evicted",
                        replica=rep.name,
                        consecutive_failures=rep.consecutive_failures,
                    )
            _REPLICA_UP.labels(rep.name).set(
                1 if (rep.healthy and not rep.evicted) else 0
            )
            _REPLICA_FAILURES.labels(rep.name).set(rep.consecutive_failures)
            _REPLICA_APPLIED_SEGMENT.labels(rep.name).set(
                _wm_segment(rep.watermark)
            )

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            self.probe_once()

    def start(self) -> None:
        self.probe_once()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="router-probe", daemon=True
        )
        self._probe_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5.0)
            self._probe_thread = None

    # ----------------------------------------------------------- placement

    def primary(self) -> Optional[Replica]:
        with self.lock:
            for rep in self.replicas.values():
                if rep.role == "primary" and not rep.evicted:
                    return rep
        return None

    def read_order(self, affinity_key: str) -> List[Replica]:
        """Healthy replicas in rendezvous order for this template key —
        element 0 is the home; the rest are the retry ladder."""
        with self.lock:
            live = [
                r
                for r in self.replicas.values()
                if r.healthy and not r.evicted
            ]
        return sorted(
            live,
            key=lambda r: hashlib.sha1(
                f"{affinity_key}|{r.name}".encode("utf-8")
            ).hexdigest(),
            reverse=True,
        )

    # ----------------------------------------------------------- promotion

    def _maybe_promote(self) -> None:
        with self.lock:
            primaries = [
                r for r in self.replicas.values() if r.role == "primary"
            ]
            dead_primary = primaries and all(
                r.consecutive_failures >= self.promote_after
                for r in primaries
            )
            no_primary = not primaries
            if not (dead_primary or no_primary):
                self._failover_started = None
                return
            # failover clock starts when the primary first becomes
            # unroutable, not when the order is finally sent — the SLO
            # covers the whole unavailability window
            if self._failover_started is None:
                self._failover_started = time.monotonic()
            if (
                time.time() - self.last_promotion_unix
                < self.promote_cooldown_s
            ):
                return
            candidates = [
                r
                for r in self.replicas.values()
                if r.role == "follower" and r.healthy and not r.evicted
            ]
        if not candidates:
            return
        self.promote(candidates)

    def promote(self, candidates: List[Replica]) -> Optional[Replica]:
        """Highest durable watermark wins: the most-caught-up follower
        holds a superset of every other follower's acknowledged state
        (all ship from one primary, whole sealed segments, in order)."""

        def key(r: Replica) -> Tuple[int, int]:
            wm = r.watermark or {}
            return (
                int(wm.get("applied_segment") or 0),
                int(wm.get("applied_records") or 0),
            )

        winner = max(candidates, key=key)
        with obs_spans.trace_scope(obs_spans.current_trace_id()) as tid, \
                obs_spans.span(
                    "router.promote", replica=winner.name, node=self.node_id
                ):
            try:
                req = urllib.request.Request(
                    winner.url + "/admin/promote",
                    data=b"{}",
                    headers={
                        "Content-Type": "application/json",
                        "X-Kolibrie-Trace-Id": tid,
                    },
                    method="POST",
                )
                with urllib.request.urlopen(req, timeout=30.0) as resp:
                    json.loads(resp.read().decode("utf-8"))
            except Exception as exc:
                # the candidate died between probe and order: counted, and
                # the supervisor re-runs on the next probe round
                _ROUTER_PROMOTE_FAILURES.inc()
                _log.error(
                    "promotion order failed",
                    replica=winner.name,
                    error=repr(exc),
                )
                return None
        with self.lock:
            for rep in self.replicas.values():
                if rep.role == "primary":
                    rep.role = "unknown"
            winner.role = "primary"
            self.promotions += 1
            self.last_promotion_unix = time.time()
            started = self._failover_started
            self._failover_started = None
        # failover duration: primary-unroutable → promotion acknowledged;
        # a manually-ordered promote (no outage observed) times only the
        # order round-trip and is recorded the same way
        if started is not None:
            elapsed = time.monotonic() - started
            _ROUTER_FAILOVER_SECONDS.observe(elapsed)
            with self.lock:
                self.last_failover_ms = elapsed * 1000.0
        _ROUTER_PROMOTIONS.inc()
        wm = winner.watermark or {}
        with self.lock:
            failover_ms = self.last_failover_ms
        _log.info(
            "follower promoted",
            replica=winner.name,
            applied_segment=wm.get("applied_segment"),
            applied_records=wm.get("applied_records"),
            failover_ms=round(failover_ms, 1),
        )
        return winner

    # ------------------------------------------------------------- stats

    def stats(self) -> dict:
        with self.lock:
            return {
                "replicas": {
                    name: rep.snapshot()
                    for name, rep in self.replicas.items()
                },
                "promotions": self.promotions,
                "last_failover_ms": self.last_failover_ms,
            }

    # -------------------------------------------------- fleet aggregation

    def fleet_metrics(self) -> str:
        """Every healthy replica's ``/metrics`` plus the router's own
        registry, merged with a ``node`` label.  TTL-cached: a scrape
        storm costs one fleet sweep per TTL window."""
        with self._fleet_lock:
            ts, cached = self._fleet_metrics_cache
            if cached and time.monotonic() - ts < self.fleet_cache_ttl_s:
                return cached
        with obs_spans.trace_scope(obs_spans.current_trace_id()) as tid, \
                obs_spans.span("router.fleet_metrics", node=self.node_id):
            with self.lock:
                targets = [
                    (rep.name, rep.url)
                    for rep in self.replicas.values()
                    if rep.healthy and not rep.evicted
                ]
            per_node: Dict[str, str] = {
                self.node_id: promtext.render_prometheus()
            }
            for name, url in targets:
                req = urllib.request.Request(url + "/metrics")
                req.add_header("X-Kolibrie-Trace-Id", tid)
                try:
                    with urllib.request.urlopen(
                        req, timeout=self.probe_timeout_s
                    ) as resp:
                        per_node[name] = resp.read().decode("utf-8")
                except Exception:
                    # a replica dying mid-sweep is the prober's problem;
                    # the merge simply goes on without it
                    _ROUTER_UPSTREAM_ERRORS.labels(name).inc()
            merged = promtext.merge_prometheus(per_node)
        with self._fleet_lock:
            self._fleet_metrics_cache = (time.monotonic(), merged)
        return merged

    def fleet_status(self) -> dict:
        """Per-replica watermark / applied-lag / staleness, rendered
        from the prober's last ``/healthz`` view.  TTL-cached alongside
        :meth:`fleet_metrics`."""
        with self._fleet_lock:
            ts, cached = self._fleet_status_cache
            if cached is not None and (
                time.monotonic() - ts < self.fleet_cache_ttl_s
            ):
                return cached
        now = time.time()
        with self.lock:
            snaps = {
                name: rep.snapshot()
                for name, rep in self.replicas.items()
            }
            promotions = self.promotions
            last_failover_ms = self.last_failover_ms
        applied = [
            _wm_segment(s["watermark"]) for s in snaps.values()
        ]
        head = max(applied) if applied else 0
        nodes = {}
        for name, s in snaps.items():
            wm = s["watermark"] or {}
            seg = _wm_segment(wm)
            last_applied = float(wm.get("last_applied_unix") or 0.0)
            nodes[name] = {
                "url": s["url"],
                "role": s["role"],
                "status": s["status"],
                "healthy": s["healthy"],
                "evicted": s["evicted"],
                "applied_segment": seg,
                "applied_records": int(wm.get("applied_records") or 0),
                # lag vs the most-advanced node the prober can see —
                # the fleet-relative number an operator actually pages on
                "applied_lag_segments": max(0, head - seg),
                "staleness_s": (
                    round(now - last_applied, 3) if last_applied else None
                ),
                "probe_age_s": (
                    round(max(0.0, now - s["last_probe_unix"]), 3)
                    if s["last_probe_unix"]
                    else None
                ),
            }
        out = {
            "head_segment": head,
            "promotions": promotions,
            "last_failover_ms": last_failover_ms,
            "nodes": nodes,
        }
        with self._fleet_lock:
            self._fleet_status_cache = (time.monotonic(), out)
        return out


class RouterHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    core: RouterCore = None  # bound by make_router
    quiet = False

    def log_message(self, fmt, *args):
        if not self.quiet:
            super().log_message(fmt, *args)

    # ------------------------------------------------------------ plumbing

    def _send_json(self, payload: dict, code: int = 200) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _forward_once(
        self, rep: Replica, method: str, path: str, body: Optional[bytes],
        timeout_s: float, attempt: int = 0,
    ) -> Tuple[int, bytes, str]:
        headers = {}
        for h in ("Content-Type", "X-Kolibrie-Deadline-Ms"):
            v = self.headers.get(h)
            if v:
                headers[h] = v
        # trace propagation: forward the client's id when present,
        # otherwise mint here — either way EVERY hop (first try and each
        # retry rung) carries the same id the router's own spans use
        trace_id = (
            self.headers.get("X-Kolibrie-Trace-Id")
            or obs_spans.current_trace_id()
            or obs_spans.new_trace_id()
        )
        headers["X-Kolibrie-Trace-Id"] = trace_id
        req = urllib.request.Request(
            rep.url + path, data=body, headers=headers, method=method
        )
        t0 = time.perf_counter()
        with obs_spans.span(
            "router.forward",
            replica=rep.name,
            path=path.partition("?")[0],
            attempt=attempt,
            node=self.core.node_id,
        ):
            try:
                with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                    data = resp.read()
                    ctype = resp.headers.get(
                        "Content-Type", "application/json"
                    )
                    return resp.status, data, ctype
            except urllib.error.HTTPError as e:
                data = e.read()
                ctype = e.headers.get("Content-Type", "application/json")
                return e.code, data, ctype
            finally:
                _ROUTER_UPSTREAM_LAT.labels(rep.name).observe(
                    time.perf_counter() - t0
                )

    def _budget_s(self) -> float:
        raw = self.headers.get("X-Kolibrie-Deadline-Ms")
        try:
            ms = float(raw) if raw is not None else DEFAULT_BUDGET_MS
        except ValueError:
            ms = DEFAULT_BUDGET_MS
        return ms / 1000.0 if ms > 0 else DEFAULT_BUDGET_MS / 1000.0

    def _route(self, method: str, path: str, body: Optional[bytes]) -> None:
        # the whole routing ladder runs under one trace scope (client-
        # supplied id or minted), so retries, probes fired from the wait
        # loop, and the forwarded request itself all stitch together
        with obs_spans.trace_scope(
            self.headers.get("X-Kolibrie-Trace-Id") or None
        ), obs_spans.span(
            "router.request",
            route=_route_label(path),
            method=method,
            node=self.core.node_id,
        ):
            self._route_traced(method, path, body)

    def _route_traced(
        self, method: str, path: str, body: Optional[bytes]
    ) -> None:
        core = self.core
        route = _route_label(path)
        is_read = method == "GET" or path.partition("?")[0] in READ_POST_ROUTES
        affinity = ""
        if method == "POST" and body and is_read:
            try:
                req = json.loads(body.decode("utf-8"))
                affinity = template_affinity_key(
                    str(req.get("sparql") or req.get("query") or "")
                )
            except (ValueError, AttributeError, TypeError):
                affinity = ""  # unparseable body: no affinity, still routable
        deadline = time.monotonic() + self._budget_s()
        attempt = 0
        last_err = "no live replica"
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                _ROUTER_REQS.labels(route, "deadline").inc()
                self._send_json(
                    {"error": last_err, "code": "deadline_exceeded"}, 504
                )
                return
            if is_read:
                order = core.read_order(affinity or path)
                # writes always belong on the primary; reads fall back to
                # it only through the rendezvous ladder
                target = order[attempt % len(order)] if order else None
            else:
                target = core.primary()
            if target is None:
                # nothing routable yet (startup, failover window): wait a
                # beat for the prober/supervisor to converge
                last_err = "no routable replica"
                core.probe_once()
                time.sleep(min(0.1, max(0.0, remaining)))
                attempt += 1
                if attempt > 200:
                    _ROUTER_REQS.labels(route, "unroutable").inc()
                    self._send_json(
                        {"error": last_err, "code": "unavailable"}, 503
                    )
                    return
                continue
            if attempt > 0:
                _ROUTER_RETRIES.inc()
            try:
                code, data, ctype = self._forward_once(
                    target, method, path, body,
                    timeout_s=max(0.05, min(remaining, 60.0)),
                    attempt=attempt,
                )
            except Exception as exc:  # connect refused / timeout / reset
                _ROUTER_UPSTREAM_ERRORS.labels(target.name).inc()
                last_err = f"{target.name}: {exc}"
                with core.lock:
                    target.consecutive_failures += 1
                    target.healthy = False
                attempt += 1
                backoff = min(0.05 * (2 ** min(attempt, 5)), 0.5)
                time.sleep(min(backoff, max(0.0, remaining)))
                continue
            if code == 409 or (code == 503 and not is_read):
                # not_primary (stale role map) or a primary mid-recovery:
                # re-probe and retry within budget
                last_err = f"{target.name}: upstream {code}"
                core.probe_once()
                attempt += 1
                time.sleep(min(0.05, max(0.0, remaining)))
                continue
            if code == 503 and is_read:
                # follower behind the requested watermark / recovering —
                # try the next rung of the ladder
                last_err = f"{target.name}: upstream 503"
                attempt += 1
                time.sleep(min(0.02, max(0.0, remaining)))
                continue
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.send_header("X-Kolibrie-Replica", target.name)
            # echo the trace id the forward carried so the client can
            # pull the stitched trace from any node's /debug/traces
            trace_id = obs_spans.current_trace_id()
            if trace_id:
                self.send_header("X-Kolibrie-Trace-Id", trace_id)
            self.end_headers()
            self.wfile.write(data)
            _ROUTER_REQS.labels(
                route, "ok" if code < 400 else "error"
            ).inc()
            return

    # -------------------------------------------------------------- verbs

    def do_GET(self):
        path = self.path.partition("?")[0]
        if path == "/router/stats":
            self._send_json(self.core.stats())
            return
        if path == "/router/healthz":
            stats = self.core.stats()
            any_ready = any(
                r["healthy"] for r in stats["replicas"].values()
            )
            self._send_json(stats, 200 if any_ready else 503)
            return
        if path == "/fleet/metrics":
            body = self.core.fleet_metrics().encode("utf-8")
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if path == "/fleet/status":
            self._send_json(self.core.fleet_status())
            return
        self._route("GET", self.path, None)

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        if length > MAX_BODY_BYTES:
            self._send_json(
                {"error": "request too large", "code": "request_too_large"},
                413,
            )
            return
        body = self.rfile.read(length)
        self._route("POST", self.path, body)


class _BurstHTTPServer(ThreadingHTTPServer):
    """A listen backlog for a burst of concurrent clients (socketserver's
    default of 5 resets the rest on a loaded host); the router keeps its
    own copy of ``frontends.http_server.BurstHTTPServer`` so that it
    imports no engine code."""

    request_queue_size = 128


def make_router(
    replicas: List[Tuple[str, str]],
    host: str = "127.0.0.1",
    port: int = 0,
    quiet: bool = False,
    **core_kwargs,
):
    """Build (httpd, core).  ``replicas`` is ``[(name, base_url), ...]``;
    roles are discovered by probing, not configured."""
    core = RouterCore(replicas, **core_kwargs)
    handler = type(
        "BoundRouterHandler", (RouterHandler,), {"core": core, "quiet": quiet}
    )
    httpd = _BurstHTTPServer((host, port), handler)
    core.node_id = f"router:{httpd.server_address[1]}"
    core.start()
    return httpd, core


# Debug-build runtime check of the # guarded by: annotations above
# (no-op unless KOLIBRIE_DEBUG_LOCKS=1 — see analysis/lockcheck.py)
from kolibrie_tpu_torch.analysis import lockcheck as _lockcheck

_lockcheck.auto_instrument(globals())
