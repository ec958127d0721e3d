"""Exposition: Prometheus text format for ``GET /metrics`` and the
single source of truth behind ``GET /stats``.

Port of ``kolibrie_tpu/obs/export.py``, with the same JSON shapes and
metric families, the mesh-serving ones included: a store with the sharded
serving layer attached (``parallel/sharded_serving.py``) carries a
``sharding`` block in ``/stats`` and the ``kolibrie_store_shards`` /
``kolibrie_store_shard_imbalance`` gauges in ``/metrics``.

Before this module existed the server had two stats code paths —
``TemplateBatcher.stats()`` poked the compile cache, plan cache and
breaker board with function-level imports on every poll, and
``_handle_stats`` assembled a second dict around it.  Both now render
here: :func:`store_stats` builds one store's block, :func:`build_stats`
the whole ``/stats`` payload, and the heavyweight imports run once at
module import instead of per scrape.

The JSON shapes are load-bearing (tests/test_plan_template.py and
tests/test_chaos.py assert on keys), so :func:`store_stats` preserves
them exactly.
"""

from __future__ import annotations

from typing import List

from kolibrie_tpu_torch.obs import metrics

# rendering itself is stdlib-only and shared with the router's fleet
# aggregation — it lives in promtext; re-exported here because every
# existing caller imports it from this module
from kolibrie_tpu_torch.obs.promtext import render_prometheus  # noqa: F401

# Satellite: module-scope imports — previously re-imported inside
# TemplateBatcher.stats() on every /stats poll.
from kolibrie_tpu_torch.optimizer.device_engine import device_compile_stats
from kolibrie_tpu_torch.query.executor import plan_cache_info
from kolibrie_tpu_torch.resilience.breaker import breaker_board


# ----------------------------------------------------------------- /stats


def _pct(samples: List[float], q: float) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


def store_stats(batcher) -> dict:
    """One store's ``/stats`` block (formerly ``TemplateBatcher.stats``).
    Key set is asserted by tests — extend, don't rename."""
    with batcher.lock:
        per = {
            fp: {
                "requests": rec["requests"],
                "dedup_hits": rec["dedup_hits"],
                "dispatches": len(rec["lat"]),
                "dispatch_ms_p50": _pct(rec["lat"], 0.50),
                "dispatch_ms_p95": _pct(rec["lat"], 0.95),
            }
            for fp, rec in batcher.templates.items()
        }
        depths = list(getattr(batcher, "depth_at_dispatch", ()))
        distinct = list(getattr(batcher, "distinct_per_dispatch", ()))
        out = {
            "requests": batcher.requests,
            "dispatches": batcher.dispatches,
            "dedup_hits": batcher.dedup_hits,
            "max_batch": batcher.max_batch,
            "shed_queue_full": batcher.shed_queue_full,
            "shed_deadline": batcher.shed_deadline,
            "queue_depth": len(batcher.pending),
            # dispatch-shape distribution (bounded recent window): how
            # deep the drained queue ran and how template-diverse each
            # dispatch was — distinct >= 2 is the population the MQO
            # shared-prefix layer can help (docs/MQO.md)
            "queue_depth_at_dispatch_p50": _pct(depths, 0.50),
            "queue_depth_at_dispatch_p95": _pct(depths, 0.95),
            "distinct_templates_p50": _pct(distinct, 0.50),
            "distinct_templates_p95": _pct(distinct, 0.95),
            "per_template": per,
        }
    with batcher.dispatch_lock:
        out["triples"] = len(batcher.db.store)
        out["plan_cache"] = plan_cache_info(batcher.db)
        out["breakers"] = breaker_board(batcher.db).snapshot()
        sharded = batcher.db.__dict__.get("_sharded_serving")
        if sharded is not None:
            # shard count, per-shard occupancy, imbalance, last cap hit —
            # the degraded-routing signals
            out["sharding"] = sharded.stats()
    out["device_compiles"] = device_compile_stats()
    from kolibrie_tpu_torch.optimizer import mqo

    # shared-prefix registry for this store: mode, standing count, per-
    # prefix beneficiaries / shared evals / cache hits (docs/MQO.md)
    out["mqo"] = mqo.stats(batcher.db)
    return out


def build_stats(state) -> dict:
    """The whole ``GET /stats`` payload (formerly inline in
    ``_handle_stats``): per-store blocks plus RSP session and resilience
    counters.  ``state`` is the server's ``_ServerState``."""
    with state.lock:
        stores = dict(state.stores)
        sessions = dict(state.sessions)
    per_session = {}
    for sid, s in sessions.items():
        with s.lock:
            info = {
                "subscribers": len(s.subscribers),
                "dropped_subscribers": s.dropped_subscribers,
                "crash_recoveries": s.crash_recoveries,
                "recovered": getattr(s, "recovered", False),
            }
        rstats = getattr(s.engine, "resilience_stats", None)
        if rstats is not None:
            info["windows"] = rstats()
        mstats = getattr(s.engine, "mqo_stats", None)
        if mstats is not None:
            # fire-round prefix sharing across the session's standing
            # windows (docs/MQO.md): hits climb when same-content rounds
            # reuse the cached prefix table
            info["mqo"] = mstats()
        per_session[sid] = info
    resilience = {
        "admission": state.admission.snapshot(),
        "sessions": per_session,
    }
    durability = getattr(state, "durability", None)
    if durability is not None:
        resilience["durability"] = {
            "status": getattr(state, "status", "ready"),
            **durability.stats(),
        }
    # compile-tail block: persistent-cache hit/miss traffic + warmer
    # progress — the "is the restart tail actually dead" dashboard
    from kolibrie_tpu_torch.query import compile_cache

    compile_tail: dict = {"cache": compile_cache.stats()}
    warmer = getattr(state, "prewarmer", None)
    if warmer is not None:
        compile_tail["prewarm"] = warmer.stats()
    # capacity-advisor block: per-template current caps / high-water mark /
    # retry counts (process-wide — the advisor spans stores and survives
    # base-version churn; "is steady state really zero-retry" dashboard)
    from kolibrie_tpu_torch.optimizer.stats_advisor import stats_advisor
    from kolibrie_tpu_torch.query.template import cap_advisor

    out = {
        "stores": {sid: store_stats(b) for sid, b in stores.items()},
        "rsp_sessions": len(sessions),
        "resilience": resilience,
        "compile_tail": compile_tail,
        "cap_advisor": cap_advisor.stats(),
        # feedback-optimizer block: per-template learned-key counts,
        # plan generation, replans and drift state (docs/OPTIMIZER.md)
        "stats_advisor": stats_advisor.stats(),
    }
    # replication block: ship/apply counters + watermark/lag on nodes
    # with a role in a fleet (primary ship server or follower); absent on
    # plain single-process servers
    replication = getattr(state, "replication", None)
    if replication is not None:
        out["replication"] = {
            "node_role": getattr(state, "role", "primary"),
            **replication.stats(),
        }
    return out


# ------------------------------------------------- scrape-time collectors

_compile_cache_gauge = metrics.gauge(
    "kolibrie_device_compile_cache_entries",
    "spec-cache sizes per device entry point (a new spec adds an entry)",
    labels=("entry",),
)


def _collect_compile_cache() -> None:
    for name, size in device_compile_stats().items():
        _compile_cache_gauge.labels(name).set(size)


metrics.register_collector(_collect_compile_cache)

_queue_depth_gauge = metrics.gauge(
    "kolibrie_batcher_queue_depth",
    "requests pending in a store's batching window",
    labels=("store",),
)
_rsp_sessions_gauge = metrics.gauge(
    "kolibrie_rsp_sessions", "live RSP sessions"
)
_store_shards_gauge = metrics.gauge(
    "kolibrie_store_shards",
    "mesh shard count serving a store (0 rows absent = single-device)",
    labels=("store",),
)
_store_shard_imbalance_gauge = metrics.gauge(
    "kolibrie_store_shard_imbalance",
    "per-store max/mean shard row occupancy",
    labels=("store",),
)
_plan_cache_gauges = {
    "parse_entries": metrics.gauge(
        "kolibrie_plan_cache_parse_entries",
        "parse-level plan cache occupancy", labels=("store",),
    ),
    "templates": metrics.gauge(
        "kolibrie_plan_cache_templates",
        "template-level plan cache occupancy", labels=("store",),
    ),
}


def refresh_server_gauges(state) -> None:
    """Pull server-held state into gauges — called by the /metrics
    handler before rendering (the registry's own collectors cannot see
    the server state object)."""
    with state.lock:
        stores = dict(state.stores)
        n_sessions = len(state.sessions)
    _rsp_sessions_gauge.set(n_sessions)
    for sid, b in stores.items():
        with b.lock:
            _queue_depth_gauge.labels(sid).set(len(b.pending))
        info = plan_cache_info(b.db)
        for key, g in _plan_cache_gauges.items():
            g.labels(sid).set(info[key])
        sharded = b.db.__dict__.get("_sharded_serving")
        if sharded is not None:
            sh_stats = sharded.stats()
            _store_shards_gauge.labels(sid).set(sh_stats["shards"])
            if "imbalance" in sh_stats:
                _store_shard_imbalance_gauge.labels(sid).set(sh_stats["imbalance"])
    # follower watermark/lag SLO gauges refresh at scrape time so a
    # wedged poll loop cannot freeze the lag /metrics reports — the
    # follower owns the gauge families; primaries (ShipServer) have no
    # refresh hook and push their counters inline
    replication = getattr(state, "replication", None)
    refresh = getattr(replication, "refresh_gauges", None)
    if refresh is not None:
        refresh()
