"""Background prewarm: run the hot templates before clients do.

Port of ``kolibrie_tpu/query/prewarm.py``.  The compile cache
(:mod:`kolibrie_tpu_torch.query.compile_cache`) keeps the kernel
libraries across restarts; the warmer moves the rest of a template's cold
cost — parsing, planning, lowering, the capacity ladder and the first
kernel loads — off the request path:

- at startup it replays the top-N templates from the persisted manifest
  against every registered store, so the first foreground query finds the
  plan cache and the capacity caches hot;
- it is *admission-aware*: before each warm it checks whether the caller
  is idle and backs off while real traffic is being served;
- warm executions run with the plan interpreter forced OFF
  (:func:`~kolibrie_tpu_torch.optimizer.plan_interp.override_mode`), so
  they run the *specialized* path and flip auto-mode routing for that
  template from the interpreter to the specialized path
  (``mark_compiled``);
- it periodically persists the manifest so the next restart knows this
  process's hot set.

Targets are ``(label, db, lock)`` triples and idleness is a callable, so
tests drive it directly against a bare database.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Tuple

from kolibrie_tpu_torch.obs import metrics as _metrics
from kolibrie_tpu_torch.query import compile_cache

__all__ = ["PrewarmManager", "replay_manifest", "warm_one"]

_COMPILED = _metrics.counter(
    "kolibrie_prewarm_compiled_total",
    "templates warmed (specialized plan compiled or disk-loaded)",
)
_SKIPPED = _metrics.counter(
    "kolibrie_prewarm_skipped_total",
    "warm attempts skipped (admission pressure or unknown template)",
)
_ERRORS = _metrics.counter(
    "kolibrie_prewarm_errors_total", "warm attempts that raised"
)
_WARM_LAT = _metrics.histogram(
    "kolibrie_prewarm_seconds", "per-template warm wall time"
)

# targets: (label, database, lock-or-None); the lock is the store's
# dispatch serialization (TemplateBatcher.dispatch_lock on the server)
Target = Tuple[str, object, Optional[threading.Lock]]

DEFAULT_TOP_N = 32
_IDLE_WAIT_S = 0.05
_IDLE_RETRIES = 40  # ~2s of admission pressure before skipping a template


def warm_one(db, query: str, lock: Optional[threading.Lock] = None) -> dict:
    """Execute ``query`` against ``db`` with interpreter routing forced
    off, returning ``{ms, source, rows}`` (``{skipped}`` for a statement
    that is not a read-only SELECT).  The execution IS the warm: it
    lowers the specialized plan, loads (or builds) the kernel libraries,
    converges the template's capacities and marks the shape compiled for
    auto-mode routing."""
    from kolibrie_tpu_torch.optimizer.plan_interp import override_mode
    from kolibrie_tpu_torch.query.executor import execute_query_volcano, plan_cache_info
    from kolibrie_tpu_torch.query.template import fingerprint_query
    from kolibrie_tpu_torch.query.parser import parse_combined_query

    if not _read_only(parse_combined_query(query, db.prefixes)):
        # the manifest records every statement the executor ran; replaying
        # an INSERT, DELETE, RULE or MODEL/TRAIN would change the store
        # (and a follower's dictionary, which must match its primary's)
        _SKIPPED.inc()
        return {"skipped": "not a read-only SELECT"}
    t0 = time.perf_counter()
    with compile_cache.suppress_recording(), override_mode("off"):
        if lock is not None:
            with lock:
                rows = execute_query_volcano(query, db)
        else:
            rows = execute_query_volcano(query, db)
        # mesh-attached store: the serving path dispatches template groups
        # through the mesh — warm that path too
        sharded = db.__dict__.get("_sharded_serving")
        mesh_warmed = sharded.warm(query) if sharded is not None else None
        ms = (time.perf_counter() - t0) * 1000.0
        # source of the run this warm produced (interp is impossible
        # here — routing was forced off)
        fp, _ = fingerprint_query(parse_combined_query(query, db.prefixes))
    per = plan_cache_info(db)["per_template"].get(fp, {})
    out = {"ms": round(ms, 3), "source": per.get("source"), "rows": len(rows)}
    if mesh_warmed is not None:
        out["mesh"] = mesh_warmed
    return out


def _read_only(cq) -> bool:
    """A SELECT that changes nothing: no update, rule, model or stream
    registration rides along."""
    return cq.select is not None and not (
        cq.register is not None
        or cq.rules
        or cq.insert is not None
        or cq.delete is not None
        or cq.models
        or cq.neural_relations
        or cq.train_decls
        or cq.ml_predict is not None
    )


def replay_manifest(
    db,
    root: Optional[str] = None,
    top_n: int = DEFAULT_TOP_N,
    lock: Optional[threading.Lock] = None,
    is_idle: Optional[Callable[[], bool]] = None,
) -> List[dict]:
    """Warm ``db`` from the persisted manifest (hottest first).  After it
    returns, the first real query of a warmed template is a plan-cache
    hit and builds no kernel."""
    # tuned routing rides the same manifest: import the advisor section
    # BEFORE replaying, so even the warm executions plan from the
    # previous process's learned cardinalities
    compile_cache.load_advisor_state(root)
    results: List[dict] = []
    for ent in compile_cache.load_manifest(root)[:top_n]:
        results.append(
            _warm_entry(ent, [("db", db, lock)], is_idle or (lambda: True))
        )
    return results


def _warm_entry(
    ent: dict, targets: List[Target], is_idle: Callable[[], bool]
) -> dict:
    out = {"fp": ent.get("fp"), "hits": ent.get("hits", 0), "targets": {}}
    query = ent.get("query")
    if not query:
        _SKIPPED.inc()
        out["skipped"] = "no representative query"
        return out
    for label, db, lock in targets:
        for _ in range(_IDLE_RETRIES):
            if is_idle():
                break
            time.sleep(_IDLE_WAIT_S)
        else:
            _SKIPPED.inc()
            out["targets"][label] = {"skipped": "admission pressure"}
            continue
        try:
            t0 = time.perf_counter()
            res = warm_one(db, query, lock)
            if "skipped" not in res:
                _COMPILED.inc()
                _WARM_LAT.observe(time.perf_counter() - t0)
            out["targets"][label] = res
        except Exception as e:  # a poisoned template must not stop the sweep
            _ERRORS.inc()
            out["targets"][label] = {"error": repr(e)}
    return out


class PrewarmManager:
    """Owns the warmer thread: startup replay, periodic manifest saves,
    and the on-demand sweep behind ``POST /debug/prewarm``."""

    def __init__(
        self,
        get_targets: Callable[[], List[Target]],
        is_idle: Callable[[], bool] = lambda: True,
        is_ready: Callable[[], bool] = lambda: True,
        root: Optional[str] = None,
        top_n: int = DEFAULT_TOP_N,
        save_interval_s: float = 30.0,
    ):
        self.get_targets = get_targets
        self.is_idle = is_idle
        self.is_ready = is_ready
        self.root = root
        self.top_n = top_n
        self.save_interval_s = save_interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()  # serializes run_once vs the thread
        self.startup_replayed = 0  # guarded by: _lock
        self.last_results: List[dict] = []  # guarded by: _lock

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="kolibrie-prewarm"
        )
        self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)
        compile_cache.save_manifest(self.root)

    def _run(self) -> None:
        from kolibrie_tpu_torch.obs.spans import trace_scope

        # fresh trace: warm sweeps land under one queryable trace id
        # (thread-locals do not cross the make_server -> warmer hop)
        with trace_scope(None):
            # gate on readiness: recovery replay owns the device until
            # the server opens; the warmer is strictly lower priority
            while not self._stop.is_set() and not self.is_ready():
                time.sleep(_IDLE_WAIT_S)
            if not self._stop.is_set():
                replayed = len(self.run_once())
                with self._lock:
                    self.startup_replayed = replayed
            while not self._stop.wait(self.save_interval_s):
                compile_cache.save_manifest(self.root)

    # ------------------------------------------------------------------ work

    def run_once(self, top_n: Optional[int] = None) -> List[dict]:
        """One warm sweep: manifest entries (disk ∪ in-memory, hottest
        first) against every current target.  Serialized against the
        background thread's own sweep."""
        n = top_n or self.top_n
        compile_cache.load_advisor_state(self.root)
        merged = {e["fp"]: e for e in compile_cache.load_manifest(self.root)}
        for e in compile_cache.manifest_snapshot():
            old = merged.get(e["fp"])
            if old is None or e.get("hits", 0) >= old.get("hits", 0):
                merged[e["fp"]] = e
        ranked = sorted(
            merged.values(), key=lambda e: (-e.get("hits", 0), e["fp"])
        )[:n]
        results: List[dict] = []
        with self._lock:
            targets = list(self.get_targets())
            for ent in ranked:
                if self._stop.is_set():
                    break
                results.append(_warm_entry(ent, targets, self.is_idle))
            self.last_results = results
        return results

    def stats(self) -> dict:
        with self._lock:
            return {
                "startup_replayed": self.startup_replayed,
                "top_n": self.top_n,
                "last_sweep": len(self.last_results),
            }



# Debug-build runtime check of the # guarded by: annotations above
# (no-op unless KOLIBRIE_DEBUG_LOCKS=1 — see analysis/lockcheck.py)
from kolibrie_tpu_torch.analysis import lockcheck as _lockcheck  # noqa: E402

_lockcheck.auto_instrument(globals())
