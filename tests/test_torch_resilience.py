"""The port's resilience layer against the JAX package's.

Each unit case drives the reference's class and the port's through the
same steps on the same inputs and compares what they show after every
step: deadlines (expiry, merge, scope nesting), circuit breakers (trip,
re-probe, doubling backoff under an injected clock), fault plans (seeded
fire patterns, ``at_calls``, ``max_fires``, ``plan_from_env``),
``error_response`` and admission control.  ``is_device_fault`` is the
port's own: CUDA's out-of-memory error is a fault, a kernel that fails to
build or launch is not.

The executor cases run the reference's executor tests on both packages
over twin databases (``execution_mode = "device"`` on both): a degrade on
``device.lower``, a trip and device-skipping, a half-open recovery, a
deadline shed, a batched group with a faulted member, and a small store
that "auto" routes to the host engine.  Rows, ``breaker_board(db).
snapshot()`` and ``plan_cache_info()`` must be equal after every step.
All comparisons are exact.
"""

from __future__ import annotations

import importlib
import json

import pytest

import kolibrie_tpu_torch as port
from test_torch_clauses import pair
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

PKGS = ("kolibrie_tpu", "kolibrie_tpu_torch")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def both(script):
    """``script(pkg)`` for each package; the two traces must be equal."""
    ref, got = (script(pkg) for pkg in PKGS)
    assert got == ref
    return got


# ----------------------------------------------------------------- deadlines


def deadline_trace(pkg):
    D = mod(pkg, "resilience.deadline")
    E = mod(pkg, "resilience.errors")
    clk = FakeClock()
    out = []
    dl = D.Deadline(1.0, clock=clk)
    out.append((dl.expired(), round(dl.remaining(), 9)))
    clk.advance(0.6)
    out.append((dl.expired(), round(dl.remaining(), 9)))
    clk.advance(0.5)
    out.append((dl.expired(), dl.remaining()))
    try:
        dl.check("unit.site")
    except E.DeadlineExceeded as e:
        out.append((e.site, e.http_status, e.code, str(e)))
    # merge picks the tighter
    tight, loose = D.Deadline(1.0, clock=clk), D.Deadline(5.0, clock=clk)
    out.append((tight.merge(loose) is tight, loose.merge(tight) is tight, tight.merge(None) is tight))
    # scope nesting, and None masking an outer scope
    outer = D.Deadline(0.5, clock=clk)
    out.append(D.current_deadline() is None)
    with D.deadline_scope(outer):
        out.append(D.current_deadline() is outer)
        with D.deadline_scope(None):
            out.append(D.current_deadline() is None)
            clk.advance(1.0)
            D.check_deadline("masked")  # no raise: masked
            out.append(D.remaining_s(7.0))
        try:
            D.check_deadline("outer")
        except E.DeadlineExceeded as e:
            out.append(("raised", e.site))
        out.append(D.remaining_s())
    out.append((D.current_deadline() is None, D.remaining_s(3.0)))
    ms = D.Deadline.from_ms(250, clock=clk)
    out.append(round(ms.remaining(), 9))
    return out


def test_deadline_expiry_merge_and_scope_nesting():
    got = both(deadline_trace)
    assert got[3][:2] == ("unit.site", 504)
    assert ("raised", "outer") in got


# ------------------------------------------------------------------ breakers


def breaker_trace(pkg, threshold, steps):
    B = mod(pkg, "resilience.breaker")
    clk = FakeClock()
    br = B.CircuitBreaker(failure_threshold=threshold, backoff_base_s=1.0,
                          backoff_max_s=60.0, clock=clk)
    out = []
    for step in steps:
        if step == "fail":
            br.record_failure()
        elif step == "ok":
            br.record_success()
        elif step == "allow":
            out.append(br.allow())
        else:
            clk.advance(step)
        out.append((step, br.snapshot(), br.consecutive_trips))
    return out


BREAKER_CASES = {
    # three consecutive failures trip; one half-open probe past the backoff
    "trip_and_reprobe": (3, ["fail", "allow", "fail", "allow", "fail", "allow", 0.5, "allow",
                             0.6, "allow", "allow", "ok", "allow"]),
    # a failed probe re-opens with a doubled backoff; success resets it
    "halfopen_failure_doubles_backoff": (1, ["fail", 1.1, "allow", "fail", 1.5, "allow", 0.6,
                                             "allow", "ok", "fail", 0.9, "allow", 0.2, "allow"]),
    # a success between failures resets the consecutive count
    "success_resets_count": (2, ["fail", "ok", "fail", "allow", "fail", "allow"]),
}


@pytest.mark.parametrize("case", sorted(BREAKER_CASES))
def test_breaker_snapshot_matches_reference_every_step(case):
    threshold, steps = BREAKER_CASES[case]
    got = both(lambda pkg: breaker_trace(pkg, threshold, steps))
    assert any(e[1]["state"] == "open" for e in got if isinstance(e, tuple))


def test_breaker_board_keys_isolated_and_bounded():
    def script(pkg):
        B = mod(pkg, "resilience.breaker")
        clk = FakeClock()
        board = B.BreakerBoard(max_entries=4, failure_threshold=1, clock=clk)
        board.record_failure("bad")
        out = [board.allow("bad"), board.allow("good"), board.close_epoch("never")]
        for i in range(6):
            board.allow(f"fill{i}")
        snap = board.snapshot()
        return out + [sorted(snap), snap["bad"]]

    got = both(script)
    assert got[:3] == [False, True, 0] and "bad" in got[3] and len(got[3]) <= 4


# ----------------------------------------------------------- fault injection


def fire_pattern(pkg, seed, **rule):
    F = mod(pkg, "resilience.faultinject")
    plan = F.FaultPlan(seed=seed)
    plan.add("site.a", error=F.InjectedCompileError, **rule)
    hits = []
    for _ in range(50):
        try:
            plan.hit("site.a")
            hits.append(False)
        except F.InjectedCompileError:
            hits.append(True)
    return hits, plan.snapshot()


@pytest.mark.parametrize("rule", [
    {"rate": 0.3},
    {"rate": 0.3, "max_fires": 4},
    {"at_calls": [2, 4, 40], "max_fires": 2},
], ids=["rate", "rate_max_fires", "at_calls_max_fires"])
def test_fault_plan_is_seed_deterministic(rule):
    a7 = both(lambda pkg: fire_pattern(pkg, 7, **rule))
    assert a7 == fire_pattern("kolibrie_tpu_torch", 7, **rule)
    if "rate" in rule:
        assert a7 != fire_pattern("kolibrie_tpu_torch", 8, **rule)
    assert 1 <= sum(a7[0]) <= rule.get("max_fires", 30)


def test_fault_plan_latency_and_global_install():
    def script(pkg):
        F = mod(pkg, "resilience.faultinject")
        slept = []
        plan = F.FaultPlan(seed=0, sleep=slept.append)
        plan.add("slow", latency_s=0.25)
        plan.add("x", error=F.InjectedDeviceOOM)
        out = []
        F.fault_point("x")  # nothing installed: no-op
        with plan.installed():
            F.fault_point("slow")
            try:
                F.fault_point("x")
            except F.InjectedDeviceOOM as e:
                out.append(str(e))
            F.fault_point("unarmed.site")
        F.fault_point("x")
        return out + [slept, plan.snapshot()]

    got = both(script)
    assert got[1] == [0.25] and got[0] == "injected fault at x (call 1)"


ENV_PLAN = {"seed": 7, "rules": [
    {"site": "wal.append", "error": "InjectedTornWrite", "at_calls": [3]},
    {"site": "device.execute", "error": "InjectedDeviceOOM", "rate": 0.25, "max_fires": 4},
    {"site": "device.lower", "latency_s": 0.5, "rate": 0.5},
]}


@pytest.mark.parametrize("env", [
    {"KOLIBRIE_FAULT_PLAN": json.dumps(ENV_PLAN)},
    {"KOLIBRIE_FAULT_PLAN": "  "},
    {"KOLIBRIE_FAULT_PLAN": "{not json"},
    {"KOLIBRIE_FAULT_PLAN": json.dumps({"rules": [{"site": "s", "error": "Nope"}]})},
], ids=["plan", "empty", "bad_json", "unknown_error"])
def test_plan_from_env(env):
    def script(pkg):
        F = mod(pkg, "resilience.faultinject")
        try:
            plan = F.plan_from_env(env)
        except ValueError as e:
            return ("ValueError", str(e).split(":")[0])
        if plan is None:
            return None
        fired = []
        slept = []
        plan._sleep = slept.append
        for site in ("wal.append", "device.execute", "device.lower") * 12:
            try:
                plan.hit(site)
            except F.InjectedFault as e:
                fired.append((site, type(e).__name__))
        return plan.seed, fired, len(slept), plan.snapshot()

    got = both(script)
    if env["KOLIBRIE_FAULT_PLAN"].startswith('{"seed"'):
        assert ("wal.append", "InjectedTornWrite") in got[1]


# ------------------------------------------------------------ error taxonomy


def error_cases(pkg):
    E = mod(pkg, "resilience.errors")
    return [
        (E.DeadlineExceeded(site="d.e"), "ctx"),
        (E.Overloaded(retry_after_s=2.5), ""),
        (E.Unavailable("down", phase="draining", retry_after_s=1.5), ""),
        (E.NotPrimary(primary_hint="http://p"), ""),
        (E.DurabilityError("fsync"), "wal"),
        (E.QueryError("bad query"), ""),
        (E.NotFound(), ""),
        (E.RequestTooLarge("big"), ""),
        (E.WindowCrash("w"), ""),
        (E.DeviceFault("d"), ""),
        (ValueError("bad input"), ""),
        (KeyError("k"), ""),
        (RuntimeError("boom"), "ctx"),
        (RuntimeError(""), ""),
    ]


def test_error_response_mappings():
    def script(pkg):
        E = mod(pkg, "resilience.errors")
        return [E.error_response(exc, ctx) for exc, ctx in error_cases(pkg)]

    got = both(script)
    assert got[0] == (504, {"error": "deadline exceeded", "code": "deadline_exceeded",
                            "context": "ctx", "site": "d.e"})
    assert got[1][0] == 429 and got[1][1]["retry_after_s"] == 2.5
    assert got[10][0] == 400 and got[12] == (500, {"error": "boom", "code": "internal",
                                                    "context": "ctx"})


def test_error_response_carries_trace_and_never_swallows_base_exceptions():
    from kolibrie_tpu_torch.obs.spans import trace_scope
    from kolibrie_tpu_torch.resilience.errors import (
        DeadlineExceeded,
        error_response,
        jittered_retry_after,
        reset_retry_jitter,
    )

    with trace_scope("abc123"):
        assert error_response(DeadlineExceeded())[1]["trace_id"] == "abc123"
        assert error_response(ValueError("v"))[1]["trace_id"] == "abc123"
    for exc in (KeyboardInterrupt(), SystemExit(0), GeneratorExit()):
        with pytest.raises(type(exc)):
            error_response(exc)
    from kolibrie_tpu.resilience import errors as RE

    RE.reset_retry_jitter(5)
    reset_retry_jitter(5)
    want = [RE.jittered_retry_after(2.0) for _ in range(4)]
    assert [jittered_retry_after(2.0) for _ in range(4)] == want
    assert all(2.0 <= w <= 3.0 for w in want)


# --------------------------------------------------------- admission control


def test_admission_cap_sheds_with_429():
    def script(pkg):
        A = mod(pkg, "resilience.admission")
        E = mod(pkg, "resilience.errors")
        adm = A.AdmissionController(max_inflight=2, retry_after_s=0.5)
        adm.try_acquire()
        adm.try_acquire()
        out = []
        try:
            adm.try_acquire()
        except E.Overloaded as e:
            out.append((E.error_response(e), e.retry_after_s))
        adm.release()
        with adm.admitted_scope():
            out.append(adm.snapshot())
        out.append(adm.snapshot())
        return out

    got = both(script)
    assert got[0][0][0] == 429
    assert got[-1] == {"max_inflight": 2, "inflight": 1, "peak_inflight": 2,
                       "admitted": 3, "shed": 1}


# -------------------------------------------------------- is_device_fault


def test_is_device_fault_counts_cuda_oom_and_never_a_kernel(monkeypatch, tmp_path):
    import torch

    from kolibrie_tpu_torch.ops import kernels as K
    from kolibrie_tpu_torch.optimizer.device_engine import Unsupported
    from kolibrie_tpu_torch.query.parser import parse_combined_query
    from kolibrie_tpu_torch.resilience import (
        DeviceFault,
        InjectedCompileError,
        InjectedDeviceOOM,
        is_device_fault,
    )

    faults = [
        DeviceFault("x"),
        InjectedCompileError("x"),
        InjectedDeviceOOM("x"),
        MemoryError(),
        torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
        RuntimeError("CUDA out of memory. Tried to allocate 512.00 MiB"),
    ]
    assert all(is_device_fault(e) for e in faults)
    # the port's own kernel errors, raised by the code that raises them
    not_faults = []
    with pytest.raises(RuntimeError) as ei:
        K._check(700, "merge_path")
    not_faults.append(ei.value)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError) as ei:
        K._nvcc()
    not_faults.append(ei.value)
    not_faults.append(RuntimeError("kernel build failed:\nmerge_join.cu:\nerror: expected ';'"))
    not_faults.append(Unsupported("cartesian product"))
    with pytest.raises(Exception) as ei:
        parse_combined_query("SELEC ?x WHERE {", {})
    not_faults.append(ei.value)
    not_faults.append(ValueError("parse"))
    assert "launch failed: CUDA error 700" in str(not_faults[0])
    assert "nvcc not found" in str(not_faults[1])
    assert not any(is_device_fault(e) for e in not_faults), not_faults


def test_kernel_failure_raises_through_the_breaker(monkeypatch):
    """A kernel that fails to launch is not a device fault: the query
    raises, the breaker counts nothing and nothing is served degraded."""
    from kolibrie_tpu.query.sparql_database import SparqlDatabase as RefDatabase
    from kolibrie_tpu_torch.optimizer import device_engine as tde
    from kolibrie_tpu_torch.query.executor import execute_query_volcano
    from kolibrie_tpu_torch.resilience.breaker import breaker_board

    _ref, tdb = pair(tiny_ref_db(RefDatabase))

    def broken(self):
        raise RuntimeError("merge_path launch failed: CUDA error 700")

    monkeypatch.setattr(tde.LoweredPlan, "run", broken)
    for _ in range(4):
        with pytest.raises(RuntimeError, match="launch failed"):
            execute_query_volcano(QUERY_DEPT, tdb)
    (snap,) = breaker_board(tdb).snapshot().values()
    assert (snap["state"], snap["total_failures"], snap["degraded_served"]) == ("closed", 0, 0)


# ----------------------------------------------------- executor integration


def tiny_ref_db(cls, n=30):
    db = cls()
    db.parse_ntriples(
        "\n".join(f'<http://e/x{i}> <http://e/dept> "dept{i % 3}" .' for i in range(n))
    )
    return db


QUERY_DEPT = 'PREFIX ex: <http://e/> SELECT ?e WHERE { ?e ex:dept "dept1" }'
QUERY_PAIR = ('PREFIX ex: <http://e/> SELECT ?a ?b WHERE { ?a ex:dept "dept0" . '
              '?b ex:dept "dept2" . ?a ex:dept ?d }')


class Twins:
    """A reference database and its port twin, each with its own breaker
    board on its own fake clock and its own fault plan."""

    def __init__(self, n=30):
        from kolibrie_tpu.query.sparql_database import SparqlDatabase as RefDatabase

        self.ref, self.port = pair(tiny_ref_db(RefDatabase, n))
        self.clocks = {pkg: FakeClock() for pkg in PKGS}
        for pkg, db in self.dbs():
            mod(pkg, "resilience.breaker").breaker_board(db, clock=self.clocks[pkg])
        self.plans = {}

    def dbs(self):
        return (("kolibrie_tpu", self.ref), ("kolibrie_tpu_torch", self.port))

    def arm(self, site, error=None, **rule):
        for pkg, _db in self.dbs():
            F = mod(pkg, "resilience.faultinject")
            plan = self.plans.get(pkg)
            if plan is None:
                sleep = self.clocks[pkg].advance
                plan = self.plans[pkg] = F.FaultPlan(seed=3, sleep=sleep)
                F.install(plan)
            plan.add(site, error=getattr(F, error) if error else None, **rule)

    def disarm(self):
        for pkg, plan in self.plans.items():
            mod(pkg, "resilience.faultinject").uninstall(plan)
        self.plans = {}

    def advance(self, dt):
        for clk in self.clocks.values():
            clk.advance(dt)

    def state(self, pkg, db):
        return (
            mod(pkg, "resilience.breaker").breaker_board(db).snapshot(),
            mod(pkg, "query.executor").plan_cache_info(db),
            self.plans[pkg].snapshot() if pkg in self.plans else None,
        )

    def run(self, q, deadline_s=None):
        """Run ``q`` on both; rows (or the error's class name and site)
        and the state after must be equal."""
        out = []
        for pkg, db in self.dbs():
            ex = mod(pkg, "query.executor")
            D = mod(pkg, "resilience.deadline")
            dl = None if deadline_s is None else D.Deadline(deadline_s, clock=self.clocks[pkg])
            try:
                with D.deadline_scope(dl):
                    got = sorted(ex.execute_query_volcano(q, db))
            except Exception as e:
                got = (type(e).__name__, getattr(e, "site", None))
            out.append((got, self.state(pkg, db)))
        assert out[1] == out[0], q
        return out[1]

    def batch(self, queries):
        out = []
        for pkg, db in self.dbs():
            got = mod(pkg, "query.executor").execute_queries_batched(db, queries)
            out.append((got, self.state(pkg, db)))
        assert out[1] == out[0]
        return out[1]


@pytest.fixture
def twins():
    t = Twins()
    yield t
    t.disarm()


def test_degrade_trip_skip_and_half_open_recovery(twins):
    twins.arm("device.lower", error="InjectedCompileError", rate=1.0)
    rows, (snap, info, faults) = twins.run(QUERY_DEPT)  # degraded, not erred
    assert len(rows) == 10
    (br,) = snap.values()
    assert (br["state"], br["failures"]) == ("closed", 1)
    for _ in range(2):
        rows, (snap, info, faults) = twins.run(QUERY_DEPT)
    (br,) = snap.values()
    assert (br["state"], br["trips"]) == ("open", 1)  # the third failure trips
    lower_calls = faults["device.lower"]["calls"]
    for _ in range(2):  # open: the device is skipped entirely
        rows, (snap, info, faults) = twins.run(QUERY_DEPT)
        assert len(rows) == 10
    assert faults["device.lower"]["calls"] == lower_calls == 3
    (br,) = snap.values()
    assert br["degraded_served"] == 2
    twins.disarm()
    rows, (snap, info, _f) = twins.run(QUERY_DEPT)  # still inside the backoff
    (br,) = snap.values()
    assert (br["state"], br["degraded_served"]) == ("open", 3)
    twins.advance(1.0)
    rows, (snap, info, _f) = twins.run(QUERY_DEPT)  # the half-open probe
    (br,) = snap.values()
    assert (br["state"], br["close_epoch"], br["total_failures"]) == ("closed", 1, 3)
    assert len(rows) == 10
    # a degraded call keeps its own warm host slot beside the device one
    (tpl,) = info["per_template"].values()
    assert tpl["states"] == 2 and info["sentinel_expiries"] == 0


def test_device_oom_at_execute_degrades(twins):
    twins.arm("device.execute", error="InjectedDeviceOOM", at_calls=[1, 2])
    for want_state in ("closed", "closed", "closed"):
        rows, (snap, _info, _f) = twins.run(QUERY_DEPT)
        assert len(rows) == 10
        (br,) = snap.values()
        assert br["state"] == want_state
    assert br["total_failures"] == 2 and br["failures"] == 0  # the third ran on the device


def test_sticky_sentinel_expires_after_a_recovery(twins):
    """A template whose lowering declined (``Unsupported``: a cartesian
    product) keeps its ``False`` sentinel while its breaker stays closed;
    once the breaker recovers from an open state (``close_epoch`` moves)
    the sentinel expires exactly once and the lowering is retried."""
    q = QUERY_PAIR
    rows, (_s, info, _f) = twins.run(q)
    assert info["sticky_failures"] == 1 and len(rows) == 100
    rows, (_s, info, _f) = twins.run(q)  # the sentinel records epoch 0
    assert info["sentinel_expiries"] == 0
    for pkg, db in twins.dbs():
        (fp,) = mod(pkg, "query.executor").plan_cache_info(db)["per_template"]
        board = mod(pkg, "resilience.breaker").breaker_board(db)
        for _ in range(3):
            board.record_failure(fp)
    twins.advance(1.0)
    for pkg, db in twins.dbs():
        board = mod(pkg, "resilience.breaker").breaker_board(db)
        (fp,) = board.snapshot()
        assert board.allow(fp)  # the half-open probe
        board.record_success(fp)
    rows, (snap, info, _f) = twins.run(q)
    (br,) = snap.values()
    assert br["close_epoch"] == 1 and info["sentinel_expiries"] == 1
    assert info["sticky_failures"] == 1  # retried, declined again
    rows, (snap, info, _f) = twins.run(q)
    assert info["sentinel_expiries"] == 1 and len(rows) == 100


def test_deadline_sheds_at_enter_and_between_lowering_and_dispatch(twins):
    got, (snap, info, _f) = twins.run(QUERY_DEPT, deadline_s=-1.0)
    assert got == ("DeadlineExceeded", "executor.enter")
    assert snap == {} and info["templates"] == 0  # shed before any work
    # lowering takes 1 s of the injected clock: the deadline expires
    # between lowering and dispatch, and the breaker records the failure
    twins.arm("device.lower", latency_s=1.0, at_calls=[1])
    got, (snap, _info, _f) = twins.run(QUERY_DEPT, deadline_s=0.5)
    assert got == ("DeadlineExceeded", "device.execute")
    (br,) = snap.values()
    assert (br["failures"], br["state"]) == (1, "closed")
    rows, (snap, _info, _f) = twins.run(QUERY_DEPT, deadline_s=0.5)
    assert len(rows) == 10


def test_batched_group_with_a_faulted_member(twins):
    batch = [QUERY_DEPT.replace("dept1", f"dept{d}") for d in (0, 1, 2, 1)]
    twins.arm("device.batch", error="InjectedDeviceOOM", at_calls=[1])
    rows, (snap, info, faults) = twins.batch(batch)
    assert [len(r) for r in rows] == [10, 10, 10, 10]
    (br,) = snap.values()
    assert (br["total_failures"], info["batched"]) == (1, 0)  # the group fell to solo
    assert faults["device.batch"] == {"calls": 1, "fires": 1}
    rows, (snap, info, faults) = twins.batch(batch)
    assert info["batched"] == 4 and info["batch_groups"] == 1


def test_auto_mode_routes_a_small_store_to_the_host_engine():
    from kolibrie_tpu.obs import analyze as ref_analyze
    from kolibrie_tpu.query.executor import execute_query_volcano as ref_execute
    from kolibrie_tpu.query.sparql_database import SparqlDatabase as RefDatabase
    from kolibrie_tpu_torch.obs import analyze as port_analyze
    from kolibrie_tpu_torch.query import executor as tex

    ref, tdb = pair(tiny_ref_db(RefDatabase))
    ref.execution_mode = tdb.execution_mode = "auto"
    assert port.SparqlDatabase(device="cpu").execution_mode == "auto"
    assert tdb.clone().execution_mode == "auto"
    assert len(tdb.store) < tex._DEVICE_AUTO_MIN and not tex._device_routed(tdb)
    with ref_analyze.capture() as rc:
        want = ref_execute(QUERY_DEPT, ref)
    with port_analyze.capture() as tc:
        got = port.execute_query_volcano(QUERY_DEPT, tdb)
    assert got == want and len(got) == 10
    assert tc.last("host") == rc.last("host") == {"kind": "host", "reason": "host-routed store"}
    assert tc.last("device") is None
    assert tex.plan_cache_info(tdb)["per_template"] == ref_info(ref)["per_template"]
    from kolibrie_tpu_torch.resilience.breaker import breaker_board

    assert breaker_board(tdb).snapshot() == {}  # host-routed: no breaker


def test_host_routed_store_shares_prefixes_like_the_reference():
    """MQO on a host-routed store (``try_shared_host``): the same rows and
    the same per-prefix counts as the reference; the port evaluates the
    prefix on the store's device (the reference on its numpy twin)."""
    import kolibrie_tpu.optimizer.mqo as ref_mqo
    from kolibrie_tpu.query.executor import execute_query_volcano as ref_execute
    from kolibrie_tpu.query.sparql_database import SparqlDatabase as RefDatabase
    from kolibrie_tpu_torch.optimizer import mqo

    ref, tdb = pair(tiny_ref_db(RefDatabase))
    ref.execution_mode = tdb.execution_mode = "auto"
    texts = [QUERY_DEPT.replace("}", f'FILTER(?e != <http://e/x{i}>) }}') for i in (1, 4, 7)]
    got = {}
    for name, M, execute, db in (("ref", ref_mqo, ref_execute, ref),
                                 ("port", mqo, port.execute_query_volcano, tdb)):
        M.register_standing(db, "w")
        with M.override_mqo_mode("force"), M.standing_scope(db, "w"):
            rows = [execute(q, db) for q in texts]
        st = M.stats(db)["prefixes"]
        got[name] = (rows, {k: {f: v[f] for f in ("shared_evals", "cache_hits", "rows")}
                            for k, v in st.items()})
    assert got["port"] == got["ref"]
    (pfx,) = got["port"][1].values()
    assert pfx["shared_evals"] == 1 and pfx["cache_hits"] == 2
    assert [len(r) for r in got["port"][0]] == [9, 9, 9]


def ref_info(db):
    from kolibrie_tpu.query.executor import plan_cache_info

    return plan_cache_info(db)


def test_chip_smoke_phase14_rehearsal(monkeypatch):
    """``chip_smoke.py`` phase 14 end to end on the CPU at LUBM-2 and 600
    employees (the card runs LUBM-1000 and employee-100K, which "auto"
    routes to the device program; here the two databases are set to
    "device" to take the same route): degraded serving, the breaker's trip
    and half-open recovery, the deadline sheds, the WAL ingest and a
    ``kill -9`` recovery in a second process, every check of the phase
    but the device-memory ones (0 on the CPU)."""
    import torch

    import chip_smoke as CS
    from benches.lubm import LUBM_Q2, LUBM_Q9, generate_fast

    counters = CS.breaker_counters()  # other tests in this process trip breakers
    lubm = port.SparqlDatabase(device="cpu")
    lubm.store.add_batch(*generate_fast(2, lubm.dictionary))
    emp = port.SparqlDatabase(device="cpu")
    emp.parse_ntriples(CS.employee_ntriples(600))
    lubm.execution_mode = emp.execution_mode = "device"
    # the RULE's closure on the device fixpoint, as at LUBM-1000 on the card
    monkeypatch.setattr(port.Reasoner, "_DEVICE_AUTO_MIN_FACTS", 0)
    queries = [("employee", emp, CS.EMPLOYEE_QUERY, "auto"), ("q2", lubm, LUBM_Q2, "auto"),
               ("q9", lubm, LUBM_Q9, "auto")]
    rows = {name: port.execute_query_volcano(q, db) for name, db, q, _w in queries}
    out = CS.run_resilience_phase(torch.device("cpu"), {"queries": queries, "rows": rows},
                                  counters, universities=2, wal_repeats=1)
    rep = out["report"]
    assert rep["idle"]["boards"] >= 2 and rep["idle"]["degraded"] == 0
    for name in CS.RESILIENCE_QUERIES:
        steps = rep["14a"][name]["steps"]
        assert [s["state"] for s in steps] == (["closed"] * 2 + ["open"] * 2 + ["closed"]) * 2 + [
            "closed"]
        assert steps[-1]["epoch"] == 2 and steps[-1]["failures"] == 6
    assert rep["14b"]["device.execute"]["breaker_failures"] == 1
    assert rep["14c"]["bulk_wal"]["records"] == 2
    d = rep["14d"]
    assert d["child"]["acked"] == 4 and d["child_returncode"] == -9
    assert d["snapshot_tail"]["snapshot_generation"] == 1 and d["torn"]["truncated_records"] == 1
    assert set(out["captured"]) >= {"merge_path_join", "lex_probe_select", "filter_mask"}
