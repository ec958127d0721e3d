"""Copy of ``kolibrie_tpu/resilience/faultinject.py`` for the PyTorch port.

Deterministic fault injection: seeded hooks at named sites.

The serving/query/streaming layers call :func:`fault_point(site)` at the
places where real hardware and real streams fail: device compile
(``device.lower``), device dispatch (``device.execute``,
``device.batch``), window processing
(``rsp.window``), and the WAL's disk path (``wal.append`` for torn
writes and bit flips, ``wal.fsync`` for partial fsyncs — see
:mod:`kolibrie_tpu_torch.durability.wal`).  With no plan installed a fault
point is a single dict lookup — effectively free.

A :class:`FaultPlan` arms sites with rules.  Every rule is
DETERMINISTIC: rate-based rules draw from a per-site ``random.Random``
seeded from ``(plan seed, site)``, so the fire pattern depends only on
the seed and that site's call ordinal — never on wall clock, thread
interleaving across sites, or global RNG state.  ``at_calls`` rules fire
on exact call ordinals (1-based) for tests that need "crash on the third
event" precision.

Faults a rule can inject:

- ``error=ExcClass``  — raise (simulated compile failure, device OOM,
  window-thread crash; pass any exception class or factory)
- ``latency_s=0.2``   — sleep (simulated slow kernel / tunnel stall)

Usage::

    plan = FaultPlan(seed=7)
    plan.add("device.lower", error=InjectedCompileError, rate=0.10)
    plan.add("rsp.window", error=InjectedWindowCrash, at_calls=[3])
    with plan.installed():
        ...

Installation is process-global (the serving stack's fault points must
not need a handle threaded through every layer) and guarded by a lock;
tests install/uninstall around each scenario.  CI runs all of this on
CPU: nothing here touches a device.
"""

from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence

from kolibrie_tpu_torch.resilience.errors import DeviceFault, WindowCrash


class InjectedFault(Exception):
    """Marker mixin — every injected exception also derives from this, so
    handlers can distinguish simulated faults in assertions/logs."""


class InjectedCompileError(DeviceFault, InjectedFault):
    """Simulated device compile failure."""


class InjectedDeviceOOM(DeviceFault, InjectedFault):
    """Simulated device out-of-memory (RESOURCE_EXHAUSTED)."""


class InjectedWindowCrash(WindowCrash, InjectedFault):
    """Simulated window-processor thread crash."""


class InjectedTornWrite(InjectedFault):
    """Simulated crash mid-``write()``: the WAL appender writes a PREFIX
    of the frame and fails the append (site ``wal.append``).  Recovery
    must truncate the torn tail."""


class InjectedBitFlip(InjectedFault):
    """Simulated silent corruption: the WAL appender flips one payload
    bit and completes the append without error (site ``wal.append``).
    Only the recovery scanner's CRC notices."""


class InjectedFsyncFault(InjectedFault, OSError):
    """Simulated partial/failed fsync (site ``wal.fsync``): data may have
    reached the disk cache but durability cannot be acknowledged."""


class InjectedShipTorn(InjectedFault):
    """Simulated link failure mid-ship (site ``repl.send``): a PREFIX of
    the protocol frame reaches the peer, then the connection dies.  The
    receiver sees a short read / CRC failure and must reconnect and
    re-request — never apply the partial frame."""


class InjectedShipDrop(InjectedFault):
    """Simulated dropped delivery (site ``repl.send``): the frame
    silently never leaves the sender.  The receiver times out and
    re-requests on a fresh connection."""


class InjectedShipDuplicate(InjectedFault):
    """Simulated duplicated delivery (site ``repl.send``): the frame is
    sent TWICE back-to-back.  The receiver must treat the replay as a
    no-op (sequence ids at the protocol layer, applied-segment watermark
    at the replication layer)."""


class _SiteRule:
    __slots__ = (
        "site",
        "error",
        "latency_s",
        "rate",
        "at_calls",
        "max_fires",
        "rng",
        "calls",
        "fires",
    )

    def __init__(
        self,
        site: str,
        seed: int,
        error: Optional[Callable[[], Exception]],
        latency_s: float,
        rate: float,
        at_calls: Optional[Sequence[int]],
        max_fires: Optional[int],
    ):
        self.site = site
        self.error = error
        self.latency_s = latency_s
        self.rate = rate
        self.at_calls = frozenset(at_calls) if at_calls is not None else None
        self.max_fires = max_fires
        # per-site stream: cross-site call interleaving cannot perturb
        # this site's fire pattern
        self.rng = random.Random(f"{seed}:{site}")
        self.calls = 0
        self.fires = 0

    def fire_decision(self) -> bool:
        self.calls += 1
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        if self.at_calls is not None:
            hit = self.calls in self.at_calls
        else:
            hit = self.rng.random() < self.rate
        if hit:
            self.fires += 1
        return hit


class FaultPlan:
    """A seeded registry of per-site fault rules."""

    def __init__(self, seed: int = 0, sleep: Callable[[float], None] = time.sleep):
        self.seed = seed
        self._sleep = sleep
        self._rules: Dict[str, _SiteRule] = {}
        self._lock = threading.Lock()

    def add(
        self,
        site: str,
        error: Optional[Callable[[], Exception]] = None,
        latency_s: float = 0.0,
        rate: float = 1.0,
        at_calls: Optional[Sequence[int]] = None,
        max_fires: Optional[int] = None,
    ) -> "FaultPlan":
        """Arm ``site``.  ``rate`` is the per-call fire probability (drawn
        from the site's seeded stream) unless ``at_calls`` pins exact
        1-based call ordinals.  ``max_fires`` bounds total injections.
        Returns self for chaining."""
        if error is None and latency_s <= 0.0:
            raise ValueError("rule injects nothing: pass error= or latency_s=")
        self._rules[site] = _SiteRule(
            site, self.seed, error, latency_s, rate, at_calls, max_fires
        )
        return self

    def hit(self, site: str) -> None:
        """Called by :func:`fault_point` — decide and inject."""
        rule = self._rules.get(site)
        if rule is None:
            return
        with self._lock:
            fire = rule.fire_decision()
        if not fire:
            return
        if rule.latency_s > 0.0:
            self._sleep(rule.latency_s)
        if rule.error is not None:
            raise rule.error(f"injected fault at {site} (call {rule.calls})")

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {
                site: {"calls": r.calls, "fires": r.fires}
                for site, r in self._rules.items()
            }

    @contextmanager
    def installed(self):
        install(self)
        try:
            yield self
        finally:
            uninstall(self)


# -------------------------------------------------------------- global hook

_active_lock = threading.Lock()
_active: List[FaultPlan] = []


def install(plan: FaultPlan) -> None:
    with _active_lock:
        _active.append(plan)


def uninstall(plan: Optional[FaultPlan] = None) -> None:
    with _active_lock:
        if plan is None:
            del _active[:]
        elif plan in _active:
            _active.remove(plan)


def active_plans() -> List[FaultPlan]:
    with _active_lock:
        return list(_active)


def fault_point(site: str) -> None:
    """The hook the production code calls.  No plan installed → a list
    check and return; armed → may sleep and/or raise."""
    if not _active:
        return
    for plan in active_plans():
        plan.hit(site)


# ------------------------------------------------------------- env plans

#: error-class names an env-declared rule may inject — chaos tests arm
#: child SERVER processes through the environment, where passing a
#: class object is impossible
_ENV_ERRORS = {
    cls.__name__: cls
    for cls in (
        InjectedCompileError,
        InjectedDeviceOOM,
        InjectedWindowCrash,
        InjectedTornWrite,
        InjectedBitFlip,
        InjectedFsyncFault,
        InjectedShipTorn,
        InjectedShipDrop,
        InjectedShipDuplicate,
    )
}

FAULT_PLAN_ENV = "KOLIBRIE_FAULT_PLAN"


def plan_from_env(env: Optional[Dict[str, str]] = None) -> Optional[FaultPlan]:
    """Build (but do not install) a plan from ``KOLIBRIE_FAULT_PLAN`` —
    JSON like::

        {"seed": 7, "rules": [
            {"site": "repl.send", "error": "InjectedShipDuplicate",
             "rate": 0.25, "max_fires": 4}]}

    Returns None when the variable is unset/empty.  Malformed JSON or an
    unknown error name raises ``ValueError`` loudly — a chaos run with a
    silently-ignored fault plan would "pass" by testing nothing."""
    import json as _json
    import os as _os

    raw = (env if env is not None else _os.environ).get(FAULT_PLAN_ENV, "")
    if not raw.strip():
        return None
    try:
        spec = _json.loads(raw)
    except _json.JSONDecodeError as exc:
        raise ValueError(f"unparseable {FAULT_PLAN_ENV}: {exc}") from exc
    plan = FaultPlan(seed=int(spec.get("seed", 0)))
    for rule in spec.get("rules", []):
        name = rule.get("error")
        if name is not None and name not in _ENV_ERRORS:
            raise ValueError(f"{FAULT_PLAN_ENV} names unknown error {name!r}")
        plan.add(
            rule["site"],
            error=_ENV_ERRORS[name] if name is not None else None,
            latency_s=float(rule.get("latency_s", 0.0)),
            rate=float(rule.get("rate", 1.0)),
            at_calls=rule.get("at_calls"),
            max_fires=rule.get("max_fires"),
        )
    return plan
