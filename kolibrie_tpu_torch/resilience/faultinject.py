"""Copy of ``kolibrie_tpu/resilience/faultinject.py`` for the PyTorch port,
without the injections of the log, fsync and replication paths the port
does not have, and without the environment-declared plans.

Deterministic fault injection: seeded hooks at named sites.

Code calls :func:`fault_point(site)` where real streams fail; in the
port that is window processing (``rsp.window``, in the supervisor).
With no plan installed a fault point is a single list check — effectively
free.

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


class InjectedWindowCrash(WindowCrash, InjectedFault):
    """Simulated window-processor thread crash."""


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
