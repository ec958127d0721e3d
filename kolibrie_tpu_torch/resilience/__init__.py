"""Resilience subsystem of the PyTorch port: the error classes the port
raises, deterministic fault injection and window supervision (from
``kolibrie_tpu/resilience/errors.py``, ``faultinject.py`` and
``supervisor.py``).  Deadlines, admission control, circuit breakers and
the HTTP error mapping come with the serving slice."""

from kolibrie_tpu_torch.resilience.errors import (
    DeviceFault,
    KolibrieError,
    WindowCrash,
)
from kolibrie_tpu_torch.resilience.faultinject import (
    FaultPlan,
    InjectedCompileError,
    InjectedFault,
    InjectedWindowCrash,
    fault_point,
)
from kolibrie_tpu_torch.resilience.supervisor import (
    DeadLetter,
    SupervisionConfig,
    WindowSupervisor,
)

__all__ = [
    "DeadLetter",
    "DeviceFault",
    "FaultPlan",
    "InjectedCompileError",
    "InjectedFault",
    "InjectedWindowCrash",
    "KolibrieError",
    "SupervisionConfig",
    "WindowCrash",
    "WindowSupervisor",
    "fault_point",
]
