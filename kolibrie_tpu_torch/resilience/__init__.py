"""Resilience subsystem of the PyTorch port (``kolibrie_tpu/resilience/``):
deadlines, admission control, circuit breakers, window supervision, and
deterministic fault injection.

The reference's docs/RESILIENCE.md has the failure-mode map and
configuration; the port keeps its names and semantics.  One difference:
:func:`is_device_fault` counts CUDA's out-of-memory errors where the
reference counts XLA's, and never a kernel's build or launch failure."""

from kolibrie_tpu_torch.resilience.admission import AdmissionController
from kolibrie_tpu_torch.resilience.breaker import (
    BreakerBoard,
    CircuitBreaker,
    breaker_board,
)
from kolibrie_tpu_torch.resilience.deadline import (
    Deadline,
    check_deadline,
    current_deadline,
    deadline_scope,
    remaining_s,
)
from kolibrie_tpu_torch.resilience.errors import (
    BadRequest,
    DeadlineExceeded,
    DeviceFault,
    KolibrieError,
    NotFound,
    Overloaded,
    QueryError,
    RequestTooLarge,
    WindowCrash,
    error_response,
    is_device_fault,
)
from kolibrie_tpu_torch.resilience.faultinject import (
    FaultPlan,
    InjectedCompileError,
    InjectedDeviceOOM,
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
    "AdmissionController",
    "BadRequest",
    "BreakerBoard",
    "CircuitBreaker",
    "DeadLetter",
    "Deadline",
    "DeadlineExceeded",
    "DeviceFault",
    "FaultPlan",
    "InjectedCompileError",
    "InjectedDeviceOOM",
    "InjectedFault",
    "InjectedWindowCrash",
    "KolibrieError",
    "NotFound",
    "Overloaded",
    "QueryError",
    "RequestTooLarge",
    "SupervisionConfig",
    "WindowCrash",
    "WindowSupervisor",
    "breaker_board",
    "check_deadline",
    "current_deadline",
    "deadline_scope",
    "error_response",
    "fault_point",
    "is_device_fault",
    "remaining_s",
]
