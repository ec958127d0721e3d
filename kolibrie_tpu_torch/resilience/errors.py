"""The error classes of ``kolibrie_tpu/resilience/errors.py`` that the
PyTorch port raises: the taxonomy's base, device faults and window
crashes.  The HTTP mapping and the serving-layer classes come with the
serving slice."""

from __future__ import annotations


class KolibrieError(Exception):
    """Base of the taxonomy."""

    code = "internal"


class DeviceFault(KolibrieError):
    """Device-side failure (compile error, OOM, kernel fault)."""

    code = "device_fault"


class WindowCrash(KolibrieError):
    """A window processor thread died mid-event.  The supervisor restarts
    it (multi-thread mode) or the session restores from its last
    checkpoint (single-thread serving)."""

    code = "window_crashed"
