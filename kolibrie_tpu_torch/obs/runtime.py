"""Copy of ``kolibrie_tpu/obs/runtime.py`` for the PyTorch port.

Observability kill switch shared by spans and metrics.

One process-wide flag, initialized from ``KOLIBRIE_OBS_DISABLED=1`` and
flippable at runtime (:func:`set_enabled`) so the bench can measure the
instrumented and uninstrumented executor in the SAME process.  Every
obs entry point checks :func:`enabled` first; disabled, the whole
subsystem costs one attribute read per call site.
"""

from __future__ import annotations

import os

_enabled: bool = os.environ.get("KOLIBRIE_OBS_DISABLED") != "1"


def enabled() -> bool:
    return _enabled


def set_enabled(value: bool) -> None:
    global _enabled
    _enabled = bool(value)
