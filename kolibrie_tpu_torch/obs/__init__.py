"""kolibrie_tpu_torch.obs — spans and metrics of the PyTorch port.

Copies of ``kolibrie_tpu/obs/runtime.py``, ``metrics.py`` and ``spans.py``:
stdlib-only, importing nothing from the engine, so any layer may instrument
itself without cycles.  The exposition and flight-recorder modules come
with the serving slice.
"""

from kolibrie_tpu_torch.obs.runtime import enabled, set_enabled  # noqa: F401
from kolibrie_tpu_torch.obs import metrics, spans  # noqa: F401
