"""Crash flight recorder: postmortem bundles that survive the process.

Every diagnostic surface this package grew — the span ring, the metrics
timeline ring, the structured-log tail — is process memory, and a dead
process takes it to the grave.  The flight recorder writes those
surfaces to disk as a **postmortem bundle**: a directory under
``<data_dir>/postmortem/`` holding

- ``manifest.json`` — reason, wall time, pid, role, artifact list;
- ``spans.jsonl``   — the span ring, one span per line;
- ``timeline.json`` — the metrics timeline ring rendered as series;
- ``log_tail.jsonl``— the structured-log tail ring;
- ``stats.json``    — the server's ``/stats`` payload (best effort);
- ``config.json``   — argv, python version, and ``KOLIBRIE_*``/``JAX_*``
  environment.

Two write modes, both through :mod:`kolibrie_tpu_torch.durability.fsio`:

- :func:`dump` publishes a uniquely-named bundle via temp-dir write +
  :func:`~kolibrie_tpu_torch.durability.fsio.atomic_rename_dir` — a crash
  mid-dump leaves either no bundle or a complete one.  Used on SIGTERM
  (the graceful-shutdown path), fatal errors (:func:`install_excepthook`)
  and ``POST /debug/bundle``.
- :class:`FlightRecorder` keeps a rolling **blackbox** bundle fresh from
  a background thread, each artifact replaced individually with
  :func:`~kolibrie_tpu_torch.durability.fsio.atomic_write_bytes`.  ``kill -9``
  cannot be caught, so the blackbox is how a hard-killed primary still
  leaves evidence — the chaos drill asserts exactly that.  Checkpoints
  skip the fsync (a SIGKILL loses process buffers, not the page cache);
  terminal dumps pay it.

Copy of ``kolibrie_tpu/obs/flightrec.py`` for the PyTorch port, its imports
rewritten.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from kolibrie_tpu_torch.durability import fsio
from kolibrie_tpu_torch.obs import log as obslog
from kolibrie_tpu_torch.obs import metrics as obs_metrics
from kolibrie_tpu_torch.obs import spans
from kolibrie_tpu_torch.obs import timeseries

BLACKBOX_DIRNAME = "blackbox"
DEFAULT_CHECKPOINT_INTERVAL_S = 5.0

_log = obslog.get_logger("flightrec")

# reasons are a closed set (checkpoint/sigterm/fatal/manual) — bounded
# label cardinality
_BUNDLES = obs_metrics.counter(
    "kolibrie_postmortem_bundles_total",
    "postmortem bundles written, by trigger",
    labels=("reason",),
)


def postmortem_dir(data_dir: str) -> str:
    return os.path.join(data_dir, "postmortem")


def _config_snapshot() -> dict:
    env = {
        k: v
        for k, v in os.environ.items()
        if k.startswith(("KOLIBRIE_", "JAX_"))
    }
    return {
        "argv": list(sys.argv),
        "pid": os.getpid(),
        "python": sys.version.split()[0],
        "env": env,
    }


def _artifacts(
    stats_fn: Optional[Callable[[], dict]],
    ring: Optional[timeseries.TimeSeriesRing],
) -> Dict[str, bytes]:
    """Render every diagnostic surface to bytes.  Pure reads — safe to
    call from a signal-adjacent shutdown path or an excepthook."""
    stats: Any = None
    if stats_fn is not None:
        try:
            stats = stats_fn()
        except Exception as exc:
            stats = {"error": repr(exc)}
    if ring is None:
        ring = timeseries.default_ring()
    try:
        timeline = ring.series()
    except Exception as exc:
        timeline = {"error": repr(exc)}
    enc = lambda obj: json.dumps(  # noqa: E731
        obj, sort_keys=True, default=str
    ).encode()
    return {
        "spans.jsonl": (spans.export_jsonl() + "\n").encode(),
        "timeline.json": enc(timeline),
        "log_tail.jsonl": (obslog.export_jsonl() + "\n").encode(),
        "stats.json": enc(stats),
        "config.json": enc(_config_snapshot()),
    }


def _manifest(reason: str, names: List[str]) -> bytes:
    return json.dumps(
        {
            "reason": reason,
            "ts": round(time.time(), 6),
            "pid": os.getpid(),
            "role": obslog.get_role(),
            "artifacts": sorted(names),
        },
        sort_keys=True,
    ).encode()


def dump(
    data_dir: str,
    reason: str,
    stats_fn: Optional[Callable[[], dict]] = None,
    ring: Optional[timeseries.TimeSeriesRing] = None,
) -> str:
    """Write one uniquely-named bundle; returns its path.  The temp-dir
    write + atomic rename means a reader never sees a partial bundle."""
    root = postmortem_dir(data_dir)
    os.makedirs(root, exist_ok=True)
    name = f"pm-{int(time.time() * 1000)}-{os.getpid()}-{reason}"
    final = os.path.join(root, name)
    tmp = os.path.join(root, f".{name}.tmp")
    os.makedirs(tmp, exist_ok=True)
    files = _artifacts(stats_fn, ring)
    for fname, data in files.items():
        fsio.atomic_write_bytes(os.path.join(tmp, fname), data)
    fsio.atomic_write_bytes(
        os.path.join(tmp, "manifest.json"),
        _manifest(reason, list(files)),
    )
    fsio.atomic_rename_dir(tmp, final)
    _BUNDLES.labels(reason).inc()
    _log.info("postmortem bundle written", reason=reason, path=final)
    return final


def try_dump(data_dir: str, reason: str, **kw: Any) -> Optional[str]:
    """:func:`dump`, but a recorder failure on a dying process must not
    mask the original failure — log and return None instead."""
    try:
        return dump(data_dir, reason, **kw)
    except Exception as exc:
        _log.error("postmortem dump failed", reason=reason, error=repr(exc))
        return None


def install_excepthook(
    data_dir: str,
    stats_fn: Optional[Callable[[], dict]] = None,
) -> None:
    """Chain a bundle dump in front of the current ``sys.excepthook`` so
    an uncaught fatal error on the main thread leaves evidence."""
    prior = sys.excepthook

    def _hook(exc_type, exc, tb):
        try_dump(data_dir, "fatal", stats_fn=stats_fn)
        prior(exc_type, exc, tb)

    sys.excepthook = _hook


def read_bundle(path: str) -> dict:
    """Parse a bundle back into dicts/lists — the test-side consumer.
    Raises on malformed JSON: parseability IS the assertion."""
    out: Dict[str, Any] = {}
    with open(os.path.join(path, "manifest.json")) as fh:
        out["manifest"] = json.load(fh)
    for fname in out["manifest"]["artifacts"]:
        fpath = os.path.join(path, fname)
        with open(fpath) as fh:
            text = fh.read()
        key = fname.rsplit(".", 1)[0]
        if fname.endswith(".jsonl"):
            out[key] = [
                json.loads(line) for line in text.splitlines() if line.strip()
            ]
        else:
            out[key] = json.loads(text)
    return out


def list_bundles(data_dir: str) -> List[str]:
    """Bundle paths under ``data_dir``, oldest first (blackbox last)."""
    root = postmortem_dir(data_dir)
    if not os.path.isdir(root):
        return []
    names = [
        n
        for n in sorted(os.listdir(root))
        if not n.startswith(".")
        and os.path.isfile(os.path.join(root, n, "manifest.json"))
    ]
    names.sort(key=lambda n: n == BLACKBOX_DIRNAME)
    return [os.path.join(root, n) for n in names]


class FlightRecorder:
    """Rolling blackbox: a daemon thread refreshing one well-known
    bundle directory so even ``kill -9`` leaves a recent snapshot."""

    def __init__(
        self,
        data_dir: str,
        interval_s: float = DEFAULT_CHECKPOINT_INTERVAL_S,
        stats_fn: Optional[Callable[[], dict]] = None,
        ring: Optional[timeseries.TimeSeriesRing] = None,
    ):
        self.data_dir = data_dir
        self.interval_s = interval_s
        self.stats_fn = stats_fn
        self.ring = ring
        self._stats_lock = threading.Lock()
        self.checkpoints = 0  # guarded by: _stats_lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def blackbox_path(self) -> str:
        return os.path.join(postmortem_dir(self.data_dir), BLACKBOX_DIRNAME)

    def checkpoint(self) -> str:
        """Refresh the blackbox in place.  Each artifact is replaced
        atomically (fsync skipped — see module docstring), manifest
        last, so a concurrent reader always parses cleanly."""
        box = self.blackbox_path
        os.makedirs(box, exist_ok=True)
        files = _artifacts(self.stats_fn, self.ring)
        for fname, data in files.items():
            fsio.atomic_write_bytes(
                os.path.join(box, fname), data, fsync=False
            )
        fsio.atomic_write_bytes(
            os.path.join(box, "manifest.json"),
            _manifest("checkpoint", list(files)),
            fsync=False,
        )
        with self._stats_lock:
            self.checkpoints += 1
        _BUNDLES.labels("checkpoint").inc()
        return box

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="kolibrie-flightrec", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.checkpoint()
            except Exception as exc:
                _log.error("blackbox checkpoint failed", error=repr(exc))

    def stats(self) -> dict:
        with self._stats_lock:
            done = self.checkpoints
        return {
            "interval_s": self.interval_s,
            "checkpoints": done,
            "blackbox": self.blackbox_path,
        }


# Debug-build runtime check of the # guarded by: annotations above
# (no-op unless KOLIBRIE_DEBUG_LOCKS=1 — see analysis/lockcheck.py)
from kolibrie_tpu_torch.analysis import lockcheck as _lockcheck

_lockcheck.auto_instrument(globals())
