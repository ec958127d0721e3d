"""Thin wrapper around CSPARQLWindow (parity: ``rsp/window_runner.rs``).

Copy of ``kolibrie_tpu/rsp/window_runner.py`` for the PyTorch port."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from kolibrie_tpu_torch.rsp.s2r import CSPARQLWindow, Report, ReportStrategy, Tick


@dataclass
class WindowSpec:
    window_iri: str
    stream_iri: str
    width: int
    slide: int
    report: str = ReportStrategy.ON_WINDOW_CLOSE
    tick: str = Tick.TIME_DRIVEN
    # standing-query registration token: the RSP engine registers the
    # window's query under this owner with the store's MQO prefix
    # registry (optimizer/mqo.py, docs/MQO.md); ``on_stop`` unregisters
    # it when the runner's lifecycle ends, so a stopped window never
    # counts as a sharing beneficiary
    standing_owner: Optional[str] = None
    on_stop: Optional[Callable[[], None]] = None


class WindowRunner:
    def __init__(self, spec: WindowSpec):
        self.spec = spec
        report = Report()
        report.add(ReportStrategy.from_name(spec.report))
        self.window = CSPARQLWindow(
            spec.width, spec.slide, report, spec.tick, spec.window_iri
        )

    def add_to_window(self, item, ts: int) -> None:
        self.window.add_to_window(item, ts)

    def register_callback(self, fn) -> None:
        self.window.register_callback(fn)

    def register(self):
        return self.window.register()

    def flush(self) -> None:
        self.window.flush()

    def stop(self) -> None:
        self.window.stop()
        if self.spec.on_stop is not None:
            self.spec.on_stop()
