"""RSPBuilder — fluent construction of an RSPEngine from an RSP-QL REGISTER
query.

Parity: ``kolibrie/src/rsp/builder.rs`` — parses the REGISTER query into
``RSPQueryConfig{windows, output_stream, stream_type, static_patterns,
sync_policy}`` (:159-209), builds per-window plans from the WINDOW block
patterns (:212-276), resolves per-window ``WITH POLICY`` over the builder
default (:85-187), and validates cross-window configuration (:341-354).

Port of ``kolibrie_tpu/rsp/builder.py``; the builder gains ``device``, which
it passes on to the engine (the CUDA card unless the caller passes another).
"""

from __future__ import annotations

from typing import Callable, List, Optional

from kolibrie_tpu_torch.query.ast import (
    SelectItem,
    SelectQuery,
    SyncPolicy,
    WhereClause,
)
from kolibrie_tpu_torch.backend import DeviceLike
from kolibrie_tpu_torch.query.parser import parse_combined_query
from kolibrie_tpu_torch.rsp.engine import (
    CrossWindowReasoningMode,
    OperationMode,
    RSPEngine,
    RSPWindowConfig,
)


class RSPBuilder:
    def __init__(self, query: Optional[str] = None, device: DeviceLike = None):
        self._query_text = query
        self._device = device
        self._operation_mode = OperationMode.SINGLE_THREAD
        self._sync_policy: Optional[SyncPolicy] = None
        self._static_data = ""
        self._initial_triples = ""
        self._syntax = "turtle"
        self._rules = ""
        self._consumer: Optional[Callable] = None
        self._cross_window_rules_text: Optional[str] = None
        self._cross_window_mode = CrossWindowReasoningMode.INCREMENTAL
        self._r2r_mode: Optional[str] = None
        self._supervision = None

    # fluent configuration ---------------------------------------------------

    def query(self, text: str) -> "RSPBuilder":
        self._query_text = text
        return self

    def set_operation_mode(self, mode: str) -> "RSPBuilder":
        self._operation_mode = mode
        return self

    def set_sync_policy(self, policy: SyncPolicy) -> "RSPBuilder":
        self._sync_policy = policy
        return self

    def add_static_data(self, turtle: str) -> "RSPBuilder":
        self._static_data += "\n" + turtle
        return self

    def add_triples(self, data: str, syntax: str = "turtle") -> "RSPBuilder":
        self._initial_triples += "\n" + data
        self._syntax = syntax
        return self

    def add_rules(self, n3_rules: str) -> "RSPBuilder":
        self._rules += "\n" + n3_rules
        return self

    def set_cross_window_rules(self, n3_rules: str) -> "RSPBuilder":
        self._cross_window_rules_text = n3_rules
        return self

    def set_cross_window_reasoning_mode(self, mode: str) -> "RSPBuilder":
        self._cross_window_mode = mode
        return self

    def with_consumer(self, fn: Callable) -> "RSPBuilder":
        self._consumer = fn
        return self

    def set_r2r_mode(self, mode: str) -> "RSPBuilder":
        """Per-window reasoning backend: ``"device"`` (device-resident
        window columns + device fixpoint per firing —
        :class:`kolibrie_tpu_torch.rsp.r2r.DeviceR2R`; also ``"auto"`` and
        the default), ``"host"`` (host closure per firing), or
        ``"incremental"`` (expiration-provenance closure carried across
        firings, delta-seeded per firing —
        :class:`kolibrie_tpu_torch.rsp.r2r.IncrementalR2R`)."""
        self._r2r_mode = mode
        return self

    def with_supervision(self, config) -> "RSPBuilder":
        """Window supervision policy
        (:class:`kolibrie_tpu_torch.resilience.SupervisionConfig`): event-retry
        and dead-letter bounds, restart backoff, checkpoint cadence."""
        self._supervision = config
        return self

    # build ------------------------------------------------------------------

    def build(self) -> RSPEngine:
        if not self._query_text:
            raise ValueError("RSPBuilder requires a REGISTER query")
        cq = parse_combined_query(self._query_text)
        if cq.register is None:
            raise ValueError("query must contain a REGISTER clause")
        reg = cq.register
        select = reg.select
        window_blocks = {wb.window_iri: wb for wb in select.where.window_blocks}

        configs: List[RSPWindowConfig] = []
        policy: Optional[SyncPolicy] = self._sync_policy
        for wc in reg.windows:
            wb = window_blocks.get(wc.window_iri)
            where = WhereClause(
                patterns=list(wb.patterns) if wb else [],
                filters=list(wb.filters) if wb else [],
            )
            wquery = SelectQuery(
                select=[SelectItem("var", var="*")],
                where=where,
                prefixes=dict(select.prefixes),
            )
            if wc.policy is not None:
                # per-window WITH POLICY takes precedence over builder default
                policy = wc.policy
            configs.append(
                RSPWindowConfig(
                    window_iri=wc.window_iri,
                    stream_iri=wc.stream_iri,
                    width=wc.spec.width,
                    slide=wc.spec.slide,
                    report=wc.spec.report,
                    tick=wc.spec.tick,
                    query=wquery,
                )
            )

        # static patterns: main WHERE patterns outside WINDOW blocks
        static_query: Optional[SelectQuery] = None
        if select.where.patterns:
            static_query = SelectQuery(
                select=[SelectItem("var", var="*")],
                where=WhereClause(
                    patterns=list(select.where.patterns),
                    filters=list(select.where.filters),
                ),
                prefixes=dict(select.prefixes),
            )

        return RSPEngine(
            window_configs=configs,
            stream_type=reg.stream_type.value,
            consumer=self._consumer,
            operation_mode=self._operation_mode,
            sync_policy=policy,
            static_query=static_query,
            static_data=self._static_data,
            initial_triples=self._initial_triples,
            syntax=self._syntax,
            rules=self._rules,
            cross_window_mode=self._cross_window_mode,
            cross_window_rules_text=self._cross_window_rules_text,
            r2r_mode=self._r2r_mode,
            supervision=self._supervision,
            device=self._device,
        )
