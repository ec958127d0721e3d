"""R2R: relation-to-relation — per-window query + reasoning.

Port of ``kolibrie_tpu/rsp/r2r.py`` (parity: ``kolibrie/src/rsp/r2r.rs``,
the ``R2ROperator`` trait, and ``simple_r2r.rs``).  :class:`SimpleR2R`
closes each firing with the host semi-naive strategy; :class:`DeviceR2R`
keeps the window's base facts as padded int64 columns on the database's
device across firings and closes each firing with the device fixpoint.
Either way the per-window SELECT runs on the port's device engine, which
has no host twin.

Unlike the reference, :class:`DeviceR2R` never reruns a firing on the host
after a device failure: a capacity or backend error propagates.  Only rule
sets the fixpoint cannot lower (``Unsupported``) take the host closure, as
in the reference, and ``_device_ok`` turns False when they do.
``IncrementalR2R`` (expiration provenance) comes with the provenance slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from kolibrie_tpu_torch.backend import DeviceLike
from kolibrie_tpu_torch.core.triple import Triple
from kolibrie_tpu_torch.ops import round_cap
from kolibrie_tpu_torch.ops.device_join import set_difference_rows
from kolibrie_tpu_torch.query.ast import SelectQuery
from kolibrie_tpu_torch.query.executor import eval_select_to_table, format_results, table_header
from kolibrie_tpu_torch.query.sparql_database import SparqlDatabase
from kolibrie_tpu_torch.reasoner.n3_parser import parse_n3_document
from kolibrie_tpu_torch.reasoner.reasoner import Reasoner
from kolibrie_tpu_torch.reasoner.rule_runtime import build_reasoner_from_db
from kolibrie_tpu_torch.rsp.s2r import WindowTriple


class R2ROperator:
    """Interface (r2r.rs:21-30)."""

    def load_triples(self, data: str, syntax: str) -> int:
        raise NotImplementedError

    def load_rules(self, rules: str) -> int:
        raise NotImplementedError

    def add(self, item) -> None:
        raise NotImplementedError

    def remove(self, item) -> None:
        raise NotImplementedError

    def materialize(self) -> List[Triple]:
        raise NotImplementedError

    def execute_query(self, plan) -> List:
        raise NotImplementedError


class SimpleR2R(R2ROperator):
    """SparqlDatabase-backed R2R (simple_r2r.rs:25-143).  ``db`` defaults to
    a new database on ``device``."""

    def __init__(self, db: Optional[SparqlDatabase] = None, device: DeviceLike = None):
        self.db = db if db is not None else SparqlDatabase(device=device)
        self.rules: List = []
        self._derived_prev: List[Triple] = []
        # (s, p, o) strings -> encoded Triple.  Sliding windows re-feed the
        # same items every firing; the dictionary is append-only, so memoized
        # encodings stay valid for the db's lifetime.
        self._enc_cache: Dict[tuple, Triple] = {}

    def load_triples(self, data: str, syntax: str = "turtle") -> int:
        syntax = syntax.lower()
        if syntax in ("turtle", "ttl"):
            return self.db.parse_turtle(data)
        if syntax in ("ntriples", "nt"):
            return self.db.parse_ntriples(data)
        if syntax in ("rdfxml", "rdf/xml", "xml", "rdf"):
            raise NotImplementedError("RDF/XML parsing is not ported to kolibrie_tpu_torch")
        if syntax == "n3":
            return self.db.parse_n3(data)
        raise ValueError(f"unknown syntax {syntax!r}")

    def load_rules(self, rules: str) -> int:
        if not rules.strip():
            return 0
        parsed = parse_n3_document(rules, self.db.dictionary)
        self.rules.extend(parsed)
        return len(parsed)

    def _to_triple(self, item) -> Triple:
        if isinstance(item, Triple):
            return item
        if isinstance(item, WindowTriple):
            key = (item.s, item.p, item.o)
            t = self._enc_cache.get(key)
            if t is None:
                if len(self._enc_cache) > 262144:
                    self._enc_cache.clear()  # bound memory on endless streams
                t = Triple(
                    self.db.encode_term_str(item.s),
                    self.db.encode_term_str(item.p),
                    self.db.encode_term_str(item.o),
                )
                self._enc_cache[key] = t
            return t
        raise TypeError(f"unsupported window item {item!r}")

    def add(self, item) -> None:
        self.db.add_triple(self._to_triple(item))

    def remove(self, item) -> None:
        self.db.delete_triple(self._to_triple(item))

    def materialize(self) -> List[Triple]:
        """Evict the previous firing's derived facts, run the host
        semi-naive closure, track the new derived facts
        (simple_r2r.rs:103-128).  The evictions are buffered store deletes
        that land with the firing's arrivals in one compaction."""
        for t in self._derived_prev:
            self.db.delete_triple(t)
        self._derived_prev = []
        if not self.rules:
            return []
        kg = build_reasoner_from_db(self.db)
        for rule in self.rules:
            kg.add_rule(rule)
        before = kg.facts.triples_set()
        kg.infer_new_facts_semi_naive()
        derived = [Triple(*k) for k in kg.facts.triples_set() - before]
        _add_rows(self.db, derived)
        self._derived_prev = derived
        return derived

    def execute_query(self, plan: SelectQuery) -> List[tuple]:
        """Run the per-window SELECT; returns rows of sorted (var, value)
        tuples (simple_r2r.rs:130-143)."""
        table = eval_select_to_table(self.db, plan)
        header = table_header(table, plan)
        rows = format_results(self.db, table, plan)
        return [tuple(sorted(zip(header, row))) for row in rows]


def _add_rows(db: SparqlDatabase, triples: List[Triple]) -> None:
    """Insert triples into ``db`` as one buffered batch."""
    if triples:
        arr = np.array(triples, dtype=np.uint32)
        db.store.add_batch(arr[:, 0], arr[:, 1], arr[:, 2])


class DeviceR2R(SimpleR2R):
    """Device-resident R2R: the window's base facts live as padded int64
    columns on the database's device ACROSS firings, and ``materialize`` is
    a net-delta window-maintenance step (:func:`_window_maintain_impl`: the
    evicted rows set-differenced out, the arrivals appended) and the device
    semi-naive fixpoint (:meth:`DeviceFixpoint.infer_padded`), reading back
    ONLY the derived rows, one transfer per column.

    Port of the TPU redesign of ``kolibrie/src/rsp/simple_r2r.rs:103-128``.
    Semantics are :class:`SimpleR2R`'s: the ``db`` stays authoritative for
    queries (derived facts are inserted and evicted there too), and a count
    guard rebuilds the mirror whenever the db was mutated outside add/remove
    (e.g. a derived fact colliding with a streamed one).  Rule sets the
    fixpoint cannot lower take the host closure for good (``_device_ok``
    False); any other failure propagates and drops the mirror and the
    closure cache, so the next firing rebuilds from the db.
    """

    def __init__(self, db: Optional[SparqlDatabase] = None, device: DeviceLike = None):
        super().__init__(db, device)
        self._pending: List[tuple] = []  # chronological ("add"/"rem", Triple)
        self._base: set = set()  # host twin of the device mirror's rows
        self._mir = None  # (fs, fp, fo) padded int64 device columns
        self._cap = 0
        self._fx = None
        self._caps_cache = None
        self._device_ok = True
        self._last_derived: Optional[List[Triple]] = None

    def load_rules(self, rules: str) -> int:
        n = super().load_rules(rules)
        self._fx = None  # re-lower against the extended rule set
        self._caps_cache = None
        self._last_derived = None
        return n

    def add(self, item) -> None:
        t = self._to_triple(item)
        self.db.add_triple(t)
        if self._device_ok:
            self._pending.append(("add", t))

    def remove(self, item) -> None:
        t = self._to_triple(item)
        self.db.delete_triple(t)
        if self._device_ok:
            self._pending.append(("rem", t))

    # ------------------------------------------------------------- helpers

    def _ensure_lowered(self):
        if self._fx is None:
            from kolibrie_tpu_torch.reasoner.device_fixpoint import DeviceFixpoint

            kg = Reasoner(self.db.dictionary, device=self.db.device)
            for rule in self.rules:
                kg.add_rule(rule)
            self._fx = DeviceFixpoint(kg)
        return self._fx

    def _rebuild_mirror(self) -> None:
        s, p, o = self.db.store.columns()
        n = len(s)
        self._base = set(zip(s.tolist(), p.tolist(), o.tolist()))
        self._cap = round_cap(max(2 * n, 1024))
        self._last_derived = None  # base changed -> closure cache invalid
        buf = np.zeros((3, self._cap), np.int64)
        buf[:, :n] = (s, p, o)
        dev = torch.from_numpy(buf).to(self.db.device)  # one transfer
        self._mir = (dev[0], dev[1], dev[2])

    def _apply_delta(self, rem: List[tuple], add: List[tuple]) -> None:
        """One maintenance step: drop ``rem`` rows, append ``add`` rows.
        Exactness of both lists (all removals present, all adds absent) is
        guaranteed by the host twin, so the new count is known host-side
        without any device readback."""
        n = len(self._base)  # already updated to the post-delta count
        if n > self._cap:
            # grow: rebuild at doubled capacity from the authoritative db
            self._rebuild_mirror()
            return
        rcap = round_cap(max(len(rem), 1), 16)
        acap = round_cap(max(len(add), 1), 16)
        buf = np.zeros((3, rcap + acap), np.int64)
        if rem:
            buf[:, : len(rem)] = np.array(rem, np.int64).T
        if add:
            buf[:, rcap : rcap + len(add)] = np.array(add, np.int64).T
        dev = torch.from_numpy(buf).to(self.db.device)  # one transfer
        fs, fp, fo = self._mir
        self._mir = _window_maintain_impl(
            fs, fp, fo,
            n - len(add) + len(rem),  # count before this delta
            dev[0, :rcap], dev[1, :rcap], dev[2, :rcap], len(rem),
            dev[0, rcap:], dev[1, rcap:], dev[2, rcap:], len(add),
        )

    # --------------------------------------------------------- materialize

    def materialize(self) -> List[Triple]:
        if not self._device_ok:
            return super().materialize()
        from kolibrie_tpu_torch.reasoner.device_fixpoint import Unsupported

        for t in self._derived_prev:
            self.db.delete_triple(t)
        self._derived_prev = []
        if not self.rules:
            # no closure to run; the mirror (not yet built) syncs from the
            # db when rules arrive, so the pendings can be dropped
            self._pending.clear()
            return []
        try:
            fx = self._ensure_lowered()
        except Unsupported:
            self._device_ok = False
            self._pending.clear()
            return super().materialize()

        # Net effect of the chronological pendings: only rows whose final
        # membership differs from their initial one touch the mirror (with
        # overlapping sliding windows, most evict+re-add pairs cancel).
        final: dict = {}
        for op, t in self._pending:
            final[tuple(t)] = op
        self._pending = []
        rem = [k for k, op in final.items() if op == "rem" and k in self._base]
        add = [k for k, op in final.items() if op == "add" and k not in self._base]
        self._base.difference_update(rem)
        self._base.update(add)
        if self._mir is not None and len(self.db.store) == len(self._base):
            if not (rem or add) and self._last_derived is not None:
                # unchanged base between firings: the closure is unchanged
                # too — reinstate the cached derived facts without a device run
                _add_rows(self.db, self._last_derived)
                self._derived_prev = list(self._last_derived)
                return list(self._last_derived)
        try:
            return self._close_on_device(fx, rem, add)
        except BaseException:
            # A failed firing leaves the mirror and the closure cache unknown:
            # the next firing (the supervisor's retry included) rebuilds the
            # mirror from the db and recomputes, or fails again.
            self._mir = None
            self._last_derived = None
            raise

    def _close_on_device(self, fx, rem: List[tuple], add: List[tuple]) -> List[Triple]:
        """Bring the mirror up to ``_base`` and run the device fixpoint over
        it; the derived rows go into the db and the closure cache."""
        from kolibrie_tpu_torch.reasoner.device_fixpoint import _Caps

        if self._mir is None or len(self.db.store) != len(self._base):
            self._rebuild_mirror()  # first firing, or external db mutation
        elif rem or add:
            self._apply_delta(rem, add)

        n0 = len(self._base)
        if n0 == 0:
            self._last_derived = []
            return []
        want = fx._caps(n0)
        c = self._caps_cache
        caps = (
            want
            if c is None
            else _Caps(max(c.fact, want.fact), max(c.delta, want.delta), max(c.join, want.join))
        )
        fs, fp, fo = self._mir
        ofs, ofp, ofo, n_out, caps = fx.infer_padded(fs, fp, fo, n0, caps)
        self._caps_cache = caps
        if n_out <= n0:
            self._last_derived = []
            return []
        s_h, p_h, o_h = (c[n0:n_out].cpu().tolist() for c in (ofs, ofp, ofo))
        derived = list(map(Triple, s_h, p_h, o_h))
        _add_rows(self.db, derived)
        self._derived_prev = derived
        self._last_derived = list(derived)
        return derived


def _window_maintain_impl(fs, fp, fo, n, rs, rp, ro, n_rem, as_, ap_, ao_, n_add):
    """Window maintenance over the padded mirror: set-difference out the
    evicted rows (compacting survivors to the front), then append the
    arrivals at the compacted end.  Port of
    ``kolibrie_tpu/rsp/r2r.py::_window_maintain_impl``; ``n``, ``n_rem`` and
    ``n_add`` are ints or 0-dim tensors, and arrivals past the capacity are
    dropped (written to a spare slot that is cut off)."""
    cap = fs.shape[0]
    acap = as_.shape[0]
    dev = fs.device
    valid = torch.arange(cap, device=dev) < n
    rvalid = torch.arange(rs.shape[0], device=dev) < n_rem
    cols, _valid2, _n2 = set_difference_rows((fs, fp, fo), valid, (rs, rp, ro), rvalid, cap)
    pos = (n - n_rem) + torch.arange(acap, device=dev)
    avalid = torch.arange(acap, device=dev) < n_add
    pos = torch.where(avalid, pos, cap).clamp_(max=cap)
    out = []
    for c, a in zip(cols, (as_, ap_, ao_)):
        buf = torch.cat([c, torch.zeros(1, dtype=torch.int64, device=dev)])
        buf.index_put_((pos,), a)
        out.append(buf[:cap])
    return tuple(out)
