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
:class:`IncrementalR2R` carries the closure across firings as expiration
provenance and seeds each firing's tagged fixpoint with the delta only.
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
            return self.db.parse_rdf(data)
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


class IncrementalR2R(SimpleR2R):
    """Delta-incremental per-firing reasoning via expiration provenance.

    Instead of recomputing the window closure from scratch every firing
    (``SimpleR2R.materialize``), the closure state — every fact tagged with
    its expiry timestamp (⊕ = max over derivations, ⊗ = min over premises,
    ``reasoner/provenance.py::ExpirationProvenance``) — is CARRIED across
    firings, and each firing runs the explicit-delta provenance semi-naive
    entry (``provenance_seminaive.semi_naive_with_initial_tags_and_delta``,
    parity ``provenance_semi_naive.rs:271-294``) seeded with ONLY the
    facts that arrived or improved since the previous firing.  Evictions
    cost nothing: a derived fact dies when its shortest-lived premise does,
    which the expiry tag already records.

    Eviction exactness: the per-window content is diffed against the
    previous firing (``feed_window``), and the prune clock ``_now``
    advances to the max expiry among evicted base facts.  For sliding
    windows eviction is strictly by age, so every alive fact's expiry is
    strictly greater than every evicted fact's — pruning state by
    ``expiry > _now`` is exactly content-diff eviction, including for
    derived facts.

    The driver feeds full window contents via :meth:`feed_window` (dict
    max-merge makes re-fed overlapping items O(1) no-ops) and fires
    :meth:`materialize_incremental`.  The legacy add/remove/materialize
    surface still works but permanently drops to the SimpleR2R full
    recompute (the two content-accounting models cannot be mixed).  On
    the CUDA card the delta closure auto-routes to the device provenance
    fixpoint (``device_provenance.infer_provenance_device``) from
    ``AUTO_MIN_FACTS`` facts, so incremental and device-resident execution
    compose; the closure's reasoner runs on ``db.device``.

    Exactness domain: ONE window.  With several windows of differing
    widths the single prune clock can run ahead of a quiet window (whose
    stale-but-unfired contents the host path would keep serving), so the
    engine only selects this class for single-window queries; multi-window
    incremental reasoning is the cross-window SDS+ coordinator's job
    (``reasoner/cross_window.py``), which carries per-window expiries.
    """

    def __init__(self, db: Optional[SparqlDatabase] = None, device: DeviceLike = None):
        super().__init__(db, device)
        self._buckets: Dict[str, Dict[tuple, int]] = {}  # window -> key -> expiry
        self._delta: Dict[tuple, int] = {}  # pending delta (max-merged)
        self._now: int = 0  # monotone prune clock
        self._state = None  # (s, p, o, expiry) sorted dedup'd closure columns
        self._tags: Dict[tuple, int] = {}  # closure expiry map (alive)
        self._derived_in_db: set = set()
        self._legacy = False  # add()/remove() used -> SimpleR2R semantics

    # -------------------------------------------------- legacy surface

    def add(self, item) -> None:
        self._legacy = True
        super().add(item)

    def remove(self, item) -> None:
        self._legacy = True
        super().remove(item)

    def materialize(self) -> List[Triple]:
        self._legacy = True
        # hand db bookkeeping back to the full-recompute path
        for k in self._derived_in_db:
            self.db.delete_triple(Triple(*k))
        self._derived_in_db = set()
        self._state = None
        self._tags = {}
        return super().materialize()

    # -------------------------------------------------- incremental path

    def feed_window(self, window_iri: str, width: int, items) -> None:
        """Reconcile one window's full content (``(item, event_ts)`` pairs)
        against the previous firing: new/improved facts join the pending
        delta, vanished facts advance the prune clock and leave the db.

        Both the adds and the eviction deletes are buffered store
        mutations — disjoint delete+insert traffic (the window-slide
        shape) stays buffered and lands as ONE incremental delta at the
        next compaction, leaving cached device plans and sort orders
        intact (see ``docs/STORE.md``)."""
        bucket = self._buckets.setdefault(window_iri, {})
        seen = set()
        for item, ets in items:
            t = self._to_triple(item)
            k = tuple(t)
            seen.add(k)
            e = int(ets) + int(width)
            old = bucket.get(k)
            if old is None:
                self.db.add_triple(t)
            if old is None or e > old:
                bucket[k] = e
                if e > self._delta.get(k, 0):
                    self._delta[k] = e
        evicted = [k for k in bucket if k not in seen]
        for k in evicted:
            e = bucket.pop(k)
            if e > self._now:
                self._now = e
            # a triple shared with another window's bucket stays in the db
            if not any(k in b for b in self._buckets.values()):
                self.db.delete_triple(Triple(*k))

    def materialize_incremental(self) -> List[Triple]:
        """Delta-seeded closure + db sync of the derived actives."""
        if self._legacy:
            return self.materialize()
        from kolibrie_tpu_torch.reasoner.cross_window import (
            _OverlayTags,
            _dedup_max_expiry,
            _lookup_expiry,
        )
        from kolibrie_tpu_torch.reasoner.provenance import ExpirationProvenance
        from kolibrie_tpu_torch.reasoner.provenance_seminaive import (
            semi_naive_with_initial_tags_and_delta,
        )
        from kolibrie_tpu_torch.reasoner.tag_store import TagStore

        if not self.rules:
            self._delta.clear()
            return []
        now = np.uint64(self._now)
        if self._state is None:
            # (re)build: every alive base fact is the delta
            self._delta = {}
            for bucket in self._buckets.values():
                for k, e in bucket.items():
                    if e > self._delta.get(k, 0):
                        self._delta[k] = e
            self._tags = {}
            os_ = op_ = oo_ = np.empty(0, np.uint32)
            oexp = np.empty(0, np.uint64)
        else:
            os_, op_, oo_, oexp = self._state
            alive = oexp > now
            os_, op_, oo_, oexp = os_[alive], op_[alive], oo_[alive], oexp[alive]

        if self._delta:
            items = list(self._delta.items())
            cs = np.fromiter((k[0] for k, _ in items), np.uint32, len(items))
            cp = np.fromiter((k[1] for k, _ in items), np.uint32, len(items))
            co = np.fromiter((k[2] for k, _ in items), np.uint32, len(items))
            cexp = np.fromiter((e for _, e in items), np.uint64, len(items))
            found, old_e = _lookup_expiry(os_, op_, oo_, oexp, cs, cp, co)
            is_new = ~found | (cexp > old_e)
            ds, dp, do_ = cs[is_new], cp[is_new], co[is_new]
            dexp = cexp[is_new]
        else:
            ds = dp = do_ = np.empty(0, np.uint32)
            dexp = np.empty(0, np.uint64)
        self._delta = {}

        prov = ExpirationProvenance()
        overlay = _OverlayTags([self._tags])
        derived: List[Triple] = []
        if len(ds) or len(os_):
            kg = Reasoner(self.db.dictionary, device=self.db.device)
            kg.quoted = self.db.quoted
            kg.facts.add_batch(
                np.concatenate([os_, ds]),
                np.concatenate([op_, dp]),
                np.concatenate([oo_, do_]),
            )
            for rule in self.rules:
                kg.add_rule(rule)
            delta_keys = set()
            for ks, kp, ko, e in zip(
                ds.tolist(), dp.tolist(), do_.tolist(), dexp.tolist()
            ):
                key = (ks, kp, ko)
                old = overlay.get(key)
                overlay[key] = e if old is None else max(old, int(e))
                delta_keys.add(key)
            tag_store = TagStore(prov)
            tag_store.tags = overlay
            if delta_keys:
                semi_naive_with_initial_tags_and_delta(
                    kg, prov, tag_store, delta_keys
                )

        # merge + prune the carried state (O(state) dict/ndarray carry)
        new_tags: Dict[tuple, int] = {
            k: e for k, e in self._tags.items() if e > self._now
        }
        t_s = np.empty(len(overlay), np.uint32)
        t_p = np.empty(len(overlay), np.uint32)
        t_o = np.empty(len(overlay), np.uint32)
        t_e = np.empty(len(overlay), np.uint64)
        for i, (k, e) in enumerate(overlay.items()):
            new_tags[k] = max(e, new_tags.get(k, 0))
            t_s[i], t_p[i], t_o[i] = k
            t_e[i] = e
        self._tags = new_tags
        self._state = _dedup_max_expiry(
            np.concatenate([os_, t_s]),
            np.concatenate([op_, t_p]),
            np.concatenate([oo_, t_o]),
            np.concatenate([oexp, t_e]),
        )

        # db sync: derived actives = alive closure minus the base contents
        base_keys = set()
        for bucket in self._buckets.values():
            base_keys |= bucket.keys()
        derived_now = {
            k
            for k, e in self._tags.items()
            if e > self._now and k not in base_keys
        }
        for k in self._derived_in_db - derived_now:
            self.db.delete_triple(Triple(*k))
        for k in derived_now - self._derived_in_db:
            self.db.add_triple(Triple(*k))
        self._derived_in_db = derived_now
        return [Triple(*k) for k in sorted(derived_now)]
