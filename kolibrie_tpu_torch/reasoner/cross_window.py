"""Cross-window streaming reasoning: the RSP-QL Streaming Dataset (SDS) model
and its naive / incremental materialisation (SDS+).

Parity: ``datalog/src/cross_window_sds.rs`` — predicate annotation =
windowIRI+localName (:17-19), ``Sds{windows: WindowData{alpha, triples},
static_graphs, output_iris}`` (:45-59), ``translate_sds_to_datalog`` (alive
facts with expiry = event_time + α, static = u64::MAX, :82-122),
``translate_datalog_back`` / ``sds_with_expiry_to_external`` (:126-182) —
plus ``cross_window_naive.rs`` (full recomputation) and
``cross_window_incremental.rs`` (D_old = unexpired prior facts max-merged,
D_new = facts whose expiry improved, ExpirationProvenance TagStore, provenance
semi-naive with initial delta = D_new only).

Port of ``kolibrie_tpu/reasoner/cross_window.py`` (a copy, the imports
rewritten; the reasoners take a ``device``, the CUDA card unless the caller
passes another).  The SDS translation and the carried state stay numpy
columns (u32 IDs, u64 expiries: torch has no u64 arithmetic).  The naive
closure is the host semi-naive strategy, as in the reference; the
incremental closure goes through ``semi_naive_with_initial_tags_and_delta``,
which on the CUDA card takes the device tagged fixpoint under the
Expiration semiring from ``device_provenance.AUTO_MIN_FACTS`` facts (expiries
as an f64 column, u64-max as +inf; event times stay below 2^53, so they
round-trip exactly).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from kolibrie_tpu_torch.backend import DeviceLike
from kolibrie_tpu_torch.core.dictionary import Dictionary
from kolibrie_tpu_torch.core.rule import Rule
from kolibrie_tpu_torch.core.triple import Triple
from kolibrie_tpu_torch.reasoner.provenance import ExpirationProvenance
from kolibrie_tpu_torch.reasoner.provenance_seminaive import (
    semi_naive_with_initial_tags_and_delta,
)
from kolibrie_tpu_torch.reasoner.reasoner import Reasoner
from kolibrie_tpu_torch.reasoner.tag_store import TagStore

U64_MAX = ExpirationProvenance.FOREVER

CROSS_WINDOW_STATIC_IRI = "urn:kolibrie:static:"


def annotate_predicate(window_iri: str, local_name: str) -> str:
    return window_iri + local_name


def strip_window_prefix(
    annotated: str, known_iris: List[str]
) -> Optional[Tuple[str, str]]:
    """Longest-prefix strip (caller passes IRIs sorted longest-first)."""
    for iri in known_iris:
        if annotated.startswith(iri):
            return iri, annotated[len(iri):]
    return None


@dataclass
class WindowedTriple:
    subject: str
    predicate: str  # LOCAL name under the owning window IRI
    object: str
    event_time: int
    # per-object encode memo: (dictionary, s_id, p_id, o_id) — re-translating
    # a long-lived window costs attribute reads, not dictionary lookups
    _enc: Optional[tuple] = field(
        default=None, repr=False, compare=False
    )


@dataclass
class WindowData:
    alpha: int  # window width
    triples: List[WindowedTriple] = field(default_factory=list)


@dataclass
class Sds:
    """An RSP-QL Streaming Dataset at a point in time."""

    windows: Dict[str, WindowData] = field(default_factory=dict)
    static_graphs: Dict[str, List[Tuple[str, str, str]]] = field(default_factory=dict)
    output_iris: Set[str] = field(default_factory=set)


def all_component_iris(sds: Sds) -> List[str]:
    iris = (
        list(sds.windows.keys())
        + list(sds.static_graphs.keys())
        + list(sds.output_iris)
    )
    iris.sort(key=len, reverse=True)
    return iris


def _window_columns(window_iri: str, wd: WindowData, dictionary: Dictionary):
    """Encoded (s, p, o, event_time) columns for one window.

    The per-triple ``_enc`` memo (keyed by dictionary AND window, since the
    annotated predicate depends on the owning window) means only new
    arrivals pay dictionary lookups; event times are read fresh each call
    so in-place time updates are always honored."""
    triples = wd.triples
    n = len(triples)
    enc = dictionary.encode
    pred_ids: Dict[str, int] = {}
    s = np.empty(n, dtype=np.uint32)
    p = np.empty(n, dtype=np.uint32)
    o = np.empty(n, dtype=np.uint32)
    et = np.empty(n, dtype=np.int64)
    for i, wt in enumerate(triples):
        e = wt._enc
        if e is None or e[0] is not dictionary or e[1] != window_iri:
            pid = pred_ids.get(wt.predicate)
            if pid is None:
                pid = enc(annotate_predicate(window_iri, wt.predicate))
                pred_ids[wt.predicate] = pid
            e = (dictionary, window_iri, enc(wt.subject), pid, enc(wt.object))
            wt._enc = e
        s[i], p[i], o[i] = e[2], e[3], e[4]
        et[i] = wt.event_time
    return s, p, o, et


def translate_sds_to_arrays(
    sds: Sds, dictionary: Dictionary, current_time: int
):
    """Vectorized SDS translation: alive facts as (s, p, o, expiry) u32/u64
    columns (the columnar twin of :func:`translate_sds_to_datalog`)."""
    parts = []
    for window_iri, wd in sds.windows.items():
        s, p, o, et = _window_columns(window_iri, wd, dictionary)
        alpha = int(wd.alpha)
        if alpha >= 1 << 62:
            # "forever" window (u64::MAX-style alpha): saturate instead of
            # overflowing int64 arithmetic
            expiry = np.full(len(et), U64_MAX, dtype=np.uint64)
            alive = np.ones(len(et), dtype=bool)
        else:
            exp64 = et + np.int64(alpha)  # event times are < 2^62
            alive = exp64 > current_time
            expiry = exp64.astype(np.uint64)
        parts.append((s[alive], p[alive], o[alive], expiry[alive]))
    enc = dictionary.encode
    for graph_iri, triples in sds.static_graphs.items():
        if not triples:
            continue
        n = len(triples)
        gs = np.fromiter((enc(t[0]) for t in triples), np.uint32, count=n)
        gp = np.fromiter(
            (enc(annotate_predicate(graph_iri, t[1])) for t in triples),
            np.uint32,
            count=n,
        )
        go = np.fromiter((enc(t[2]) for t in triples), np.uint32, count=n)
        parts.append((gs, gp, go, np.full(n, U64_MAX, dtype=np.uint64)))
    if not parts:
        z = np.empty(0, dtype=np.uint32)
        return z, z, z, np.empty(0, dtype=np.uint64)
    return (
        np.concatenate([x[0] for x in parts]),
        np.concatenate([x[1] for x in parts]),
        np.concatenate([x[2] for x in parts]),
        np.concatenate([x[3] for x in parts]),
    )


def translate_sds_to_datalog(
    sds: Sds, dictionary: Dictionary, current_time: int
) -> List[Tuple[Triple, int]]:
    """Alive facts annotated with expiry; static facts get expiry = ∞."""
    out: List[Tuple[Triple, int]] = []
    enc = dictionary.encode
    pred_ids: Dict[Tuple[str, str], int] = {}  # (window, local) → encoded
    for window_iri, wd in sds.windows.items():
        for wt in wd.triples:
            expiry = wt.event_time + wd.alpha
            if expiry <= current_time:
                continue
            pkey = (window_iri, wt.predicate)
            pid = pred_ids.get(pkey)
            if pid is None:
                pid = enc(annotate_predicate(window_iri, wt.predicate))
                pred_ids[pkey] = pid
            out.append((Triple(enc(wt.subject), pid, enc(wt.object)), expiry))
    for graph_iri, triples in sds.static_graphs.items():
        for s, p, o in triples:
            out.append(
                (
                    Triple(enc(s), enc(annotate_predicate(graph_iri, p)), enc(o)),
                    U64_MAX,
                )
            )
    return out


def translate_datalog_back(
    facts: List[Triple], dictionary: Dictionary, sds: Sds
) -> Dict[str, List[Triple]]:
    """Strip window-IRI prefixes; route triples to component buckets.

    Distinct predicates are few; decode/strip/re-encode each once."""
    router = _PredicateRouter(dictionary, all_component_iris(sds))
    out: Dict[str, List[Triple]] = {}
    for t in facts:
        route = router.route(t.predicate)
        if route is None:
            continue
        comp, local_id = route
        out.setdefault(comp, []).append(Triple(t.subject, local_id, t.object))
    return out


_MISS = object()  # sentinel distinguishing "unseen predicate" from None


class _PredicateRouter:
    """Cached annotated-predicate-ID → (component IRI, local-name ID) map.

    The decode → longest-prefix strip → re-encode round trip runs once per
    DISTINCT predicate, not once per fact."""

    def __init__(self, dictionary: Dictionary, component_iris: List[str]):
        self._dictionary = dictionary
        self._component_iris = component_iris
        self._cache: Dict[int, Optional[Tuple[str, int]]] = {}

    def route(self, pred_id: int) -> Optional[Tuple[str, int]]:
        hit = self._cache.get(pred_id, _MISS)
        if hit is _MISS:
            pred = self._dictionary.decode(pred_id)
            stripped = (
                strip_window_prefix(pred, self._component_iris)
                if pred
                else None
            )
            hit = (
                (stripped[0], self._dictionary.encode(stripped[1]))
                if stripped is not None
                else None
            )
            self._cache[pred_id] = hit
        return hit


# Internal incremental state: component IRI -> {annotated triple -> expiry}
SdsWithExpiry = Dict[str, Dict[Tuple[int, int, int], int]]


def sds_with_expiry_to_external(
    internal: SdsWithExpiry, dictionary: Dictionary, component_iris: List[str]
) -> Dict[str, List[Triple]]:
    router = _PredicateRouter(dictionary, component_iris)
    out: Dict[str, List[Triple]] = {}
    for comp, fact_map in internal.items():
        for key in fact_map:
            hit = router.route(key[1])
            if hit is None:
                continue
            _, local_id = hit
            out.setdefault(comp, []).append(Triple(key[0], local_id, key[2]))
    return out


def naive_sds_plus(
    rules: List[Rule],
    sds: Sds,
    dictionary: Dictionary,
    current_time: int,
    device: DeviceLike = None,
) -> Dict[str, List[Triple]]:
    """Full SDS+ recomputation (cross_window_naive.rs:20-43)."""
    s, p, o, _exp = translate_sds_to_arrays(sds, dictionary, current_time)
    reasoner = Reasoner(dictionary, device=device)
    if len(s):
        reasoner.facts.add_batch(s, p, o)
    for rule in rules:
        reasoner.add_rule(rule)
    reasoner.infer_new_facts_semi_naive()
    all_facts = [Triple(*k) for k in reasoner.facts.triples_set()]
    return translate_datalog_back(all_facts, dictionary, sds)


class SdsPlusState(dict):
    """An ``SdsWithExpiry`` result that carries its own columnar mirror
    ``(s, p, o, expiry)`` so the NEXT incremental call's D_old handling is
    vectorized instead of re-walking the dicts."""

    arrays = None  # (s u32, p u32, o u32, expiry u64)


class _OverlayTags(dict):
    """Tag map whose misses fall back to the prior state's component maps
    (max-merged D_old semantics).  The fixpoint reads via ``.get`` and
    writes normal items, so this dict's OWN entries are exactly the facts
    whose tags were seeded or changed this cycle — the incremental result
    update set."""

    def __init__(self, prior_maps):
        super().__init__()
        self._prior = prior_maps

    def get(self, key, default=None):
        if dict.__contains__(self, key):
            return dict.__getitem__(self, key)
        best = None
        for m in self._prior:
            e = m.get(key)
            if e is not None and (best is None or e > best):
                best = e
        return default if best is None else best


def _state_arrays(sds_plus_old: SdsWithExpiry):
    """(s, p, o, expiry) columns of a prior state (cached on SdsPlusState)."""
    arrays = getattr(sds_plus_old, "arrays", None)
    if arrays is not None:
        return arrays
    n = sum(len(m) for m in sds_plus_old.values())
    s = np.empty(n, dtype=np.uint32)
    p = np.empty(n, dtype=np.uint32)
    o = np.empty(n, dtype=np.uint32)
    exp = np.empty(n, dtype=np.uint64)
    i = 0
    for fact_map in sds_plus_old.values():
        for (ks, kp, ko), e in fact_map.items():
            s[i], p[i], o[i], exp[i] = ks, kp, ko, e
            i += 1
    return _dedup_max_expiry(s, p, o, exp)


def _pack3(s, p, o):
    """Exact two-u64 lex key for (s, p, o) u32 rows."""
    return (s.astype(np.uint64) << np.uint64(32)) | p.astype(np.uint64), o


def _dedup_max_expiry(s, p, o, exp):
    """Sort rows by (s, p, o) keeping the MAX expiry per distinct triple."""
    if len(s) == 0:
        return s, p, o, exp
    order = np.lexsort((exp, o, p, s))
    s, p, o, exp = s[order], p[order], o[order], exp[order]
    # groups are contiguous; last of each group has the max expiry
    last = np.ones(len(s), dtype=bool)
    last[:-1] = (s[1:] != s[:-1]) | (p[1:] != p[:-1]) | (o[1:] != o[:-1])
    return s[last], p[last], o[last], exp[last]


def _lookup_expiry(os_, op_, oo_, oexp, cs, cp, co):
    """Vectorized per-row lookup of current rows in the (sorted, deduped)
    old columns; returns (found mask, old expiry where found else 0)."""
    if len(os_) == 0 or len(cs) == 0:
        z = np.zeros(len(cs), dtype=np.uint64)
        return np.zeros(len(cs), dtype=bool), z
    k1o, k2o = _pack3(os_, op_, oo_)
    k1c, k2c = _pack3(cs, cp, co)
    lo = np.searchsorted(k1o, k1c, side="left")
    hi = np.searchsorted(k1o, k1c, side="right")
    # refine on o within each (s, p) run: runs are sorted by o
    found = np.zeros(len(cs), dtype=bool)
    old_e = np.zeros(len(cs), dtype=np.uint64)
    narrow = hi - lo
    # common case: unique (s, p) per row -> fully vectorized equality
    one = narrow == 1
    if one.any():
        pos = lo[one]
        eq = k2o[pos] == k2c[one]
        found_idx = np.flatnonzero(one)
        found[found_idx[eq]] = True
        old_e[found_idx[eq]] = oexp[pos[eq]]
    multi = np.flatnonzero(narrow > 1)
    for i in multi:
        sub = k2o[lo[i] : hi[i]]
        j = int(np.searchsorted(sub, k2c[i]))
        if j < len(sub) and sub[j] == k2c[i]:
            found[i] = True
            old_e[i] = oexp[lo[i] + j]
    return found, old_e


def incremental_sds_plus(
    rules: List[Rule],
    sds_current: Sds,
    sds_plus_old: SdsWithExpiry,
    dictionary: Dictionary,
    current_time: int,
    device: DeviceLike = None,
) -> SdsWithExpiry:
    """Incremental SDS+ maintenance (cross_window_incremental.rs:26-110).

    D_old = unexpired prior facts (max-merged over components);
    D_new = current facts whose expiry improved on the prior state;
    run expiration-provenance semi-naive with initial delta = D_new ONLY.

    All O(state) bookkeeping is vectorized (columnar D_old carried on
    :class:`SdsPlusState`, membership via packed-key binary search, tag
    fallback instead of tag pre-seeding), so the per-cycle cost tracks the
    UPDATE volume plus one C-speed state carry — the asymmetry that makes
    incremental beat naive at low update ratios.
    """
    t = np.uint64(current_time)
    cs, cp, co, cexp = translate_sds_to_arrays(
        sds_current, dictionary, current_time
    )
    os_, op_, oo_, oexp = _state_arrays(sds_plus_old)
    alive = oexp > t
    os_, op_, oo_, oexp = os_[alive], op_[alive], oo_[alive], oexp[alive]

    # D_new: current facts absent from D_old or with improved expiry
    found, old_e = _lookup_expiry(os_, op_, oo_, oexp, cs, cp, co)
    is_new = ~found | (cexp > old_e)
    ds, dp, do_, dexp = cs[is_new], cp[is_new], co[is_new], cexp[is_new]

    reasoner = Reasoner(dictionary, device=device)
    if len(os_) or len(ds):
        reasoner.facts.add_batch(
            np.concatenate([os_, ds]),
            np.concatenate([op_, dp]),
            np.concatenate([oo_, do_]),
        )
    for rule in rules:
        reasoner.add_rule(rule)

    prov = ExpirationProvenance()
    prior_maps = list(sds_plus_old.values())
    overlay = _OverlayTags(prior_maps)
    initial_tags = TagStore(prov)
    initial_tags.tags = overlay
    # seed ONLY the update set (D_old reads go through the fallback)
    for ks, kp, ko, e in zip(
        ds.tolist(), dp.tolist(), do_.tolist(), dexp.tolist()
    ):
        key = (ks, kp, ko)
        old = overlay.get(key)
        overlay[key] = e if old is None else max(old, e)

    delta = set(zip(ds.tolist(), dp.tolist(), do_.tolist()))
    semi_naive_with_initial_tags_and_delta(
        reasoner, prov, initial_tags, delta
    )  # effects land in `overlay` (initial_tags.tags)

    # result = carried prior state (expired pruned) + this cycle's overlay
    router = _PredicateRouter(dictionary, all_component_iris(sds_current))
    result = SdsPlusState()
    for comp, fact_map in sds_plus_old.items():
        carried = {k: e for k, e in fact_map.items() if e > current_time}
        if carried:
            result[comp] = carried
    # ROUTED overlay entries only, so the columnar mirror stays an exact
    # mirror of the dict state (unroutable intermediates are dropped from
    # both, as in the reference)
    routed: List[Tuple[Tuple[int, int, int], int]] = []
    for key, expiry in overlay.items():
        hit = router.route(key[1])
        if hit is not None:
            result.setdefault(hit[0], {})[key] = expiry
            routed.append((key, expiry))
    touched_s = np.empty(len(routed), dtype=np.uint32)
    touched_p = np.empty(len(routed), dtype=np.uint32)
    touched_o = np.empty(len(routed), dtype=np.uint32)
    touched_e = np.empty(len(routed), dtype=np.uint64)
    for i, (key, expiry) in enumerate(routed):
        touched_s[i], touched_p[i], touched_o[i] = key
        touched_e[i] = expiry
    # columnar mirror for the NEXT cycle: old-alive rows superseded by the
    # overlay where both exist (overlay expiries are >= by construction)
    result.arrays = _dedup_max_expiry(
        np.concatenate([os_, touched_s]),
        np.concatenate([op_, touched_p]),
        np.concatenate([oo_, touched_o]),
        np.concatenate([oexp, touched_e]),
    )
    return result
