"""Distributed execution of full SPARQL query plans over the shard mesh.

Port of ``kolibrie_tpu/parallel/dist_query.py``.  A SELECT's basic graph
pattern + filters + projection is a datalog rule body, so the distributed
lowering reuses the mesh fixpoint machinery: shard-local pattern scans
over the :class:`~kolibrie_tpu_torch.parallel.sharded_store.
ShardedTripleStore`'s subject-owned blocks, all-to-all repartitioning of
the binding table between join stages, local sort-merge joins against the
subject-owned facts or the object-hash mirror, replicated filter masks,
and a final projection gathered to the host.  It is a single-round
specialisation of ``dist_general._general_round``: the joined binding
table IS the result (bag semantics: no dedup unless ``DISTINCT``).

Scope, as the reference's: BGP patterns (constants anywhere, joins keyed
at subject/object position), numeric + term-equality + constant-pattern
string FILTERs (AND-composed), projection, mesh-side DISTINCT (projection
tuples hash to an owner shard), ORDER BY + LIMIT (per-shard top-k; a
non-numeric sort value anywhere flips the run to the global string
ranks), BIND (applied host-side to the gathered table), VALUES in its
constraining form, plain sub-SELECTs (inlined), UNION / OPTIONAL / MINUS
/ NOT with BGP(+filter) branches, GROUP BY aggregates (the gathered
columns flow into the single-device segment aggregator).  Everything else
raises :class:`Unsupported`; callers fall back to the single-device
engine.

The reference's ``shard_map`` body becomes controller code over the
shards, split at each collective.  Premise scans run the fused
``filter_mask`` kernel and BGP joins the merge-path kernel on the card
(``_scan_premise``, ``dist_join.local_join_u32``); clause joins use the
plain sort join ``ops/device_join.py::join_indices``, as the reference
uses its XLA join there.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kolibrie_tpu_torch.core.dictionary import QUOTED_BIT
from kolibrie_tpu_torch.ops import round_cap
from kolibrie_tpu_torch.ops.device_join import join_indices as _dj
from kolibrie_tpu_torch.ops.device_join import pack_key_multi
from kolibrie_tpu_torch.parallel.dist_general import _exchange_table, _join_step, _plan_rule_dist
from kolibrie_tpu_torch.parallel.dist_join import exchange, mix32
from kolibrie_tpu_torch.parallel.mesh import Mesh, psum, replicate
from kolibrie_tpu_torch.parallel.sharded_store import ShardedTripleStore
from kolibrie_tpu_torch.query import ast as A
from kolibrie_tpu_torch.reasoner.device_fixpoint import (
    LoweredFilter,
    LoweredPremise,
    Unsupported,
    _scan_premise,
)

__all__ = ["DistQueryExecutor", "execute_query_distributed", "Unsupported"]

# Unknown-constant sentinel: dictionary IDs occupy bits 0..30 (+ bit 31 for
# quoted triples) but never all-ones, so a scan against it matches nothing.
_NO_MATCH = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Lowering: SelectQuery -> premises + filters + projection
# ---------------------------------------------------------------------------


def _lower_query_pattern(resolved) -> LoweredPremise:
    """Resolved :class:`PatternTriple` (kinds 'var'/'id') → LoweredPremise."""
    consts: List[Optional[int]] = []
    out_vars: List[tuple] = []
    eq_pairs: List[tuple] = []
    seen: Dict[str, int] = {}
    for pos, t in enumerate((resolved.subject, resolved.predicate, resolved.object)):
        if t.kind == "id":
            consts.append(_NO_MATCH if t.value is None else int(t.value))
        elif t.kind == "var":
            consts.append(None)
            name = t.value
            if name in seen:
                eq_pairs.append((seen[name], pos))
            else:
                seen[name] = pos
                out_vars.append((name, pos))
        else:
            raise Unsupported(f"pattern term kind {t.kind!r}")
    return LoweredPremise(tuple(consts), tuple(out_vars), tuple(eq_pairs))


def _mirror(op: str) -> str:
    return {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)


def _lower_query_filters(
    filters, db, bound: set, mask_offset: int = 0
) -> Tuple[Tuple[LoweredFilter, ...], Tuple[tuple, ...]]:
    """Query FILTER expressions → LoweredFilters + per-ID mask exprs.

    Numeric comparisons (``=``/``!=`` included — value semantics, the host
    engine's NumCmp) become per-ID mask gathers; term equality against
    IRIs/strings an ID compare; constant-pattern string predicates a pair
    of per-ID verdict masks (dictionary and quoted).  AND composes;
    anything else is Unsupported.  ``mask_offset``: index the returned
    exprs start at in the caller's combined mask bank."""
    lowered: List[LoweredFilter] = []
    exprs: List[tuple] = []
    keys: Dict[tuple, int] = {}

    def mask_key(k: tuple) -> int:
        if k not in keys:
            keys[k] = mask_offset + len(exprs)
            exprs.append(k)
        return keys[k]

    def walk(f) -> None:
        if isinstance(f, A.LogicalAnd):
            walk(f.left)
            walk(f.right)
            return
        if isinstance(f, A.FunctionCall):
            name = f.name.upper()
            args = f.args
            if (
                name in ("REGEX", "CONTAINS", "STRSTARTS", "STRENDS")
                and len(args) == 2
                and isinstance(args[0], A.Var)
                and args[0].name in bound
                and isinstance(args[1], A.StringLit)
            ):
                lex = args[1].value
                pattern = lex[1:].split('"')[0] if lex.startswith('"') else lex
                didx = mask_key(("str", name, pattern, "dict"))
                qidx = mask_key(("str", name, pattern, "quoted"))
                lowered.append(
                    LoweredFilter("strmask", args[0].name, mask_idx=didx, const_id=qidx)
                )
                return
            raise Unsupported(f"filter function {f.name}")
        if not isinstance(f, A.Comparison):
            raise Unsupported(f"filter {type(f).__name__}")
        left, op, right = f.left, f.op, f.right
        if isinstance(right, A.Var) and not isinstance(left, A.Var):
            left, right, op = right, left, _mirror(op)
        if not isinstance(left, A.Var) or left.name not in bound:
            raise Unsupported("filter variable unbound in patterns")
        var = left.name
        if isinstance(right, A.NumberLit):
            lowered.append(LoweredFilter("mask", var, mask_idx=mask_key((op, float(right.value)))))
            return
        if isinstance(right, (A.IriRef, A.StringLit)) and op in ("=", "!="):
            term = db.expand_term(right.iri) if isinstance(right, A.IriRef) else right.value
            tid = db.dictionary.lookup(term)
            if tid is None:
                tid = _NO_MATCH  # '=' never matches; '!=' always passes
            lowered.append(LoweredFilter("eq" if op == "=" else "ne", var, const_id=int(tid)))
            return
        raise Unsupported(f"filter comparison against {type(right).__name__}")

    for f in filters:
        walk(f)
    return tuple(lowered), tuple(exprs)


def _materialize_masks(db, exprs: Tuple[tuple, ...]) -> List[np.ndarray]:
    """Per-ID boolean masks — the single-device engine's builders
    (numeric-literal comparisons and constant-pattern string predicates)."""
    if not exprs:
        return []
    from kolibrie_tpu_torch.optimizer.device_engine import (
        numeric_filter_mask,
        string_filter_mask,
    )

    vals = db.numeric_values()
    out = []
    for key in exprs:
        if key[0] == "str":
            out.append(string_filter_mask(db, key[1], key[2], key[3]))
        else:
            out.append(numeric_filter_mask(vals, key[0], key[1]))
    return out


def _strmask_verdict(col, masks, f):
    """Two-level string-predicate gather: dictionary IDs from
    ``masks[f.mask_idx]``, quoted IDs (bit 31) from ``masks[f.const_id]``."""
    dm = masks[f.mask_idx]
    qm = masks[f.const_id]
    isq = (col & QUOTED_BIT) != 0
    dv = dm[col.clamp(max=dm.shape[0] - 1)]
    qv = qm[(col & (~QUOTED_BIT & 0xFFFFFFFF)).clamp(max=qm.shape[0] - 1)]
    return torch.where(isq, qv, dv)


def _query_filters(filters, table, valid, masks):
    for f in filters:
        col = table[f.var]
        if f.kind == "eq":
            valid = valid & (col == f.const_id)
        elif f.kind == "ne":
            valid = valid & (col != f.const_id)
        elif f.kind == "strmask":
            valid = valid & _strmask_verdict(col, masks, f)
        else:
            m = masks[f.mask_idx]
            valid = valid & m[col.clamp(max=m.shape[0] - 1)]
    return valid


def _lexsorted(cols: List[torch.Tensor]) -> List[torch.Tensor]:
    """Rows sorted lexicographically by every column (``lax.sort`` with
    ``num_keys=len(cols)``): stable sorts, least significant key first."""
    perm = torch.arange(cols[0].shape[0], device=cols[0].device)
    for c in reversed(cols):
        perm = perm[torch.sort(c[perm], stable=True).indices]
    return [c[perm] for c in cols]


def _limit_offset(rows, q):
    start = q.offset or 0
    end = start + q.limit if q.limit is not None else None
    return rows[start:end]


# ---------------------------------------------------------------------------
# The mesh body (single round: scan -> routed joins -> filter -> project)
# ---------------------------------------------------------------------------


def _query_body(
    state,
    masks,
    numf,
    vals,
    dranks,
    qranks,
    *,
    premises,
    seed,
    steps,
    filters,
    out_vars,
    n,
    join_cap,
    bucket_cap,
    distinct=False,
    topk=None,
    values_var=None,
    anti=(),
    unions=(),
    optionals=(),
):
    """One query over every shard.  ``state`` is ``(fcols, fv, gcols,
    gv)`` per shard; ``masks``, ``numf``, ``vals``, ``dranks``, ``qranks``
    hold one replicated copy per shard.  Returns per shard the projected
    columns and validity, then the global row count, overflow and
    non-numeric-sort-key flag."""
    fcols, fv, gcols, gv = state
    ovfs: List[torch.Tensor] = []

    def eval_bgp(premises, seed, steps, filters):
        """Seed scan → routed join steps → filters: the shard-local BGP
        pipeline, shared by the main pattern and every clause branch."""
        tables, valids = [], []
        for i in range(n):
            t, v = _scan_premise(premises[seed], fcols[i], fv[i])
            tables.append(t)
            valids.append(v)
        for j, kv, kpos, extra in steps:
            if n > 1:
                # on one shard every key hashes to shard 0: the exchange is
                # an identity that would still pay a bucketize sort
                tables, valids, dropped = _exchange_table(tables, valids, kv, n, bucket_cap)
                ovfs.append(dropped)
            tables, valids, step_ovf = _join_step(
                tables, valids, fcols, fv, gcols, gv, premises[j], kv, kpos, extra, join_cap
            )
            ovfs.extend(step_ovf)
        valids = [_query_filters(filters, tables[i], valids[i], masks[i]) for i in range(n)]
        return tables, valids

    tables, valids = eval_bgp(premises, seed, steps, filters)

    if values_var is not None:
        # replicated VALUES membership: sorted array + searchsorted per row
        for i in range(n):
            col = tables[i][values_var]
            vpos = torch.searchsorted(vals[i], col).clamp(0, vals[i].shape[0] - 1)
            valids[i] = valids[i] & (vals[i][vpos] == col)

    def _dest(cols_k):
        h = cols_k[0]
        for c in cols_k[1:]:
            h = mix32(h) ^ c
        return mix32(h) % n

    def _route_sides(tables, valids, btables, bvalids, bkeys, bextra):
        """Co-locate main rows and branch rows by shared-key hash.
        ``bextra``: branch columns beyond the keys to carry through."""
        if n <= 1:
            return tables, valids, btables, bvalids
        names = sorted(tables[0])
        routed, valids, dropped = exchange(
            [tuple(t[v] for v in names) for t in tables],
            valids,
            [_dest([t[v] for v in bkeys]) for t in tables],
            n,
            bucket_cap,
        )
        ovfs.append(dropped)
        bnames = list(bkeys) + [v for v in bextra if v not in bkeys]
        brouted, bvalids, bdropped = exchange(
            [tuple(t[v] for v in bnames) for t in btables],
            bvalids,
            [_dest([t[v] for v in bkeys]) for t in btables],
            n,
            bucket_cap,
        )
        ovfs.append(bdropped)
        return (
            [dict(zip(names, r)) for r in routed],
            valids,
            [dict(zip(bnames, r)) for r in brouted],
            bvalids,
        )

    def _pack_pair(table, valid, btable, bvalid, bkeys):
        """Shared-key tuples → comparable u64 key carriers.  Equal tuples
        are co-located after routing, so a LOCAL rank pack over the
        concatenated columns is exact for any key arity."""
        return pack_key_multi(
            [table[v] for v in bkeys], [btable[v] for v in bkeys], valid, bvalid
        )

    for branches, gvars, gkeys in unions:
        parts = [eval_bgp(*b) for b in branches]
        ucols, uvalid = [], []
        for i in range(n):
            dev = valids[i].device
            ucols.append(
                {
                    v: torch.cat(
                        [
                            bt[i][v]
                            if v in bt[i]
                            else torch.zeros(bv[i].shape[0], dtype=torch.int64, device=dev)
                            for bt, bv in parts
                        ]
                    )
                    for v in gvars
                }
            )
            uvalid.append(torch.cat([bv[i] for _bt, bv in parts]))
        tables, valids, ucols, uvalid = _route_sides(tables, valids, ucols, uvalid, gkeys, gvars)
        for i in range(n):
            lk, rk = _pack_pair(tables[i], valids[i], ucols[i], uvalid[i], gkeys)
            li, ri, jvalid, total = _dj(lk, rk, join_cap)
            ovfs.append((total - join_cap).clamp(min=0))
            new_table = {v: torch.where(jvalid, c[li], 0) for v, c in tables[i].items()}
            for v in gvars:
                if v not in new_table:
                    new_table[v] = torch.where(jvalid, ucols[i][v][ri], 0)
            tables[i], valids[i] = new_table, jvalid

    for oprem, oseed, osteps, ofilters, ovars, okeys in optionals:
        bt, bv = eval_bgp(oprem, oseed, osteps, ofilters)
        tables, valids, bt, bv = _route_sides(tables, valids, bt, bv, okeys, ovars)
        for i in range(n):
            lk, rk = _pack_pair(tables[i], valids[i], bt[i], bv[i], okeys)
            li, ri, jvalid, total = _dj(lk, rk, join_cap)
            ovfs.append((total - join_cap).clamp(min=0))
            rs = torch.sort(rk).values
            pos = torch.searchsorted(rs, lk).clamp(0, rs.shape[0] - 1)
            keep = valids[i] & (rs[pos] != lk)  # unmatched main rows
            new_table = {
                v: torch.cat([torch.where(jvalid, c[li], 0), c]) for v, c in tables[i].items()
            }
            for v in ovars:
                if v not in tables[i]:
                    new_table[v] = torch.cat(
                        [torch.where(jvalid, bt[i][v][ri], 0), torch.zeros_like(lk)]
                    )
            tables[i], valids[i] = new_table, torch.cat([jvalid, keep])

    for bprem, bseed, bsteps, bfilters, bkeys in anti:
        btables, bvalids = eval_bgp(bprem, bseed, bsteps, bfilters)
        tables, valids, btables, bvalids = _route_sides(
            tables, valids, btables, bvalids, bkeys, ()
        )
        for i in range(n):
            lk, rk = _pack_pair(tables[i], valids[i], btables[i], bvalids[i], bkeys)
            rs = torch.sort(rk).values
            pos = torch.searchsorted(rs, lk).clamp(0, rs.shape[0] - 1)
            valids[i] = valids[i] & (rs[pos] != lk)

    if distinct and out_vars:
        # mesh-side DISTINCT: equal projection tuples hash to the same
        # owner shard, so a shard-local sort + first-occurrence mask is a
        # globally exact dedup
        ocols = [tuple(t[v] for v in out_vars) for t in tables]
        if n > 1:
            ocols, valids, dropped = exchange(
                ocols, valids, [_dest(list(c)) for c in ocols], n, bucket_cap
            )
            ovfs.append(dropped)
        sent = 0xFFFFFFFF  # never a real dictionary ID
        for i in range(n):
            scols = _lexsorted([torch.where(valids[i], c, sent) for c in ocols[i]])
            first = torch.ones_like(valids[i])
            neq = torch.zeros(scols[0].shape[0] - 1, dtype=torch.bool, device=first.device)
            for c in scols:
                neq = neq | (c[1:] != c[:-1])
            first[1:] = neq
            valids[i] = first & (scols[0] != sent)
            tables[i] = dict(zip(out_vars, scols))

    nan_seen = [torch.zeros((), dtype=torch.bool, device=v.device) for v in valids]
    if topk is not None:
        # mesh-side ORDER BY + LIMIT: per-shard top-k through the device
        # engine's ``_order_limit``; the union of per-shard top-k holds the
        # global top-k.  Whether a key column sorts by string ranks must be
        # GLOBAL (one non-numeric value anywhere switches the column), so
        # each key's flag is psum'd before the sort.
        from kolibrie_tpu_torch.optimizer.device_engine import _order_limit

        k, opos, descs = topk
        cols_t = [tuple(t[v] for v in out_vars) for t in tables]
        overrides = []
        for pos in opos:
            flags = []
            for i in range(n):
                nf = numf[i]
                vk = nf[cols_t[i][pos].clamp(max=nf.shape[0] - 1)]
                flags.append((torch.isnan(vk) & valids[i]).any().to(torch.int64))
            overrides.append(psum(flags) > 0)
        for i in range(n):
            dev = valids[i].device
            top_cols, valids[i], _n_valid, nan_seen[i] = _order_limit(
                cols_t[i],
                valids[i],
                numf[i],
                opos,
                descs,
                k,
                dranks[i],
                qranks[i],
                nan_overrides=tuple(o.to(dev) for o in overrides),
            )
            tables[i] = dict(zip(out_vars, top_cols))

    outs = [tuple(torch.where(valids[i], tables[i][v], 0) for v in out_vars) for i in range(n)]
    total_rows = psum([v.sum() for v in valids])
    overflow = psum(ovfs) if ovfs else torch.zeros((), dtype=torch.int64)
    nan_any = psum([s.to(torch.int64) for s in nan_seen])
    return outs, valids, total_rows, overflow, nan_any


# ---------------------------------------------------------------------------
# Host driver
# ---------------------------------------------------------------------------


def _replicated(mesh: Mesh, arr) -> list:
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.asarray(arr))
    return list(replicate(mesh, t))


def _mask_copies(mesh: Mesh, host_masks) -> list:
    """Per shard, the tuple of its copies of the filter masks."""
    per_mask = [replicate(mesh, torch.from_numpy(np.asarray(m))) for m in host_masks]
    return [tuple(m[i] for m in per_mask) for i in range(mesh.size)]


class DistQueryExecutor:
    """Lower one SELECT for the mesh and execute it over sharded triples.

    ``store`` may be a prebuilt :class:`ShardedTripleStore` (reused across
    queries); otherwise one is partitioned from the database's columns on
    first :meth:`run`."""

    def __init__(
        self,
        mesh: Mesh,
        db,
        sparql: str,
        store: Optional[ShardedTripleStore] = None,
        join_cap: Optional[int] = None,
        bucket_cap: Optional[int] = None,
    ):
        from kolibrie_tpu_torch.optimizer.engine import resolve_pattern
        from kolibrie_tpu_torch.query.parser import parse_combined_query
        from kolibrie_tpu_torch.query.subquery_inline import inline_subqueries

        self.mesh = mesh
        self.db = db
        self.n = mesh.size
        db.register_prefixes_from_query(sparql)
        cq = parse_combined_query(sparql, db.prefixes)
        q = cq.select
        if q is None or cq.rules or cq.insert or cq.delete or cq.ml_predict:
            raise Unsupported("distributed path executes plain SELECT only")
        # plain sub-SELECTs fold into the BGP (the single-device rewrite)
        w = inline_subqueries(q.where)
        if w.subqueries or w.window_blocks:
            raise Unsupported("non-BGP clause in WHERE")
        if not w.patterns:
            raise Unsupported("empty BGP")
        resolved = [resolve_pattern(db, p) for p in w.patterns]
        self.premises = tuple(_lower_query_pattern(p) for p in resolved)
        bound = {v for pr in self.premises for v, _ in pr.vars}

        # UNION groups / OPTIONAL branches: structural lowering NOW so the
        # clause variables join the projection/aggregation variable space;
        # branch filters lower later into the shared mask bank.  Join keys
        # accumulate left to right, the host post-pass order.
        def _branch_bgp(bw, kind):
            bw = inline_subqueries(bw)
            if (
                not bw.patterns
                or bw.binds
                or bw.values is not None
                or bw.subqueries
                or bw.not_blocks
                or bw.window_blocks
                or bw.optionals
                or bw.unions
                or bw.minus
            ):
                raise Unsupported(f"non-BGP {kind} branch stays single-device")
            bres = [resolve_pattern(db, p) for p in bw.patterns]
            bprem = tuple(_lower_query_pattern(p) for p in bres)
            bbound = {v for pr in bprem for v, _ in pr.vars}
            return bprem, bbound, bw

        cur_vars = set(bound)
        union_pre = []
        for groups in w.unions:
            gpre = [_branch_bgp(bw_u, "UNION") for bw_u in groups]
            gvars: set = set()
            for _bp, bb, _bw in gpre:
                gvars |= bb
            keys = tuple(sorted(gvars & cur_vars))
            if not keys:
                raise Unsupported("UNION with no shared variables stays single-device")
            union_pre.append((gpre, tuple(sorted(gvars)), keys))
            cur_vars |= gvars
        opt_pre = []
        for ow in w.optionals:
            oprem, obound, ow_i = _branch_bgp(ow, "OPTIONAL")
            keys = tuple(sorted(obound & cur_vars))
            if not keys:
                raise Unsupported("OPTIONAL with no shared variables stays single-device")
            opt_pre.append((oprem, obound, ow_i, keys))
            cur_vars |= obound
        full_bound = cur_vars
        # VALUES in its constraining form — ONE variable the BGP binds, all
        # cells bound and distinct — lowers to a replicated membership
        # mask; general VALUES stays single-device
        self.values_var: Optional[str] = None
        self.values_ids: Optional[np.ndarray] = None
        if w.values is not None:
            if len(w.values.variables) != 1:
                raise Unsupported("multi-variable VALUES stays single-device")
            vvar = w.values.variables[0]
            if vvar not in bound:
                raise Unsupported("VALUES variable unbound in patterns")
            ids = []
            for row in w.values.rows:
                term = row[0] if row else None
                if term is None:
                    raise Unsupported("UNBOUND VALUES cell stays single-device")
                ids.append(db.dictionary.encode(db.expand_term(term)))
            if len(set(ids)) != len(ids):
                # duplicate cells change bag multiplicity, not membership
                raise Unsupported("duplicate VALUES cells stay single-device")
            self.values_var = vvar
            self.values_ids = np.sort(np.asarray(ids, dtype=np.int64))
        # BINDs: the mesh computes the BGP; binds (and filters that read a
        # bind output) apply host-side to the gathered table
        self.binds = list(w.binds)
        bind_vars = {b.var for b in self.binds}
        if self.binds and (q.group_by or any(i.kind == "agg" for i in q.select)):
            raise Unsupported("BIND with aggregates stays single-device")
        from kolibrie_tpu_torch.query.executor import _filter_vars

        plan_filters = [f for f in w.filters if not (set(_filter_vars(f)) & bind_vars)]
        self.post_bind_filters = [f for f in w.filters if set(_filter_vars(f)) & bind_vars]
        # GROUP BY + aggregates: the plan's out columns flow into the
        # single-device segment aggregator; the host reads one row per group
        self.agg_items = [i for i in q.select if i.kind == "agg"]
        if self.agg_items or q.group_by:
            for item in self.agg_items:
                a = item.agg
                if a.func not in ("COUNT", "SUM", "AVG", "MIN", "MAX", "SAMPLE"):
                    raise Unsupported(f"aggregate {a.func}")
                if a.distinct and a.func != "COUNT":
                    raise Unsupported("DISTINCT on non-COUNT aggregate")
                if a.var is not None and a.var not in full_bound:
                    raise Unsupported(f"aggregate variable unbound: {a.var}")
            if any(i.kind == "expr" for i in q.select):
                raise Unsupported("expressions in aggregate SELECT")
            missing = set(q.group_by) - full_bound
            if missing:
                raise Unsupported(f"group variables unbound: {missing}")
            need = list(q.group_by) + [i.agg.var for i in self.agg_items if i.agg.var is not None]
            self.out_vars = tuple(dict.fromkeys(need)) or tuple(sorted(full_bound))[:1]
        elif not q.select_all() and any(i.kind != "var" for i in q.select):
            raise Unsupported("expressions in SELECT")
        elif q.select_all():
            # internal variables (subquery-inline renames, "__sq*") are never
            # user-visible: a mesh DISTINCT over them would disagree with the
            # host engine, which drops them before dedup
            visible = [v for v in sorted(full_bound) if not v.startswith("__")]
            self.out_vars = tuple(visible) or tuple(sorted(full_bound))[:1]
        elif self.binds:
            # binds may reference any pattern variable: gather them ALL
            sel = tuple(item.var for item in q.select)
            missing = set(sel) - full_bound - bind_vars
            if missing:
                raise Unsupported(f"projected variables unbound: {missing}")
            self.out_vars = tuple(sorted(full_bound))
        else:
            self.out_vars = tuple(item.var for item in q.select)
            missing = set(self.out_vars) - full_bound
            if missing:
                raise Unsupported(f"projected variables unbound: {missing}")
        self.filters, self.mask_exprs = _lower_query_filters(plan_filters, db, bound)
        # clause branches: each lowers to its own premise pipeline; branch
        # filters share the main mask bank via offsets
        mask_exprs = list(self.mask_exprs)

        def _branch_pipeline(bprem, bfilter_src, bbound):
            bfilters, bexprs = _lower_query_filters(
                list(bfilter_src), db, bbound, mask_offset=len(mask_exprs)
            )
            mask_exprs.extend(bexprs)
            bplans = dict(_plan_rule_dist(bprem))
            bseed = max(
                range(len(bprem)),
                key=lambda i: (sum(c is not None for c in bprem[i].consts), -i),
            )
            return bprem, bseed, bplans[bseed], bfilters

        self.union_specs = tuple(
            (
                tuple(_branch_pipeline(bprem, bw_u.filters, bbound) for bprem, bbound, bw_u in gpre),
                gvars,
                keys,
            )
            for gpre, gvars, keys in union_pre
        )
        self.optional_specs = tuple(
            _branch_pipeline(oprem, ow_i.filters, obound) + (tuple(sorted(obound)), keys)
            for oprem, obound, ow_i, keys in opt_pre
        )
        anti = []
        for bw in list(w.minus) + [A.WhereClause(patterns=nb.patterns) for nb in w.not_blocks]:
            bprem, bbound, bw = _branch_bgp(bw, "MINUS/NOT")
            bkeys = tuple(sorted(bbound & full_bound))
            if not bkeys:
                continue  # disjoint domains: MINUS removes nothing
            anti.append(_branch_pipeline(bprem, bw.filters, bbound) + (bkeys,))
        self.anti = tuple(anti)
        self.mask_exprs = tuple(mask_exprs)
        plans = _plan_rule_dist(self.premises)
        # seed at the most selective premise (most constant positions)
        self.seed = max(
            range(len(self.premises)),
            key=lambda i: (sum(c is not None for c in self.premises[i].consts), -i),
        )
        self.steps = dict(plans)[self.seed]
        self.query = q
        self.store = store
        if join_cap is None or bucket_cap is None:
            est = self._calibrated_caps_cached()
            if join_cap is None:
                join_cap = est[0]
            if bucket_cap is None:
                bucket_cap = est[1]
        self.join_cap = join_cap
        self.bucket_cap = bucket_cap

    # Calibration bails to the store-size heuristic past this many
    # intermediate rows: materializing bigger host joins just to size the
    # device buffers would cost the host memory the static capacities
    # exist to avoid.
    _CALIBRATE_ROW_LIMIT = 8_000_000

    def _calibrated_caps_cached(self) -> Tuple[int, int]:
        """Per-database memo of :meth:`_calibrate_caps` keyed on (query
        shape, mesh size), valid for ONE store version; a store mutation
        drops the whole memo."""
        version = self.db.store.version
        cache = self.db.__dict__.get("_dist_cap_cache")
        if cache is None or cache["version"] != version:
            cache = {"version": version, "caps": {}}
            self.db.__dict__["_dist_cap_cache"] = cache
        key = (
            self.premises,
            self.seed,
            self.steps,
            self.anti,
            self.union_specs,
            self.optional_specs,
            self.n,
        )
        caps = cache["caps"].get(key)
        if caps is None:
            caps = self._calibrate_caps()
            cache["caps"][key] = caps
        return caps

    def _calibrate_caps(self) -> Tuple[int, int]:
        """Size the per-shard join/bucket capacities from a HOST pass over
        the actual premise chain (``store.match`` scans, each step's join
        size counted before any index materialization) instead of a blind
        multiple of the store size.  Skew headroom 4x; the overflow/retry
        protocol still backstops underestimates; a blow-up past
        ``_CALIBRATE_ROW_LIMIT`` falls back to the heuristic."""
        heuristic = round_cap(4 * max(1, -(-len(self.db.store) // self.n)), 256)

        def table_of(prem):
            scan = self.db.store.match(s=prem.consts[0], p=prem.consts[1], o=prem.consts[2])
            m = np.ones(len(scan[0]), dtype=bool)
            for a, b in prem.eq_pairs:
                m &= scan[a] == scan[b]
            return {v: scan[pos][m] for v, pos in prem.vars}

        class _Blowup(Exception):
            pass

        def walk_chain(premises, seed, steps):
            """(max intermediate rows, final table) of one premise chain."""
            table = table_of(premises[seed])
            n_rows = len(next(iter(table.values()))) if table else 0
            max_rows = n_rows
            for j, kv, kpos, extra in steps:
                ptab = table_of(premises[j])
                lk, rk = table[kv], ptab[kv]
                order = np.argsort(rk, kind="stable")
                rs = rk[order]
                lo = np.searchsorted(rs, lk, side="left")
                counts = np.searchsorted(rs, lk, side="right") - lo
                total = int(counts.sum())
                if total > self._CALIBRATE_ROW_LIMIT:
                    raise _Blowup
                li = np.repeat(np.arange(len(lk)), counts)
                offs = (
                    np.concatenate(([0], np.cumsum(counts[:-1])))
                    if len(counts)
                    else np.zeros(0, dtype=np.int64)
                )
                pos = np.arange(total) - np.repeat(offs, counts) + np.repeat(lo, counts)
                ri = order[pos]
                new_table = {v: c[li] for v, c in table.items()}
                keep = np.ones(total, dtype=bool)
                for v, c in ptab.items():
                    if v not in new_table:
                        new_table[v] = c[ri]
                    elif v in extra:
                        keep &= new_table[v] == c[ri]
                # pre-mask size is what the static join output must hold
                max_rows = max(max_rows, total)
                table = {v: c[keep] for v, c in new_table.items()}
            return max_rows, table

        def count_and_join(table, btable, keys):
            """Clause join on the mesh program's shared-key route: (join
            total, joined table)."""
            from kolibrie_tpu_torch.ops.join import _pack_shared_keys, join_indices

            ln = len(next(iter(table.values()))) if table else 0
            rn = len(next(iter(btable.values()))) if btable else 0
            if ln == 0 or rn == 0:
                return 0, {v: np.empty(0, dtype=np.uint32) for v in set(table) | set(btable)}
            lk, rk = _pack_shared_keys(table, btable, list(keys), ln)
            li, ri = join_indices(lk, rk)
            total = len(li)
            if total > self._CALIBRATE_ROW_LIMIT:
                raise _Blowup
            out = {v: c[li] for v, c in table.items()}
            for v, c in btable.items():
                if v not in out:
                    out[v] = c[ri]
            return total, out

        def rows_of(t):
            return len(next(iter(t.values()))) if t else 0

        try:
            max_rows, table = walk_chain(self.premises, self.seed, self.steps)
            # clause pipelines run through the SAME static buffers: their
            # chains, clause-join totals and grown post-OPTIONAL tables all
            # have to fit
            for branches, gvars, gkeys in self.union_specs:
                parts = []
                for bprem, bseed, bsteps, _bf in branches:
                    bmax, btab = walk_chain(bprem, bseed, bsteps)
                    max_rows = max(max_rows, bmax)
                    parts.append(btab)
                un = sum(rows_of(t) for t in parts)
                ucols = {}
                for v in gvars:
                    ucols[v] = (
                        np.concatenate(
                            [
                                t[v] if v in t else np.zeros(rows_of(t), dtype=np.uint32)
                                for t in parts
                            ]
                        )
                        if parts
                        else np.empty(0, dtype=np.uint32)
                    )
                max_rows = max(max_rows, un)
                total, table = count_and_join(table, ucols, gkeys)
                max_rows = max(max_rows, total)
            for oprem, oseed, osteps, _of, ovars, okeys in self.optional_specs:
                bmax, btab = walk_chain(oprem, oseed, osteps)
                max_rows = max(max_rows, bmax)
                total, joined = count_and_join(table, btab, okeys)
                # OPTIONAL output = matches + every left row (mesh concat)
                grown = total + rows_of(table)
                if grown > self._CALIBRATE_ROW_LIMIT:
                    raise _Blowup
                max_rows = max(max_rows, grown)
                n_l = rows_of(table)
                out = {}
                for v in set(table) | set(joined):
                    left_part = table.get(v, np.zeros(n_l, dtype=np.uint32))
                    join_part = joined.get(v, np.zeros(total, dtype=np.uint32))
                    out[v] = np.concatenate([join_part, left_part])
                table = out
            for bprem, bseed, bsteps, _bf, _bkeys in self.anti:
                bmax, _btab = walk_chain(bprem, bseed, bsteps)
                max_rows = max(max_rows, bmax)  # anti only shrinks the main
        except _Blowup:
            return heuristic, heuristic
        per_shard = -(-max(max_rows, 1) // self.n)
        cap = round_cap(4 * per_shard, 256)
        return cap, cap

    def _ensure_store(self) -> ShardedTripleStore:
        if self.store is None:
            s, p, o = self.db.store.columns()
            self.store = ShardedTripleStore.from_columns(self.mesh, s, p, o)
        return self.store

    def run_device(self, max_attempts: int = 8, distinct=False, topk=None, with_ranks=False):
        """Run the mesh body; returns the UN-read per-shard tensors
        ``(out_cols, valid, total, nan_flag)`` at the first capacity that
        does not overflow (one host read of the overflow per attempt).
        ``distinct``/``topk`` enable the mesh-side DISTINCT and per-shard
        ORDER BY + LIMIT stages (see :func:`_query_body`)."""
        from kolibrie_tpu_torch.optimizer.device_engine import device_numf, device_string_ranks

        store = self._ensure_store()
        mesh = self.mesh
        state = store.shard_state()
        masks = _mask_copies(mesh, _materialize_masks(self.db, self.mask_exprs))
        f64 = torch.zeros(1, dtype=torch.float64)
        numf = _replicated(mesh, device_numf(self.db) if topk is not None else f64)
        if topk is not None and with_ranks:
            dr, qr = device_string_ranks(self.db)
        else:
            # phase-1 placeholders: used only when a psum'd per-key flag
            # fires, and then the caller runs again with the real ranks
            dr = qr = f64
        dranks, qranks = _replicated(mesh, dr), _replicated(mesh, qr)
        vals = _replicated(
            mesh,
            self.values_ids if self.values_var is not None else np.zeros(1, dtype=np.int64),
        )
        for _attempt in range(max_attempts):
            outs, valid, total, overflow, nan_flag = _query_body(
                state,
                masks,
                numf,
                vals,
                dranks,
                qranks,
                premises=self.premises,
                seed=self.seed,
                steps=self.steps,
                filters=self.filters,
                out_vars=self.out_vars,
                n=self.n,
                join_cap=self.join_cap,
                bucket_cap=self.bucket_cap,
                distinct=distinct,
                topk=topk,
                values_var=self.values_var,
                anti=self.anti,
                unions=self.union_specs,
                optionals=self.optional_specs,
            )
            if int(overflow) == 0:
                return outs, valid, total, nan_flag
            self.join_cap *= 2
            self.bucket_cap *= 2
        raise RuntimeError("distributed query capacities failed to converge")

    def _gather(self, outs, valid) -> dict:
        """The valid rows of every shard as a host table, shard by shard."""
        v = np.concatenate([t.cpu().numpy() for t in valid])
        return {
            var: np.concatenate([o[k].cpu().numpy() for o in outs])[v].astype(np.uint32)
            for k, var in enumerate(self.out_vars)
        }

    def _run_aggregated(self) -> List[List[str]]:
        """GROUP BY / aggregate tail: the gathered result columns flow into
        the single-device segment aggregator (one definition of aggregate
        semantics); the host reads one row per group."""
        from kolibrie_tpu_torch.optimizer.device_engine import aggregate_table
        from kolibrie_tpu_torch.query.executor import _order_table, format_results

        q = self.query
        outs, valid, _total, _nan = self.run_device()
        dev = self.db.device
        flat_cols = tuple(
            torch.cat([o[k].to(dev) for o in outs]) for k in range(len(self.out_vars))
        )
        flat_valid = torch.cat([v.to(dev) for v in valid])
        gpos = [self.out_vars.index(g) for g in q.group_by]
        funcs, apos = [], []
        for item in self.agg_items:
            a = item.agg
            funcs.append(a.func)
            apos.append(-1 if a.var is None else self.out_vars.index(a.var))
        table = aggregate_table(
            self.db, flat_cols, flat_valid, q.group_by, self.agg_items, gpos, funcs, apos
        )
        table = _order_table(self.db, table, q.order_by)
        rows = format_results(self.db, table, q, sort_rows=not q.order_by)
        return _limit_offset(rows, q)

    def _run_with_binds(self) -> List[List[str]]:
        """BIND tail: the mesh gathers ALL pattern variables, then binds,
        post-bind filters, DISTINCT, ordering and the projection run
        host-side on the (small) result table.  Mesh DISTINCT/top-k stay
        off here: they would act on pre-bind tuples."""
        from kolibrie_tpu_torch.ops.unique import unique_table
        from kolibrie_tpu_torch.optimizer.engine import ExecutionEngine
        from kolibrie_tpu_torch.query.executor import _order_table, format_results

        q = self.query
        outs, valid, _total, _nan = self.run_device()
        table = self._gather(outs, valid)
        engine = ExecutionEngine(self.db)
        for b in self.binds:
            col = engine.eval_arith_to_ids(b.expr, table)
            table = dict(table)
            table[b.var] = col
        for f in self.post_bind_filters:
            mask = engine.eval_filter(f, table)
            table = {k: c[mask] for k, c in table.items()}
        if not q.select_all():
            sel = [item.var for item in q.select]
            table = {k: table[k] for k in sel if k in table}
        if q.distinct and table:
            table = unique_table(table)
        table = _order_table(self.db, table, q.order_by)
        rows = format_results(self.db, table, q, sort_rows=not q.order_by)
        return _limit_offset(rows, q)

    def run(self) -> List[List[str]]:
        """Execute and return decoded rows identical to the host volcano
        executor (same formatting, ordering, DISTINCT, LIMIT post-passes)."""
        from kolibrie_tpu_torch.query.executor import _order_table, format_results

        if self.agg_items or self.query.group_by:
            return self._run_aggregated()
        q = self.query
        if self.binds:
            return self._run_with_binds()
        # mesh-side ORDER BY + LIMIT: per-shard top-k when every sort key
        # is a projected variable (the host re-orders the k·n rows)
        topk = None
        if q.limit is not None and q.order_by:
            opos, descs = [], []
            for cond in q.order_by:
                if isinstance(cond.expr, A.Var) and cond.expr.name in self.out_vars:
                    opos.append(self.out_vars.index(cond.expr.name))
                    descs.append(bool(cond.descending))
                else:
                    opos = None
                    break
            if opos is not None:
                k = round_cap((q.offset or 0) + q.limit, 8)
                topk = (k, tuple(opos), tuple(descs))
        outs, valid, _total, nan_flag = self.run_device(distinct=bool(q.distinct), topk=topk)
        if topk is not None and int(nan_flag) > 0:
            # a non-numeric sort key somewhere on the mesh: build the global
            # string ranks and run the SAME top-k with them
            outs, valid, _total, _nan = self.run_device(
                distinct=bool(q.distinct), topk=topk, with_ranks=True
            )
        table = self._gather(outs, valid)
        # DISTINCT already happened on the mesh (owner-shard dedup)
        table = _order_table(self.db, table, q.order_by)
        rows = format_results(self.db, table, q, sort_rows=not q.order_by)
        return _limit_offset(rows, q)


def execute_query_distributed(sparql: str, db, mesh: Mesh, **caps) -> List[List[str]]:
    """One-shot distributed SELECT (see :class:`DistQueryExecutor`)."""
    return DistQueryExecutor(mesh, db, sparql, **caps).run()
