"""Neurosymbolic runtime: MODEL / NEURAL RELATION registration, the
TRAIN NEURAL RELATION differentiable-reasoning loop, and ML.PREDICT.

Port of ``kolibrie_tpu/ml/runtime.py`` (a copy, the imports rewritten; the
models live on the database's device).

Parity:
- registration/normalization: ``kolibrie/src/neural_relations.rs`` (:59-107)
- training loop: ``kolibrie/src/execute_ml_train.rs`` (:63-200+) — per
  epoch/batch: MLP forward per neural call → predicted probs become SeedSpecs
  → SDD-provenance closure → P(target) via WMC → loss gradient
  (CE/NLL/MSE/BCE) → ``wmc_gradient`` through the proof structure to seed
  vars → backprop into the MLP (Adam/SGD), artifact save
- prediction: ``kolibrie/src/ml_predict_runtime.rs`` (:40-106 validation,
  :109+ clause execution) + candle-first dispatch
  (``ml_predict_candle.rs:23-122``) — here the "candle" is the torch MLP
- feature loading: ``kolibrie/src/ml_feature_loader.rs`` (:21-104)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from kolibrie_tpu_torch.core.store import ColumnarTripleStore
from kolibrie_tpu_torch.core.triple import Triple
from kolibrie_tpu_torch.ml.mlp import MlpNeuralPredicate
from kolibrie_tpu_torch.query.ast import (
    CombinedQuery,
    LossFn,
    MLPredictClause,
    ModelDecl,
    NeuralRelationDecl,
    OptimizerKind,
    SelectQuery,
    TrainNeuralRelationDecl,
    WhereClause,
)
from kolibrie_tpu_torch.query.executor import eval_select_to_table, eval_where, table_len
from kolibrie_tpu_torch.reasoner.diff_sdd import wmc_gradient_by_seed
from kolibrie_tpu_torch.reasoner.rule_runtime import build_reasoner_from_db
from kolibrie_tpu_torch.reasoner.sdd_seed import infer_new_facts_with_sdd_seed_specs
from kolibrie_tpu_torch.reasoner.seed_spec import ExclusiveGroupSeed, IndependentSeed

PROB_NS = "http://kolibrie.tpu/prob#"
XSD_BOOL_TRUE = '"true"^^http://www.w3.org/2001/XMLSchema#boolean'


# --------------------------------------------------------------------------
# Registration
# --------------------------------------------------------------------------


def register_declarations(db, cq: CombinedQuery) -> None:
    """Normalize + register MODEL and NEURAL RELATION declarations
    (neural_relations.rs:59-107)."""
    for m in cq.models:
        db.model_registry[m.name] = m
    for nr in cq.neural_relations:
        db.neural_relations[nr.predicate] = nr
        db.neural_relations.setdefault("by_model:" + nr.model_name, nr)


def get_or_create_model(db, model_name: str, in_dim: int) -> MlpNeuralPredicate:
    model = db.trained_models.get(model_name)
    if model is not None:
        return model
    decl: Optional[ModelDecl] = db.model_registry.get(model_name)
    hidden = decl.arch.hidden if decl else [16]
    output_kind = decl.output.kind if decl else "binary"
    labels = decl.output.labels if decl else []
    model = MlpNeuralPredicate(in_dim, hidden, output_kind, labels, device=db.device)
    db.trained_models[model_name] = model
    return model


# --------------------------------------------------------------------------
# Feature loading (ml_feature_loader.rs parity)
# --------------------------------------------------------------------------


def query_training_rows(
    db, select: Optional[SelectQuery], patterns=None
) -> Tuple[List[str], List[Dict[str, int]]]:
    """Run the training SELECT (or a bare pattern block) → binding rows as
    var -> term-id maps."""
    if select is not None:
        table = eval_select_to_table(db, select)
    else:
        table = eval_where(db, WhereClause(patterns=list(patterns or [])))
    names = [k for k in table.keys() if not k.startswith("__")]
    n = table_len(table)
    rows = [{k: int(table[k][i]) for k in names} for i in range(n)]
    return names, rows


def build_feature_vec(db, row: Dict[str, int], feature_vars: List[str]) -> np.ndarray:
    """xsd numeric literal -> f64 (ml_feature_loader.rs:21-104)."""
    numeric = db.numeric_values()
    out = np.zeros(len(feature_vars), dtype=np.float64)
    for i, v in enumerate(feature_vars):
        tid = row.get(v, 0)
        val = numeric[tid] if tid < len(numeric) else np.nan
        out[i] = 0.0 if np.isnan(val) else val
    return out


# --------------------------------------------------------------------------
# TRAIN NEURAL RELATION (execute_ml_train.rs parity)
# --------------------------------------------------------------------------


def _loss_grad(loss: LossFn, p_q: float, y: float = 1.0) -> Tuple[float, float]:
    """(loss value, dL/dp_q) for target probability p_q with label y∈{0,1}
    (CE/NLL/MSE/BCE ∂L/∂p_q table, execute_ml_train.rs:158)."""
    p = min(max(p_q, 1e-7), 1.0 - 1e-7)
    if loss == LossFn.MSE:
        return (y - p) ** 2, -2.0 * (y - p)
    # CE / NLL / BCE
    if y >= 0.5:
        return -float(np.log(p)), -1.0 / p
    return -float(np.log(1.0 - p)), 1.0 / (1.0 - p)


def _binary_label(db, row: Dict[str, int], label_var: str) -> float:
    lex = db.dictionary.decode(row.get(label_var, 0)) or ""
    if lex.startswith('"'):
        lex = lex[1:].split('"')[0]
    return 1.0 if lex.lower() in ("true", "1", "yes") else 0.0


def _premise_facts(store, rules) -> ColumnarTripleStore:
    """The facts of ``store`` that a premise of ``rules``, positive or
    negated, can match, as a store of their own: a superset of every fact
    a closure under ``rules`` reads, so every closure derives the same facts
    and tags over it.  The reference's trainer closes over the whole
    database; there each per-sample closure merges its few new facts into
    every sort order of the whole store, which costs O(store) a sample."""
    parts = []
    for rule in rules:
        for pat in list(rule.premise) + list(rule.negative_premise):
            consts = [t.value if t.is_constant else None for t in pat.terms()]
            if consts == [None, None, None]:
                return store
            parts.append(store.match(*consts))
    out = ColumnarTripleStore(store.device)
    if parts:
        out.add_batch(*(np.concatenate(c) for c in zip(*parts)))
    return out


def execute_train_decl(db, decl: TrainNeuralRelationDecl) -> Dict[str, float]:
    """The differentiable-reasoning training loop (SURVEY §3.4)."""
    nr: Optional[NeuralRelationDecl] = db.neural_relations.get(decl.relation)
    if nr is None:
        raise ValueError(f"no NEURAL RELATION declared for {decl.relation!r}")
    model_decl: Optional[ModelDecl] = db.model_registry.get(nr.model_name)
    exclusive = model_decl is not None and model_decl.output.kind == "exclusive"
    labels = model_decl.output.labels if model_decl else []

    # training rows: label + features joined from DATA/QUERY + INPUT patterns
    if decl.data_query is not None:
        base_select = decl.data_query
        if isinstance(base_select, str):
            from kolibrie_tpu_torch.query.parser import parse_sparql_query

            base_select = parse_sparql_query(base_select, db.prefixes)
        table = eval_select_to_table(db, base_select)
    else:
        where = WhereClause(patterns=list(decl.data_patterns) + list(nr.input_patterns))
        table = eval_where(db, where)
    names = [k for k in table.keys() if not k.startswith("__")]
    n = table_len(table)
    rows = [{k: int(table[k][i]) for k in names} for i in range(n)]
    if not rows:
        raise ValueError("no training rows matched")

    pred_id = db.dictionary.encode(decl.relation)
    model = get_or_create_model(db, nr.model_name, len(nr.feature_vars))
    model.learning_rate = decl.learning_rate
    model.optimizer = (
        "sgd" if decl.optimizer == OptimizerKind.SGD else "adam"
    )

    # standardize features over the training set (StandardScaler parity)
    all_X = np.stack([build_feature_vec(db, r, nr.feature_vars) for r in rows])
    model.set_normalization(all_X.mean(axis=0), all_X.std(axis=0))

    rules = [r for r in db.rule_map.values()]
    rng = np.random.default_rng(0)
    history = {"loss": 0.0, "epochs": 0}
    # Fast path: with no rules the SDD closure is exactly the seed itself —
    # P(target) = p_label and ∂P/∂p_i = δ_{i,label} — so skip per-sample
    # reasoner/SDD construction entirely (plain MLP classification).
    no_rules = not rules

    # One ground reasoner for the whole run (execute_ml_train.rs:337 parity):
    # built + rule-loaded ONCE; per sample the closure's seed/derived facts
    # are rolled back via an O(1) store snapshot instead of recloning the db.
    kg = None
    base_snap = None
    seeds_only_delta = False
    if not no_rules:
        kg = build_reasoner_from_db(db)
        kg.facts = _premise_facts(kg.facts, rules)
        for rule in rules:
            kg.add_rule(rule)
        # NAF-free programs are monotone: close the base facts ONCE, then
        # each per-sample closure needs only the seed triples as its first
        # delta (its derivation cone), not the whole database.  With NAF the
        # closure is non-monotone in the seed facts, so fall back to the
        # full-delta closure per sample.
        if not any(r.negative_premise for r in rules):
            kg.infer_new_facts_semi_naive()
            seeds_only_delta = True
        base_snap = kg.facts.snapshot()
        # Frozen view of the closed base, shared as every per-sample
        # closure's round-1 old-side: its lazily-built sort orders are
        # computed once and reused for all samples/epochs.
        base_store = kg.facts.clone() if seeds_only_delta else None
    # Per-sample proof-structure cache: the SDD built for a sample depends
    # only on the db facts + seed TRIPLES — not on the seed probabilities,
    # which enter as variable weights.  So the closure runs once per sample
    # (first epoch); later epochs reuse (prov, tag) and just reassign seed
    # weights before re-evaluating WMC and its gradient.
    proof_cache: Dict[int, Optional[Tuple[object, int]]] = {}
    if not no_rules:
        true_term = db.dictionary.encode(XSD_BOOL_TRUE)
        label_terms = [db.dictionary.encode(f'"{lab}"') for lab in labels]
    for _epoch in range(decl.epochs):
        order = rng.permutation(len(rows))
        epoch_loss = 0.0
        for start in range(0, len(rows), decl.batch_size):
            batch_idx = order[start : start + decl.batch_size]
            X = np.stack(
                [build_feature_vec(db, rows[i], nr.feature_vars) for i in batch_idx]
            )
            probs, backward = model.forward_with_vjp(X)
            cotangent = np.zeros(probs.shape, dtype=np.float64)
            if no_rules:
                for bi, ri in enumerate(batch_idx):
                    row = rows[ri]
                    if exclusive:
                        lab = db.dictionary.decode(row.get(decl.label_var, 0)) or ""
                        lab_lex = lab[1:].split('"')[0] if lab.startswith('"') else lab
                        try:
                            li = labels.index(lab_lex)
                        except ValueError:
                            continue
                        p_q = float(probs[bi, li])
                        loss, dl_dpq = _loss_grad(decl.loss, p_q)
                        epoch_loss += loss
                        cotangent[bi, li] += dl_dpq
                    else:
                        p_q = float(probs[bi]) if probs.ndim == 1 else float(probs[bi, 0])
                        y = _binary_label(db, row, decl.label_var)
                        loss, dl_dpq = _loss_grad(decl.loss, p_q, y)
                        epoch_loss += loss
                        if cotangent.ndim == 1:
                            cotangent[bi] += dl_dpq
                        else:
                            cotangent[bi, 0] += dl_dpq
                grads = backward(cotangent)
                model.apply_gradients(grads)
                continue
            for bi, ri in enumerate(batch_idx):
                row = rows[ri]
                ri = int(ri)
                anchor_id = row.get(nr.anchor_var, 0)
                label_id = row.get(decl.label_var, 0)
                if ri in proof_cache:
                    cached = proof_cache[ri]
                    if cached is None:
                        continue  # target not derivable for this sample
                    prov, tag = cached
                    if exclusive:
                        for li in range(len(labels)):
                            var = prov.seed_vars.get(li)
                            if var is not None:
                                prov.manager.set_weight(var, float(probs[bi, li]))
                    else:
                        var = prov.seed_vars.get(0)
                        if var is not None:
                            p = float(probs[bi]) if probs.ndim == 1 else float(probs[bi, 0])
                            prov.manager.set_weight(var, p)
                else:
                    # first epoch: run the closure, then roll the shared
                    # reasoner back to the base facts
                    if exclusive:
                        choices = [
                            (Triple(anchor_id, pred_id, label_terms[li]), float(probs[bi, li]), li)
                            for li in range(len(labels))
                        ]
                        specs = [ExclusiveGroupSeed(0, choices)]
                        target_obj = label_id
                    else:
                        p = float(probs[bi]) if probs.ndim == 1 else float(probs[bi, 0])
                        specs = [
                            IndependentSeed(Triple(anchor_id, pred_id, true_term), p, 0)
                        ]
                        target_obj = true_term
                    tag_store, prov = infer_new_facts_with_sdd_seed_specs(
                        kg,
                        specs,
                        seeds_only_delta=seeds_only_delta,
                        base_store=base_store,
                    )
                    kg.facts.restore(base_snap)
                    target = Triple(anchor_id, pred_id, target_obj)
                    tag = tag_store.get_opt(target)
                    proof_cache[ri] = None if tag is None else (prov, tag)
                    if tag is None:
                        continue  # target not derivable for this sample
                p_q = prov.recover_probability(tag)
                y = 1.0 if exclusive else _binary_label(db, row, decl.label_var)
                loss, dl_dpq = _loss_grad(decl.loss, p_q, y)
                epoch_loss += loss
                seed_grads = wmc_gradient_by_seed(prov.manager, tag, prov.seed_vars)
                if exclusive:
                    for li in range(len(labels)):
                        g = seed_grads.get(li, 0.0)
                        cotangent[bi, li] += dl_dpq * g
                else:
                    g = seed_grads.get(0, 0.0)
                    if cotangent.ndim == 1:
                        cotangent[bi] += dl_dpq * g
                    else:
                        cotangent[bi, 0] += dl_dpq * g
            grads = backward(cotangent)
            model.apply_gradients(grads)
        history["loss"] = epoch_loss / max(len(rows), 1)
        history["epochs"] += 1
    if decl.save_path:
        model.save(decl.save_path)
    db.trained_models[nr.model_name] = model
    return history


# --------------------------------------------------------------------------
# ML.PREDICT (ml_predict_runtime.rs parity)
# --------------------------------------------------------------------------


def execute_ml_predict(db, clause: MLPredictClause) -> List[Triple]:
    """Run the INPUT query, dispatch the (torch) model, materialize prediction
    triples + probability companion facts (ml_predict_runtime.rs:109+)."""
    table = eval_select_to_table(db, clause.input_select)
    names = [
        i.var
        for i in clause.input_select.select
        if i.kind == "var" and i.var != "*"
    ]
    if not names:
        names = sorted(k for k in table.keys() if not k.startswith("__"))
    anchor_var = names[0]
    feature_vars = [v for v in names[1:]]
    n = table_len(table)
    if n == 0:
        return []
    rows = [{k: int(table[k][i]) for k in table if not k.startswith("__")} for i in range(n)]
    model = db.trained_models.get(clause.model)
    if model is None:
        model = get_or_create_model(db, clause.model, len(feature_vars))
    X = np.stack([build_feature_vec(db, row, feature_vars) for row in rows])
    probs = model.predict(X)

    nr: Optional[NeuralRelationDecl] = db.neural_relations.get(
        "by_model:" + clause.model
    )
    pred_iri = nr.predicate if nr is not None else f"urn:ml:{clause.model}:{clause.output_var}"
    pred_id = db.dictionary.encode(pred_iri)
    pv = db.dictionary.encode(PROB_NS + "value")
    out: List[Triple] = []
    for i, row in enumerate(rows):
        anchor_id = row.get(anchor_var, 0)
        if model.output_kind == "binary":
            p = float(probs[i]) if probs.ndim == 1 else float(probs[i, 0])
            obj = db.dictionary.encode(XSD_BOOL_TRUE)
            t = Triple(anchor_id, pred_id, obj)
            out.append(t)
            db.add_triple(t)
            qid = db.quoted.intern(*t)
            db.add_triple(
                Triple(qid, pv, db.dictionary.encode(f'"{p}"^^http://www.w3.org/2001/XMLSchema#double'))
            )
        else:
            li = int(np.argmax(probs[i]))
            lab = model.labels[li] if li < len(model.labels) else str(li)
            obj = db.dictionary.encode(f'"{lab}"')
            t = Triple(anchor_id, pred_id, obj)
            out.append(t)
            db.add_triple(t)
            p = float(probs[i, li])
            qid = db.quoted.intern(*t)
            db.add_triple(
                Triple(qid, pv, db.dictionary.encode(f'"{p}"^^http://www.w3.org/2001/XMLSchema#double'))
            )
    return out


def materialize_neural_relations_for_patterns(db, patterns) -> int:
    """Materialize neural predicates referenced by WHERE/RULE patterns as
    ordinary RDF triples (neural_relations.rs
    materialize_neural_relations_for_patterns)."""
    count = 0
    seen: set = set()
    cache = getattr(db, "_neural_materialized", None)
    if cache is None:
        cache = db._neural_materialized = {}
    for pat in patterns:
        pred = pat.predicate
        if pred.kind != "term":
            continue
        pred_iri = db.expand_term(pred.value)
        if pred_iri in seen:
            continue  # one inference pass per predicate per call
        seen.add(pred_iri)
        nr: Optional[NeuralRelationDecl] = db.neural_relations.get(pred_iri)
        if nr is None:
            continue
        if cache.get(pred_iri) == db.store.version:
            continue  # store unchanged since last materialization
        select = SelectQuery(
            select=[],
            where=WhereClause(patterns=list(nr.input_patterns)),
        )
        table = eval_where(db, select.where)
        n = table_len(table)
        if n == 0:
            continue
        rows = [
            {k: int(table[k][i]) for k in table if not k.startswith("__")}
            for i in range(n)
        ]
        model = db.trained_models.get(nr.model_name)
        if model is None:
            model = get_or_create_model(db, nr.model_name, len(nr.feature_vars))
        X = np.stack([build_feature_vec(db, row, nr.feature_vars) for row in rows])
        pred_id = db.dictionary.encode(pred_iri)
        labels = model.predict_labels(X)
        for row, lab in zip(rows, labels):
            anchor_id = row.get(nr.anchor_var, 0)
            if model.output_kind == "binary":
                if lab != "true":
                    continue
                obj = db.dictionary.encode(XSD_BOOL_TRUE)
            else:
                obj = db.dictionary.encode(f'"{lab}"')
            db.add_triple(Triple(anchor_id, pred_id, obj))
            count += 1
        # record post-materialization store version: a later query with no
        # intervening data changes skips re-inference for this predicate
        cache[pred_iri] = db.store.version
    return count
