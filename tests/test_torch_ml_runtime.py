"""The neurosymbolic runtime on the port against the JAX package: the
end-to-end cases of ``tests/test_ml.py`` (TRAIN then ML.PREDICT, a neural
predicate in a SELECT and in a RULE body, binary training, the SDD proof
path at 2,000 rows with its pin of one closure per sample, a seed fact that
already exists, RULE … ML.PREDICT) through both packages'
``execute_query_volcano``.

Both databases hold the same triples under the same IDs (the port's
``from_arrays`` of the reference's dictionary and columns) and the same
initial weights (the JAX model's, carried with ``from_params``) in
``trained_models`` before the TRAIN statement.  Each case runs once per
package (module-scoped), and the tests compare:

- the training table, column by column in row order (its order decides
  the batches), exactly;
- each epoch's loss, within 1e-4 relative, and the final parameters within
  1e-4 absolute;
- the closures the SDD path ran (one per sample), exactly;
- the store after the statements that follow TRAIN as decoded triples:
  ``prob:value`` objects by their value within 1e-5, every other triple
  exactly; the rows of the SELECTs, exactly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Callable, Dict, List, Optional

import numpy as np
import pytest

import kolibrie_tpu_torch as port
from kolibrie_tpu.ml import runtime as ref_runtime
from kolibrie_tpu.ml.mlp import MlpNeuralPredicate as RefMlp
from kolibrie_tpu.query.executor import execute_query as ref_execute_query
from kolibrie_tpu.query.executor import execute_query_volcano as ref_execute
from kolibrie_tpu.query.sparql_database import SparqlDatabase as RefDatabase
from kolibrie_tpu_torch.ml import runtime as port_runtime
from kolibrie_tpu_torch.ml.mlp import MlpNeuralPredicate

PROB_VALUE = "http://kolibrie.tpu/prob#value"
TRUE = '"true"^^<http://www.w3.org/2001/XMLSchema#boolean>'


def digit_turtle() -> str:
    rows = []
    rng = np.random.default_rng(42)
    for i in range(40):
        label = i % 2
        x0 = (0.1 if label == 0 else 0.9) + rng.normal(0, 0.05)
        x1 = (0.9 if label == 0 else 0.1) + rng.normal(0, 0.05)
        rows.append(f'ex:s{i} ex:x0 "{x0:.4f}" ; ex:x1 "{x1:.4f}" ; ex:label "{label}" .')
    return "@prefix ex: <http://e/> .\n" + "\n".join(rows)


def hot_turtle(n: int, seed: int, preassert: bool = False) -> str:
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        hot = i % 2
        t = (80 + rng.normal(0, 3)) if hot else (50 + rng.normal(0, 3))
        rows.append(f'ex:m{i} ex:temp "{t:.2f}" ; ex:isHot "{"true" if hot else "false"}" .')
    if preassert:
        rows.append(f"ex:m1 ex:predictedHot {TRUE} .")
    return "@prefix ex: <http://e/> .\n" + "\n".join(rows)


DIGIT_DECLS = """PREFIX ex: <http://e/>
MODEL "digit_model" {
    ARCH MLP { HIDDEN [16] }
    OUTPUT EXCLUSIVE { "0", "1" }
}
NEURAL RELATION ex:predictedDigit USING MODEL "digit_model" {
    INPUT {
        ?sample ex:x0 ?x0 .
        ?sample ex:x1 ?x1 .
    }
    FEATURES { ?x0, ?x1 }
}
"""

DIGIT_PREDICT = """PREFIX ex: <http://e/>
ML.PREDICT(
    MODEL "digit_model",
    INPUT { SELECT ?sample ?x0 ?x1 WHERE {
        ?sample ex:x0 ?x0 . ?sample ex:x1 ?x1 . } },
    OUTPUT ?digit
)"""

HOT_DECLS = """PREFIX ex: <http://e/>
MODEL "{model}" {{ ARCH MLP {{ HIDDEN [8] }} OUTPUT BINARY }}
NEURAL RELATION ex:predictedHot USING MODEL "{model}" {{
    INPUT {{ ?m ex:temp ?t . }}
    FEATURES {{ ?t }}
}}
"""

HOT_TRAIN = """TRAIN NEURAL RELATION ex:predictedHot {{
    DATA {{ ?m ex:isHot ?hot . }}
    LABEL ?hot
    TARGET {{ ?m ex:predictedHot ?l }}
    LOSS bce
    EPOCHS {epochs}
    BATCH_SIZE {batch}
    LEARNING_RATE {lr}
}}"""

ALERT_RULE = ("PREFIX ex: <http://e/>\nRULE :alertRule :- CONSTRUCT { ?m ex:alert \"yes\" . } "
              f"WHERE {{ ?m ex:predictedHot {TRUE} . }}")


@dataclasses.dataclass
class Case:
    turtle: Callable[[], str]
    model: str
    in_dim: int
    hidden: List[int]
    kind: str
    labels: Optional[List[str]]
    train: str
    epochs: int
    before: List[str] = dataclasses.field(default_factory=list)
    after: List[str] = dataclasses.field(default_factory=list)
    save: bool = False


CASES: Dict[str, Case] = {
    # test_ml.py::TestTrainPredict::test_train_and_predict_end_to_end
    "digit_save": Case(
        digit_turtle, "digit_model", 2, [16], "exclusive", ["0", "1"],
        DIGIT_DECLS + """TRAIN NEURAL RELATION ex:predictedDigit {
    DATA { ?sample ex:label ?label . }
    LABEL ?label
    TARGET { ?sample ex:predictedDigit ?label }
    LOSS cross_entropy
    OPTIMIZER adam
    LEARNING_RATE 0.05
    EPOCHS 8
    BATCH_SIZE 8
    SAVE_TO "{save}"
}""", 8,
        after=["PREFIX ex: <http://e/> SELECT ?s ?d WHERE { ?s ex:predictedDigit ?d }"],
        save=True,
    ),
    # ::test_ml_predict_materializes_predictions
    "digit_predict": Case(
        digit_turtle, "digit_model", 2, [16], "exclusive", ["0", "1"],
        DIGIT_DECLS + """TRAIN NEURAL RELATION ex:predictedDigit {
    DATA { ?sample ex:label ?label . }
    LABEL ?label
    TARGET { ?sample ex:predictedDigit ?label }
    LOSS cross_entropy
    EPOCHS 6
    BATCH_SIZE 8
    LEARNING_RATE 0.05
}""", 6,
        after=[
            DIGIT_PREDICT,
            "PREFIX ex: <http://e/> SELECT ?s ?d WHERE { ?s ex:predictedDigit ?d }",
            "PREFIX ex: <http://e/> PREFIX prob: <http://kolibrie.tpu/prob#> "
            'SELECT ?p WHERE { << ex:s0 ex:predictedDigit "0" >> prob:value ?p }',
        ],
    ),
    # ::test_neural_relation_in_query_pattern, and a RULE body naming it
    "digit_pattern": Case(
        digit_turtle, "digit_model", 2, [16], "exclusive", ["0", "1"],
        DIGIT_DECLS + """TRAIN NEURAL RELATION ex:predictedDigit {
    DATA { ?sample ex:label ?label . }
    LABEL ?label
    TARGET { ?sample ex:predictedDigit ?label }
    EPOCHS 6
    BATCH_SIZE 8
    LEARNING_RATE 0.05
}""", 6,
        after=[
            'PREFIX ex: <http://e/> SELECT ?s WHERE { ?s ex:predictedDigit "1" }',
            'PREFIX ex: <http://e/> RULE :one :- CONSTRUCT { ?s ex:isOne "yes" . } '
            'WHERE { ?s ex:predictedDigit "1" . }',
            'PREFIX ex: <http://e/> SELECT ?s WHERE { ?s ex:isOne "yes" }',
        ],
    ),
    # TestBinaryTraining, then RULE … ML.PREDICT and a RULE naming the relation
    "binary": Case(
        lambda: hot_turtle(30, 7), "hot_model", 1, [8], "binary", None,
        HOT_DECLS.format(model="hot_model")
        + HOT_TRAIN.format(epochs=10, batch=8, lr=0.1), 10,
        after=[
            "PREFIX ex: <http://e/> RULE :hotFlag :- CONSTRUCT { ?m ex:flag \"hot\" . } "
            f"WHERE {{ ?m ex:predictedHot {TRUE} . }} "
            'ML.PREDICT(MODEL "hot_model", INPUT { SELECT ?m ?t WHERE { ?m ex:temp ?t . } }, '
            "OUTPUT ?hot)",
            'PREFIX ex: <http://e/> SELECT ?m WHERE { ?m ex:flag "hot" }',
            "PREFIX ex: <http://e/> PREFIX prob: <http://kolibrie.tpu/prob#> "
            "SELECT ?m ?p WHERE { << ?m ex:predictedHot ?h >> prob:value ?p }",
        ],
    ),
    # TestTrainerScale: the SDD path, one closure per sample in all
    "sdd_scale": Case(
        lambda: hot_turtle(2000, 11), "hot2", 1, [8], "binary", None,
        HOT_DECLS.format(model="hot2") + HOT_TRAIN.format(epochs=5, batch=64, lr=0.1), 5,
        before=[ALERT_RULE],
        after=[ALERT_RULE.replace("alertRule", "alertAgain"),
               'PREFIX ex: <http://e/> SELECT ?m WHERE { ?m ex:alert "yes" }'],
    ),
    # TestSeedPreexists: the full-delta fallback for one sample
    "seed_preexists": Case(
        lambda: hot_turtle(24, 3, preassert=True), "hp", 1, [8], "binary", None,
        HOT_DECLS.format(model="hp") + HOT_TRAIN.format(epochs=6, batch=8, lr=0.1), 6,
        before=[ALERT_RULE.replace("alertRule", "r").replace('"yes"', '"y"')],
        after=["PREFIX ex: <http://e/> SELECT ?m ?l WHERE { ?m ex:predictedHot ?l }"],
    ),
}


@contextlib.contextmanager
def spies(runtime, out: dict):
    """Record the training table, each sample's loss and the SDD closures
    of ``runtime``'s TRAIN."""
    saved = {k: getattr(runtime, k) for k in (
        "eval_select_to_table", "eval_where", "_loss_grad",
        "infer_new_facts_with_sdd_seed_specs")}

    def table(fn):
        def wrapped(*a, **k):
            t = fn(*a, **k)
            out.setdefault("tables", []).append(
                {c: np.asarray(v).tolist() for c, v in t.items() if not c.startswith("__")})
            return t
        return wrapped

    def loss(*a, **k):
        value = saved["_loss_grad"](*a, **k)
        out.setdefault("losses", []).append(value[0])
        return value

    def closure(*a, **k):
        out["closures"] = out.get("closures", 0) + 1
        return saved["infer_new_facts_with_sdd_seed_specs"](*a, **k)

    runtime.eval_select_to_table = table(saved["eval_select_to_table"])
    runtime.eval_where = table(saved["eval_where"])
    runtime._loss_grad = loss
    runtime.infer_new_facts_with_sdd_seed_specs = closure
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(runtime, k, v)


def decoded(db):
    """``(plain, probs)``: the store's decoded triples without the
    ``prob:value`` ones, and those as ``{(subject, predicate): value}``."""
    plain, probs = set(), {}
    for s, p, o in db.iter_decoded():
        if p == PROB_VALUE:
            probs[(s, p)] = float(re.match(r'"([^"]*)"', o).group(1))
        else:
            plain.add((s, p, o))
    return plain, probs


def run_case(name: str, pkg: str, tmp_path) -> dict:
    case = CASES[name]
    ref = RefDatabase()
    ref.parse_turtle(case.turtle())
    weights = RefMlp(case.in_dim, case.hidden, case.kind, case.labels, seed=0)
    if pkg == "ref":
        db, execute, runtime, model = ref, ref_execute, ref_runtime, weights
    else:
        db = port.SparqlDatabase.from_arrays(
            ref.dictionary.id_to_str, *ref.store.columns(), quoted=dict(ref.quoted.items()),
            device="cpu")
        db.prefixes.update(ref.prefixes)
        execute, runtime = port.execute_query_volcano, port_runtime
        model = MlpNeuralPredicate.from_params(
            [(np.asarray(w), np.asarray(b)) for w, b in weights.params], case.kind, case.labels,
            device="cpu")
    for q in case.before:
        execute(q, db)
    db.trained_models[case.model] = model
    out: dict = {}
    save = str(tmp_path / f"{name}_{pkg}.json")
    with spies(runtime, out):
        execute(case.train.replace("{save}", save), db)
    trained = db.trained_models[case.model]
    out["params"] = (trained.params_numpy() if pkg == "port"
                     else [(np.asarray(w), np.asarray(b)) for w, b in trained.params])
    if case.save:
        loaded = (MlpNeuralPredicate.load(save, device="cpu") if pkg == "port"
                  else RefMlp.load(save))
        out["loaded"] = loaded.predict(np.array([[0.1, 0.9], [0.9, 0.1]]))
    out["rows"] = [execute(q, db) for q in case.after]
    out["store"] = decoded(db)
    out["legacy"] = (port.execute_query if pkg == "port" else ref_execute_query)(
        case.after[-1], db)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache: dict = {}

    def get(name):
        if name not in cache:
            tmp = tmp_path_factory.mktemp(name)
            cache[name] = {pkg: run_case(name, pkg, tmp) for pkg in ("ref", "port")}
        return cache[name]

    return get


def assert_rows(got, want):
    """Equal rows, a numeric cell within 1e-5."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if re.fullmatch(r"[-+0-9.eE]+", b or "") and a != b:
                assert abs(float(a) - float(b)) <= 1e-5, (g, w)
            else:
                assert a == b, (g, w)


@pytest.mark.parametrize("name", sorted(CASES))
def test_training_table_order(runs, name):
    got, want = runs(name)["port"], runs(name)["ref"]
    assert got["tables"] and got["tables"][0]
    assert got["tables"] == want["tables"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_losses_and_weights(runs, name):
    got, want = runs(name)["port"], runs(name)["ref"]
    assert len(got["losses"]) == len(want["losses"]) > 0
    epochs = CASES[name].epochs
    g = np.asarray(got["losses"]).reshape(epochs, -1).sum(axis=1)
    w = np.asarray(want["losses"]).reshape(epochs, -1).sum(axis=1)
    np.testing.assert_allclose(g, w, rtol=1e-4, atol=0)
    for (gw, gb), (rw, rb) in zip(got["params"], want["params"]):
        np.testing.assert_allclose(gw, rw, rtol=0, atol=1e-4)
        np.testing.assert_allclose(gb, rb, rtol=0, atol=1e-4)
    if "loaded" in want:
        np.testing.assert_allclose(got["loaded"], want["loaded"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", sorted(CASES))
def test_store_and_rows_after_training(runs, name):
    got, want = runs(name)["port"], runs(name)["ref"]
    (gplain, gprob), (wplain, wprob) = got["store"], want["store"]
    assert gplain == wplain
    assert gprob.keys() == wprob.keys()
    for k, v in wprob.items():
        assert abs(gprob[k] - v) <= 1e-5, k
    assert len(got["rows"]) == len(want["rows"])
    for g, w in zip(got["rows"] + [got["legacy"]], want["rows"] + [want["legacy"]]):
        assert_rows(g, w)
    assert any(got["rows"])


def test_sdd_path_runs_one_closure_per_sample(runs):
    got, want = runs("sdd_scale")["port"], runs("sdd_scale")["ref"]
    assert got["closures"] == want["closures"] == 2000
    assert "closures" not in runs("digit_predict")["port"]  # the no-rules fast path
    assert runs("seed_preexists")["port"]["closures"] == runs("seed_preexists")["ref"]["closures"]


def test_premise_facts_are_a_superset_of_what_rules_read():
    """The trainer's reasoner holds only the facts a premise can match;
    a premise with no constant keeps the whole store."""
    from kolibrie_tpu_torch.core.store import ColumnarTripleStore
    from kolibrie_tpu_torch.core.terms import Term, TriplePattern
    from kolibrie_tpu_torch.core.rule import Rule

    st = ColumnarTripleStore("cpu")
    st.add_batch(np.array([1, 2, 3, 4]), np.array([10, 10, 11, 12]), np.array([5, 6, 7, 8]))
    v, c = Term.variable, Term.constant
    r = Rule(premise=[TriplePattern(v("x"), c(10), v("y"))],
             negative_premise=[TriplePattern(v("x"), c(12), c(8))],
             conclusion=[TriplePattern(v("x"), c(13), v("y"))])
    got = port_runtime._premise_facts(st, [r])
    assert sorted(zip(*[c.tolist() for c in got.columns()])) == [
        (1, 10, 5), (2, 10, 6), (4, 12, 8)]
    r.premise.append(TriplePattern(v("a"), v("b"), v("c")))
    assert port_runtime._premise_facts(st, [r]) is st


def test_chip_smoke_phase12_rehearsal(monkeypatch):
    """``chip_smoke.py`` phase 12 on the CPU at a small size (LUBM-2, 2,000
    samples, 400 measurements): every check of the phase holds, with the
    port's CPU run as both sides, and the ML statements call the merge path
    (the launches a card run makes)."""
    import torch

    import chip_smoke as CS
    from benches.lubm import generate_fast

    monkeypatch.setattr(CS, "ML_SAMPLES", 2000)
    monkeypatch.setattr(CS, "ML_MEASUREMENTS", 400)
    monkeypatch.setattr(CS, "ML_MLP_ROWS", 256)
    monkeypatch.setattr(CS, "ML_ADAM_STEPS", 5)
    lubm = port.SparqlDatabase(device="cpu")
    lubm.store.add_batch(*generate_fast(2, lubm.dictionary))
    with CS.KernelCalls() as calls:
        out = CS.run_ml_phase(torch.device("cpu"), lubm)
    assert calls.counts.get("merge_path_join", 0) >= 5, calls.counts
    assert out["counts"]["digit"]["predictions"] == 2000
    assert out["counts"]["hot"] == {"predictions": 400, "prob_err": 0.0, "flips": 0,
                                    "near_boundary": 0}
    assert len(out["losses"]["hot"]) == 5 and out["losses"]["hot"][-1] < out["losses"]["hot"][0]
