"""The port's MLSchema converter, MLSchema Turtle writer and model handler
against the JAX package's: the cases of ``tests/test_ml.py``
(``TestMLSchemaConverter``, ``TestMLSchemaAndHandler``,
``TestGenerateMlModels``) through both packages.

Graphs compare as sets of decoded triples, exactly, except the
``software/<module>`` IRI, which names the package that defines the model
(the reference's rule); query rows and handler results compare exactly.
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest

import kolibrie_tpu_torch as port
from kolibrie_tpu.ml import handler as ref_handler
from kolibrie_tpu.ml import mlschema as ref_mlschema
from kolibrie_tpu.ml.mlp import MlpNeuralPredicate as RefMlp
from kolibrie_tpu.query.executor import execute_query_volcano as ref_execute
from kolibrie_tpu.query.sparql_database import SparqlDatabase as RefDatabase
from kolibrie_tpu_torch.ml import handler as port_handler
from kolibrie_tpu_torch.ml import mlschema as port_mlschema
from kolibrie_tpu_torch.ml.mlp import MlpNeuralPredicate

from test_ml import DummySk
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

SOFTWARE = "http://kolibrie.tpu/software/"
ACCURACY = """PREFIX mls: <http://www.w3.org/ns/mls#>
SELECT ?v WHERE {
  ?e a mls:ModelEvaluation .
  ?e mls:specifiedBy <http://www.w3.org/ns/mls#accuracy> .
  ?e mls:hasValue ?v }"""
REALIZES = """PREFIX mls: <http://www.w3.org/ns/mls#>
SELECT ?a WHERE { ?r a mls:Run . ?r mls:realizes ?a }"""


class LinearStub:
    coef_ = np.array([[0.5, -1.5]])
    intercept_ = np.array([0.25])

    def get_params(self):
        return {"C": 1.0, "penalty": "l2"}


def graph(db, package: str) -> set:
    """Decoded triples with the defining package's software IRI made
    neutral."""
    return {tuple(t.replace(SOFTWARE + package, SOFTWARE + "<package>") for t in triple)
            for triple in db.iter_decoded()}


def convert(kind: str, pkg: str):
    conv = (port_mlschema.MLSchemaConverter(device="cpu") if pkg == "port"
            else ref_mlschema.MLSchemaConverter())
    conv.db.execution_mode = "device"  # both: the graph is under the host-routed floor
    if kind == "linear":
        conv.convert_model(
            LinearStub(), X_train=np.zeros((30, 2)), X_test=np.zeros((10, 2)),
            y_test=np.zeros(10), feature_names=["age", "salary"], class_names=["hot"],
            cpu_time_used=1.5, evaluation_metrics={"accuracy": 0.93})
        return conv, LinearStub.__module__.split(".")[0]
    ref = RefMlp(2, [4], "binary")
    model = (ref if pkg == "ref" else MlpNeuralPredicate.from_params(
        [(np.asarray(w), np.asarray(b)) for w, b in ref.params], device="cpu"))

    def evaluate(m, X, y):
        return {"meanProb": float(np.mean(m.predict(X)))}

    conv.convert_model(model, X_test=np.zeros((5, 2)), y_test=np.zeros(5),
                       evaluation_function=evaluate)
    return conv, "kolibrie_tpu_torch" if pkg == "port" else "kolibrie_tpu"


@pytest.mark.parametrize("kind", ["linear", "mlp"])
def test_converter_graph_and_queries(kind):
    (got, gsw), (want, wsw) = convert(kind, "port"), convert(kind, "ref")
    assert graph(got.db, gsw) == graph(want.db, wsw)
    if kind == "mlp":
        assert gsw != wsw  # the software IRI names the defining package
        ttl = got.serialize()
        assert "Parameter layer0.W" in ttl and '"(2, 4)"' in ttl and "layers.0" not in ttl
    for q in (ACCURACY, REALIZES):
        assert got.query(q) == want.query(q)
    for fmt, parse in (("turtle", "parse_turtle"), ("ntriples", "parse_ntriples"),
                       ("rdfxml", "parse_rdf")):
        back = port.SparqlDatabase(device="cpu")
        getattr(back, parse)(got.serialize(fmt))
        assert set(back.iter_decoded()) == set(got.db.iter_decoded()), fmt


def test_mlschema_roundtrip():
    ttl = port_mlschema.model_to_mlschema_ttl("m1", metrics={"accuracy": 0.93, "cpuUsage": 12.5})
    assert ttl == ref_mlschema.model_to_mlschema_ttl(
        "m1", metrics={"accuracy": 0.93, "cpuUsage": 12.5})
    tdb, rdb = port.SparqlDatabase(device="cpu"), RefDatabase()
    tdb.execution_mode = rdb.execution_mode = "device"  # under the host-routed floor
    assert port_mlschema.load_mlschema_into_db(tdb, ttl) == ref_mlschema.load_mlschema_into_db(
        rdb, ttl)
    assert set(tdb.iter_decoded()) == set(rdb.iter_decoded())
    assert port.execute_query_volcano(ACCURACY, tdb) == ref_execute(ACCURACY, rdb) == [["0.93"]]


def test_handler_discovery_best_model(tmp_path):
    for name, cpu in [("fast", 1.0), ("slow", 50.0)]:
        with open(tmp_path / f"{name}_predictor.pkl", "wb") as f:
            pickle.dump(DummySk(1.0 if name == "fast" else 2.0), f)
        (tmp_path / f"{name}_schema.ttl").write_text(
            port_mlschema.model_to_mlschema_ttl(name, metrics={"cpuUsage": cpu}))
    assert port_handler.parse_mlschema_ttl(str(tmp_path / "slow_schema.ttl")) == (
        ref_handler.parse_mlschema_ttl(str(tmp_path / "slow_schema.ttl")))
    got, want = port_handler.MLHandler(), ref_handler.MLHandler()
    assert got.discover_and_load_models(str(tmp_path)) == want.discover_and_load_models(
        str(tmp_path)) == ["fast"]
    res, rres = got.predict("fast", [[1.0, 2.0]]), want.predict("fast", [[1.0, 2.0]])
    assert res.predictions == rres.predictions == [1.0]
    assert res.timing.total_ms >= 0 and res.model_name == "fast"
    assert [m.name for m in got.compare_models()] == [m.name for m in want.compare_models()]
    assert [m.resource_score() for m in got.compare_models()] == [
        m.resource_score() for m in want.compare_models()]
    with pytest.raises(KeyError):
        got.predict("slow", [[1.0]])


def test_generate_ml_models(tmp_path):
    script = (
        "import pickle\n"
        "with open('temp_predictor.pkl', 'wb') as f:\n"
        "    pickle.dump({'const': 7.0}, f)\n"
        "with open('temp_schema.ttl', 'w') as f:\n"
        "    f.write('@prefix mls: <http://www.w3.org/ns/mls#> .\\n'\n"
        "            '<http://m/e> mls:specifiedBy mls:cpuUsage ;\\n'\n"
        "            '  mls:hasValue 3.5 .\\n')\n"
    )
    for pkg in ("port", "ref"):
        (tmp_path / pkg).mkdir()
        (tmp_path / pkg / "temp_predictor.py").write_text(script)
    got = port_handler.MLHandler().generate_ml_models(str(tmp_path / "port"))
    want = ref_handler.MLHandler().generate_ml_models(str(tmp_path / "ref"))
    assert got == want == ["temp"]
    assert port_handler.parse_mlschema_ttl(str(tmp_path / "port" / "temp_schema.ttl")) == {
        "cpuusage": 3.5}
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "bad_predictor.py").write_text("raise SystemExit(3)\n")
    with pytest.raises(RuntimeError, match="bad_predictor"):
        port_handler.MLHandler().generate_ml_models(str(tmp_path / "bad"))
