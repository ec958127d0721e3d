"""MLSchema export: encode model implementations + evaluation metrics as W3C
MLSchema (mls:) RDF/Turtle — metrics-as-knowledge-graph, queryable back via
SPARQL.

Port of ``kolibrie_tpu/ml/mlschema.py`` (a copy, the imports rewritten; the
converter's graph is a port ``SparqlDatabase``, and the port's own MLP is
exported in the reference's ``layer{i}.W`` / ``layer{i}.b`` form).

Parity: ``ml/src/mlschema.py`` (the reference's Python MLSchema writer) and
the metrics-as-RDF pattern noted in SURVEY §5.
"""

from __future__ import annotations

from typing import Dict

from kolibrie_tpu_torch.backend import DeviceLike
from kolibrie_tpu_torch.ml.mlp import MlpNeuralPredicate

MLS = "http://www.w3.org/ns/mls#"
XSD = "http://www.w3.org/2001/XMLSchema#"


def model_to_mlschema_ttl(
    name: str,
    algorithm: str = "MLP",
    metrics: Dict[str, float] = None,
    base: str = "http://kolibrie.tpu/models/",
) -> str:
    """Render a trained model + its evaluation metrics as MLSchema Turtle."""
    metrics = metrics or {}
    m = f"<{base}{name}>"
    lines = [
        "@prefix mls: <http://www.w3.org/ns/mls#> .",
        f"@prefix xsd: <{XSD}> .",
        "",
        f"{m} a mls:Model ;",
        f'    mls:hasQuality "{algorithm}" .',
        "",
        f"<{base}{name}/run> a mls:Run ;",
        f"    mls:hasOutput {m} .",
    ]
    for i, (measure, value) in enumerate(sorted(metrics.items())):
        ev = f"<{base}{name}/eval/{i}>"
        lines += [
            "",
            f"{ev} a mls:ModelEvaluation ;",
            f"    mls:specifiedBy <{MLS}{measure}> ;",
            f'    mls:hasValue "{value}"^^xsd:double .',
            f"<{base}{name}/run> mls:hasOutput {ev} .",
        ]
    return "\n".join(lines) + "\n"


def load_mlschema_into_db(db, ttl: str) -> int:
    """Ingest MLSchema metadata so model metrics are SPARQL-queryable."""
    return db.parse_turtle(ttl)


class MLSchemaConverter:
    """Full model→MLSchema knowledge-graph converter.

    Parity: ``ml/src/mlschema.py`` ``MLSchema.convert_model`` (:41-139) —
    the Run/Implementation/Algorithm/Software/Task/EvaluationSpecification
    graph, hyperparameters (:142), dataset characteristics (:161),
    evaluation measures incl. custom evaluation functions (:195-248),
    per-framework model characteristics (:250-357: sklearn linear/tree,
    keras, torch — plus this port's MLP), and CPU time
    (:359).  Where the reference builds an rdflib ``Graph``, this converter
    dogfoods the framework itself: triples land in a
    :class:`~kolibrie_tpu_torch.query.sparql_database.SparqlDatabase`, so
    ``serialize()`` is the engine's own Turtle writer and ``query()`` runs
    the engine's own SPARQL.
    """

    DCTERMS = "http://purl.org/dc/terms/"
    RDF_TYPE = "<http://www.w3.org/1999/02/22-rdf-syntax-ns#type>"
    RDFS_LABEL = "<http://www.w3.org/2000/01/rdf-schema#label>"

    def __init__(self, base: str = "http://kolibrie.tpu/", device: DeviceLike = None) -> None:
        """``device``: where the metadata graph's database runs (the CUDA
        card unless the caller passes another)."""
        from kolibrie_tpu_torch.query.sparql_database import SparqlDatabase

        self.base = base
        self.db = SparqlDatabase(device)
        self.db.register_prefix("mls", MLS)
        self.db.register_prefix("dcterms", self.DCTERMS)
        self.db.register_prefix("ex", base)
        self._eval_counter = 0

    # ------------------------------------------------------------- plumbing

    def _iri(self, local: str) -> str:
        return f"<{self.base}{local}>"

    def _mls(self, local: str) -> str:
        return f"<{MLS}{local}>"

    def _add(self, s: str, p: str, o: str) -> None:
        self.db.add_triple_parts(s, p, o)

    @staticmethod
    def _lit(value, dtype: str = None) -> str:
        if dtype:
            return f'"{value}"^^{XSD}{dtype}'
        return f'"{value}"'

    # ------------------------------------------------------------ converter

    def convert_model(
        self,
        model,
        X_train=None,
        y_train=None,
        X_test=None,
        y_test=None,
        feature_names=None,
        class_names=None,
        cpu_time_used: float = None,
        model_uri: str = None,
        evaluation_function=None,
        evaluation_metrics: Dict[str, float] = None,
    ) -> str:
        """Convert a trained model + data + metrics into the MLSchema graph;
        returns the model IRI."""
        m = model_uri if model_uri else f"{self.base}model1"
        m_t = f"<{m}>"
        run = self._iri("run1")
        self._add(run, self.RDF_TYPE, self._mls("Run"))
        self._add(run, self._mls("hasOutput"), m_t)
        self._add(m_t, self.RDF_TYPE, self._mls("Model"))

        impl = self._iri("implementation1")
        self._add(impl, self.RDF_TYPE, self._mls("Implementation"))
        self._add(run, self._mls("executes"), impl)

        algorithm = type(model).__name__
        algo = self._iri(f"algorithm/{algorithm}")
        self._add(algo, self.RDF_TYPE, self._mls("Algorithm"))
        self._add(impl, self._mls("implements"), algo)
        self._add(run, self._mls("realizes"), algo)

        # framework detection by defining module (mlschema.py:100-105)
        software = (
            model.__module__.split(".")[0]
            if hasattr(model, "__module__")
            else "unknown"
        )
        sw = self._iri(f"software/{software}")
        self._add(sw, self.RDF_TYPE, self._mls("Software"))
        self._add(sw, self._mls("hasPart"), impl)

        self._add_hyperparameters(model, impl, run)

        for uri_local, data, kind in (
            ("data/training", X_train, "Training"),
            ("data/testing", X_test, "Testing"),
        ):
            if data is None:
                continue
            d = self._iri(uri_local)
            self._add(d, self.RDF_TYPE, self._mls("Dataset"))
            self._add(run, self._mls("hasInput"), d)
            self._add_dataset_characteristics(d, data, kind)

        task = self._iri("task1")
        self._add(task, self.RDF_TYPE, self._mls("Task"))
        self._add(run, self._mls("achieves"), task)
        eval_spec = self._iri("evalspec1")
        self._add(eval_spec, self.RDF_TYPE, self._mls("EvaluationSpecification"))
        self._add(eval_spec, self._mls("defines"), task)

        metrics = dict(evaluation_metrics or {})
        if evaluation_function is not None and X_test is not None:
            metrics.update(evaluation_function(model, X_test, y_test))
        for name, value in sorted(metrics.items()):
            self._add_single_evaluation(name, value, eval_spec, run)

        self._add_model_characteristics(model, m_t, feature_names, class_names)
        if cpu_time_used is not None:
            self._add_single_evaluation(
                "cpuUsage", float(cpu_time_used), eval_spec, run
            )
        return m

    # -------------------------------------------------------- sub-builders

    def _add_hyperparameters(self, model, impl: str, run: str) -> None:
        """sklearn ``get_params()``, torch/keras config dicts, or the native
        MLP's fields (mlschema.py:142-158)."""
        params = {}
        if hasattr(model, "get_params"):
            try:
                params = dict(model.get_params())
            # kolint: ignore[KL601] best-effort metadata harvest from a foreign model object; empty params is the documented degraded output
            except Exception:
                params = {}
        elif hasattr(model, "hidden"):  # MlpNeuralPredicate
            params = {
                "hidden": getattr(model, "hidden", None),
                "learning_rate": getattr(model, "learning_rate", None),
                "optimizer": getattr(model, "optimizer", None),
                "output_kind": getattr(model, "output_kind", None),
            }
        for i, (name, value) in enumerate(sorted(params.items())):
            if value is None or callable(value):
                continue
            hp = self._iri(f"hyperparam/{name}")
            self._add(hp, self.RDF_TYPE, self._mls("HyperParameter"))
            self._add(impl, self._mls("hasHyperParameter"), hp)
            setting = self._iri(f"hpsetting/{i}")
            self._add(setting, self.RDF_TYPE, self._mls("HyperParameterSetting"))
            self._add(setting, self._mls("specifiedBy"), hp)
            self._add(setting, self._mls("hasValue"), self._lit(value))
            self._add(run, self._mls("hasInput"), setting)

    def _add_dataset_characteristics(self, d: str, X, kind: str) -> None:
        """Row/feature counts as DatasetCharacteristic (mlschema.py:161-192)."""
        try:
            n_rows = len(X)
            n_feats = len(X[0]) if n_rows and hasattr(X[0], "__len__") else 1
        except TypeError:
            return
        for name, value in (("numberOfInstances", n_rows), ("numberOfFeatures", n_feats)):
            c = self._iri(f"datachar/{kind}/{name}")
            self._add(c, self.RDF_TYPE, self._mls("DatasetCharacteristic"))
            self._add(d, self._mls("hasQuality"), c)
            self._add(c, self._mls("hasValue"), self._lit(value, "integer"))
            self._add(c, self.RDFS_LABEL, self._lit(f"{kind} {name}"))

    def _add_single_evaluation(
        self, metric: str, value: float, eval_spec: str, run: str
    ) -> None:
        """One ModelEvaluation node (mlschema.py:230-248) — same shape the
        simple writer and :func:`parse_mlschema_ttl` use."""
        self._eval_counter += 1
        measure = self._mls(metric)
        self._add(measure, self.RDF_TYPE, self._mls("EvaluationMeasure"))
        self._add(eval_spec, self._mls("hasPart"), measure)
        ev = self._iri(f"eval/{self._eval_counter}")
        self._add(ev, self.RDF_TYPE, self._mls("ModelEvaluation"))
        self._add(ev, self._mls("specifiedBy"), measure)
        self._add(ev, self._mls("hasValue"), self._lit(float(value), "double"))
        self._add(run, self._mls("hasOutput"), ev)

    def _add_model_characteristics(
        self, model, m_t: str, feature_names, class_names
    ) -> None:
        """Per-framework learned-parameter export (mlschema.py:250-357).
        The port's MLP is a ``torch.nn.Module`` but skips the torch branch:
        it exports the native MLP's ``layer{i}.W`` / ``layer{i}.b`` with
        ``(in, out)`` shapes, as the JAX package does."""
        if hasattr(model, "coef_"):
            self._add_linear(model, m_t, feature_names, class_names)
        elif hasattr(model, "feature_importances_"):
            self._add_tree(model, m_t, feature_names)
        elif hasattr(model, "named_parameters") and not isinstance(
            model, MlpNeuralPredicate
        ):  # torch
            self._add_named_params(
                model.named_parameters(), m_t, lambda p: tuple(p.shape)
            )
        elif hasattr(model, "layers"):  # keras
            self._add_keras(model, m_t)
        elif hasattr(model, "params"):  # native MLP: [(W, b), ...]
            try:
                named = [
                    (f"layer{i}.{nm}", arr)
                    for i, wb in enumerate(model.params)
                    for nm, arr in zip(("W", "b"), wb)
                ]
            # kolint: ignore[KL601] foreign model params may not be (W, b) tuples; skipping weight triples is the documented degraded output
            except Exception:
                return
            self._add_named_params(
                named, m_t, lambda a: tuple(getattr(a, "shape", ()))
            )

    def _add_characteristic(self, m_t: str, local: str, label: str, value) -> None:
        c = self._iri(f"modelchar/{local}")
        self._add(c, self.RDF_TYPE, self._mls("ModelCharacteristic"))
        self._add(m_t, self._mls("hasQuality"), c)
        self._add(c, self.RDFS_LABEL, self._lit(label))
        self._add(c, self._mls("hasValue"), self._lit(value))

    def _add_linear(self, model, m_t, feature_names, class_names) -> None:
        import numpy as np

        coef = np.atleast_2d(np.asarray(model.coef_))

        def cname_for(ci: int) -> str:
            # binary sklearn classifiers carry ONE coef row: the decision
            # weights for classes_[1] (the positive class), not class 0
            if len(coef) == 1 and class_names and len(class_names) == 2:
                return class_names[1]
            if class_names and ci < len(class_names):
                return class_names[ci]
            return str(ci)

        for ci, row in enumerate(coef):
            cname = cname_for(ci)
            for fi, v in enumerate(row):
                fname = (
                    feature_names[fi]
                    if feature_names and fi < len(feature_names)
                    else f"f{fi}"
                )
                self._add_characteristic(
                    m_t,
                    f"coef/{ci}/{fi}",
                    f"Coefficient for class {cname}, feature {fname}",
                    float(v),
                )
        if hasattr(model, "intercept_"):
            import numpy as np

            for ci, v in enumerate(np.atleast_1d(model.intercept_)):
                self._add_characteristic(
                    m_t,
                    f"intercept/{ci}",
                    f"Intercept for class {cname_for(ci)}",
                    float(v),
                )

    def _add_tree(self, model, m_t, feature_names) -> None:
        for fi, v in enumerate(model.feature_importances_):
            fname = (
                feature_names[fi]
                if feature_names and fi < len(feature_names)
                else f"f{fi}"
            )
            self._add_characteristic(
                m_t,
                f"importance/{fi}",
                f"Feature importance for {fname}",
                float(v),
            )

    def _add_keras(self, model, m_t) -> None:
        for li, layer in enumerate(model.layers):
            self._add_characteristic(
                m_t,
                f"layer/{li}",
                f"Layer {li}: {type(layer).__name__}",
                str(getattr(layer, "output_shape", "")),
            )

    def _add_named_params(self, named, m_t, shape_of) -> None:
        for name, param in named:
            self._add_characteristic(
                m_t,
                f"param/{name}",
                f"Parameter {name}",
                str(shape_of(param)),
            )

    # --------------------------------------------------------------- output

    def serialize(self, format: str = "turtle") -> str:
        """The graph in the requested syntax — via the ENGINE's writers."""
        if format in ("turtle", "ttl"):
            return self.db.to_turtle()
        if format in ("ntriples", "nt"):
            return self.db.to_ntriples()
        if format in ("rdfxml", "xml", "rdf/xml"):
            return self.db.to_rdfxml()
        raise ValueError(f"unknown serialization format: {format!r}")

    def query(self, sparql: str):
        """Run SPARQL over the metadata graph (mlschema.py:370)."""
        from kolibrie_tpu_torch.query.executor import execute_query_volcano

        return execute_query_volcano(sparql, self.db)
