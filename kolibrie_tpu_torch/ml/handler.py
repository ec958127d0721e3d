"""MLHandler — external-model bridge with MLSchema metadata and timing.

Port of ``kolibrie_tpu/ml/handler.py`` (a copy, the imports rewritten).

Parity: ``ml/src/lib.rs`` — loads pickled ``*_predictor.pkl`` sklearn models
(:63-158), parses MLSchema TTL sidecars for performance metrics (via our own
Turtle parser instead of rdflib), compares models by resource score
(cpu 0.5 + mem 0.4 + time 0.1, :227-267), ``predict`` with timing
instrumentation (:269-350), two-pass ``discover_and_load_models`` (schemas
first, then only the best model, :353-412) — and the ``MLPredictTiming``
breakdown of ``kolibrie/src/execute_ml.rs:18-56`` (the Rust↔Python overhead
axis becomes host↔device transfer time here).
"""

from __future__ import annotations

import glob
import os
import pickle
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from kolibrie_tpu_torch.query.rdf_parsers import parse_turtle

MLS = "http://www.w3.org/ns/mls#"


@dataclass
class MLPredictTiming:
    """Timing breakdown (execute_ml.rs:18-56 parity)."""

    total_ms: float = 0.0
    data_prep_ms: float = 0.0
    pure_predict_ms: float = 0.0
    overhead_ms: float = 0.0  # host<->device / marshalling overhead


@dataclass
class MLPredictionResult:
    predictions: List[float]
    timing: MLPredictTiming
    model_name: str = ""


@dataclass
class ModelMetadata:
    name: str
    path: str
    cpu_usage: float = 0.0
    memory_usage: float = 0.0
    prediction_time: float = 0.0
    accuracy: float = 0.0

    def resource_score(self) -> float:
        """Lower is better (lib.rs:227-267 weights)."""
        return (
            0.5 * self.cpu_usage + 0.4 * self.memory_usage + 0.1 * self.prediction_time
        )


def parse_mlschema_ttl(path: str) -> Dict[str, float]:
    """Extract mls: evaluation metrics from an MLSchema TTL sidecar."""
    with open(path, "r", encoding="utf-8") as f:
        triples, _ = parse_turtle(f.read())
    metrics: Dict[str, float] = {}
    # mls:ModelEvaluation nodes: <eval> mls:specifiedBy <measure>; mls:hasValue v
    measures: Dict[str, str] = {}
    values: Dict[str, float] = {}
    for s, p, o in triples:
        if not isinstance(p, str):
            continue
        if p == MLS + "specifiedBy" and isinstance(o, str):
            measures[s] = o.rsplit("/", 1)[-1].rsplit("#", 1)[-1]
        elif p == MLS + "hasValue" and isinstance(o, str):
            lex = o.strip('"').split('"')[0] if o.startswith('"') else o
            try:
                values[s] = float(lex.split("^^")[0].strip('"'))
            except ValueError:
                pass
    for node, measure in measures.items():
        if node in values:
            metrics[measure.lower()] = values[node]
    return metrics


class MLHandler:
    """Loads and serves external predictive models."""

    def __init__(self) -> None:
        self.models: Dict[str, object] = {}
        self.metadata: Dict[str, ModelMetadata] = {}

    def discover_and_load_models(self, directory: str) -> List[str]:
        """Two-pass discovery: read ALL schema sidecars, then load only the
        model with the best resource score (lib.rs:353-412)."""
        candidates: List[ModelMetadata] = []
        for pkl in glob.glob(os.path.join(directory, "*_predictor.pkl")):
            name = os.path.basename(pkl)[: -len("_predictor.pkl")]
            meta = ModelMetadata(name=name, path=pkl)
            for ttl in (
                pkl.replace("_predictor.pkl", "_schema.ttl"),
                pkl.replace("_predictor.pkl", ".ttl"),
            ):
                if os.path.exists(ttl):
                    metrics = parse_mlschema_ttl(ttl)
                    meta.cpu_usage = metrics.get("cpuusage", metrics.get("cpu", 0.0))
                    meta.memory_usage = metrics.get(
                        "memoryusage", metrics.get("memory", 0.0)
                    )
                    meta.prediction_time = metrics.get(
                        "predictiontime", metrics.get("time", 0.0)
                    )
                    meta.accuracy = metrics.get("accuracy", 0.0)
                    break
            candidates.append(meta)
        if not candidates:
            return []
        best = min(candidates, key=lambda m: m.resource_score())
        self.load_model(best.name, best.path)
        for meta in candidates:
            self.metadata[meta.name] = meta
        return [best.name]

    def generate_ml_models(
        self, directory: str, timeout: float = 300.0
    ) -> List[str]:
        """Run the directory's predictor scripts so they (re)generate their
        pickled models and MLSchema TTL sidecars.

        Parity: ``ml/src/lib.rs:415-489`` (``generate_ml_models`` runs
        ``predictor.py`` through the embedded Python interpreter).  Here
        each ``*predictor*.py`` script runs as a subprocess with the
        directory as cwd, so artifacts land beside their generator.
        Returns the model names available afterwards (``*_predictor.pkl``
        stems); raises on a failing script.
        """
        import subprocess
        import sys

        scripts = sorted(glob.glob(os.path.join(directory, "*predictor*.py")))
        for script in scripts:
            proc = subprocess.run(
                [sys.executable, script],
                cwd=directory,
                capture_output=True,
                text=True,
                timeout=timeout,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"predictor script {script} failed "
                    f"(rc={proc.returncode}):\n{proc.stderr[-2000:]}"
                )
        return sorted(
            os.path.basename(p)[: -len("_predictor.pkl")]
            for p in glob.glob(os.path.join(directory, "*_predictor.pkl"))
        )

    def load_model(self, name: str, path: str) -> None:
        with open(path, "rb") as f:
            self.models[name] = pickle.load(f)
        self.metadata.setdefault(name, ModelMetadata(name=name, path=path))

    def compare_models(self) -> List[ModelMetadata]:
        return sorted(self.metadata.values(), key=lambda m: m.resource_score())

    def predict(self, model_name: str, features: List[List[float]]) -> MLPredictionResult:
        t0 = time.perf_counter()
        model = self.models.get(model_name)
        if model is None:
            raise KeyError(f"model {model_name!r} not loaded")
        X = np.asarray(features, dtype=np.float64)
        t1 = time.perf_counter()
        preds = model.predict(X)
        t2 = time.perf_counter()
        preds_list = [float(p) for p in np.asarray(preds).ravel()]
        t3 = time.perf_counter()
        timing = MLPredictTiming(
            total_ms=(t3 - t0) * 1000,
            data_prep_ms=(t1 - t0) * 1000,
            pure_predict_ms=(t2 - t1) * 1000,
            overhead_ms=(t3 - t2) * 1000,
        )
        return MLPredictionResult(preds_list, timing, model_name)
