"""The PyTorch port's ``QueryBuilder``, ``QueryEngine`` facade, RDF parsers
and serializers, and ``format_parse_error`` against the JAX package, on the
CPU.

Every case of ``tests/test_query_builder.py`` and ``tests/test_rdf_parsers.py``
is replayed on the port: the reference file's source runs with its imports
pointed at ``kolibrie_tpu_torch`` and its databases built with
``device="cpu"``, so each reference assertion holds the port to the same
answer.  The one case left out, ``test_explain_device_plan_tree``, needs
``QueryEngine.explain_device``, which raises on the port until ROADMAP A7;
``test_explain_device_raises_until_a7`` pins that.  Beside the replay, the
builder's answers, the facade's explanations and the parse-error rendering
are compared with the JAX package's one for one.
"""

from __future__ import annotations

import inspect
import types
from pathlib import Path

import pytest

import kolibrie_tpu_torch as port
from kolibrie_tpu.query import error_handler as ref_eh
from kolibrie_tpu.query import parser as ref_parser
from kolibrie_tpu.query.engine import QueryEngine as RefEngine
from kolibrie_tpu.query.sparql_database import SparqlDatabase as RefDb
from kolibrie_tpu_torch.query import error_handler as port_eh
from kolibrie_tpu_torch.query import parser as port_parser
from test_torch_clauses import port_device_program  # noqa: F401  (a fixture)
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

TESTS = Path(__file__).resolve().parent
SKIPPED = {"test_explain_device_plan_tree"}


def _replay_module(name: str) -> types.ModuleType:
    """The reference test file ``name`` with the port in place of the JAX
    package and every database on the CPU."""
    src = (TESTS / name).read_text()
    src = src.replace("kolibrie_tpu.", "kolibrie_tpu_torch.")
    src = src.replace("SparqlDatabase()", 'SparqlDatabase(device="cpu")')
    src = src.replace("QueryEngine()", 'QueryEngine(device="cpu")')
    mod = types.ModuleType(f"port_replay_{name[:-3]}")
    mod.__file__ = str(TESTS / name)
    exec(compile(src, f"<port replay of {name}>", "exec"), mod.__dict__)
    return mod


def _cases(mod: types.ModuleType):
    """``(id, callable)`` for every test function and test method."""
    out = []
    for key, obj in vars(mod).items():
        if key.startswith("test_") and callable(obj) and key not in SKIPPED:
            out.append((key, obj))
        elif key.startswith("Test") and isinstance(obj, type):
            for meth in sorted(k for k in vars(obj) if k.startswith("test_")):
                out.append((f"{key}.{meth}", getattr(obj(), meth)))
    return out


_MODULES = {n: _replay_module(n) for n in ("test_query_builder.py", "test_rdf_parsers.py")}
_CASES = {f"{n}::{cid}": fn for n, mod in _MODULES.items() for cid, fn in _cases(mod)}


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.usefixtures("port_device_program")
def test_reference_case_on_the_port(case, tmp_path):
    fn = _CASES[case]
    if "tmp_path" in inspect.signature(fn).parameters:
        fn(tmp_path=tmp_path)
    else:
        fn()


def test_replay_covers_the_reference_files():
    """Every reference case but the EXPLAIN one is replayed."""
    assert len(_CASES) == 23 + 29


def test_explain_device_raises_until_a7():
    """A7 has landed: ``explain_device`` no longer raises; it renders the
    JAX package's plan text (tests/test_torch_explain.py holds it against
    the reference over a corpus)."""
    ttl = "@prefix ex: <http://example.org/> . ex:a ex:knows ex:b ."
    q = "SELECT ?a WHERE { ?a <http://example.org/knows> ?b }"
    e = port.QueryEngine(device="cpu")
    e.load_turtle_to_memory(ttl)
    ref = RefEngine()
    ref.load_turtle_to_memory(ttl)
    ref.db.execution_mode = "device"
    text = e.explain_device(q)
    assert text == ref.explain_device(q)
    assert text.startswith("scan[pos]") and "project -> ?a" in text


# ------------------------------------------------------------ builder parity

EX = "http://example.org/"
DATA = f"""@prefix ex: <{EX}> .
ex:alice ex:knows ex:bob ; ex:name "Alice" ; ex:age 30 .
ex:bob ex:knows ex:carol ; ex:name "Bob" ; ex:age 41 .
ex:carol ex:knows ex:alice ; ex:name "Carol" .
ex:dave ex:name "Dave"@en .
"""

BUILDER_CASES = {
    "subject": lambda q: q.with_subject(f"{EX}alice").get_decoded_triples(),
    "predicate_object": lambda q: q.with_predicate(f"{EX}knows").with_object(f"{EX}carol").get_decoded_triples(),
    "like": lambda q: q.with_subject_like("ar").get_decoded_triples(),
    "starting_ending": lambda q: q.with_predicate_starting(f"{EX}n").with_object_ending('e"').get_decoded_triples(),
    "distinct_subjects": lambda q: q.with_predicate(f"{EX}knows").distinct().get_subjects(),
    "order_limit_offset": lambda q: [
        t for t in q.with_predicate(f"{EX}name").order_by(lambda t: t.object).desc().offset(1).limit(2).get_triples()
    ],
    "count": lambda q: q.with_predicate(f"{EX}age").count(),
    "filter": lambda q: q.filter(lambda t: t.subject == t.object or t.predicate > 0).count(),
    "objects": lambda q: sorted(q.with_subject(f"{EX}bob").get_objects()),
}


def _builder_dbs():
    ref, prt = RefDb(), port.SparqlDatabase(device="cpu")
    ref.parse_turtle(DATA)
    prt.parse_turtle(DATA)
    return ref, prt


@pytest.mark.parametrize("case", sorted(BUILDER_CASES))
def test_builder_matches_reference(case):
    ref, prt = _builder_dbs()
    got = BUILDER_CASES[case](prt.query())
    want = BUILDER_CASES[case](ref.query())
    if isinstance(got, list) and got and hasattr(got[0], "subject"):
        got = [tuple(t) for t in got]
        want = [tuple(t) for t in want]
    assert got == want


def test_builder_join_matches_reference():
    ref, prt = _builder_dbs()
    out = {}
    for name, db, mk in (("ref", ref, RefDb), ("port", prt, lambda: port.SparqlDatabase(device="cpu"))):
        other = mk()
        other.add_triple_parts(f"{EX}alice", f"{EX}likes", f"{EX}tea")
        other.add_triple_parts(f"{EX}bob", f"{EX}likes", f"{EX}coffee")
        out[name] = db.query().with_predicate(f"{EX}knows").join(other).join_on_subject().get_decoded_triples()
    assert out["port"] == out["ref"] and out["port"]


@pytest.mark.parametrize("op", ["ISTREAM", "RSTREAM", "DSTREAM"])
def test_builder_stream_matches_reference(op):
    from kolibrie_tpu.rsp.r2s import StreamOperator as RefOp
    from kolibrie_tpu.rsp.s2r import ReportStrategy as RefReport
    from kolibrie_tpu_torch.rsp.r2s import StreamOperator as PortOp
    from kolibrie_tpu_torch.rsp.s2r import ReportStrategy as PortReport

    out = {}
    for name, db, ops, rep in (("ref", RefDb(), RefOp, RefReport),
                               ("port", port.SparqlDatabase(device="cpu"), PortOp, PortReport)):
        q = (db.query().with_predicate("p").window(10, 2)
             .with_report_strategy(rep.ON_WINDOW_CLOSE)
             .with_stream_operator(getattr(ops, op)).as_stream())
        for ts in range(25):
            q.add_stream_triple(f"s{ts % 7}", "p", f"o{ts % 5}", ts)
            q.add_stream_triple(f"s{ts}", "q", f"o{ts}", ts)
        out[name] = [sorted(tuple(db.decode_term(x) for x in t) for t in b)
                     for b in q.get_stream_results()]
    assert out["port"] == out["ref"] and any(out["port"])


QUERIES_FOR_EXPLAIN = [
    "SELECT ?x WHERE { ?x <http://e/p> ?y }",
    "REGISTER RSTREAM <http://o> AS SELECT ?x FROM NAMED WINDOW <http://w> ON <http://s> "
    "[RANGE 10 STEP 2] WHERE { WINDOW <http://w> { ?x <http://e/p> ?y } }",
    "SELECT ?x WHERE { ?x <http://e/p> ?y } # RANGE in a comment",
    "SELECT ?x FROM NAMED WINDOW <http://w> ON <http://s> [RANGE 5 STEP 1] WHERE { ?x ?p ?o }",
]


@pytest.mark.parametrize("i", range(len(QUERIES_FOR_EXPLAIN)))
def test_query_engine_matches_reference(i):
    q = QUERIES_FOR_EXPLAIN[i]
    ref, prt = RefEngine(), port.QueryEngine(device="cpu")
    for e in (ref, prt):
        e.db.execution_mode = "device"  # both: the graph is under the host-routed floor
        e.load_turtle_to_memory(DATA)
        e.add_triple(f"<{EX}erin>", f"<{EX}knows>", f"<{EX}alice>")
    assert vars(prt.explain(q)) == vars(ref.explain(q))
    assert vars(prt.stats()) == vars(ref.stats())
    sel = f"PREFIX ex: <{EX}> SELECT ?a ?b WHERE {{ ?a ex:knows ?b . ?b ex:age ?g }}"
    assert sorted(prt.query(sel)) == sorted(ref.query(sel))


# ------------------------------------------------------------ parse errors

BAD_QUERIES = [
    "SELECT ?x WHERE { ?x ?p ?o",
    'SELECT ?x WHERE { ?x ?p "open . }',
    "SELECT ?x WHERE {\n  ?x <http://e/p> ?o .\n  FILTER(?o > ) }",
    "SELEC ?x WHERE { ?x ?p ?o }",
    "PREFIX ex <http://e/> SELECT ?x WHERE { ?x ex:p ?o }",
    "SELECT ?x WHERE { ?x <http://e/p ?o }",
]


@pytest.mark.parametrize("i", range(len(BAD_QUERIES)))
def test_format_parse_error_matches_reference(i):
    src = BAD_QUERIES[i]
    with pytest.raises(ref_parser.SparqlParseError) as ref_err:
        ref_parser.parse_sparql_query(src)
    with pytest.raises(port_parser.SparqlParseError) as port_err:
        port_parser.parse_sparql_query(src)
    want = ref_eh.format_parse_error(src, ref_err.value)
    assert port_eh.format_parse_error(src, port_err.value) == want
    assert "error:" in want


HINT_TEXTS = BAD_QUERIES + [
    "SELECT ?x",
    "SELECT ?x WHERE { ?x unknownpfx:name ?o . }",
    "SELECT ?x WHERE { ?x ?p ?o ?y ?q ?z }",
    "SELECT ?x WHERE { ?x rdf:type ?o }",
]


@pytest.mark.parametrize("i", range(len(HINT_TEXTS)))
def test_error_hints_match_reference(i):
    src = HINT_TEXTS[i]
    for at in sorted({0, len(src) // 2, len(src)}):
        assert port_eh.detect_specific_sparql_error(src, at) == ref_eh.detect_specific_sparql_error(src, at)
    err = (ref_parser.SparqlParseError("unexpected end of input", line=1, col=len(src)),
           port_parser.SparqlParseError("unexpected end of input", line=1, col=len(src)))
    assert port_eh.format_parse_error(src, err[1]) == ref_eh.format_parse_error(src, err[0])
