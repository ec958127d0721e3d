"""The PyTorch port's database surface against the JAX package, on the CPU:
one-file checkpoints (written by either package, loaded by the other),
clone / union / ``par_join`` / ``map_id`` / ``register_udf`` /
``iter_decoded``, the N-Triples, Turtle and RDF/XML serializers (string-equal
to the reference's), ``load_file`` / ``parse_rdf`` / ``parse_rdf_from_file``,
the native bulk parsers of the repo's ``native/`` library (the same IDs as
the reference's, declining where it declines), and the store's
``snapshot`` / ``restore`` / ``save_npz`` / ``load_npz``.

The same seeded mutation sequences go through both packages (mirroring
``tests/test_checkpoint_fuzz.py`` and ``tests/test_rsp.py:491``).  Rules
are configuration, not data: neither package's checkpoint holds them, so a
RULE defined after the restore is compared instead.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

import kolibrie_tpu_torch as port
from kolibrie_tpu.native import nt_native as ref_nt
from kolibrie_tpu.native import ttl_native as ref_ttl
from kolibrie_tpu.query.executor import execute_query_volcano as ref_exec
from kolibrie_tpu.query.sparql_database import SparqlDatabase as RefDb
from kolibrie_tpu_torch.backend import resolve_device
from kolibrie_tpu_torch.core.store import ColumnarTripleStore
from kolibrie_tpu_torch.native import load as port_native
from kolibrie_tpu_torch.native import nt_native as port_nt
from kolibrie_tpu_torch.native import ttl_native as port_ttl
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

PortDb = port.SparqlDatabase
port_exec = port.execute_query_volcano

QUERIES = (
    "SELECT ?s ?p ?o WHERE { ?s ?p ?o }",
    "SELECT ?s ?o WHERE { ?s <http://f/p0> ?o }",
    'SELECT ?s WHERE { ?s <http://f/p1> "lit3" }',
    "SELECT ?a ?b WHERE { ?a <http://f/p0> ?x . ?x <http://f/p1> ?b }",
)


def _device_routed(db):
    """Both packages' stores here are far under the 100,000-triple floor
    below which "auto" takes the host engine: their queries run the
    device program (the port's device mirror) instead."""
    db.execution_mode = "device"
    return db


def _db(pkg):
    return _device_routed(RefDb() if pkg == "ref" else PortDb(device="cpu"))


def _load(pkg, path):
    return _device_routed(PortDb.from_checkpoint(path, device="cpu") if pkg == "port"
                          else RefDb.from_checkpoint(path))


def _exec(pkg):
    return ref_exec if pkg == "ref" else port_exec


def run_all(pkg, db):
    return [sorted(map(tuple, _exec(pkg)(q, db))) for q in QUERIES]


def _mutate(db, rng, live, n_ops):
    """``tests/test_checkpoint_fuzz.py::_mutate``: inserts of IRI, literal
    and quoted triples, deletes of present and absent triples, seeds."""
    for _ in range(n_ops):
        op = rng.random()
        if op < 0.55 or not live:
            kind = rng.random()
            s = f"<http://f/s{rng.randrange(12)}>"
            p = f"<http://f/p{rng.randrange(3)}>"
            if kind < 0.45:
                o = f"<http://f/s{rng.randrange(12)}>"
            elif kind < 0.8:
                o = f'"lit{rng.randrange(6)}"'
            else:
                o = None
            if o is not None:
                live.append(db.add_triple_parts(s, p, o))
            else:
                db.parse_ntriples(
                    f"<< {s} {p} <http://f/o{rng.randrange(4)}> >> "
                    f"<http://f/saidBy> <http://f/w{rng.randrange(3)}> ."
                )
        elif op < 0.85:
            db.delete_triple(live.pop(rng.randrange(len(live))))
        elif op < 0.95:
            db.store.remove(0xFFFFFF, 0xFFFFFE, 0xFFFFFD)
        else:
            t = rng.choice(live)
            db.probability_seeds[(t.subject, t.predicate, t.object)] = rng.random()


def _state(db):
    """Everything a checkpoint carries, decoded where IDs could differ."""
    dec = db.decode_term
    return {
        "triples": sorted(tuple(dec(x) for x in t) for t in db.store.triples_set()),
        "ids": sorted(db.store.triples_set()),
        "terms": list(db.dictionary.id_to_str),
        "quoted": sorted(db.quoted.items()),
        "seeds": sorted(db.probability_seeds.items()),
        "prefixes": sorted(db.prefixes.items()),
    }


def _mutated(pkg, seed, n_ops=60):
    db = _db(pkg)
    live: list = []
    _mutate(db, random.Random(seed), live, n_ops)
    return db, live


# ----------------------------------------------------------- checkpoints


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref"), ("port", "port")])
@pytest.mark.parametrize("seed", range(4))
def test_checkpoint_across_packages(tmp_path, seed, writer, reader):
    src, live = _mutated(writer, seed)
    twin, _ = _mutated(reader, seed)
    path = str(tmp_path / f"fuzz-{seed}.npz")
    src.checkpoint(path)
    loaded = _load(reader, path)
    assert _state(loaded) == _state(src) == _state(twin)
    assert run_all(reader, loaded) == run_all(writer, src)
    # the restored copy keeps interning and mutating exactly like the twin
    _mutate(loaded, random.Random(seed + 1000), list(live), 20)
    _mutate(twin, random.Random(seed + 1000), list(live), 20)
    assert _state(loaded) == _state(twin)
    assert run_all(reader, loaded) == run_all(reader, twin)


def test_checkpoint_roundtrip_mirrors_reference(tmp_path):
    """``tests/test_rsp.py:491``: turtle, a quoted triple, a seed; the
    restored database keeps interning; a RULE defined afterwards derives
    the same rows in both packages."""
    out = {}
    for pkg in ("ref", "port"):
        db = _db(pkg)
        db.parse_turtle(
            """@prefix ex: <http://example.org/> .
            ex:a ex:p ex:b ; ex:q 7 .
            ex:b ex:p ex:c ."""
        )
        db.parse_ntriples(
            "<< <http://example.org/a> <http://example.org/p> "
            '<http://example.org/b> >> <http://example.org/conf> "0.9" .'
        )
        db.probability_seeds[(1, 2, 3)] = 0.75
        path = str(tmp_path / f"{pkg}.npz")
        db.checkpoint(path)
        other = "port" if pkg == "ref" else "ref"
        db2 = _load(other, path)
        q = "PREFIX ex: <http://example.org/> SELECT ?x ?y WHERE { ?x ex:p ?y }"
        assert _exec(other)(q, db2) == _exec(pkg)(q, db)
        assert db2.parse_turtle("@prefix ex: <http://example.org/> . ex:new ex:p ex:a .") == 1
        _exec(other)(
            "PREFIX ex: <http://example.org/> RULE :R :- CONSTRUCT { ?x ex:p2 ?z . } "
            "WHERE { ?x ex:p ?y . ?y ex:p ?z . }", db2)
        out[other] = (sorted(map(tuple, _exec(other)(
            "PREFIX ex: <http://example.org/> SELECT ?x ?z WHERE { ?x ex:p2 ?z }", db2))),
            _state(db2))
    assert out["port"] == out["ref"]
    assert len(out["port"][0]) == 2


def test_empty_database_round_trips(tmp_path):
    for writer in ("ref", "port"):
        path = str(tmp_path / f"{writer}.npz")
        _db(writer).checkpoint(path)
        db2 = _load("port", path)
        assert len(db2.store) == 0 and run_all("port", db2) == [[]] * len(QUERIES)
        db2.add_triple_parts("<http://f/a>", "<http://f/p0>", "<http://f/b>")
        assert len(db2.store) == 1


# ------------------------------------------------- whole-database operations


def _pair(seed, n_ops=50):
    return {pkg: _mutated(pkg, seed, n_ops)[0] for pkg in ("ref", "port")}


@pytest.mark.parametrize("seed", range(3))
def test_clone_is_independent(seed):
    out = {}
    for pkg, db in _pair(seed).items():
        before = _state(db)
        c = db.clone()
        c.add_triple_parts("<http://f/new>", "<http://f/p0>", "<http://f/s1>")
        c.probability_seeds[(1, 1, 1)] = 0.5
        assert _state(db) == before
        out[pkg] = (_state(c), run_all(pkg, c))
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("seed", range(3))
def test_union_and_map_id(seed):
    out = {}
    for pkg in ("ref", "port"):
        a, _ = _mutated(pkg, seed, 40)
        b, _ = _mutated(pkg, seed + 50, 40)
        b.parse_turtle("@prefix g: <http://g/> . g:x g:y g:z .")
        a.udfs["MYFN"] = len
        u = a.union(b)
        assert "MYFN" in u.udfs
        out[pkg] = (_state(u), run_all(pkg, u))
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("seed", range(3))
def test_par_join(seed):
    out = {}
    for pkg in ("ref", "port"):
        a, _ = _mutated(pkg, seed, 50)
        b, _ = _mutated(pkg, seed + 7, 50)
        a.add_triple_parts("<http://f/s1>", "<http://f/p0>", "<http://f/s2>")
        b.add_triple_parts("<http://f/s2>", "<http://f/p0>", "<http://f/s3>")
        j = a.par_join(b, "<http://f/p0>")
        none = a.par_join(b, "<http://f/absent>")
        out[pkg] = (_state(j), len(none.store), len(a.dictionary.id_to_str))
    assert out["port"] == out["ref"]
    assert out["port"][0]["triples"]


def test_register_udf_and_iter_decoded():
    out = {}
    for pkg in ("ref", "port"):
        db = _db(pkg)
        db.parse_turtle('@prefix e: <http://e/> . e:a e:n "alpha" . e:b e:n "be" . e:c e:n "gamma" .')
        db.register_udf("shout", lambda s: (s or "").upper() + "!")
        rows = _exec(pkg)(
            "PREFIX e: <http://e/> SELECT ?x ?y WHERE { ?x e:n ?v . BIND(SHOUT(?v) AS ?y) }", db)
        out[pkg] = (sorted(map(tuple, rows)), sorted(db.iter_decoded()), sorted(db.udfs))
    assert out["port"] == out["ref"]
    assert ("http://e/a", "ALPHA!") in out["port"][0]


# ----------------------------------------------------------- serializers

SER_DOC = """@prefix ex: <http://example.org/> .
@prefix foaf: <http://xmlns.com/foaf/0.1/> .
ex:alice a foaf:Person ; foaf:name "Alice \\"A\\"" ; ex:age 30 ; ex:note "salut"@fr .
ex:bob foaf:knows ex:alice , ex:carol ; ex:score "3.5"^^<http://www.w3.org/2001/XMLSchema#decimal> .
_:b1 ex:linked ex:alice .
"""


def _ser_dbs(star: bool):
    out = {}
    for pkg in ("ref", "port"):
        db = _db(pkg)
        db.parse_turtle(SER_DOC)
        if star:
            db.parse_ntriples(
                "<< <http://example.org/alice> <http://example.org/age> \"30\" >> "
                '<http://example.org/certainty> "0.9" .')
        out[pkg] = db
    return out


@pytest.mark.parametrize("fmt", ["to_ntriples", "to_turtle", "to_rdfxml"])
@pytest.mark.parametrize("star", [False, True])
def test_serializers_string_equal(fmt, star):
    dbs = _ser_dbs(star)
    want = getattr(dbs["ref"], fmt)()
    got = getattr(dbs["port"], fmt)()
    assert got == want and got


@pytest.mark.parametrize("fmt,parse", [("to_ntriples", "parse_ntriples"), ("to_turtle", "parse_turtle"),
                                       ("to_rdfxml", "parse_rdf")])
def test_serializers_round_trip(fmt, parse):
    src = _ser_dbs(False)["port"]
    text = getattr(src, fmt)()
    back = PortDb(device="cpu")
    getattr(back, parse)(text)
    ref_back = RefDb()
    getattr(ref_back, parse)(text)
    dec = lambda db: sorted(db.iter_decoded())  # noqa: E731
    assert dec(back) == dec(ref_back)
    if fmt != "to_turtle":
        assert _state(back) == _state(ref_back)


# ----------------------------------------------------------- file loading

NT_DOC = """
# a comment line
<http://e/a> <http://e/p> <http://e/b> .
<http://e/a> <http://e/name> "Alice \\"quoted\\" \\u00e9" .
_:b1 <http://e/p> "30"^^<http://www.w3.org/2001/XMLSchema#integer> .
<http://e/a> <http://e/label> "bonjour"@fr .
<http://e/a> <http://e/p> <http://e/b> .
"""

TTL_DOC = """@prefix ex: <http://example.org/> .
@prefix foaf: <http://xmlns.com/foaf/0.1/> .
PREFIX ds: <https://data.example/ontology#>
# comment line
ex:alice a foaf:Person ;
    foaf:knows ex:bob, ex:carol ;
    ds:salary 42000 ;
    ds:score 3.5 ;
    ds:big 1.5e3 ;
    ds:active true .
ex:bob foaf:name "Bob \\"quoted\\""@en .
ex:carol ds:note "w"^^<http://www.w3.org/2001/XMLSchema#string> ;
    ds:typed "7"^^ds:custom .
_:b1 ex:linked ex:alice .
"""

RX_DOC = """<?xml version="1.0"?>
<rdf:RDF xmlns:rdf="http://www.w3.org/1999/02/22-rdf-syntax-ns#" xmlns:ex="http://e/">
<ex:Person rdf:about="http://e/a" ex:nick="al">
  <ex:knows rdf:resource="http://e/b"/>
  <ex:age rdf:datatype="http://www.w3.org/2001/XMLSchema#int">30</ex:age>
  <ex:note xml:lang="fr">salut &amp; bye</ex:note>
  <ex:friend rdf:nodeID="bn1"/>
  <ex:empty></ex:empty>
</ex:Person>
<rdf:Description rdf:nodeID="bn1"><ex:age>7</ex:age></rdf:Description>
<rdf:Description rdf:ID="frag"><ex:p>v</ex:p></rdf:Description>
</rdf:RDF>"""

FILES = {"data.nt": NT_DOC, "data.ttl": TTL_DOC, "data.rdf": RX_DOC, "data.owl": RX_DOC,
         "data.n3": TTL_DOC}


@pytest.mark.parametrize("name", sorted(FILES))
def test_load_file_matches_reference(tmp_path, name):
    path = tmp_path / name
    path.write_text(FILES[name], encoding="utf-8")
    out = {}
    for pkg in ("ref", "port"):
        db = _db(pkg)
        n = db.load_file(str(path))
        out[pkg] = (n, _state(db))
    assert out["port"] == out["ref"] and out["port"][0] > 0


def test_parse_rdf_and_from_file(tmp_path):
    path = tmp_path / "x.xml"
    path.write_text(RX_DOC, encoding="utf-8")
    out = {}
    for pkg in ("ref", "port"):
        a, b = _db(pkg), _db(pkg)
        out[pkg] = (a.parse_rdf(RX_DOC), b.parse_rdf_from_file(str(path)), _state(a), _state(b))
    assert out["port"] == out["ref"]


def test_r2r_load_triples_parses_rdfxml():
    from kolibrie_tpu.rsp.r2r import SimpleR2R as RefR2R
    from kolibrie_tpu_torch.rsp.r2r import SimpleR2R

    ref, prt = RefR2R(), SimpleR2R(device="cpu")
    assert prt.load_triples(RX_DOC, "rdfxml") == ref.load_triples(RX_DOC, "rdfxml") > 0
    assert _state(prt.db) == _state(ref.db)


# ------------------------------------------------------- native bulk parsers


def test_native_library_builds():
    assert port_native() is not None


@pytest.mark.parametrize("doc", ["nt", "nt_mt", "ttl", "ttl_mt", "rx", "rx_mt"])
def test_native_bulk_parsers_match_reference(doc):
    """The port's native parse returns the reference's ids and term list;
    a database loaded through it holds the reference database's IDs."""
    big_nt = NT_DOC + "".join(f"<http://e/n{i}> <http://e/p> \"{i}\" .\n" for i in range(3000))
    big_ttl = TTL_DOC + "\n".join(f"ex:n{i} ds:salary {1000 + i} ." for i in range(997))
    big_rx = RX_DOC.replace("</rdf:RDF>", "".join(
        f'<rdf:Description rdf:about="http://e/n{i}"><ex:v>{i}</ex:v></rdf:Description>\n'
        for i in range(400)) + "</rdf:RDF>")
    kind, mt = doc.split("_")[0], doc.endswith("_mt")
    nthreads = 4 if mt else 1
    if kind == "nt":
        text = big_nt if mt else NT_DOC
        got, want = port_nt.bulk_parse_ntriples(text, nthreads), ref_nt.bulk_parse_ntriples(text, nthreads)
        method = "parse_ntriples"
    elif kind == "ttl":
        text = big_ttl if mt else TTL_DOC
        got, want = port_ttl.bulk_parse_turtle(text, {}, nthreads), ref_ttl.bulk_parse_turtle(text, {}, nthreads)
        method = "parse_turtle"
    else:
        text = big_rx if mt else RX_DOC
        got, want = port_nt.bulk_parse_rdf_xml(text, nthreads), ref_nt.bulk_parse_rdf_xml(text, nthreads)
        method = "parse_rdf"
    assert got is not None and want is not None
    np.testing.assert_array_equal(got[0], want[0])
    assert list(got[1:]) == list(want[1:])
    dbs = {pkg: _db(pkg) for pkg in ("ref", "port")}
    for db in dbs.values():
        getattr(db, method)(text)
    assert _state(dbs["port"]) == _state(dbs["ref"])


DECLINED = {
    "nt": [
        "<< <http://a> <http://p> <http://o> >> <http://q> <http://r> .",
        "@prefix ex: <http://e/> . ex:a ex:p ex:b .",
        "<http://a> <http://p> <http://o>",
    ],
    "ttl": [
        "@prefix ex: <http://e/> .\nex:a ex:p [ ex:q ex:r ] .",
        "@prefix ex: <http://e/> .\nex:a ex:p ( 1 2 ) .",
        '@prefix ex: <http://e/> .\nex:a ex:p """multi\nline""" .',
        "@prefix ex: <http://e/> .\nex:a ex:p 'single' .",
        "@base <http://b/> .",
        "@prefix ex: <http://e/> .\n<< ex:a ex:p ex:o >> ex:q ex:r .",
        "nope:a nope:b nope:c .",
        "@prefix ex: <http://e/> .\nex:a ex:p ex:c.",
    ],
    "rx": [
        '<rdf:RDF xmlns:rdf="http://www.w3.org/1999/02/22-rdf-syntax-ns#" xmlns:e="http://e/">'
        '<rdf:Description rdf:about="http://e/a"><e:p><rdf:Description rdf:about="http://e/b"/></e:p>'
        "</rdf:Description></rdf:RDF>",
        '<r xmlns="http://d/"/>',
        '<!DOCTYPE x><rdf:RDF xmlns:rdf="http://www.w3.org/1999/02/22-rdf-syntax-ns#"/>',
        '<rdf:RDF xmlns:rdf="http://www.w3.org/1999/02/22-rdf-syntax-ns#" xmlns:e="http://e/">'
        "<rdf:Description><e:p>v</e:p></rdf:Description></rdf:RDF>",
    ],
}


@pytest.mark.parametrize("case", [f"{k}:{i}" for k, v in sorted(DECLINED.items()) for i in range(len(v))])
def test_native_declines_where_reference_declines(case):
    kind, i = case.split(":")
    text = DECLINED[kind][int(i)]
    if kind == "nt":
        got, want = port_nt.bulk_parse_ntriples(text), ref_nt.bulk_parse_ntriples(text)
    elif kind == "ttl":
        got, want = port_ttl.bulk_parse_turtle(text, {}), ref_ttl.bulk_parse_turtle(text, {})
    else:
        got, want = port_nt.bulk_parse_rdf_xml(text), ref_nt.bulk_parse_rdf_xml(text)
    assert got is None and want is None


def test_parse_takes_the_native_route(monkeypatch):
    calls = []
    real = PortDb._ingest_native_session

    def spy(self, ids, terms):
        calls.append(len(ids))
        return real(self, ids, terms)

    monkeypatch.setattr(PortDb, "_ingest_native_session", spy)
    db = PortDb(device="cpu")
    db.parse_ntriples(NT_DOC)
    db.parse_turtle(TTL_DOC)
    db.parse_rdf(RX_DOC)
    assert calls == [5, 11, 9]  # rows as parsed, duplicates included


# ------------------------------------------------------------------ store


def test_store_without_a_device_needs_a_card():
    if torch_cuda_available():
        pytest.skip("a CUDA card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ColumnarTripleStore()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert ColumnarTripleStore("cpu").device.type == "cpu"


def torch_cuda_available() -> bool:
    import torch

    return torch.cuda.is_available()


def test_store_npz_round_trip_across_packages(tmp_path):
    from kolibrie_tpu.core.store import ColumnarTripleStore as RefStore

    db, _ = _mutated("port", 3)
    p1, p2 = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    db.store.save_npz(p1)
    ref_loaded = RefStore.load_npz(p1)
    ref_loaded.save_npz(p2)
    st = ColumnarTripleStore.load_npz(p2, device="cpu")
    assert st.device.type == "cpu"
    assert st.triples_set() == ref_loaded.triples_set() == db.store.triples_set()
    for c1, c2 in zip(st.columns(), ref_loaded.columns()):
        np.testing.assert_array_equal(c1, c2)


def test_restore_never_answers_from_a_later_mirror():
    """Snapshot, mutate, query (which uploads the mutated state's mirror),
    restore: the next query answers from the restored state, as the JAX
    package's does, never from the mirror of the state before the
    restore."""
    q = "SELECT ?s ?o WHERE { ?s <http://f/p0> ?o }"
    out = {}
    for pkg in ("ref", "port"):
        db, _ = _mutated(pkg, 5, 40)
        first = sorted(map(tuple, _exec(pkg)(q, db)))
        snap = db.store.snapshot()
        for i in range(3000):  # past the delta threshold: a new base
            db.add_triple_parts(f"<http://f/x{i}>", "<http://f/p0>", f"<http://f/y{i}>")
        db.delete_triple(next(t for t in db.store if t.predicate == db.dictionary.lookup("http://f/p0")))
        mutated = sorted(map(tuple, _exec(pkg)(q, db)))
        db.store.restore(snap)
        again = sorted(map(tuple, _exec(pkg)(q, db)))
        db.add_triple_parts("<http://f/z>", "<http://f/p0>", "<http://f/s1>")
        after = sorted(map(tuple, _exec(pkg)(q, db)))
        db.store.restore(snap)
        twice = sorted(map(tuple, _exec(pkg)(q, db)))
        assert again == first == twice != mutated
        out[pkg] = (first, mutated, again, after)
    assert out["port"] == out["ref"]


def test_restore_small_delta_mirror():
    """The same through the delta tier alone (no new base)."""
    q = "SELECT ?s ?o WHERE { ?s <http://f/p1> ?o }"
    db, live = _mutated("port", 6, 40)
    first = sorted(map(tuple, port_exec(q, db)))
    snap = db.store.snapshot()
    db.add_triple_parts("<http://f/q>", "<http://f/p1>", "<http://f/r>")
    for t in live[:5]:
        db.delete_triple(t)
    assert sorted(map(tuple, port_exec(q, db))) != first
    db.store.restore(snap)
    assert sorted(map(tuple, port_exec(q, db))) == first


# ---------------------------------------------- chip_smoke phase 11 rehearsal


def test_chip_smoke_phase11_rehearsal():
    """Phase 11 through the smoke's own function and gates at LUBM-2 and
    600 employees: the native load of the written N-Triples, Q2 / Q9
    against the first database's rows, the checkpoint, clone, union,
    serializers and the QueryBuilder twin (the launch gate runs on the
    card only)."""
    import chip_smoke as CS
    from benches.lubm import LUBM_Q2, LUBM_Q9, generate_fast

    lubm = PortDb(device="cpu")
    lubm.store.add_batch(*generate_fast(2, lubm.dictionary))
    emp = PortDb(device="cpu")
    emp.parse_ntriples(CS.employee_ntriples(600))
    rows = {"q2": port_exec(LUBM_Q2, lubm), "q9": port_exec(LUBM_Q9, lubm),
            "employee": port_exec(CS.EMPLOYEE_QUERY, emp)}
    assert all(rows.values())
    out = CS.run_load_phase(resolve_device("cpu"), {"rows": rows, "report": {"queries": {}}}, lubm, emp)
    assert out["nt_bytes"] > 0 and out["checkpoint_bytes"] > 0
    assert {"load_file", "checkpoint", "from_checkpoint", "to_turtle", "to_rdfxml"} <= set(out["ms"])
