"""The port's query templates against the JAX package's.

``template_key`` and ``fingerprint_query`` must give the reference's
skeleton, fingerprint and parameter tuple for the same parsed query —
string for string, over a corpus with constants, FILTERs, VALUES, UNION /
OPTIONAL / MINUS / NOT, sub-SELECTs, aggregates, ORDER BY … LIMIT and
RDF-star terms, under ``KOLIBRIE_WCOJ`` auto / off / force and the
interpreter, MQO and stats-advisor modes.  ``CapAdvisor`` must give the
reference's advice, retries and stats for the same observations, and
``occupancy_pct`` / ``_k_bucket`` the same numbers.  All exact.
"""

from __future__ import annotations

import pytest

from kolibrie_tpu.query import template as ref_template
from kolibrie_tpu.query.parser import parse_combined_query as ref_parse
from kolibrie_tpu_torch.query import template as port_template
from kolibrie_tpu_torch.query.parser import parse_combined_query as port_parse
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

PREFIXES = {"ex": "http://example.org/", "foaf": "http://xmlns.com/foaf/0.1/"}
P = "PREFIX ex: <http://example.org/>\nPREFIX foaf: <http://xmlns.com/foaf/0.1/>\n"

CORPUS = [
    'SELECT ?e ?s WHERE { ?e ex:dept "dept0" . ?e ex:salary ?s . FILTER(?s > 25) }',
    'SELECT ?e ?s WHERE { ?e ex:dept "dept3" . ?e ex:salary ?s . FILTER(?s > 40) }',
    'SELECT ?e ?salary WHERE { ?e ex:dept "dept0" . ?e ex:salary ?salary . FILTER(?salary > 25) }',
    'SELECT ?e WHERE { ?e ex:dept ?d . FILTER(?d = "42") }',
    'SELECT ?e WHERE { ?e ex:dept ?d . FILTER(?d = "dept1") }',
    "SELECT ?e WHERE { ?e ex:dept ?d . FILTER(?d != ex:none && ?d != ex:other) }",
    "SELECT ?e ?s WHERE { ?e ex:salary ?s . FILTER(?s >= 30000 || ?s < 100) }",
    "SELECT ?e ?s WHERE { ?e ex:salary ?s . FILTER(!(?s = 50000)) }",
    'SELECT ?e ?d WHERE { ?e ex:dept ?d . FILTER(CONTAINS(?d, "1")) }',
    'SELECT ?e ?d WHERE { ?e ex:dept ?d . FILTER(REGEX(?d, "^dept[12]$")) }',
    "SELECT ?e WHERE { ?e ex:dept ?d . FILTER(BOUND(?d)) }",
    'SELECT ?e ?d WHERE { ?e ex:dept ?d . VALUES ?d { "dept1" "dept3" } }',
    'SELECT ?e ?d WHERE { ?e ex:dept ?d . VALUES ?d { "dept2" UNDEF } }',
    'SELECT ?e ?d ?w WHERE { ?e ex:dept ?d . ?e foaf:workplaceHomepage ?w . '
    'VALUES (?d ?w) { ("dept1" <http://company2.example/>) ("dept4" UNDEF) } }',
    'SELECT ?e ?x WHERE { ?e ex:salary ?x { ?e ex:dept "dept0" } UNION { ?e ex:dept "dept1" } }',
    "SELECT ?e ?s ?y WHERE { ?e ex:salary ?s . OPTIONAL { ?e ex:knows ?y } }",
    'SELECT ?e ?s WHERE { ?e ex:salary ?s MINUS { ?e ex:dept "dept0" } }',
    "SELECT ?e ?s WHERE { ?e ex:salary ?s . NOT { ?e ex:knows ?y } }",
    "SELECT ?e ?s WHERE { ?e ex:salary ?s . "
    '{ SELECT ?e WHERE { ?e ex:dept "dept2" } } }',
    "SELECT ?d (COUNT(?e) AS ?n) WHERE { ?e ex:dept ?d } GROUP BY ?d",
    "SELECT ?d (AVG(?s) AS ?a) (MAX(?s) AS ?m) WHERE { ?e ex:dept ?d . ?e ex:salary ?s } GROUP BY ?d",
    "SELECT ?e ?s WHERE { ?e ex:salary ?s } ORDER BY DESC(?s) LIMIT 10",
    "SELECT ?e ?s WHERE { ?e ex:salary ?s } ORDER BY DESC(?s) LIMIT 12",
    "SELECT ?e ?s WHERE { ?e ex:salary ?s } ORDER BY DESC(?s) LIMIT 10 OFFSET 20",
    "SELECT ?e ?s WHERE { ?e ex:salary ?s } LIMIT 5",
    "SELECT DISTINCT ?d WHERE { ?e ex:dept ?d }",
    "SELECT * WHERE { ?a ex:knows ?b . ?b ex:knows ?c . ?c ex:knows ?a }",
    "SELECT ?a ?c WHERE { ?a ex:knows ?b . ?b ex:knows ?c . ?a ex:knows ?c . ?a ex:type ex:T1 }",
    "SELECT ?s ?v ?c WHERE { << ?s ex:age ?v >> ex:certainty ?c }",
    "SELECT ?p ?c WHERE { << ex:alice ?p 30 >> ex:certainty ?c }",
    "SELECT ?e (?s * 2 AS ?d) WHERE { ?e ex:salary ?s }",
    "SELECT ?e ?z WHERE { ?e ex:salary ?s . BIND(?s + 1 AS ?z) }",
    'INSERT DATA { ex:a ex:dept "dept9" }',
]


def both(text: str):
    r = ref_template.template_key(ref_parse(P + text, PREFIXES))
    t = port_template.template_key(port_parse(P + text, PREFIXES))
    rf = ref_template.fingerprint_query(ref_parse(P + text, PREFIXES))
    tf = port_template.fingerprint_query(port_parse(P + text, PREFIXES))
    return r, t, rf, tf


@pytest.mark.parametrize("mode", ["auto", "off", "force"])
def test_fingerprints_match_reference(monkeypatch, mode):
    assert len(CORPUS) >= 30
    monkeypatch.setenv("KOLIBRIE_WCOJ", mode)
    fps = []
    for text in CORPUS:
        r, t, rf, tf = both(text)
        assert repr(t[0]) == repr(r[0]), text
        assert t[1] == r[1], text
        assert tf == rf, text
        fps.append(tf[0])
    # constant variants share a template; a renamed variable does not
    assert fps[0] == fps[1] != fps[2]
    # a numeric-looking string literal is structural
    assert fps[3] != fps[4]
    # the top-k bucket is structural, the LIMIT itself a parameter
    assert fps[21] == fps[22] != fps[23]


@pytest.mark.parametrize(
    "env", [("KOLIBRIE_PLAN_INTERP", "force"), ("KOLIBRIE_MQO", "force"),
            ("KOLIBRIE_STATS_ADVISOR", "auto")]
)
def test_routing_modes_enter_the_fingerprint(monkeypatch, env):
    text = CORPUS[0]
    _r, _t, before, port_before = both(text)
    monkeypatch.setenv(*env)
    _r, _t, after, port_after = both(text)
    assert port_before == before and port_after == after
    assert after[0] != before[0]


def test_fingerprints_across_wcoj_modes_differ(monkeypatch):
    out = []
    for mode in ("auto", "off", "force"):
        monkeypatch.setenv("KOLIBRIE_WCOJ", mode)
        out.append(port_template.fingerprint_query(port_parse(P + CORPUS[26], PREFIXES))[0])
    assert len(set(out)) == 3


def test_occupancy_and_k_bucket_match_reference():
    for rows, cap in ((0, 0), (5, 8), (8, 8), (300, 1024), (7, -1)):
        assert port_template.occupancy_pct(rows, cap) == ref_template.occupancy_pct(rows, cap)
    for n in (0, 1, 8, 9, 100, 1000, 4097):
        assert port_template._k_bucket(n) == ref_template._k_bucket(n)


def test_cap_advisor_matches_reference(monkeypatch):
    steps = [
        ("observe", "device", "fp1", (8, 16), 3),
        ("retry", "device", "fp1", 1),
        ("observe", "device", "fp1", (32, 4), 3),
        ("observe", "device", "fp2", (64,), None),
        ("retry", "sharded", "fp2", 2),
        ("observe", "device", "fp2", (8, 8), 5),  # a new length replaces
    ]
    advisors = (ref_template.CapAdvisor(), port_template.CapAdvisor())
    for adv in advisors:
        for step in steps:
            if step[0] == "observe":
                adv.observe(step[1], step[2], step[3], base_version=step[4])
            else:
                adv.observe_retry(step[1], step[2], step[3])
    ref, ours = advisors
    for fp in ("fp1", "fp2", "fp3"):
        assert ours.advise("device", fp) == ref.advise("device", fp)
    assert ours.advise("device", "fp1") == (32, 16)
    for eng in (None, "device", "sharded"):
        assert ours.retries(eng) == ref.retries(eng)
    assert ours.stats() == ref.stats()
    monkeypatch.setenv("KOLIBRIE_CAP_ADVISOR", "off")
    assert ours.advise("device", "fp1") is None is ref.advise("device", "fp1")
    assert port_template.cap_advisor_enabled() == ref_template.cap_advisor_enabled() is False
    ours.reset()
    assert ours.stats()["templates"] == {}
