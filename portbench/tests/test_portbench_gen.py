"""The UBA-shaped generator: deterministic for a seed, the same sizes for
every seed, and each department's counts inside UBA's ranges."""

from collections import Counter

import numpy as np
import pytest

from conftest import tiny_cell
from portbench import lubm_gen

UB = lubm_gen.UB


def _graph(universities, seed):
    return lubm_gen.generate(tiny_cell("lubm100.analytic", universities)["config"], seed)


def test_deterministic_for_a_seed():
    a, b = _graph(2, 2**31 + 5), _graph(2, 2**31 + 5)
    assert a.terms == b.terms
    for x, y in ((a.s, b.s), (a.p, b.p), (a.o, b.o)):
        assert np.array_equal(x, y)


def test_seeds_change_links_not_sizes():
    a, b = _graph(3, 1), _graph(3, 2)
    assert not np.array_equal(a.o, b.o)
    pa = Counter(a.terms[i] for i in a.p.tolist())
    pb = Counter(b.terms[i] for i in b.p.tolist())
    for key in ("takesCourse", "advisor", "memberOf", "publicationAuthor", "teacherOf"):
        assert pa[UB + key] == pb[UB + key], key
    assert len(a) == len(b) and len(a.terms) == len(b.terms)


def _per_department(g):
    """Counts by department of each kind of member."""
    t = g.terms
    typ = {i for i, x in enumerate(t) if x == lubm_gen.RDF_TYPE}.pop()
    out = {}
    for s, p, o in zip(g.s.tolist(), g.p.tolist(), g.o.tolist()):
        if p != typ:
            continue
        iri, cls = t[s], t[o][len(UB):]
        if "/Department" not in iri and ".University" in iri and "Department" in iri:
            continue
        head = iri.split("/")
        if len(head) < 4:
            continue
        dept = head[2]
        out.setdefault(dept, Counter())[cls] += 1
    return out


def test_department_counts_in_uba_ranges():
    config = tiny_cell("lubm100.analytic", 2)["config"]
    uba = config["uba"]
    g = lubm_gen.generate(config, 11)
    depts = _per_department(g)
    per_univ = Counter(d.split(".")[1] for d in depts)
    lo, hi = uba["departments_per_university"]
    assert all(lo <= n <= hi for n in per_univ.values())
    for dept, c in depts.items():
        ranks = [c["FullProfessor"], c["AssociateProfessor"], c["AssistantProfessor"], c["Lecturer"]]
        for n, key in zip(ranks, ("full_professors_per_department", "associate_professors_per_department",
                                  "assistant_professors_per_department", "lecturers_per_department")):
            assert uba[key][0] <= n <= uba[key][1], (dept, key, n)
        fac = sum(ranks)
        ug, gr = c["UndergraduateStudent"], c["GraduateStudent"]
        assert ug % fac == 0 and uba["undergraduates_per_faculty"][0] <= ug // fac <= uba["undergraduates_per_faculty"][1]
        assert gr % fac == 0 and uba["graduates_per_faculty"][0] <= gr // fac <= uba["graduates_per_faculty"][1]
        assert uba["research_groups_per_department"][0] <= c["ResearchGroup"] <= uba["research_groups_per_department"][1]
        assert fac <= c["Course"] <= 2 * fac and fac <= c["GraduateCourse"] <= 2 * fac


def test_per_entity_ranges():
    config = tiny_cell("lubm100.analytic", 1)["config"]
    uba = config["uba"]
    g = lubm_gen.generate(config, 3)
    t = g.terms
    takes = Counter()
    advisors = Counter()
    heads = Counter()
    for s, p, o in zip(g.s.tolist(), g.p.tolist(), g.o.tolist()):
        if t[p] == UB + "takesCourse":
            takes[t[s]] += 1
        elif t[p] == UB + "advisor":
            advisors[t[s]] += 1
            assert "Lecturer" not in t[o]
        elif t[p] == UB + "headOf":
            heads[t[o]] += 1
            assert "FullProfessor" in t[s]
    for who, n in takes.items():
        key = "courses_taken_per_undergraduate" if "Undergraduate" in who else "courses_taken_per_graduate"
        assert uba[key][0] <= n <= uba[key][1]
    assert set(heads.values()) == {1}
    ug = sum(1 for x in t if x and x.rsplit("/", 1)[-1].startswith("UndergraduateStudent") and x.startswith("http"))
    ug_adv = sum(1 for w in advisors if "Undergraduate" in w)
    assert ug_adv == ug // uba["undergraduates_per_advisor"]


@pytest.mark.parametrize("universities", [1, 4])
def test_columns_unique_and_terms_dense(universities):
    g = _graph(universities, 9)
    key = np.stack([g.s, g.p, g.o], 1)
    assert len(np.unique(key, axis=0)) == len(g)
    assert g.s.max() < len(g.terms) and g.o.max() < len(g.terms)
    assert g.terms[0] is None and len(set(g.terms[1:])) == len(g.terms) - 1
