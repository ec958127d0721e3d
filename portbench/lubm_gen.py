"""A LUBM data generator shaped after UBA, vectorised and seeded.

LUBM's data generator (UBA, Guo, Pan & Heflin 2005) emits, for each
university, departments with faculty of four ranks, students, courses,
research groups and publications, each count drawn from a published range.
This file follows those ranges, which the configuration file states under
``uba``; what UBA leaves open is listed there under ``assumed``.

Sizes are the same for every seed: each count is drawn from a list whose
values spread evenly over the range.  A university's and a department's
counts are dealt out by the scale alone, so each is the same under every
seed; counts of single entities (courses taken, publications) are dealt
out by the seed, their totals fixed.  Two seeds give graphs of the same
size and shape with different links.  Which
course a student takes, which professor advises whom and which university
a degree is from come from the seed.

``generate(cfg, seed)`` returns a :class:`Graph`: the term list in ID order
(index 0 is ``None``; IRIs bare, literals in double quotes, as the port's
dictionary holds them) and the ``s``, ``p``, ``o`` uint32 columns, unique.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

UB = "http://swat.cse.lehigh.edu/onto/univ-bench.owl#"
RDF_TYPE = "http://www.w3.org/1999/02/22-rdf-syntax-ns#type"

#: the univ-bench names the data uses; rule and query constants that are
#: not here are appended after them by :func:`generate`
VOCAB = (
    "University", "Department", "FullProfessor", "AssociateProfessor",
    "AssistantProfessor", "Lecturer", "UndergraduateStudent", "GraduateStudent",
    "TeachingAssistant", "ResearchAssistant", "Course", "GraduateCourse",
    "ResearchGroup", "Publication", "name", "emailAddress", "telephone",
    "researchInterest", "worksFor", "headOf", "memberOf", "subOrganizationOf",
    "undergraduateDegreeFrom", "mastersDegreeFrom", "doctoralDegreeFrom",
    "teacherOf", "takesCourse", "advisor", "teachingAssistantOf",
    "publicationAuthor",
)
RANKS = ("FullProfessor", "AssociateProfessor", "AssistantProfessor", "Lecturer")
TELEPHONE = '"xxx-xxx-xxxx"'


@dataclass
class Graph:
    terms: List[object]
    s: np.ndarray
    p: np.ndarray
    o: np.ndarray

    def __len__(self) -> int:
        return len(self.s)


def balanced(rng, lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` whole numbers in ``[lo, hi]`` spread evenly over the range, in
    an order drawn from ``rng``: the multiset depends on ``(lo, hi, n)``
    alone."""
    vals = lo + (np.arange(n, dtype=np.int64) * (hi - lo + 1)) // max(n, 1)
    return rng.permutation(vals)


def seg_local(counts: np.ndarray) -> np.ndarray:
    """Position of each item within its segment, for segments of
    ``counts`` items laid end to end."""
    total = int(counts.sum())
    starts = np.cumsum(counts) - counts
    return np.arange(total, dtype=np.int64) - np.repeat(starts, counts)


def offsets(counts: np.ndarray) -> np.ndarray:
    return np.cumsum(counts) - counts


def spread_picks(rng, owner_n: np.ndarray, takes: np.ndarray) -> tuple:
    """For each chooser ``i``, ``takes[i]`` distinct positions in
    ``range(owner_n[i])``: a start drawn from ``rng`` and a stride of 1 to
    7 (distinct while ``7 * (takes - 1) < owner_n``).  Returns
    ``(chooser, position)`` flat arrays."""
    n = len(takes)
    if n and int((7 * (takes - 1) >= owner_n).sum()):
        raise ValueError("a pool is too small for its picks")
    base = (rng.random(n) * owner_n).astype(np.int64)
    stride = 1 + (rng.random(n) * 7).astype(np.int64)
    chooser = np.repeat(np.arange(n, dtype=np.int64), takes)
    j = seg_local(takes)
    pos = (base[chooser] + j * stride[chooser]) % owner_n[chooser]
    return chooser, pos


class _Terms:
    """Term list under construction: blocks of strings, IDs by offset."""

    def __init__(self):
        self.blocks: List[List[str]] = []
        self.n = 1  # ID 0 is the NULL slot

    def add(self, strings) -> np.ndarray:
        strings = list(strings)
        ids = np.arange(self.n, self.n + len(strings), dtype=np.int64)
        self.blocks.append(strings)
        self.n += len(strings)
        return ids

    def one(self, s: str) -> int:
        return int(self.add([s])[0])

    def terms(self) -> List[object]:
        out: List[object] = [None]
        for b in self.blocks:
            out.extend(b)
        return out


def generate(cfg: dict, seed: int, extra_terms=()) -> Graph:
    """The graph of ``cfg["universities"]`` universities from ``seed``.
    ``extra_terms`` (rule and query constants) get IDs after the
    vocabulary when the data does not hold them."""
    rng = np.random.default_rng(int(seed) & ((1 << 64) - 1))
    uba = cfg["uba"]
    U = int(cfg["universities"])
    T = _Terms()
    voc = {name: T.one(UB + name) for name in VOCAB}
    typ = T.one(RDF_TYPE)
    known = {UB + n for n in VOCAB} | {RDF_TYPE}
    for t in extra_terms:
        if t not in known:
            known.add(t)
            T.one(t)
    pool = max(U, int(uba["degree_university_pool"]))
    univ = T.add(f"http://www.University{u}.edu" for u in range(pool))
    univ_name = T.add(f'"University{u}"' for u in range(U))

    # -- departments
    # sizes come from a generator of their own, seeded by the scale alone:
    # every university and every department has the same counts under
    # every seed, and the seed draws the links
    fixed = np.random.default_rng(U)
    ndept = balanced(fixed, *uba["departments_per_university"], U)
    D = int(ndept.sum())
    d_univ = np.repeat(np.arange(U), ndept)
    d_loc = seg_local(ndept)
    dept_base = [f"http://www.Department{dl}.University{u}.edu" for u, dl in
                 zip(d_univ.tolist(), d_loc.tolist())]
    dept = T.add(dept_base)
    max_dept = int(ndept.max())
    dept_name = T.add(f'"Department{i}"' for i in range(max_dept))

    # -- faculty, rank by rank within each department
    # each department's counts: one row of a table whose columns spread
    # evenly over their ranges
    profile = np.stack([balanced(fixed, *uba[key], D) for key in (
        "full_professors_per_department", "associate_professors_per_department",
        "assistant_professors_per_department", "lecturers_per_department",
        "undergraduates_per_faculty", "graduates_per_faculty",
        "research_groups_per_department", "graduates_per_teaching_assistant",
        "graduates_per_research_assistant")], axis=1)
    nrank = profile[:, :4]  # (D, 4)
    nfac = nrank.sum(1)
    F = int(nfac.sum())
    f_dept = np.repeat(np.arange(D), nfac)
    f_rank = np.concatenate([np.repeat(np.arange(4), nrank[d]) for d in range(D)])
    f_loc = seg_local(nrank.ravel())
    f_str = [f"{dept_base[d]}/{RANKS[r]}{i}" for d, r, i in
             zip(f_dept.tolist(), f_rank.tolist(), f_loc.tolist())]
    fac = T.add(f_str)
    nprof = nrank[:, :3].sum(1)
    fac_off = offsets(nfac)

    # -- students
    nug = nfac * profile[:, 4]
    ngr = nfac * profile[:, 5]
    ug_dept = np.repeat(np.arange(D), nug)
    gr_dept = np.repeat(np.arange(D), ngr)
    ug_loc, gr_loc = seg_local(nug), seg_local(ngr)
    ug_str = [f"{dept_base[d]}/UndergraduateStudent{i}" for d, i in
              zip(ug_dept.tolist(), ug_loc.tolist())]
    gr_str = [f"{dept_base[d]}/GraduateStudent{i}" for d, i in
              zip(gr_dept.tolist(), gr_loc.tolist())]
    ug, gr = T.add(ug_str), T.add(gr_str)

    # -- courses: each faculty member teaches 1-2 of each kind, numbered by
    #    distinct draws from the department's pool of 100
    def courses(key, pool_key, word):
        per_fac = balanced(fixed, *uba[key], F)
        k = np.bincount(f_dept, weights=per_fac, minlength=D).astype(np.int64)
        npool = int(uba[pool_key])
        if int(k.max()) > npool:
            raise ValueError(f"{word}: more courses than the pool holds")
        perm = np.argsort(rng.random((D, npool)), axis=1)
        c_dept = np.repeat(np.arange(D), k)
        c_num = perm[c_dept, seg_local(k)]
        ids = T.add(f"{dept_base[d]}/{word}{n}" for d, n in
                    zip(c_dept.tolist(), c_num.tolist()))
        names = T.add(f'"{word}{n}"' for n in range(npool))
        teacher = np.repeat(fac, per_fac)
        return ids, c_dept, c_num, k, names[c_num], teacher

    crs, crs_dept, _crs_num, kc, crs_name, crs_teacher = courses(
        "courses_per_faculty", "course_pool", "Course")
    gcrs, gcrs_dept, _gnum, kg, gcrs_name, gcrs_teacher = courses(
        "graduate_courses_per_faculty", "graduate_course_pool", "GraduateCourse")
    crs_off, gcrs_off = offsets(kc), offsets(kg)

    # -- research groups
    nrg = profile[:, 6]
    rg_dept = np.repeat(np.arange(D), nrg)
    rg = T.add(f"{dept_base[d]}/ResearchGroup{i}" for d, i in
               zip(rg_dept.tolist(), seg_local(nrg).tolist()))

    # -- publications of the faculty, by rank
    npub = np.zeros(F, dtype=np.int64)
    for r, key in enumerate((
        "publications_per_full_professor", "publications_per_associate_professor",
        "publications_per_assistant_professor", "publications_per_lecturer",
    )):
        sel = np.flatnonzero(f_rank == r)
        npub[sel] = balanced(rng, *uba[key], len(sel))
    p_fac = np.repeat(np.arange(F), npub)
    p_loc = seg_local(npub)
    pub = T.add(f"{f_str[f]}/Publication{i}" for f, i in
                zip(p_fac.tolist(), p_loc.tolist()))
    max_pub = int(npub.max()) if F else 0
    pub_name = T.add(f'"Publication{i}"' for i in range(max_pub))

    # -- literals: names by class and index, e-mail addresses, the rest
    def names(word, n):
        return T.add(f'"{word}{i}"' for i in range(n))

    rank_names = [names(RANKS[r], int(nrank[:, r].max())) for r in range(4)]
    ug_names = names("UndergraduateStudent", int(nug.max()))
    gr_names = names("GraduateStudent", int(ngr.max()))
    tel = T.one(TELEPHONE)
    research = names("Research", int(uba["research_interest_pool"]))

    def email(strs):
        # <local>@Department<d>.University<u>.edu, from the entity's IRI
        out = []
        for s in strs:
            head, _, local = s.rpartition("/")
            out.append(f'"{local}@{head[11:]}"')
        return T.add(out)

    f_mail = email(f_str)
    ug_mail = email(ug_str)
    gr_mail = email(gr_str)

    # -- triples
    S: List[np.ndarray] = []
    P: List[np.ndarray] = []
    O: List[np.ndarray] = []

    def emit(s, p, o):
        s = np.asarray(s, dtype=np.int64).ravel()
        o = np.broadcast_to(np.asarray(o, dtype=np.int64), s.shape).ravel()
        S.append(s)
        P.append(np.full(len(s), p, dtype=np.int64))
        O.append(o)

    emit(univ[:U], typ, voc["University"])
    emit(univ[:U], voc["name"], univ_name)
    emit(dept, typ, voc["Department"])
    emit(dept, voc["name"], dept_name[d_loc])
    emit(dept, voc["subOrganizationOf"], univ[d_univ])

    rank_class = np.array([voc[r] for r in RANKS])
    emit(fac, typ, rank_class[f_rank])
    f_name = np.empty(F, dtype=np.int64)
    for r in range(4):
        sel = f_rank == r
        f_name[sel] = rank_names[r][f_loc[sel]]
    emit(fac, voc["name"], f_name)
    emit(fac, voc["emailAddress"], f_mail)
    emit(fac, voc["telephone"], tel)
    emit(fac, voc["worksFor"], dept[f_dept])
    pool_univ = univ[:pool]
    for key in ("undergraduateDegreeFrom", "mastersDegreeFrom", "doctoralDegreeFrom"):
        emit(fac, voc[key], pool_univ[rng.integers(0, pool, F)])
    profs = np.flatnonzero(f_rank < 3)
    emit(fac[profs], voc["researchInterest"], research[rng.integers(0, len(research), len(profs))])
    head = fac[fac_off + (rng.random(D) * nrank[:, 0]).astype(np.int64)]
    emit(head, voc["headOf"], dept)

    emit(crs, typ, voc["Course"])
    emit(crs, voc["name"], crs_name)
    emit(crs_teacher, voc["teacherOf"], crs)
    emit(gcrs, typ, voc["GraduateCourse"])
    emit(gcrs, voc["name"], gcrs_name)
    emit(gcrs_teacher, voc["teacherOf"], gcrs)

    emit(ug, typ, voc["UndergraduateStudent"])
    emit(ug, voc["name"], ug_names[ug_loc])
    emit(ug, voc["emailAddress"], ug_mail)
    emit(ug, voc["telephone"], tel)
    emit(ug, voc["memberOf"], dept[ug_dept])
    t_ug = balanced(rng, *uba["courses_taken_per_undergraduate"], len(ug))
    who, pos = spread_picks(rng, kc[ug_dept], t_ug)
    emit(ug[who], voc["takesCourse"], crs[crs_off[ug_dept[who]] + pos])
    n_adv = len(ug) // int(uba["undergraduates_per_advisor"])
    advised = rng.permutation(len(ug))[:n_adv]
    a_dept = ug_dept[advised]
    emit(ug[advised], voc["advisor"],
         fac[fac_off[a_dept] + (rng.random(n_adv) * nprof[a_dept]).astype(np.int64)])

    emit(gr, typ, voc["GraduateStudent"])
    emit(gr, voc["name"], gr_names[gr_loc])
    emit(gr, voc["emailAddress"], gr_mail)
    emit(gr, voc["telephone"], tel)
    emit(gr, voc["memberOf"], dept[gr_dept])
    emit(gr, voc["undergraduateDegreeFrom"], pool_univ[rng.integers(0, pool, len(gr))])
    t_gr = balanced(rng, *uba["courses_taken_per_graduate"], len(gr))
    who, pos = spread_picks(rng, kg[gr_dept], t_gr)
    emit(gr[who], voc["takesCourse"], gcrs[gcrs_off[gr_dept[who]] + pos])
    emit(gr, voc["advisor"],
         fac[fac_off[gr_dept] + (rng.random(len(gr)) * nprof[gr_dept]).astype(np.int64)])
    # teaching and research assistants: disjoint sets of each department's
    # graduate students, in an order drawn from the seed
    n_ta = ngr // profile[:, 7]
    n_ra = ngr // profile[:, 8]
    order = np.lexsort((rng.random(len(gr)), gr_dept))
    rank_in = np.empty(len(gr), dtype=np.int64)
    rank_in[order] = seg_local(ngr)
    ta = np.flatnonzero(rank_in < n_ta[gr_dept])
    ra = np.flatnonzero((rank_in >= n_ta[gr_dept]) & (rank_in < (n_ta + n_ra)[gr_dept]))
    emit(gr[ta], typ, voc["TeachingAssistant"])
    emit(gr[ta], voc["teachingAssistantOf"], crs[crs_off[gr_dept[ta]] + rank_in[ta]])
    emit(gr[ra], typ, voc["ResearchAssistant"])

    emit(rg, typ, voc["ResearchGroup"])
    emit(rg, voc["subOrganizationOf"], dept[rg_dept])

    emit(pub, typ, voc["Publication"])
    emit(pub, voc["name"], pub_name[p_loc])
    emit(pub, voc["publicationAuthor"], fac[p_fac])
    npub_dept = np.bincount(f_dept[p_fac], minlength=D).astype(np.int64)
    pub_off = offsets(npub_dept)  # publications are laid out department by department
    g_pubs = balanced(rng, *uba["publications_per_graduate"], len(gr))
    who, pos = spread_picks(rng, npub_dept[gr_dept], g_pubs)
    emit(pub[pub_off[gr_dept[who]] + pos], voc["publicationAuthor"], gr[who])

    s = np.concatenate(S)
    p = np.concatenate(P)
    o = np.concatenate(O)
    order = np.lexsort((o, p, s))
    s, p, o = s[order], p[order], o[order]
    keep = np.ones(len(s), dtype=bool)
    keep[1:] = (s[1:] != s[:-1]) | (p[1:] != p[:-1]) | (o[1:] != o[:-1])
    return Graph(T.terms(), s[keep].astype(np.uint32), p[keep].astype(np.uint32),
                 o[keep].astype(np.uint32))

