"""End-to-end smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--parent DIR]

(on a machine with one CUDA card; ``chip_profile.py`` breaks the same
queries down by phase and device operator).  ``--parent DIR`` names another
checkout, such as the parent commit unpacked with ``git archive``: phase 5
then also builds that checkout's kernels and times its merge-path and
filter kernels in turns with this tree's on the same inputs.

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. card   — the card's name and power limit (``nvidia-smi``); no CUDA card
            is a failure.
2. build  — compile every kernel source with nvcc for sm_90a.
3. kernels (random shapes) — each CUDA kernel against its plain PyTorch
            version on the same CUDA inputs, bit-exact: keys >= 2^31,
            sentinel rows, skewed fan-out, overflowing capacities; the
            merge path's tile edges (``merge_path_edge_args``: a fan-out
            over >= 3 tiles, one row, a match count that is a whole number
            of tiles, ragged capacities below it, windows at odd rows, no
            match); the filter at every wildcard pattern and compare op with
            the 0xFFFFFFFF constant at ``FILTER_SIZES`` rows (every tail
            of its 4-row groups) and, predicate only, at 2^25 + 3 rows, each
            also on a view off 16-byte alignment; tag combines with 0, 1,
            NaN and +-0.0.
4. main path — LUBM (``benches/lubm.py::generate_fast``, 1000 universities
            = 3,785,000 triples) and the employee-100K dataset (as
            ``bench.py`` builds it) through ``SparqlDatabase`` +
            ``execute_query_volcano`` on the card: employee join, LUBM Q2,
            Q9, and Q9 again under ``KOLIBRIE_WCOJ=off``.  Row counts are
            asserted and rows must equal the port's own run on the CPU.
            Launch counters are zeroed just before and read just after;
            each query's warm run must launch the kernels of its route.
4b. SELECT surface — over the same LUBM-1000 and employee databases, plus
            a copy of the LUBM columns with ``<< ?x ub:advisor ?p >>
            ub:since "<year>"`` for each of the 160,000 graduate students:
            UNION + OPTIONAL + MINUS, two GROUP BY counts (one over a
            triangle, through WCOJ), ORDER BY DESC LIMIT 100, VALUES, an
            RDF-star quoted pattern, and COUNT/SUM/AVG/MIN/MAX/SAMPLE per
            employer, each cold and then warm (``SURFACE_QUERIES``).  Counts
            asserted; each run must take the JAX package's route
            (``SURFACE_ROUTES``: the fused device program, the device
            aggregate or the device top-k, never a host post-pass) and the
            warm run must launch the kernels of its plan
            (``SURFACE_LAUNCHES``); rows, routes and plans must equal the
            port's CPU run.  Counters zeroed just before, read just after.
6. reasoner — the Datalog closure of ``benches/bench_lubm.py`` (transitive
            ``subOrganizationOf`` + ``memberOf`` propagation) over the same
            LUBM-1000 columns, through ``Reasoner.
            infer_new_facts_semi_naive_parallel`` (the device fixpoint above
            50,000 facts) on the card, cold and then warm on a fresh
            reasoner: 640,000 derived facts, the fact set equal to the
            port's host strategy on a copy, and the warm run launching the
            fused filter and the merge-path join.  Counters are zeroed just
            before each run and read just after; a third, untimed run
            records the kernels' inputs for phase 5.
6b. small closure — LUBM at a few universities plus an age literal per
            graduate student, with a negated premise, a numeric filter and a
            three-premise rule, through ``DeviceFixpoint.infer`` and
            ``infer_chunked(chunk_rows=1024)`` and
            ``Reasoner.infer_new_facts_device``: the card's padded output
            columns equal the port's CPU run row for row.
6c. ops entry points — ``kolibrie_tpu_torch.ops.filter_mask`` (LUBM-1000
            graduate students), ``merge_join`` (the Q9-off join's keys) and
            ``tag_combine`` (every op, at the closure's fact capacity), with
            counters zeroed just before and read just after.
7. RSP — the single-window R2R shape of ``benches/bench_rsp_engine.py``
            at a 120,000-triple window: ``RSPBuilder(RSP_QUERY)
            .add_rules(RSP_RULES).set_r2r_mode("device")`` on the card over
            360 ticks of 1,000 ``knows`` events among 40,000 persons (rule
            ``knows o knows => reach``, about 360,000 derived a firing; the
            query joins ``reach`` and ``knows`` on two keys).  The same
            stream through ``set_r2r_mode("host")`` is the oracle: rows and
            derived counts equal firing by firing, rows > 0.  The host run
            still queries on the card, so the stream's first
            ``RSP_CPU_TICKS`` ticks also go through the port's CPU run
            (``device="cpu"``, host closure), whose firings the card's must
            equal too.  At least five
            full-width firings, the device route kept (``_device_ok``), no
            dead letters, and every warm firing launching ``filter_mask``
            and the merge path twice.  Per firing: maintenance, fixpoint
            and query ms, rounds, capacities, derived, rows, wall; events/s
            and peak device memory.  Counters zeroed just before the stream
            and read just after.
8. statements and host-engine shapes — on a database of its own built
            from phase 4's LUBM-1000 columns: the shapes the device lowering
            declines, answered by the host engine on the card
            (``HOST_QUERIES``: a cartesian COUNT over 8,000,000 rows, a
            96-row cartesian, a string FILTER over ``STR(?c)``, a
            clause-only UNION with a FILTER, constant-only groups true and
            false) and ``execute_query`` on ``agg_dept`` (textual join
            order, host aggregate), each cold then warm, route "host" /
            "naive" and warm-run launches as ``HOST_LAUNCHES`` says; then
            through ``execute_query_volcano`` the RULE ``memberOf`` lift
            (640,000 facts inserted), the University0 members, DELETE …
            WHERE of those facts (640,000 → 0 by count; Q2 still 56,120
            rows), the RULE and the DELETE again (warm: the RULE launching
            the fused filter and the merge path), and INSERT DATA /
            DELETE DATA of 1,000 triples.  The same sequence runs on the
            CPU (``device="cpu"``, the RULE's closure by the host
            strategy): rows, counts and the store after the RULE must
            equal.  Per statement: wall, closure and compaction ms, rounds.
            Counters zeroed just before each run and read just after.
5. kernels (main-path shapes) — each kernel against its plain version on
            the largest inputs its path gave it (phases 4, 6, 6c, 7 and 8), both
            timed on the device, and the bound: the bytes the function needs
            at 3.35 TB/s; ``filter_mask`` beside ``torch.eq`` for its
            predicate-only shapes; the ``-Xptxas -v`` registers, shared
            memory and spills of the merge-path and filter kernels each row
            launches (and, with ``--parent``, the parent's kernels timed in
            turns with them).  Runs last, after the phases that record the
            shapes.

Prints the kernel table as one JSON line, the card line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
UNIVERSITIES = 1000  # LUBM-1000
LUBM_TRIPLES = 3_785_000
EMPLOYEES = 25_000  # employee-100K: 4 triples per employee
EXPECTED_ROWS = {"employee": 25_000, "q2": 56_120, "q9": 640_000, "q9_wcoj_off": 640_000}
# Kernel launches each query's warm run must make (the route it must take)
EXPECTED_LAUNCHES = {
    "employee": {"merge_path_join": 1, "merge_join_indices": 1},
    "q2": {"lex_probe_select": 1, "lex_probe_validate": 1},
    "q9": {"lex_probe_select": 1, "lex_probe_validate": 1},
    "q9_wcoj_off": {
        "merge_path_join": 2, "merge_join_indices": 1, "ranked_merge_join_indices": 1,
    },
}
# Kernels the SELECT path (phase 4) must reach at all
MAIN_PATH_KERNELS = (
    "merge_path_join", "lex_probe_select", "lex_probe_validate",
    "merge_join_indices", "ranked_merge_join_indices",
)
CLOSURE_DERIVED = 640_000  # memberOf of every LUBM-1000 student lifted to its university
# Kernel launches the closure's warm run must make
CLOSURE_LAUNCHES = {"filter_mask": 1, "merge_path_join": 1, "ranked_merge_join_indices": 1}
# Kernels the ops API's entries (phase 6c) must reach
OPS_ENTRY_KERNELS = ("filter_mask", "merge_join", "tag_combine")
SMALL_UNIVERSITIES = 3
LUBM_GRAD_STUDENTS = 160_000  # 20 of each department's 80 students
TAG_OPS = ("min", "max", "mul", "noisy_or")
TAG_ROWS = 1 << 25  # the LUBM-1000 closure's fact capacity

EMPLOYEE_QUERY = """PREFIX ds: <https://data.example/ontology#>
PREFIX foaf: <http://xmlns.com/foaf/0.1/>
SELECT ?employee ?workplaceHomepage ?salary WHERE {
    ?employee foaf:workplaceHomepage ?workplaceHomepage .
    ?employee ds:annual_salary ?salary
}"""

# ---- phase 4b: the rest of the SELECT surface
SURFACE_PREFIXES = """PREFIX rdf: <http://www.w3.org/1999/02/22-rdf-syntax-ns#>
PREFIX ub: <http://swat.cse.lehigh.edu/onto/univ-bench.owl#>
PREFIX foaf: <http://xmlns.com/foaf/0.1/>
PREFIX ds: <https://data.example/ontology#>
"""
# (database, query): "lubm" is phase 4's LUBM database, "quoted" the same
# columns plus one annotation per graduate student, "employee" phase 4's
# employee database
SURFACE_QUERIES = {
    "clauses": ("lubm", "SELECT ?x ?d ?y WHERE { ?x ub:memberOf ?d . "
                "{ ?x rdf:type ub:GraduateStudent } UNION { ?x rdf:type ub:UndergraduateStudent } "
                "OPTIONAL { ?x ub:undergraduateDegreeFrom ?y } "
                "MINUS { ?x ub:undergraduateDegreeFrom ?u . ?d ub:subOrganizationOf ?u } }"),
    "agg_dept": ("lubm", "SELECT ?d (COUNT(?x) AS ?n) WHERE { ?x ub:memberOf ?d . "
                 "?x rdf:type ub:GraduateStudent } GROUP BY ?d"),
    "agg_triangle": ("lubm", "SELECT ?p (COUNT(?x) AS ?n) WHERE { ?x ub:advisor ?p . "
                     "?x ub:takesCourse ?c . ?p ub:teacherOf ?c } GROUP BY ?p"),
    "topk": ("lubm", "SELECT ?x ?c WHERE { ?x ub:takesCourse ?c . "
             "?x rdf:type ub:GraduateStudent } ORDER BY DESC(?x) LIMIT 100"),
    "values": ("lubm", "SELECT ?x ?d WHERE { VALUES ?d { <http://www.Department0.University0.edu> "
               "<http://www.Department3.University1.edu> } ?x ub:memberOf ?d . "
               "?x rdf:type ub:GraduateStudent }"),
    "quoted": ("quoted", "SELECT ?x ?y WHERE { << ?x ub:advisor ?p >> ub:since ?y . "
               "?x rdf:type ub:GraduateStudent }"),
    "emp_agg": ("employee", "SELECT ?h (COUNT(?e) AS ?n) (SUM(?s) AS ?sum) (AVG(?s) AS ?avg) "
                "(MIN(?s) AS ?lo) (MAX(?s) AS ?hi) (SAMPLE(?e) AS ?one) WHERE { "
                "?e foaf:workplaceHomepage ?h . ?e ds:annual_salary ?s } GROUP BY ?h"),
}
# The route each query must take, as the JAX package routes it: "fused" =
# one device program with the UNION/OPTIONAL/MINUS inside it, "device" =
# one device program (no clauses to fuse), "aggregated" = the device
# segment-reduce, "ordered" = the device top-k.  No host post-pass.
SURFACE_ROUTES = {
    "clauses": "fused", "agg_dept": "aggregated", "agg_triangle": "aggregated",
    "topk": "ordered", "values": "device", "quoted": "device", "emp_agg": "aggregated",
}
# Kernel launches of one run of each query's plan, from the port's own
# lowering on the CPU (``tests/test_torch_clauses.py`` holds this table
# against it at LUBM-3; phase 4b against the CPU run at full size).
SURFACE_LAUNCHES = {
    # union join and MINUS-branch join presorted, OPTIONAL ranked
    "clauses": {"merge_path_join": 3, "merge_join_indices": 2, "ranked_merge_join_indices": 1},
    "agg_dept": {"merge_path_join": 1, "merge_join_indices": 1},
    "agg_triangle": {"lex_probe_select": 3, "lex_probe_validate": 3},  # WCOJ, 3 levels
    "topk": {"merge_path_join": 1, "merge_join_indices": 1},
    "values": {"merge_path_join": 2, "merge_join_indices": 2},
    "quoted": {"merge_path_join": 1, "merge_join_indices": 1},
    "emp_agg": {"merge_path_join": 1, "merge_join_indices": 1},
}
SINCE_YEARS = 20  # "<year>" literals of the advisor annotations

# ---- phase 7: RSP (the single-window R2R shape of benches/bench_rsp_engine.py:96-145)
RSP_PERSONS = 40_000
RSP_EVENTS_PER_TICK = 1_000
RSP_TICKS = 360  # ticks 1 .. 360: firings at 60, 120, ..., 360
RSP_WIDTH = 120  # [RANGE 120 STEP 60]: a full window holds 120 ticks of events
RSP_SEED = 7
RSP_FULL_FIRINGS = 5
RSP_CPU_TICKS = 180  # the CPU oracle's prefix: firings at 60, 120, 180 (two at full width)
RSP_STREAM = "http://city/social"
RSP_QUERY = """PREFIX s: <http://city/>
REGISTER RSTREAM <http://out/cyc> AS
SELECT ?a ?c
FROM NAMED WINDOW <http://city/w/> ON <http://city/social> [RANGE 120 STEP 60]
WHERE { WINDOW <http://city/w/> { ?a s:reach ?c . ?c s:knows ?a } }"""
RSP_RULES = """@prefix s: <http://city/> .
{ ?a s:knows ?b . ?b s:knows ?c . } => { ?a s:reach ?c . } .
"""
# Kernel launches every warm device firing must make: the fixpoint's premise
# scans (filter_mask) and its premise join + the query's two-key join
RSP_LAUNCHES = {"filter_mask": 1, "merge_path_join": 2}

# ---- phase 8: the host engine's shapes and the statements beside SELECT
# (SURFACE_PREFIXES), each answered by the JAX package on its host engine
HOST_QUERIES = {
    # every university beside every department: 8,000,000 rows at LUBM-1000
    "cartesian_count": "SELECT (COUNT(?u) AS ?n) WHERE { ?u rdf:type ub:University . "
                       "?d rdf:type ub:Department }",
    # the 8 departments of University0 beside the 12 professors of its Department0
    "cartesian_small": "SELECT ?d ?p WHERE { ?d ub:subOrganizationOf <http://www.University0.edu> . "
                       "?p ub:worksFor <http://www.Department0.University0.edu> . "
                       "?p rdf:type ub:FullProfessor }",
    # a string predicate over STR(?c): no device mask for it
    "filter_function": "SELECT (COUNT(?x) AS ?n) WHERE { ?x ub:takesCourse ?c . "
                       "?x rdf:type ub:GraduateStudent . FILTER(REGEX(STR(?c), \"Course1[0-4]$\")) }",
    # a UNION with no group beside it and a FILTER (which sees no clause column)
    "clause_only": "SELECT ?x ?d WHERE { { ?x ub:worksFor ?d . "
                   "?d ub:subOrganizationOf <http://www.University0.edu> } UNION "
                   "{ ?x ub:advisor ?d . ?d ub:worksFor <http://www.Department0.University0.edu> } "
                   "FILTER(BOUND(?x)) }",
    "const_true": "SELECT (COUNT(*) AS ?n) WHERE { <http://www.University0.edu> rdf:type ub:University }",
    "const_false": "SELECT (COUNT(*) AS ?n) WHERE { <http://www.University0.edu> rdf:type ub:Department }",
}
# ``execute_query`` (textual join order, host aggregate) on phase 4b's agg_dept
NAIVE_QUERY = SURFACE_QUERIES["agg_dept"][1]
# Kernel launches of one warm run of each (the host engine's joins are the
# ranked merge path at the exact count; a cartesian product launches
# nothing; the clause-only group's UNION branches run on the device engine).
# ``tests/test_torch_host_engine.py`` holds this table at LUBM-3.
HOST_LAUNCHES = {
    "cartesian_count": {},
    "cartesian_small": {"merge_path_join": 1, "ranked_merge_join_indices": 1},
    "filter_function": {"merge_path_join": 1, "ranked_merge_join_indices": 1},
    "clause_only": {"merge_path_join": 2, "merge_join_indices": 2},
    "const_true": {},
    "const_false": {},
    "naive": {"merge_path_join": 1, "ranked_merge_join_indices": 1},
}
RULE_STATEMENT = ("RULE :MemberUniv :- CONSTRUCT { ?x ub:memberOf ?u . } "
                  "WHERE { ?x ub:memberOf ?d . ?d ub:subOrganizationOf ?u . }")
RULE_LAUNCHES = {"filter_mask": 1, "merge_path_join": 1}  # the closure's, at least
DELETE_STATEMENT = ("DELETE { ?x ub:memberOf ?u } "
                    "WHERE { ?x ub:memberOf ?u . ?u rdf:type ub:University }")
UNIV_MEMBERS = "SELECT (COUNT(?x) AS ?n) WHERE { ?x ub:memberOf ?u . ?u rdf:type ub:University }"
UNIV0_MEMBERS = "SELECT ?x WHERE { ?x ub:memberOf <http://www.University0.edu> }"
NOTE = "http://phase8.example/note"
NOTE_COUNT = f"SELECT (COUNT(?s) AS ?n) WHERE {{ ?s <{NOTE}> ?o }}"
DATA_TRIPLES = 1_000


def surface_expected(universities: int, q2_rows: int, employees: int) -> dict:
    """What each phase-4b query must return at ``universities`` (LUBM has
    640 students, 160 of them graduate students, 8 departments and 96
    professors per university; ``q2_rows`` = LUBM Q2's count there)."""
    students, grads = 640 * universities, 160 * universities
    return {
        # every student less the Q2 rows; ?y bound for the graduate
        # students outside Q2
        "clauses": {"rows": students - q2_rows, "y_bound": grads - q2_rows},
        "agg_dept": {"rows": 8 * universities, "each": 20},
        "agg_triangle": {"rows": 96 * universities, "sum": grads * 4},
        "topk": {"rows": 100},
        "values": {"rows": 40},
        "quoted": {"rows": grads},
        "emp_agg": {"rows": min(employees, 500)},
    }


def host_expected(universities: int) -> dict:
    """What each phase-8 host-engine query must return at ``universities``
    (8 departments and 96 professors a university; 6 of a department's 20
    graduate students take one of Course10-Course14)."""
    return {
        "cartesian_count": [[str(universities * 8 * universities)]],
        "cartesian_small": 8 * 12,
        "filter_function": [[str(48 * universities)]],
        "clause_only": 96 + 80,
        "const_true": [["1"]],
        "const_false": [["0"]],
        "naive": 8 * universities,
    }


def annotate_advisors(db) -> int:
    """Add ``<< ?x ub:advisor ?p >> ub:since "<year>"`` for every graduate
    student's advisor triple, interning the quoted triples by ID (no
    parsing).  Works on either package's database.  Returns the count."""
    import numpy as np

    from benches.lubm import RDF_TYPE, UB

    enc = db.dictionary.encode
    s, p, o = db.store.columns()
    grads = s[(p == enc(RDF_TYPE)) & (o == enc(UB + "GraduateStudent"))]
    adv = (p == enc(UB + "advisor")) & np.isin(s, grads)
    qids = np.array(
        [db.quoted.intern(int(a), int(b), int(c)) for a, b, c in zip(s[adv], p[adv], o[adv])],
        dtype=np.uint32,
    )
    years = np.array([enc(f'"{2000 + y}"') for y in range(SINCE_YEARS)], dtype=np.uint32)
    db.store.add_batch(
        qids,
        np.full(len(qids), enc(UB + "since"), dtype=np.uint32),
        years[np.arange(len(qids)) % SINCE_YEARS],
    )
    return len(qids)


def plan_launches(root) -> dict:
    """Kernel launches of one run of a lowered plan's spec tree: the
    merge-path kernel per join (and its entry), the lex-probe pair per WCOJ
    level."""
    from collections import Counter

    from kolibrie_tpu_torch.optimizer import device_engine as DE

    counts = Counter()

    def walk(node):
        if isinstance(node, DE.JoinSpec):
            counts["merge_path_join"] += 1
            counts["merge_join_indices" if node.rsorted else "ranked_merge_join_indices"] += 1
        elif isinstance(node, DE.LeftOuterSpec):
            counts["merge_path_join"] += 1
            counts["ranked_merge_join_indices"] += 1
        elif isinstance(node, DE.WcojSpec):
            counts["lex_probe_select"] += len(node.levels)
            counts["lex_probe_validate"] += len(node.levels)
        DE._map_children(node, walk)
        return node

    walk(root)
    return dict(counts)


class RouteSpy:
    """Records how ``execute_query_volcano`` answered: the spec tree of
    every device plan run, whether it fused the clauses, whether a host
    clause post-pass ran, and whether the aggregate / ordered device routes
    served the query."""

    def __enter__(self):
        from kolibrie_tpu_torch.optimizer import device_engine as DE
        from kolibrie_tpu_torch.query import executor as E

        from kolibrie_tpu_torch.optimizer.engine import ExecutionEngine

        self.runs, self.post_passes, self.routes = [], 0, []
        self._saved = (DE.LoweredPlan.run, E._clause_post_passes,
                       E.try_device_execute_aggregated, E.try_device_execute_ordered,
                       ExecutionEngine.execute_with_ids, E._naive_eval)
        run, post, agg, ordered, host, naive = self._saved
        spy = self

        def host_rec(*a, **k):
            spy.routes.append("host")
            return host(*a, **k)

        def naive_rec(*a, **k):
            spy.routes.append("naive")
            return naive(*a, **k)

        def run_rec(lowered):
            spy.runs.append((lowered.root, lowered.fused_clauses))
            return run(lowered)

        def post_rec(*a):
            spy.post_passes += 1
            return post(*a)

        def agg_rec(*a, **k):
            out = agg(*a, **k)
            if out is not None:
                spy.routes.append("aggregated")
            return out

        def ordered_rec(*a, **k):
            out = ordered(*a, **k)
            if out is not None:
                spy.routes.append("ordered")
            return out

        DE.LoweredPlan.run = run_rec
        E._clause_post_passes = post_rec
        E.try_device_execute_aggregated = agg_rec
        E.try_device_execute_ordered = ordered_rec
        ExecutionEngine.execute_with_ids = host_rec
        E._naive_eval = naive_rec
        return self

    def __exit__(self, *exc):
        from kolibrie_tpu_torch.optimizer import device_engine as DE
        from kolibrie_tpu_torch.optimizer.engine import ExecutionEngine
        from kolibrie_tpu_torch.query import executor as E

        (DE.LoweredPlan.run, E._clause_post_passes,
         E.try_device_execute_aggregated, E.try_device_execute_ordered,
         ExecutionEngine.execute_with_ids, E._naive_eval) = self._saved
        return False

    def route(self) -> str:
        """The route of the one query run under this spy: "naive" or
        "host" when the legacy join order or the host engine answered its
        group (whatever else ran beside it)."""
        for first in ("naive", "host"):
            if first in self.routes:
                return first
        if self.post_passes or len(set(self.routes)) > 1:
            return "host post-pass"
        if self.routes:
            return self.routes[0]
        if self.runs and all(fused for _root, fused in self.runs):
            return "fused"
        return "device" if self.runs else "none"

    def launches(self) -> dict:
        """Kernel launches of the distinct plans run (one run each)."""
        out = {}
        seen = set()
        for root, _fused in self.runs:
            if root in seen:
                continue
            seen.add(root)
            for k, n in plan_launches(root).items():
                out[k] = out.get(k, 0) + n
        return out


class KernelCalls:
    """Counts the kernel wrappers' calls in its scope under the names of
    ``LAUNCHES`` / ``ENTRY_LAUNCHES``.  On the card each call is one launch;
    on the CPU, where the counters stay 0, the calls are the launches a
    card run of the same work makes."""

    def __enter__(self):
        from kolibrie_tpu_torch.ops import kernels as K
        from kolibrie_tpu_torch.optimizer import device_engine as DE
        from kolibrie_tpu_torch.reasoner import device_fixpoint as FX

        self.counts = {}
        self._saved = [(K, "merge_path"), (K, "_merge_join_core"), (DE, "lex_probe_select"),
                       (DE, "lex_probe_validate"), (FX, "filter_mask")]
        self._saved = [(owner, attr, getattr(owner, attr)) for owner, attr in self._saved]
        counts = self.counts

        def counted(name, fn, when=lambda a: True):
            def wrapped(*a, **k):
                if when(a):
                    counts[name(a) if callable(name) else name] = (
                        counts.get(name(a) if callable(name) else name, 0) + 1)
                return fn(*a, **k)

            return wrapped

        (_, _, path), (_, _, core), (_, _, sel), (_, _, val), (_, _, filt) = self._saved
        K.merge_path = counted("merge_path_join", path)
        # an entry reaches its kernel unless a side is empty
        K._merge_join_core = counted(lambda a: a[3], core,
                                     lambda a: a[0].shape[0] and a[1].shape[0])
        DE.lex_probe_select = counted("lex_probe_select", sel)
        DE.lex_probe_validate = counted("lex_probe_validate", val)
        FX.filter_mask = counted("filter_mask", filt)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in self._saved:
            setattr(owner, attr, fn)
        return False


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def employee_ntriples(n: int) -> str:
    lines = []
    for i in range(n):
        e = f"<https://data.example/employee/{i}>"
        lines.append(f'{e} <http://xmlns.com/foaf/0.1/name> "Employee {i}" .')
        lines.append(f'{e} <https://data.example/ontology#title> "Engineer" .')
        lines.append(
            f"{e} <http://xmlns.com/foaf/0.1/workplaceHomepage> "
            f"<https://company{i % 500}.example/> ."
        )
        lines.append(
            f'{e} <https://data.example/ontology#annual_salary> '
            f'"{30000 + (i % 50) * 1000}" .'
        )
    return "\n".join(lines)


# ------------------------------------------------------------------ timing


def time_ms(fn, reps: int = 20) -> tuple:
    """``(device_ms, enqueue_ms)`` of one call of ``fn``.  Device time: the
    calls are queued behind a spin kernel, so the card runs them back to
    back whatever the host's launch rate, and CUDA events time them; the
    spin is lengthened until it outlasts the queueing, and the number of
    calls halved each time as well: a call of many small launches fills the
    card's launch queue, whose limit blocks the host behind the spin.
    Enqueue time: host wall per call of ``reps`` calls ending in one
    synchronisation."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    enqueue_ms = (time.perf_counter() - t) * 1e3 / reps
    cycles = 10_000_000
    for _try in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        starved = start.query()  # spin over before the last call was queued
        torch.cuda.synchronize()
        if not starved:
            break
        cycles *= 4
        reps = max(1, reps // 2)
    else:
        raise AssertionError("the host could not queue the calls ahead of the card")
    return start.elapsed_time(end) / reps, enqueue_ms


def max_abs_err(got, want) -> int:
    import torch

    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def float_err(got, want) -> float:
    """0.0 when the f32 tensors are bit-identical, NaN matching NaN; else
    the largest absolute difference among the rows that differ."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    same = (got.view(torch.int32) == want.view(torch.int32)) | (
        torch.isnan(got) & torch.isnan(want)
    )
    if bool(same.all()):
        return 0.0
    return float((got - want).abs()[~same].nan_to_num(float("inf")).max())


# ----------------------------------------------------- kernel comparisons


def random_join_keys(seed: int, dev):
    """Keys of one random merge join: bit 31 set on a fifth of them,
    Zipf-skewed fan-out, left sentinel holes, prefix-valid sorted right
    side."""
    import torch

    from kolibrie_tpu_torch.ops import kernels as K

    g = torch.Generator().manual_seed(seed)
    n_l, n_r = 50_000 + 7919 * seed, 40_000 + 104_729 * seed
    zipf = torch.floor(torch.rand(n_l, generator=g).pow(3) * 3000).to(torch.int64)
    lk = zipf | ((torch.rand(n_l, generator=g) < 0.2).to(torch.int64) << 31)
    rk = torch.randint(0, 3000, (n_r,), generator=g)
    rk = torch.sort(rk | ((torch.rand(n_r, generator=g) < 0.2).to(torch.int64) << 31)).values
    lvalid = torch.rand(n_l, generator=g) < 0.9
    rvalid = torch.arange(n_r) < int(n_r * 0.95)
    lk = torch.where(lvalid, lk, K.SENT - 1).to(dev)
    rk = torch.where(rvalid, rk, K.SENT).to(dev)
    return lk, rk, g


def merge_path_args_random(seed: int, dev):
    """Prepass outputs of one random merge join (:func:`random_join_keys`),
    at a capacity that holds every match and at one that overflows."""
    from kolibrie_tpu_torch.ops import kernels as K

    lk, rk, _g = random_join_keys(seed, dev)
    n_l, n_r = lk.shape[0], rk.shape[0]
    lidx_c, low_c, cum, total = K._join_prepass(lk, rk)
    total_h = int(total)
    # once exactly at the match count, once overflowing (half the matches)
    caps = [K._round_out(total_h), K._round_out(max(total_h // 2, 1))]
    return [(lidx_c, low_c, cum, total, n_l, n_r, cap) for cap in caps]


MERGE_TILE = 1024  # output slots of one merge-path block (csrc/merge_join.cu)


def merge_path_edge_args(dev) -> list:
    """Prepass outputs at the shapes the merge-path kernel's tiles make
    hard, each with the capacities that matter for it: one row whose fan-out
    spans >= 3 tiles, a single compacted row, a match count that is an exact
    multiple of the tile, capacities below it that are not (one not even a
    multiple of 8), every tile's window starting at an odd row (and random
    fan-outs of 1-5, so odd and even starts mix), and no match at all."""
    import torch

    from kolibrie_tpu_torch.ops import kernels as K

    t = MERGE_TILE
    g = torch.Generator().manual_seed(5)
    fan = torch.randint(1, 6, (3000,), generator=g)
    cases = [
        ([1, 5, 9], [1] + [5] * (3 * t + 100) + [9] * 7, (None, 2 * t + 1)),
        ([5], [5] * (2 * t + 3), (None,)),
        (range(4 * t), range(4 * t), (None, 3 * t, 5003)),
        (range(3 * t), [0] + list(range(3 * t)), (None, 2 * t - 1)),
        (range(3000), torch.repeat_interleave(torch.arange(3000), fan).tolist(), (None,)),
        ([1, 2, 3], [10, 20], (1024, 5003)),
    ]
    out = []
    for lk, rk, caps in cases:
        lk = torch.tensor(list(lk), dtype=torch.int64, device=dev)
        rk = torch.sort(torch.tensor(list(rk), dtype=torch.int64)).values.to(dev)
        lidx_c, low_c, cum, total = K._join_prepass(lk, rk)
        for cap in caps:
            cap = K._round_out(int(total)) if cap is None else cap
            out.append((lidx_c, low_c, cum, total, lk.shape[0], rk.shape[0], cap))
    return out


def check_merge_path(args) -> int:
    from kolibrie_tpu_torch.ops import kernels as K

    got = K.merge_path(*args)
    want = K.merge_path_plain(*args)
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"merge_path_join differs from its plain version by {err}")
    return err


def merge_join_args_random(seed: int, dev):
    """``merge_join`` arguments over :func:`random_join_keys` with random
    u32 payloads, at a capacity that holds every match and at one that
    overflows."""
    import torch

    from kolibrie_tpu_torch.ops import kernels as K

    lk, rk, g = random_join_keys(seed, dev)
    lval = torch.randint(0, 1 << 32, (lk.shape[0],), generator=g).to(dev)
    rval = torch.randint(0, 1 << 32, (rk.shape[0],), generator=g).to(dev)
    total = int(K._join_prepass(lk, rk)[3])
    return [(lk, lval, rk, rval, cap) for cap in (total, max(total // 2, 1))]


def merge_join_plain(*args):
    """``merge_join`` with the merge-path kernel's plain version in its
    place: the plain form of the whole entry."""
    from kolibrie_tpu_torch.ops import kernels as K

    saved = K.merge_path
    K.merge_path = K.merge_path_plain
    try:
        return K.merge_join(*args)
    finally:
        K.merge_path = saved


def check_merge_join(args) -> int:
    from kolibrie_tpu_torch.ops import kernels as K

    err = max_abs_err(K.merge_join(*args), merge_join_plain(*args))
    if err:
        raise AssertionError(f"merge_join differs from its plain form by {err}")
    return err


# IDs for the filter checks: bit 31 set, the largest ID and the sentinel
FILTER_IDS = (0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE, 0xFFFFFFFF)
# Row counts of the filter checks at every pattern: every tail of the
# kernel's 4-row groups, around 1024, and 2^20 + 3
FILTER_SIZES = (1, 3, 5, 6, 15, 17, 1000, 1023, 1025, 300_001, (1 << 20) + 3)
FILTER_LARGEST = (1 << 25) + 3  # the closure's fact scan + 3, predicate only


def filter_args_random(seed: int, n: int, dev) -> list:
    """Three ID columns of ``n`` rows drawn from :data:`FILTER_IDS`, and the
    keyword arguments of every wildcard pattern crossed with every
    ``o_op`` (-1 none, 0..5), with constants from the same pool."""
    import torch

    g = torch.Generator().manual_seed(seed)
    pool = torch.tensor(FILTER_IDS, dtype=torch.int64)
    s, p, o = (pool[torch.randint(0, len(pool), (n,), generator=g)].to(dev) for _ in range(3))
    out = []
    for pattern in range(8):
        for op in range(-1, 6):
            c = [FILTER_IDS[int(i)] for i in torch.randint(0, len(pool), (4,), generator=g)]
            kw = {
                "s_const": c[0] if pattern & 1 else -1,
                "p_const": c[1] if pattern & 2 else -1,
                "o_const": c[2] if pattern & 4 else -1,
                "o_op": op,
                "o_cmp": c[3],
            }
            out.append((s, p, o, kw))
    kw_never = {"s_const": 0xFFFFFFFF, "p_const": -1, "o_const": -1, "o_op": -1, "o_cmp": 0}
    out.append((s, p, o, kw_never))
    return out


def check_filter(args) -> int:
    from kolibrie_tpu_torch.ops import kernels as K

    s, p, o, kw = args
    err = max_abs_err([K.filter_mask(s, p, o, **kw)], [K.filter_mask_plain(s, p, o, **kw)])
    if err:
        raise AssertionError(f"filter_mask {kw} differs from its plain version by {err}")
    return err


def tag_args_random(seed: int, n: int, dev):
    """Two f32 tag columns in [0, 1] with 0, 1, NaN and +-0.0 planted."""
    import torch

    g = torch.Generator().manual_seed(seed)
    a = torch.rand(n, generator=g)
    b = torch.rand(n, generator=g)
    special = torch.tensor([0.0, 1.0, float("nan"), -0.0, 0.0, 1.0, float("nan"), -0.0])
    k = min(n, len(special))
    a[:k], b[:k] = special[:k], special.flip(0)[:k]
    return a.to(dev), b.to(dev)


def check_tag(args) -> float:
    from kolibrie_tpu_torch.ops import kernels as K

    a, b, op = args
    err = float_err(K.tag_combine(a, b, op), K.tag_combine_plain(a, b, op))
    if err:
        raise AssertionError(f"tag_combine {op} differs from its plain version by {err}")
    return err


def probe_args_random(seed: int, a_count: int, p: int, dev):
    import torch

    g = torch.Generator().manual_seed(seed)

    def ids(n):
        v = torch.randint(0, 6, (n,), generator=g)
        v = torch.where(torch.rand(n, generator=g) < 0.05, 0xFFFFFFFF, v)
        return (v | ((torch.rand(n, generator=g) < 0.1).to(torch.int64) << 31)).to(dev)

    kk = torch.randint(0, 16, (p,), generator=g).to(dev)
    ch = torch.randint(0, a_count, (p,), generator=g).to(dev)
    in_range = (torch.rand(p, generator=g) < 0.8).to(dev)
    sel = [
        (torch.randint(0, 16, (p,), generator=g).to(dev), ids(p), ids(p), ids(p), ids(p))
        for _ in range(a_count)
    ]
    ex = []
    for _ in range(a_count):
        fl = torch.randint(0, 8, (p,), generator=g)
        tl = torch.randint(0, 4, (p,), generator=g)
        dl = torch.randint(0, 4, (p,), generator=g)
        ex.append(
            (
                fl.to(dev),
                (fl + torch.randint(0, 3, (p,), generator=g)).to(dev),
                tl.to(dev),
                (tl + torch.randint(0, 3, (p,), generator=g)).to(dev),
                dl.to(dev),
                (dl + torch.randint(0, 2, (p,), generator=g)).to(dev),
                (torch.rand(p, generator=g) < 0.1).to(dev),
            )
        )
    ok = (torch.rand(p, generator=g) < 0.7).to(dev)
    isb = (torch.rand(p, generator=g) < 0.5).to(dev)
    return (kk, ch, in_range, sel), (ok, isb, ch, ex)


def check_select(args) -> int:
    from kolibrie_tpu_torch.ops import kernels as K

    err = max_abs_err(K.lex_probe_select(*args), K.lex_probe_select_plain(*args))
    if err:
        raise AssertionError(f"lex_probe_select differs from its plain version by {err}")
    return err


def check_validate(args) -> int:
    from kolibrie_tpu_torch.ops import kernels as K

    err = max_abs_err([K.lex_probe_validate(*args)], [K.lex_probe_validate_plain(*args)])
    if err:
        raise AssertionError(f"lex_probe_validate differs from its plain version by {err}")
    return err


# ---------------------------------------------------------------- bounds


def merge_path_bytes(args) -> int:
    """Bytes the merge-path expansion must move for these inputs: the
    compacted rows that feed the ``cap`` output slots (cum, low, lidx:
    24 bytes each) read once, and li, ri (8 bytes) + valid (1 byte) per
    slot written once."""
    import torch

    _lidx, _low, cum, total, _ln, _rn, cap = args
    slots = min(int(total), cap)
    rows = 0
    if slots:
        last = torch.tensor([slots - 1], device=cum.device)
        rows = int(torch.searchsorted(cum, last, right=True)) + 1
    return 24 * rows + 17 * cap


def select_bytes(args) -> int:
    """Per slot: kk, ch (8 B each) + in_range (1 B) read, the chosen
    accessor's nb and its base or delta value (16 B) read, val (8 B) + ok +
    is_base (2 B) written; and the value's predecessor (8 B) for the slots
    that do not start their range."""
    import torch

    kk, ch, _in_range, acc = args
    p = kk.shape[0]
    nb = torch.stack([a[0] for a in acc]).gather(0, ch.unsqueeze(0))[0]
    needs_prev = int(torch.where(kk < nb, kk != 0, kk != nb).sum())
    return p * (8 + 8 + 1 + 16 + 10) + 8 * needs_prev


def validate_bytes(args) -> int:
    """ok read and the mask written (1 B each) for every slot; is_base
    (1 B), ch (8 B) and every accessor's six ranges (48 B) + sent (1 B) only
    for the slots still valid."""
    ok, _isb, _ch, acc = args
    p = ok.shape[0]
    live = int(ok.sum())
    return p * 2 + live * (1 + 8) + live * 49 * len(acc)


def filter_bytes(args) -> int:
    """8 bytes a row of each column an active clause reads (the object
    once, for its constant and its compare), and the 1-byte mask written."""
    s, _p, _o, kw = args
    cols = (kw["s_const"] >= 0) + (kw["p_const"] >= 0) + (
        kw["o_const"] >= 0 or kw["o_op"] >= 0
    )
    return s.shape[0] * (8 * cols + 1)


def tag_bytes(args) -> int:
    """Two f32 inputs read, one f32 output written."""
    return args[0].shape[0] * 12


def merge_join_bytes(args) -> int:
    """Keys and payloads of both sides read once (8 bytes each a row); the
    key, both payloads (8 bytes each) and the valid byte written for every
    output slot."""
    from kolibrie_tpu_torch.ops import kernels as K

    lk, _lv, rk, _rv, cap = args
    return 16 * (lk.shape[0] + rk.shape[0]) + 25 * K._round_out(cap)


def check_random_shapes(dev) -> None:
    for seed in range(3):
        for a in merge_path_args_random(seed, dev):
            check_merge_path(a)
        for a in merge_join_args_random(seed, dev):
            check_merge_join(a)
    for a_count in (1, 2, 3):
        for p in (1, 1000, 300_001):
            sel_args, val_args = probe_args_random(10 * a_count + p % 7, a_count, p, dev)
            check_select(sel_args)
            check_validate(val_args)
    for a in merge_path_edge_args(dev):
        check_merge_path(a)
    for n in FILTER_SIZES:
        for s, p, o, kw in filter_args_random(n % 97, n, dev):
            check_filter((s, p, o, kw))
            check_filter((s[1:], p[1:], o[1:], kw))  # a view off 16-byte alignment
    # the closure's scan size + 3, predicate only
    s, p, o, _kw = filter_args_random(3, FILTER_LARGEST, dev)[0]
    kw = {"s_const": -1, "p_const": FILTER_IDS[1], "o_const": -1, "o_op": -1, "o_cmp": 0}
    check_filter((s, p, o, kw))
    check_filter((s[1:], p[1:], o[1:], kw))
    del s, p, o
    for n in (1, 1000, 300_001):
        a, b = tag_args_random(n % 89, n, dev)
        for op in TAG_OPS:
            check_tag((a, b, op))
            check_tag((a[1:], b[1:], op))


def build_queries(dev) -> list:
    """LUBM-1000 and employee-100K as databases on ``dev``, and the four
    main-path queries over them as ``(name, db, sparql, KOLIBRIE_WCOJ)``.
    Fails unless LUBM-1000 has its 3,785,000 triples."""
    from benches.lubm import LUBM_Q2, LUBM_Q9, generate_fast
    from kolibrie_tpu_torch import SparqlDatabase

    t0 = time.perf_counter()
    lubm = SparqlDatabase(device=dev)
    s, p, o = generate_fast(UNIVERSITIES, lubm.dictionary)
    lubm.store.add_batch(s, p, o)
    emp = SparqlDatabase(device=dev)
    emp.parse_ntriples(employee_ntriples(EMPLOYEES))
    log(f"data: LUBM {len(lubm)} triples, employee {len(emp)} triples, "
        f"{time.perf_counter() - t0:.1f} s")
    if len(lubm) != LUBM_TRIPLES:
        raise AssertionError(f"LUBM-{UNIVERSITIES} has {len(lubm)} triples, "
                             f"expected {LUBM_TRIPLES}")
    return [
        ("employee", emp, EMPLOYEE_QUERY, "auto"),
        ("q2", lubm, LUBM_Q2, "auto"),
        ("q9", lubm, LUBM_Q9, "auto"),
        ("q9_wcoj_off", lubm, LUBM_Q9, "off"),
    ]


def run_main_path(dev, queries: list) -> dict:
    """Run the four queries twice each (cold: capacity convergence; warm:
    capacities cached), recording the largest inputs each kernel wrapper
    receives.  Launch counters are zeroed just before the queries and read
    just after."""
    import torch

    from kolibrie_tpu_torch import execute_query_volcano
    from kolibrie_tpu_torch.ops import kernels as K
    from kolibrie_tpu_torch.optimizer import device_engine as DE

    report = {}
    captured = {}
    capturing = {"on": False}  # record the LUBM Q9 shapes only

    def recorder(name, fn, size):
        def wrapped(*a):
            n = size(a)
            if capturing["on"] and n >= captured.get(name, (0, None))[0]:
                captured[name] = (n, a)
            return fn(*a)

        return wrapped

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    orig = (K.merge_path, DE.lex_probe_select, DE.lex_probe_validate, K._merge_join_core)
    K.merge_path = recorder("merge_path_join", orig[0], lambda a: a[6])
    DE.lex_probe_select = recorder("lex_probe_select", orig[1], lambda a: a[0].shape[0])
    DE.lex_probe_validate = recorder("lex_probe_validate", orig[2], lambda a: a[0].shape[0])
    # the presorted join's keys (after masking), for merge_join's row
    K._merge_join_core = recorder(
        "merge_join_keys", orig[3], lambda a: a[2] if a[3] == "merge_join_indices" else -1
    )
    rows, timings = {}, {}
    K.reset_launches()
    try:
        for name, db, q, wcoj in queries:
            os.environ["KOLIBRIE_WCOJ"] = wcoj
            capturing["on"] = name.startswith("q9")
            ms = []
            for _rep in range(2):  # cold (capacity convergence), then warm
                before = {**K.LAUNCHES, **K.ENTRY_LAUNCHES}
                sync()
                t = time.perf_counter()
                rows[name] = execute_query_volcano(q, db)
                sync()
                ms.append((time.perf_counter() - t) * 1e3)
            after = {**K.LAUNCHES, **K.ENTRY_LAUNCHES}
            warm = {k: after[k] - before[k] for k in before}
            timings[name] = {
                "cold_ms": ms[0], "warm_ms": ms[1], "rows": len(rows[name]),
                "warm_launches": warm,
            }
            log(f"{name}: {len(rows[name])} rows, cold {ms[0]:.1f} ms, "
                f"warm {ms[1]:.1f} ms, warm-run launches {warm}")
    finally:
        K.merge_path, DE.lex_probe_select, DE.lex_probe_validate, K._merge_join_core = orig
        os.environ.pop("KOLIBRIE_WCOJ", None)
    report["launches"] = dict(K.LAUNCHES)
    report["entry_launches"] = dict(K.ENTRY_LAUNCHES)
    report["queries"] = timings
    log(f"launches: {report['launches']} entries: {report['entry_launches']}")
    return {"report": report, "rows": rows, "captured": captured, "queries": queries}


def check_main_path(report: dict) -> None:
    """Row counts of every query, and each query's warm run took its route
    through the kernels (``EXPECTED_LAUNCHES``)."""
    for name, want in EXPECTED_ROWS.items():
        got = report["queries"][name]["rows"]
        if got != want:
            raise AssertionError(f"{name}: {got} rows, expected {want}")
    for name, need in EXPECTED_LAUNCHES.items():
        warm = report["queries"][name]["warm_launches"]
        for k, n in need.items():
            if warm[k] < n:
                raise AssertionError(
                    f"{name}: {k} launched {warm[k]} times in the warm run, "
                    f"expected at least {n}"
                )
    counts = {**report["launches"], **report["entry_launches"]}
    for k in MAIN_PATH_KERNELS:
        if counts[k] <= 0:
            raise AssertionError(f"{k} never reached its kernel on the main path")


def cpu_twin(db):
    """The port on the CPU holding ``db``'s state (IDs included)."""
    from kolibrie_tpu_torch import SparqlDatabase

    return SparqlDatabase.from_arrays(
        db.dictionary.id_to_str, *db.store.columns(), quoted=dict(db.quoted.items()),
        device="cpu",
    )


def compare_with_cpu(main_path: dict) -> dict:
    """Run the same queries through the port on the CPU (the kernels'
    plain versions) and require identical rows.  Returns the CPU twins by
    ``id`` of the card database."""
    from kolibrie_tpu_torch import execute_query_volcano

    t0 = time.perf_counter()
    cpu_dbs = {}
    for name, db, q, wcoj in main_path["queries"]:
        if id(db) not in cpu_dbs:
            cpu_dbs[id(db)] = cpu_twin(db)
        os.environ["KOLIBRIE_WCOJ"] = wcoj
        try:
            cpu = execute_query_volcano(q, cpu_dbs[id(db)])
        finally:
            os.environ.pop("KOLIBRIE_WCOJ", None)
        if cpu != main_path["rows"][name]:
            raise AssertionError(f"{name}: card rows differ from the CPU run")
    log(f"main path: rows equal the CPU run ({time.perf_counter() - t0:.1f} s)")
    return cpu_dbs


# ------------------------------------------------------- SELECT surface


def surface_databases(dev, queries) -> dict:
    """Phase 4b's databases: phase 4's LUBM and employee databases, and a
    copy of the LUBM columns with one advisor annotation per graduate
    student (phase 4's database keeps its triples)."""
    from kolibrie_tpu_torch import SparqlDatabase

    by_name = {name: db for name, db, _q, _w in queries}
    lubm = by_name["q2"]
    t0 = time.perf_counter()
    quoted = SparqlDatabase.from_arrays(lubm.dictionary.id_to_str, *lubm.store.columns(), device=dev)
    n = annotate_advisors(quoted)
    log(f"quoted database: {n} annotations, {len(quoted)} triples, "
        f"{time.perf_counter() - t0:.1f} s")
    if n != LUBM_GRAD_STUDENTS or len(lubm) != LUBM_TRIPLES:
        raise AssertionError(f"{n} annotations, LUBM at {len(lubm)} triples")
    return {"lubm": lubm, "quoted": quoted, "employee": by_name["employee"]}


def run_select_surface(dev, dbs: dict) -> dict:
    """Phase 4b: each SELECT-surface query cold and then warm through
    ``execute_query_volcano`` on the card, the route and the warm run's
    launches recorded.  Launch counters are zeroed just before the queries
    and read just after."""
    import torch

    from kolibrie_tpu_torch import execute_query_volcano
    from kolibrie_tpu_torch.ops import kernels as K

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    report, rows = {}, {}
    K.reset_launches()
    for name, (which, q) in SURFACE_QUERIES.items():
        ms, routes = [], []
        for _rep in range(2):  # cold (capacity convergence), then warm
            before = {**K.LAUNCHES, **K.ENTRY_LAUNCHES}
            sync()
            t = time.perf_counter()
            with RouteSpy() as spy:
                rows[name] = execute_query_volcano(SURFACE_PREFIXES + q, dbs[which])
            sync()
            ms.append((time.perf_counter() - t) * 1e3)
            routes.append(spy.route())
        after = {**K.LAUNCHES, **K.ENTRY_LAUNCHES}
        warm = {k: after[k] - before[k] for k in before}
        report[name] = {
            "cold_ms": ms[0], "warm_ms": ms[1], "rows": len(rows[name]), "routes": routes,
            "warm_launches": warm,
        }
        log(f"{name}: {len(rows[name])} rows, cold {ms[0]:.1f} ms, warm {ms[1]:.1f} ms, "
            f"route {routes}, warm-run launches {warm}")
    launches = {**K.LAUNCHES, **K.ENTRY_LAUNCHES}
    log(f"select surface launches: {launches}")
    return {"queries": report, "rows": rows, "launches": launches}


def check_select_surface(surface: dict, expected: dict) -> None:
    """Counts, the route of both runs and the warm run's launches of every
    phase-4b query."""
    for name, want in expected.items():
        rep, rows = surface["queries"][name], surface["rows"][name]
        if rep["rows"] != want["rows"]:
            raise AssertionError(f"{name}: {rep['rows']} rows, expected {want['rows']}")
        if "y_bound" in want and sum(1 for r in rows if r[2]) != want["y_bound"]:
            raise AssertionError(f"{name}: ?y bound in {sum(1 for r in rows if r[2])} rows")
        if "each" in want and {int(r[1]) for r in rows} != {want["each"]}:
            raise AssertionError(f"{name}: group sizes {sorted({r[1] for r in rows})}")
        if "sum" in want and sum(int(r[1]) for r in rows) != want["sum"]:
            raise AssertionError(f"{name}: group sizes sum to {sum(int(r[1]) for r in rows)}")
        if set(rep["routes"]) != {SURFACE_ROUTES[name]}:
            raise AssertionError(f"{name}: routes {rep['routes']}, expected {SURFACE_ROUTES[name]}")
        for k, n in SURFACE_LAUNCHES[name].items():
            if rep["warm_launches"][k] < n:
                raise AssertionError(f"{name}: {k} launched {rep['warm_launches'][k]} times "
                                     f"in the warm run, expected at least {n}")


def compare_surface_with_cpu(surface: dict, dbs: dict, cpu_dbs: dict) -> None:
    """The phase-4b queries through the port on the CPU: rows equal the
    card's (emp_agg's SUM/AVG too: the salaries are integer-valued, so
    every summation order is exact), the same route, and a plan whose
    launches are the ``SURFACE_LAUNCHES`` table."""
    from kolibrie_tpu_torch import execute_query_volcano

    t0 = time.perf_counter()
    twins = {which: cpu_dbs.get(id(db)) or cpu_twin(db) for which, db in dbs.items()}
    for name, (which, q) in SURFACE_QUERIES.items():
        with RouteSpy() as spy:
            cpu = execute_query_volcano(SURFACE_PREFIXES + q, twins[which])
        if cpu != surface["rows"][name]:
            raise AssertionError(f"{name}: card rows differ from the CPU run")
        if spy.route() != SURFACE_ROUTES[name]:
            raise AssertionError(f"{name}: the CPU run took route {spy.route()}")
        if spy.launches() != SURFACE_LAUNCHES[name]:
            raise AssertionError(f"{name}: the CPU lowering launches {spy.launches()}, "
                                 f"the table says {SURFACE_LAUNCHES[name]}")
    log(f"select surface: rows, routes and plans equal the CPU run "
        f"({time.perf_counter() - t0:.1f} s)")


# --------------------------------------------------------------- reasoner


def add_lubm_closure_rules(r) -> None:
    """The closure of ``benches/bench_lubm.py``: transitive
    ``subOrganizationOf`` and ``memberOf`` lifted along it."""
    from benches.lubm import UB

    sub, mem = UB + "subOrganizationOf", UB + "memberOf"
    r.add_rule(r.rule_from_strings([("?a", sub, "?b"), ("?b", sub, "?c")], [("?a", sub, "?c")]))
    r.add_rule(r.rule_from_strings([("?x", mem, "?d"), ("?d", sub, "?u")], [("?x", mem, "?u")]))


def same_facts(a, b) -> bool:
    """Two reasoners hold the same fact set (compacted columns are sorted
    and deduplicated)."""
    import numpy as np

    return all(np.array_equal(x, y) for x, y in zip(a.facts.columns(), b.facts.columns()))


def run_closure(dev, lubm) -> dict:
    """Phase 6: the LUBM-1000 closure through the reasoner's public entry,
    cold and then warm, each on a fresh reasoner over the same columns,
    with the launch counters zeroed just before each run and read just
    after.  A third, untimed run records the largest inputs the fused
    filter and the merge-path kernel received (a record inside a timed run
    would hold them on the card through that run's peak-memory reading)."""
    import torch

    from kolibrie_tpu_torch import Reasoner
    from kolibrie_tpu_torch.ops import kernels as K
    from kolibrie_tpu_torch.reasoner import device_fixpoint as FX

    s, p, o = lubm.store.columns()

    def fresh():
        r = Reasoner(lubm.dictionary, device=dev)
        r.facts.add_batch(s, p, o)
        add_lubm_closure_rules(r)
        len(r.facts)  # compact on the host before the clock starts
        return r

    fixpoints = []
    orig_infer = FX.DeviceFixpoint.infer

    def infer_rec(self, *a, **k):
        out = orig_infer(self, *a, **k)
        # not the DeviceFixpoint itself, which holds its output columns
        fixpoints.append((self.last_rounds, vars(self.converged_caps)))
        return out

    runs = {}
    FX.DeviceFixpoint.infer = infer_rec
    try:
        for label in ("cold", "warm"):
            r = fresh()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            K.reset_launches()
            t = time.perf_counter()
            derived = r.infer_new_facts_semi_naive_parallel()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            launches = {**K.LAUNCHES, **K.ENTRY_LAUNCHES}
            if len(fixpoints) != len(runs) + 1:
                raise AssertionError(f"{label} closure did not take the device fixpoint")
            rounds, caps = fixpoints[-1]
            runs[label] = {
                "derived": derived, "ms": ms, "rounds": rounds, "caps": caps,
                "peak_bytes": torch.cuda.max_memory_allocated(), "launches": launches,
            }
            log(f"closure {label}: {derived} derived, {ms:.1f} ms, {rounds} rounds, "
                f"caps {caps}, peak device memory {runs[label]['peak_bytes']} B, "
                f"launches {launches}")
    finally:
        FX.DeviceFixpoint.infer = orig_infer
    for label, run in runs.items():
        if run["derived"] != CLOSURE_DERIVED:
            raise AssertionError(f"closure {label}: {run['derived']} derived, "
                                 f"expected {CLOSURE_DERIVED}")
    for k, n in CLOSURE_LAUNCHES.items():
        if runs["warm"]["launches"][k] < n:
            raise AssertionError(f"closure warm run launched {k} "
                                 f"{runs['warm']['launches'][k]} times, expected >= {n}")
    t0 = time.perf_counter()
    host = fresh()
    host.infer_new_facts_semi_naive()
    if not same_facts(host, r):
        raise AssertionError("closure: the card's fact set differs from the host strategy's")
    log(f"closure: fact set equals the host strategy's ({time.perf_counter() - t0:.1f} s)")
    del host, r
    return {"runs": runs, "captured": record_closure_inputs(fresh)}


def filter_recorder(captured: dict, fn):
    """``fn`` (the fixpoint's ``filter_mask``) keeping in ``captured`` the
    call with the most rows, as phase 5's arguments (no readback)."""

    def wrapped(s_, p_, o_, s_c, p_c, o_c):
        if s_.shape[0] > captured.get("filter_mask", (0, None))[0]:
            kw = {"s_const": s_c, "p_const": p_c, "o_const": o_c, "o_op": -1, "o_cmp": 0}
            captured["filter_mask"] = (s_.shape[0], (s_, p_, o_, kw))
        return fn(s_, p_, o_, s_c, p_c, o_c)

    return wrapped


def record_closure_inputs(fresh) -> dict:
    """One more closure run on ``fresh()``, recording the largest fact scan
    the fused filter received and the merge-path call with the most output
    slots, then matches, then left rows: the inputs phase 5 times the
    kernels on.  Reading each call's match count syncs, so this run is not
    timed."""
    from kolibrie_tpu_torch.ops import kernels as K
    from kolibrie_tpu_torch.reasoner import device_fixpoint as FX

    captured = {}
    orig = (FX.filter_mask, K.merge_path)

    def merge_rec(*a):
        key = (a[6], int(a[3]), a[4])
        if key > captured.get("merge_path_join", ((0, 0, 0), None))[0]:
            captured["merge_path_join"] = (key, a)
        return orig[1](*a)

    FX.filter_mask, K.merge_path = filter_recorder(captured, orig[0]), merge_rec
    try:
        derived = fresh().infer_new_facts_semi_naive_parallel()
    finally:
        FX.filter_mask, K.merge_path = orig
    if derived != CLOSURE_DERIVED:
        raise AssertionError(f"closure record run: {derived} derived")
    log(f"closure inputs: filter scan {captured['filter_mask'][0]} rows, merge path "
        f"(slots, matches, left rows) {captured['merge_path_join'][0]}")
    return captured


def small_closure_reasoner(dev):
    """LUBM at a few universities, an age literal for every graduate
    student, and rules the LUBM closure does not reach: a negated premise,
    a numeric filter and a three-premise join (beside the memberOf lift)."""
    import numpy as np

    from benches.lubm import RDF_TYPE, UB, generate_fast
    from kolibrie_tpu_torch import Reasoner
    from kolibrie_tpu_torch.core.rule import FilterCondition

    r = Reasoner(device=dev)
    enc = r.dictionary.encode
    s, p, o = generate_fast(SMALL_UNIVERSITIES, r.dictionary)
    r.facts.add_batch(s, p, o)
    grads = s[(p == enc(RDF_TYPE)) & (o == enc(UB + "GraduateStudent"))]
    ages = np.array([enc(f'"{22 + i % 13}"') for i in range(len(grads))], np.uint32)
    r.facts.add_batch(grads, np.full(len(grads), enc(UB + "age"), np.uint32), ages)
    add_lubm_closure_rules(r)
    ub = {k: UB + k for k in ("memberOf", "advisor", "teacherOf", "takesCourse", "age")}
    r.add_rule(r.rule_from_strings(
        [("?x", ub["memberOf"], "?d")], [("?x", UB + "undergraduateMemberOf", "?d")],
        negative=[("?x", RDF_TYPE, UB + "GraduateStudent")]))
    r.add_rule(r.rule_from_strings(
        [("?x", ub["age"], "?a")], [("?x", RDF_TYPE, UB + "SeniorStudent")],
        filters=[FilterCondition("a", ">", 28.0)]))
    r.add_rule(r.rule_from_strings(
        [("?x", ub["advisor"], "?f"), ("?f", ub["teacherOf"], "?c"),
         ("?x", ub["takesCourse"], "?c")],
        [("?x", UB + "takesAdvisorCourse", "?c")]))
    return r


def run_small_closure(dev) -> None:
    """Phase 6b: the small closure on the card and on the CPU through both
    entries; padded output columns, counts, rounds and capacities equal."""
    import torch

    from kolibrie_tpu_torch.reasoner.device_fixpoint import DeviceFixpoint

    cpu = torch.device("cpu")
    for entry, kw in (("infer", {}), ("infer_chunked", {"chunk_rows": 1024})):
        got = {}
        for d in (dev, cpu):
            fx = DeviceFixpoint(small_closure_reasoner(d))
            derived = getattr(fx, entry)(**kw)
            fs, fp, fo, n, _n0 = fx._last_state
            got[d.type] = (derived, n, fx.last_rounds, vars(fx.converged_caps),
                           [c[:n].cpu() for c in (fs, fp, fo)])
        card, host = got[dev.type], got["cpu"]
        if card[:4] != host[:4]:
            raise AssertionError(f"small closure {entry}: card {card[:4]} vs CPU {host[:4]}")
        if not all(torch.equal(a, b) for a, b in zip(card[4], host[4])):
            raise AssertionError(f"small closure {entry}: padded columns differ from the CPU run")
        if card[0] <= 0:
            raise AssertionError(f"small closure {entry}: nothing derived")
        log(f"small closure {entry}: {card[0]} derived, {card[2]} rounds, caps {card[3]}, "
            f"columns equal the CPU run row for row")
    r_card, r_host = small_closure_reasoner(dev), small_closure_reasoner(cpu)
    derived = r_card.infer_new_facts_device()
    r_host.infer_new_facts_semi_naive()
    if derived != got["cpu"][0] or not same_facts(r_card, r_host):
        raise AssertionError("small closure: infer_new_facts_device differs from the host strategy")


def run_ops_entries(dev, lubm, q9_off_keys) -> dict:
    """Phase 6c: the ops API's kernel entries, counters zeroed just before
    and read just after.  Returns per-entry launches and the inputs phase 5
    times them on."""
    import torch

    import kolibrie_tpu_torch.ops as ops
    from benches.lubm import RDF_TYPE, UB
    from kolibrie_tpu_torch.ops import kernels as K

    enc = lubm.dictionary.encode
    s, p, o = (torch.from_numpy(c.astype("int64")).to(dev) for c in lubm.store.columns())
    lk, rk, cap, _entry = q9_off_keys
    lval = torch.arange(lk.shape[0], device=dev)
    rval = torch.arange(rk.shape[0], device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    a = torch.rand(TAG_ROWS, generator=g, device=dev)
    b = torch.rand(TAG_ROWS, generator=g, device=dev)

    K.reset_launches()
    grads = ops.filter_mask(s, p, o, p_const=enc(RDF_TYPE), o_const=enc(UB + "GraduateStudent"))
    key, lv, rv, valid, total = ops.merge_join(lk, lval, rk, rval, cap)
    tags, tag_launches = {}, {}
    for op in TAG_OPS:
        before = K.LAUNCHES["tag_combine"]
        tags[op] = ops.tag_combine(a, b, op)
        tag_launches[op] = K.LAUNCHES["tag_combine"] - before
    torch.cuda.synchronize()
    launches = {**K.LAUNCHES, **K.ENTRY_LAUNCHES}

    if int(grads.sum()) != LUBM_GRAD_STUDENTS:
        raise AssertionError(f"filter_mask: {int(grads.sum())} graduate students")
    li, ri, v2, t2 = K.merge_join_indices(lk, rk, cap)
    want = (torch.where(v2, lk[li], 0), torch.where(v2, li, 0), torch.where(v2, ri, 0), v2, t2)
    if max_abs_err((key, lv, rv, valid, total), want):
        raise AssertionError("merge_join disagrees with merge_join_indices")
    for op in TAG_OPS:
        if float_err(tags[op], K.tag_combine_plain(a, b, op)):
            raise AssertionError(f"tag_combine {op} disagrees with its plain version")
    for k in OPS_ENTRY_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"ops.{k} never reached its kernel")
    log(f"ops entries: {int(grads.sum())} graduate students, merge_join {int(total)} "
        f"matches, launches {launches}")
    return {
        "launches": launches,
        "tag_launches": tag_launches,
        "merge_join": (lk, lval, rk, rval, cap),
        "tags": (a, b),
    }


# ------------------------------------------------------------------- RSP


def rsp_stream(persons: int, per_tick: int, ticks: int, seed: int) -> list:
    """Phase 7's stream: ``per_tick`` ``knows`` events at each tick 1 ..
    ``ticks``, between persons drawn uniformly from ``persons`` with
    ``numpy.random.default_rng(seed)``.  Returns ``(ts, WindowTriple)``
    pairs."""
    import numpy as np

    from kolibrie_tpu_torch import WindowTriple

    rng = np.random.default_rng(seed)
    n = per_tick * ticks
    i = rng.integers(0, persons, n).tolist()
    j = rng.integers(0, persons, n).tolist()
    knows = "<http://city/knows>"
    return [
        (1 + k // per_tick, WindowTriple(f"<http://city/p{a}>", knows, f"<http://city/p{b}>"))
        for k, (a, b) in enumerate(zip(i, j))
    ]


def rsp_prefix(stream: list, ticks: int) -> list:
    """The events of ``stream`` at ticks 1 .. ``ticks``."""
    return [e for e in stream if e[0] <= ticks]


def run_rsp(dev, mode: str, stream: list, around_firing=None) -> dict:
    """Drive ``stream`` through ``RSPBuilder(RSP_QUERY).add_rules(RSP_RULES)
    .set_r2r_mode(mode)`` on ``dev``, recording per firing: the window's
    content size, the wall ms of the whole firing (the window processor),
    the R2R's maintenance ms and fixpoint ms (device mode; synchronised),
    the fixpoint's rounds and capacities, the query ms, the derived count,
    the emitted rows and the kernel launches.  ``around_firing(k, fn)``, if
    given, runs firing ``k`` (default: ``fn()``).  Launch counters are
    zeroed just before the stream and read just after; the largest inputs
    the merge-path kernel and the fused filter received are kept (as
    references, no readback) for phase 5."""
    import torch

    from kolibrie_tpu_torch import RSPBuilder
    from kolibrie_tpu_torch.ops import kernels as K
    from kolibrie_tpu_torch.reasoner import device_fixpoint as FX

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    firings: list = []
    engine = (
        RSPBuilder(RSP_QUERY, device=dev)
        .add_rules(RSP_RULES)
        .set_r2r_mode(mode)
        .with_consumer(lambda row: firings[-1]["rows"].append(row))
        .build()
    )
    r2r = engine.r2r

    def timed(key, fn):
        def wrapped(*a, **k):
            sync()
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                sync()
                rec = firings[-1]
                rec[key] = rec.get(key, 0.0) + (time.perf_counter() - t) * 1e3

        return wrapped

    def counted_materialize():
        derived = materialize()
        firings[-1]["derived"] = len(derived)
        return derived

    materialize = timed("r2r_ms", r2r.materialize)
    r2r.materialize = counted_materialize
    r2r.execute_query = timed("query_ms", r2r.execute_query)
    if mode == "device":
        r2r._apply_delta = timed("maintain_ms", r2r._apply_delta)
        r2r._rebuild_mirror = timed("maintain_ms", r2r._rebuild_mirror)
    window = engine.windows[0].window
    processor = window.call_back

    def firing(content):
        k = len(firings)
        firings.append({"content": len(content), "rows": []})
        before = {**K.LAUNCHES, **K.ENTRY_LAUNCHES}
        sync()
        t = time.perf_counter()
        if around_firing is None:
            processor(content)
        else:
            around_firing(k, lambda: processor(content))
        sync()
        rec = firings[-1]
        rec["wall_ms"] = (time.perf_counter() - t) * 1e3
        after = {**K.LAUNCHES, **K.ENTRY_LAUNCHES}
        rec["launches"] = {k2: after[k2] - before[k2] for k2 in before if after[k2] > before[k2]}

    window.call_back = firing

    captured = {}
    orig = (FX.DeviceFixpoint.infer_padded, FX.filter_mask, K.merge_path)

    def infer_rec(self, *a, **k):
        out = timed("fixpoint_ms", orig[0])(self, *a, **k)
        firings[-1]["rounds"], firings[-1]["caps"] = self.last_rounds, vars(out[4])
        return out

    def merge_rec(*a):
        key = (a[6], a[4])  # output slots, left rows: host ints, no readback
        if key > captured.get("merge_path_join", ((0, 0), None))[0]:
            captured["merge_path_join"] = (key, a)
        return orig[2](*a)

    FX.DeviceFixpoint.infer_padded, K.merge_path = infer_rec, merge_rec
    FX.filter_mask = filter_recorder(captured, orig[1])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    try:
        t0 = time.perf_counter()
        for ts, item in stream:
            engine.add_to_stream(RSP_STREAM, item, ts)
        sync()
        wall_s = time.perf_counter() - t0
    finally:
        FX.DeviceFixpoint.infer_padded, FX.filter_mask, K.merge_path = orig
        engine.stop()
    launches = {**K.LAUNCHES, **K.ENTRY_LAUNCHES}
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    for k, rec in enumerate(firings):
        rec["rows"] = sorted(rec["rows"])
        log(f"rsp {mode} firing {k}: content {rec['content']}, derived {rec.get('derived')}, "
            f"rows {len(rec['rows'])}, wall {rec['wall_ms']:.1f} ms (r2r {rec.get('r2r_ms', 0):.1f}: "
            f"maintenance {rec.get('maintain_ms', 0):.1f}, fixpoint {rec.get('fixpoint_ms', 0):.1f} "
            f"in {rec.get('rounds')} rounds, caps {rec.get('caps')}; query "
            f"{rec.get('query_ms', 0):.1f}), launches {rec['launches']}")
    log(f"rsp {mode}: {len(stream)} events in {wall_s:.2f} s = {len(stream) / wall_s:.1f} "
        f"events/s, {len(firings)} firings, peak device memory {peak} B, launches {launches}")
    return {
        "firings": firings,
        "wall_s": wall_s,
        "events_per_s": len(stream) / wall_s,
        "peak_bytes": peak,
        "launches": launches,
        "captured": captured,
        "device_ok": getattr(r2r, "_device_ok", None),
        "dead_letters": engine.dead_letters,
    }


def check_rsp(card: dict, host: dict, full_window: int, launches: dict, cpu: dict) -> None:
    """Phase 7's gates: the device R2R took the device route throughout and
    dead-lettered nothing; at least ``RSP_FULL_FIRINGS`` firings held a full
    window (``full_window`` distinct triples or more, less 1% for repeated
    draws); every firing's rows and derived count equal the host R2R's, the
    first firings equal the CPU run's over a prefix of the stream (``cpu``:
    at least two firings, one at full width), and the rows total more than
    0; every warm firing launched ``launches``."""
    if card["device_ok"] is not True:
        raise AssertionError("rsp: the device R2R left the device route")
    for run in (card, host, cpu):
        if run["dead_letters"]:
            raise AssertionError(f"rsp: dead-lettered firings {run['dead_letters']}")
    full = sum(1 for f in card["firings"] if f["content"] >= 0.99 * full_window)
    if full < RSP_FULL_FIRINGS:
        raise AssertionError(f"rsp: {full} full-width firings, expected {RSP_FULL_FIRINGS}")
    if len(card["firings"]) != len(host["firings"]):
        raise AssertionError("rsp: the card and host runs fired a different number of times")
    if not 2 <= len(cpu["firings"]) <= len(card["firings"]):
        raise AssertionError(f"rsp: the CPU oracle fired {len(cpu['firings'])} times")
    if max(f["content"] for f in cpu["firings"]) < 0.99 * full_window:
        raise AssertionError("rsp: the CPU oracle held no full-width firing")
    for oracle, run in (("host", host), ("cpu", cpu)):
        for k, (c, h) in enumerate(zip(card["firings"], run["firings"])):
            if c["rows"] != h["rows"] or c["derived"] != h["derived"]:
                raise AssertionError(f"rsp firing {k}: card {len(c['rows'])} rows / {c['derived']} "
                                     f"derived, {oracle} {len(h['rows'])} / {h['derived']}")
    total = sum(len(f["rows"]) for f in card["firings"])
    if total <= 0:
        raise AssertionError("rsp: no rows emitted")
    for k, f in enumerate(card["firings"][1:], start=1):
        for name, n in launches.items():
            if f["launches"].get(name, 0) < n:
                raise AssertionError(f"rsp firing {k} launched {name} "
                                     f"{f['launches'].get(name, 0)} times, expected >= {n}")
    log(f"rsp: {len(card['firings'])} firings ({full} full width), {total} rows, "
        f"rows and derived counts equal the host R2R's firing by firing and the "
        f"CPU run's in the first {len(cpu['firings'])}")


def run_rsp_phase(dev) -> dict:
    """Phase 7: the RSP engine at a 120,000-triple window, device R2R on the
    card against the host R2R (also on the card's engine) as its oracle,
    and against the port's CPU run over the stream's first
    ``RSP_CPU_TICKS`` ticks."""
    import torch

    stream = rsp_stream(RSP_PERSONS, RSP_EVENTS_PER_TICK, RSP_TICKS, RSP_SEED)
    card = run_rsp(dev, "device", stream)
    host = run_rsp(dev, "host", stream)
    cpu = run_rsp(torch.device("cpu"), "host", rsp_prefix(stream, RSP_CPU_TICKS))
    launches = RSP_LAUNCHES if dev.type == "cuda" else {}
    check_rsp(card, host, RSP_WIDTH * RSP_EVENTS_PER_TICK, launches, cpu)
    return card


# --------------------------------------- statements and host-engine shapes


def data_statement(n: int, verb: str) -> str:
    """``INSERT DATA`` / ``DELETE DATA`` of ``n`` note triples."""
    body = " ".join(f'<http://phase8.example/item{i}> <{NOTE}> "note {i}" .' for i in range(n))
    return f"{verb} {{ {body} }}"


def first_count(rows) -> int:
    return int(rows[0][0]) if rows else 0


class StepTimer:
    """Host-clock ms spent inside the wrapped callables, synchronised on
    the card: ``{key: ms}``.  ``only`` restricts a method's timing to one
    instance."""

    def __init__(self, dev, specs):
        self.specs, self.dev, self.ms = specs, dev, {}

    def __enter__(self):
        import torch

        sync = torch.cuda.synchronize if self.dev.type == "cuda" else (lambda: None)
        self._saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _k, _o in self.specs]
        for (owner, attr, fn), (_o, _a, key, only) in zip(self._saved, self.specs):

            def wrapped(*a, _fn=fn, _key=key, _only=only, **k):
                if _only is not None and (not a or a[0] is not _only):
                    return _fn(*a, **k)
                sync()
                t = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    sync()
                    self.ms[_key] = self.ms.get(_key, 0.0) + (time.perf_counter() - t) * 1e3

            setattr(owner, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in self._saved:
            setattr(owner, attr, fn)
        return False


def run_statements(dev, db, twin: bool = False) -> dict:
    """Phase 8 on ``db`` (a database of its own, so no other phase sees the
    writes).  The host engine's shapes (``HOST_QUERIES``) through
    ``execute_query_volcano`` and ``NAIVE_QUERY`` through ``execute_query``,
    each cold then warm; then the statements: RULE, the University0 members,
    DELETE … WHERE, the RULE and the DELETE once more (warm), INSERT DATA and
    DELETE DATA, with counts between them.  Launch counters are zeroed just
    before each run and read just after (on the CPU, the kernel wrappers'
    calls).  ``twin``: the oracle run on the CPU: one run of each, and the
    RULE's closure by the host strategy."""
    import torch

    from benches.lubm import LUBM_Q2
    from kolibrie_tpu_torch import Reasoner, execute_query, execute_query_volcano
    from kolibrie_tpu_torch.core.store import ColumnarTripleStore
    from kolibrie_tpu_torch.ops import kernels as K
    from kolibrie_tpu_torch.reasoner import device_fixpoint as FX

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    reps = 1 if twin else 2
    out = {"queries": {}, "statements": {}, "rows": {}, "counts": {}, "launches": {},
           "captured": {}, "peaks_above": []}
    captured = out["captured"]
    rounds = []

    def merge_rec(fn):
        def wrapped(*a):  # the call with the most slots, then left rows (no readback)
            if (a[6], a[4]) > captured.get("merge_path_join", ((0, 0), None))[0]:
                captured["merge_path_join"] = ((a[6], a[4]), a)
            return fn(*a)

        return wrapped

    def one(fn, capturing=False):
        """(result, ms, route, launches) of one run; ``capturing`` keeps the
        largest merge-path and filter calls as phase 5's inputs."""
        saved = (K.merge_path, FX.filter_mask, FX.DeviceFixpoint.infer)
        orig_infer = FX.DeviceFixpoint.infer

        def infer_rec(self, *a, **k):
            res = orig_infer(self, *a, **k)
            rounds.append(self.last_rounds)
            return res

        FX.DeviceFixpoint.infer = infer_rec
        if capturing and on_card:
            K.merge_path = merge_rec(saved[0])
            FX.filter_mask = filter_recorder(captured, saved[1])
        K.reset_launches()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        try:
            with RouteSpy() as spy, KernelCalls() as calls:
                sync()
                t = time.perf_counter()
                res = fn()
                sync()
                ms = (time.perf_counter() - t) * 1e3
        finally:
            K.merge_path, FX.filter_mask, FX.DeviceFixpoint.infer = saved
        counters = {k: v for k, v in {**K.LAUNCHES, **K.ENTRY_LAUNCHES}.items() if v}
        launches = counters if on_card else dict(calls.counts)
        for k, n in launches.items():
            out["launches"][k] = out["launches"].get(k, 0) + n
        if on_card:  # the run's peak device memory above what was held before it
            peak = torch.cuda.max_memory_allocated()
            out["peak_bytes"] = max(out.get("peak_bytes", 0), peak)
            out["peaks_above"].append(peak - held)
        return res, ms, spy.route(), launches

    def select(q):
        return execute_query_volcano(SURFACE_PREFIXES + q, db)

    # ---- A1: the host engine's shapes, and the legacy textual join order
    named = [(name, lambda q=q: select(q)) for name, q in HOST_QUERIES.items()]
    named.append(("naive", lambda: execute_query(SURFACE_PREFIXES + NAIVE_QUERY, db)))
    for name, fn in named:
        runs = [one(fn) for _ in range(reps)]
        out["rows"][name] = runs[-1][0]
        out["queries"][name] = {
            "cold_ms": runs[0][1], "warm_ms": runs[-1][1], "rows": len(runs[-1][0]),
            "routes": [r[2] for r in runs], "warm_launches": runs[-1][3],
            "warm_peak_above_bytes": out["peaks_above"][-1] if on_card else None,
        }
        log(f"{name}: {len(runs[-1][0])} rows, cold {runs[0][1]:.1f} ms, warm {runs[-1][1]:.1f} ms, "
            f"routes {out['queries'][name]['routes']}, warm-run launches {runs[-1][3]}, "
            f"peak device memory above the held {out['queries'][name]['warm_peak_above_bytes']} B")
    out["rows"]["naive_volcano"] = select(NAIVE_QUERY)

    # ---- A2: the statements
    def count(q) -> int:
        return first_count(select(q))

    counts = out["counts"]
    counts["univ_members_before"] = count(UNIV_MEMBERS)
    saved_min = Reasoner._DEVICE_AUTO_MIN_FACTS
    if twin:
        Reasoner._DEVICE_AUTO_MIN_FACTS = 1 << 62  # the host strategy: the oracle
    try:
        for label in ("cold", "warm")[:reps]:
            n0 = len(db)
            del rounds[:]
            specs = [(Reasoner, "infer_new_facts_semi_naive_parallel", "closure_ms", None),
                     (ColumnarTripleStore, "compact", "compaction_ms", db.store)]
            with StepTimer(dev, specs) as steps:
                # the RULE's wall ends with the store compacted
                _r, ms, _route, launches = one(
                    lambda: (select(RULE_STATEMENT), len(db)), capturing=label == "cold")
            inserted = len(db) - n0
            rec = {"ms": ms, "inserted": inserted, "rounds": list(rounds), "launches": launches,
                   **steps.ms}
            rec["write_back_ms"] = ms - rec.get("closure_ms", 0.0) - rec.get("compaction_ms", 0.0)
            out["statements"][f"rule_{label}"] = rec
            if label == "cold":
                out["after_rule"] = tuple(c.copy() for c in db.store.columns())
                out["rows"]["univ0_members"] = select(UNIV0_MEMBERS)
            counts[f"univ_members_after_rule_{label}"] = count(UNIV_MEMBERS)
            n1 = len(db)
            with StepTimer(dev, [(ColumnarTripleStore, "compact", "compaction_ms", db.store)]) as st:
                _r, ms, _route, launches = one(lambda: (select(DELETE_STATEMENT), len(db)))
            out["statements"][f"delete_{label}"] = {
                "ms": ms, "removed": n1 - len(db), "launches": launches, **st.ms}
            counts[f"univ_members_after_delete_{label}"] = count(UNIV_MEMBERS)
            log(f"RULE {label}: {inserted} inserted, {rec}; DELETE {label}: "
                f"{out['statements'][f'delete_{label}']}")
    finally:
        Reasoner._DEVICE_AUTO_MIN_FACTS = saved_min
    out["rows"]["q2_after_delete"] = execute_query_volcano(LUBM_Q2, db)
    counts["notes_before"], counts["len_before"] = count(NOTE_COUNT), len(db)
    for verb in ("INSERT DATA", "DELETE DATA"):
        text = SURFACE_PREFIXES + data_statement(DATA_TRIPLES, verb)
        _r, ms, _route, _l = one(lambda: (execute_query_volcano(text, db), len(db)))
        key = verb.split()[0].lower()
        out["statements"][f"{key}_data"] = {"ms": ms}
        counts[f"notes_after_{key}"], counts[f"len_after_{key}"] = count(NOTE_COUNT), len(db)
    log(f"phase 8 counts {counts}; launches {out['launches']}")
    return out


def check_statements(card: dict, twin: dict, universities: int, q2_rows: int, on_card: bool) -> None:
    """Phase 8's checks: rows, routes and warm-run launches of the host
    engine's shapes; the RULE's inserted facts (both runs) and the store
    after it equal to the CPU run's (the host strategy); the counts around
    the DELETE and the data statements equal to the CPU run's."""
    import numpy as np

    want = host_expected(universities)
    for name, rep in card["queries"].items():
        rows, route = card["rows"][name], "naive" if name == "naive" else "host"
        if rows != twin["rows"][name]:
            raise AssertionError(f"{name}: rows differ from the CPU run")
        got = rows if isinstance(want[name], list) else len(rows)
        if got != want[name]:
            raise AssertionError(f"{name}: {got}, expected {want[name]}")
        if set(rep["routes"]) != {route} or twin["queries"][name]["routes"] != [route]:
            raise AssertionError(f"{name}: routes {rep['routes']}, expected {route}")
        if rep["warm_launches"] != HOST_LAUNCHES[name]:
            raise AssertionError(f"{name}: warm-run launches {rep['warm_launches']}, "
                                 f"the table says {HOST_LAUNCHES[name]}")
    if card["rows"]["naive"] != card["rows"]["naive_volcano"]:
        raise AssertionError("execute_query's rows differ from execute_query_volcano's")
    members = 640 * universities
    for label in ("cold", "warm"):
        rule, delete = card["statements"][f"rule_{label}"], card["statements"][f"delete_{label}"]
        if rule["inserted"] != members or delete["removed"] != members:
            raise AssertionError(f"{label}: RULE inserted {rule['inserted']}, DELETE removed "
                                 f"{delete['removed']}, expected {members}")
        c = card["counts"]
        if (c[f"univ_members_after_rule_{label}"], c[f"univ_members_after_delete_{label}"]) != (
                members, 0):
            raise AssertionError(f"{label}: university members {c}")
    if on_card:
        for k, n in RULE_LAUNCHES.items():
            if card["statements"]["rule_warm"]["launches"].get(k, 0) < n:
                raise AssertionError(f"RULE warm run launched {k} "
                                     f"{card['statements']['rule_warm']['launches']}")
    if not all(np.array_equal(a, b) for a, b in zip(card["after_rule"], twin["after_rule"])):
        raise AssertionError("RULE: the store differs from the CPU run's (host strategy)")
    for name in ("univ0_members", "q2_after_delete"):
        if card["rows"][name] != twin["rows"][name]:
            raise AssertionError(f"{name}: rows differ from the CPU run")
    if len(card["rows"]["univ0_members"]) != 640 or len(card["rows"]["q2_after_delete"]) != q2_rows:
        raise AssertionError("University0 members or Q2 after the DELETE")
    for k, v in twin["counts"].items():
        if card["counts"][k] != v:
            raise AssertionError(f"{k}: {card['counts'][k]}, the CPU run {v}")
    c = card["counts"]
    if (c["notes_before"], c["notes_after_insert"], c["notes_after_delete"]) != (
            0, DATA_TRIPLES, 0) or c["len_after_delete"] != c["len_before"]:
        raise AssertionError(f"INSERT DATA / DELETE DATA counts {c}")


def run_statements_phase(dev, lubm, universities: int, q2_rows: int) -> dict:
    """Phase 8 on the card and on the CPU (the oracle), each on its own
    database built from phase 4's LUBM columns."""
    import torch

    from kolibrie_tpu_torch import SparqlDatabase

    def fresh(d):
        return SparqlDatabase.from_arrays(
            lubm.dictionary.id_to_str, *lubm.store.columns(), device=d)

    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    card = run_statements(dev, fresh(dev))
    t1 = time.perf_counter()
    twin = run_statements(torch.device("cpu"), fresh(torch.device("cpu")), twin=True)
    check_statements(card, twin, universities, q2_rows, on_card)
    log(f"phase 8: card {t1 - t0:.1f} s, CPU run {time.perf_counter() - t1:.1f} s; rows, routes, "
        f"launches and counts as expected; peak device memory {card.get('peak_bytes')} B")
    return card


# ------------------------------------------------------- kernel timing


def timed_row(name, src, replaces, launches, args, fn, plain, nbytes, check, library=None):
    """One kernel row: its check against the plain version on ``args``,
    device times of the kernel, the plain version and the library call,
    and the bytes bound."""
    err = check(args)
    ms, enqueue_ms = time_ms(lambda: fn(*args))
    plain_ms, plain_enqueue_ms = time_ms(lambda: plain(*args))
    library_ms = time_ms(library)[0] if library is not None else None
    b = nbytes(args)
    entry = {
        "name": name,
        "route": "cuda",
        "source": src,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": library_ms,
    }
    log(f"{name}: {b} bytes, device {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
        f"{entry['bound_ms']:.4f} ms, library {library_ms}); host enqueue per call "
        f"{enqueue_ms:.4f} ms (plain {plain_enqueue_ms:.4f} ms)")
    return entry


def filter_library(args):
    """The one PyTorch call that computes ``filter_mask`` on ``args`` where
    there is one: ``torch.eq`` for a predicate-only pattern; else None."""
    import torch

    s, p, o, kw = args
    if kw["s_const"] < 0 and kw["o_const"] < 0 and kw["o_op"] < 0 and kw["p_const"] >= 0:
        return lambda: torch.eq(p, kw["p_const"])
    return None


def ptxas_lines(build_log: str, needle: str) -> list:
    """The ``-Xptxas -v`` lines (registers, shared memory, stack and
    spills) of the kernels whose mangled names hold ``needle``."""
    out, keep = [], False
    for line in build_log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            keep = needle in line
        elif keep and ("registers" in line or "stack frame" in line):
            out.append(line.strip())
    return out


def ptxas_summary(build_log: str) -> str:
    """Kernel count, most registers and spill bytes of one source's
    ``-Xptxas -v`` report."""
    import re

    regs = [int(m) for m in re.findall(r"Used (\d+) registers", build_log)]
    spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", build_log))
    return f"{len(regs)} kernels, at most {max(regs, default=0)} registers, {spills} bytes spilled"


def filter_kernel_needle(kw) -> str:
    """The template arguments ``<active clauses, o_op>`` of the filter
    kernel that ``kw`` launches, as they appear in its mangled name."""
    active = (kw["s_const"] >= 0) | (kw["p_const"] >= 0) << 1 | (kw["o_const"] >= 0) << 2
    op = "in1" if kw["o_op"] < 0 else f"i{kw['o_op']}"
    return f"ILi{int(active)}EL{op}E"


def against_parent(name, parent_fn, fn, args) -> None:
    """Log the parent checkout's kernel and this tree's on the same inputs,
    timed in turns (parent, this, this, parent) in one process."""
    p1 = time_ms(lambda: parent_fn(*args))[0]
    n1 = time_ms(lambda: fn(*args))[0]
    n2 = time_ms(lambda: fn(*args))[0]
    p2 = time_ms(lambda: parent_fn(*args))[0]
    log(f"{name}: parent {p1!r} / {p2!r} ms, this tree {n1!r} / {n2!r} ms "
        f"(parent, this, this, parent)")


def load_parent_kernels(root: str):
    """The kernel module of another checkout of this repository (``--parent
    DIR``), loaded under another name and built from that checkout's own
    sources into its own build directory."""
    import importlib.util

    path = os.path.join(root, "kolibrie_tpu_torch", "ops", "kernels.py")
    spec = importlib.util.spec_from_file_location("parent_kernels", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build_kernels()
    return mod


def kernels_at_main_path_shapes(
    main_path: dict, surface: dict, closure: dict, entries: dict, rsp: dict, statements: dict,
    parent=None,
):
    """Phase 5: each kernel against its plain version on the largest inputs
    its path gave it, with both timed and the bytes bound.  Launches are
    each path's own count: phases 4 and 4b (the SELECT path) for the SELECT
    kernels, the closure's warm run (phase 6) for the fused filter and the
    closure's merge path, phase 6c for the ops entries, phase 7's device run
    for the RSP path's merge path and filter.  The merge path's and the
    filter's rows also log their kernels' ``-Xptxas -v`` lines and, with
    ``parent`` (another checkout's kernel module), that checkout's kernel
    timed in turns with this one on the same inputs."""
    import torch

    from kolibrie_tpu_torch.ops import kernels as K

    build = K.build_log()

    def redesigned(name, fn, parent_fn, args, source, needle):
        for line in ptxas_lines(build.get(source, ""), needle):
            log(f"{name}: ptxas {line}")
        if parent is not None:
            against_parent(name, parent_fn, fn, args)

    cap4 = main_path["captured"]
    l4 = {
        k: n + surface["launches"][k] for k, n in main_path["report"]["launches"].items()
    }
    pk = "kolibrie_tpu/ops/pallas_kernels.py:"
    csrc = "kolibrie_tpu_torch/csrc/"
    log("kernels at the paths' largest shapes, tolerance 0 (bit-exact):")
    warm = closure["runs"]["warm"]["launches"]
    line = [
        timed_row("merge_path_join", csrc + "merge_join.cu", pk + "181", l4["merge_path_join"],
                  cap4["merge_path_join"][1], K.merge_path, K.merge_path_plain,
                  merge_path_bytes, check_merge_path),
        timed_row("merge_path_join[closure]", csrc + "merge_join.cu", pk + "181",
                  warm["merge_path_join"], closure["captured"]["merge_path_join"][1],
                  K.merge_path, K.merge_path_plain, merge_path_bytes, check_merge_path),
        timed_row("lex_probe_select", csrc + "lex_probe.cu", pk + "743", l4["lex_probe_select"],
                  cap4["lex_probe_select"][1], K.lex_probe_select, K.lex_probe_select_plain,
                  select_bytes, check_select),
        timed_row("lex_probe_validate", csrc + "lex_probe.cu", pk + "783",
                  l4["lex_probe_validate"], cap4["lex_probe_validate"][1], K.lex_probe_validate,
                  K.lex_probe_validate_plain, validate_bytes, check_validate),
        timed_row("merge_join", csrc + "merge_join.cu", pk + "522",
                  entries["launches"]["merge_join"], entries["merge_join"], K.merge_join,
                  merge_join_plain, merge_join_bytes, check_merge_join),
    ]
    for row, args in ((line[0], cap4["merge_path_join"][1]),
                      (line[1], closure["captured"]["merge_path_join"][1])):
        redesigned(row["name"], K.merge_path, parent and parent.merge_path, args,
                   "merge_join", "merge_path_join_kernel")
    # the merge-path kernel alone inside that merge_join call
    lk, _lv, rk, _rv, cap = entries["merge_join"]
    inner = (*K._join_prepass(lk, rk), lk.shape[0], rk.shape[0], K._round_out(cap))
    log(f"merge_join: its merge-path kernel alone {time_ms(lambda: K.merge_path(*inner))[0]:.4f} "
        f"ms of the entry's {line[-1]['ms']:.4f} ms")

    def filt(s, p, o, kw):
        return K.filter_mask(s, p, o, **kw)

    def filt_plain(s, p, o, kw):
        return K.filter_mask_plain(s, p, o, **kw)

    def filt_parent(s, p, o, kw):
        return parent.filter_mask(s, p, o, **kw)

    for name, launches, fargs in (
        ("filter_mask", warm["filter_mask"], closure["captured"]["filter_mask"][1]),
        ("filter_mask[rsp]", rsp["launches"]["filter_mask"], rsp["captured"]["filter_mask"][1]),
    ):
        line.append(timed_row(name, csrc + "filter_mask.cu", pk + "887", launches, fargs, filt,
                              filt_plain, filter_bytes, check_filter, filter_library(fargs)))
        redesigned(name, filt, filt_parent, fargs, "filter_mask",
                   filter_kernel_needle(fargs[3]))
    # phase 8: its own launches, at the largest calls of its first RULE
    st, l8 = statements["captured"], statements["launches"]
    line.append(timed_row("merge_path_join[statements]", csrc + "merge_join.cu", pk + "181",
                          l8.get("merge_path_join", 0), st["merge_path_join"][1], K.merge_path,
                          K.merge_path_plain, merge_path_bytes, check_merge_path))
    fargs = st["filter_mask"][1]
    line.append(timed_row("filter_mask[statements]", csrc + "filter_mask.cu", pk + "887",
                          l8.get("filter_mask", 0), fargs, filt, filt_plain, filter_bytes,
                          check_filter, filter_library(fargs)))
    rargs = rsp["captured"]["merge_path_join"][1]
    line.append(timed_row("merge_path_join[rsp]", csrc + "merge_join.cu", pk + "181",
                          rsp["launches"]["merge_path_join"], rargs, K.merge_path,
                          K.merge_path_plain, merge_path_bytes, check_merge_path))
    redesigned("merge_path_join[rsp]", K.merge_path, parent and parent.merge_path, rargs,
               "merge_join", "merge_path_join_kernel")
    a, b = entries["tags"]
    library = {"min": torch.minimum, "max": torch.maximum, "mul": torch.mul}
    for op in TAG_OPS:
        lib = library.get(op)
        line.append(timed_row(f"tag_combine[{op}]", csrc + "tag_combine.cu", pk + "995",
                              entries["tag_launches"][op], (a, b, op), K.tag_combine,
                              K.tag_combine_plain, tag_bytes, check_tag,
                              (lambda f=lib: f(a, b)) if lib is not None else None))
    return line


# ------------------------------------------------------------------ main


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one CUDA card.")
    ap.add_argument("--parent", metavar="DIR",
                    help="another checkout (e.g. the parent commit from git archive): phase 5 "
                         "also times its merge-path and filter kernels in turns with this tree's")
    args = ap.parse_args(argv)

    # ---- 1. card
    if not torch.cuda.is_available():
        log("no CUDA device")
        return 1
    card = card_line()
    log(f"card: {card}")
    dev = torch.device("cuda")

    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from kolibrie_tpu_torch.ops import kernels as K

    # ---- 2. build
    t0 = time.perf_counter()
    logs = K.build_kernels()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        log(f"  {name}: {ptxas_summary(text)}")
        for line in text.splitlines():
            if "error" in line.lower() or "warning" in line.lower():
                log(f"  {name}: {line.strip()}")
    parent = load_parent_kernels(args.parent) if args.parent else None

    # ---- 3. kernels at random shapes
    check_random_shapes(dev)
    torch.cuda.synchronize()
    log("kernels: bit-exact against the plain versions at random shapes")

    # ---- 4. main path
    queries = build_queries(dev)
    main_path = run_main_path(dev, queries)
    check_main_path(main_path["report"])
    cpu_dbs = compare_with_cpu(main_path)

    # ---- 4b. the rest of the SELECT surface
    dbs = surface_databases(dev, queries)
    surface = run_select_surface(dev, dbs)
    check_select_surface(
        surface, surface_expected(UNIVERSITIES, EXPECTED_ROWS["q2"], EMPLOYEES)
    )
    compare_surface_with_cpu(surface, dbs, cpu_dbs)
    del cpu_dbs, dbs

    # ---- 6. the reasoner at full width, 6b. a small closure, 6c. ops entries
    lubm = next(db for name, db, _q, _w in queries if name == "q2")
    closure = run_closure(dev, lubm)
    run_small_closure(dev)
    entries = run_ops_entries(dev, lubm, main_path["captured"]["merge_join_keys"][1])

    # ---- 7. the RSP engine at a 120,000-triple window
    rsp = run_rsp_phase(dev)

    # ---- 8. the host engine's shapes and the statements beside SELECT
    statements = run_statements_phase(dev, lubm, UNIVERSITIES, EXPECTED_ROWS["q2"])

    # ---- 5. kernels at the paths' shapes
    kernels = kernels_at_main_path_shapes(
        main_path, surface, closure, entries, rsp, statements, parent
    )
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
