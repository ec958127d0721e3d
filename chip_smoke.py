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
            240 ticks of 1,000 ``knows`` events among 40,000 persons (rule
            ``knows o knows => reach``, about 360,000 derived a firing; the
            query joins ``reach`` and ``knows`` on two keys).  The same
            stream through ``set_r2r_mode("host")`` is the oracle: rows and
            derived counts equal firing by firing, rows > 0.  The host run
            still queries on the card, so the stream's first
            ``RSP_CPU_TICKS`` ticks also go through the port's CPU run
            (``device="cpu"``, host closure), whose firings the card's must
            equal too.  At least three
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
9. provenance — tagged reasoning on the card.  9a: the graph of
            ``benches/bench_device_provenance.py`` (200,000 ``observes``
            edges over 50,000 nodes, ``default_rng(7)``, expiries, then
            probabilities from the same generator) closed under its 2-hop
            rule through ``Reasoner.infer_new_facts_with_provenance`` under
            Expiration, MinMax and AddMult, cold then warm: the device route
            taken, facts and TagStore equal to the port's host loop on the
            same machine (exact; AddMult within 1e-9 a tag), AddMult's two
            runs bit-identical with the same dispatches, and the warm run
            launching the fused filter and the merge path every dispatch
            (``PROV_LAUNCHES``).  9b: ``RULE … PROB`` (independent, then
            min) through ``execute_query_volcano`` on databases of their own
            built from phase 4's LUBM-1000 columns with a seeded probability
            on every ``memberOf`` and ``subOrganizationOf`` fact: 640,000
            derived, one tag triple per tagged fact, the device route, and
            the same facts and tag triples as the CPU twin (host loop).  9c:
            the reference tests' NAF programs (Boolean, MinMax, AddMult),
            wmc and sdd PROB rules, backward chaining, repairs and
            ``to_dot``, equal to the CPU's.  Walls, rounds, derived counts,
            peak device memory and launches are logged.  Counters are
            zeroed just before each run and read just after.
10. cross-window SDS+ and the incremental R2R.  10a: the CityBench point
            of ``benches/bench_cross_window.py`` at its largest size
            (50,000 roads' ``avgSpeed``, alpha 60; 12,500 lots' ``nearRoad``
            and ``occupancy``, alpha 120: 75,000 window triples) at update
            ratios 1, 10, 50 and 100%: ``naive_sds_plus`` (the host
            strategy, as in the reference) against ``incremental_sds_plus``
            from the ratio-0 SDS at time 0, whose closure takes the device
            tagged fixpoint under Expiration; the RESULT sets equal each
            other and the port's CPU run, and every incremental closure
            launches the fused filter and the merge path each dispatch
            (``CW_LAUNCHES``).  10b: ``RSPBuilder`` with a traffic window
            ``[RANGE 60 STEP 10]`` and a parking window ``[RANGE 120 STEP
            10]``, the same join rule (its conclusion in the traffic
            window, which the query reads), 834 ``avgSpeed`` readings and
            105 lots a tick over ticks 1-180 (about 50,000 and 25,000 window
            triples): modes naive, incremental and auto emit the same rows
            every cycle, the first three full-width cycles equal the CPU's
            naive run, and an incremental engine checkpointed after tick 140
            and restored into a fresh engine (given the first one's terms:
            the blob holds dictionary IDs, as the reference's does)
            continues with the uninterrupted rows.  10c: phase 7's stream
            under ``set_r2r_mode("incremental")``: rows and derived counts
            equal phase 7's device rows firing by firing, every firing on
            the device tagged fixpoint.  Per cycle: wall, mode, route,
            launches.
11. load and checkpoint — phase 4's LUBM-1000 database written with
            ``to_ntriples`` to a temporary file and ``load_file``-d into a
            fresh database on the card through the native parser (asserted);
            Q2 and Q9 return phase 4's rows with phase 4's warm launches of
            the merge path and both lex probes; ``checkpoint`` then
            ``from_checkpoint``: Q9's rows again; ``clone`` + INSERT DATA
            leave the original unchanged; ``union`` with employee-100K
            answers the employee join; employee-100K round-trips through
            ``to_turtle`` and through ``to_rdfxml`` + ``parse_rdf``; a
            ``QueryBuilder`` query over LUBM-1000 equals its SPARQL twin.
            Each step timed; peak device memory.
12. neurosymbolic ML — 12a: the digit model (``HIDDEN [16]``, exclusive
            over "0"/"1") and the hot model (``HIDDEN [8]``, binary) on
            4,096-row batches: forward, VJP and 50 Adam steps on the card
            against the port's CPU run from the same weights, TF32 matmuls
            asserted off.  Then two clones of phase 4's LUBM-1000 database:
            12c, 100,000 digit samples (``tests/test_ml.py``'s graph, three
            triples each) and the digit TRAIN statement (EPOCHS 3,
            BATCH_SIZE 256) on the no-rules fast path; 12b, 20,000 sensor
            measurements, ``tests/test_ml.py``'s RULE and TRAIN (``HIDDEN
            [8]``, EPOCHS 5, BATCH_SIZE 64, bce) through the SDD proof path:
            20,000 closures in all, p(85) > 0.8 and p(45) < 0.2; 12d,
            ML.PREDICT over every sample and measurement, the SPARQL-star
            read of ``prob:value``, a SELECT naming ``ex:predictedDigit``
            (the materialisation pre-pass) and a RULE whose body names
            ``ex:predictedHot``.  The port's CPU run repeats 12b and 12c from
            the same initial weights (epoch losses and weights within the
            stated drift) and 12d with the card's trained weights through
            ``save`` / ``load`` (rows equal but for rows within
            ``ML_PROB_TOL`` of the decision boundary, which are counted).
            Each statement's wall and launches; the ML statements must
            launch the merge path.  Counters zeroed just before the card's
            statements, read just after.
13. repeated queries — over phase 4's databases.  13a: ``PreparedQuery``
            on the employee join, Q2 and Q9: ``calibrate`` on the host twin,
            ``run`` x20, ``run_amortized(16)``, ``fetch``: phase 4's rows,
            the twin's counts equal to the converged counts, and no readback
            across the runs (``fetch_counters``).  13b: 64 constant-variants
            of ``benches/bench_plan_template.py``'s template on the employee
            predicates and 64 of a two-pattern LUBM join (one department a
            variant) through the plan cache — one new spec, one miss and 63
            parameter rebinds each, a hit on a repeat, the rows of uncached
            runs — then through one ``execute_queries_batched`` call (one
            batched dispatch, the solo rows).  13c: the employee variants
            under ``plan_interp`` force: the specialized rows, source
            ``interp``; Q9 and the LUBM template decline (WCOJ; the register
            file's cell budget).  13d: ``bench.py``'s MQO fleet (50,000
            subjects, 256 standing queries) off, then twice under force:
            equal rows, one shared prefix evaluation and 511 cache hits, the
            ``mqo:`` EXPLAIN line.  13e: EXPLAIN ANALYZE on Q2 and Q9 (the
            actuals equal the row counts), then Q9 three times under the
            stats advisor (rows unchanged; its report and replans logged).
            13f: ``compile_cache.enable`` on a temporary directory, the
            kernels built there, 13b's templates recorded and the manifest
            saved; a second process loads a fresh LUBM-1000 and replays the
            manifest: both templates warmed, every kernel library a cache
            hit, none built.  Walls (cold, warm) and launches per subphase;
            counters zeroed just before 13a and read just after 13e.
14. resilience and durability — first, every breaker board on a live
            database, and the process-wide trip and degraded counters, read
            zero after phases 4-13.  14a: phase 4's employee join, Q2 and Q9
            behind an injected ``device.lower`` compile error, then a
            ``device.execute`` OOM: three faulted calls served by the host
            engine on the card (merge path launched, no lex probe) trip the
            template's breaker, a fourth skips the device program, and past
            the backoff (an injected clock) the half-open probe runs the
            device program (lex probes / merge path); phase 4's rows at
            every call; degraded and device walls, Q9's busy shares.  14b:
            Q9 shed by an expired deadline at ``executor.enter`` and by one
            expiring between lowering and dispatch (at ``device.execute``,
            counted by the breaker): no launch, device memory back where it
            began.  14c: ``bench.py``'s WAL ingest (30 batches of 2,048
            rows, best of 5) and the LUBM-1000 bulk load with the WAL off
            and on under ``group``: the overhead beside the 15% target.
            14d: a second process under ``KOLIBRIE_FSYNC=always`` loads
            LUBM-1000 through the WAL, snapshots, applies phase 8's INSERT
            DATA / DELETE DATA, the ``memberOf`` RULE and a batch, prints
            its acknowledgement and is killed with SIGKILL; recovery from
            the snapshot + WAL tail and from the WAL alone gives the
            uncrashed twin's columns and dictionary and phase 4's Q2 / Q9
            rows; a torn append recovers to the acknowledged prefix.
            Recover, first-query and snapshot walls, snapshot bytes, peak
            device memory; each subphase's Python collections
            (``GcMeter``); counters zeroed just before 14a, read after 14d.
15. serving — phase 4's LUBM-1000 and employee-100K databases behind the
            port's HTTP server on the card.  15a: both snapshotted as stores
            ``lubm`` and ``emp`` in the layout the server's ``_snapshot_now``
            writes; ``make_server(data_dir=..., recover_async=False,
            repl_port=..., device="cuda")`` recovers them (recovery and
            first-query walls).  15b: over ``/store/query`` Q2, Q9 and the
            employee join, cold then warm, give phase 4's rows, each warm
            request launching its route's kernels; 16 client threads send
            64 employee template variants (``/stats``: fewer dispatches than
            requests, a batched plan cache), each answer equal to a solo call
            on the card; a ``/store/load`` write answers with a watermark
            token; request latency p50 / p99.  15c: the trace id echoed and
            one trace holding the HTTP → batcher → executor → device chain,
            ``/metrics`` parsed as Prometheus text, ``/debug/timeline``,
            ``/debug/profile?seconds=0.5`` under load (``torch.profiler``;
            the trace names a ``csrc/`` kernel) and ``/debug/bundle``
            (``flightrec.read_bundle``).  15d: an in-process follower
            bootstraps LUBM-1000 from the primary's ship server onto the
            card behind ``make_router``; a write through the router is
            applied on the follower; Q9 read on the follower through the
            router gives phase 4's rows; ``/fleet/metrics`` labels both
            nodes.  15e: a child process serves as primary (``python -m
            kolibrie_tpu_torch.frontends.cli --serve --device cuda``,
            ``KOLIBRIE_DATA_DIR``, ``KOLIBRIE_REPL_PORT``) holding
            employee-100K loaded over ``/store/load``, is SIGKILLed while a
            writer ingests through the router; the router's supervisor
            promotes the in-process follower, every acknowledged write whose
            segment the follower had applied is there, and the promoted node
            takes a write and answers the employee join with the merge path.
            Counters zeroed just before 15a, read after 15e.
16. multi-device — four shards over the cards present (``make_mesh(4,
            devices=[cuda:i % count])``: all on one card with one card) on
            phase 4's LUBM-1000.  16a: ``ShardedTripleStore.from_columns``,
            both mirrors' occupancy and imbalance, peak memory, and
            ``dist_bgp_join_count(advisor, teacherOf)`` equal to numpy's
            count.  16b: ``DistQueryExecutor`` Q2 and Q9 give phase 4's rows;
            warm ``run_device`` times and busy share.  16c:
            ``DistGeneralReasoner`` over phase 6's closure rules: its fact
            set equals phase 6's.  16d: ``attach_sharded(lubm, mesh)``, 64
            variants of the worksFor/teacherOf template through
            ``execute_queries_batched`` equal to the single-device answers
            (``stats()``: a dispatch, 64 batched queries, no fallback); an
            INSERT DATA of 1,000 triples refreshes the delta with
            ``sharded_compile_stats()`` unchanged and the answers equal to
            the single-device run; then the 64 variants from 16 threads
            over HTTP against ``make_server(data_dir=..., mesh=mesh)``
            booted on a snapshot of that store (``/stats`` ``sharding``,
            every ``kolibrie_shard_*`` / ``kolibrie_store_shard*`` family on
            ``/metrics``).  Every step launches the merge path and the fused
            filter and no plain version; no attach error, no fallback.
            Counters zeroed just before 16a, read after 16d.
17. distributed provenance and training — phase 16's four shards.  17a:
            ``DistProvenanceReasoner`` on phase 9a's graph under
            Expiration, MinMax and AddMult, cold then warm: both runs'
            facts and TagStore equal 9a's single-device run (AddMult within 1e-9 a
            tag), AddMult's two runs bit-identical; walls, rounds, capacity
            attempts, peak memory.  17b: the reference tests' NAF programs
            (and one whose NAF body joins) equal to the port's host loop;
            the refused shapes raise ``Unsupported``.  17c:
            ``dp_train_step`` over 12c's 100,000 digit samples, each of 20
            losses and the last params, m and v within 1e-5 of the
            one-device step, the loss falling; then
            ``neurosymbolic_step`` on phase 16a's partition of LUBM-1000
            with the transitive ``subOrganizationOf`` rule (0 derived: the
            generator has no 2-hop chain) and phase 6's ``memberOf`` lift
            (640,000), each count equal to numpy's.  Every dispatch of 17a
            and 17b launches the fused filter on every shard, and the merge
            path wherever its rules join (17c's fast-path rounds launch the
            merge path and no filter: they compare predicates inline, as
            the reference's do); no plain version is called.  Counters
            zeroed just before 17a, read after 17c.
18. the project linter — ``python -m kolibrie_tpu_torch.analysis --json
            --max-seconds 60`` in a child process over the package as
            shipped, against its committed (empty) baseline: its finding
            count and ``kolint_runtime_s``; a non-zero exit fails the
            smoke.  No kernel and no card.
5. kernels (main-path shapes) — each kernel against its plain version on
            the largest inputs its path gave it (phases 4, 6, 6c, 7-17), both
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
import re
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
# 240 ticks, not more: the whole smoke must stay inside its time limit
RSP_TICKS = 240  # ticks 1 .. 240: firings at 60, 120, 180, 240
RSP_WIDTH = 120  # [RANGE 120 STEP 60]: a full window holds 120 ticks of events
RSP_SEED = 7
RSP_FULL_FIRINGS = 3
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
    facts = r.facts.columns()  # phase 16c's expected closure
    del host, r
    return {"runs": runs, "captured": record_closure_inputs(fresh), "facts": facts}


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
    the R2R's maintenance ms and fixpoint ms (device mode; synchronised;
    in incremental mode the tagged closure's ms and its device route), the
    fixpoint's rounds and capacities, the query ms, the derived count,
    the emitted rows and the kernel launches.  ``around_firing(k, fn)``, if
    given, runs firing ``k`` (default: ``fn()``).  Launch counters are
    zeroed just before the stream and read just after; the largest inputs
    the merge-path kernel and the fused filter received are kept (as
    references, no readback) for phase 5."""
    import torch

    from kolibrie_tpu_torch import RSPBuilder
    from kolibrie_tpu_torch.ops import kernels as K
    from kolibrie_tpu_torch.reasoner import device_fixpoint as FX
    from kolibrie_tpu_torch.reasoner import device_provenance as DP

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

    entry = "materialize_incremental" if mode == "incremental" else "materialize"

    def counted_materialize():
        derived = materialize()
        firings[-1]["derived"] = len(derived)
        return derived

    materialize = timed("r2r_ms", getattr(r2r, entry))
    setattr(r2r, entry, counted_materialize)
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
    orig = (FX.DeviceFixpoint.infer_padded, FX.filter_mask, K.merge_path,
            DP.infer_provenance_device)

    def infer_rec(self, *a, **k):
        out = timed("fixpoint_ms", orig[0])(self, *a, **k)
        firings[-1]["rounds"], firings[-1]["caps"] = self.last_rounds, vars(out[4])
        return out

    def tagged_rec(*a, **k):
        out = timed("fixpoint_ms", orig[3])(*a, **k)
        rec = firings[-1]
        rec.setdefault("route", []).append(out is not None)
        rec["rounds"], rec["caps"] = DP.LAST_RUN["rounds"], DP.LAST_RUN["caps"]
        return out

    def merge_rec(*a):
        key = (a[6], a[4])  # output slots, left rows: host ints, no readback
        if key > captured.get("merge_path_join", ((0, 0), None))[0]:
            captured["merge_path_join"] = (key, a)
        return orig[2](*a)

    FX.DeviceFixpoint.infer_padded, K.merge_path = infer_rec, merge_rec
    FX.filter_mask = filter_recorder(captured, orig[1])
    DP.infer_provenance_device = tagged_rec
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
        (FX.DeviceFixpoint.infer_padded, FX.filter_mask, K.merge_path,
         DP.infer_provenance_device) = orig
        engine.stop()
    launches = {**K.LAUNCHES, **K.ENTRY_LAUNCHES}
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    for k, rec in enumerate(firings):
        rec["rows"] = sorted(rec["rows"])
        log(f"rsp {mode} firing {k}: content {rec['content']}, derived {rec.get('derived')}, "
            f"rows {len(rec['rows'])}, wall {rec['wall_ms']:.1f} ms (r2r {rec.get('r2r_ms', 0):.1f}: "
            f"maintenance {rec.get('maintain_ms', 0):.1f}, fixpoint {rec.get('fixpoint_ms', 0):.1f} "
            f"in {rec.get('rounds')} rounds, caps {rec.get('caps')}, route {rec.get('route')}; query "
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


# ------------------------------------------------------- phase 9: provenance

PROV_FACTS = 200_000  # benches/bench_device_provenance.py's default
PROV_SEED = 7
PROV_SEMIRINGS = ("expiration", "minmax", "addmult")
# per dispatch of the 2-hop rule: both plans scan both premises through the
# fused filter and join once through the merge path
PROV_LAUNCHES = {"filter_mask": 4, "merge_path_join": 2}
PROV_ADDMULT_TOL = 1e-9  # per tag, the reference tests' _close_tags tolerance
PROB_VALUE = "http://kolibrie.tpu/prob#value"
PROB_RULE = ("RULE :MemberUnivP PROB(combination={comb}) :- CONSTRUCT {{ ?x ub:memberOf ?u . }} "
             "WHERE {{ ?x ub:memberOf ?d . ?d ub:subOrganizationOf ?u . }}")
PROB_COMBINATIONS = ("independent", "min")


def prov_workload(n: int, seed: int) -> dict:
    """``benches/bench_device_provenance.py``'s graph drawn from
    ``default_rng(seed)``: ``n`` ``observes`` edges over ``n // 4`` nodes,
    each from a node to one 1-2 layers on, expiries in 10,000-1,000,000;
    then one probability per edge from the same generator."""
    import numpy as np

    rng = np.random.default_rng(seed)
    src = rng.integers(0, n // 4, n, dtype=np.uint32)
    dst = src + rng.integers(1, 3, n).astype(np.uint32)
    expiries = rng.integers(10_000, 1_000_000, n)
    probs = rng.uniform(0.05, 0.95, n)
    return {"src": src, "dst": dst, "expiries": expiries, "probs": probs}


def prov_reasoner(dev, work: dict):
    """The workload's reasoner on ``dev`` with the bench's dictionary IDs
    and its 2-hop rule ``?x observes ?y . ?y observes ?z => ?x reaches ?z``,
    and the fact columns in draw order."""
    import numpy as np

    from kolibrie_tpu_torch import Reasoner

    r = Reasoner(device=dev)
    d = r.dictionary
    obs = d.encode("observes")
    node_ids = np.array([d.encode(f"v{i}") for i in range(int(work["dst"].max()) + 1)],
                        dtype=np.uint32)
    cols = (node_ids[work["src"]], np.full(len(work["src"]), obs, np.uint32),
            node_ids[work["dst"]])
    r.facts.add_batch(*cols)
    r.add_rule(r.rule_from_strings([("?x", "observes", "?y"), ("?y", "observes", "?z")],
                                   [("?x", "reaches", "?z")]))
    len(r.facts)  # compact on the host before any clock starts
    return r, cols


def prov_tag_store(name: str, cols, work: dict):
    """The seeded TagStore: expiries for ``expiration``, the drawn
    probabilities otherwise (a repeated edge keeps its last draw, as the
    bench's loop does)."""
    from kolibrie_tpu_torch.reasoner.provenance import make_provenance
    from kolibrie_tpu_torch.reasoner.tag_store import TagStore

    prov = make_provenance(name)
    vals = work["expiries"] if name == "expiration" else work["probs"]
    keys = zip(*(c.tolist() for c in cols))
    return prov, TagStore.from_items(prov, zip(keys, vals.tolist()))


class DeviceRoute:
    """Records every ``device_provenance.infer_provenance_device`` call made
    in its scope (through the reasoner's entry) and whether it accepted
    the program (not None)."""

    def __enter__(self):
        from kolibrie_tpu_torch.reasoner import device_provenance as DP

        self.accepted = []
        self._orig = DP.infer_provenance_device

        def spy(*a, **k):
            out = self._orig(*a, **k)
            self.accepted.append(out is not None)
            return out

        DP.infer_provenance_device = spy
        return self

    def __exit__(self, *exc):
        from kolibrie_tpu_torch.reasoner import device_provenance as DP

        DP.infer_provenance_device = self._orig
        return False


def prov_recorders(captured: dict):
    """Wrappers keeping phase 9's largest fused-filter scan and merge-path
    call (most slots, then left rows; no readback) as phase 5's inputs."""
    from kolibrie_tpu_torch.ops import kernels as K
    from kolibrie_tpu_torch.reasoner import device_fixpoint as FX

    saved = (FX.filter_mask, K.merge_path)

    def merge_rec(*a):
        if (a[6], a[4]) > captured.get("merge_path_join", ((0, 0), None))[0]:
            captured["merge_path_join"] = ((a[6], a[4]), a)
        return saved[1](*a)

    def install():
        FX.filter_mask, K.merge_path = filter_recorder(captured, saved[0]), merge_rec

    def restore():
        FX.filter_mask, K.merge_path = saved

    return install, restore


def prov_launches(on_card: bool, calls) -> dict:
    from kolibrie_tpu_torch.ops import kernels as K

    if on_card:
        return {k: v for k, v in {**K.LAUNCHES, **K.ENTRY_LAUNCHES}.items() if v}
    return dict(calls.counts)


def same_tags(want: dict, got: dict, addmult: bool) -> float:
    """Largest per-tag difference (0.0: equal); raises on other keys or
    an exact semiring's difference."""
    if set(want) != set(got):
        raise AssertionError(f"tag keys differ: {len(want)} vs {len(got)}")
    if not addmult:
        if want != got:
            raise AssertionError("tags differ")
        return 0.0
    err = max((abs(v - got[k]) for k, v in want.items()), default=0.0)
    if not err <= PROV_ADDMULT_TOL:
        raise AssertionError(f"AddMult tags differ by {err} > {PROV_ADDMULT_TOL}")
    return err


def run_prov_closures(dev, work: dict, captured: dict) -> dict:
    """9a: the workload under each semiring through
    ``Reasoner.infer_new_facts_with_provenance`` on ``dev``, cold then warm
    on fresh reasoners (launch counters zeroed just before each run, read
    just after), then the port's host loop on the same machine
    (``infer_with_provenance_host``).  Checks the device
    route, facts and TagStore against the host loop, AddMult's two device
    runs bit-identical with the same dispatches, and the warm run's launch
    floor."""
    import torch

    from kolibrie_tpu_torch.ops import kernels as K
    from kolibrie_tpu_torch.reasoner import device_provenance as DP
    from kolibrie_tpu_torch.reasoner.provenance_seminaive import infer_with_provenance_host

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    install, restore = prov_recorders(captured)
    out = {}
    for name in PROV_SEMIRINGS:
        runs = {}
        for label in ("cold", "warm"):
            r, cols = prov_reasoner(dev, work)
            prov, store = prov_tag_store(name, cols, work)
            n0 = len(r.facts)
            K.reset_launches()
            if on_card:
                torch.cuda.reset_peak_memory_stats()
                install()
            try:
                with DeviceRoute() as route, KernelCalls() as calls:
                    sync()
                    t = time.perf_counter()
                    r.infer_new_facts_with_provenance(prov, store)
                    sync()
                    ms = (time.perf_counter() - t) * 1e3
            finally:
                restore()
            runs[label] = {
                "derived": len(r.facts) - n0, "ms": ms, "route": route.accepted,
                "rounds": DP.LAST_RUN["rounds"], "attempts": DP.LAST_RUN["attempts"],
                "caps": DP.LAST_RUN["caps"], "dispatches": list(DP.LAST_RUN["dispatches"]),
                "launches": prov_launches(on_card, calls),
                "peak_bytes": torch.cuda.max_memory_allocated() if on_card else None,
                "tags": dict(store.tags), "facts": r.facts.columns(),
            }
            if route.accepted != [True]:
                raise AssertionError(f"9a {name} {label}: device route {route.accepted}")
            rec = runs[label]
            log(f"9a {name} {label}: {n0} facts, {rec['derived']} derived, {ms:.1f} ms, "
                f"{rec['rounds']} rounds, {rec['attempts']} overflow attempts, caps {rec['caps']}, "
                f"peak device memory {rec['peak_bytes']} B, launches {rec['launches']}")
        r, cols = prov_reasoner(dev, work)
        prov, store = prov_tag_store(name, cols, work)
        t = time.perf_counter()
        infer_with_provenance_host(r, prov, store)  # the host loop on the same machine
        host_ms = (time.perf_counter() - t) * 1e3
        warm = runs["warm"]
        import numpy as np

        if not all(np.array_equal(a, b) for a, b in zip(warm["facts"], r.facts.columns())):
            raise AssertionError(f"9a {name}: facts differ from the host loop")
        err = same_tags(dict(store.tags), warm["tags"], name == "addmult")
        if name == "addmult" and (runs["cold"]["tags"] != warm["tags"]
                                  or runs["cold"]["dispatches"] != warm["dispatches"]):
            raise AssertionError("9a addmult: two device runs differ")
        floor = {k: n * len(warm["dispatches"]) for k, n in PROV_LAUNCHES.items()}
        if any(warm["launches"].get(k, 0) < n for k, n in floor.items()):
            raise AssertionError(f"9a {name} warm launches {warm['launches']}, floor {floor}")
        # phase 17a holds the mesh's closure to this run's
        result = {"derived": warm["derived"], "facts": sorted_facts(warm["facts"]),
                  "tags": warm["tags"]}
        for rec in runs.values():
            del rec["tags"], rec["facts"]
        out[name] = {**runs, "host_ms": host_ms, "max_tag_err": err, "result": result}
        log(f"9a {name}: facts and TagStore equal the host loop ({host_ms:.1f} ms; largest tag "
            f"difference {err}){'; two device runs bit-identical' if name == 'addmult' else ''}")
    return out


def prov_seeds(lubm, seed: int) -> dict:
    """A probability from ``default_rng(seed)`` on every ``ub:memberOf``
    and ``ub:subOrganizationOf`` fact of the LUBM columns, in store
    order."""
    import numpy as np

    from benches.lubm import UB

    s, p, o = lubm.store.columns()
    ids = [lubm.dictionary.lookup(UB + k) for k in ("memberOf", "subOrganizationOf")]
    m = np.isin(p, ids)
    probs = np.random.default_rng(seed).uniform(0.05, 0.95, int(m.sum()))
    return dict(zip(zip(s[m].tolist(), p[m].tolist(), o[m].tolist()), probs.tolist()))


def tag_view(db) -> tuple:
    """The store split into its facts without the tag triples (sorted
    columns) and the tag triples as {(s, p, o) of the tagged fact: value
    literal}: two databases whose tags were written in another order hold
    other IDs for the quoted triples and literals, the same view."""
    import numpy as np

    s, p, o = db.store.columns()
    pv = db.dictionary.lookup(PROB_VALUE)
    m = p == pv if pv is not None else np.zeros(len(p), bool)
    q = db.quoted.get
    dec = db.dictionary.decode
    tags = {q(int(a)): dec(int(c)) for a, c in zip(s[m].tolist(), o[m].tolist())}
    return (s[~m], p[~m], o[~m]), tags


def run_prob_rules(dev, lubm, seeds: dict, captured: dict, twin: bool = False) -> dict:
    """9b: ``RULE … PROB`` (``PROB_COMBINATIONS``) through
    ``execute_query_volcano`` on a database of its own per combination,
    built from the LUBM columns with ``probability_seeds``; launch counters
    zeroed just before each run and read just after.  ``twin``: the CPU
    run, whose closure takes the host loop."""
    import torch

    from kolibrie_tpu_torch import SparqlDatabase, execute_query_volcano
    from kolibrie_tpu_torch.ops import kernels as K
    from kolibrie_tpu_torch.reasoner import device_provenance as DP

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    install, restore = prov_recorders(captured)
    out = {}
    for comb in PROB_COMBINATIONS:
        db = SparqlDatabase.from_arrays(lubm.dictionary.id_to_str, *lubm.store.columns(),
                                        device=dev, probability_seeds=seeds)
        n0 = len(db)
        K.reset_launches()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
            install()
        try:
            with DeviceRoute() as route, KernelCalls() as calls:
                sync()
                t = time.perf_counter()
                execute_query_volcano(SURFACE_PREFIXES + PROB_RULE.format(comb=comb), db)
                len(db)  # the wall ends with the store compacted
                sync()
                ms = (time.perf_counter() - t) * 1e3
        finally:
            restore()
        facts, tags = tag_view(db)
        out[comb] = {
            "ms": ms, "inserted": len(db) - n0, "tag_triples": len(tags), "route": route.accepted,
            "rounds": DP.LAST_RUN["rounds"] if route.accepted else None,
            "attempts": DP.LAST_RUN["attempts"] if route.accepted else None,
            "caps": DP.LAST_RUN["caps"] if route.accepted else None,
            "dispatches": len(DP.LAST_RUN["dispatches"]) if route.accepted else None,
            "launches": prov_launches(on_card, calls),
            "peak_bytes": torch.cuda.max_memory_allocated() if on_card else None,
            "facts": facts, "tags": tags,
        }
        rec = {k: v for k, v in out[comb].items() if k not in ("facts", "tags")}
        log(f"9b{' CPU twin' if twin else ''} {comb}: {rec}")
    return out


def check_prob_rules(card: dict, twin: dict, universities: int, n_seeds: int):
    """9b's checks: each combination derived ``640 * universities`` facts,
    wrote one tag triple per tagged fact (every seed and every derived
    fact), took the device route launching the fused filter and the merge
    path every dispatch (the CPU twin: the host loop), and left the same
    facts and tag triples as the CPU twin."""
    import numpy as np

    members = 640 * universities
    for comb in PROB_COMBINATIONS:
        c, h = card[comb], twin[comb]
        if c["tag_triples"] != n_seeds + members or c["inserted"] != members + c["tag_triples"]:
            raise AssertionError(f"9b {comb}: {c['inserted']} inserted, {c['tag_triples']} tag "
                                 f"triples; expected {members} facts + {n_seeds + members} tags")
        if c["route"] != [True] or h["route"] != []:
            raise AssertionError(f"9b {comb}: device route {c['route']}, twin {h['route']}")
        if not all(np.array_equal(a, b) for a, b in zip(c["facts"], h["facts"])):
            raise AssertionError(f"9b {comb}: facts differ from the CPU twin")
        if c["tags"] != h["tags"]:
            raise AssertionError(f"9b {comb}: tag triples differ from the CPU twin")
        floor = {k: n * c["dispatches"] for k, n in PROV_LAUNCHES.items()}
        if any(c["launches"].get(k, 0) < n for k, n in floor.items()):
            raise AssertionError(f"9b {comb}: launches {c['launches']}, floor {floor}")


def prov_small_programs(dev) -> dict:
    """9c's programs on ``dev``, each a fresh object per call: the
    reference tests' NAF programs (``_naf_blocked_builder`` under Boolean
    and MinMax, the AddMult NAF program), a wmc and an sdd ``RULE … PROB``
    of a few facts, and backward chaining, repairs and ``to_dot`` on a
    small reasoner.  Returns every answer in a comparable form."""
    from kolibrie_tpu_torch import Reasoner, SparqlDatabase, execute_query_volcano
    from kolibrie_tpu_torch.core.terms import Term, TriplePattern
    from kolibrie_tpu_torch.reasoner import device_provenance as DP
    from kolibrie_tpu_torch.reasoner import to_dot
    from kolibrie_tpu_torch.reasoner.provenance import make_provenance
    from kolibrie_tpu_torch.reasoner.provenance_seminaive import seed_tag_store

    def naf_blocked(tagged):
        r = Reasoner(device=dev)
        add = r.add_tagged_triple if tagged else (lambda s, p, o, _t: r.add_abox_triple(s, p, o))
        add("a", "p", "b", 0.9)
        add("c", "p", "d", 0.8)
        add("b", "broken", "yes", 0.3)
        r.add_rule(r.rule_from_strings([("?x", "p", "?y")], [("?x", "ok", "?y")],
                                       negative=[("?y", "broken", "yes")]))
        return r

    def naf_addmult():
        r = Reasoner(device=dev)
        r.add_tagged_triple("a", "p", "b", 0.9)
        r.add_tagged_triple("b", "p", "c", 0.8)
        r.add_tagged_triple("c", "broken", "yes", 0.4)
        for i in range(6):
            r.add_tagged_triple(f"u{i}", "p", f"v{i % 3}", 0.3 + 0.1 * i)
        r.add_tagged_triple("v1", "broken", "yes", 0.25)
        r.add_rule(r.rule_from_strings([("?x", "p", "?y")], [("?x", "ok", "?y")],
                                       negative=[("?y", "broken", "yes")]))
        return r

    out = {}
    for label, build, name in (("naf_boolean", lambda: naf_blocked(False), "boolean"),
                               ("naf_minmax", lambda: naf_blocked(True), "minmax"),
                               ("naf_addmult", naf_addmult, "addmult")):
        r = build()
        prov = make_provenance(name)
        store = seed_tag_store(r, prov)
        accepted = DP.infer_provenance_device(r, prov, store) is not None
        out[label] = (accepted, r.facts.triples_set(), dict(store.tags),
                      list(DP.LAST_RUN["dispatches"]))
    ttl = """@prefix e: <http://e/> .
e:s e:p1 e:m1 . e:s e:p2 e:m2 . e:m1 e:q e:z . e:m2 e:q e:z . e:t e:p1 e:m2 ."""
    for comb in ("wmc", "sdd"):
        db = SparqlDatabase(device=dev)
        db.parse_turtle(ttl)
        s, p, o = db.store.columns()
        db.probability_seeds = {k: 0.3 + 0.1 * i for i, k in enumerate(zip(
            s.tolist(), p.tolist(), o.tolist()))}
        execute_query_volcano(
            f"PREFIX e: <http://e/> RULE :G PROB(combination={comb}) :- CONSTRUCT "
            "{ ?x e:reach ?z . } WHERE { ?x ?p ?y . ?y e:q ?z . }", db)
        out[f"prob_{comb}"] = tag_view(db)[1], sorted(
            (db.decode_term(int(a)), db.decode_term(int(b)), db.decode_term(int(c)))
            for a, b, c in zip(*db.store.columns()))
    r = Reasoner(device=dev)
    for a, b in (("alice", "bob"), ("bob", "carol"), ("carol", "dave")):
        r.add_abox_triple(a, "parentOf", b)
    r.add_abox_triple("x", "status", "active")
    r.add_abox_triple("x", "status", "inactive")
    r.add_rule(r.rule_from_strings([("?x", "parentOf", "?y")], [("?x", "ancestorOf", "?y")]))
    r.add_rule(r.rule_from_strings([("?x", "parentOf", "?y"), ("?y", "ancestorOf", "?z")],
                                   [("?x", "ancestorOf", "?z")]))
    goal = TriplePattern(Term.variable("a"), Term.constant(r.dictionary.encode("ancestorOf")),
                         Term.constant(r.dictionary.encode("dave")))
    out["backward"] = r.backward_chaining(goal)
    r.add_constraint(r.rule_from_strings(
        [("?s", "status", "active"), ("?s", "status", "inactive")], []))
    out["repairs"] = sorted(map(sorted, r.compute_repairs()))
    out["to_dot"] = to_dot(r)
    return out


def run_prov_small(dev) -> dict:
    """9c: the small programs on ``dev`` against the CPU: every answer
    equal (AddMult tags within ``PROV_ADDMULT_TOL``), each NAF program on
    the device route on both."""
    import torch

    card, host = prov_small_programs(dev), prov_small_programs(torch.device("cpu"))
    for key, got in card.items():
        want = host[key]
        if key.startswith("naf_"):
            if not (got[0] and want[0]) or got[1] != want[1] or got[3] != want[3]:
                raise AssertionError(f"9c {key}: card {got[0]} {got[3]} vs CPU {want[0]} {want[3]}")
            same_tags(want[2], got[2], key == "naf_addmult")
        elif got != want:
            raise AssertionError(f"9c {key}: the card's answer differs from the CPU's")
    if not card["backward"] or len(card["repairs"]) != 2:
        raise AssertionError(f"9c: backward {card['backward']}, repairs {card['repairs']}")
    log(f"9c: NAF programs (Boolean, MinMax, AddMult), PROB wmc/sdd rules, backward chaining "
        f"({len(card['backward'])} answers), repairs ({len(card['repairs'])}) and to_dot equal "
        f"the CPU's")
    return {k: len(v[1]) if k.startswith("naf_") else None for k, v in card.items()}


def run_prov_phase(dev, lubm, universities: int) -> dict:
    """Phase 9 on ``dev``: 9a (the tagged closures at ``PROV_FACTS``), 9b
    (``RULE … PROB`` at the LUBM columns, against the CPU twin) and 9c
    (small programs against the CPU).  Returns the runs and the largest
    kernel inputs phase 5 times."""
    import torch

    from kolibrie_tpu_torch.reasoner.sdd import make_sdd_manager

    captured = {}
    t0 = time.perf_counter()
    closures = run_prov_closures(dev, prov_workload(PROV_FACTS, PROV_SEED), captured)
    t1 = time.perf_counter()
    seeds = prov_seeds(lubm, PROV_SEED)
    card = run_prob_rules(dev, lubm, seeds, captured)
    t2 = time.perf_counter()
    twin = run_prob_rules(torch.device("cpu"), lubm, seeds, {}, twin=True)
    t3 = time.perf_counter()
    check_prob_rules(card, twin, universities, len(seeds))
    small = run_prov_small(dev)
    launches = {}
    for rec in [c["warm"] for c in closures.values()] + list(card.values()):
        for k, n in rec["launches"].items():
            launches[k] = launches.get(k, 0) + n
    for rec in list(card.values()) + list(twin.values()):
        del rec["facts"], rec["tags"]
    log(f"phase 9: 9a {t1 - t0:.1f} s, 9b card {t2 - t1:.1f} s, 9b CPU twin {t3 - t2:.1f} s, "
        f"9c {time.perf_counter() - t3:.1f} s; SDD manager {type(make_sdd_manager()).__name__}; "
        f"warm-run launches {launches}")
    results = {name: rec.pop("result") for name, rec in closures.items()}
    return {"closures": closures, "rules": card, "twin": twin, "small": small,
            "launches": launches, "captured": captured, "results": results}


# --------------------------------------- cross-window SDS+ and incremental R2R

# 10a: benches/bench_cross_window.py's largest grid point
CW_ROADS = 50_000  # avgSpeed triples (alpha 60); lots = roads // 4, two triples each (alpha 120)
CW_RATIOS = (1, 10, 50, 100)
CW_TIME = 60
CW_TRAFFIC = "http://traffic/"
CW_PARKING = "http://parking/"
CW_RESULT = "http://result/"
CW_RULE = """@prefix wt: <http://traffic/> .
@prefix wp: <http://parking/> .
@prefix wr: <http://result/> .
{ ?road wt:avgSpeed ?s . ?lot wp:nearRoad ?road . ?lot wp:occupancy ?occ } => { ?road wr:congested <true> }
"""
# per incremental closure (the device tagged fixpoint, one dispatch at
# least): the rule's three premise scans and its two joins
CW_LAUNCHES = {"filter_mask": 3, "merge_path_join": 2}
# 10b: the same join rule on the engine, its conclusion routed into the
# traffic window so that the window query reads what it derived
CW_TICKS = 180  # not more: the whole smoke must stay inside its time limit
CW_SPEED_PER_TICK = 834  # ~50,000 avgSpeed triples in a 60-tick window
CW_LOTS_PER_TICK = 105  # 2 triples each: ~25,000 in a 120-tick window
CW_LOTS = CW_ROADS // 4
CW_CHECKPOINT_TICK = 140
CW_CPU_FIRINGS = 3  # the CPU run's full-width firings
CW_SEED = 11
CW_MODES = ("naive", "incremental", "auto")
CW_ENGINE_RULE = CW_RULE.replace("wr:congested", "wt:congested")
CW_ENGINE_QUERY = f"""REGISTER RSTREAM <http://city/congestion> AS SELECT ?road ?c ?lot
FROM NAMED WINDOW <{CW_TRAFFIC}> ON <http://city/traffic> [RANGE 60 STEP 10]
FROM NAMED WINDOW <{CW_PARKING}> ON <http://city/parking> [RANGE 120 STEP 10]
WHERE {{ WINDOW <{CW_TRAFFIC}> {{ ?road <congested> ?c }} WINDOW <{CW_PARKING}> {{ ?lot <nearRoad> ?road }} }}"""


def cw_sds(n: int, ratio: int):
    """``benches/bench_cross_window.py::make_sds`` on the port's ``Sds``:
    ``n`` roads' ``avgSpeed`` in the traffic window (alpha 60) and ``n // 4``
    lots' ``nearRoad`` / ``occupancy`` in the parking window (alpha 120);
    the first ``ratio`` % of each carry event times at or after
    ``CW_TIME``."""
    from kolibrie_tpu_torch.reasoner.cross_window import Sds, WindowData, WindowedTriple

    sds = Sds()
    sds.output_iris.add(CW_RESULT)
    upd = n * ratio // 100
    sds.windows[CW_TRAFFIC] = WindowData(60, [
        WindowedTriple(f"road_{i}", "avgSpeed", str(20 + i % 80),
                       (CW_TIME + i % 10) if i < upd else 1 + i % 59)
        for i in range(n)
    ])
    lots = max(n // 4, 1)
    p_upd = lots * ratio // 100
    parking = []
    for j in range(lots):
        et = (CW_TIME + j % 10) if j < p_upd else 1 + j % 119
        parking.append(WindowedTriple(f"lot_{j}", "nearRoad", f"road_{(j * 4) % max(n, 1)}", et))
        parking.append(WindowedTriple(f"lot_{j}", "occupancy", str(50 + j % 50), et))
    sds.windows[CW_PARKING] = WindowData(120, parking)
    return sds


def cw_results(dictionary, buckets) -> set:
    """The decoded RESULT component of an SDS+ result."""
    dec = dictionary.decode
    return {(dec(t.subject), dec(t.predicate), dec(t.object)) for t in buckets.get(CW_RESULT, [])}


def run_cw_point(dev, n: int, ratio: int, captured: dict) -> dict:
    """10a at one update ratio on ``dev``: ``naive_sds_plus`` against
    ``incremental_sds_plus`` from the ratio-0 SDS maintained at time 0 (the
    bench's prior), each timed; the incremental closure's device route
    and launches recorded (counters zeroed just before, read just
    after)."""
    import torch

    from kolibrie_tpu_torch import Dictionary
    from kolibrie_tpu_torch.ops import kernels as K
    from kolibrie_tpu_torch.reasoner import device_provenance as DP
    from kolibrie_tpu_torch.reasoner.cross_window import (
        incremental_sds_plus,
        naive_sds_plus,
        sds_with_expiry_to_external,
    )
    from kolibrie_tpu_torch.reasoner.n3_parser import parse_n3_rules_for_sds

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    d = Dictionary()
    rules, _ = parse_n3_rules_for_sds(CW_RULE, d, [CW_TRAFFIC, CW_PARKING])
    sds = cw_sds(n, ratio)
    t = time.perf_counter()
    naive = naive_sds_plus(rules, sds, d, CW_TIME, device=dev)
    naive_ms = (time.perf_counter() - t) * 1e3
    prior = incremental_sds_plus(rules, cw_sds(n, 0), {}, d, 0, device=dev)
    install, restore = prov_recorders(captured)
    K.reset_launches()
    if on_card:
        install()
    try:
        with DeviceRoute() as route, KernelCalls() as calls:
            sync()
            t = time.perf_counter()
            inc = incremental_sds_plus(rules, sds, prior, d, CW_TIME, device=dev)
            sync()
            inc_ms = (time.perf_counter() - t) * 1e3
    finally:
        restore()
    ext = sds_with_expiry_to_external(inc, d, [CW_TRAFFIC, CW_PARKING, CW_RESULT])
    rec = {
        "ratio": ratio, "naive_ms": naive_ms, "incremental_ms": inc_ms,
        "naive": cw_results(d, naive), "incremental": cw_results(d, ext),
        "route": route.accepted, "rounds": DP.LAST_RUN["rounds"] if route.accepted else None,
        "dispatches": len(DP.LAST_RUN["dispatches"]) if route.accepted else 0,
        "launches": prov_launches(on_card, calls),
    }
    log(f"10a {dev.type} ratio {ratio}%: naive {naive_ms:.1f} ms, incremental {inc_ms:.1f} ms "
        f"({len(rec['incremental'])} results, route {route.accepted}, {rec['rounds']} rounds, "
        f"launches {rec['launches']})")
    return rec


def check_cw_points(card: list, cpu: list, on_card: bool) -> None:
    """10a's gates: naive and incremental RESULT sets equal, each equal to
    the CPU run's and not empty; on the card every incremental closure took
    the device route and launched ``CW_LAUNCHES`` per dispatch."""
    for c, h in zip(card, cpu):
        want = h["naive"]
        if not want or c["naive"] != want or c["incremental"] != want or h["incremental"] != want:
            raise AssertionError(f"10a ratio {c['ratio']}%: RESULT sets differ "
                                 f"({len(c['naive'])}, {len(c['incremental'])}, {len(want)})")
        if on_card:
            if c["route"] != [True]:
                raise AssertionError(f"10a ratio {c['ratio']}%: device route {c['route']}")
            for k, n in CW_LAUNCHES.items():
                if c["launches"].get(k, 0) < n * c["dispatches"]:
                    raise AssertionError(f"10a ratio {c['ratio']}%: launches {c['launches']}")
    log(f"10a: naive and incremental RESULT sets equal each other and the CPU run at "
        f"{[c['ratio'] for c in card]}%")


def cw_stream(ticks: int, seed: int) -> list:
    """10b's stream: at each tick 1 .. ``ticks``, ``CW_SPEED_PER_TICK``
    ``avgSpeed`` readings on the next roads in turn (speeds from
    ``default_rng(seed)``), then ``CW_LOTS_PER_TICK`` lots in turn, each
    with its ``nearRoad`` (``road_{4 lot}``) and an ``occupancy`` draw.
    Returns ``(ts, stream IRI, WindowTriple)`` triples."""
    import numpy as np

    from kolibrie_tpu_torch import WindowTriple

    rng = np.random.default_rng(seed)
    out = []
    for ts in range(1, ticks + 1):
        speeds = rng.integers(5, 120, CW_SPEED_PER_TICK).tolist()
        occ = rng.integers(0, 100, CW_LOTS_PER_TICK).tolist()
        r0 = (ts - 1) * CW_SPEED_PER_TICK
        for k, v in enumerate(speeds):
            out.append((ts, "http://city/traffic",
                        WindowTriple(f"road_{(r0 + k) % CW_ROADS}", "avgSpeed", str(v))))
        l0 = (ts - 1) * CW_LOTS_PER_TICK
        for k, v in enumerate(occ):
            lot = (l0 + k) % CW_LOTS
            out.append((ts, "http://city/parking",
                        WindowTriple(f"lot_{lot}", "nearRoad", f"road_{(lot * 4) % CW_ROADS}")))
            out.append((ts, "http://city/parking", WindowTriple(f"lot_{lot}", "occupancy", str(v))))
    return out


def cw_engine(dev, mode: str, cycles: list):
    """``RSPBuilder(CW_ENGINE_QUERY)`` with the cross-window rule in
    ``mode`` on ``dev``; each SDS+ cycle appends to ``cycles`` its emitted
    rows, wall ms, chosen mode, device route, kernel launches and window
    content."""
    import torch

    from kolibrie_tpu_torch import RSPBuilder
    from kolibrie_tpu_torch.ops import kernels as K

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    engine = (RSPBuilder(CW_ENGINE_QUERY, device=dev).set_cross_window_rules(CW_ENGINE_RULE)
              .set_cross_window_reasoning_mode(mode)
              .with_consumer(lambda row: cycles[-1]["rows"].append(row)).build())
    cycle, auto = engine._emit_cross_window, engine._auto_mode

    def chosen(sds):
        m = auto(sds)
        cycles[-1]["mode"] = m
        return m

    def timed_cycle(ts):
        cycles.append({"ts": ts, "rows": [], "mode": mode})
        before = {**K.LAUNCHES, **K.ENTRY_LAUNCHES}
        with DeviceRoute() as route, KernelCalls() as calls:
            sync()
            t = time.perf_counter()
            cycle(ts)
            sync()
        rec = cycles[-1]
        rec["wall_ms"] = (time.perf_counter() - t) * 1e3
        rec["route"] = route.accepted
        after = {**K.LAUNCHES, **K.ENTRY_LAUNCHES}
        rec["launches"] = ({k: after[k] - before[k] for k in before if after[k] > before[k]}
                           if on_card else dict(calls.counts))
        with engine._cw_lock:
            rec["content"] = {k: len(v) for k, v in engine._latest_contents.items()}
        rec["rows"] = sorted(rec["rows"])

    engine._emit_cross_window, engine._auto_mode = timed_cycle, chosen
    return engine


def carry_terms(engine, terms) -> None:
    """Give ``engine`` (fresh, nothing streamed yet) the dictionary
    ``terms``.  An engine checkpoint holds the SDS+ state and the latest
    window contents as dictionary IDs (the reference's format), so a
    restart restores the terms with the data (as
    ``SparqlDatabase.from_checkpoint`` does) before the engine state."""
    engine.dictionary = engine.r2r.db.dictionary = engine.static_db.dictionary = terms


def run_cw_engine(dev, mode: str, stream: list, checkpoint_tick=None) -> dict:
    """Drive ``stream`` through :func:`cw_engine`; with ``checkpoint_tick``,
    also checkpoint the engine once every event up to that tick is in,
    restore the blob into a fresh engine (given the first engine's terms,
    :func:`carry_terms`) and feed it the rest of the stream."""
    from kolibrie_tpu_torch import Dictionary

    cycles: list = []
    engine = cw_engine(dev, mode, cycles)
    blob, t0 = None, time.perf_counter()
    for ts, stream_iri, item in stream:
        if checkpoint_tick is not None and blob is None and ts > checkpoint_tick:
            blob = engine.checkpoint_state()
            terms = Dictionary.from_terms(engine.dictionary.id_to_str)
            mark = len(cycles)
        engine.add_to_stream(stream_iri, item, ts)
    engine.process_single_thread_window_results()
    wall_s = time.perf_counter() - t0
    engine.stop()
    out = {"cycles": cycles, "wall_s": wall_s, "dead_letters": engine.dead_letters}
    if blob is not None:
        resumed: list = []
        fresh = cw_engine(dev, mode, resumed)
        carry_terms(fresh, terms)
        fresh.restore_state(blob)
        for ts, stream_iri, item in stream:
            if ts > checkpoint_tick:
                fresh.add_to_stream(stream_iri, item, ts)
        fresh.process_single_thread_window_results()
        fresh.stop()
        out.update(resumed=resumed, resumed_from=mark, blob_bytes=len(blob))
    for rec in cycles:
        log(f"10b {dev.type} {mode} cycle at {rec['ts']}: {rec['mode']}, windows {rec['content']}, "
            f"{len(rec['rows'])} rows, {rec['wall_ms']:.1f} ms, route {rec['route']}, "
            f"launches {rec['launches']}")
    log(f"10b {dev.type} {mode}: {len(stream)} events, {len(cycles)} cycles in {wall_s:.2f} s")
    return out


def cw_full(cycle: dict) -> bool:
    """Both windows of a 10b cycle hold their full width (99% of the
    distinct roads or lot triples a window can hold)."""
    traffic = min(CW_ROADS, 60 * CW_SPEED_PER_TICK)
    parking = 2 * min(CW_LOTS, 120 * CW_LOTS_PER_TICK)
    c = cycle["content"]
    return c.get(CW_TRAFFIC, 0) >= 0.99 * traffic and c.get(CW_PARKING, 0) >= 0.99 * parking


def check_cw_engine(runs: dict, cpu: dict, on_card: bool) -> None:
    """10b's gates: every mode emitted the same rows cycle by cycle, rows in
    every full-width cycle; the first ``CW_CPU_FIRINGS`` full-width cycles
    equal the CPU naive run's; the restored incremental engine emitted the
    uninterrupted run's rows; on the card every incremental cycle took the
    device route and launched its kernels; nothing was dead-lettered."""
    base = runs["naive"]["cycles"]
    full = [k for k, c in enumerate(base) if cw_full(c)]
    for mode, run in runs.items():
        if run["dead_letters"]:
            raise AssertionError(f"10b {mode}: dead letters {run['dead_letters']}")
        cyc = run["cycles"]
        if len(cyc) != len(base) or any(a["rows"] != b["rows"] for a, b in zip(cyc, base)):
            raise AssertionError(f"10b {mode}: rows differ from the naive run's")
        if on_card:
            for c in cyc:
                if c["mode"] == "incremental" and (c["route"] != [True] or any(
                        c["launches"].get(k, 0) < n for k, n in CW_LAUNCHES.items())):
                    raise AssertionError(f"10b {mode} cycle at {c['ts']}: route {c['route']}, "
                                         f"launches {c['launches']}")
    if not full or any(not base[k]["rows"] for k in full):
        raise AssertionError("10b: a full-width cycle emitted no rows")
    cpu_full = [c for c in cpu["cycles"] if cw_full(c)][:CW_CPU_FIRINGS]
    if len(cpu_full) < CW_CPU_FIRINGS or any(
            c["rows"] != base[k]["rows"] for c, k in zip(cpu_full, full)):
        raise AssertionError("10b: the card's full-width cycles differ from the CPU run's")
    inc = runs["incremental"]
    tail = inc["cycles"][inc["resumed_from"]:]
    if not tail or [c["rows"] for c in inc["resumed"]] != [c["rows"] for c in tail]:
        raise AssertionError("10b: the restored engine's rows differ from the uninterrupted run")
    modes = {c["mode"] for c in runs["auto"]["cycles"]}
    log(f"10b: {len(base)} cycles ({len(full)} full width) equal across {list(runs)} "
        f"(auto chose {sorted(modes)}), the first {CW_CPU_FIRINGS} full-width equal the CPU "
        f"run's, {len(tail)} cycles after the tick-{CW_CHECKPOINT_TICK} checkpoint equal")


def run_cw_phase(dev, rsp_card: dict) -> dict:
    """Phase 10: 10a (``CW_ROADS`` at ``CW_RATIOS``, naive against
    incremental, against the CPU), 10b (the engine in every mode over
    ``CW_TICKS`` ticks, against the CPU's naive run and across a
    checkpoint) and 10c (phase 7's stream under the incremental R2R against
    phase 7's device rows).  Returns the runs and the largest kernel inputs
    phase 5 times."""
    import torch

    cpu = torch.device("cpu")
    on_card = dev.type == "cuda"
    captured = {}
    t0 = time.perf_counter()
    card_pts = [run_cw_point(dev, CW_ROADS, r, captured) for r in CW_RATIOS]
    cpu_pts = [run_cw_point(cpu, CW_ROADS, r, {}) for r in CW_RATIOS]
    check_cw_points(card_pts, cpu_pts, on_card)
    t1 = time.perf_counter()
    stream = cw_stream(CW_TICKS, CW_SEED)
    install, restore = prov_recorders(captured)
    if on_card:
        install()
    try:
        runs = {m: run_cw_engine(dev, m, stream,
                                 CW_CHECKPOINT_TICK if m == "incremental" else None)
                for m in CW_MODES}
    finally:
        restore()
    # through the tick that closes the card run's third full-width cycle
    last = [c["ts"] for c in runs["naive"]["cycles"] if cw_full(c)][CW_CPU_FIRINGS - 1] + 1
    cpu_run = run_cw_engine(cpu, "naive", [e for e in stream if e[0] <= last])
    check_cw_engine(runs, cpu_run, on_card)
    t2 = time.perf_counter()
    inc = run_rsp(dev, "incremental", rsp_stream(RSP_PERSONS, RSP_EVENTS_PER_TICK, RSP_TICKS,
                                                 RSP_SEED))
    check_incremental_r2r(inc, rsp_card, on_card)
    t3 = time.perf_counter()
    launches = {}
    for c in card_pts:
        for k, n in c["launches"].items():
            launches[k] = launches.get(k, 0) + n
    for run in runs.values():
        for c in run["cycles"]:
            for k, n in c["launches"].items():
                launches[k] = launches.get(k, 0) + n
    for k, n in inc["launches"].items():
        launches[k] = launches.get(k, 0) + n
    log(f"phase 10: 10a {t1 - t0:.1f} s, 10b {t2 - t1:.1f} s, 10c {t3 - t2:.1f} s; "
        f"launches {launches}")
    for c in card_pts + cpu_pts:
        del c["naive"], c["incremental"]
    for k, (key, args) in inc["captured"].items():
        if key > captured.get(k, (key, None))[0] or k not in captured:
            captured[k] = (key, args)
    return {"points": card_pts, "engine": runs, "incremental_r2r": inc, "launches": launches,
            "captured": captured, "seconds": {"10a": t1 - t0, "10b": t2 - t1, "10c": t3 - t2}}


def check_incremental_r2r(inc: dict, card: dict, on_card: bool) -> None:
    """10c's gates: phase 7's stream under ``set_r2r_mode("incremental")``
    fired as often as phase 7's device run, with its rows and derived
    counts firing by firing, no dead letters, and on the card every firing
    closed on the device tagged fixpoint."""
    if inc["dead_letters"]:
        raise AssertionError(f"10c: dead letters {inc['dead_letters']}")
    if len(inc["firings"]) != len(card["firings"]):
        raise AssertionError("10c: fired a different number of times than phase 7")
    for k, (a, b) in enumerate(zip(inc["firings"], card["firings"])):
        if a["rows"] != b["rows"] or a["derived"] != b["derived"]:
            raise AssertionError(f"10c firing {k}: {len(a['rows'])} rows / {a['derived']} derived, "
                                 f"phase 7 {len(b['rows'])} / {b['derived']}")
        if on_card and a.get("route") != [True]:
            raise AssertionError(f"10c firing {k}: device route {a.get('route')}")
    log(f"10c: {len(inc['firings'])} firings equal phase 7's device rows and derived counts, "
        f"every one on the device tagged fixpoint" if on_card else
        f"10c: {len(inc['firings'])} firings equal phase 7's rows and derived counts")


# ------------------------------------------------ bulk load and checkpoints

LOAD_INSERT = ("INSERT DATA { <http://load.example/a> <http://load.example/p> "
               "<http://load.example/b> }")
BUILDER_PREDICATE = "subOrganizationOf"


def native_spy(db) -> list:
    """Make ``db`` record the row count of every native bulk ingest."""
    calls = []
    ingest = db._ingest_native_session

    def spy(ids, terms):
        calls.append(int(ids.shape[0]))
        return ingest(ids, terms)

    db._ingest_native_session = spy
    return calls


def sorted_rows(rows) -> list:
    return sorted(map(tuple, rows))


def run_load_phase(dev, main_path: dict, lubm, emp) -> dict:
    """Phase 11 on ``dev``: LUBM-1000 written with ``to_ntriples`` to a
    temporary file and ``load_file``-d into a fresh database through the
    native parser; Q2 and Q9 (cold, warm) against phase 4's rows and warm
    launches; ``checkpoint`` + ``from_checkpoint`` (Q9 again); ``clone`` +
    INSERT DATA leaving the original alone; ``union`` with employee-100K
    answering the employee join; employee-100K through ``to_turtle`` and
    through ``to_rdfxml`` + ``parse_rdf``; one ``QueryBuilder`` query
    against its SPARQL twin.  Every step timed; launch counters zeroed just
    before the queries and read just after."""
    import tempfile

    import torch

    from benches.lubm import LUBM_Q2, LUBM_Q9, UB
    from kolibrie_tpu_torch import SparqlDatabase, execute_query_volcano
    from kolibrie_tpu_torch.ops import kernels as K

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    ms: dict = {}

    def step(name, fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        ms[name] = ms.get(name, 0.0) + (time.perf_counter() - t) * 1e3
        return out

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    want = {"q2": sorted_rows(main_path["rows"]["q2"]), "q9": sorted_rows(main_path["rows"]["q9"])}
    phase4 = main_path["report"]["queries"]
    kernels = ("merge_path_join", "lex_probe_select", "lex_probe_validate")
    captured: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lubm.nt")
        text = step("to_ntriples", lubm.to_ntriples)

        def write():
            with open(path, "w", encoding="utf-8") as fh:
                fh.write(text)

        step("write", write)
        nbytes = len(text)
        del text
        db = SparqlDatabase(device=dev)
        native = native_spy(db)
        n = step("load_file", lambda: db.load_file(path))
        if n != len(lubm) or native != [n] or len(db) != len(lubm):
            raise AssertionError(f"11: load_file read {n} rows ({len(db)} triples), native "
                                 f"ingests {native}, expected {len(lubm)} through the native parser")
        step("upload", lambda: [db.store.device_segment(o) for o in ("spo", "pos", "osp")])

        def run(name, q, target, label):
            rows = []
            for rep in range(2):
                before = {**K.LAUNCHES, **K.ENTRY_LAUNCHES}
                rows = step(f"{label}_{'cold' if rep == 0 else 'warm'}",
                            lambda: execute_query_volcano(q, target))
            after = {**K.LAUNCHES, **K.ENTRY_LAUNCHES}
            warm = {k: after[k] - before[k] for k in kernels}
            if sorted_rows(rows) != want[name]:
                raise AssertionError(f"11 {label}: rows differ from phase 4's")
            # phase 4's warm launches (``chip_profile.py`` passes none)
            if on_card and name in phase4 and any(
                    warm[k] != phase4[name]["warm_launches"][k] for k in kernels):
                raise AssertionError(f"11 {label}: warm launches {warm}, phase 4 "
                                     f"{ {k: phase4[name]['warm_launches'][k] for k in kernels} }")
            return warm

        K.reset_launches()
        rec = recorder_install(captured)
        try:
            warm = {"q2": run("q2", LUBM_Q2, db, "q2"), "q9": run("q9", LUBM_Q9, db, "q9")}
        finally:
            rec()
        launches = {k: v for k, v in {**K.LAUNCHES, **K.ENTRY_LAUNCHES}.items() if v}
        ckpt = os.path.join(tmp, "lubm.npz")
        step("checkpoint", lambda: db.checkpoint(ckpt))
        ckpt_bytes = os.path.getsize(ckpt)
        restored = step("from_checkpoint", lambda: SparqlDatabase.from_checkpoint(ckpt, device=dev))
    run("q9", LUBM_Q9, restored, "q9_restored")
    before = len(db)
    clone = step("clone", db.clone)
    step("insert_data", lambda: execute_query_volcano(LOAD_INSERT, clone))
    if len(clone) != before + 1 or len(db) != before or sorted_rows(
            execute_query_volcano(LUBM_Q9, db)) != want["q9"]:
        raise AssertionError("11: clone + INSERT DATA changed the original")
    union = step("union", lambda: restored.union(emp))
    emp_rows = execute_query_volcano(EMPLOYEE_QUERY, union)
    if sorted_rows(emp_rows) != sorted_rows(main_path["rows"]["employee"]):
        raise AssertionError("11: the union's employee join differs from phase 4's")
    emp_set = sorted(emp.iter_decoded())
    for fmt, parse in (("to_turtle", "parse_turtle"), ("to_rdfxml", "parse_rdf")):
        text = step(fmt, getattr(emp, fmt))
        back = SparqlDatabase(device=dev)
        step(parse, lambda: getattr(back, parse)(text))
        if sorted(back.iter_decoded()) != emp_set:
            raise AssertionError(f"11: employee-100K does not round-trip through {fmt}")
    built = step("query_builder", lambda: db.query().with_predicate(UB + BUILDER_PREDICATE)
                 .get_decoded_triples())
    twin = execute_query_volcano(
        f"SELECT ?s ?o WHERE {{ ?s <{UB}{BUILDER_PREDICATE}> ?o }}", db)
    if sorted((s, o) for s, _p, o in built) != sorted_rows(twin) or not twin:
        raise AssertionError("11: the QueryBuilder query differs from its SPARQL twin")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    log(f"11: {len(db)} triples ({nbytes} bytes of N-Triples) through the native parser; Q2, Q9 "
        f"and Q9 after from_checkpoint ({ckpt_bytes} bytes) equal phase 4's rows, warm launches "
        f"{warm}; clone, union, turtle and RDF/XML round trips, QueryBuilder ({len(built)} "
        f"triples) equal; peak device memory {peak} B; ms " +
        ", ".join(f"{k} {v:.1f}" for k, v in ms.items()))
    return {"ms": ms, "launches": launches, "warm": warm, "captured": captured, "peak_bytes": peak,
            "nt_bytes": nbytes, "checkpoint_bytes": ckpt_bytes}


def recorder_install(captured: dict):
    """Keep phase 11's largest merge-path and lex-probe calls (no readback)
    for phase 5; returns the undo."""
    from kolibrie_tpu_torch.ops import kernels as K
    from kolibrie_tpu_torch.optimizer import device_engine as DE

    saved = (K.merge_path, DE.lex_probe_select, DE.lex_probe_validate)

    def rec(name, fn, size):
        def wrapped(*a):
            if size(a) >= captured.get(name, (0, None))[0]:
                captured[name] = (size(a), a)
            return fn(*a)
        return wrapped

    K.merge_path = rec("merge_path_join", saved[0], lambda a: a[6])
    DE.lex_probe_select = rec("lex_probe_select", saved[1], lambda a: a[0].shape[0])
    DE.lex_probe_validate = rec("lex_probe_validate", saved[2], lambda a: a[0].shape[0])

    def undo():
        K.merge_path, DE.lex_probe_select, DE.lex_probe_validate = saved

    return undo



# ------------------------------------------------- phase 12: neurosymbolic ML

ML_NS = "http://e/"
ML_SAMPLES = 100_000  # 12c: digit samples, three triples each
ML_MEASUREMENTS = 20_000  # 12b: ten times tests/test_ml.py's TrainerScale, two triples each
ML_MLP_ROWS = 4_096  # 12a: rows of each batch
ML_ADAM_STEPS = 50
ML_SEED = 13
# card against the port's CPU run, f32 throughout (TF32 off; cuBLAS and the
# CPU sum in other orders): the same weights give probabilities within
# ML_PROB_TOL and gradients within ML_GRAD_TOL of the array's largest; from
# the same initial weights, the weights after training within ML_TRAIN_TOL
# and each epoch's loss within ML_LOSS_RTOL relative.  The H100 measured
# 1.2e-7, 3.1e-6, 7.2e-7 and 8.7e-8 (after 50 Adam steps, 3 epochs of 391
# batches and 5 of 313): each bound is 30-140 times the measured drift
ML_PROB_TOL = 1e-5
ML_GRAD_TOL = 1e-4
ML_TRAIN_TOL = 1e-4
ML_LOSS_RTOL = 1e-5
XSD_TRUE = '"true"^^<http://www.w3.org/2001/XMLSchema#boolean>'
ML_DIGIT_STATEMENT = """PREFIX ex: <http://e/>
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
TRAIN NEURAL RELATION ex:predictedDigit {
    DATA { ?sample ex:label ?label . }
    LABEL ?label
    TARGET { ?sample ex:predictedDigit ?label }
    LOSS cross_entropy
    OPTIMIZER adam
    LEARNING_RATE 0.05
    EPOCHS 3
    BATCH_SIZE 256
    SAVE_TO "<save>"
}"""
ML_ALERT_RULE = ("PREFIX ex: <http://e/>\nRULE :alertRule :- CONSTRUCT { ?m ex:alert \"yes\" . } "
                 f"WHERE {{ ?m ex:predictedHot {XSD_TRUE} . }}")
ML_HOT_STATEMENT = """PREFIX ex: <http://e/>
MODEL "hot2" { ARCH MLP { HIDDEN [8] } OUTPUT BINARY }
NEURAL RELATION ex:predictedHot USING MODEL "hot2" {
    INPUT { ?m ex:temp ?t . }
    FEATURES { ?t }
}
TRAIN NEURAL RELATION ex:predictedHot {
    DATA { ?m ex:isHot ?hot . }
    LABEL ?hot
    TARGET { ?m ex:predictedHot ?l }
    LOSS bce
    EPOCHS 5
    BATCH_SIZE 64
    LEARNING_RATE 0.1
}"""
ML_PREDICT = {
    "digit": """PREFIX ex: <http://e/>
ML.PREDICT(MODEL "digit_model",
    INPUT { SELECT ?sample ?x0 ?x1 WHERE { ?sample ex:x0 ?x0 . ?sample ex:x1 ?x1 . } },
    OUTPUT ?digit)""",
    "hot": """PREFIX ex: <http://e/>
ML.PREDICT(MODEL "hot2", INPUT { SELECT ?m ?t WHERE { ?m ex:temp ?t . } }, OUTPUT ?hot)""",
}
ML_STAR = {
    "digit": "PREFIX ex: <http://e/> PREFIX prob: <http://kolibrie.tpu/prob#> "
             "SELECT ?s ?d ?p WHERE { << ?s ex:predictedDigit ?d >> prob:value ?p }",
    "hot": "PREFIX ex: <http://e/> PREFIX prob: <http://kolibrie.tpu/prob#> "
           "SELECT ?s ?d ?p WHERE { << ?s ex:predictedHot ?d >> prob:value ?p }",
}
ML_DIGIT_SELECT = "PREFIX ex: <http://e/> SELECT ?s ?d WHERE { ?s ex:predictedDigit ?d }"
ML_ALARM_RULE = ("PREFIX ex: <http://e/>\nRULE :alarm :- CONSTRUCT { ?m ex:alarm \"on\" . } "
                 f"WHERE {{ ?m ex:predictedHot {XSD_TRUE} . ?m ex:temp ?t . }}")
ML_ALARMS = ('PREFIX ex: <http://e/> SELECT (COUNT(?m) AS ?n) WHERE { ?m ex:alarm "on" }')


def ml_digit_draw(n: int, seed: int) -> tuple:
    """``tests/test_ml.py``'s digit samples at ``n``: class 0 near
    (0.1, 0.9), class 1 near (0.9, 0.1), sigma 0.05, as ``(x0, x1, label)``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    label = np.arange(n) % 2
    x0 = np.where(label == 0, 0.1, 0.9) + rng.normal(0, 0.05, n)
    x1 = np.where(label == 0, 0.9, 0.1) + rng.normal(0, 0.05, n)
    return x0, x1, label


def ml_digit_ntriples(n: int, seed: int) -> str:
    """``ml_digit_draw``'s samples as N-Triples, four decimals."""
    x0, x1, label = ml_digit_draw(n, seed)
    return "".join(
        f'<{ML_NS}s{i}> <{ML_NS}x0> "{a:.4f}" .\n<{ML_NS}s{i}> <{ML_NS}x1> "{b:.4f}" .\n'
        f'<{ML_NS}s{i}> <{ML_NS}label> "{c}" .\n'
        for i, (a, b, c) in enumerate(zip(x0.tolist(), x1.tolist(), label.tolist())))


def ml_sensor_ntriples(n: int, seed: int) -> str:
    """``tests/test_ml.py:240-250``'s sensor graph at ``n`` measurements:
    hot ones near 80, cold ones near 50, sigma 3."""
    import numpy as np

    rng = np.random.default_rng(seed)
    hot = np.arange(n) % 2
    t = np.where(hot == 1, 80.0, 50.0) + rng.normal(0, 3, n)
    return "".join(
        f'<{ML_NS}m{i}> <{ML_NS}temp> "{v:.2f}" .\n'
        f'<{ML_NS}m{i}> <{ML_NS}isHot> "{"true" if h else "false"}" .\n'
        for i, (v, h) in enumerate(zip(t.tolist(), hot.tolist())))


def mlp_cotangent(probs, y):
    """The cross-entropy (exclusive) or BCE (binary) cotangent of mean
    loss over the batch."""
    import numpy as np

    p = np.clip(np.asarray(probs, np.float64), 1e-7, 1 - 1e-7)
    if p.ndim == 1:
        return (-(y / p) + (1 - y) / (1 - p)) / len(p)
    cot = np.zeros_like(p)
    cot[np.arange(len(p)), y] = -1.0 / p[np.arange(len(p)), y] / len(p)
    return cot


def near_boundary(probs, tol: float) -> int:
    """Rows whose decision could flip under a change of ``tol`` in their
    probabilities: within ``tol`` of 0.5 (binary) or of a tie (exclusive)."""
    import numpy as np

    p = np.asarray(probs)
    if p.ndim == 1:
        return int((np.abs(p - 0.5) <= tol).sum())
    top = np.sort(p, axis=1)
    return int((top[:, -1] - top[:, -2] <= 2 * tol).sum())


def run_mlp_alone(dev) -> dict:
    """12a: the digit model (``HIDDEN [16]``, exclusive over "0"/"1") and
    the hot model (``HIDDEN [8]``, binary) on ``ML_MLP_ROWS``-row batches:
    forward, VJP and ``ML_ADAM_STEPS`` Adam steps on ``dev`` against the
    port's CPU run from the same weights."""
    import numpy as np
    import torch

    from kolibrie_tpu_torch.ml.mlp import MlpNeuralPredicate

    if dev.type == "cuda" and (torch.backends.cuda.matmul.allow_tf32
                               or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("12a: TF32 matmuls are on")
    rng = np.random.default_rng(ML_SEED)
    out = {}
    for name, in_dim, hidden, kind, labels in (("digit", 2, [16], "exclusive", ["0", "1"]),
                                               ("hot", 1, [8], "binary", None)):
        card = MlpNeuralPredicate(in_dim, hidden, kind, labels, learning_rate=0.05,
                                  seed=ML_SEED, device=dev)
        cpu = MlpNeuralPredicate.from_params(card.params_numpy(), kind, labels, 0.05,
                                             device="cpu")
        for m in (card, cpu):
            m.set_normalization(np.full(in_dim, 0.5), np.full(in_dim, 0.3))
        x = rng.uniform(0, 1, size=(ML_MLP_ROWS, in_dim))
        y = (x[:, 0] > 0.5).astype(np.int64)
        yb = y if kind == "exclusive" else y.astype(np.float64)
        probs, backward = card.forward_with_vjp(x)
        cprobs, cbackward = cpu.forward_with_vjp(x)
        prob_err = float(np.abs(probs - cprobs).max())
        cot = mlp_cotangent(cprobs, yb)
        grad_err = max(
            float((g.cpu() - c).abs().max()) / max(float(c.abs().max()), 1e-30)
            for gc, cc in zip(backward(cot), cbackward(cot)) for g, c in zip(gc, cc))
        if prob_err > ML_PROB_TOL or grad_err > ML_GRAD_TOL:
            raise AssertionError(f"12a {name}: forward {prob_err}, VJP {grad_err} relative")
        for _step in range(ML_ADAM_STEPS):
            for m in (card, cpu):
                p, bw = m.forward_with_vjp(x)
                m.apply_gradients(bw(mlp_cotangent(p, yb)))
        drift = max(float(np.abs(a - b).max()) for (aw, ab), (bw_, bb) in
                    zip(card.params_numpy(), cpu.params_numpy()) for a, b in ((aw, bw_), (ab, bb)))
        after, cafter = card.predict(x), cpu.predict(x)
        flips = int((np.asarray(card.predict_labels(x)) != np.asarray(cpu.predict_labels(x))).sum())
        near = near_boundary(cafter, float(np.abs(after - cafter).max()))
        if drift > ML_TRAIN_TOL or flips > near:
            raise AssertionError(f"12a {name}: weights drift {drift} after {ML_ADAM_STEPS} steps, "
                                 f"{flips} labels flipped ({near} rows near the boundary)")
        out[name] = {"prob_err": prob_err, "grad_rel_err": grad_err, "drift": drift,
                     "prob_drift": float(np.abs(after - cafter).max()), "flips": flips,
                     "near_boundary": near}
        log(f"12a {name}: forward err {prob_err!r}, VJP err {grad_err!r} (relative), after "
            f"{ML_ADAM_STEPS} Adam steps weights drift {drift!r}, probabilities "
            f"{out[name]['prob_drift']!r}, {flips} labels flipped, {near} near the boundary")
    return out


class MlSpy:
    """Per-sample losses and SDD closures of TRAIN (``ml.runtime``)."""

    def __enter__(self):
        from kolibrie_tpu_torch.ml import runtime as R

        self.losses, self.closures = [], 0
        self._saved = (R._loss_grad, R.infer_new_facts_with_sdd_seed_specs)
        loss, infer = self._saved

        def loss_rec(*a, **k):
            v = loss(*a, **k)
            self.losses.append(v[0])
            return v

        def infer_rec(*a, **k):
            self.closures += 1
            return infer(*a, **k)

        R._loss_grad, R.infer_new_facts_with_sdd_seed_specs = loss_rec, infer_rec
        return self

    def __exit__(self, *exc):
        from kolibrie_tpu_torch.ml import runtime as R

        R._loss_grad, R.infer_new_facts_with_sdd_seed_specs = self._saved
        return False

    def epoch_losses(self, epochs: int) -> list:
        import numpy as np

        return np.asarray(self.losses).reshape(epochs, -1).sum(axis=1).tolist()


def ml_statement(dev, db, label: str, q: str, record: dict):
    """Run one statement, timed (synchronised) with its launch counts."""
    import torch

    from kolibrie_tpu_torch import execute_query_volcano
    from kolibrie_tpu_torch.ops import kernels as K

    before = {**K.LAUNCHES, **K.ENTRY_LAUNCHES}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    rows = execute_query_volcano(q, db)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    after = {**K.LAUNCHES, **K.ENTRY_LAUNCHES}
    launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    record[label] = {"ms": ms, "launches": launches}
    log(f"12 {label} [{dev.type}]: {ms:.1f} ms, launches {launches}")
    return rows


def ml_train(dev, db, label: str, q: str, model, epochs: int, record: dict) -> dict:
    """TRAIN ``q`` on ``db`` from ``model``'s weights (placed in
    ``trained_models`` first): per-epoch losses, closures, final weights."""
    name = re.search(r'USING MODEL "([^"]+)"', q).group(1)
    db.trained_models[name] = model
    with MlSpy() as spy:
        ml_statement(dev, db, label, q, record)
    trained = db.trained_models[name]
    return {"losses": spy.epoch_losses(epochs), "closures": spy.closures,
            "params": trained.params_numpy(), "model": trained}


def check_ml_train(label: str, card: dict, cpu: dict, closures: int) -> None:
    import numpy as np

    drift = max(float(np.abs(a - b).max()) for (aw, ab), (bw, bb) in
                zip(card["params"], cpu["params"]) for a, b in ((aw, bw), (ab, bb)))
    loss_err = float(np.max(np.abs(np.subtract(card["losses"], cpu["losses"]))
                            / np.abs(cpu["losses"])))
    log(f"12 {label}: epoch losses card {card['losses']}, CPU {cpu['losses']} (relative err "
        f"{loss_err!r}); weights drift {drift!r}; closures {card['closures']}")
    if card["closures"] != closures or cpu["closures"] != closures:
        raise AssertionError(f"12 {label}: closures {card['closures']} / {cpu['closures']}, "
                             f"expected {closures}")
    if drift > ML_TRAIN_TOL or loss_err > ML_LOSS_RTOL:
        raise AssertionError(f"12 {label}: card and CPU differ: weights {drift}, losses {loss_err}")


def run_ml_predict(dev, dbs: dict, record: dict) -> dict:
    """12d on ``dbs`` (``"digit"``: 12c's database, ``"hot"``: 12b's):
    ML.PREDICT over every sample and measurement, the SPARQL-star read of
    the probabilities, a SELECT naming ``ex:predictedDigit`` (the
    materialisation pre-pass), and a RULE whose body names
    ``ex:predictedHot`` with the count of what it derived."""
    out = {}
    for name in ("digit", "hot"):
        ml_statement(dev, dbs[name], f"ml_predict_{name}", ML_PREDICT[name], record)
        out[f"star_{name}"] = ml_statement(dev, dbs[name], f"star_{name}", ML_STAR[name], record)
    out["digit_select"] = ml_statement(dev, dbs["digit"], "select_predicted_digit",
                                       ML_DIGIT_SELECT, record)
    ml_statement(dev, dbs["hot"], "rule_predicted_hot", ML_ALARM_RULE, record)
    out["alarms"] = ml_statement(dev, dbs["hot"], "alarms", ML_ALARMS, record)
    out["sizes"] = {k: len(db) for k, db in dbs.items()}
    return out


def check_ml_predict(card: dict, cpu: dict) -> dict:
    """Card rows against the CPU run's, which used the card's weights: equal
    but for the labels of rows within ``ML_PROB_TOL`` of the decision
    boundary, probabilities within ``ML_PROB_TOL``.  Returns the counts."""
    counts = {}
    if card["sizes"] != cpu["sizes"]:
        raise AssertionError(f"12d: store sizes {card['sizes']} against {cpu['sizes']}")
    for name, n in (("digit", ML_SAMPLES), ("hot", ML_MEASUREMENTS)):
        got = {r[0]: (r[1], float(r[2])) for r in card[f"star_{name}"]}
        want = {r[0]: (r[1], float(r[2])) for r in cpu[f"star_{name}"]}
        if len(got) != n or got.keys() != want.keys():
            raise AssertionError(f"12d {name}: {len(got)} / {len(want)} predictions of {n}")
        perr = max(abs(got[k][1] - want[k][1]) for k in got)
        flips = sum(got[k][0] != want[k][0] for k in got)
        near = sum(abs(want[k][1] - 0.5) <= ML_PROB_TOL for k in got)
        if perr > ML_PROB_TOL or flips > near:
            raise AssertionError(f"12d {name}: probabilities differ by {perr}, {flips} labels "
                                 f"flipped, {near} near the boundary")
        counts[name] = {"predictions": n, "prob_err": perr, "flips": flips, "near_boundary": near}
    got, want = sorted_rows(card["digit_select"]), sorted_rows(cpu["digit_select"])
    differ = len(set(got) ^ set(want))
    if len(got) != len(want) or differ > 2 * counts["digit"]["near_boundary"]:
        raise AssertionError(f"12d: the SELECT naming ex:predictedDigit gave {len(got)} rows "
                             f"against {len(want)}, {differ} differ")
    if card["alarms"] != cpu["alarms"] or int(card["alarms"][0][0]) != ML_MEASUREMENTS:
        raise AssertionError(f"12d: alarms {card['alarms']} against {cpu['alarms']}")
    counts["digit_select_rows"] = len(got)
    log(f"12d: predictions and rows equal the CPU run's (the card's weights): {counts}")
    return counts


def run_ml_phase(dev, lubm) -> dict:
    """Phase 12 on ``dev``: 12a, then on two clones of the LUBM database
    (``lubm``), one with ``ML_SAMPLES`` digit samples and one with
    ``ML_MEASUREMENTS`` sensor measurements: 12c (TRAIN on the fast path),
    12b (the RULE, then TRAIN through the SDD path), and 12d.  The port's
    CPU run repeats 12b and 12c on copies of the databases from the same
    initial weights, and 12d with the card's trained weights (through
    ``save`` / ``load``).  Launch counters are zeroed just before the card's
    statements and read just after."""
    import tempfile

    import numpy as np
    import torch

    from kolibrie_tpu_torch.ml.mlp import MlpNeuralPredicate
    from kolibrie_tpu_torch.ops import kernels as K
    from kolibrie_tpu_torch.reasoner import device_fixpoint as FX
    from kolibrie_tpu_torch.reasoner.reasoner import Reasoner

    on_card = dev.type == "cuda"
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    mlp = run_mlp_alone(dev)
    t0 = time.perf_counter()
    dbs = {"digit": lubm.clone(), "hot": lubm.clone()}
    dbs["digit"].parse_ntriples(ml_digit_ntriples(ML_SAMPLES, ML_SEED))
    dbs["hot"].parse_ntriples(ml_sensor_ntriples(ML_MEASUREMENTS, ML_SEED))
    for db in dbs.values():
        db.store.device_segment("spo")  # the mirror's upload, before the timed statements
    log(f"12: databases of {len(dbs['digit'])} and {len(dbs['hot'])} triples "
        f"({time.perf_counter() - t0:.1f} s)")
    init = {
        "digit": MlpNeuralPredicate(2, [16], "exclusive", ["0", "1"], seed=ML_SEED, device=dev),
        "hot": MlpNeuralPredicate(1, [8], "binary", seed=ML_SEED + 1, device=dev),
    }
    init_params = {k: m.params_numpy() for k, m in init.items()}
    record: dict = {}
    captured: dict = {}
    tmp = tempfile.TemporaryDirectory()
    saves = {"digit": os.path.join(tmp.name, "digit.json"), "hot": os.path.join(tmp.name, "hot.json")}
    K.reset_launches()
    undo = recorder_install(captured)
    saved_filter = FX.filter_mask
    FX.filter_mask = filter_recorder(captured, saved_filter)
    try:
        t1 = time.perf_counter()
        card_c = ml_train(dev, dbs["digit"], "train_digit",
                          ML_DIGIT_STATEMENT.replace("<save>", saves["digit"]), init["digit"], 3,
                          record)
        ml_statement(dev, dbs["hot"], "rule_alert", ML_ALERT_RULE, record)
        card_b = ml_train(dev, dbs["hot"], "train_hot", ML_HOT_STATEMENT, init["hot"], 5, record)
        card_b["model"].save(saves["hot"])
        twins = {k: cpu_twin(db) for k, db in dbs.items()}
        twins["hot"].rule_map = dict(dbs["hot"].rule_map)
        t2 = time.perf_counter()
        card_d = run_ml_predict(dev, dbs, record)
        t3 = time.perf_counter()
    finally:
        undo()
        FX.filter_mask = saved_filter
    launches = {k: v for k, v in {**K.LAUNCHES, **K.ENTRY_LAUNCHES}.items() if v}
    if on_card and not launches.get("merge_path_join"):
        raise AssertionError(f"12: the ML statements launched no merge-path join: {launches}")
    hot = card_b["model"].predict(np.array([[85.0], [45.0]]))
    if not (hot[0] > 0.8 and hot[1] < 0.2):
        raise AssertionError(f"12b: p(85) {hot[0]}, p(45) {hot[1]}")
    digit = card_c["model"].predict_labels(np.array([[0.1, 0.9], [0.9, 0.1]]))
    if digit != ["0", "1"]:
        raise AssertionError(f"12c: labels {digit} for the class centres")
    # the port's CPU run: 12c and 12b from the same initial weights
    rec_cpu: dict = {}
    cpu_c = ml_train(cpu, twins["digit"], "train_digit",
                     ML_DIGIT_STATEMENT.replace("<save>", os.path.join(tmp.name, "cpu.json")),
                     MlpNeuralPredicate.from_params(init_params["digit"], "exclusive", ["0", "1"],
                                                    device="cpu"), 3, rec_cpu)
    check_ml_train("12c", card_c, cpu_c, 0)
    cpu_b = ml_train(cpu, twins["hot"], "train_hot", ML_HOT_STATEMENT,
                     MlpNeuralPredicate.from_params(init_params["hot"], device="cpu"), 5, rec_cpu)
    check_ml_train("12b", card_b, cpu_b, ML_MEASUREMENTS)
    # 12d with the card's weights
    twins["digit"].trained_models["digit_model"] = MlpNeuralPredicate.load(saves["digit"], cpu)
    twins["hot"].trained_models["hot2"] = MlpNeuralPredicate.load(saves["hot"], cpu)
    saved_min = Reasoner._DEVICE_AUTO_MIN_FACTS
    Reasoner._DEVICE_AUTO_MIN_FACTS = 1 << 62  # the CPU run's RULE: the host strategy
    try:
        cpu_d = run_ml_predict(cpu, twins, rec_cpu)
    finally:
        Reasoner._DEVICE_AUTO_MIN_FACTS = saved_min
    counts = check_ml_predict(card_d, cpu_d)
    tmp.cleanup()
    t4 = time.perf_counter()
    log(f"phase 12: {t4 - t_phase:.1f} s (12a {t0 - t_phase:.1f}, card 12b/12c "
        f"{t2 - t1:.1f}, card 12d {t3 - t2:.1f}, CPU run {t4 - t3:.1f}); launches {launches}")
    return {"mlp": mlp, "record": record, "cpu_record": rec_cpu, "launches": launches,
            "captured": captured, "counts": counts,
            "losses": {"digit": card_c["losses"], "hot": card_b["losses"]}}


# ------------------------------------------------------- kernel timing


# ------------------------------------------------- phase 13: the repeated-query layer

REPEAT_RUNS = 20  # 13a: PreparedQuery.run calls after calibration
REPEAT_K = 16  # 13a: run_amortized(k)
TEMPLATE_VARIANTS = 64  # 13b: constant-variants of each template
FLEET_ROWS = 50_000  # 13d: CITYBENCH_SWEEP.json's largest size, as bench.py's fleet takes it
FLEET_QUERIES = 256  # 13d: standing queries of bench.py's largest fleet
TEMPLATE_PREFIXES = """PREFIX ds: <https://data.example/ontology#>
PREFIX foaf: <http://xmlns.com/foaf/0.1/>
PREFIX ub: <http://swat.cse.lehigh.edu/onto/univ-bench.owl#>
"""


def employee_template(i: int) -> str:
    """``benches/bench_plan_template.py``'s ``variant`` on the employee
    predicates of ``bench.py``: the company homepage in the department's
    place, the same salary thresholds.  Its variable names are its own, so
    its spec tree is new to the process whatever ran before."""
    return (TEMPLATE_PREFIXES + f"SELECT ?tplEmp ?tplPay WHERE {{ ?tplEmp foaf:workplaceHomepage "
            f"<https://company{i % 16}.example/> . ?tplEmp ds:annual_salary ?tplPay . "
            f"FILTER(?tplPay > {30000 + (i * 700) % 35000}) }}")


def lubm_template(i: int) -> str:
    """A two-pattern LUBM join, one department a variant: the courses its
    students take (variable names of its own, as ``employee_template``)."""
    from benches.lubm import DEPTS_PER_UNIV

    dept = f"http://www.Department{i % DEPTS_PER_UNIV}.University{i // DEPTS_PER_UNIV}.edu"
    return (TEMPLATE_PREFIXES
            + f"SELECT ?tplStudent ?tplCourse WHERE {{ ?tplStudent ub:memberOf <{dept}> . "
            f"?tplStudent ub:takesCourse ?tplCourse }}")


def fleet_ntriples(rows: int) -> str:
    """``bench.py``'s MQO fleet store: a value and a kind per subject."""
    lines = []
    for i in range(rows):
        s = f"<http://e/s{i}>"
        lines.append(f'{s} <http://e/val> "{i % 100}" .')
        lines.append(f'{s} <http://e/kind> "k{i % 7}" .')
    return "\n".join(lines)


def fleet_q(i: int) -> str:
    """``bench.py``'s standing fleet query ``i``: one prefix, ``i``'s filter."""
    return ('SELECT ?s ?v WHERE { ?s <http://e/kind> "k3" . '
            f"?s <http://e/val> ?v . FILTER(?v > {i % 90}) }}")


class GcMeter:
    """Python's garbage collections over a ``with`` block: the count per
    generation and the milliseconds they took (``gc.callbacks``)."""

    def __enter__(self):
        import gc

        self.counts, self.ms, self._t = [0, 0, 0], 0.0, None
        gc.callbacks.append(self._note)
        return self

    def _note(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.counts[info["generation"]] += 1
            self.ms += (time.perf_counter() - self._t) * 1e3
            self._t = None

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._note)
        return False

    def summary(self) -> dict:
        return {"collections_by_generation": self.counts, "ms": self.ms}


def prewarm_child(cache_dir: str, universities: int, device: str) -> dict:
    """13f's second process: a fresh LUBM database replays the manifest
    against the same compile-cache directory.  Returns what it saw."""
    import torch

    from benches.lubm import generate_fast
    from kolibrie_tpu_torch import SparqlDatabase
    from kolibrie_tpu_torch.query import compile_cache, prewarm

    compile_cache.enable(explicit_dir=cache_dir)
    db = SparqlDatabase(device=torch.device(device))
    s, p, o = generate_fast(universities, db.dictionary)
    db.store.add_batch(s, p, o)
    t = time.perf_counter()
    results = prewarm.replay_manifest(db, cache_dir)
    if device == "cuda":
        torch.cuda.synchronize()
    return {"results": results, "counters": compile_cache.counters(),
            "ms": (time.perf_counter() - t) * 1e3, "triples": len(db)}


def run_repeated_phase(dev, main_path: dict, lubm, emp, universities: int = UNIVERSITIES,
                       variants: int = TEMPLATE_VARIANTS, fleet_rows: int = FLEET_ROWS,
                       fleet_queries: int = FLEET_QUERIES, runs: int = REPEAT_RUNS,
                       k: int = REPEAT_K) -> dict:
    """Phase 13 on ``dev``: the repeated-query layer at full width.  13a
    ``PreparedQuery`` on the employee join, Q2 and Q9 (calibrate on the
    host twin, ``run`` x ``runs``, ``run_amortized(k)``, ``fetch``): rows
    equal phase 4's, the twin's counts equal the converged counts, and the
    runs read nothing back.  13b two template sets of ``variants``
    constant-variants through the plan cache (one new spec each, one miss
    and ``variants - 1`` rebinds, a hit on a repeat, rows equal uncached
    runs) and then through one ``execute_queries_batched`` call (rows equal
    solo, one batched dispatch).  13c the employee variants under
    ``plan_interp`` force (the interpreter's rows and source; Q9 and the
    LUBM template decline).  13d ``bench.py``'s MQO fleet: ``fleet_queries``
    standing queries off, then two rounds under force (rows equal, one
    shared evaluation, every other query a cache hit, the ``mqo:`` EXPLAIN
    line).  13e EXPLAIN ANALYZE on
    Q2 and Q9 (actuals equal the row counts) and Q9 under the stats advisor
    (rows unchanged).  13f the compile cache and a second process replaying
    the manifest (every template warmed, every kernel library a hit).
    Launch counters are zeroed just before 13a and read just after 13e."""
    import subprocess
    import tempfile

    import torch

    from benches.lubm import LUBM_Q2, LUBM_Q9
    from kolibrie_tpu_torch import SparqlDatabase, execute_query_volcano
    from kolibrie_tpu_torch.ops import kernels as K
    from kolibrie_tpu_torch.optimizer import device_engine as DE
    from kolibrie_tpu_torch.optimizer import mqo, plan_interp, stats_advisor
    from kolibrie_tpu_torch.query import compile_cache
    from kolibrie_tpu_torch.query import executor as EX
    from kolibrie_tpu_torch.query.engine import QueryEngine
    from kolibrie_tpu_torch.query.parser import parse_combined_query
    from kolibrie_tpu_torch.query.template import fingerprint_query

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    walls: dict = {}

    def step(name, fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        walls[name] = walls.get(name, 0.0) + (time.perf_counter() - t) * 1e3
        return out

    def launches_of(fn):
        before = {**K.LAUNCHES, **K.ENTRY_LAUNCHES}
        out = fn()
        after = {**K.LAUNCHES, **K.ENTRY_LAUNCHES}
        return out, {k2: after[k2] - before[k2] for k2 in after if after[k2] != before[k2]}

    want = {name: main_path["rows"][name] for name in ("employee", "q2", "q9")}
    captured: dict = {}
    report: dict = {}
    K.reset_launches()
    undo = recorder_install(captured)
    try:
        # ---- 13a. prepared queries
        for name, db, q in (("employee", emp, EMPLOYEE_QUERY), ("q2", lubm, LUBM_Q2),
                            ("q9", lubm, LUBM_Q9)):
            pq = step(f"13a_{name}_prepare", lambda: DE.PreparedQuery(db, q))
            twin = step(f"13a_{name}_calibrate", pq.lowered.calibrate_host)
            fetched0 = DE.fetch_counters()
            out, l_cold = launches_of(lambda: step(f"13a_{name}_run_cold", pq.run))
            for _ in range(runs - 1):
                out, l_warm = launches_of(lambda: step(f"13a_{name}_run_warm", pq.run))
            (sums, nrows), l_k = launches_of(
                lambda: step(f"13a_{name}_run_k", lambda: pq.run_amortized(k)))
            if DE.fetch_counters() != fetched0:
                raise AssertionError(f"13a {name}: run()/run_amortized() read back "
                                     f"{DE.fetch_counters()} (before {fetched0})")
            rows = step(f"13a_{name}_fetch", lambda: pq.fetch(out))
            if rows != want[name]:
                raise AssertionError(f"13a {name}: prepared rows differ from phase 4's")
            if pq.lowered._last_counts != twin:
                raise AssertionError(f"13a {name}: host twin counts {twin}, converged "
                                     f"{pq.lowered._last_counts}")
            nrows_h, sums_h = nrows.tolist(), sums.tolist()
            if set(nrows_h) != {len(rows)} or len(set(sums_h)) != 1:
                raise AssertionError(f"13a {name}: run_k rows {set(nrows_h)}, "
                                     f"checksums {set(sums_h)}")
            report[f"13a_{name}"] = {
                "rows": len(rows), "twin_counts": twin, "caps": list(pq.lowered._join_caps),
                "run_cold_ms": walls[f"13a_{name}_run_cold"],
                "run_warm_ms": walls.get(f"13a_{name}_run_warm", 0.0) / max(runs - 1, 1),
                "run_k_ms_per_iter": walls[f"13a_{name}_run_k"] / k,
                "calibrate_ms": walls[f"13a_{name}_calibrate"],
                "fetch_ms": walls[f"13a_{name}_fetch"],
                "launches": {"cold": l_cold, "warm": l_warm if runs > 1 else {}, "run_k": l_k},
            }
            log(f"13a {name}: {report[f'13a_{name}']}")
            del pq, out

        # ---- 13b. templates: solo through the plan cache, then batched
        texts = {"employee": [employee_template(i) for i in range(variants)],
                 "lubm": [lubm_template(i) for i in range(variants)]}
        dbs = {"employee": emp, "lubm": lubm}
        solo_rows = {}
        for label, db in dbs.items():
            # each pass's Python collections and counts readbacks (one a
            # query unless a capacity overflowed and the plan re-ran)
            gcs, reads = {}, {}

            def metered(name, fn):
                r0 = DE.fetch_counters().get("converge.counts", 0)
                with GcMeter() as meter:
                    out = fn()
                gcs[name] = meter.summary()
                reads[name] = DE.fetch_counters().get("converge.counts", 0) - r0
                return out

            info0, comp0 = EX.plan_cache_info(db), DE.device_compile_stats()
            rows, l_solo = launches_of(lambda: metered("solo", lambda: [
                step(f"13b_{label}_solo_{'cold' if i == 0 else 'warm'}",
                     lambda t=t: execute_query_volcano(t, db))
                for i, t in enumerate(texts[label])]))
            info1, comp1 = EX.plan_cache_info(db), DE.device_compile_stats()
            execute_query_volcano(texts[label][-1], db)
            info2 = EX.plan_cache_info(db)
            got = (comp1["run_plan"] - comp0["run_plan"], info1["misses"] - info0["misses"],
                   info1["param_rebinds"] - info0["param_rebinds"], info2["hits"] - info1["hits"])
            if got != (1, 1, variants - 1, 1):
                raise AssertionError(f"13b {label}: (new specs, misses, rebinds, repeat hits) "
                                     f"{got}, expected (1, 1, {variants - 1}, 1)")
            # the parent's path (parse, plan, lower, run; no cache), then a
            # second pass through the cache (every variant a rebind again),
            # so the first pass's one-time costs show against both
            uncached = metered("uncached", lambda: step(f"13b_{label}_uncached", lambda: [
                EX.execute_combined(db, parse_combined_query(t, db.prefixes))
                for t in texts[label]]))
            again = metered("solo_again", lambda: step(f"13b_{label}_solo_again", lambda: [
                execute_query_volcano(t, db) for t in texts[label]]))
            if uncached != rows or again != rows:
                raise AssertionError(f"13b {label}: cached rows differ from uncached runs")
            fetched0 = DE.fetch_counters()
            batched, l_batch = launches_of(lambda: step(
                f"13b_{label}_batched", lambda: EX.execute_queries_batched(db, texts[label])))
            info3, comp3 = EX.plan_cache_info(db), DE.device_compile_stats()
            if batched != rows:
                raise AssertionError(f"13b {label}: batched rows differ from solo")
            fetched = DE.fetch_counters()
            batch_reads = fetched.get("batch.counts", 0) - fetched0.get("batch.counts", 0)
            if (info3["batch_groups"] - info2["batch_groups"],
                    info3["batched"] - info2["batched"]) != (1, variants):
                raise AssertionError(f"13b {label}: not one batched dispatch of {variants}")
            solo_rows[label] = rows
            report[f"13b_{label}"] = {
                "variants": variants, "rows": sum(len(r) for r in rows),
                "solo_cold_ms": walls[f"13b_{label}_solo_cold"],
                "solo_warm_ms_per_query": walls[f"13b_{label}_solo_warm"] / (variants - 1),
                "uncached_ms_per_query": walls[f"13b_{label}_uncached"] / variants,
                "solo_again_ms_per_query": walls[f"13b_{label}_solo_again"] / variants,
                "batched_ms_per_query": walls[f"13b_{label}_batched"] / variants,
                "gc": gcs, "count_reads": reads,
                "batch_count_reads": batch_reads,
                "new_batch_specs": comp3["run_plan_batch"] - comp1["run_plan_batch"],
                "launches": {"solo": l_solo, "batched": l_batch},
            }
            log(f"13b {label}: {report[f'13b_{label}']}")

        # ---- 13c. the plan-bytecode interpreter
        with plan_interp.override_mode("force"):
            interp0 = DE.device_compile_stats()["run_interp"]
            rows, l_interp = launches_of(lambda: step("13c_interp", lambda: [
                execute_query_volcano(t, emp) for t in texts["employee"]]))
            if rows != solo_rows["employee"]:
                raise AssertionError("13c: interpreter rows differ from the specialized path")
            fp = fingerprint_query(parse_combined_query(texts["employee"][0], emp.prefixes))[0]
            src = EX.plan_cache_info(emp)["per_template"][fp]["source"]
            q9_rows = step("13c_q9", lambda: execute_query_volcano(LUBM_Q9, lubm))
            fp9 = fingerprint_query(parse_combined_query(LUBM_Q9, lubm.prefixes))[0]
            src9 = EX.plan_cache_info(lubm)["per_template"][fp9]["source"]
            if src != "interp" or src9 != "compiled" or q9_rows != want["q9"]:
                raise AssertionError(f"13c: sources {src} / Q9 {src9}")
            low = DE.PreparedQuery(lubm, texts["lubm"][0]).lowered
            low.build()
            try:
                plan_interp.compile_bytecode(low)
                lubm_decline = None
            except plan_interp.InterpUnsupported as e:
                lubm_decline = str(e)
        report["13c"] = {
            "interp_ms_per_query": walls["13c_interp"] / variants, "source": src,
            "q9_source": src9, "size_classes": DE.device_compile_stats()["run_interp"] - interp0,
            "lubm_template_declines": lubm_decline, "launches": l_interp,
        }
        log(f"13c: {report['13c']}")

        # ---- 13d. MQO's shared prefix over bench.py's fleet
        fleet = SparqlDatabase(device=dev)
        step("13d_fleet_load", lambda: fleet.parse_ntriples(fleet_ntriples(fleet_rows)))
        owners = [f"w{i}" for i in range(fleet_queries)]
        for o in owners:
            mqo.register_standing(fleet, o)
        off = [execute_query_volcano(fleet_q(i), fleet) for i in range(fleet_queries)]
        off = step("13d_off", lambda: [execute_query_volcano(fleet_q(i), fleet)
                                       for i in range(fleet_queries)])

        def fire():
            out = []
            for i, o in enumerate(owners):
                with mqo.standing_scope(fleet, o):
                    out.append(execute_query_volcano(fleet_q(i), fleet))
            return out

        with mqo.override_mqo_mode("force"):
            reads0 = DE.fetch_counters().get("mqo.counts", 0)
            step("13d_force_cold", fire)
            # the shared prefix ran on the card: the interpreter read its
            # join counts back once (a host-twin evaluation reads none)
            prefix_reads = DE.fetch_counters().get("mqo.counts", 0) - reads0
            shared, l_mqo = launches_of(lambda: step("13d_force", fire))
            stats = mqo.stats(fleet)
            mqo_line = QueryEngine(fleet).explain_device(fleet_q(0)).splitlines()[-1]
        if shared != off:
            raise AssertionError("13d: shared-prefix rows differ from independent runs")
        prefixes = list(stats["prefixes"].values())
        if (len(prefixes) != 1 or prefixes[0]["shared_evals"] != 1
                or prefixes[0]["host_evals"] != 0 or prefix_reads < 1
                or prefixes[0]["cache_hits"] != 2 * fleet_queries - 1
                or not mqo_line.startswith("mqo: shared prefix=")):
            raise AssertionError(f"13d: prefixes {stats['prefixes']}, prefix count reads "
                                 f"{prefix_reads}, EXPLAIN {mqo_line!r}")
        report["13d"] = {
            "fleet_rows": fleet_rows, "queries": fleet_queries, "prefix": prefixes[0],
            "prefix_on_card": prefix_reads >= 1 and prefixes[0]["host_evals"] == 0,
            "prefix_count_reads": prefix_reads, "host_evals": prefixes[0]["host_evals"],
            "off_ms_per_query": walls["13d_off"] / fleet_queries,
            "force_cold_ms_per_query": walls["13d_force_cold"] / fleet_queries,
            "force_ms_per_query": walls["13d_force"] / fleet_queries,
            "marginal_ratio": walls["13d_force"] / walls["13d_off"], "explain": mqo_line,
            "launches": l_mqo,
        }
        log(f"13d: {report['13d']}")
        del fleet

        # ---- 13e. EXPLAIN ANALYZE and the stats advisor
        expected = {"q2": len(want["q2"]), "q9": len(want["q9"])}
        for name, q in (("q2", LUBM_Q2), ("q9", LUBM_Q9)):
            text = step(f"13e_{name}_explain",
                        lambda: QueryEngine(lubm).explain_device(q, analyze=True))
            n = expected[name]
            if f"\nrows: {n}\n" not in text + "\n" or not (
                    f"actual={n}" in text or f"live={n}" in text):
                raise AssertionError(f"13e {name}: EXPLAIN ANALYZE actuals miss {n}:\n{text}")
            log(f"13e {name} EXPLAIN ANALYZE:\n{text}")
        with stats_advisor.override_mode("auto"):
            info0 = EX.plan_cache_info(lubm)
            for rep in range(3):
                rows = step(f"13e_q9_advisor_{rep}", lambda: execute_query_volcano(LUBM_Q9, lubm))
                if rows != want["q9"]:
                    raise AssertionError("13e: Q9 rows changed under the stats advisor")
            fp9 = fingerprint_query(parse_combined_query(LUBM_Q9, lubm.prefixes))[0]
            advisor = stats_advisor.stats_advisor.report(fp9)
            replans = EX.plan_cache_info(lubm)["advisor_replans"] - info0["advisor_replans"]
            plan = QueryEngine(lubm).explain_device(LUBM_Q9, exact_counts=False)
        report["13e"] = {
            "advisor": {k2: v for k2, v in (advisor or {}).items() if k2 != "ops"},
            "replans": replans, "q9_wcoj_after": "wcoj elim=" in plan,
            "q9_advisor_ms": [walls[f"13e_q9_advisor_{r}"] for r in range(3)],
        }
        log(f"13e: advisor report {report['13e']}")
    finally:
        undo()
    launches = {k2: v for k2, v in {**K.LAUNCHES, **K.ENTRY_LAUNCHES}.items() if v}
    log(f"phase 13 launches: {launches}")

    # ---- 13f. the compile cache and a second process replaying the manifest
    with tempfile.TemporaryDirectory() as tmp:
        compile_cache.enable(explicit_dir=tmp)
        built = step("13f_build", K.build_kernels) if on_card else {}
        with compile_cache._templates_lock:
            compile_cache._templates.clear()
        for t in texts["employee"] + texts["lubm"]:
            fp = fingerprint_query(parse_combined_query(t, emp.prefixes))[0]
            compile_cache.record_template(fp, t)
        path = compile_cache.save_manifest(tmp)
        if path is None or len(compile_cache.load_manifest(tmp)) != 2:
            raise AssertionError("13f: the manifest did not save two templates")
        code = ("import json, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
                "print(json.dumps(chip_smoke.prewarm_child(sys.argv[2], int(sys.argv[3]), "
                "sys.argv[4])))")
        repo = os.path.dirname(os.path.abspath(__file__))
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", code, repo, tmp, str(universities), dev.type],
            capture_output=True, text=True, timeout=600)
        walls["13f_child"] = (time.perf_counter() - t) * 1e3
        if proc.returncode != 0:
            raise AssertionError(f"13f: the replaying process failed:\n{proc.stderr[-4000:]}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        compile_cache._active_dir = None
        K.set_build_dir(K._BUILD)
    warmed = [r["targets"]["db"] for r in child["results"]]
    if len(warmed) != 2 or any("error" in w for w in warmed):
        raise AssertionError(f"13f: templates not warmed: {child['results']}")
    if on_card and (child["counters"]["misses"] != 0 or child["counters"]["hits"] < 1
                    or "disk" not in [w["source"] for w in warmed]):
        raise AssertionError(f"13f: compile cache counters {child['counters']}, "
                             f"sources {[w['source'] for w in warmed]}")
    report["13f"] = {"built": sorted(built), "child": child["counters"],
                     "sources": [w["source"] for w in warmed],
                     "warm_ms": [w["ms"] for w in warmed], "replay_ms": child["ms"],
                     "child_wall_ms": walls["13f_child"]}
    log(f"13f: {report['13f']}")
    log(f"phase 13 walls (ms): { {k2: round(v, 3) for k2, v in walls.items()} }")
    return {"report": report, "launches": launches, "captured": captured, "walls": walls}


# ------------------------------------------- phase 14: resilience and durability

RESILIENCE_QUERIES = ("employee", "q2", "q9")  # phase 4's, on phase 4's databases
WAL_BATCHES, WAL_ROWS, WAL_REPEATS = 30, 2_048, 5  # bench.py's durability block
WAL_OVERHEAD_TARGET_PCT = 15.0  # bench.py's and the reference's docs/DURABILITY.md target
CRASH_STORE = "lubm"
CRASH_BATCH = 20_000  # 14d's second batch: note triples after the RULE
CRASH_TORN = 'INSERT DATA { <http://phase14.example/torn> <http://phase14.example/p> "{}" }'


class FakeClock:
    """An injected monotonic clock: breakers and deadlines move only when
    the script advances it, so no step sleeps."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def breaker_counters() -> tuple:
    """The process-wide breaker trips and degraded requests so far (they
    outlive the databases)."""
    from kolibrie_tpu_torch.obs import metrics

    trips = metrics.REGISTRY.get("kolibrie_breaker_trips_total").children()[0][1].value
    return trips, metrics.REGISTRY.get("kolibrie_query_seconds").labels("degraded").count


def breakers_idle(before: tuple) -> dict:
    """Phases 4-13 injected nothing: every breaker board on a live port
    database reads zero failures and zero degraded requests, and the
    process-wide counters saw no trip and no degraded request since
    ``before`` (:func:`breaker_counters` ahead of phase 4)."""
    import gc

    from kolibrie_tpu_torch.query.sparql_database import SparqlDatabase

    gc.collect()  # only databases something still holds
    boards, templates = 0, 0
    for obj in gc.get_objects():
        if type(obj) is SparqlDatabase and "_breaker_board" in obj.__dict__:
            boards += 1
            for fp, snap in obj.__dict__["_breaker_board"].snapshot().items():
                templates += 1
                if snap["total_failures"] or snap["degraded_served"] or snap["trips"]:
                    raise AssertionError(f"breaker {fp[:12]} after phases 4-13: {snap}")
    now = breaker_counters()
    trips, degraded = now[0] - before[0], now[1] - before[1]
    if trips or degraded:
        raise AssertionError(f"phases 4-13: {trips} breaker trips, {degraded} degraded requests")
    return {"boards": boards, "templates": templates, "trips": trips, "degraded": degraded}


def device_profile(fn) -> dict:
    """Device busy time, device op count and the operators whose kernels
    took the most of it, for one call of ``fn`` under ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    # device time by the operator that launched it (aten::sort, aten::index, ...)
    ops = [e for e in events if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "device_busy_ms": sum(e.self_device_time_total for e in dev) / 1e3,
        "device_ops": sum(e.count for e in dev),
        "top_device": [
            {"op": e.key, "device_ms": e.self_device_time_total / 1e3, "calls": e.count}
            for e in top
        ],
    }


def busy_share(dev, fn) -> dict:
    """One synchronised call of ``fn`` timed, then one under
    :func:`device_profile`: the wall, the device time of its kernels and
    their share of that wall, as ``chip_profile.py`` measures busy shares
    (not measured on the CPU)."""
    import torch

    if dev.type != "cuda":
        fn()
        return {"wall_ms": None, "device_ms": None, "busy_share": None}
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    busy = device_profile(fn)["device_busy_ms"]
    return {"wall_ms": wall, "device_ms": busy, "busy_share": busy / wall if wall else None}


def run_degraded(dev, main_path: dict) -> dict:
    """14a: phase 4's employee join, Q2 and Q9 on phase 4's databases behind
    an injected ``device.lower`` compile error, then an injected
    ``device.execute`` OOM.  Each round: three faulted calls served by the
    host engine (on the card) trip the template's breaker, a fourth skips
    the device program, and past the backoff (the injected clock moved, no
    sleep) the half-open probe runs the device program again.  Rows equal
    phase 4's at every call."""
    import torch

    from kolibrie_tpu_torch import execute_query_volcano
    from kolibrie_tpu_torch.query.executor import plan_cache_info
    from kolibrie_tpu_torch.resilience import breaker as B
    from kolibrie_tpu_torch.resilience import faultinject as F

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    dbs = {name: (db, q) for name, db, q, _w in main_path["queries"]}
    rounds = (("device.lower", F.InjectedCompileError), ("device.execute", F.InjectedDeviceOOM))
    out = {}
    for name in RESILIENCE_QUERIES:
        db, q = dbs[name]
        want = main_path["rows"][name]
        clk = FakeClock()
        db.__dict__.pop("_breaker_board", None)
        board = B.breaker_board(db, clock=clk)
        # cold templates: the fault at device.lower fires only on a lowering
        db.__dict__.pop("_template_cache", None)
        steps, walls = [], {}

        def call(label, _db=db, _q=q, _want=want, _name=name):
            with KernelCalls() as calls:
                sync()
                t = time.perf_counter()
                rows = execute_query_volcano(_q, _db)
                sync()
                ms = (time.perf_counter() - t) * 1e3
            if rows != _want:
                raise AssertionError(f"14a {_name} {label}: rows differ from phase 4's")
            (snap,) = board.snapshot().values()
            steps.append({"step": label, "ms": ms, "launches": dict(calls.counts),
                          "state": snap["state"], "failures": snap["total_failures"],
                          "degraded": snap["degraded_served"], "epoch": snap["close_epoch"]})
            return steps[-1]

        for site, error in rounds:
            plan = F.FaultPlan(seed=14).add(site, error=error)
            with plan.installed():
                for i in range(B.DEFAULT_FAILURE_THRESHOLD + 1):
                    st = call(f"{site}#{i + 1}")
                    if st["launches"].get("lex_probe_select") or st["launches"].get(
                            "lex_probe_validate"):
                        raise AssertionError(f"14a {name}: a degraded call probed on the "
                                             f"device: {st}")
                    if not st["launches"].get("merge_path_join"):
                        raise AssertionError(f"14a {name}: the host engine launched no merge "
                                             f"path: {st}")
                calls_at_trip = plan.snapshot()[site]["calls"]
                if steps[-1]["state"] != "open" or calls_at_trip != B.DEFAULT_FAILURE_THRESHOLD:
                    raise AssertionError(f"14a {name} {site}: breaker {steps[-1]}, "
                                         f"fault site calls {calls_at_trip}")
                if steps[-1]["degraded"] < 1:
                    raise AssertionError(f"14a {name}: the open breaker served nothing degraded")
            walls[f"degraded_{site}"] = steps[-1]["ms"]  # warm host slot, device skipped
            clk.advance(B.DEFAULT_BACKOFF_MAX_S)
            st = call(f"{site}:probe")
            if (st["state"], st["epoch"]) != ("closed", 1 + rounds.index((site, error))):
                raise AssertionError(f"14a {name}: half-open probe {st}")
            probe = "merge_path_join" if name == "employee" else "lex_probe_select"
            if not st["launches"].get(probe):
                raise AssertionError(f"14a {name}: the probe launched no {probe}: {st}")
        walls["device_warm"] = call("device:warm")["ms"]
        info = plan_cache_info(db)
        busy = {"degraded": None, "device": None}
        if name == "q9":
            mode, db.execution_mode = db.execution_mode, "host"  # the degraded route, warm
            try:
                busy["degraded"] = busy_share(dev, lambda: execute_query_volcano(q, db))
            finally:
                db.execution_mode = mode
            busy["device"] = busy_share(dev, lambda: execute_query_volcano(q, db))
        out[name] = {"steps": steps, "walls": walls, "sentinel_expiries":
                     info["sentinel_expiries"], "breaker": board.snapshot(), "busy": busy}
        log(f"14a {name}: degraded {walls['degraded_device.lower']:.1f} / "
            f"{walls['degraded_device.execute']:.1f} ms, device warm {walls['device_warm']:.1f} "
            f"ms, sentinel_expiries {info['sentinel_expiries']}, busy {busy}")
        log(f"14a {name} steps: {steps}")
    return out


def run_deadlines(dev, main_path: dict) -> dict:
    """14b: Q9 shed by an expired deadline at ``executor.enter`` (no kernel
    launched, no device memory kept), then by a deadline that expires
    between lowering and dispatch (the injected clock moves 1 s inside the
    lowering): ``device.execute`` sheds it, the breaker counts the failure,
    no kernel launched."""
    import gc

    import torch

    from kolibrie_tpu_torch import execute_query_volcano
    from kolibrie_tpu_torch.resilience import breaker as B
    from kolibrie_tpu_torch.resilience import faultinject as F
    from kolibrie_tpu_torch.resilience.deadline import Deadline, deadline_scope
    from kolibrie_tpu_torch.resilience.errors import DeadlineExceeded

    on_card = dev.type == "cuda"
    mem = torch.cuda.memory_allocated if on_card else (lambda: 0)
    db, q = next((db, q) for name, db, q, _w in main_path["queries"] if name == "q9")
    clk = FakeClock()
    db.__dict__.pop("_breaker_board", None)
    board = B.breaker_board(db, clock=clk)
    out = {}
    for label, budget, plan in (
            ("executor.enter", -1.0, None),
            ("device.execute", 0.5,
             F.FaultPlan(seed=14, sleep=clk.advance).add("device.lower", latency_s=1.0))):
        db.__dict__.pop("_template_cache", None)
        gc.collect()
        m0 = mem()
        with KernelCalls() as calls:
            try:
                with deadline_scope(Deadline(budget, clock=clk)):
                    if plan is None:
                        execute_query_volcano(q, db)
                    else:
                        with plan.installed():
                            execute_query_volcano(q, db)
            except DeadlineExceeded as e:
                site = e.site
            else:
                raise AssertionError(f"14b {label}: Q9 was not shed")
        m1 = mem()
        db.__dict__.pop("_template_cache", None)  # the slot holding the shed lowering
        gc.collect()
        m2 = mem()
        snap = board.snapshot()
        failures = sum(s["total_failures"] for s in snap.values())
        out[label] = {"site": site, "launches": dict(calls.counts), "mem_before": m0,
                      "mem_after": m1, "mem_after_slot": m2, "breaker_failures": failures}
        if site != label or calls.counts or m2 != m0:
            raise AssertionError(f"14b {label}: {out[label]}")
        if failures != (0 if plan is None else 1):
            raise AssertionError(f"14b {label}: breaker {snap}")
    log(f"14b: {out}")
    return out


def wal_ingest(db, tag: str) -> float:
    """bench.py's durability ingest: ``WAL_BATCHES`` ``parse_ntriples``
    calls of ``WAL_ROWS`` lines; seconds."""
    t0 = time.perf_counter()
    for b in range(WAL_BATCHES):
        db.parse_ntriples("\n".join(
            f"<https://d.example/{tag}/{b}_{j}> <https://d.example/p{j % 4}> "
            f"<https://d.example/v{b}_{j}> ." for j in range(WAL_ROWS)))
    return time.perf_counter() - t0


def run_wal_ingest(dev, universities: int, repeats: int = WAL_REPEATS) -> dict:
    """14c: bench.py's durability ingest (best of ``WAL_REPEATS``) with the
    WAL off and on under ``group``, then the LUBM bulk load
    (``generate_fast`` into ``add_batch``) off and on; the WAL's bytes and
    records, and the overhead beside the reference's 15% target."""
    import shutil
    import tempfile

    from benches.lubm import generate_fast
    from kolibrie_tpu_torch import SparqlDatabase
    from kolibrie_tpu_torch.durability import DurabilityManager

    best = {"off": float("inf"), "on": float("inf")}
    wal = {}
    for r in range(repeats):
        best["off"] = min(best["off"], wal_ingest(SparqlDatabase(device=dev), f"off{r}"))
        tmp = tempfile.mkdtemp(prefix="kolibrie-wal-")
        try:
            m = DurabilityManager(tmp, fsync_policy="group", device=dev)
            m.start()
            db = SparqlDatabase(device=dev)
            m.attach("bench", db)
            best["on"] = min(best["on"], wal_ingest(db, f"on{r}"))
            m.flush()
            wal = {"bytes": m.wal.appended_bytes, "records": m.wal.appended_records}
            m.close()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    bulk = {}
    for side in ("off", "on"):
        tmp = tempfile.mkdtemp(prefix="kolibrie-wal-")
        try:
            db = SparqlDatabase(device=dev)
            m = None
            if side == "on":
                m = DurabilityManager(tmp, fsync_policy="group", device=dev)
                m.start()
                m.attach("lubm", db)
            t = time.perf_counter()
            db.store.add_batch(*generate_fast(universities, db.dictionary))
            if m is not None:
                m.flush()
            bulk[side] = time.perf_counter() - t
            if m is not None:
                bulk["wal"] = {"bytes": m.wal.appended_bytes, "records": m.wal.appended_records}
                m.close()
            bulk["triples"] = len(db)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    out = {
        "fsync_policy": "group",
        "ingest_s_wal_off": best["off"], "ingest_s_wal_on": best["on"],
        "ingest_overhead_pct": (best["on"] - best["off"]) / best["off"] * 100.0,
        "ingest_wal": wal,
        "bulk_s_wal_off": bulk["off"], "bulk_s_wal_on": bulk["on"],
        "bulk_overhead_pct": (bulk["on"] - bulk["off"]) / bulk["off"] * 100.0,
        "bulk_wal": bulk["wal"], "bulk_triples": bulk["triples"],
        "target_pct": WAL_OVERHEAD_TARGET_PCT,
    }
    if wal.get("records") != WAL_BATCHES + 1 or bulk["wal"]["records"] != 2:
        raise AssertionError(f"14c: WAL records {wal}, {bulk['wal']}")
    log(f"14c: {out}")
    return out


def crash_statements(db) -> int:
    """14d's writes after the snapshot, in order: phase 8's INSERT DATA and
    DELETE DATA (half of them), the ``memberOf`` RULE, a second batch of
    note triples.  Returns the count of statements applied."""
    import numpy as np

    from kolibrie_tpu_torch import execute_query_volcano

    pre = SURFACE_PREFIXES
    execute_query_volcano(pre + data_statement(DATA_TRIPLES, "INSERT DATA"), db)
    execute_query_volcano(pre + data_statement(DATA_TRIPLES // 2, "DELETE DATA"), db)
    execute_query_volcano(pre + RULE_STATEMENT, db)
    enc = db.dictionary.encode
    note = enc(NOTE)
    subj = np.fromiter((enc(f"http://phase14.example/s{i}") for i in range(CRASH_BATCH)),
                       dtype=np.uint32, count=CRASH_BATCH)
    obj = np.fromiter((enc(f'"batch {i % 97}"') for i in range(CRASH_BATCH)),
                      dtype=np.uint32, count=CRASH_BATCH)
    db.store.add_batch(subj, np.full(CRASH_BATCH, note, dtype=np.uint32), obj)
    return 4


def crash_child(data_dir: str, aside_dir: str, universities: int, device: str) -> None:
    """14d's writer: under ``KOLIBRIE_FSYNC=always`` it attaches a manager,
    bulk-loads LUBM, copies the WAL aside (the WAL-alone copy's first
    segments), snapshots, applies :func:`crash_statements`, prints the
    acknowledged count and blocks until it is killed."""
    import shutil
    import threading

    import torch

    from benches.lubm import generate_fast
    from kolibrie_tpu_torch import SparqlDatabase
    from kolibrie_tpu_torch.durability import DurabilityManager

    os.environ["KOLIBRIE_FSYNC"] = "always"
    dev = torch.device(device)
    m = DurabilityManager(data_dir, device=dev)
    m.start()
    db = SparqlDatabase(device=dev)
    m.attach(CRASH_STORE, db)
    db.store.add_batch(*generate_fast(universities, db.dictionary))
    m.flush()
    shutil.copytree(m.wal_dir, os.path.join(aside_dir, "wal"))
    t = time.perf_counter()
    gen = m.snapshot({CRASH_STORE: db})
    snap_ms = (time.perf_counter() - t) * 1e3
    gen_dir = m.generation_dir(gen)
    snap_bytes = sum(os.path.getsize(os.path.join(gen_dir, f)) for f in os.listdir(gen_dir))
    acked = crash_statements(db)
    print(json.dumps({"acked": acked, "generation": gen, "snapshot_ms": snap_ms,
                      "snapshot_bytes": snap_bytes, "wal": m.stats()["wal"],
                      "triples": len(db)}), flush=True)
    threading.Event().wait()


def recover_and_check(dev, label: str, data_dir: str, twin, want: dict, on_card: bool) -> dict:
    """Recover ``data_dir`` on ``dev``; the store's columns and dictionary
    must equal ``twin``'s, Q2 phase 4's rows and Q9 the twin's (= phase
    4's); recovery replayed records and truncated none."""
    import numpy as np
    import torch

    from benches.lubm import LUBM_Q2, LUBM_Q9
    from kolibrie_tpu_torch import execute_query_volcano
    from kolibrie_tpu_torch.durability import DurabilityManager

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    m = DurabilityManager(data_dir, device=dev)
    t = time.perf_counter()
    res = m.recover()
    rec_ms = (time.perf_counter() - t) * 1e3
    db = res.stores[CRASH_STORE]
    stats = m.stats()["last_recovery"]
    m.close()
    if stats["replayed_records"] < 1 or stats["truncated_records"] != 0:
        raise AssertionError(f"14d {label}: recovery {stats}")
    sync()
    t = time.perf_counter()
    q2 = execute_query_volcano(LUBM_Q2, db)  # compaction, mirror upload, lowering
    sync()
    first_ms = (time.perf_counter() - t) * 1e3
    q9 = execute_query_volcano(LUBM_Q9, db)
    cols, tcols = db.store.columns(), twin.store.columns()
    if not all(np.array_equal(a, b) for a, b in zip(cols, tcols)):
        raise AssertionError(f"14d {label}: the recovered columns differ from the twin's")
    if db.dictionary.id_to_str != twin.dictionary.id_to_str:
        raise AssertionError(f"14d {label}: the recovered dictionary differs from the twin's")
    if q2 != want["q2"] or q9 != want["q9"] or q9 != want["twin_q9"]:
        raise AssertionError(f"14d {label}: Q2/Q9 rows differ")
    out = {"recover_ms": rec_ms, "first_query_ms": first_ms, "triples": len(db),
           "replayed_records": stats["replayed_records"],
           "replayed_bytes": stats["replayed_bytes"],
           "snapshot_generation": stats["snapshot_generation"]}
    log(f"14d {label}: {out}")
    return out, db


def run_crash_recovery(dev, main_path: dict, universities: int, captured: dict) -> dict:
    """14d: a second process writes through the WAL and is killed with
    SIGKILL after its acknowledgement; recovery from snapshot + WAL tail and
    from the WAL alone each give the uncrashed twin's store and phase 4's
    Q2 / Q9 rows.  Then a torn append (``InjectedTornWrite`` at
    ``wal.append``) is truncated to the acknowledged prefix."""
    import shutil
    import signal
    import tempfile
    import threading

    import torch

    from benches.lubm import LUBM_Q9, generate_fast
    from kolibrie_tpu_torch import SparqlDatabase, execute_query_volcano
    from kolibrie_tpu_torch.durability import DurabilityManager, wal as W
    from kolibrie_tpu_torch.ops import kernels as K
    from kolibrie_tpu_torch.query import compile_cache
    from kolibrie_tpu_torch.reasoner import device_fixpoint as FX
    from kolibrie_tpu_torch.resilience.errors import DurabilityError
    from kolibrie_tpu_torch.resilience.faultinject import FaultPlan, InjectedTornWrite

    on_card = dev.type == "cuda"
    repo = os.path.dirname(os.path.abspath(__file__))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data, aside = os.path.join(tmp, "data"), os.path.join(tmp, "aside")
        os.makedirs(aside)
        code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
                "chip_smoke.crash_child(sys.argv[2], sys.argv[3], int(sys.argv[4]), sys.argv[5])")
        t = time.perf_counter()
        with open(os.path.join(tmp, "child.err"), "w") as err:
            proc = subprocess.Popen(
                [sys.executable, "-c", code, repo, data, aside, str(universities), dev.type],
                stdout=subprocess.PIPE, stderr=err, text=True)
            ack = None
            guard = threading.Timer(900.0, proc.kill)  # a writer that hangs is killed too
            guard.start()
            try:
                for line in proc.stdout:  # the acknowledgement, or EOF if it died
                    if line.startswith('{"acked"'):
                        ack = json.loads(line)
                        break
            finally:
                guard.cancel()
                proc.send_signal(signal.SIGKILL)
                proc.wait()
                proc.stdout.close()
        out["child_wall_ms"] = (time.perf_counter() - t) * 1e3
        if ack is None:
            raise AssertionError("14d: the writer died before its acknowledgement:\n"
                                 + open(os.path.join(tmp, "child.err")).read()[-4000:])
        out["child"] = ack
        out["child_returncode"] = proc.returncode
        # the uncrashed twin: the same writes, no manager, no crash
        t = time.perf_counter()
        twin = SparqlDatabase(device=dev)
        twin.store.add_batch(*generate_fast(universities, twin.dictionary))
        saved_filter = FX.filter_mask
        FX.filter_mask = filter_recorder(captured, saved_filter)
        undo = recorder_install(captured)
        try:
            crash_statements(twin)
            want = {"q2": main_path["rows"]["q2"], "q9": main_path["rows"]["q9"],
                    "twin_q9": execute_query_volcano(LUBM_Q9, twin)}
        finally:
            FX.filter_mask = saved_filter
            undo()
        out["twin_ms"] = (time.perf_counter() - t) * 1e3
        if ack["triples"] != len(twin):
            raise AssertionError(f"14d: the writer acknowledged {ack['triples']} triples, the "
                                 f"twin holds {len(twin)}")
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        # the WAL alone: the segments copied aside before the snapshot plus
        # every later segment (the snapshot pruned them from the data dir)
        for idx in W.list_segments(os.path.join(data, "wal")):
            shutil.copy(W.segment_path(os.path.join(data, "wal"), idx),
                        W.segment_path(os.path.join(aside, "wal"), idx))
        out["snapshot_tail"], db = recover_and_check(dev, "snapshot+tail", data, twin, want,
                                                     on_card)
        del db
        out["wal_alone"], db = recover_and_check(dev, "WAL alone", aside, twin, want, on_card)
        del db
        if out["snapshot_tail"]["snapshot_generation"] != 1 or \
                out["wal_alone"]["snapshot_generation"] != 0:
            raise AssertionError("14d: recovered from the wrong generations")
        # a torn append: the first statement is acknowledged, the second tears
        m = DurabilityManager(data, device=dev)
        db = m.recover().stores[CRASH_STORE]
        m.attach(CRASH_STORE, db, log_create=False)
        plan = FaultPlan(seed=14).add("wal.append", error=InjectedTornWrite, at_calls=[2])
        with plan.installed():
            execute_query_volcano(CRASH_TORN.replace("{}", "acked"), db)
            try:
                execute_query_volcano(CRASH_TORN.replace("{}", "torn"), db)
            except DurabilityError:
                pass
            else:
                raise AssertionError("14d: the torn append was acknowledged")
        m.close()
        m = DurabilityManager(data, device=dev)
        t = time.perf_counter()
        res = m.recover()
        torn_ms = (time.perf_counter() - t) * 1e3
        back = res.stores[CRASH_STORE]
        stats = m.stats()["last_recovery"]
        m.close()
        got = execute_query_volcano(
            'SELECT ?o WHERE { <http://phase14.example/torn> <http://phase14.example/p> ?o }',
            back)
        if got != [["acked"]] or stats["truncated_records"] < 1 or len(back) != len(twin) + 1:
            raise AssertionError(f"14d torn tail: rows {got}, recovery {stats}")
        out["torn"] = {"recover_ms": torn_ms, "truncated_records": stats["truncated_records"],
                       "truncated_bytes": stats["truncated_bytes"],
                       "corrupt_reason": stats["corrupt_reason"]}
        if on_card:
            out["peak_bytes"] = torch.cuda.max_memory_allocated()
        del db, back, twin
    # recovery pointed the kernel build at the data dir's compile cache
    compile_cache._active_dir = None
    K.set_build_dir(K._BUILD)
    log(f"14d: {out}")
    return out


def run_resilience_phase(dev, main_path: dict, counters_before: tuple,
                         universities: int = UNIVERSITIES, wal_repeats: int = WAL_REPEATS) -> dict:
    """Phase 14 (14a-14d), its launches counted from just before 14a to just
    after 14d, each subphase metered by ``GcMeter``; ``counters_before``
    is :func:`breaker_counters` ahead of phase 4."""
    from kolibrie_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    idle = breakers_idle(counters_before)
    log(f"phase 14: breakers after phases 4-13: {idle}")
    captured = {}
    report, gc = {"idle": idle}, {}
    K.reset_launches()
    undo = recorder_install(captured)
    try:
        with GcMeter() as g:
            report["14a"] = run_degraded(dev, main_path)
        gc["14a"] = g.summary()
        with GcMeter() as g:
            report["14b"] = run_deadlines(dev, main_path)
        gc["14b"] = g.summary()
    finally:
        undo()
    with GcMeter() as g:
        report["14c"] = run_wal_ingest(dev, universities, wal_repeats)
    gc["14c"] = g.summary()
    with GcMeter() as g:
        report["14d"] = run_crash_recovery(dev, main_path, universities, captured)
    gc["14d"] = g.summary()
    launches = {**K.LAUNCHES}
    report["gc"] = gc
    log(f"phase 14 collections: {gc}")
    log(f"phase 14 launches: {launches}; {time.perf_counter() - t0:.1f} s")
    return {"report": report, "launches": launches, "captured": captured}



# ------------------------------------------------------- phase 15: serving

SERVE_STORES = ("lubm", "emp")
SERVE_CLIENTS = 16  # 15b: client threads
SERVE_VARIANTS = 64  # 15b: employee template variants, one request each
SERVE_PROFILE_S = 0.5  # 15c: /debug/profile window
SERVE_KERNEL_NAMES = ("lex_probe_select_kernel", "lex_probe_validate_kernel",
                      "merge_path_join_kernel", "filter_mask")
SERVE_WRITES_CONFIRMED = 20  # 15e: acknowledged writes shipped before the kill
SERVE_NS = "http://phase15.example/"


def http_json(base: str, path: str, payload=None, headers=None, timeout: float = 300.0):
    """``(status, json body, headers)`` of a POST (``payload`` given) or a
    GET; HTTP errors are answers too."""
    import urllib.error
    import urllib.request

    h = {"Content-Type": "application/json", **(headers or {})}
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, headers=h,
                                 method="GET" if payload is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = resp.read()
            status, hdrs = resp.status, dict(resp.headers)
    except urllib.error.HTTPError as e:
        body, status, hdrs = e.read(), e.code, dict(e.headers)
    ctype = hdrs.get("Content-Type", "")
    return status, (json.loads(body) if ctype.startswith("application/json") else body), hdrs


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def serve_in_thread(httpd) -> str:
    import threading

    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


def wait_until(what: str, fn, timeout_s: float = 120.0, every_s: float = 0.05):
    """Poll ``fn`` until it returns a true value; that value."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            got = fn()
        except OSError:
            got = None
        if got:
            return got
        time.sleep(every_s)
    raise AssertionError(f"15: timed out waiting for {what}")


def healthz(base: str) -> dict:
    return http_json(base, "/healthz", timeout=10)[1]


def wait_prewarmed(httpd) -> dict:
    """Until a primary's background prewarm has replayed the manifest's
    hot templates (phases 4-14's, process-wide) against its stores, so the
    requests timed next do not share the card with it; how long that took
    after this call and how many templates it replayed.  (A follower warms
    only once promoted.)"""
    warmer = httpd.RequestHandlerClass.state.prewarmer
    t = time.perf_counter()
    n = wait_until("the startup prewarm", lambda: warmer.stats()["startup_replayed"],
                   timeout_s=300.0)
    return {"replayed": n, "waited_ms": (time.perf_counter() - t) * 1e3}


def applied_segment(base: str) -> int:
    repl = healthz(base).get("replication") or {}
    return int((repl.get("watermark") or {}).get("applied_segment") or 0)


def store_query(base: str, store: str, sparql: str, want_rows=None, label: str = "",
                headers=None) -> dict:
    """One ``/store/query``: wall ms, rows, the launches it made (deltas
    of the process's counters) and the answering replica."""
    from kolibrie_tpu_torch.ops import kernels as K

    before = {**K.LAUNCHES, **K.ENTRY_LAUNCHES}
    t = time.perf_counter()
    st, body, hdrs = http_json(base, "/store/query", {"store_id": store, "sparql": sparql},
                               headers=headers)
    ms = (time.perf_counter() - t) * 1e3
    after = {**K.LAUNCHES, **K.ENTRY_LAUNCHES}
    if st != 200:
        raise AssertionError(f"15 {label}: HTTP {st}: {str(body)[:400]}")
    if want_rows is not None and body["data"] != want_rows:
        raise AssertionError(f"15 {label}: {len(body['data'])} rows differ from phase 4's "
                             f"{len(want_rows)}")
    return {"ms": ms, "rows": len(body["data"]), "data": body["data"],
            "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]},
            "replica": hdrs.get("X-Kolibrie-Replica"), "headers": hdrs}


def launched_route(label: str, got: dict, want: dict, on_card: bool) -> None:
    """A warm request's launches hold at least its route's kernels (a
    background prewarm may add its own)."""
    if on_card and any(got.get(k, 0) < n for k, n in want.items()):
        raise AssertionError(f"15 {label}: launches {got}, the route needs {want}")


def percentile(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def serve_recovery(dev, main_path: dict, tmp: str) -> tuple:
    """15a: snapshot phase 4's databases as the server does, boot a durable
    primary on them and time its recovery and first query."""
    from benches.lubm import LUBM_Q2
    from kolibrie_tpu_torch.durability import DurabilityManager
    from kolibrie_tpu_torch.frontends import http_server as hs

    dbs = {name: db for name, db, _q, _w in main_path["queries"]}
    stores = {"lubm": dbs["q2"], "emp": dbs["employee"]}
    data = os.path.join(tmp, "primary")
    t = time.perf_counter()
    m = DurabilityManager(data, device=dev)
    m.start()
    gen = m.snapshot(stores, {})  # _snapshot_now's layout: stores, sessions
    m.close()
    snap_ms = (time.perf_counter() - t) * 1e3
    gen_dir = os.path.join(data, "snapshots", f"gen-{gen:08d}")
    snap_bytes = sum(os.path.getsize(os.path.join(gen_dir, f)) for f in os.listdir(gen_dir))
    repl_port = free_port()
    t = time.perf_counter()
    httpd = hs.make_server("127.0.0.1", 0, quiet=True, data_dir=data, recover_async=False,
                           repl_port=repl_port, device=dev)
    boot_ms = (time.perf_counter() - t) * 1e3
    base = serve_in_thread(httpd)
    hz = healthz(base)
    if hz["status"] != "ready" or sorted(hz["watermark"]["stores"]) != sorted(SERVE_STORES):
        raise AssertionError(f"15a: /healthz {hz}")
    # the first query races the server's startup prewarm, as a client's would
    first = store_query(base, "lubm", LUBM_Q2, main_path["rows"]["q2"], "15a first Q2")
    out = {"snapshot_ms": snap_ms, "snapshot_bytes": snap_bytes, "generation": gen,
           "boot_and_recover_ms": boot_ms,
           "recovery": hz.get("recovery", {}).get("last_recovery") or hz.get("recovery"),
           "first_query_ms": first["ms"], "prewarm": wait_prewarmed(httpd)}
    log(f"15a: {out}")
    return httpd, base, repl_port, out


def serve_queries(dev, main_path: dict, base: str) -> dict:
    """15b: Q2, Q9 and the employee join over HTTP, cold then warm; the
    concurrent template burst; a write's watermark token."""
    import threading

    from benches.lubm import LUBM_Q2, LUBM_Q9
    from kolibrie_tpu_torch import execute_query_volcano

    on_card = dev.type == "cuda"
    rows = main_path["rows"]
    out = {}
    for name, store, q in (("q2", "lubm", LUBM_Q2), ("q9", "lubm", LUBM_Q9),
                           ("employee", "emp", EMPLOYEE_QUERY)):
        cold, warm = (store_query(base, store, q, rows[name], f"15b {name}") for _ in range(2))
        launched_route(f"15b warm {name}", warm["launches"], EXPECTED_LAUNCHES[name], on_card)
        out[name] = {"cold_ms": cold["ms"], "warm_ms": warm["ms"], "rows": cold["rows"],
                     "warm_launches": warm["launches"]}
        log(f"15b {name}: {out[name]}")
    # the template burst: 16 threads, 64 variants, against solo calls on the card
    before = http_json(base, "/stats")[1]["stores"]["emp"]
    texts = [employee_template(i) for i in range(SERVE_VARIANTS)]
    answers, lat, errors = {}, [], []
    gate = threading.Barrier(SERVE_CLIENTS)

    def client(k):
        try:
            gate.wait()
            for i in range(k, SERVE_VARIANTS, SERVE_CLIENTS):
                t = time.perf_counter()
                st, body, _ = http_json(base, "/store/query",
                                        {"store_id": "emp", "sparql": texts[i]})
                lat.append((time.perf_counter() - t) * 1e3)
                if st != 200:
                    raise AssertionError(f"HTTP {st}: {body}")
                answers[i] = body["data"]
        except Exception as e:  # reported below, in the main thread
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(k,)) for k in range(SERVE_CLIENTS)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    burst_ms = (time.perf_counter() - t) * 1e3
    if errors:
        raise AssertionError(f"15b burst: {errors[:3]}")
    emp = next(db for name, db, _q, _w in main_path["queries"] if name == "employee")
    for i, text in enumerate(texts):
        if answers[i] != execute_query_volcano(text, emp):
            raise AssertionError(f"15b burst: variant {i} differs from a solo call")
    after = http_json(base, "/stats")[1]["stores"]["emp"]
    requests = after["requests"] - before["requests"]
    dispatches = after["dispatches"] - before["dispatches"]
    batched = after["plan_cache"]["batched"] - before["plan_cache"]["batched"]
    if requests != SERVE_VARIANTS or not dispatches < requests or batched < 1:
        raise AssertionError(f"15b burst: {requests} requests in {dispatches} dispatches, "
                             f"{batched} batched")
    out["burst"] = {"ms": burst_ms, "requests": requests, "dispatches": dispatches,
                    "batched": batched, "max_batch": after["max_batch"],
                    "p50_ms": percentile(lat, 0.50), "p99_ms": percentile(lat, 0.99)}
    st, body, _ = http_json(base, "/store/load", {
        "store_id": "emp", "rdf": f'<{SERVE_NS}w0> <{SERVE_NS}p> "0" .\n'})
    if st != 200 or body.get("watermark", {}).get("segment", 0) < 1:
        raise AssertionError(f"15b write: {st} {body}")
    out["write_watermark"] = body["watermark"]
    log(f"15b burst: {out['burst']}; write token {body['watermark']}")
    return out


def prom_lines_parse(text: str) -> int:
    """Families of a Prometheus text exposition; raises on a bad line."""
    families = 0
    sample = re.compile(r'[a-zA-Z_:][\w:]*(\{([a-zA-Z_]\w*="([^"\\]|\\.)*",?)*\})? '
                        r'([-+]?[0-9.eE+-]+|[-+]?Inf|NaN)')
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            families += 1
        elif line.startswith("# HELP ") or not line.strip():
            continue
        elif not sample.fullmatch(line):
            raise AssertionError(f"15c /metrics: not Prometheus text: {line!r}")
    return families


def serve_observability(dev, base: str, tmp: str) -> dict:
    """15c: trace id echo and chain, /metrics, /debug/timeline, a profile
    under load, a postmortem bundle."""
    import threading

    from benches.lubm import LUBM_Q2
    from kolibrie_tpu_torch.obs import flightrec, spans, timeseries

    on_card = dev.type == "cuda"
    out = {}
    spans.clear()
    # variable names of its own: a template this process has not lowered
    q = (TEMPLATE_PREFIXES + "SELECT ?obsEmp ?obsPay WHERE { ?obsEmp foaf:workplaceHomepage "
         "<https://company3.example/> . ?obsEmp ds:annual_salary ?obsPay }")
    r = store_query(base, "emp", q, None, "15c traced", {"X-Kolibrie-Trace-Id": "phase15-trace"})
    if r["headers"].get("X-Kolibrie-Trace-Id") != "phase15-trace":
        raise AssertionError(f"15c: trace id not echoed: {r['headers']}")
    chain = {"http.request", "batcher.submit", "batcher.dispatch", "query.execute",
             "query.parse", "query.plan", "device.lower", "device.dispatch", "device.collect"}
    # the handler closes its http.request span after it has written the
    # response, so a trace read at once may still lack it
    deadline = time.monotonic() + 10.0
    while True:
        st, body, _ = http_json(base, "/debug/traces?trace_id=phase15-trace")
        recs = [json.loads(ln) for ln in body.decode().splitlines() if ln]
        names = {rec["name"] for rec in recs}
        if chain <= names or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    if not chain <= names or any(rec["trace_id"] != "phase15-trace" for rec in recs):
        raise AssertionError(f"15c: trace holds {sorted(names)}")
    out["trace_spans"] = len(recs)
    st, text, hdrs = http_json(base, "/metrics")
    out["metric_families"] = prom_lines_parse(text.decode())
    ring = timeseries.default_ring()
    ring.record()
    ring.record()
    st, tl, _ = http_json(base, "/debug/timeline?n=2")
    if st != 200 or tl["samples"] != 2 or "kolibrie_http_requests_total" not in tl["metrics"]:
        raise AssertionError(f"15c /debug/timeline: {st} {str(tl)[:300]}")
    # a profile while queries run on other handler threads
    prof_dir = os.path.join(tmp, "profile")
    os.makedirs(prof_dir)
    os.environ["KOLIBRIE_PROFILE_DIR"] = prof_dir
    busy, stop = [], threading.Event()

    def load():
        while not stop.is_set():
            busy.append(store_query(base, "lubm", LUBM_Q2, None, "15c load")["ms"])
            busy.append(store_query(base, "emp", EMPLOYEE_QUERY, None, "15c load")["ms"])

    th = threading.Thread(target=load)
    th.start()
    try:
        st, prof, _ = http_json(base, f"/debug/profile?seconds={SERVE_PROFILE_S}", {})
    finally:
        stop.set()
        th.join()
        os.environ.pop("KOLIBRIE_PROFILE_DIR", None)
    if st != 200 or prof.get("profiled") is not on_card or prof.get("backend") != (
            "gpu" if on_card else "cpu"):
        raise AssertionError(f"15c /debug/profile: {st} {prof}")
    if on_card:
        with open(os.path.join(prof["trace_dir"], "trace.json")) as fh:
            trace = fh.read()
        found = [n for n in SERVE_KERNEL_NAMES if n in trace]
        if not found:
            raise AssertionError("15c: the profile names no kernel of csrc/")
        out["profile"] = {"trace_files": prof["trace_files"], "kernels": found,
                          "queries_during": len(busy)}
    st, bundle, _ = http_json(base, "/debug/bundle", {})
    manifest = flightrec.read_bundle(bundle["path"])["manifest"]
    if st != 200 or manifest["reason"] != "manual":
        raise AssertionError(f"15c /debug/bundle: {st} {manifest}")
    out["bundle_artifacts"] = sorted(manifest["artifacts"])
    log(f"15c: {out}")
    return out


def q9_homed_on(core, home: str) -> str:
    """LUBM Q9 with its variables renamed so that the router's rendezvous
    order puts ``home`` first (the rows are Q9's)."""
    from benches.lubm import LUBM_Q9
    from kolibrie_tpu_torch.replication.router import template_affinity_key

    for i in range(400):
        q = re.sub(r"\?([xyz])\b", rf"?\g<1>{i}", LUBM_Q9)
        if core.read_order(template_affinity_key(q))[0].name == home:
            return q
    raise AssertionError(f"15d: no Q9 renaming homed on {home}")


def serve_replication(dev, main_path: dict, prim_base: str, repl_port: int, tmp: str) -> dict:
    """15d: an in-process follower of the primary behind the router."""
    from kolibrie_tpu_torch.frontends import http_server as hs
    from kolibrie_tpu_torch.replication.router import make_router

    out = {}
    t = time.perf_counter()
    fol = hs.make_server("127.0.0.1", 0, quiet=True, data_dir=os.path.join(tmp, "follower"),
                         repl_source=f"127.0.0.1:{repl_port}", repl_poll_interval_s=0.05,
                         device=dev)
    fol_base = serve_in_thread(fol)
    wait_until("the follower's bootstrap", lambda: healthz(fol_base)["status"] == "ready")
    out["bootstrap_ms"] = (time.perf_counter() - t) * 1e3
    router, core = make_router([("prim", prim_base), ("fol", fol_base)], quiet=True,
                               probe_interval_s=3600.0, auto_promote=False)
    router_base = serve_in_thread(router)
    try:
        core.probe_once()
        if core.primary() is None or core.primary().name != "prim":
            raise AssertionError(f"15d: router roles {core.stats()}")
        t = time.perf_counter()
        st, body, hdrs = http_json(router_base, "/store/load", {
            "store_id": "emp", "rdf": f'<{SERVE_NS}w1> <{SERVE_NS}p> "1" .\n'})
        if st != 200 or hdrs.get("X-Kolibrie-Replica") != "prim":
            raise AssertionError(f"15d write: {st} {body} {hdrs}")
        seg = body["watermark"]["segment"]
        wait_until("the follower to apply the write", lambda: applied_segment(fol_base) >= seg)
        out["write_to_applied_ms"] = (time.perf_counter() - t) * 1e3
        q9 = q9_homed_on(core, "fol")
        cold = store_query(router_base, "lubm", q9, main_path["rows"]["q9"], "15d Q9")
        warm = store_query(router_base, "lubm", q9, main_path["rows"]["q9"], "15d Q9 warm")
        if cold["replica"] != "fol" or warm["replica"] != "fol":
            raise AssertionError(f"15d: Q9 answered by {cold['replica']}, {warm['replica']}")
        launched_route("15d warm Q9 on the follower", warm["launches"], EXPECTED_LAUNCHES["q9"],
                       dev.type == "cuda")
        out["q9_follower_ms"] = {"cold": cold["ms"], "warm": warm["ms"]}
        st, text, _ = http_json(router_base, "/fleet/metrics")
        text = text.decode()
        if st != 200 or 'node="prim"' not in text or 'node="fol"' not in text:
            raise AssertionError("15d: /fleet/metrics lacks a node's labels")
        out["fleet_metric_lines"] = len(text.splitlines())
    finally:
        core.stop()
        router.shutdown()
        hs.shutdown_gracefully(fol, timeout_s=10.0)
        fol.server_close()
    log(f"15d: {out}")
    return out


def serve_kill9(dev, main_path: dict, tmp: str) -> dict:
    """15e: a child-process primary SIGKILLed mid-ingest; the router's
    supervisor promotes the in-process follower."""
    import shutil
    import signal
    import threading

    from kolibrie_tpu_torch.frontends import http_server as hs
    from kolibrie_tpu_torch.ops import kernels as K
    from kolibrie_tpu_torch.query import compile_cache
    from kolibrie_tpu_torch.replication.router import make_router

    on_card = dev.type == "cuda"
    repo = os.path.dirname(os.path.abspath(__file__))
    out = {}
    # the child shares a kernel cache this process fills: no nvcc at its boot
    cache = os.path.join(tmp, "kernel_cache")
    target = os.path.join(cache, compile_cache.cache_namespace())
    os.makedirs(target)
    for lib in K._BUILD.glob("lib*.so"):
        shutil.copy(lib, target)
    http_port, repl_port = free_port(), free_port()
    env = dict(os.environ, KOLIBRIE_DATA_DIR=os.path.join(tmp, "child"),
               KOLIBRIE_REPL_PORT=str(repl_port), KOLIBRIE_COMPILE_CACHE_DIR=cache,
               KOLIBRIE_LOG_QUIET="1", KOLIBRIE_REPL_SEAL_INTERVAL_S="0.05",
               KOLIBRIE_FLIGHTREC_DISABLED="1", PYTHONPATH=repo)
    child_base = f"http://127.0.0.1:{http_port}"
    err_path = os.path.join(tmp, "child.err")
    t = time.perf_counter()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "kolibrie_tpu_torch.frontends.cli", "--serve",
             "--device", dev.type, "--port", str(http_port)],
            stdout=subprocess.DEVNULL, stderr=err, env=env, cwd=repo)
    fol = router = core = None
    try:
        def child_ready():
            if proc.poll() is not None:
                raise AssertionError("15e: the child primary died:\n"
                                     + open(err_path).read()[-4000:])
            return healthz(child_base).get("status") == "ready"

        wait_until("the child primary", child_ready, timeout_s=300.0, every_s=0.2)
        out["child_boot_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        st, body, _ = http_json(child_base, "/store/load", {
            "store_id": "emp", "rdf": employee_ntriples(EMPLOYEES), "mode": "device"})
        if st != 200 or body["triples"] != 4 * EMPLOYEES:
            raise AssertionError(f"15e load: {st} {str(body)[:300]}")
        out["load_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        fol = hs.make_server("127.0.0.1", 0, quiet=True, data_dir=os.path.join(tmp, "fol15e"),
                             repl_source=f"127.0.0.1:{repl_port}", repl_poll_interval_s=0.05,
                             device=dev)
        fol_base = serve_in_thread(fol)
        wait_until("the follower's bootstrap", lambda: healthz(fol_base)["status"] == "ready")
        out["follower_bootstrap_ms"] = (time.perf_counter() - t) * 1e3
        follower = fol.RequestHandlerClass.state.replication
        router, core = make_router([("prim", child_base), ("fol", fol_base)], quiet=True,
                                   probe_interval_s=0.1, auto_promote=True)
        router_base = serve_in_thread(router)
        wait_until("the router's roles", lambda: core.primary() and core.primary().name == "prim")
        acked, stop = [], threading.Event()

        def writer():
            i = 0
            while not stop.is_set():
                st, body, _ = http_json(router_base, "/store/load", {
                    "store_id": "emp",
                    "rdf": f'<{SERVE_NS}ingest{i}> <{SERVE_NS}seq> "{i}" .\n'}, timeout=10)
                if st != 200:
                    return  # the primary is gone
                acked.append((i, body["watermark"]["segment"]))
                i += 1

        th = threading.Thread(target=writer)
        th.start()
        try:
            wait_until("acknowledged writes", lambda: len(acked) > SERVE_WRITES_CONFIRMED)
            seg = acked[SERVE_WRITES_CONFIRMED][1]
            wait_until("the follower to apply them", lambda: follower.applied_segment >= seg)
            killed_at = len(acked)
            proc.send_signal(signal.SIGKILL)
            proc.wait()
            t = time.perf_counter()
            wait_until("the promotion", lambda: core.primary() and core.primary().name == "fol",
                       timeout_s=60.0)
            out["kill_to_promoted_ms"] = (time.perf_counter() - t) * 1e3
        finally:
            stop.set()
            th.join()
        applied = follower.applied_segment
        confirmed = {i for i, s in acked if s <= applied}
        st, body, _ = http_json(router_base, "/store/query", {
            "store_id": "emp", "sparql": f"SELECT ?o WHERE {{ ?s <{SERVE_NS}seq> ?o }}"})
        present = {int(r[0]) for r in body["data"]}
        if st != 200 or not confirmed <= present or len(confirmed) <= SERVE_WRITES_CONFIRMED:
            raise AssertionError(f"15e: {len(confirmed)} confirmed writes, "
                                 f"{len(confirmed - present)} missing after the promotion")
        st, body, hdrs = http_json(router_base, "/store/load", {
            "store_id": "emp", "rdf": f'<{SERVE_NS}after> <{SERVE_NS}p> "promoted" .\n'})
        if st != 200 or hdrs.get("X-Kolibrie-Replica") != "fol":
            raise AssertionError(f"15e: the promoted node refused a write: {st} {body}")
        join = store_query(router_base, "emp", EMPLOYEE_QUERY, main_path["rows"]["employee"],
                           "15e join")
        join = store_query(router_base, "emp", EMPLOYEE_QUERY, main_path["rows"]["employee"],
                           "15e join warm")
        launched_route("15e employee join on the promoted node", join["launches"],
                       EXPECTED_LAUNCHES["employee"], on_card)
        out.update({"acked": len(acked), "acked_at_kill": killed_at,
                    "confirmed": len(confirmed), "present": len(present),
                    "applied_segment": applied, "join_ms": join["ms"],
                    "join_launches": join["launches"], "child_returncode": proc.returncode})
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        if core is not None:
            core.stop()
            router.shutdown()
        if fol is not None:
            hs.shutdown_gracefully(fol, timeout_s=10.0)
            fol.server_close()
    log(f"15e: {out}")
    return out


def run_serving_phase(dev, main_path: dict) -> dict:
    """Phase 15 (15a-15e), its launches counted from just before 15a to just
    after 15e.  The servers point the kernel build at their data dirs'
    compile cache; the process's build directory is put back afterwards."""
    import tempfile

    from kolibrie_tpu_torch.frontends import http_server as hs
    from kolibrie_tpu_torch.obs import log as obslog
    from kolibrie_tpu_torch.ops import kernels as K
    from kolibrie_tpu_torch.query import compile_cache

    t0 = time.perf_counter()
    captured, report = {}, {}
    obslog.set_quiet(True)
    K.reset_launches()
    undo = recorder_install(captured)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            prim, base, repl_port, report["15a"] = serve_recovery(dev, main_path, tmp)
            try:
                report["15b"] = serve_queries(dev, main_path, base)
                report["15c"] = serve_observability(dev, base, tmp)
                report["15d"] = serve_replication(dev, main_path, base, repl_port, tmp)
            finally:
                hs.shutdown_gracefully(prim, timeout_s=10.0)
                prim.server_close()
            report["15e"] = serve_kill9(dev, main_path, tmp)
    finally:
        undo()
        obslog.set_quiet(False)
        compile_cache._active_dir = None
        K.set_build_dir(K._BUILD)
    launches = {**K.LAUNCHES}
    if dev.type == "cuda":
        missing = [k for k in ("merge_path_join", "lex_probe_select", "lex_probe_validate")
                   if not launches.get(k)]
        if missing:
            raise AssertionError(f"phase 15 launched no {missing}: {launches}")
    report["seconds"] = time.perf_counter() - t0
    log(f"phase 15 launches: {launches}; {report['seconds']:.1f} s")
    return {"report": report, "launches": launches, "captured": captured}


# ------------------------------------------ phase 16: the multi-device layer

MESH_SHARDS = 4  # shards over the cards present (all on cuda:0 with one card)
MESH_VARIANTS = 64  # 16d: constant-variants of the serving template
MESH_CLIENTS = 16  # 16d: HTTP client threads
MESH_INSERT = 1_000  # 16d: triples of the INSERT DATA between the two groups
MESH_NS = "http://phase16.example/"
MESH_TEMPLATE = (
    "PREFIX ub: <http://swat.cse.lehigh.edu/onto/univ-bench.owl#>\n"
    "SELECT ?x ?c WHERE {{ ?x ub:worksFor <{dept}> . ?x ub:teacherOf ?c . }}"
)
MESH_DEPTS = ("PREFIX ub: <http://swat.cse.lehigh.edu/onto/univ-bench.owl#>\n"
              "SELECT DISTINCT ?d WHERE { ?x ub:worksFor ?d . }")
MESH_KERNELS = ("filter_mask", "merge_path_join")


def mesh_devices(dev, n: int) -> list:
    """``n`` shard placements over the cards present, round robin (the
    CPU ``n`` times for a rehearsal)."""
    import torch

    if dev.type != "cuda":
        return [torch.device("cpu")] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def mesh_insert(depts: list) -> str:
    """16d's INSERT DATA: ``MESH_INSERT`` triples, half new faculty working
    for the template's departments, half the courses they teach."""
    lines = []
    for i in range(MESH_INSERT // 2):
        f = f"<{MESH_NS}faculty{i}>"
        lines.append(f"{f} ub:worksFor <{depts[i % len(depts)]}> .")
        lines.append(f"{f} ub:teacherOf <{MESH_NS}course{i}> .")
    return ("PREFIX ub: <http://swat.cse.lehigh.edu/onto/univ-bench.owl#>\n"
            "INSERT DATA { " + " ".join(lines) + " }")


class PlainCalls:
    """Counts calls of the kernels' plain versions while active (a card run
    must make none on the mesh path)."""

    def __enter__(self):
        from kolibrie_tpu_torch.ops import kernels as K

        self.counts = {"merge_path_plain": 0, "filter_mask_plain": 0}
        self._saved = (K.merge_path_plain, K.filter_mask_plain)

        def spy(name, fn):
            def wrapped(*a, **k):
                self.counts[name] += 1
                return fn(*a, **k)
            return wrapped

        K.merge_path_plain = spy("merge_path_plain", self._saved[0])
        K.filter_mask_plain = spy("filter_mask_plain", self._saved[1])
        return self

    def __exit__(self, *exc):
        from kolibrie_tpu_torch.ops import kernels as K

        K.merge_path_plain, K.filter_mask_plain = self._saved


def mesh_filter_recorder(captured: dict):
    """Keep the mesh path's largest ``filter_mask`` call (no readback) for
    phase 5; returns the undo."""
    from kolibrie_tpu_torch.parallel import sharded_serving as SS
    from kolibrie_tpu_torch.reasoner import device_fixpoint as FX

    saved = (FX.filter_mask, SS.filter_mask)

    def wrapped(s_, p_, o_, s_c=-1, p_c=-1, o_c=-1, *rest):
        if s_.shape[0] >= captured.get("filter_mask", (0, None))[0]:
            kw = {"s_const": s_c, "p_const": p_c, "o_const": o_c, "o_op": -1, "o_cmp": 0}
            captured["filter_mask"] = (s_.shape[0], (s_, p_, o_, kw))
        return saved[0](s_, p_, o_, s_c, p_c, o_c, *rest)

    FX.filter_mask = SS.filter_mask = wrapped

    def undo():
        FX.filter_mask, SS.filter_mask = saved

    return undo


def step_launches(fn):
    """``(result, launches, wall ms)`` of ``fn()``: the launch counters'
    growth over the call, and its wall (synchronised)."""
    import torch

    from kolibrie_tpu_torch.ops import kernels as K

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    before = dict(K.LAUNCHES)
    t = time.perf_counter()
    out = fn()
    sync()
    ms = (time.perf_counter() - t) * 1e3
    return out, {k: v - before[k] for k, v in K.LAUNCHES.items() if v != before[k]}, ms


def need_kernels(label: str, launches: dict, on_card: bool, names=MESH_KERNELS) -> None:
    if on_card:
        missing = [k for k in names if not launches.get(k)]
        if missing:
            raise AssertionError(f"16{label} launched no {missing}: {launches}")


def plan_exchange_bytes(ex) -> int:
    """Bytes the all-to-all exchanges of a ``DistQueryExecutor`` plan move
    at its converged capacities: before each join step every shard sends
    its binding table (8-byte ID carriers a column, a 1-byte validity) in
    ``n`` fixed buckets of ``bucket_cap`` rows."""
    bound = {v for v, _ in ex.premises[ex.seed].vars}
    total = 0
    for j, _kv, _kpos, _extra in ex.steps:
        total += (8 * len(bound) + 1) * ex.n * ex.n * ex.bucket_cap
        bound |= {v for v, _ in ex.premises[j].vars}
    return total if ex.n > 1 else 0


def mesh_store_step(dev, mesh, lubm) -> tuple:
    """16a: partition LUBM-1000 over the mesh, both mirrors' occupancy and
    imbalance, peak memory, and the co-located BGP join count against
    numpy (``benches/bench_lubm.py``'s formula)."""
    import numpy as np
    import torch

    from kolibrie_tpu_torch.parallel import ShardedTripleStore, dist_bgp_join_count
    from kolibrie_tpu_torch.parallel.dist_join import dist_bgp_join_count_device

    on_card = dev.type == "cuda"
    s, p, o = lubm.store.columns()
    resident = None
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
    store, _l, ms = step_launches(lambda: ShardedTripleStore.from_columns(mesh, s, p, o))
    occ = {name: [int(v.sum()) for v in valid]
           for name, valid in (("subj", store.by_subj_valid), ("obj", store.by_obj_valid))}
    imb = {k: max(v) / (sum(v) / len(v)) for k, v in occ.items()}
    d = lubm.dictionary
    p1 = d.lookup("http://swat.cse.lehigh.edu/onto/univ-bench.owl#advisor")
    p2 = d.lookup("http://swat.cse.lehigh.edu/onto/univ-bench.owl#teacherOf")
    count = dist_bgp_join_count(store, p1, p2)
    lv, lc = np.unique(o[p == p1], return_counts=True)
    rv, rc = np.unique(s[p == p2], return_counts=True)
    _, li, ri = np.intersect1d(lv, rv, return_indices=True)
    want = int((lc[li] * rc[ri]).sum())
    if count != want or sum(occ["subj"]) != len(s) or sum(occ["obj"]) != len(s):
        raise AssertionError(f"16a: count {count} (numpy {want}), occupancy {occ}")
    count_ms = time_ms(lambda: dist_bgp_join_count_device(store, p1, p2), reps=5)[0] if on_card else None
    out = {"partition_ms": ms, "cap": store.cap, "occupancy": occ, "imbalance": imb,
           "advisor_teacherOf": count, "count_device_ms": count_ms, "resident_bytes": resident,
           "peak_bytes": torch.cuda.max_memory_allocated() if on_card else None}
    log(f"16a: {out}")
    return store, out


def mesh_query_step(dev, mesh, lubm, store, main_path: dict) -> dict:
    """16b: Q2 and Q9 through ``DistQueryExecutor`` over the store of 16a;
    rows equal to phase 4's single-device rows; warm ``run_device`` times
    (synchronised) and a busy share."""
    from benches.lubm import LUBM_Q2, LUBM_Q9
    from kolibrie_tpu_torch.parallel import DistQueryExecutor

    on_card = dev.type == "cuda"
    out = {}
    for name, q in (("q2", LUBM_Q2), ("q9", LUBM_Q9)):
        ex = DistQueryExecutor(mesh, lubm, q, store=store)
        rows, launches, ms = step_launches(ex.run)
        if rows != main_path["rows"][name]:
            raise AssertionError(f"16b {name}: {len(rows)} rows differ from phase 4's "
                                 f"{len(main_path['rows'][name])}")
        need_kernels(f"b {name}", launches, on_card)
        warm = [step_launches(ex.run_device)[2] for _ in range(3)]
        out[name] = {"rows": len(rows), "run_ms": ms, "run_device_ms": warm,
                     "caps": [ex.join_cap, ex.bucket_cap], "launches": launches,
                     "exchanged_bytes": plan_exchange_bytes(ex),
                     "busy": busy_share(dev, ex.run_device) if on_card else None}
        log(f"16b {name}: {out[name]}")
    return out


def mesh_closure_step(dev, mesh, lubm, closure: dict) -> dict:
    """16c: the general distributed fixpoint over phase 6's closure rules;
    its fact set must equal phase 6's closure."""
    import numpy as np

    from kolibrie_tpu_torch import Reasoner
    from kolibrie_tpu_torch.parallel import DistGeneralReasoner

    s, p, o = lubm.store.columns()
    r = Reasoner(lubm.dictionary, device=dev)
    r.facts.add_batch(s, p, o)
    add_lubm_closure_rules(r)
    len(r.facts)
    dr = DistGeneralReasoner(mesh, r)
    derived, launches, ms = step_launches(dr.infer)
    want = closure["facts"]
    if derived != CLOSURE_DERIVED or not all(
            np.array_equal(x, y) for x, y in zip(r.facts.columns(), want)):
        raise AssertionError(f"16c: {derived} derived; the fact set differs from phase 6's")
    need_kernels("c", launches, dev.type == "cuda")
    out = {"derived": derived, "ms": ms, "rounds": dr.rounds, "attempts": dr.attempts,
           "caps": [dr.fact_cap, dr.delta_cap, dr.join_cap, dr.bucket_cap], "launches": launches}
    log(f"16c: {out}")
    return out


class OnlyTemplate:
    """While active, the prewarm manifest holds only the fingerprint of
    ``query`` (a server booted inside warms that template, mesh included,
    and not the hundreds the earlier phases recorded)."""

    def __init__(self, query: str, db):
        from kolibrie_tpu_torch.query.parser import parse_combined_query
        from kolibrie_tpu_torch.query.template import fingerprint_query

        self.fp = fingerprint_query(parse_combined_query(query, db.prefixes))[0]

    def __enter__(self):
        from kolibrie_tpu_torch.query import compile_cache as cc

        self._saved = (cc.manifest_snapshot, cc.load_manifest)
        keep = lambda ents: [e for e in ents if e.get("fp") == self.fp]  # noqa: E731
        cc.manifest_snapshot = lambda *a, **k: keep(self._saved[0](*a, **k))
        cc.load_manifest = lambda *a, **k: keep(self._saved[1](*a, **k))
        return self

    def __exit__(self, *exc):
        from kolibrie_tpu_torch.query import compile_cache as cc

        cc.manifest_snapshot, cc.load_manifest = self._saved


def mesh_serving_step(dev, mesh, lubm, tmp: str) -> dict:
    """16d: ``attach_sharded`` on phase 4's LUBM-1000, 64 template variants
    through ``execute_queries_batched`` against the single-device answers,
    an INSERT DATA of 1,000 triples (a delta refresh, no new program), the
    group again, then the same 64 variants as an HTTP burst from 16
    threads against a durable server booted on a snapshot of that store
    with the mesh, and its ``/stats`` and ``/metrics``."""
    import threading

    from kolibrie_tpu_torch import execute_query_volcano
    from kolibrie_tpu_torch.durability import DurabilityManager
    from kolibrie_tpu_torch.frontends import http_server as hs
    from kolibrie_tpu_torch.parallel import attach_sharded, sharded_compile_stats
    from kolibrie_tpu_torch.parallel import sharded_serving as SS
    from kolibrie_tpu_torch.query.executor import execute_queries_batched

    on_card = dev.type == "cuda"
    out = {}
    xbytes = SS._SHARD_XBYTES.labels().value
    attach_errors = hs._SHARDED_ATTACH_ERRORS.labels().value
    depts = [r[0] for r in execute_query_volcano(MESH_DEPTS, lubm)][:MESH_VARIANTS]
    texts = [MESH_TEMPLATE.format(dept=d) for d in depts]
    want = [execute_query_volcano(t, lubm) for t in texts]
    sh = attach_sharded(lubm, mesh)
    if sh is None:
        raise AssertionError("16d: attach_sharded attached nothing")
    _r, _l, out["refresh_ms"] = step_launches(sh.refresh)
    got, launches, ms = step_launches(lambda: execute_queries_batched(lubm, texts))
    st = sh.stats()
    if got != want or st["dispatches"] < 1 or st["batched_queries"] != MESH_VARIANTS or st["fallbacks"]:
        raise AssertionError(f"16d group: equal {got == want}, stats {st}")
    need_kernels("d group", launches, on_card)
    warm, _l2, warm_ms = step_launches(lambda: execute_queries_batched(lubm, texts))
    if warm != want:
        raise AssertionError("16d: the warm group differs from the single-device answers")
    out["group"] = {"ms": ms, "warm_ms": warm_ms, "launches": launches,
                    "rows": sum(len(r) for r in got), "cap_hits": st["cap_hits"],
                    "exchanged_bytes": SS._SHARD_XBYTES.labels().value - xbytes,
                    "busy": busy_share(dev, lambda: execute_queries_batched(lubm, texts))}
    # a mutation batch under the delta threshold: a delta refresh, no new
    # program surface, answers equal to the single-device run
    sig = lubm.store.segment_signature()
    if sig[2] + sig[3] + MESH_INSERT > lubm.store.delta_threshold:
        raise AssertionError(f"16d: the store's delta {sig} leaves no room for the insert")
    before, rebuilds = sharded_compile_stats(), sh.stats_counters["base_rebuilds"]
    refreshes = sh.stats_counters["delta_refreshes"]
    execute_query_volcano(mesh_insert(depts), lubm)
    want2 = [execute_query_volcano(t, lubm) for t in texts]
    got2, launches2, ms2 = step_launches(lambda: execute_queries_batched(lubm, texts))
    st2 = sh.stats()
    if (got2 != want2 or want2 == want or sharded_compile_stats() != before
            or st2["base_rebuilds"] != rebuilds or st2["delta_refreshes"] <= refreshes
            or st2["fallbacks"]):
        raise AssertionError(f"16d after the insert: equal {got2 == want2}, compile "
                             f"{sharded_compile_stats()} vs {before}, stats {st2}")
    need_kernels("d after the insert", launches2, on_card)
    out["after_insert"] = {"ms": ms2, "launches": launches2, "compile": before,
                           "delta_refreshes": st2["delta_refreshes"]}
    # the HTTP burst against a durable server on a snapshot of that store
    data = os.path.join(tmp, "mesh")
    m = DurabilityManager(data, device=dev)
    m.start()
    t = time.perf_counter()
    m.snapshot({"lubm": lubm}, {})
    m.close()
    out["snapshot_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    with OnlyTemplate(texts[0], lubm):
        httpd = hs.make_server("127.0.0.1", 0, quiet=True, data_dir=data, recover_async=False,
                               device=dev, mesh=mesh)
        out["boot_ms"] = (time.perf_counter() - t) * 1e3
        try:
            base = serve_in_thread(httpd)
            out["prewarm"] = wait_prewarmed(httpd)
            answers, lat, errors = {}, [], []
            gate = threading.Barrier(MESH_CLIENTS)

            def client(k):
                try:
                    gate.wait()
                    for i in range(k, MESH_VARIANTS, MESH_CLIENTS):
                        t0 = time.perf_counter()
                        code, body, _ = http_json(base, "/store/query",
                                                  {"store_id": "lubm", "sparql": texts[i]})
                        lat.append((time.perf_counter() - t0) * 1e3)
                        if code != 200:
                            raise AssertionError(f"HTTP {code}: {body}")
                        answers[i] = body["data"]
                except Exception as e:  # reported below, in the main thread
                    errors.append(repr(e))

            threads = [threading.Thread(target=client, args=(k,)) for k in range(MESH_CLIENTS)]
            _r, blaunches, burst_ms = step_launches(
                lambda: [th.start() for th in threads] and [th.join() for th in threads])
            if errors:
                raise AssertionError(f"16d burst: {errors[:3]}")
            bad = [i for i in range(MESH_VARIANTS) if answers[i] != want2[i]]
            if bad:
                raise AssertionError(f"16d burst: variants {bad[:5]} differ from the single-device run")
            stats = http_json(base, "/stats")[1]["stores"]["lubm"]
            sharding = stats.get("sharding") or {}
            keys = {"shards", "signature", "base_cap", "delta_cap", "base_rebuilds",
                    "delta_refreshes", "dispatches", "batched_queries", "fallbacks",
                    "cap_hits", "last_cap_hit", "occupancy", "imbalance", "compile_surfaces"}
            if (not keys <= set(sharding) or sharding["shards"] != MESH_SHARDS
                    or sharding["batched_queries"] < 2 or sharding["fallbacks"]):
                raise AssertionError(f"16d /stats sharding: {sharding}")
            metrics = http_json(base, "/metrics")[1].decode()
            fams = ("kolibrie_shard_dispatch_total", "kolibrie_shard_queries_total",
                    "kolibrie_shard_rows_scanned_total", "kolibrie_shard_exchanged_bytes_total",
                    "kolibrie_shard_h2d_bytes_total", "kolibrie_shard_imbalance",
                    "kolibrie_shard_rows", "kolibrie_shard_exchange_cap_hits_total",
                    "kolibrie_shard_fallback_total", "kolibrie_shard_dispatch_seconds",
                    "kolibrie_shard_attach_errors_total", "kolibrie_store_shards",
                    "kolibrie_store_shard_imbalance")
            missing = [f for f in fams if f"# TYPE {f} " not in metrics]
            if missing:
                raise AssertionError(f"16d /metrics lacks {missing}")
            need_kernels("d burst", blaunches, on_card)
            out["burst"] = {"ms": burst_ms, "p50_ms": percentile(lat, 0.50),
                            "p99_ms": percentile(lat, 0.99), "launches": blaunches,
                            "dispatches": sharding["dispatches"],
                            "batched_queries": sharding["batched_queries"],
                            "occupancy": sharding["occupancy"], "imbalance": sharding["imbalance"]}
        finally:
            hs.shutdown_gracefully(httpd, timeout_s=10.0)
            httpd.server_close()
    if hs._SHARDED_ATTACH_ERRORS.labels().value != attach_errors:
        raise AssertionError("16d: a sharded attach failed")
    out["stats"] = sh.stats()
    log(f"16d: {out}")
    return out


def run_mesh_phase(dev, main_path: dict, closure: dict) -> dict:
    """Phase 16 (16a-16d) on phase 4's LUBM-1000 and phase 6's closure,
    four shards over the cards present; its launches counted from just
    before 16a to just after 16d, with no call of a kernel's plain
    version on the card."""
    import tempfile

    from kolibrie_tpu_torch.obs import log as obslog
    from kolibrie_tpu_torch.ops import kernels as K
    from kolibrie_tpu_torch.parallel import make_mesh
    from kolibrie_tpu_torch.query import compile_cache

    import torch

    t0 = time.perf_counter()
    lubm = next(db for name, db, _q, _w in main_path["queries"] if name == "q2")
    mesh = make_mesh(MESH_SHARDS, devices=mesh_devices(dev, MESH_SHARDS))
    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    log(f"phase 16: {MESH_SHARDS} shards on {[str(d) for d in mesh.devices]}, {count} card(s)")
    captured, report = {}, {}
    obslog.set_quiet(True)
    undo = [recorder_install(captured), mesh_filter_recorder(captured)]
    try:
        with PlainCalls() as plain, tempfile.TemporaryDirectory() as tmp:
            K.reset_launches()
            store, report["16a"] = mesh_store_step(dev, mesh, lubm)
            report["16b"] = mesh_query_step(dev, mesh, lubm, store, main_path)
            del store
            report["16c"] = mesh_closure_step(dev, mesh, lubm, closure)
            report["16d"] = mesh_serving_step(dev, mesh, lubm, tmp)
            total = {k: v for k, v in K.LAUNCHES.items() if v}
            if dev.type == "cuda" and any(plain.counts.values()):
                raise AssertionError(f"phase 16 called plain versions: {plain.counts}")
    finally:
        for u in undo:
            u()
        obslog.set_quiet(False)
        compile_cache._active_dir = None
        K.set_build_dir(K._BUILD)
    need_kernels("", total, dev.type == "cuda")
    report["seconds"] = time.perf_counter() - t0
    log(f"phase 16 launches: {total}; {report['seconds']:.1f} s")
    return {"report": report, "launches": total, "captured": captured}


# ------------------- phase 17: distributed provenance and the training steps

TRAIN_STEPS = 20  # 17c: dp_train_step steps over ML_SAMPLES digit samples
TRAIN_LR = 0.05  # 12c's TRAIN learning rate
TRAIN_TOL = 1e-5  # 17c: each step's loss, and the last state, against the one-device step's
# 17b: the NAF programs of tests/test_dist_provenance.py (and one NAF rule
# whose body joins), against the port's host loop
NAF_PROGRAMS = ("naf_minmax", "naf_boolean_feeds_positive", "naf_addmult",
                "naf_addmult_across_passes", "cross_blocking_boolean",
                "cross_blocking_minmax", "naf_join_minmax")
NAF_REFUSED = ("self_blocking", "order_sensitive", "structural")


def sorted_facts(cols) -> tuple:
    """Fact columns in lexicographic (s, p, o) order."""
    import numpy as np

    order = np.lexsort((cols[2], cols[1], cols[0]))
    return tuple(np.asarray(c)[order] for c in cols)


def need_dispatch_launches(label: str, launches: dict, floor: dict, on_card: bool) -> None:
    """On the card: at least ``floor`` launches of each kernel."""
    if on_card and any(launches.get(k, 0) < n for k, n in floor.items()):
        raise AssertionError(f"{label}: launches {launches}, floor {floor}")


def prov_mesh_step(dev, mesh, work: dict, results: dict) -> dict:
    """17a: ``DistProvenanceReasoner`` on phase 9a's graph under each
    semiring, cold then warm on fresh reasoners; each run's facts and
    TagStore equal 9a's device-route results, AddMult's two runs are
    bit-identical, and every dispatch launches the merge path and the fused
    filter on every shard (9a's per-dispatch counts, once a shard)."""
    import numpy as np
    import torch

    from kolibrie_tpu_torch.parallel import DistProvenanceReasoner

    on_card = dev.type == "cuda"
    out = {}
    for name in PROV_SEMIRINGS:
        runs = {}
        for label in ("cold", "warm"):
            r, cols = prov_reasoner(dev, work)
            prov, store = prov_tag_store(name, cols, work)
            n0 = len(r.facts)
            resident = None
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                resident = torch.cuda.memory_allocated()
            dr = DistProvenanceReasoner(mesh, r, prov, store)
            derived, launches, ms = step_launches(dr.infer)
            rec = runs[label] = {
                "derived": derived, "ms": ms, "dispatches": dr.dispatches, "rounds": dr.rounds,
                "attempts": dr.attempts,
                "caps": [dr.fact_cap, dr.delta_cap, dr.join_cap, dr.bucket_cap],
                "launches": launches, "resident_bytes": resident,
                "peak_bytes": torch.cuda.max_memory_allocated() if on_card else None,
                "tags": dict(store.tags), "facts": sorted_facts(r.facts.columns()),
            }
            log(f"17a {name} {label}: {n0} facts, {derived} derived, {ms:.1f} ms, "
                f"{dr.rounds} rounds of {dr.dispatches} dispatches, {dr.attempts} capacity "
                f"attempts, caps {rec['caps']}, peak device memory {rec['peak_bytes']} B "
                f"({resident} B resident before), launches {launches}")
            floor = {k: n * mesh.size * dr.dispatches for k, n in PROV_LAUNCHES.items()}
            need_dispatch_launches(f"17a {name} {label}", launches, floor, on_card)
        want, err = results[name], 0.0
        for label, rec in runs.items():
            if rec["derived"] != want["derived"] or not all(
                    np.array_equal(a, b) for a, b in zip(rec["facts"], want["facts"])):
                raise AssertionError(f"17a {name} {label}: {rec['derived']} derived; the facts "
                                     f"differ from 9a's ({want['derived']})")
            err = max(err, same_tags(want["tags"], rec["tags"], name == "addmult"))
        cold, warm = runs["cold"], runs["warm"]
        if name == "addmult" and (cold["tags"] != warm["tags"] or any(
                cold[k] != warm[k] for k in ("dispatches", "rounds", "caps"))):
            raise AssertionError("17a addmult: two mesh runs differ")
        for rec in runs.values():
            del rec["tags"], rec["facts"]
        out[name] = {**runs, "max_tag_err": err}
        log(f"17a {name}: both runs' facts and TagStore equal 9a's single-device run (largest tag "
            f"difference {err}){'; two mesh runs bit-identical' if name == 'addmult' else ''}")
    return out


def naf_program(name: str, new_reasoner) -> tuple:
    """One of 17b's programs as ``(reasoner, semiring name)``, built into
    ``new_reasoner()`` (any reasoner with the port's building methods)."""
    r = new_reasoner()
    rule = r.rule_from_strings

    def add(prems, concls, negs=None):
        r.add_rule(rule(prems, concls, negative=negs))

    prov = "minmax"
    if name == "naf_minmax":
        for i in range(12):
            r.add_tagged_triple(f"a{i}", "p", f"b{i}", 0.5 + 0.03 * i)
        for i in range(0, 12, 3):
            r.add_tagged_triple(f"b{i}", "broken", "yes", 0.3)
        add([("?x", "p", "?y")], [("?x", "ok", "?y")], [("?y", "broken", "yes")])
    elif name == "naf_boolean_feeds_positive":
        prov = "boolean"
        for i in range(10):
            r.add_abox_triple(f"v{i}", "p", f"w{i}")
        add([("?v", "p", "?w")], [("?v", "q", "?w")], [("missing", "r", "z")])
        add([("?v", "q", "?w")], [("?v", "s", "?w")])
    elif name == "naf_addmult":
        prov = "addmult"
        for s, o, t in (("a", "b", 0.9), ("b", "c", 0.8)):
            r.add_tagged_triple(s, "p", o, t)
        r.add_tagged_triple("c", "broken", "yes", 0.4)
        for i in range(8):
            r.add_tagged_triple(f"u{i}", "p", f"v{i % 3}", 0.3 + 0.08 * i)
        r.add_tagged_triple("v1", "broken", "yes", 0.25)
        add([("?x", "p", "?y")], [("?x", "ok", "?y")], [("?y", "broken", "yes")])
    elif name == "naf_addmult_across_passes":
        prov = "addmult"
        for s, p, o, t in (("a", "p", "b", 0.6), ("c", "p", "d", 0.5),
                           ("d", "blocked", "yes", 0.3), ("a", "r", "b", 0.7),
                           ("e", "r", "f", 0.4)):
            r.add_tagged_triple(s, p, o, t)
        add([("?x", "p", "?y")], [("?x", "q", "?y")], [("?y", "blocked", "yes")])
        add([("?x", "q", "?y")], [("?x", "s", "?y")])
        add([("?x", "r", "?y")], [("?x", "w", "?y")], [("?x", "s", "?y")])
    elif name.startswith("cross_blocking"):
        prov = name.split("_")[-1]
        r.add_abox_triple("a", "p", "b")
        r.add_abox_triple("c", "p", "d")
        add([("?x", "p", "?y")], [("?y", "blocked", "yes")], [("dummy", "d", "d")])
        add([("?x", "p", "?y")], [("?x", "ok", "?y")], [("?y", "blocked", "yes")])
    elif name == "naf_join_minmax":
        for i in range(40):
            r.add_tagged_triple(f"p{i}", "knows", f"p{(i * 7 + 3) % 40}", 0.5 + 0.01 * i)
            r.add_tagged_triple(f"p{i}", "worksAt", f"org{i % 6}", 0.9 - 0.01 * i)
        r.add_tagged_triple("org2", "suspended", "yes", 0.4)
        r.add_tagged_triple("org5", "suspended", "yes", 1.0)
        add([("?x", "knows", "?y"), ("?y", "worksAt", "?o")], [("?x", "colleagueAt", "?o")],
            [("?o", "suspended", "yes")])
    elif name == "self_blocking":
        prov = "boolean"
        r.add_abox_triple("a", "p", "b")
        add([("?x", "p", "?y")], [("?y", "blocked", "yes")], [("?x", "blocked", "yes")])
    elif name == "order_sensitive":
        prov = "addmult"
        for i in range(4):
            r.add_tagged_triple(f"n{i}", "next", f"n{i + 1}", 0.9)
            r.add_tagged_triple(f"n{i}", "alt", f"n{i + 1}", 0.4)
        add([("?x", "next", "?y"), ("?y", "next", "?z")], [("?x", "next", "?z")])
        add([("?x", "alt", "?y"), ("?y", "next", "?z")], [("?x", "next", "?z")])
    elif name == "structural":
        prov = "topk"
        r.add_abox_triple("a", "p", "b")
        add([("?x", "p", "?y")], [("?x", "q", "?y")])
    return r, prov


def naf_mesh_step(dev, mesh) -> dict:
    """17b: the NAF programs on the mesh, facts and tags equal to the port's
    host loop (AddMult within ``PROV_ADDMULT_TOL`` a tag), every dispatch
    launching the fused filter on every shard, and the join's program the
    merge path; the refused shapes raise ``Unsupported``."""
    from kolibrie_tpu_torch import Reasoner
    from kolibrie_tpu_torch.parallel import DistProvenanceReasoner
    from kolibrie_tpu_torch.parallel.dist_provenance import Unsupported
    from kolibrie_tpu_torch.reasoner.provenance import make_provenance
    from kolibrie_tpu_torch.reasoner.provenance_seminaive import (
        infer_with_provenance_host,
        seed_tag_store,
    )

    def build(name):
        r, prov = naf_program(name, lambda: Reasoner(device=dev))
        return r, make_provenance(prov, k=3)

    on_card = dev.type == "cuda"
    out = {}
    for name in NAF_PROGRAMS:
        host, prov = build(name)
        hstore = seed_tag_store(host, prov)
        infer_with_provenance_host(host, prov, hstore)
        r, prov = build(name)
        store = seed_tag_store(r, prov)
        dr = DistProvenanceReasoner(mesh, r, prov, store)
        derived, launches, ms = step_launches(dr.infer)
        if r.facts.triples_set() != host.facts.triples_set() or derived == 0:
            raise AssertionError(f"17b {name}: {derived} derived; facts differ from the host loop")
        err = same_tags(dict(hstore.tags), dict(store.tags), prov.name == "addmult")
        floor = {"filter_mask": mesh.size * dr.dispatches}
        if name == "naf_join_minmax":
            floor["merge_path_join"] = mesh.size * dr.dispatches
        need_dispatch_launches(f"17b {name}", launches, floor, on_card)
        out[name] = {"derived": derived, "ms": ms, "dispatches": dr.dispatches,
                     "sequential": dr.naf_sequential, "max_tag_err": err, "launches": launches}
        log(f"17b {name}: {out[name]}")
    for name in NAF_REFUSED:
        r, prov = build(name)
        try:
            DistProvenanceReasoner(mesh, r, prov, seed_tag_store(r, prov))
        except Unsupported:
            continue
        raise AssertionError(f"17b {name}: the mesh reasoner took a program it must refuse")
    log(f"17b: {', '.join(NAF_REFUSED)} raise Unsupported")
    return out


def ml_digit_arrays(n: int, seed: int) -> tuple:
    """12c's digit samples as arrays: the features as ``ml_digit_ntriples``
    writes them (four decimals) and the labels."""
    import numpy as np

    x0, x1, label = ml_digit_draw(n, seed)
    x = np.array([[float(f"{a:.4f}"), float(f"{b:.4f}")] for a, b in zip(x0, x1)],
                 dtype=np.float32)
    return x, label.astype(np.float32)


def two_hop_new(s, p, o, p1: int, p2: int, head: int) -> tuple:
    """numpy: the pairs (x, z) of ``x p1 y . y p2 z`` that are no ``head``
    fact yet, and the count of such 2-hop paths."""
    import numpy as np

    a, b = p == p1, p == p2
    xs, ys = s[a].astype(np.int64), o[a].astype(np.int64)
    order = np.argsort(s[b], kind="stable")
    bs, bo = s[b].astype(np.int64)[order], o[b].astype(np.int64)[order]
    lo = np.searchsorted(bs, ys, "left")
    cnt = np.searchsorted(bs, ys, "right") - lo
    start = np.repeat(lo, cnt) + np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    pairs = np.unique(np.repeat(xs, cnt) << 32 | bo[start])
    h = p == head
    have = np.unique(s[h].astype(np.int64) << 32 | o[h].astype(np.int64))
    return int(np.setdiff1d(pairs, have).size), int(cnt.sum())


# 17c's neurosymbolic rules: the transitive subOrganizationOf rule (LUBM's
# generator gives no 2-hop chain, departments are suborganizations of
# universities only, so it derives nothing) and phase 6's memberOf lift
# along it (640,000 at LUBM-1000), both binary chains of DistRuleSet
NEURO_RULES = (("subOrganizationOf", "subOrganizationOf", "subOrganizationOf"),
               ("memberOf", "subOrganizationOf", "memberOf"))


def train_mesh_step(dev, mesh, lubm) -> dict:
    """17c: ``dp_train_step`` over 12c's digit samples (one equal slice a
    shard) for ``TRAIN_STEPS`` steps, each loss and the last params, Adam
    moments and step count within ``TRAIN_TOL`` of the one-device
    ``_dp_step`` on the whole batch from the same state, the loss falling; then ``neurosymbolic_step`` on phase 16a's partition of
    LUBM-1000 for each of ``NEURO_RULES`` through ``DistRuleSet``, its
    count equal to numpy's new 2-hop pairs.  The fast path's round compares
    predicates inline (as the reference's does), so it launches the merge
    path and no filter."""
    import numpy as np
    import torch

    from benches.lubm import UB
    from kolibrie_tpu_torch.core.rule import Rule
    from kolibrie_tpu_torch.core.terms import Term, TriplePattern
    from kolibrie_tpu_torch.ops import round_cap
    from kolibrie_tpu_torch.parallel import (
        DistRuleSet,
        DistributedReasoner,
        ShardedTripleStore,
        dp_train_step,
        make_train_state,
        neurosymbolic_step,
    )
    from kolibrie_tpu_torch.parallel.train_step import _dp_step

    x, y = ml_digit_arrays(ML_SAMPLES, ML_SEED)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    st = one = make_train_state(torch.Generator().manual_seed(ML_SEED), 2, (16,), device=dev)
    losses, diffs, walls = [], [], []
    for _ in range(TRAIN_STEPS):
        (st, loss), _l, ms = step_launches(lambda: dp_train_step(mesh, st, x, y, lr=TRAIN_LR))
        (one, loss1), _l, ms1 = step_launches(lambda: _dp_step(one, xt, yt, TRAIN_LR))
        losses.append(float(loss))
        diffs.append(abs(float(loss) - float(loss1)))
        walls.append((ms, ms1))
    # Adam's update barely moves under a scaled gradient, so the losses alone
    # would miss a wrong gradient mean: the state must agree too
    state_diff = max(float((a - b).abs().max()) for key in ("params", "m", "v")
                     for pa, pb in zip(st[key], one[key]) for a, b in zip(pa, pb))
    if (max(diffs) > TRAIN_TOL or state_diff > TRAIN_TOL or int(st["t"]) != int(one["t"])
            or not losses[-1] < losses[0]):
        raise AssertionError(f"17c dp_train_step: losses {losses[0]} .. {losses[-1]}, largest "
                             f"difference from the one-device step {max(diffs)}, in the state "
                             f"{state_diff} (step {int(st['t'])} against {int(one['t'])})")
    out = {"dp": {"steps": TRAIN_STEPS, "loss_first": losses[0], "loss_last": losses[-1],
                  "max_loss_diff": max(diffs), "max_state_diff": state_diff,
                  "step_ms": [w[0] for w in walls[1:]],
                  "one_device_ms": [w[1] for w in walls[1:]]}}
    log(f"17c dp_train_step: {out['dp']}")

    s, p, o = lubm.store.columns()
    store, _l, part_ms = step_launches(lambda: ShardedTripleStore.from_columns(mesh, s, p, o))
    out["partition_ms"] = part_ms
    V, C = Term.variable, Term.constant
    for names in NEURO_RULES:
        p1, p2, head = (lubm.dictionary.lookup(UB + k) for k in names)
        hs, hp, ho = store.gather_host()
        want, paths = two_hop_new(hs, hp, ho, p1, p2, head)
        rule = Rule(premise=[TriplePattern(V("x"), C(p1), V("y")),
                             TriplePattern(V("y"), C(p2), V("z"))],
                    conclusion=[TriplePattern(V("x"), C(head), V("z"))])
        # an exchange bucket holds at most every p1 fact (the delta routed
        # to the object owners) or every derivation; a shard's join output
        # at most every path
        cap = round_cap(max(paths, int((hp == p1).sum()), 1))
        dr = DistributedReasoner(mesh, DistRuleSet.from_rules([rule]), fact_cap=store.cap,
                                 delta_cap=store.cap, join_cap=cap, bucket_cap=cap)
        before = store.n_triples
        resident = None
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
        (st, loss, count), launches, ms = step_launches(
            lambda: neurosymbolic_step(mesh, st, x, y, dr, store, lr=TRAIN_LR))
        if count != want or store.n_triples != before + want or not np.isfinite(loss):
            raise AssertionError(f"17c neurosymbolic_step {names}: count {count} (numpy {want}), "
                                 f"{store.n_triples} triples, loss {loss}")
        need_dispatch_launches(f"17c neurosymbolic_step {names}", launches,
                               {"merge_path_join": 2 * mesh.size}, dev.type == "cuda")
        rec = out["neurosymbolic_" + names[0]] = {
            "count": count, "paths": paths, "loss": loss, "ms": ms, "caps": [store.cap, cap],
            "launches": launches, "resident_bytes": resident,
            "peak_bytes": torch.cuda.max_memory_allocated() if dev.type == "cuda" else None}
        log(f"17c neurosymbolic_step {names}: {rec}")
    return out


def run_prov_mesh_phase(dev, main_path: dict, prov: dict) -> dict:
    """Phase 17 (17a-17c) on the mesh of phase 16 (four shards over the
    cards present); its launches counted from just before 17a to just after
    17c, with no call of a kernel's plain version on the card."""
    from kolibrie_tpu_torch.ops import kernels as K
    from kolibrie_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    lubm = next(db for name, db, _q, _w in main_path["queries"] if name == "q2")
    mesh = make_mesh(MESH_SHARDS, devices=mesh_devices(dev, MESH_SHARDS))
    log(f"phase 17: {MESH_SHARDS} shards on {[str(d) for d in mesh.devices]}")
    captured, report = {}, {}
    undo = [recorder_install(captured), mesh_filter_recorder(captured)]
    try:
        with PlainCalls() as plain:
            K.reset_launches()
            report["17a"] = prov_mesh_step(dev, mesh, prov_workload(PROV_FACTS, PROV_SEED),
                                           prov["results"])
            report["17b"] = naf_mesh_step(dev, mesh)
            report["17c"] = train_mesh_step(dev, mesh, lubm)
            total = {k: v for k, v in K.LAUNCHES.items() if v}
            if dev.type == "cuda" and any(plain.counts.values()):
                raise AssertionError(f"phase 17 called plain versions: {plain.counts}")
    finally:
        for u in undo:
            u()
    need_dispatch_launches("phase 17", total, {k: 1 for k in MESH_KERNELS}, dev.type == "cuda")
    report["seconds"] = time.perf_counter() - t0
    log(f"phase 17 launches: {total}; {report['seconds']:.1f} s")
    return {"report": report, "launches": total, "captured": captured}


# ------------------------------------------------- phase 18: the project linter


def run_lint_phase(repo: str) -> dict:
    """Phase 18: the port's linter over ``kolibrie_tpu_torch/`` in a child
    process, as a user runs it; its exit code decides."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "kolibrie_tpu_torch.analysis", "--json", "--max-seconds", "60"],
        cwd=repo, capture_output=True, text=True, timeout=120,
    )
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(
            f"phase 18: kolint exited {out.returncode}\n{out.stdout[-4000:]}{out.stderr[-2000:]}"
        )
    report = json.loads(out.stdout)
    log(f"phase 18: kolint {len(report['findings'])} finding(s), {report['suppressed']} "
        f"suppressed, {report['baselined']} baselined; kolint_runtime_s={report['runtime_s']}; "
        f"{wall:.1f} s with the child's start")
    return report


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
    prov: dict, cw: dict, load: dict, ml: dict, repeated: dict, resilience: dict, serving: dict,
    mesh: dict, prov_mesh: dict, parent=None,
):
    """Phase 5: each kernel against its plain version on the largest inputs
    its path gave it, with both timed and the bytes bound.  Launches are
    each path's own count: phases 4 and 4b (the SELECT path) for the SELECT
    kernels, the closure's warm run (phase 6) for the fused filter and the
    closure's merge path, phase 6c for the ops entries, phase 7's device run
    for the RSP path's merge path and filter, phase 10's card runs for the
    cross-window and incremental closures' merge path and filter, phase
    11's queries after the load for the lex probes, phase 12's card
    statements for the ML path's merge path and filter, phase 13's
    repeated-query runs (13a-13e) for the merge path and the lex probes,
    phase 14 (14a-14d) for the merge path, the lex probes and the RULE's
    fused filter, phase 15 (15a-15e, the requests the servers answered)
    for the merge path and the lex probes, phase 16 (16a-16d, the mesh
    path) and phase 17 (17a-17c, the mesh's tagged closures and training
    steps) for the merge path and the fused filter.  The merge path's and the
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
    # phase 9: its warm runs' launches, at the largest calls of its card runs
    pc, l9 = prov["captured"], prov["launches"]
    line.append(timed_row("merge_path_join[provenance]", csrc + "merge_join.cu", pk + "181",
                          l9.get("merge_path_join", 0), pc["merge_path_join"][1], K.merge_path,
                          K.merge_path_plain, merge_path_bytes, check_merge_path))
    fargs = pc["filter_mask"][1]
    line.append(timed_row("filter_mask[provenance]", csrc + "filter_mask.cu", pk + "887",
                          l9.get("filter_mask", 0), fargs, filt, filt_plain, filter_bytes,
                          check_filter, filter_library(fargs)))
    # phase 10: its card runs' launches, at the largest calls of its closures
    cc, l10 = cw["captured"], cw["launches"]
    line.append(timed_row("merge_path_join[cross_window]", csrc + "merge_join.cu", pk + "181",
                          l10.get("merge_path_join", 0), cc["merge_path_join"][1], K.merge_path,
                          K.merge_path_plain, merge_path_bytes, check_merge_path))
    fargs = cc["filter_mask"][1]
    line.append(timed_row("filter_mask[cross_window]", csrc + "filter_mask.cu", pk + "887",
                          l10.get("filter_mask", 0), fargs, filt, filt_plain, filter_bytes,
                          check_filter, filter_library(fargs)))
    # phase 11: its queries' launches, at their largest calls
    lc, l11 = load["captured"], load["launches"]
    for name, src, body, fn, plain, nbytes, check in (
            ("lex_probe_select", "lex_probe.cu", "743", K.lex_probe_select,
             K.lex_probe_select_plain, select_bytes, check_select),
            ("lex_probe_validate", "lex_probe.cu", "783", K.lex_probe_validate,
             K.lex_probe_validate_plain, validate_bytes, check_validate),
            ("merge_path_join", "merge_join.cu", "181", K.merge_path, K.merge_path_plain,
             merge_path_bytes, check_merge_path)):
        if name in lc:
            line.append(timed_row(f"{name}[load]", csrc + src, pk + body, l11.get(name, 0),
                                  lc[name][1], fn, plain, nbytes, check))
    # phase 12: its card statements' launches, at their largest calls
    mc, l12 = ml["captured"], ml["launches"]
    line.append(timed_row("merge_path_join[ml]", csrc + "merge_join.cu", pk + "181",
                          l12.get("merge_path_join", 0), mc["merge_path_join"][1], K.merge_path,
                          K.merge_path_plain, merge_path_bytes, check_merge_path))
    if "filter_mask" in mc:
        fargs = mc["filter_mask"][1]
        line.append(timed_row("filter_mask[ml]", csrc + "filter_mask.cu", pk + "887",
                              l12.get("filter_mask", 0), fargs, filt, filt_plain, filter_bytes,
                              check_filter, filter_library(fargs)))
    # phase 13: its launches (13a-13e), at its largest calls
    rc, l13 = repeated["captured"], repeated["launches"]
    for name, src, body, fn, plain, nbytes, check in (
            ("merge_path_join", "merge_join.cu", "181", K.merge_path, K.merge_path_plain,
             merge_path_bytes, check_merge_path),
            ("lex_probe_select", "lex_probe.cu", "743", K.lex_probe_select,
             K.lex_probe_select_plain, select_bytes, check_select),
            ("lex_probe_validate", "lex_probe.cu", "783", K.lex_probe_validate,
             K.lex_probe_validate_plain, validate_bytes, check_validate)):
        line.append(timed_row(f"{name}[repeated]", csrc + src, pk + body, l13.get(name, 0),
                              rc[name][1], fn, plain, nbytes, check))
    # phase 14: its launches (14a-14d), at its largest calls
    zc, l14 = resilience["captured"], resilience["launches"]
    for name, src, body, fn, plain, nbytes, check in (
            ("merge_path_join", "merge_join.cu", "181", K.merge_path, K.merge_path_plain,
             merge_path_bytes, check_merge_path),
            ("lex_probe_select", "lex_probe.cu", "743", K.lex_probe_select,
             K.lex_probe_select_plain, select_bytes, check_select),
            ("lex_probe_validate", "lex_probe.cu", "783", K.lex_probe_validate,
             K.lex_probe_validate_plain, validate_bytes, check_validate)):
        line.append(timed_row(f"{name}[resilience]", csrc + src, pk + body, l14.get(name, 0),
                              zc[name][1], fn, plain, nbytes, check))
    fargs = zc["filter_mask"][1]
    line.append(timed_row("filter_mask[resilience]", csrc + "filter_mask.cu", pk + "887",
                          l14.get("filter_mask", 0), fargs, filt, filt_plain, filter_bytes,
                          check_filter, filter_library(fargs)))
    # phase 15: its launches (15a-15e), at the largest calls its servers made
    vc, l15 = serving["captured"], serving["launches"]
    for name, src, body, fn, plain, nbytes, check in (
            ("merge_path_join", "merge_join.cu", "181", K.merge_path, K.merge_path_plain,
             merge_path_bytes, check_merge_path),
            ("lex_probe_select", "lex_probe.cu", "743", K.lex_probe_select,
             K.lex_probe_select_plain, select_bytes, check_select),
            ("lex_probe_validate", "lex_probe.cu", "783", K.lex_probe_validate,
             K.lex_probe_validate_plain, validate_bytes, check_validate)):
        line.append(timed_row(f"{name}[serving]", csrc + src, pk + body, l15.get(name, 0),
                              vc[name][1], fn, plain, nbytes, check))
    # phase 16: its launches (16a-16d), at the largest calls of its mesh path
    hc, l16 = mesh["captured"], mesh["launches"]
    line.append(timed_row("merge_path_join[mesh]", csrc + "merge_join.cu", pk + "181",
                          l16.get("merge_path_join", 0), hc["merge_path_join"][1], K.merge_path,
                          K.merge_path_plain, merge_path_bytes, check_merge_path))
    fargs = hc["filter_mask"][1]
    line.append(timed_row("filter_mask[mesh]", csrc + "filter_mask.cu", pk + "887",
                          l16.get("filter_mask", 0), fargs, filt, filt_plain, filter_bytes,
                          check_filter, filter_library(fargs)))
    # phase 17: its launches (17a-17c), at the largest calls of its mesh path
    pc17, l17 = prov_mesh["captured"], prov_mesh["launches"]
    line.append(timed_row("merge_path_join[prov-mesh]", csrc + "merge_join.cu", pk + "181",
                          l17.get("merge_path_join", 0), pc17["merge_path_join"][1],
                          K.merge_path, K.merge_path_plain, merge_path_bytes, check_merge_path))
    fargs = pc17["filter_mask"][1]
    line.append(timed_row("filter_mask[prov-mesh]", csrc + "filter_mask.cu", pk + "887",
                          l17.get("filter_mask", 0), fargs, filt, filt_plain, filter_bytes,
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
    counters = breaker_counters()  # phase 14 reads them again
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

    # ---- 9. tagged (provenance) reasoning
    prov = run_prov_phase(dev, lubm, UNIVERSITIES)

    # ---- 10. cross-window SDS+ and the incremental R2R
    cw = run_cw_phase(dev, rsp)

    # ---- 11. bulk load, checkpoints and the database surface
    emp = next(db for name, db, _q, _w in queries if name == "employee")
    load = run_load_phase(dev, main_path, lubm, emp)

    # ---- 12. the neurosymbolic ML layer
    ml = run_ml_phase(dev, lubm)

    # ---- 13. the repeated-query layer
    repeated = run_repeated_phase(dev, main_path, lubm, emp)

    # ---- 14. resilience and durability
    resilience = run_resilience_phase(dev, main_path, counters)

    # ---- 15. serving: the HTTP server, the router and a follower
    serving = run_serving_phase(dev, main_path)

    # ---- 16. the multi-device layer: four shards over the cards present
    mesh = run_mesh_phase(dev, main_path, closure)

    # ---- 17. distributed provenance and the training steps on the mesh
    prov_mesh = run_prov_mesh_phase(dev, main_path, prov)
    del prov["results"]

    # ---- 18. the project linter over the package as shipped
    run_lint_phase(repo)

    # ---- 5. kernels at the paths' shapes
    kernels = kernels_at_main_path_shapes(
        main_path, surface, closure, entries, rsp, statements, prov, cw, load, ml, repeated,
        resilience, serving, mesh, prov_mesh, parent,
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
