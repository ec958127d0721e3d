"""End-to-end smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

(on a machine with one CUDA card; ``chip_profile.py`` breaks the same
queries down by phase and device operator).

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. card   — the card's name and power limit (``nvidia-smi``); no CUDA card
            is a failure.
2. build  — compile every kernel source with nvcc for sm_90a.
3. kernels (random shapes) — each CUDA kernel against its plain PyTorch
            version on the same CUDA inputs, bit-exact: keys >= 2^31,
            sentinel rows, skewed fan-out, overflowing capacities.
4. main path — LUBM (``benches/lubm.py::generate_fast``, 1000 universities
            = 3,785,000 triples) and the employee-100K dataset (as
            ``bench.py`` builds it) through ``SparqlDatabase`` +
            ``execute_query_volcano`` on the card: employee join, LUBM Q2,
            Q9, and Q9 again under ``KOLIBRIE_WCOJ=off``.  Row counts are
            asserted and rows must equal the port's own run on the CPU.
            Launch counters are zeroed just before and read just after;
            each query's warm run must launch the kernels of its route.
5. kernels (main-path shapes) — each kernel against its plain version on
            the largest inputs the main path gave it, both timed on the
            device, and the bound: the bytes the function needs at 3.35 TB/s.

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

EMPLOYEE_QUERY = """PREFIX ds: <https://data.example/ontology#>
PREFIX foaf: <http://xmlns.com/foaf/0.1/>
SELECT ?employee ?workplaceHomepage ?salary WHERE {
    ?employee foaf:workplaceHomepage ?workplaceHomepage .
    ?employee ds:annual_salary ?salary
}"""


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
    spin is lengthened until it outlasts the queueing.  Enqueue time: host
    wall per call of ``reps`` calls ending in one synchronisation."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    enqueue_ms = (time.perf_counter() - t) * 1e3 / reps
    cycles = 10_000_000
    for _try in range(4):
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


# ----------------------------------------------------- kernel comparisons


def merge_path_args_random(seed: int, dev):
    """Prepass outputs of one random merge join: keys with bit 31 set,
    Zipf-skewed fan-out, left sentinel holes, prefix-valid right side."""
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
    lidx_c, low_c, cum, total = K._join_prepass(lk, rk)
    total_h = int(total)
    # once exactly at the match count, once overflowing (half the matches)
    caps = [K._round_out(total_h), K._round_out(max(total_h // 2, 1))]
    return [(lidx_c, low_c, cum, total, n_l, n_r, cap) for cap in caps]


def check_merge_path(args) -> int:
    from kolibrie_tpu_torch.ops import kernels as K

    got = K.merge_path(*args)
    want = K.merge_path_plain(*args)
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"merge_path_join differs from its plain version by {err}")
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


def check_random_shapes(dev) -> None:
    for seed in range(3):
        for a in merge_path_args_random(seed, dev):
            check_merge_path(a)
    for a_count in (1, 2, 3):
        for p in (1, 1000, 300_001):
            sel_args, val_args = probe_args_random(10 * a_count + p % 7, a_count, p, dev)
            check_select(sel_args)
            check_validate(val_args)


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
    orig = (K.merge_path, DE.lex_probe_select, DE.lex_probe_validate)
    K.merge_path = recorder("merge_path_join", orig[0], lambda a: a[6])
    DE.lex_probe_select = recorder("lex_probe_select", orig[1], lambda a: a[0].shape[0])
    DE.lex_probe_validate = recorder("lex_probe_validate", orig[2], lambda a: a[0].shape[0])
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
        K.merge_path, DE.lex_probe_select, DE.lex_probe_validate = orig
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
    for k, n in {**report["launches"], **report["entry_launches"]}.items():
        if n <= 0:
            raise AssertionError(f"{k} never reached its kernel on the main path")


def compare_with_cpu(main_path: dict) -> None:
    """Run the same queries through the port on the CPU (the kernels'
    plain versions) and require identical rows."""
    from kolibrie_tpu_torch import SparqlDatabase, execute_query_volcano

    t0 = time.perf_counter()
    cpu_dbs = {}
    for name, db, q, wcoj in main_path["queries"]:
        if id(db) not in cpu_dbs:
            cpu_dbs[id(db)] = SparqlDatabase.from_arrays(
                db.dictionary.id_to_str, *db.store.columns(), device="cpu"
            )
        os.environ["KOLIBRIE_WCOJ"] = wcoj
        try:
            cpu = execute_query_volcano(q, cpu_dbs[id(db)])
        finally:
            os.environ.pop("KOLIBRIE_WCOJ", None)
        if cpu != main_path["rows"][name]:
            raise AssertionError(f"{name}: card rows differ from the CPU run")
    log(f"main path: rows equal the CPU run ({time.perf_counter() - t0:.1f} s)")


def kernels_at_main_path_shapes(captured: dict, launches: dict):
    """Each kernel against its plain version on the largest inputs the main
    path gave it, with both timed and the bytes bound."""
    from kolibrie_tpu_torch.ops import kernels as K

    specs = [
        ("merge_path_join", "kolibrie_tpu_torch/csrc/merge_join.cu",
         "kolibrie_tpu/ops/pallas_kernels.py:181", K.merge_path, K.merge_path_plain,
         merge_path_bytes, check_merge_path),
        ("lex_probe_select", "kolibrie_tpu_torch/csrc/lex_probe.cu",
         "kolibrie_tpu/ops/pallas_kernels.py:743", K.lex_probe_select,
         K.lex_probe_select_plain, select_bytes, check_select),
        ("lex_probe_validate", "kolibrie_tpu_torch/csrc/lex_probe.cu",
         "kolibrie_tpu/ops/pallas_kernels.py:783", K.lex_probe_validate,
         K.lex_probe_validate_plain, validate_bytes, check_validate),
    ]
    line = []
    log("kernels at LUBM-1000 Q9 shapes, tolerance 0 (bit-exact):")
    for name, src, replaces, fn, plain, nbytes, check in specs:
        size, a = captured[name]
        err = check(a)
        ms, enqueue_ms = time_ms(lambda: fn(*a))
        plain_ms, plain_enqueue_ms = time_ms(lambda: plain(*a))
        b = nbytes(a)
        entry = {
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": b / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": None,
        }
        line.append(entry)
        log(f"{name}: {size} slots, {b} bytes, device {ms:.4f} ms (plain "
            f"{plain_ms:.4f} ms, bound {entry['bound_ms']:.4f} ms); host enqueue "
            f"per call {enqueue_ms:.4f} ms (plain {plain_enqueue_ms:.4f} ms)")
    return line


# ------------------------------------------------------------------ main


def main() -> int:
    import torch

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
        for line in text.splitlines():
            if ("registers" in line or "smem" in line or "stack" in line
                    or "error" in line.lower()):
                log(f"  {name}: {line.strip()}")

    # ---- 3. kernels at random shapes
    check_random_shapes(dev)
    torch.cuda.synchronize()
    log("kernels: bit-exact against the plain versions at random shapes")

    # ---- 4. main path
    main_path = run_main_path(dev, build_queries(dev))
    check_main_path(main_path["report"])
    compare_with_cpu(main_path)

    # ---- 5. kernels at main-path shapes
    kernels = kernels_at_main_path_shapes(
        main_path["captured"], main_path["report"]["launches"]
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
