"""Every cell's control flow on the CPU at a small size: set-up, warm-up,
the window, the reference's verdict; the control of each cell comes out
not correct; and without a card the harness reports nothing."""

import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT, tiny_cell
from portbench import check, run, spec

#: the size each cell runs at here, and its window: every store reaches
#: the device program's routing floor (100,000 triples; 50,000 facts for
#: the closure), and every window sends each query of its mix
SIZES = {"lubm100-rdfs.materialize": (1, 0.0), "lubm100.analytic": (2, 4.0)}
SEED = 2**31 + 17


@pytest.fixture(scope="module", params=sorted(SIZES))
def ran(request):
    name = request.param
    universities, seconds = SIZES[name]
    c = tiny_cell(name, universities)
    loop = spec.loop(c["traffic"]["loop"])
    out = loop.run(c, SEED, seconds, False, torch.device("cpu"))
    out.pop("db", None)
    return c, loop, out


def test_benchmark_names_every_file():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        c = spec.cell(w["name"])
        loop = spec.loop(c["traffic"]["loop"])
        assert callable(loop.run) and callable(loop.judge) and callable(loop.control)
        assert loop.CONTROL and loop.LIMITS
        for q in c["traffic"].get("queries", ()):
            spec.query_text(q)
    for m in bench["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists(), m["name"]


def _judge(c, loop, out):
    return loop.judge(c, out, check.Reference(c["config"], out["graph"]))


def test_a_cell_is_correct_and_reports_its_metrics(ran):
    c, loop, out = ran
    checks = _judge(c, loop, out)
    assert check.correct(checks), checks
    assert out["attempted"] >= 1 and out["failed"] == 0
    for name, value in out["e2e"].items():
        assert value > 0, name


def test_the_control_is_not_correct(ran):
    c, loop, out = ran
    checks = _judge(c, loop, loop.control(c, out))
    assert not check.correct(checks), checks


def test_a_traced_run_reads_its_spans_on_the_cpu():
    c = tiny_cell("lubm100.analytic", 2)
    result = run.run(c, 5, 0.5, True, torch.device("cpu"), time.perf_counter())
    assert result["correct"] and list(result)[-1] == "checks"
    assert {"load_s", "engine_ms.analytic"} <= set(result["metrics"])
    # device metrics come from the card alone
    assert not {"kernel_roofline_pct.analytic", "device_idle_pct.analytic"} & set(result["metrics"])


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "lubm100.analytic",
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
