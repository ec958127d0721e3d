"""Run one cell of the benchmark of ``kolibrie_tpu_torch`` on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in ``BENCHMARK.json`` names its configuration and its
traffic file; the traffic file's ``loop`` names the loop,
``loops/<loop>.py``, which reads its parameters from the file.  The run
generates the data from ``--seed``, loads it into the program on the
card, warms the cell's own shapes, measures for ``--seconds``, then
judges what the timed path produced against the plain reference (the
loop's ``judge``).  The last line of standard output is the result: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read by ``metrics/<name>.py`` from the traced window.
Without a card the run fails and prints no result."""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
if str(HERE) in sys.path:
    sys.path.remove(str(HERE))
sys.path.insert(0, str(HERE.parent))

#: top-level module names the process may not hold once the window has
#: closed: JAX, the JAX package the port was made from, and that package's
#: benchmark scripts (``bench.py``, ``benches/``)
FORBIDDEN = ("jax", "jaxlib", "flax", "kolibrie_tpu", "bench", "benches")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def listed(entries: list, cell: str, reported: set) -> list:
    """The metrics of ``entries`` this cell reports: those that list it,
    and those without a list whose end-to-end metric it reports."""
    out = []
    for m in entries:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif m.get("moves") is None or m["moves"] in reported:
            out.append(m)
    return out


def read_metric(name: str, ctx: dict):
    path = HERE / "metrics" / f"{name}.py"
    loader = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(mod)
    return mod.read(ctx)


def device_share(spans: list) -> str:
    ex = [s for s in spans if s["name"] == "query.execute"]
    if not ex:
        return "no query.execute span"
    dev = sum(1 for s in ex if (s.get("attrs") or {}).get("path") == "device")
    return f"{dev} of {len(ex)} query.execute spans took path=device"


def run(c: dict, seed: int, seconds: float, traced: bool, dev, t0: float) -> dict:
    """One run of the cell ``c`` (``spec.cell``) on ``dev``: the result
    line's object.  ``t0`` is the process's start on the host clock."""
    import torch

    from portbench import check, spec
    from portbench.harness import log

    name = c["workload"]["name"]
    bench = c["bench"]
    loop = spec.loop(c["traffic"]["loop"])
    out = loop.run(c, seed, seconds, traced, dev)
    setup_s = out["ready"] - t0
    on_card = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    probe = out["probe"]
    from kolibrie_tpu_torch.obs import spans as _spans

    log(device_share(probe.spans if traced else _spans.spans_snapshot())
        + (" (the window's spans)" if traced else " (the last spans the ring holds)"))
    out.pop("db", None)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    e2e = listed(bench["end_to_end"], name, set())
    reported = {m["name"] for m in e2e}
    result_metrics = {}
    device = {
        "platform": "gpu" if on_card else dev.type,
        "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "count": int(c["workload"]["chips"]),
        "memory_peak_bytes": int(peak),
    }
    breakdown = None
    if not traced:
        values = dict(out["e2e"], setup_s=setup_s)
        for m in e2e:
            if m["name"] not in values:
                raise KeyError(f"the loop measured no {m['name']}")
            result_metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        timeline = probe.timeline.reduce(probe.spans) if on_card else None
        ctx = {
            "load_s": out["load_s"],
            "spans": probe.spans,
            "requests": out["requests"],
            "kernels": probe.kernels.totals() if on_card else None,
            "timeline": timeline,
            "peaks": json.loads((HERE / "peaks.json").read_text()),
            **out["readings"],
        }
        for m in listed(bench["per_layer"], name, reported):
            v = read_metric(m["name"], ctx)
            if v is not None:
                result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if timeline is not None:
            device["busy_s"] = timeline["busy_s"]
            device["window_s"] = timeline["window_s"]
            breakdown = {"device_ops": timeline["device_ops"], "idle_gaps": timeline["idle_gaps"]}
            log(f"trace: {timeline['ops']} device ops, kernels {ctx['kernels']}, "
                        f"kernel seconds {timeline['kernel_s']}")
    t = time.perf_counter()
    checks = loop.judge(c, out, check.Reference(c["config"], out["graph"]))
    log(f"reference: {time.perf_counter() - t:.1f} s")
    result = {
        "correct": check.correct(checks),
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": result_metrics,
        "device": device,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import spec

    c = spec.cell(args.workload)
    chips = int(c["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run(c, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), _T0)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {', '.join(found)}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
