"""The readings ``correct``'s limits are set from, on the card at a cell's
own size: for each seed, the program's numbers (the timed path against
the reference) and the control's (a weakened reference in the program's
place, the loop's ``control``), one JSON line each.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 5

The benchmark's own runs never run it.  Every seed runs the cell's whole
set-up and a window of ``--seconds`` in this one process."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE) in sys.path:
    sys.path.remove(str(HERE))
sys.path.insert(0, str(HERE.parent))


def readings(c: dict, seed: int, seconds: float, dev) -> dict:
    """One seed: the program's compared numbers and the control's."""
    from portbench import check, spec

    loop = spec.loop(c["traffic"]["loop"])
    out = loop.run(c, seed, seconds, False, dev)
    out.pop("db", None)
    gc.collect()
    t = time.perf_counter()
    ref = check.Reference(c["config"], out["graph"])
    program = loop.judge(c, out, ref)
    control = loop.judge(c, loop.control(c, out), ref)
    return {
        "workload": c["workload"]["name"], "seed": seed, "attempted": out["attempted"],
        "program": {k: v["value"] for k, v in program.items()},
        "control": {k: v["value"] for k, v in control.items()},
        "control_is": loop.CONTROL,
        "judge_s": time.perf_counter() - t,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)

    import torch

    from portbench import spec

    if not torch.cuda.is_available():
        print("portbench control: needs a CUDA card", file=sys.stderr)
        return 2
    c = spec.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(c, seed, args.seconds, torch.device("cuda", 0))), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
