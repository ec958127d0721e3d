"""Traffic of materialisation jobs, one at a time (a closed loop).

Each job seeds a fresh ``Reasoner`` with the base facts (outside the
window) and runs ``infer_new_facts_semi_naive_parallel`` to the fixpoint,
writing back; the window is the sum of the jobs' walls, each ending in
``torch.cuda.synchronize()``, and every job that starts in it counts.
``materialize_s`` is that sum over the jobs.

``correct`` compares each job's whole fact set after write-back with the
reference's fixpoint over the same columns and rule file
(``facts_mismatched``: facts in one and not the other, the worst job).
The control is the reference fixpoint stopped after one round."""

from __future__ import annotations

import gc
import time
from typing import Dict

from portbench import spec
from portbench.check import Reference, verdict
from portbench.harness import FixpointRounds, Probe, add_rules, graph, log, sync

LIMITS = {"facts_mismatched": 0}
CONTROL = "the reference fixpoint stopped after one round (an incomplete closure)"


def run(c: dict, seed: int, seconds: float, traced: bool, dev) -> dict:
    from kolibrie_tpu_torch import Reasoner

    config = c["config"]
    rules = spec.rules(config)
    g = graph(config, seed)
    t = time.perf_counter()
    first = Reasoner.from_arrays(g.terms, g.s, g.p, g.o, device=dev)
    add_rules(first, rules)
    len(first.facts)
    sync(dev)
    load_s = time.perf_counter() - t
    log(f"reasoner seeded with {len(first.facts)} facts in {load_s:.2f} s")
    dictionary = first.dictionary

    def seed_job():
        r = Reasoner(dictionary, device=dev)
        r.facts.add_batch(g.s, g.p, g.o)
        add_rules(r, rules)
        len(r.facts)  # compaction on the host, before the clock
        return r

    def job(r):
        sync(dev)
        t0 = time.perf_counter()
        derived = r.infer_new_facts_semi_naive_parallel()
        sync(dev)
        return time.perf_counter() - t0, derived

    with FixpointRounds() as fr:
        warm_s, warm_derived = job(first)
        if not fr.rounds:
            raise RuntimeError("the closure did not take the device fixpoint")
        log(f"warm-up job: {warm_derived} derived, {warm_s:.2f} s, {fr.rounds[-1]} rounds")
        del first
        gc.collect()
        ready = time.perf_counter()
        fr.rounds.clear()
        jobs = []
        spent = 0.0
        with Probe(traced, dev) as probe:
            while not jobs or spent < seconds:
                r = seed_job()
                with probe.work():
                    wall, derived = job(r)
                spent += wall
                jobs.append({"wall_s": wall, "derived": derived, "facts": r.facts.columns()})
                del r
        rounds = list(fr.rounds)
    log("jobs: " + ", ".join(f"{j['wall_s']:.3f} s ({j['derived']} derived)" for j in jobs))
    return {
        "graph": g,
        "ready": ready,
        "load_s": load_s,
        "attempted": len(jobs),
        "failed": 0,
        "e2e": {"materialize_s": spent / len(jobs)},
        "jobs": jobs,
        "probe": probe,
        "requests": len(jobs),
        "readings": {"rounds": rounds},
    }


def judge(c: dict, out: dict, ref: Reference) -> Dict[str, dict]:
    worst = max(ref.fact_mismatch(j["facts"]) for j in out["jobs"])
    return verdict({"facts_mismatched": worst}, LIMITS)


def control(c: dict, out: dict) -> dict:
    """``out`` with the control's closure in place of every job's."""
    weak = Reference(c["config"], out["graph"], rounds=1)
    facts = weak.codec.decode(weak.keys)
    return dict(out, jobs=[dict(j, facts=facts) for j in out["jobs"]])
