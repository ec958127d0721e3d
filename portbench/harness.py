"""What every loop shares: the log, the probe a traced run wraps around
its window, the generated graph, the program's rules, and the count of
device fixpoint rounds."""

from __future__ import annotations

import contextlib
import sys
import time
from typing import List

from portbench import lubm_gen, spec


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


class Probe:
    """What a traced run wraps around its window; a no-op otherwise."""

    def __init__(self, traced: bool, dev):
        self.traced = traced
        self.on_card = dev.type == "cuda"
        self.timeline = None
        self.kernels = None
        self.spans: List[dict] = []

    def __enter__(self):
        if self.traced:
            from kolibrie_tpu_torch.obs import spans

            from portbench.trace import KernelBytes, Timeline

            # every span of the window, not the ring's default 4,096
            spans.set_ring_capacity(1 << 22)
            spans.clear()
            if self.on_card:
                self.kernels = KernelBytes().__enter__()
                self.timeline = Timeline().__enter__()
        return self

    def work(self):
        """Marks one stretch of timed work inside the window (a traced run
        on the card reads the device's idle share over these alone)."""
        return self.timeline.work() if self.timeline is not None else contextlib.nullcontext()

    def __exit__(self, *exc):
        if self.traced:
            from kolibrie_tpu_torch.obs import spans

            if self.on_card:
                self.timeline.__exit__(*exc)
                self.kernels.__exit__(*exc)
            self.spans = spans.spans_snapshot()
        return False


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def graph(config: dict, seed: int, queries=()) -> lubm_gen.Graph:
    t = time.perf_counter()
    g = lubm_gen.generate(config, seed, extra_terms=spec.constants(config, queries))
    log(f"generated LUBM({config['universities']}): {len(g)} triples, "
        f"{len(g.terms) - 1} terms, {time.perf_counter() - t:.1f} s")
    return g


def add_rules(r, rules: List[dict]) -> None:
    for ru in rules:
        r.add_rule(r.rule_from_strings([tuple(t) for t in ru["if"]], [tuple(ru["then"])]))


class FixpointRounds:
    """Records ``DeviceFixpoint.last_rounds`` of each device closure (the
    way ``chip_smoke.run_closure`` reads it), so a run can say that the
    closure took the device fixpoint and how many rounds it ran."""

    def __init__(self):
        self.rounds: List[int] = []

    def __enter__(self):
        from kolibrie_tpu_torch.reasoner import device_fixpoint as FX

        self._orig = FX.DeviceFixpoint.infer
        orig, rounds = self._orig, self.rounds

        def infer(fx, *a, **k):
            out = orig(fx, *a, **k)
            rounds.append(fx.last_rounds)
            return out

        FX.DeviceFixpoint.infer = infer
        return self

    def __exit__(self, *exc):
        from kolibrie_tpu_torch.reasoner import device_fixpoint as FX

        FX.DeviceFixpoint.infer = self._orig
        return False
