"""A small-size rehearsal of ``chip_smoke.py`` phase 9 on the CPU: the
tagged closures of 9a at 4,000 facts, ``RULE … PROB`` of 9b at LUBM-2
against its CPU twin, and 9c's small programs, through the smoke's own
functions and checks.  On the CPU the reasoner's entries take the host
loop (the device route is taken on the CUDA card only), so the rehearsal
sends the card runs' closures to ``infer_provenance_device`` on torch's
CPU; the launch floors count the kernel wrappers' calls."""

from __future__ import annotations

import torch

import chip_smoke as CS
from benches.lubm import generate_fast
from kolibrie_tpu_torch import Reasoner, SparqlDatabase
from kolibrie_tpu_torch.reasoner import device_provenance as DP
from kolibrie_tpu_torch.reasoner import provenance_seminaive as PS
from kolibrie_tpu_torch.reasoner import rule_runtime as RR
from torch_threads import one_torch_thread  # noqa: F401  (an autouse fixture)

CPU = torch.device("cpu")


def _on_device(kg, prov, store=None):
    store = store if store is not None else PS.seed_tag_store(kg, prov)
    assert DP.infer_provenance_device(kg, prov, store) is not None
    return store


def test_chip_smoke_phase9_rehearsal(monkeypatch):
    monkeypatch.setattr(Reasoner, "infer_new_facts_with_provenance", _on_device)
    closures = CS.run_prov_closures(CPU, CS.prov_workload(4000, CS.PROV_SEED), {})
    for name in CS.PROV_SEMIRINGS:
        warm = closures[name]["warm"]
        assert warm["route"] == [True] and warm["derived"] > 2000 and warm["rounds"] == 2

    lubm = SparqlDatabase(device=CPU)
    lubm.store.add_batch(*generate_fast(2, lubm.dictionary))
    seeds = CS.prov_seeds(lubm, CS.PROV_SEED)
    with monkeypatch.context() as m:
        m.setattr(RR, "infer_with_provenance", _on_device)
        card = CS.run_prob_rules(CPU, lubm, seeds, {})
    twin = CS.run_prob_rules(CPU, lubm, seeds, {}, twin=True)
    CS.check_prob_rules(card, twin, 2, len(seeds))
    assert CS.run_prov_small(CPU)["naf_addmult"] > 0
