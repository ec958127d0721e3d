"""The timed path broken underneath, the rest of a run driven as usual:
each fault a cell can have comes out not correct.  (The look for a card is
skipped: the cells run on CPU tensors at a small size.)"""

import pytest
import torch

from conftest import tiny_cell
from portbench import check, spec

SEED = 2**31 + 29


def _verdict(name: str, universities: int) -> dict:
    c = tiny_cell(name, universities)
    loop = spec.loop(c["traffic"]["loop"])
    out = loop.run(c, SEED, 0.0, False, torch.device("cpu"))
    out.pop("db", None)
    return loop.judge(c, out, check.Reference(c["config"], out["graph"]))


# ------------------------------------------------------------ materialize


def _unchanged(self):
    return 0  # nothing written back: the reasoner's state as it was


def _half(self):
    fs, fp, fo, n_facts, n0 = self._last_state
    self._last_state = (fs, fp, fo, n0 + (n_facts - n0) // 2, n0)
    return _ORIG_WRITE_BACK(self)


def _altered(self):
    fs, fp, fo, n_facts, n0 = self._last_state
    fo = fo.clone()
    fo[n0] = fo[n0] + 1
    self._last_state = (fs, fp, fo, n_facts, n0)
    return _ORIG_WRITE_BACK(self)


from kolibrie_tpu_torch.reasoner import device_fixpoint as FX  # noqa: E402

_ORIG_WRITE_BACK = FX.DeviceFixpoint.materialize_to_host


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["state_unchanged", "half_left_out", "fact_altered"])
def test_materialize_faults(monkeypatch, fault):
    monkeypatch.setattr(FX.DeviceFixpoint, "materialize_to_host", fault)
    checks = _verdict("lubm100-rdfs.materialize", 1)
    assert not check.correct(checks), checks


# --------------------------------------------------------------- queries


def _rows_fault(kind):
    from kolibrie_tpu_torch.query import executor as EX

    orig = EX.format_results

    def broken(*a, **k):
        rows = orig(*a, **k)
        if kind == "nothing":
            return []
        if kind == "half":
            return rows[: len(rows) // 2]
        if rows:
            rows = [list(r) for r in rows]
            rows[0][0] = rows[0][0] + "x"
        return rows

    return EX, broken


@pytest.mark.parametrize("kind", ["nothing", "half", "altered"])
def test_analytic_faults(monkeypatch, kind):
    EX, broken = _rows_fault(kind)
    monkeypatch.setattr(EX, "format_results", broken)
    checks = _verdict("lubm100.analytic", 2)
    assert not check.correct(checks), checks
