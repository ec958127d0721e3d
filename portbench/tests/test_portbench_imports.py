"""The import guard: nothing the harness or the reference runs imports JAX,
the JAX package or the JAX package's benchmarks, and the reference imports
nothing of the port.  Names are compared by their whole top-level part:
``kolibrie_tpu_torch`` begins with ``kolibrie_tpu`` and is allowed."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "kolibrie_tpu", "bench", "benches"}


def _sources(sub=""):
    return [p for p in (PB / sub).rglob("*.py") if "tests" not in p.parts]


def _top_levels(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(PB)))
def test_no_source_names_a_forbidden_module(path):
    assert not _top_levels(path) & FORBIDDEN


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: p.name)
def test_reference_names_nothing_of_the_port(path):
    names = _top_levels(path)
    assert "kolibrie_tpu_torch" not in names and "torch" not in names


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_what_a_run_loads():
    """Every module a run imports: the harness, its metric readers, and
    the program's entries it drives."""
    readers = "; ".join(
        f"portbench.run.read_metric({p.stem!r}, {{}})" for p in (PB / "metrics").glob("*.py")
        if p.stem != "kernel_bytes" and "kernel_roofline" not in p.stem)
    loops = "".join(f"import portbench.loops.{p.stem}\n" for p in (PB / "loops").glob("*.py"))
    loaded = _modules_after(
        "import portbench.run, portbench.check, portbench.trace, portbench.control\n"
        + loops
        + "import kolibrie_tpu_torch\n"
        "from kolibrie_tpu_torch.reasoner import device_fixpoint\n"
        "from kolibrie_tpu_torch.optimizer import device_engine\n"
        + readers)
    assert "kolibrie_tpu_torch" in loaded and "portbench" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    loaded = _modules_after(
        "import portbench.reference.closure, portbench.reference.bgp, portbench.check")
    assert "kolibrie_tpu_torch" not in loaded
    assert "torch" not in loaded
    assert not loaded & FORBIDDEN
