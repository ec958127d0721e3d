"""The port's project linter (``kolibrie_tpu_torch/analysis/``) against the
JAX package's (``kolibrie_tpu/analysis/``).

- Parity: every source text that ``tests/test_kolint.py`` and
  ``tests/test_kolint_v2.py`` lint (their module-level fixture strings and
  the inline ones, read with ``ast`` from those files, at the paths they
  are written to) goes through both linters on the same file; the
  findings, suppressions and baseline matches agree once the package name
  is mapped.
- Mechanics: ``--list-rules``, ``--explain``, exit codes and JSON, the
  result cache, ``--jobs``, ``--changed-only`` and ``--max-seconds``, each
  against the reference.
- KL801's counterpart in the port: plain versions, launch internals and
  ``ctypes`` loaders outside ``ops/``.
- The repo gate: ``kolibrie_tpu_torch/`` lints clean against its committed
  empty baseline, and the reference's linter finds nothing in it either.
"""

import ast
import json
import os
from pathlib import Path

import pytest

from kolibrie_tpu.analysis import cache as ref_cache
from kolibrie_tpu.analysis import core as ref_core
from kolibrie_tpu.analysis.__main__ import main as ref_main
from kolibrie_tpu_torch.analysis import cache as port_cache
from kolibrie_tpu_torch.analysis import core as port_core
from kolibrie_tpu_torch.analysis.__main__ import main as port_main

REPO = Path(__file__).resolve().parents[1]
PORT_PKG = "kolibrie_tpu_torch"


def _map(text: str) -> str:
    """The port's package name as the reference writes it."""
    return text.replace(PORT_PKG, "kolibrie_tpu")


# the port's rule docstrings drop the reference's change numbers
_HISTORY = (("PR 16's shared-prefix", "MQO's shared-prefix"),
            ("(PR 2/3, documented", "(documented"), ("taxonomy and PR 3's", "taxonomy and its"))


def _unnumbered(text: str) -> str:
    for old, new in _HISTORY:
        text = text.replace(old, new)
    return text


def _keys(findings, mapped=False):
    m = _map if mapped else (lambda s: s)
    return [(f.rule, f.path, f.line, f.scope, m(f.message)) for f in findings]


# ------------------------------------------- the reference's fixture texts


class _Unknown(Exception):
    pass


def _eval(node, env):
    """A fixture expression's value: str constants, names bound earlier,
    ``+``, ``.replace`` / ``.format``, and ``tmp_path / ...`` paths (as
    ``dir/name`` strings relative to the linted root)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        if node.id in env:
            return env[node.id]
        raise _Unknown(node.id)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _eval(node.left, env) + _eval(node.right, env)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
        left, right = _eval(node.left, env), _eval(node.right, env)
        return f"{left}/{right}" if left else right
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        base = _eval(node.func.value, env)
        args = [_eval(a, env) for a in node.args]
        kw = {k.arg: _eval(k.value, env) for k in node.keywords}
        if node.func.attr == "replace":
            return base.replace(*args)
        if node.func.attr == "format":
            return base.format(*args, **kw)
    raise _Unknown(ast.dump(node)[:80])


def _param_envs(fn, base):
    """One name binding per ``pytest.mark.parametrize("name", [...])`` value."""
    for deco in fn.decorator_list:
        if isinstance(deco, ast.Call) and getattr(deco.func, "attr", "") == "parametrize":
            name = deco.args[0].value
            return [dict(base, **{name: v}) for v in ast.literal_eval(deco.args[1])]
    return [base]


def _bind(node, env):
    if (
        isinstance(node, ast.Assign)
        and len(node.targets) == 1
        and isinstance(node.targets[0], ast.Name)
    ):
        try:
            env[node.targets[0].id] = _eval(node.value, env)
        except _Unknown:
            pass


def _fixture_texts(fname):
    """``(label, path, text)`` for every text the file lints: each
    module-level fixture at ``mod.py``, and each ``lint(tmp_path, src,
    name=...)`` / ``<path>.write_text(src)`` of a test at its path."""
    tree = ast.parse((REPO / "tests" / fname).read_text())
    module_env = {}
    for node in tree.body:
        _bind(node, module_env)
    seen = {}
    for name, text in module_env.items():
        seen.setdefault((text, "mod.py"), name)
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef) or fn.name == "lint":
            continue
        k = 0
        for env in _param_envs(fn, dict(module_env, tmp_path="")):
            for node in ast.walk(fn):
                _bind(node, env)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if isinstance(f, ast.Name) and f.id == "lint":
                    text = _eval(node.args[1], env)
                    rel = "mod.py"
                    for kw in node.keywords:
                        if kw.arg == "name":
                            rel = _eval(kw.value, env)
                elif isinstance(f, ast.Attribute) and f.attr == "write_text":
                    text, rel = _eval(node.args[0], env), _eval(f.value, env)
                else:
                    continue
                k += 1
                seen.setdefault((text, rel), f"{fn.name}#{k}")
    return [(label, rel, text) for (text, rel), label in seen.items()]


FIXTURES = [
    pytest.param(rel, text, id=f"{fname[:-3]}:{label}@{rel}")
    for fname in ("test_kolint.py", "test_kolint_v2.py")
    for label, rel, text in _fixture_texts(fname)
]


def test_every_fixture_of_both_files_is_collected():
    # 48 module-level texts and 60 inline (path, text) pairs when written
    assert len(FIXTURES) >= 100
    paths = {p.values[0] for p in FIXTURES}
    assert {"mod.py", "ops/kernels.py", "durability/fsio.py", "__main__.py",
            "conftest.py", "replication/frames.py", "bare.py"} <= paths


@pytest.mark.parametrize("rel,text", FIXTURES)
def test_fixture_findings_match_reference(tmp_path, rel, text):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(text)
    ref = ref_core.run([str(p)], use_baseline=False, root=str(tmp_path))
    port = port_core.run([str(p)], use_baseline=False, root=str(tmp_path))
    assert _keys(port.findings, mapped=True) == _keys(ref.findings)
    assert _keys(port.suppressed, mapped=True) == _keys(ref.suppressed)
    # each linter's own baseline of those findings: the same file, and
    # every finding baselined on the next run
    ref_bl, port_bl = tmp_path / "ref.json", tmp_path / "port.json"
    ref_core.write_baseline(str(ref_bl), ref.findings)
    port_core.write_baseline(str(port_bl), port.findings)
    assert _map(port_bl.read_text()) == ref_bl.read_text()
    ref2 = ref_core.run([str(p)], baseline_path=str(ref_bl), root=str(tmp_path))
    port2 = port_core.run([str(p)], baseline_path=str(port_bl), root=str(tmp_path))
    assert port2.findings == [] and ref2.findings == []
    assert len(port2.baselined) == len(ref2.baselined) == len(ref.findings)
    assert len(port2.suppressed) == len(ref2.suppressed)


# ------------------------------------------------------------- mechanics

RACE = """
import threading

class Sampler:
    def __init__(self):
        self.count = 0

    def start(self):
        t = threading.Thread(target=self._run, daemon=True)
        t.start()

    def _run(self):
        self.count += 1

    def stats(self):
        return self.count
"""

TAINT = """

import jax
import jax.numpy as jnp

@jax.jit
def step(x):
    y = jnp.sum(x) * 2.0
    if y > 0:
        return y
    return -y
"""

BROAD_EXCEPT = """
import json

def load(path):
    try:
        return json.load(open(path))
    except Exception:
        pass
"""


def test_list_rules_matches_reference(capsys):
    assert ref_main(["--list-rules"]) == 0
    ref = capsys.readouterr().out
    assert port_main(["--list-rules"]) == 0
    port = capsys.readouterr().out
    assert _map(port) == ref
    assert tuple(sorted(port_core.RULES)) == tuple(sorted(ref_core.RULES)) == RULE_IDS
    assert len(port.strip().splitlines()) == len(RULE_IDS) + 2  # and KL001, KL002


# the catalog (the rule modules register on first use, after collection)
RULE_IDS = (
    "KL101", "KL102", "KL111", "KL112", "KL201", "KL202", "KL203", "KL301",
    "KL302", "KL311", "KL312", "KL401", "KL501", "KL502", "KL503", "KL504",
    "KL601", "KL701", "KL702", "KL801", "KL901", "KL902",
)


@pytest.mark.parametrize("rule_id", RULE_IDS + ("KL001", "KL002"))
def test_explain_matches_reference(capsys, rule_id):
    assert ref_main(["--explain", rule_id]) == 0
    ref = _unnumbered(capsys.readouterr().out)
    assert port_main(["--explain", rule_id.lower()]) == 0
    port = _map(capsys.readouterr().out)
    if rule_id != "KL801":
        assert port == ref
        return
    # KL801's family notes go on with the port's counterpart
    assert port.startswith(ref.rstrip())
    for name in ("merge_path_plain", "_ptr_table", "ctypes.CDLL", "native/",
                 "build_kernels", "set_build_dir"):
        assert name in port[len(ref.rstrip()):], name


def test_cli_exit_codes_and_json_match_reference(tmp_path, capsys):
    p = tmp_path / "mod.py"
    p.write_text(BROAD_EXCEPT)
    out = {}
    for tag, main in (("ref", ref_main), ("port", port_main)):
        bl = tmp_path / f"{tag}-baseline.json"
        rc = main(["--json", "--no-cache", "--baseline", str(bl), str(p)])
        payload = json.loads(capsys.readouterr().out)
        assert rc == 1 and payload["ok"] is False
        assert isinstance(payload.pop("runtime_s"), float)
        out[tag] = payload
        assert main(["--write-baseline", "--no-cache", "--baseline", str(bl), str(p)]) == 0
        assert "wrote 1 finding(s)" in capsys.readouterr().out
        assert main(["--no-cache", "--baseline", str(bl), str(p)]) == 0
        assert "0 finding(s), 0 suppressed, 1 baselined" in capsys.readouterr().out
        assert main(["--no-cache", "--rules", "KL999", str(p)]) == 2
        assert "unknown rule id" in capsys.readouterr().err
        assert main(["--explain", "KL999"]) == 2
        assert "unknown rule id" in capsys.readouterr().err
    assert out["port"] == out["ref"]
    assert out["port"]["findings"][0]["rule"] == "KL601"


def test_cli_max_seconds_matches_reference(tmp_path, capsys):
    p = tmp_path / "ok.py"
    p.write_text("x = 1\n")
    for main in (ref_main, port_main):
        assert main([str(p), "--no-baseline", "--no-cache", "--max-seconds", "60"]) == 0
        assert "kolint_runtime_s=" in capsys.readouterr().out
        # an impossible budget flips the exit code even with zero findings
        assert main([str(p), "--no-baseline", "--no-cache", "--max-seconds", "0"]) == 1
        assert "exceeded --max-seconds 0" in capsys.readouterr().err


def test_cache_cold_and_warm_match_reference(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text(RACE)
    kw = dict(use_baseline=False, root=str(tmp_path), use_cache=True)
    ref = ref_core.run([str(p)], **kw)
    manifest = tmp_path / ".kolint_cache" / "files.json"
    ref_manifest = manifest.read_text()
    cold = port_core.run([str(p)], **kw)
    warm = port_core.run([str(p)], **kw)
    assert _keys(cold.findings) == _keys(warm.findings)
    assert _keys(warm.findings, mapped=True) == _keys(ref.findings)
    assert [f.rule for f in warm.findings] == ["KL311"]
    # the port's entries and manifest sit under torch/; the reference's
    # manifest is left as the reference wrote it
    cache = tmp_path / ".kolint_cache" / "torch"
    sigs = [d for d in cache.iterdir() if d.is_dir()]
    assert len(sigs) == 1 and (sigs[0] / "KL311.json").exists()
    assert (cache / "files.json").exists()
    assert manifest.read_text() == ref_manifest
    # an edit moves the signature: the fix is seen, not a stale entry
    p.write_text(RACE.replace("        self.count += 1", "        pass"))
    assert port_core.run([str(p)], **kw).findings == []


def test_parallel_jobs_match_sequential_and_reference(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text(RACE + TAINT)
    kw = dict(use_baseline=False, root=str(tmp_path))
    seq = port_core.run([str(p)], jobs=1, **kw)
    par = port_core.run([str(p)], jobs=4, **kw)
    ref = ref_core.run([str(p)], jobs=4, **kw)
    assert _keys(par.findings) == _keys(seq.findings)
    assert _keys(par.findings, mapped=True) == _keys(ref.findings)
    assert {"KL111", "KL311"} <= {f.rule for f in par.findings}
    assert port_cache.bucket_rules(list(port_core.RULES)) == ref_cache.bucket_rules(
        list(ref_core.RULES)
    )


def test_changed_only_matches_reference(tmp_path):
    paths = {}
    for tag, core in (("ref", ref_core), ("port", port_core)):
        root = tmp_path / tag
        root.mkdir()
        (root / "a.py").write_text(RACE)
        (root / "b.py").write_text(RACE)
        kw = dict(use_baseline=False, root=str(root), use_cache=True)
        full = core.run([str(root)], **kw)
        (root / "b.py").write_text(RACE.replace("count", "tally"))
        focused = core.run([str(root)], changed_only=True, **kw)
        refull = core.run([str(root)], **kw)
        paths[tag] = [
            sorted(f.path for f in r.findings) for r in (full, focused, refull)
        ]
    assert paths["port"] == paths["ref"] == [["a.py", "b.py"], ["b.py"], ["a.py", "b.py"]]


# ------------------------------------------------ KL801 in the port

BAD_KL801_PLAIN = """
from kolibrie_tpu_torch.ops import kernels
from kolibrie_tpu_torch.ops.kernels import filter_mask_plain

def mask(s, p, o):
    return filter_mask_plain(s, p, o, p_const=3)

def merge(lidx_c, low_c, cum, total):
    return kernels.merge_path_plain(lidx_c, low_c, cum, total, 4, 4, 8)
"""

BAD_KL801_INTERNALS = """
import torch
from kolibrie_tpu_torch.ops import kernels as K
from kolibrie_tpu_torch.ops.kernels import _check, _stream

def launch(x):
    lib = K._lib("filter_mask")
    ptrs = K._ptr_table([x], 1)
    _check(lib.launch(K._arg(x, torch.int64), ptrs, _stream(x.device)), "filter_mask")
"""

BAD_KL801_LOADER = """
import ctypes
from ctypes import CDLL

def load(path):
    a = ctypes.CDLL(path)
    b = ctypes.cdll.LoadLibrary(path)
    c = CDLL(path)
    return a, b, c
"""

GOOD_KL801_PORT = """
import ctypes
from kolibrie_tpu_torch.ops import kernels
from kolibrie_tpu_torch.ops.kernels import build_kernels, filter_mask, set_build_dir

def warm(build_dir):
    set_build_dir(build_dir)
    return build_kernels()

def mask(s, p, o):
    return filter_mask(s, p, o, p_const=3)  # the wrapper takes the plain version on CPU

def merge(lkey, rkey):
    return kernels.merge_join_indices(lkey, rkey)

def _check(rows):  # a module's own helper of a launch internal's name
    return len(rows)

def count(rows):
    return _check(rows)

def width(lib: ctypes.CDLL) -> int:  # an annotation loads nothing
    return ctypes.sizeof(ctypes.c_int)
"""


def _lint_port(tmp_path, text, rel="mod.py"):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(text)
    return port_core.run([str(p)], use_baseline=False, root=str(tmp_path))


@pytest.mark.parametrize(
    "text,lines,needle",
    [
        (BAD_KL801_PLAIN, [6, 9], "plain version bypasses the kernel"),
        (BAD_KL801_INTERNALS, [7, 8, 9, 9, 9], "launch internal"),
        (BAD_KL801_LOADER, [6, 7, 8], "outside kolibrie_tpu_torch/ops/ and native/"),
    ],
    ids=["plain", "internals", "loader"],
)
def test_kl801_port_containment_fires(tmp_path, text, lines, needle):
    res = _lint_port(tmp_path, text)
    assert [f.rule for f in res.findings] == ["KL801"] * len(lines)
    assert [f.line for f in res.findings] == lines
    assert all(needle in f.message for f in res.findings)
    # the reference's linter has no such rule: nothing there
    assert ref_core.run(
        [str(tmp_path / "mod.py")], use_baseline=False, root=str(tmp_path)
    ).findings == []


def test_kl801_port_containment_names_each_callee(tmp_path):
    msgs = [f.message for f in _lint_port(tmp_path, BAD_KL801_INTERNALS).findings]
    for name in ("_lib()", "_ptr_table()", "_check()", "_arg()", "_stream()"):
        assert sum(name in m for m in msgs) == 1, name
    msgs = [f.message for f in _lint_port(tmp_path, BAD_KL801_LOADER, "l.py").findings]
    assert sum("ctypes.cdll.LoadLibrary()" in m for m in msgs) == 1
    assert sum(m.startswith("ctypes.CDLL()") for m in msgs) == 2


def test_kl801_port_good_fixture_is_clean(tmp_path):
    assert _lint_port(tmp_path, GOOD_KL801_PORT).findings == []


@pytest.mark.parametrize(
    "rel", ["ops/kernels.py", "kolibrie_tpu_torch/ops/device_join.py",
            "tests/helpers.py", "test_kernels.py", "conftest.py"],
)
def test_kl801_port_containment_sanctioned_files(tmp_path, rel):
    text = BAD_KL801_PLAIN + BAD_KL801_INTERNALS + BAD_KL801_LOADER
    assert _lint_port(tmp_path, text, rel).findings == []


def test_kl801_native_may_load_but_not_bypass(tmp_path):
    assert _lint_port(tmp_path, BAD_KL801_LOADER, "native/__init__.py").findings == []
    res = _lint_port(tmp_path, BAD_KL801_PLAIN, "native/join_native.py")
    assert [f.line for f in res.findings] == [6, 9]


def test_kl801_port_suppression_with_reason(tmp_path):
    src = BAD_KL801_PLAIN.replace(
        "    return filter_mask_plain(s, p, o, p_const=3)",
        "    # kolint: ignore[KL801] fixture: a CPU oracle beside the kernel\n"
        "    return filter_mask_plain(s, p, o, p_const=3)",
    )
    res = _lint_port(tmp_path, src)
    assert [f.line for f in res.findings] == [10]
    assert [f.rule for f in res.suppressed] == ["KL801"]
    bare = _lint_port(tmp_path, src.replace(" fixture: a CPU oracle beside the kernel", ""))
    assert sorted(f.rule for f in bare.findings) == ["KL001", "KL801", "KL801"]


# ---------------------------------------------------------- the repo gate


@pytest.fixture(scope="module")
def whole_package_lints(tmp_path_factory):
    """The port's linter against its committed baseline and the
    reference's with none, over ``kolibrie_tpu_torch/`` — once, on one
    worker, with both result caches in a temporary directory."""
    tmp = tmp_path_factory.mktemp("kolint_cache")
    pkg = str(REPO / PORT_PKG)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_cache, "CACHE_DIRNAME", str(tmp / "port"))
        mp.setattr(ref_cache, "CACHE_DIRNAME", str(tmp / "ref"))
        port = port_core.run([pkg], jobs=1, use_cache=True)
        ref = ref_core.run([pkg], use_baseline=False, jobs=1, use_cache=True)
    assert (tmp / "port" / "files.json").exists()
    return port, ref


def test_port_lints_clean_against_its_empty_baseline(whole_package_lints):
    port, _ = whole_package_lints
    assert port_core.default_baseline_path() == str(
        REPO / PORT_PKG / "analysis" / "kolint_baseline.json"
    )
    msgs = "\n".join(f.render() for f in port.findings)
    assert port.ok, f"kolint findings in {PORT_PKG}/:\n{msgs}"
    # every reasoned suppression the reference carries has its copy here
    assert len(port.suppressed) >= 16


def test_port_baseline_is_minimal(whole_package_lints):
    port, _ = whole_package_lints
    with open(port_core.default_baseline_path(), encoding="utf-8") as fh:
        assert json.load(fh) == {"version": 1, "findings": []}
    budget = port_core.load_baseline(port_core.default_baseline_path())
    assert len(port.baselined) == sum(budget.values()) == 0


def test_reference_linter_finds_nothing_in_the_port(whole_package_lints):
    _, ref = whole_package_lints
    msgs = "\n".join(f.render() for f in ref.findings)
    assert ref.findings == [], f"reference kolint findings in {PORT_PKG}/:\n{msgs}"
    assert {f.path.split("/")[1] for f in ref.suppressed} >= {
        "durability", "obs", "replication", "rsp", "optimizer", "analysis",
    }


def test_default_cli_lints_the_port_with_its_baseline(monkeypatch, tmp_path, capsys):
    # no paths, no --baseline: the port's package and committed baseline
    seen = {}

    def fake_run(paths, baseline_path=None, **kw):
        seen.update(paths=paths, baseline=baseline_path)
        return port_core.RunResult([], [], [])

    monkeypatch.setattr(port_core, "run", fake_run)
    assert port_main(["--no-cache"]) == 0
    assert seen == {
        "paths": [os.path.join(port_core.repo_root(), PORT_PKG)],
        "baseline": port_core.default_baseline_path(),
    }
    assert "0 finding(s)" in capsys.readouterr().out
