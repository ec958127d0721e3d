"""kolint core: findings, the rule registry, suppression handling, the
baseline file, and the programmatic runner.

Suppressions
    ``# kolint: ignore[KL301] reason text`` on the offending line (or on
    a comment-only line directly above it) drops matching findings.  A
    reason is mandatory: an ignore with no reason (or an unknown rule
    id) is itself a finding (KL001) — suppressions document judgement,
    they don't hide it.

Baseline
    A JSON file of grandfathered findings keyed on ``(rule, path, scope,
    message)`` — deliberately line-number-free so unrelated edits don't
    invalidate it.  ``run()`` subtracts baseline matches (as a multiset)
    and reports the remainder; ``--write-baseline`` regenerates the file
    from the current findings.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from kolibrie_tpu_torch.analysis.project import Project, SourceFile, load_files

META_SUPPRESSION = "KL001"
META_PARSE = "KL002"


@dataclass
class Finding:
    rule: str
    path: str  # repo-root-relative when under the root
    line: int
    message: str
    scope: str = ""  # enclosing function qualname (baseline key part)

    def key(self) -> Tuple[str, str, str, str]:
        return (self.rule, self.path, self.scope, self.message)

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "scope": self.scope,
            "message": self.message,
        }

    def render(self) -> str:
        scope = f" [{self.scope}]" if self.scope else ""
        return f"{self.path}:{self.line}: {self.rule}{scope}: {self.message}"


# rule id → (one-line description, fn(Project) -> List[Finding])
RULES: Dict[str, Tuple[str, Callable[[Project], List[Finding]]]] = {}


def rule(rule_id: str, description: str):
    def register(fn):
        RULES[rule_id] = (description, fn)
        return fn

    return register


def repo_root() -> str:
    """Parent of the kolibrie_tpu_torch package — the root that findings'
    paths are relative to and the cache lives under."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg)


def default_baseline_path() -> str:
    """``kolibrie_tpu_torch/analysis/kolint_baseline.json``, beside this
    module (the repo root's ``kolint_baseline.json`` is the JAX
    package's)."""
    return os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "kolint_baseline.json"
    )


def load_baseline(path: Optional[str]) -> Counter:
    if not path or not os.path.exists(path):
        return Counter()
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    out: Counter = Counter()
    for ent in data.get("findings", []):
        out[
            (ent["rule"], ent["path"], ent.get("scope", ""), ent["message"])
        ] += int(ent.get("count", 1))
    return out


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    counts: Counter = Counter(f.key() for f in findings)
    entries = [
        {
            "rule": rule_id,
            "path": p,
            "scope": scope,
            "message": msg,
            "count": n,
        }
        for (rule_id, p, scope, msg), n in sorted(counts.items())
    ]
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": 1, "findings": entries}, fh, indent=2)
        fh.write("\n")


@dataclass
class RunResult:
    findings: List[Finding]  # post-suppression, post-baseline
    suppressed: List[Finding]
    baselined: List[Finding]
    all_findings: List[Finding] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings


def _apply_suppressions(
    files: List[SourceFile], findings: List[Finding]
) -> Tuple[List[Finding], List[Finding], List[Finding]]:
    """→ (kept, suppressed, meta-findings for malformed directives)."""
    by_rel = {f.rel: f for f in files}
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    meta: List[Finding] = []
    for f in files:
        for sup in f.suppressions:
            if not sup.reason:
                meta.append(
                    Finding(
                        META_SUPPRESSION,
                        f.rel,
                        sup.raw_line,
                        "kolint ignore without a reason — write "
                        "`# kolint: ignore[RULE] why it is safe`",
                    )
                )
            for rid in sup.rules:
                if rid not in RULES and rid not in (
                    META_SUPPRESSION, META_PARSE,
                ):
                    meta.append(
                        Finding(
                            META_SUPPRESSION,
                            f.rel,
                            sup.raw_line,
                            f"kolint ignore names unknown rule {rid!r}",
                        )
                    )
    for finding in findings:
        src = by_rel.get(finding.path)
        matched = False
        if src is not None:
            for sup in src.suppressions:
                if (
                    sup.line == finding.line
                    and sup.reason
                    and finding.rule in sup.rules
                ):
                    sup.used = True
                    matched = True
                    break
        (suppressed if matched else kept).append(finding)
    return kept, suppressed, meta


def run(
    paths: Sequence[str],
    baseline_path: Optional[str] = None,
    use_baseline: bool = True,
    rules: Optional[Sequence[str]] = None,
    root: Optional[str] = None,
    use_cache: bool = False,
    jobs: int = 1,
    changed_only: bool = False,
) -> RunResult:
    # rule modules self-register on import
    from kolibrie_tpu_torch.analysis import (  # noqa: F401
        rules_caching,
        rules_context,
        rules_durability,
        rules_errors,
        rules_locks,
        rules_obs,
        rules_pallas,
        rules_races,
        rules_taint,
        rules_tracing,
    )
    from kolibrie_tpu_torch.analysis import cache as _cache

    root = root or repo_root()
    files = load_files(list(paths), root)
    project = Project(files)

    findings: List[Finding] = []
    for f in files:
        if f.parse_error:
            findings.append(
                Finding(META_PARSE, f.rel, 1, f"syntax error: {f.parse_error}")
            )
    active = rules if rules is not None else sorted(RULES)

    # per-(project signature, rule) cache of RAW findings; suppressions
    # and the baseline are applied after, so they can change without
    # invalidating cached analysis (their inputs are in the signature
    # anyway for suppressions, and the baseline is a post-filter)
    per_rule: Dict[str, List[Finding]] = {}
    sig: Optional[str] = None
    missing = list(active)
    if use_cache:
        sig = _cache.project_signature(files)
        missing = []
        for rule_id in active:
            got = _cache.get_rule(root, sig, rule_id)
            if got is None:
                missing.append(rule_id)
            else:
                per_rule[rule_id] = [Finding(**d) for d in got]
    if missing:
        for rule_id, dicts in _cache.run_rules(
            project, missing, jobs=jobs
        ).items():
            per_rule[rule_id] = [Finding(**d) for d in dicts]
            if sig is not None:
                _cache.put_rule(root, sig, rule_id, dicts)
    if sig is not None:
        _cache.gc(root, sig)
    for rule_id in active:
        findings.extend(per_rule.get(rule_id, []))
    findings.sort(key=lambda x: (x.path, x.line, x.rule))

    kept, suppressed, meta = _apply_suppressions(files, findings)
    kept.extend(meta)
    kept.sort(key=lambda x: (x.path, x.line, x.rule))

    if changed_only:
        # the ANALYSIS covered the whole project (interprocedural rules
        # need it); only the REPORT narrows to files that changed since
        # the last full run's manifest
        changed = _cache.changed_files(root, files)
        kept = [f for f in kept if f.path in changed]
    elif use_cache:
        # full runs advance the --changed-only reference point
        _cache.write_manifest(root, _cache.file_digests(files))

    baselined: List[Finding] = []
    if use_baseline:
        budget = load_baseline(
            baseline_path
            if baseline_path is not None
            else default_baseline_path()
        )
        remaining: List[Finding] = []
        for finding in kept:
            if budget.get(finding.key(), 0) > 0:
                budget[finding.key()] -= 1
                baselined.append(finding)
            else:
                remaining.append(finding)
        kept = remaining
    return RunResult(
        findings=kept,
        suppressed=suppressed,
        baselined=baselined,
        all_findings=findings + meta,
    )
