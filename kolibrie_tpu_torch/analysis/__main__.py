"""kolint CLI.

    python -m kolibrie_tpu_torch.analysis [paths...]        lint (against baseline)
    python -m kolibrie_tpu_torch.analysis --json            machine-readable output
    python -m kolibrie_tpu_torch.analysis --no-baseline     raw findings
    python -m kolibrie_tpu_torch.analysis --write-baseline  regenerate baseline
    python -m kolibrie_tpu_torch.analysis --list-rules      rule catalog
    python -m kolibrie_tpu_torch.analysis --explain KL311   rule doc + fix recipe
    python -m kolibrie_tpu_torch.analysis --changed-only    report only edited files

Performance: results are cached per (project signature, rule) under
.kolint_cache/torch/ and cold rules fan out over a small process pool —
``--no-cache`` / ``--jobs N`` (default ``KOLINT_JOBS`` or cpu-derived)
control both.  Every run prints ``kolint_runtime_s=…``; ``--max-seconds``
turns that number into a gate so lint stays fast enough to run on every
commit.

Exit status: 0 when no non-baselined findings remain, 1 otherwise (or
when --max-seconds is exceeded), 2 on usage errors.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from kolibrie_tpu_torch.analysis import core


def _default_jobs() -> int:
    env = os.environ.get("KOLINT_JOBS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    # rules bucket into ~10 families; more workers than that is churn
    return min(4, os.cpu_count() or 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kolibrie_tpu_torch.analysis",
        description="kolint: repo-native static analysis for tracing, "
        "recompile, lock-discipline, and observability invariants.",
    )
    ap.add_argument(
        "paths",
        nargs="*",
        help="files or directories to lint (default: the kolibrie_tpu_torch "
        "package)",
    )
    ap.add_argument("--json", action="store_true", help="JSON output")
    ap.add_argument(
        "--baseline",
        metavar="PATH",
        default=None,
        help="baseline file (default: "
        "kolibrie_tpu_torch/analysis/kolint_baseline.json)",
    )
    ap.add_argument(
        "--no-baseline",
        action="store_true",
        help="report all findings, ignoring the baseline",
    )
    ap.add_argument(
        "--write-baseline",
        action="store_true",
        help="write current (post-suppression) findings as the baseline",
    )
    ap.add_argument(
        "--rules",
        metavar="IDS",
        default=None,
        help="comma-separated rule ids to run (default: all)",
    )
    ap.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog"
    )
    ap.add_argument(
        "--explain",
        metavar="RULE",
        default=None,
        help="print one rule's documentation, example, and fix recipe",
    )
    ap.add_argument(
        "--no-cache",
        action="store_true",
        help="skip the .kolint_cache/torch result cache (always "
        "re-analyze)",
    )
    ap.add_argument(
        "--jobs",
        type=int,
        default=None,
        metavar="N",
        help="process-pool workers for rule execution "
        "(default: $KOLINT_JOBS or cpu-derived; 1 = in-process)",
    )
    ap.add_argument(
        "--changed-only",
        action="store_true",
        help="report only findings in files changed since the last full "
        "run (analysis still covers the whole project)",
    )
    ap.add_argument(
        "--max-seconds",
        type=float,
        default=None,
        metavar="S",
        help="fail (exit 1) if the lint run takes longer than S seconds",
    )
    args = ap.parse_args(argv)

    # import for registration before --list-rules / --explain
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

    if args.explain:
        from kolibrie_tpu_torch.analysis.explain import explain

        text = explain(args.explain.strip().upper())
        if text is None:
            print(f"unknown rule id: {args.explain}", file=sys.stderr)
            return 2
        print(text)
        return 0

    if args.list_rules:
        for rid in sorted(core.RULES):
            desc, _ = core.RULES[rid]
            print(f"{rid}  {desc}")
        print(f"{core.META_SUPPRESSION}  suppression directive malformed "
              "(no reason / unknown rule)")
        print(f"{core.META_PARSE}  file does not parse")
        return 0

    paths = args.paths or [
        os.path.join(core.repo_root(), "kolibrie_tpu_torch")
    ]
    rule_ids = None
    if args.rules:
        rule_ids = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rule_ids if r not in core.RULES]
        if unknown:
            print(f"unknown rule id(s): {', '.join(unknown)}", file=sys.stderr)
            return 2

    baseline_path = args.baseline or core.default_baseline_path()
    t0 = time.perf_counter()
    result = core.run(
        paths,
        baseline_path=baseline_path,
        use_baseline=not (args.no_baseline or args.write_baseline),
        rules=rule_ids,
        use_cache=not args.no_cache,
        jobs=args.jobs if args.jobs is not None else _default_jobs(),
        changed_only=args.changed_only,
    )
    runtime_s = time.perf_counter() - t0
    too_slow = (
        args.max_seconds is not None and runtime_s > args.max_seconds
    )

    if args.write_baseline:
        core.write_baseline(baseline_path, result.findings)
        print(
            f"wrote {len(result.findings)} finding(s) to {baseline_path}"
        )
        return 0

    if args.json:
        print(
            json.dumps(
                {
                    "findings": [f.to_dict() for f in result.findings],
                    "suppressed": len(result.suppressed),
                    "baselined": len(result.baselined),
                    "runtime_s": round(runtime_s, 2),
                    "ok": result.ok and not too_slow,
                },
                indent=2,
            )
        )
    else:
        for f in result.findings:
            print(f.render())
        tail = (
            f"{len(result.findings)} finding(s), "
            f"{len(result.suppressed)} suppressed, "
            f"{len(result.baselined)} baselined"
        )
        print(tail)
        print(f"kolint_runtime_s={runtime_s:.2f}")
    if too_slow:
        print(
            f"kolint exceeded --max-seconds {args.max_seconds:g} "
            f"(took {runtime_s:.2f}s)",
            file=sys.stderr,
        )
        return 1
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
