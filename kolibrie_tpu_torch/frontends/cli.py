"""Command-line interface: load RDF, run SPARQL, print a result table.

Parity: ``cli/src/main.rs:15-41`` (``--file RDF --query SPARQL``), extended
with format override, rule application (SPARQL RULE and N3 logic), and an
``--serve`` flag that starts the HTTP server.  Port of
``kolibrie_tpu/frontends/cli.py``: ``--device`` names where the database
(or the server) lives, the CUDA card unless given.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

from kolibrie_tpu_torch.obs import log as obslog

_log = obslog.get_logger("cli")


def _read_arg(value: str) -> str:
    """Accept either inline text or a path to a file holding the text."""
    if os.path.exists(value):
        with open(value, "r", encoding="utf-8") as f:
            return f.read()
    return value


def _print_table(rows: List[List[str]], out) -> None:
    if not rows:
        print("(no results)", file=out)
        return
    widths = [
        max(len(str(r[i])) for r in rows if i < len(r))
        for i in range(max(len(r) for r in rows))
    ]
    for row in rows:
        print(
            "  ".join(str(v).ljust(w) for v, w in zip(row, widths)).rstrip(),
            file=out,
        )


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="kolibrie-tpu",
        description="SPARQL/RDF + RSP + probabilistic-Datalog engine on PyTorch",
    )
    ap.add_argument("--file", help="RDF data file (format by extension)")
    ap.add_argument("--format", help="override data format: turtle|ntriples|rdfxml|n3")
    ap.add_argument("--query", help="SPARQL query text or path to a .rq file")
    ap.add_argument(
        "--rule",
        action="append",
        default=[],
        help="SPARQL RULE definition (text or path); may repeat",
    )
    ap.add_argument("--n3logic", help="N3 logic rules (text or path)")
    ap.add_argument("--legacy", action="store_true", help="use the legacy join path")
    ap.add_argument(
        "--export",
        choices=["ntriples", "turtle", "rdfxml"],
        help="after loading (and applying rules), print the database in this "
        "format instead of running a query",
    )
    ap.add_argument("--time", action="store_true", help="print execution time")
    ap.add_argument(
        "--explain",
        action="store_true",
        help="print the device physical plan (scan orders, join keys +"
        " exact counts) for --query instead of executing it",
    )
    ap.add_argument("--serve", action="store_true", help="start the HTTP server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7878)
    ap.add_argument(
        "--device",
        default=None,
        help="torch device to run on (default: the CUDA card; e.g. cpu)",
    )
    args = ap.parse_args(argv)

    if args.serve:
        from kolibrie_tpu_torch.frontends.http_server import serve

        serve(args.host, args.port, device=args.device)
        return 0

    if not args.query and not args.export:
        ap.error("--query or --export is required (unless --serve)")

    from kolibrie_tpu_torch.query.executor import execute_query, execute_query_volcano
    from kolibrie_tpu_torch.query.sparql_database import SparqlDatabase

    db = SparqlDatabase(device=args.device)
    if args.file:
        db.load_file(args.file, args.format)

    if args.n3logic:
        from kolibrie_tpu_torch.frontends.rules import apply_n3_logic

        inferred = apply_n3_logic(db, _read_arg(args.n3logic))
        _log.info("n3logic rules applied", inferred=inferred)

    for rule_text in args.rule:
        from kolibrie_tpu_torch.frontends.rules import apply_sparql_rules

        inferred = apply_sparql_rules(db, [_read_arg(rule_text)])
        _log.info("sparql rule applied", inferred=inferred)

    if args.export:
        writer = {
            "ntriples": db.to_ntriples,
            "turtle": db.to_turtle,
            "rdfxml": db.to_rdfxml,
        }[args.export]
        sys.stdout.write(writer())
        return 0

    sparql = _read_arg(args.query)
    if args.explain:
        from kolibrie_tpu_torch.query.engine import QueryEngine

        print(QueryEngine(db).explain_device(sparql), file=sys.stdout)
        return 0
    start = time.perf_counter()
    run = execute_query if args.legacy else execute_query_volcano
    rows = run(sparql, db)
    elapsed_ms = (time.perf_counter() - start) * 1000.0
    _print_table(rows, sys.stdout)
    if args.time:
        _log.info("query executed", rows=len(rows), elapsed_ms=round(elapsed_ms, 2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
