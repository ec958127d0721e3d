"""candidate_rows.materialize: candidate rows a job, the candidate_rows
of the window's fixpoint.round spans (the candidate blocks' static lengths
that each round puts through the dedup) over its reasoner.fixpoint spans,
one a job."""


def read(ctx):
    spans = ctx.get("spans")
    if not spans:
        return None
    jobs = sum(1 for s in spans if s["name"] == "reasoner.fixpoint")
    rows = [(s.get("attrs") or {}).get("candidate_rows") for s in spans
            if s["name"] == "fixpoint.round"]
    rows = [r for r in rows if r is not None]
    if not jobs or not rows:
        return None
    return sum(rows) / jobs
