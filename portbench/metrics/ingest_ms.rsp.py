"""ingest_ms.rsp: host milliseconds a cycle outside the cross-window
cycle: the window's wall time, up to its last completion, less the
rsp.cw.cycle spans, over the cycles completed.  That is the loop pushing
events through S2R and the window processors (each event's WindowTriple
built as it is pushed; the events are drawn before the window)."""


def read(ctx):
    spans = ctx.get("spans")
    n = ctx.get("requests")
    window_s = ctx.get("window_s")
    if not spans or not n or not window_s:
        return None
    cycles = [s["dur_ms"] for s in spans if s["name"] == "rsp.cw.cycle"]
    if not cycles:
        return None
    return (1000.0 * window_s - sum(cycles)) / n
