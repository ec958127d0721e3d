"""cw_query_ms.rsp: host milliseconds a cycle in the per-window bucket
databases, their plans and decoding, the rsp.cw.query spans over the
cycles completed."""


def read(ctx):
    spans = ctx.get("spans")
    n = ctx.get("requests")
    if not spans or not n:
        return None
    ms = [s["dur_ms"] for s in spans if s["name"] == "rsp.cw.query"]
    if not ms:
        return None
    return sum(ms) / n
