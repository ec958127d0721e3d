"""decode_ms.analytic: host milliseconds a query in result decoding, the
query.decode spans over the window (format_results: the ID to string
decode and the row sort) over the queries completed."""


def read(ctx):
    spans = ctx.get("spans")
    n = ctx.get("requests")
    if not spans or not n:
        return None
    ms = [s["dur_ms"] for s in spans if s["name"] == "query.decode"]
    if not ms:
        return None
    return sum(ms) / n
