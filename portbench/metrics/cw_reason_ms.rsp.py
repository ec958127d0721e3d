"""cw_reason_ms.rsp: host milliseconds a cycle in the SDS+ closure, the
sds.reason spans (incremental_sds_plus or naive_sds_plus whole: the SDS
translation, the tagged fixpoint, the state carried to the next cycle)
over the cycles completed."""


def read(ctx):
    spans = ctx.get("spans")
    n = ctx.get("requests")
    if not spans or not n:
        return None
    ms = [s["dur_ms"] for s in spans if s["name"] == "sds.reason"]
    if not ms:
        return None
    return sum(ms) / n
