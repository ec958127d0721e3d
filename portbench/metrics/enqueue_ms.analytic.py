"""enqueue_ms.analytic: host milliseconds a query issuing the plan body,
each device.dispatch span less the device.wait spans inside it (the host
blocked on a readback of the join counts) over the queries completed."""


def read(ctx):
    spans = ctx.get("spans")
    n = ctx.get("requests")
    if not spans or not n:
        return None
    dispatch = {s["span_id"]: s["dur_ms"] for s in spans if s["name"] == "device.dispatch"}
    if not dispatch or not any(s["name"] == "device.wait" for s in spans):
        # a program that times no readback cannot split its dispatch
        return None
    parent = {s["span_id"]: s.get("parent_id") for s in spans}
    waited = 0.0
    for s in spans:
        if s["name"] != "device.wait":
            continue
        # the nearest enclosing dispatch, if any, pays for this wait
        p = s.get("parent_id")
        while p is not None and p not in dispatch:
            p = parent.get(p)
        if p is not None:
            waited += s["dur_ms"]
    return (sum(dispatch.values()) - waited) / n
