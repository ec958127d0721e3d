"""engine_ms.analytic: host milliseconds a query in the device engine's
spans (device.lower, device.dispatch, device.collect) over the window
(device.dispatch holds the plan's run and its waits for the device's
counts; device.collect the readback)."""


def read(ctx):
    spans = ctx.get("spans")
    n = ctx.get("requests")
    if not spans or not n:
        return None
    ms = [s["dur_ms"] for s in spans
          if s["name"] in ("device.lower", "device.dispatch", "device.collect")]
    if not ms:
        return None
    return sum(ms) / n
