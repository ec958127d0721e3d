"""device_idle_pct.rsp: the share of the traced window in which no
operation ran on the card (the union of the profiler's device intervals):
how far the host's stream path holds the card back."""


def read(ctx):
    t = ctx.get("timeline")
    if not t or t["window_s"] <= 0 or not t["ops"]:
        return None
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]
