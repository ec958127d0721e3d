"""fixpoint_rounds: DeviceFixpoint.last_rounds of each job in the
window, averaged over the jobs (an exact count a job)."""


def read(ctx):
    rounds = ctx.get("rounds")
    if not rounds:
        return None
    return sum(rounds) / len(rounds)
