"""Dom-ST training throughput: every window of the steps the timed window
completed, over the time they took (host clock, the device waited for)."""


def read(ctx):
    return ctx.rate() if ctx.units == "windows" else None
