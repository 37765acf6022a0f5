"""LM training throughput: every token of the steps the timed window
completed, over the time they took (host clock, the device waited for)."""


def read(ctx):
    return ctx.rate() if ctx.units == "tokens" else None
