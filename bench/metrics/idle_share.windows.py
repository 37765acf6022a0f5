"""The device: the share of the traced window in which no kernel, copy or
set ran on the card (the union of the profiler's device intervals), %."""
from bench.harness import idle_share


def read(ctx):
    return idle_share(ctx) if ctx.units == "windows" else None
