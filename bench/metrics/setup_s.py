"""Set-up: from the start of the process to the first timed step (data,
weights, the kernels' build or load, the first steps)."""


def read(ctx):
    return ctx.setup_s
