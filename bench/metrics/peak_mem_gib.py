"""The card's peak allocated memory over the timed window
(``torch.cuda.max_memory_allocated`` after a reset at its start), GiB."""


def read(ctx):
    b = ctx.window["peak_bytes"]
    return b / 2 ** 30 if b else None
