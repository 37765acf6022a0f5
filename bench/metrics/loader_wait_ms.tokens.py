"""The input pipeline (``data/loader.py``, ``data/pipeline.py``): mean host
time a step waits in ``next()`` on the ``ShardedLoader`` over the timed
window, ms."""


def read(ctx):
    return ctx.spans.mean_ms("loader_wait") if ctx.units == "tokens" else None
