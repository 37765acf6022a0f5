"""The engine (``train/engine.py``, ``optim/``): mean host time inside
``Engine.step`` a call over the timed window (no wait for the device is
added), ms."""


def read(ctx):
    return ctx.spans.mean_ms("dispatch") if ctx.units == "tokens" else None
