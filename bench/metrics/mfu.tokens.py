"""An LM's whole step: model FLOPs (``bench/work.py``: three forwards a
token, remat's recompute not counted) of the timed window's steps, over
its time and the H100's bfloat16 tensor-core peak, %."""
from bench import work


def read(ctx):
    if ctx.units != "tokens":
        return None
    flops = work.train_flops(work.mamba2_forward_flops_per_token(
        ctx.config["model"], ctx.traffic["seq"]))
    return 100.0 * flops * ctx.rate() / work.BF16_OPS_PER_S
