"""Dom-ST's whole step: model FLOPs (``bench/work.py``: three forwards a
window, the contractions' multiply-adds) of the timed window's steps, over
its time and the H100's float32 peak outside the tensor cores (TF32 is
off), %."""
from bench import work


def read(ctx):
    if ctx.units != "windows":
        return None
    flops = work.train_flops(work.domst_forward_flops(
        ctx.config["model"]["domst"]))
    return 100.0 * flops * ctx.rate() / work.FP32_OPS_PER_S
