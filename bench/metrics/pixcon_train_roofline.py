"""The Pix-Con gate kernel (``kernels/csrc/pixcon.cu``) at Dom-ST's stacked
training shape: the least time of its launches in the traced window
(``bench/work.py``: bytes once over HBM or fp32 operations over the peak)
over their device time, %."""
from bench import work
from bench.harness import roofline


def read(ctx):
    dc, t = ctx.config["model"]["domst"], ctx.traffic
    if not dc["use_pixcon"]:
        return None
    least = work.least_s(work.pixcon_work(
        t["watersheds"], t["batch"], dc["window_days"], dc["num_pixels"],
        4, dc["pixcon"]["hidden"]))
    return roofline(ctx, "pixcon_gate_kernel", least)
