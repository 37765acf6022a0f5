"""The causal depthwise conv1d kernel (``kernels/csrc/conv1d.cu``) with
SiLU at the LM training shape (a launch a layer in the forward and again
in remat's recompute): the least time of its launches in the traced
window over their device time, %."""
from bench import work
from bench.harness import roofline


def read(ctx):
    m, t = ctx.config["model"], ctx.traffic
    s = m["ssm"]
    C = s["expand"] * m["d_model"] + 2 * s["ngroups"] * s["state_dim"]
    esize = 2 if t["dtype"] == "bfloat16" else 4
    least = work.least_s(work.conv1d_work(
        t["batch"] // t["accum_steps"], t["seq"], C, s["conv_width"], esize,
        True))
    return roofline(ctx, "conv1d_kernel", least)
