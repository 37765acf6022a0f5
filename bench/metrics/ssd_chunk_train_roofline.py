"""The SSD-chunk kernel (``kernels/csrc/ssd_chunk.cu``) at the LM training
shape (a launch a layer in the forward and again in remat's recompute):
the least time of its launches in the traced window (bytes once over
HBM, or operations over the tensor-core peak in bfloat16) over their
device time, %."""
from bench import work
from bench.harness import roofline


def read(ctx):
    m, t = ctx.config["model"], ctx.traffic
    s = m["ssm"]
    Q = min(s["chunk_size"], t["seq"])
    H = s["expand"] * m["d_model"] // s["head_dim"]
    bf16 = t["dtype"] == "bfloat16"
    least = work.least_s(
        work.ssd_work(t["batch"] // t["accum_steps"], -(-t["seq"] // Q), Q, H,
                      s["state_dim"], s["head_dim"], 2 if bf16 else 4),
        work.BF16_OPS_PER_S if bf16 else work.FP32_OPS_PER_S)
    return roofline(ctx, "ssd_chunk", least)
