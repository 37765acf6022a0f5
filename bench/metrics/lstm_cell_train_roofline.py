"""The LSTM-step kernel (``kernels/csrc/lstm_cell.cu``) at Dom-ST's stacked
training shapes (a launch a day a layer; the first layer's input is the
heads' features, the others' the hidden state): the least time of its
launches in the traced window over their device time, %."""
from bench import work
from bench.harness import roofline


def read(ctx):
    dc, t = ctx.config["model"]["domst"], ctx.traffic
    R, B, H = t["watersheds"], t["batch"], dc["lstm_hidden"]
    dims = [dc["num_heads"] * dc["cnn_channels"]] + \
        [H] * (dc["lstm_layers"] - 1)
    per_launch = sum(work.least_s(work.lstm_work(R, B, D, H))
                     for D in dims) / len(dims)
    return roofline(ctx, "lstm_cell_kernel", per_launch)
