"""The benchmark's yardstick arithmetic: the H100's published peaks, the
least time of a piece of work, the bytes and operations of each kernel
launch at its shape, and the model FLOPs of a training step.

``bound_ms``, ``pixcon_work``, ``lstm_work``, ``conv1d_work`` and
``ssd_work`` are frozen copies of ``chip_smoke.py``'s (a test holds them
equal). The model FLOP counts are this file's own: the multiply-adds of
every contraction the forward needs, times two, and a training step is
three forwards (the backward two); recomputation (remat) is not counted.
"""
from __future__ import annotations

from typing import Mapping

# NVIDIA H100 SXM, data sheet (dense): HBM rate and float32 rate outside
# the tensor cores (the kernels do fp32 FMAs on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12       # tensor cores, dense


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """Least time for the work on the card: bytes moved once over HBM, or
    operations over the peak rate of their type (fp32 outside the tensor
    cores unless given), whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pixcon_work(R, B, T, P, F=4, Hp=32) -> tuple[float, float]:
    """Bytes (each input read once, each output written once) and fp32
    operations of one Pix-Con gate; tanh, exp and a division count as one."""
    nbytes = 4 * (2 * R * B * T * P + R * B * P * F + R * (F * Hp + 2 * Hp + 1)
                  + R * B * P)
    per_pixel = Hp * (2 * F + 1 + 1 + 2) + 1 + 1 + 3 + 2
    return nbytes, R * B * (P * per_pixel + T * P)


def lstm_work(R, B, D, H) -> tuple[float, float]:
    """Bytes and fp32 operations of one LSTM step (every replica's weights
    read once); sigmoid and tanh count as one operation each."""
    nbytes = 4 * (R * B * D + 4 * R * B * H + R * 4 * H * (D + H + 1))
    return nbytes, R * B * H * (4 * 2 * (D + H) + 4 * 2 + 5 + 5)


def conv1d_work(B, S, C, K, esize, silu) -> tuple[float, float]:
    """Bytes (x, w, b read once, y written once) and fp32 operations (K
    multiplies and adds, the bias, and SiLU's exp, add, divide, multiply)
    of one causal conv."""
    nbytes = esize * (2 * B * S * C + K * C + C)
    return nbytes, B * S * C * (2 * K + 1 + (4 if silu else 0))


def ssd_work(B, nc, Q, H, N, P, esize) -> tuple[float, float]:
    """Bytes (C, B, xdt, dA read once, y and the float32 state written
    once) and operations: per (chunk, head), C.B (2N), the decay (3) and
    the P.xdt product (2P) over the Q(Q+1)/2 causal pairs, and the state's
    2PN per row plus its decay (N + 2)."""
    nbytes = (esize * B * nc * Q * H * (2 * N + 2 * P) + 4 * B * nc * H * Q
              + 4 * B * nc * H * P * N)
    pairs = Q * (Q + 1) / 2
    ops = B * nc * H * (pairs * (2 * N + 3 + 2 * P) + Q * (2 * P * N + N + 2))
    return nbytes, ops


def least_s(work: tuple[float, float],
            ops_per_s: float = FP32_OPS_PER_S) -> float:
    """``bound_ms`` of a (bytes, operations) pair, in seconds."""
    return bound_ms(*work, ops_per_s)[0] * 1e-3


# -- model FLOPs -------------------------------------------------------------
def domst_forward_flops(dc: Mapping) -> int:
    """FLOPs of one window through Dom-ST's forward (``dc``: the
    configuration's ``domst`` group): the Pix-Con MLP over the pixels, the
    two SAME convs of every head, the LSTM's gate products over the days,
    and the head (with the target day's pixels where it takes them)."""
    P, T, G = dc["num_pixels"], dc["window_days"], dc["num_heads"]
    C, K, H = dc["cnn_channels"], dc["kernel_size"], dc["lstm_hidden"]
    M = dc["mlp_hidden"]
    macs = 0
    if dc["use_pixcon"]:
        hp = dc["pixcon"]["hidden"]
        macs += P * (4 * hp + hp)
    macs += G * T * K * (P // G) * C          # first conv of every head
    macs += G * T * K * C * C                 # second conv
    d = G * C
    for _ in range(dc["lstm_layers"]):
        macs += T * (d + H) * 4 * H
        d = H
    head_in = H + (P if dc["use_target_day"] else 0)
    macs += head_in * M + M
    return 2 * macs


def mamba2_forward_flops_per_token(m: Mapping, seq: int) -> float:
    """FLOPs of one token through a Mamba-2 LM's forward (``m``: the
    configuration's ``model`` group): per layer the five input
    projections, the depthwise conv, the SSD dual form (C.B and the
    weighted sum over the causal pairs of a chunk, the chunk's state and
    its read-out; the inter-chunk scan per chunk) and the out projection;
    then the tied head over the real vocabulary."""
    d = m["d_model"]
    s = m["ssm"]
    di = s["expand"] * d
    H = di // s["head_dim"]
    N, P, G = s["state_dim"], s["head_dim"], s["ngroups"]
    Q = min(s["chunk_size"], seq)
    conv_dim = di + 2 * G * N
    per_layer = (d * (2 * di + 2 * G * N + H)          # in projections
                 + conv_dim * s["conv_width"]           # depthwise conv
                 + H * ((Q + 1) / 2 * (N + P)           # causal pairs
                        + 2 * P * N                     # state, read-out
                        + P * N / Q)                    # inter-chunk scan
                 + di * d)                              # out projection
    return 2 * (m["num_layers"] * per_layer + d * m["vocab_size"])


def train_flops(forward: float) -> float:
    """A training step's model FLOPs: forward and backward (twice the
    forward), remat's recompute not counted."""
    return 3 * forward
