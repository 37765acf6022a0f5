"""The weights a cell trains from, made from its seed on the device: one
normal draw and one uniform draw for the whole model, cut into leaves
and scaled by the init law of the port's configurations (normal with
std 1/sqrt(fan-in), fan-in the leaf's second-to-last axis in the
reference's packed layout; biases 0; norm scales and the SSM skip 1;
``A_log`` uniform on [-1, 1]; the embedding normal with std 0.02).

The same seed on the same device gives the same tensors, so the
benchmark hands them to the program and makes them again, after the
program is gone, for the reference. Leaves are keyed as the port's flat
parameter dicts are, in the port's layout (the LSTM's gate-split
weights, Pix-Con's ``w2`` without its unit axis).
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import torch

# (key, shape, init, std); init is "normal", "uniform", "zeros" or "ones"
Leaf = Tuple[str, Tuple[int, ...], str, float]


def domst_leaves(dc: Mapping, replicas: int) -> List[Leaf]:
    """Dom-ST's stacked leaves for ``replicas`` watersheds."""
    P, G, K = dc["num_pixels"], dc["num_heads"], dc["kernel_size"]
    C, H, M = dc["cnn_channels"], dc["lstm_hidden"], dc["mlp_hidden"]
    R = replicas
    out: List[Leaf] = []
    if dc["use_pixcon"]:
        hp = dc["pixcon"]["hidden"]
        out += [("pixcon/w1", (R, 4, hp), "normal", 4 ** -0.5),
                ("pixcon/b1", (R, hp), "zeros", 0.0),
                ("pixcon/w2", (R, hp), "normal", hp ** -0.5),
                ("pixcon/b2", (R, 1), "zeros", 0.0)]
    out += [("spatial/conv_w", (R, G, K, P // G, C), "normal",
             (P // G) ** -0.5),
            ("spatial/conv_b", (R, G, C), "zeros", 0.0),
            ("spatial/conv2_w", (R, G, K, C, C), "normal", C ** -0.5),
            ("spatial/conv2_b", (R, G, C), "zeros", 0.0)]
    d = G * C
    for l in range(dc["lstm_layers"]):
        out += [(f"temporal/lstm{l}/wx", (R, d, 4, H), "normal", d ** -0.5),
                (f"temporal/lstm{l}/wh", (R, H, 4, H), "normal", H ** -0.5),
                (f"temporal/lstm{l}/b", (R, 4, H), "zeros", 0.0)]
        d = H
    head = H + (P if dc["use_target_day"] else 0)
    out += [("temporal/fc1", (R, head, M), "normal", head ** -0.5),
            ("temporal/fc1_b", (R, M), "zeros", 0.0),
            ("temporal/fc2", (R, M, 1), "normal", M ** -0.5),
            ("temporal/fc2_b", (R, 1), "zeros", 0.0)]
    return out


def padded_vocab(vocab: int, multiple: int = 128) -> int:
    return -(-vocab // multiple) * multiple


def mamba2_leaves(m: Mapping) -> List[Leaf]:
    """A Mamba-2 LM's leaves (tied embedding, one SSM mixer a layer)."""
    d = m["d_model"]
    s = m["ssm"]
    di = s["expand"] * d
    H = di // s["head_dim"]
    GN = s["ngroups"] * s["state_dim"]
    K = s["conv_width"]
    out: List[Leaf] = [
        ("embed/embedding", (padded_vocab(m["vocab_size"]), d), "normal",
         0.02),
        ("final_norm/scale", (d,), "ones", 0.0)]
    for i in range(m["num_layers"]):
        pre = f"layers/{i}/"
        out += [(pre + "norm1/scale", (d,), "ones", 0.0),
                (pre + "ssm/w_in_x", (d, di), "normal", d ** -0.5),
                (pre + "ssm/w_in_z", (d, di), "normal", d ** -0.5),
                (pre + "ssm/w_in_B", (d, GN), "normal", d ** -0.5),
                (pre + "ssm/w_in_C", (d, GN), "normal", d ** -0.5),
                (pre + "ssm/w_in_dt", (d, H), "normal", d ** -0.5),
                (pre + "ssm/dt_bias", (H,), "zeros", 0.0),
                (pre + "ssm/A_log", (H,), "uniform", 1.0),
                (pre + "ssm/D", (H,), "ones", 0.0),
                (pre + "ssm/conv_w", (K, di + 2 * GN), "normal", K ** -0.5),
                (pre + "ssm/conv_b", (di + 2 * GN,), "zeros", 0.0),
                (pre + "ssm/out_norm/scale", (di,), "ones", 0.0),
                (pre + "ssm/w_out", (di, d), "normal", di ** -0.5)]
    return out


def make(leaves: List[Leaf], seed: int,
         device: torch.device) -> Dict[str, torch.Tensor]:
    """float32 tensors on ``device`` for ``leaves``, drawn from ``seed``:
    one normal and one uniform draw over all the leaves of each kind."""
    g = torch.Generator(device=device).manual_seed(seed)
    sizes = {kind: sum(math.prod(s) for _, s, k, _ in leaves if k == kind)
             for kind in ("normal", "uniform")}
    pools = {"normal": torch.randn(sizes["normal"], generator=g,
                                   device=device),
             "uniform": torch.rand(sizes["uniform"], generator=g,
                                   device=device) * 2 - 1}
    at = {"normal": 0, "uniform": 0}
    out = {}
    for key, shape, kind, std in leaves:
        if kind in ("zeros", "ones"):
            out[key] = (torch.zeros if kind == "zeros" else torch.ones)(
                shape, device=device)
            continue
        n = math.prod(shape)
        out[key] = pools[kind][at[kind]:at[kind] + n].view(shape).mul_(std)
        at[kind] += n
    return out


def nest(flat: Mapping[str, torch.Tensor]) -> Dict:
    """A flat dict keyed by '/'-joined paths as a nested tree, numeric
    path parts as list indices (the LM layer stack)."""
    tree: Dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v

    def lists(t):
        if not isinstance(t, dict):
            return t
        if t and all(k.isdigit() for k in t):
            return [lists(t[str(i)]) for i in range(len(t))]
        return {k: lists(v) for k, v in t.items()}
    return lists(tree)
