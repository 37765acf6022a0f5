#!/usr/bin/env python3
"""The SSD-chunk kernel's float32 tile-edge check of ``chip_smoke.py``
phase 2, over many random draws, against float64, on one NVIDIA GPU.

    python3 scripts/ssd_chunk_edge_f64.py [DRAWS]

For each of DRAWS generators (seeds 0, 1, ...), draws phase 2's 60
tile-edge cases (``check_ssd_chunk``'s ``edges``: Q from 1 to 256, N in
{16, 20, 128}, P in {24, 64}, 2 batch rows of 2 chunks) with
``chip_smoke.ssd_inputs`` in float32, runs the kernel and its plain
version, and computes the same formula in float64. For each case it
records the kernel's largest difference from the plain version over the
check's bound (``ATOL_KERNEL + RTOL_F32_EDGE |y|``: above 1, the check
fails), and the kernel's and the plain version's largest error against
float64 in units of float32 eps times the sum of the absolute terms of
that output (the scale of a float32 sum's rounding). Prints one JSON
line: the cases over the bound, and the largest of each measure by Q.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def exact(a: dict):
    """(y, sum of |terms|) of the plain version's formula in float64,
    laid out as its y: (B, nc, Q, H, P)."""
    import torch
    C = a["Cc"].double().permute(0, 1, 3, 2, 4)
    Bm = a["Bc"].double().permute(0, 1, 3, 2, 4)
    x = a["xdt"].double().permute(0, 1, 3, 2, 4)
    dA = a["dA_cs"].double()
    Q = dA.shape[-1]
    seg = dA[..., :, None] - dA[..., None, :]
    lower = torch.ones((Q, Q), dtype=torch.bool, device=dA.device).tril()
    L = torch.exp(torch.where(lower, seg, float("-inf")))
    y = (C @ Bm.transpose(-1, -2) * L) @ x
    mag = (C.abs() @ Bm.abs().transpose(-1, -2) * L) @ x.abs()
    return y.permute(0, 1, 3, 2, 4), mag.permute(0, 1, 3, 2, 4)


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    draws = int(argv[0]) if argv else 20
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.ssd_chunk.ops import ssd_chunk_fused
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    eps = torch.finfo(torch.float32).eps
    edges = [(Q, N, P) for N in (16, 20, 128) for P in (24, 64)
             for Q in (1, 15, 16, 17, 63, 64, 65, 129, 200, 256)]
    over, by_q = [], {}
    for seed in range(draws):
        g = torch.Generator().manual_seed(seed)
        for Q, N, P in edges:
            a = cs.ssd_inputs(g, dev, torch.float32, 2, 2, Q, 3, N, P)
            y, _ = ssd_chunk_fused(**a)
            ry, _ = ssd_chunk_ref(**a)
            ey, mag = exact(a)
            y, ry = y.double(), ry.double()
            bound = cs.ATOL_KERNEL + cs.RTOL_F32_EDGE * ry.abs()
            kp = float(((y - ry).abs() / bound).max())
            scale = eps * mag.clamp(min=1e-30)
            ke = float(((y - ey).abs() / scale).max())
            pe = float(((ry - ey).abs() / scale).max())
            row = by_q.setdefault(Q, {"kernel_vs_plain_over_bound": 0.0,
                                      "kernel_err_eps_sum": 0.0,
                                      "plain_err_eps_sum": 0.0, "cases": 0})
            row["kernel_vs_plain_over_bound"] = max(
                row["kernel_vs_plain_over_bound"], kp)
            row["kernel_err_eps_sum"] = max(row["kernel_err_eps_sum"], ke)
            row["plain_err_eps_sum"] = max(row["plain_err_eps_sum"], pe)
            row["cases"] += 1
            if kp > 1:
                over.append({"seed": seed, "Q": Q, "N": N, "P": P,
                             "over_bound": kp, "kernel_err_eps_sum": ke,
                             "plain_err_eps_sum": pe})
    out = {"draws": draws, "cases": draws * len(edges),
           "over_bound": over, "by_q": by_q,
           "device": torch.cuda.get_device_name(0)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
