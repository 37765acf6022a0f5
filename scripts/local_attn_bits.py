#!/usr/bin/env python3
"""Outputs of the local-attention kernel at the no-softcap cases of
``chip_smoke.py`` phase 2, for comparing two trees bit for bit on one
NVIDIA GPU.

    python3 scripts/local_attn_bits.py SRC OUT.pt [OTHER.pt]

Runs ``local_attention_fused`` of the tree whose ``src`` is SRC (its
kernel built from that tree's sources) on recurrentgemma-2b's 2,560- and
600-token prefills and the four ragged shapes, float32 and bf16, inputs
drawn from a fixed seed, with no softcap argument (so a tree from before
the softcap runs too), and saves the outputs to OUT.pt. Given OTHER.pt,
saved from another tree, it prints for every case whether the two
outputs are equal to the bit, and exits 1 if any is not.
"""
from __future__ import annotations

import sys
from pathlib import Path

CASES = [
    ("rg_prefill_2560", 1, 2560, 10, 1, 256, 2048, True),
    ("rg_prefill_600", 1, 600, 10, 1, 256, 2048, True),
    ("ragged_gqa", 1, 77, 8, 2, 128, 33, True),
    ("noncausal_mqa", 2, 77, 8, 1, 128, 33, False),
    ("noncausal_nogroup", 2, 100, 4, 4, 64, 16, False),
    ("window_ge_s", 1, 50, 4, 1, 64, 64, False),
]


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 3:
        print(__doc__.splitlines()[3], file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(sys.argv[1]).resolve()))
    from repro_torch.kernels.local_attn.ops import local_attention_fused

    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(2024)
    outs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, S, Hq, Hkv, D, window, causal in CASES:
            q, k, v = (
                torch.randn(B, S, h, D, generator=g).to(dev, dtype)
                for h in (Hq, Hkv, Hkv)
            )
            out = local_attention_fused(q, k, v, window=window, causal=causal)
            outs[f"{name} {str(dtype)[6:]}"] = out.cpu()
    torch.save(outs, sys.argv[2])
    if len(sys.argv) < 4:
        return 0
    other = torch.load(sys.argv[3])
    same = {key: torch.equal(out, other[key]) for key, out in outs.items()}
    for key, eq in same.items():
        print(f"local_attn {key}: {'equal to the bit' if eq else 'DIFFERS'}")
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
