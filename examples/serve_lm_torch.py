"""Batched serving demo, PyTorch port: continuous batching through the
paged inference engine on the reduced config of each decodable family
(dense / MoE / SSM / hybrid / local-global), with ragged prompts, slot
reuse, 8-token pages, chunked prefill (8 tokens at a time between
decodes) and speculative decoding (``spec_k=3`` n-gram drafts verified in
one fused paged forward; greedy streams are the same as without it). On
the card the paged-attention, local-attention, conv1d and SSD-chunk
kernels serve them.

The second half is a shared-system-prompt workload: every prompt opens
with the same 24 tokens, served with the prefix cache and page-aware
preemption on (``--prefix-cache --preempt``). Later requests map the
cached prefix pages and skip that prefill; the demo prints the hit rate.
The recurrent arch resumes from its prefix snapshots.

    PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402

FAMILIES = ("qwen2-1.5b", "deepseek-moe-16b", "mamba2-130m",
            "recurrentgemma-2b", "gemma2-2b")
SHARED_PREFIX = ("qwen2-1.5b", "recurrentgemma-2b")


class Args:
    """The demo's settings where they differ from the serve CLI's
    defaults; ``serve`` fills every other field from those."""
    smoke = True
    requests = 6
    batch_size = 3
    prompt_len = 16
    gen = 12
    page_size = 8          # paged KV pool (0 = contiguous slot-major cache)
    prefill_chunk = 8      # admit prompts 8 tokens at a time between decodes
    spec_k = 3             # draft-and-verify: up to 3 n-gram drafts a step
    ragged = True


def family_args(arch: str, device="cuda", ckpt: str = "") -> Args:
    """The first half's run of ``arch``: chunked prefill and n-gram
    speculation on ragged prompts."""
    a = Args()
    a.arch, a.device, a.ckpt = arch, device, ckpt
    return a


def shared_prefix_args(arch: str, device="cuda", ckpt: str = "") -> Args:
    """The second half's run of ``arch``: 24 of each prompt's 32 tokens a
    shared prefix, the prefix cache and preemption on, uniform lengths so
    the prefix stays page-aligned, no speculation."""
    a = family_args(arch, device, ckpt)
    a.prompt_len, a.shared_prefix = 32, 24
    a.prefix_cache = a.preempt = True
    a.ragged = False
    a.spec_k = 0
    return a


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    resolve_device(args.device)          # raises before any work without a card
    out = {"families": {}, "shared_prefix": {}}
    for arch in FAMILIES:
        print(f"--- {arch} (reduced config) ---")
        out["families"][arch] = serve(family_args(arch, args.device))
    for arch in SHARED_PREFIX:
        print(f"--- {arch} + shared system prompt (prefix cache) ---")
        r = out["shared_prefix"][arch] = serve(
            shared_prefix_args(arch, args.device))
        print(f"prefix-cache hit rate: {r['prefix_hit_rate']:.0%} "
              f"({r['prefix_hit_tokens']} prefill tokens skipped, "
              f"{r['prefix_hits']} hits, {r['cow_pages']} CoW pages, "
              f"{r['preemptions']} preemptions)")
    return out


if __name__ == "__main__":
    main()
