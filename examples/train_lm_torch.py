"""LM-side end-to-end driver, PyTorch port: train an assigned architecture
(mamba2-130m by default) on the synthetic token stream through the
engine, batches prefetched by the ``ShardedLoader``; on the card its
forward runs the causal conv1d and SSD-chunk kernels. Without ``--full``
the config is cut to a mid size (a quarter of the layers, at least 4; a
vocabulary of at most 8,192) that fits a CPU's budget; ``--full`` trains
the real 130M config.

    PYTHONPATH=src python examples/train_lm_torch.py [--full] [--steps 300] [--device cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.convert import flatten  # noqa: E402
from repro_torch.data.loader import ShardedLoader  # noqa: E402
from repro_torch.data.tokens import TokenSource  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.train import Engine  # noqa: E402


def mid_size(cfg):
    """The family kept, cut to fit a CPU training budget."""
    return cfg.replace(num_layers=max(4, cfg.num_layers // 4),
                       vocab_size=min(cfg.vocab_size, 8192))


def train_lm(cfg, params, *, steps: int = 300, batch: int = 8,
             seq: int = 256, accum_steps: int = 1, device="cuda",
             dtype: torch.dtype = torch.bfloat16) -> list:
    """``steps`` AdamW steps (block remat, ``dtype`` activations, the
    state donated through the step, ``accum_steps`` microbatches a step)
    from ``params`` (the per-layer tree ``transformer.init`` gives) on
    ``TokenSource(cfg, batch, seq)``. Returns the loss of every step."""
    tc = TrainConfig(learning_rate=6e-4, total_steps=steps,
                     warmup_steps=steps // 10, remat="block")
    engine = Engine.for_lm(cfg, tc, accum_steps=accum_steps, device=device,
                           dtype=dtype)
    state = engine.init_state(params)
    loader = ShardedLoader(TokenSource(cfg, batch, seq), engine, prefetch=2,
                           num_steps=steps)
    losses, t0 = [], time.perf_counter()
    for b in loader:
        state, m = engine.step(state, b)
        losses.append(float(m["loss"]))
        i = loader.cursor - 1
        if i % max(steps // 15, 1) == 0:
            print(f"step {i:4d}  loss {losses[-1]:.4f}  "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    print(f"done: loss {losses[-1]:.4f} (start {losses[0]:.4f}) in "
          f"{time.perf_counter() - t0:.0f}s")
    return losses


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--full", action="store_true",
                    help="use the full config (slow on a CPU)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum-steps", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = mid_size(cfg)
    params = tfm.init(cfg, torch.Generator(device=dev).manual_seed(0))
    n = sum(v.numel() for v in flatten(params).values())
    print(f"{cfg.name}: {n / 1e6:.1f}M params, {args.steps} steps, "
          f"batch {args.batch} x seq {args.seq}")
    losses = train_lm(cfg, params, steps=args.steps, batch=args.batch,
                      seq=args.seq, accum_steps=args.accum_steps, device=dev)
    return {"arch": cfg.name, "losses": losses}


if __name__ == "__main__":
    main()
