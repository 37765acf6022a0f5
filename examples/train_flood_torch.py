"""End-to-end driver (the paper's kind), PyTorch port: every watershed's
replica trained at once through the IP-D pipeline (a leading watershed
axis, one stacked step; the Pix-Con and LSTM-step kernels on the card),
then the Singlehead ablation the same way; the held-out NSE per
watershed and the share of watersheds on which Dom-ST beats Singlehead.

    PYTHONPATH=src python examples/train_flood_torch.py [--watersheds 23] [--device cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.core import domst  # noqa: E402
from repro_torch.data.loader import ShardedLoader  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    InputPipeline, StackedSource, make_training_windows, stacked_test_batch,
    train_split,
)
from repro_torch.data.synthetic_hydro import generate_all_watersheds  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.train import Engine  # noqa: E402


def train_stacked(cfg_name, windows, ip, epochs, *, device="cuda",
                  params=None):
    """``epochs`` epochs of stacked AdamW steps of ``cfg_name`` from
    ``params`` (the port's stacked params; by default its init, seed 0),
    batches prefetched two steps ahead by the ``ShardedLoader`` (paper
    Fig. 2a "I.P."). Returns (held-out NSE per watershed, steps taken,
    the per-watershed loss of every step (steps, W))."""
    cfg = get_config(cfg_name)
    tc = TrainConfig(learning_rate=3e-3, total_steps=epochs * 60,
                     warmup_steps=20)
    engine = Engine.for_domst(cfg, tc, stacked=True, device=device)
    if params is None:
        params = domst.init(cfg, torch.Generator().manual_seed(0),
                            len(windows))
    state = engine.init_state(params)
    source = StackedSource(ip)
    loader = ShardedLoader(source, engine, prefetch=2,
                           num_steps=epochs * source.steps_per_epoch)
    losses = []
    for b in loader:
        state, m = engine.step(state, b)
        losses.append(m["loss"])
    # held-out NSE per watershed straight off the live state
    ev = engine.eval_step(state,
                          engine.place_batch(stacked_test_batch(windows)))
    return (ev["nse"].cpu().numpy(), int(state.step),
            torch.stack(losses).cpu().numpy())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--watersheds", type=int, default=23)
    ap.add_argument("--days", type=int, default=400)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    resolve_device(args.device)          # raises before any work without a card

    data = generate_all_watersheds(args.watersheds, num_days=args.days)
    windows = [make_training_windows(w) for w in data.values()]
    # train on the leading split; eval_step scores the held-out tail
    ip = InputPipeline([train_split(w) for w in windows], batch_size=64)
    print(f"{len(windows)} watersheds (paper: 23), {args.epochs} epochs, "
          f"IP-D stacked execution")

    out = {}
    for name in ("domst", "domst-singlehead"):
        t0 = time.perf_counter()
        nse, steps, losses = train_stacked(name, windows, ip, args.epochs,
                                           device=args.device)
        wall = time.perf_counter() - t0
        print(f"{name}: {steps} steps in {wall:.1f}s  mean NSE "
              f"{nse.mean():.3f}  min {nse.min():.3f}  max {nse.max():.3f}")
        out[name] = {"nse": nse.tolist(), "steps": steps, "wall_s": wall,
                     "losses": losses.tolist()}
    dom = np.asarray(out["domst"]["nse"])
    sh = np.asarray(out["domst-singlehead"]["nse"])
    for w, (a, b) in enumerate(zip(dom, sh)):
        print(f"watershed {w:2d}: Dom-ST NSE {a:.4f}  Singlehead NSE {b:.4f}")
    out["win_share"] = float((dom > sh).mean())
    print(f"Dom-ST beats Singlehead on {out['win_share'] * 100:.0f}% of "
          f"watersheds (paper: 'almost all')")
    return out


if __name__ == "__main__":
    main()
