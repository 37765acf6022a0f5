"""Serving launcher, Dom-ST forecast mode.

The stacked multi-watershed params — from the port's own init, or the
``params`` subtree of a checkpoint the reference's training launcher wrote
(``--ckpt``; optimizer moments are never loaded) — roll forward day by day
over the held-out forcing windows through :class:`Forecaster`, reporting
per-watershed NSE against observed discharge. Runs on the card unless
``--device cpu`` is given; without a card it raises.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch domst
  PYTHONPATH=src python -m repro_torch.launch.serve --arch domst \\
      --watersheds 2 --days 150 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.checkpoint import restore_subtree
from repro_torch.configs import get_config
from repro_torch.core import domst
from repro_torch.data.pipeline import make_domst_windows, stacked_test_batch
from repro_torch.device import device_name
from repro_torch.serve.forecast import Forecaster


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_domst(args) -> dict:
    cfg = get_config(args.arch)
    fc = Forecaster(cfg, device=args.device)
    windows = make_domst_windows(args.watersheds, args.days)
    params = domst.init(cfg, torch.Generator().manual_seed(args.seed),
                        len(windows))
    if args.ckpt:
        # params subtree of the full training state the trainer saved
        params = restore_subtree(args.ckpt, params, prefix="params")
    held = stacked_test_batch(windows)
    params = fc.place_params(params)
    placed = fc.place_batch(held)
    fc.forecast(params, placed)          # warm-up: builds and loads kernels
    _sync(fc.device)
    t0 = time.perf_counter()
    res = fc.forecast(params, placed)
    _sync(fc.device)
    wall = time.perf_counter() - t0
    nses = [round(float(x), 6) for x in res["nse"].cpu().numpy()]
    horizon = int(held["discharge"].shape[1])
    out = {"arch": cfg.name, "watersheds": len(windows),
           "horizon_days": horizon, "restored": bool(args.ckpt),
           "nse": nses, "mean_nse": round(float(np.mean(nses)), 6),
           "wall_s": round(wall, 3),
           "forecasts_per_s": round(len(windows) * horizon / wall, 1),
           "device": device_name(fc.device)}
    print(json.dumps(out))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    help="a Dom-ST variant: domst, domst-singlehead, "
                         "domst-singlehead-p")
    ap.add_argument("--ckpt", default="",
                    help="npz checkpoint whose 'params/...' entries to serve")
    ap.add_argument("--watersheds", type=int, default=23)
    ap.add_argument("--days", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    if not args.arch.startswith("domst"):
        ap.error(f"--arch {args.arch}: only the Dom-ST forecast is ported")
    return serve_domst(args)


if __name__ == "__main__":
    main()
