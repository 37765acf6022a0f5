"""Quickstart, PyTorch port: the paper's Dom-ST model on one synthetic
watershed, trained through the seed-era step API (``domst.make_train_step``)
on the Pix-Con and LSTM-step kernels.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.core import domst  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    make_training_windows, train_test_split,
)
from repro_torch.data.synthetic_hydro import generate_watershed  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402

STEPS, BATCH = 300, 64


def data():
    """(train, test) batches of watershed 0's 30-day windows."""
    windows = make_training_windows(generate_watershed(0, num_days=365),
                                    window=30)
    print(f"watershed 0: {windows.precip.shape[0]} windows, "
          f"{windows.precip.shape[2]} pixels")
    return train_test_split(windows)


def train_single(cfg, params, train, test, *, steps: int = STEPS,
                 device="cuda"):
    """``steps`` AdamW steps on minibatches of 64 drawn by
    ``np.random.default_rng(0)``, then the held-out NSE. ``params``: the
    port's single-mode params (replica axis R=1) on ``device``. Returns
    (params, the loss of every step, the test NSE)."""
    tc = TrainConfig(learning_rate=3e-3, total_steps=STEPS, warmup_steps=10)
    step = domst.make_train_step(cfg, tc, device=device)
    opt = make_optimizer(tc)[0](params)
    rng = np.random.default_rng(0)
    n = len(train["discharge"])
    losses = []
    for i in range(steps):
        sl = rng.integers(0, n, BATCH)
        params, opt, m = step(params, opt, {k: v[sl] for k, v in train.items()})
        losses.append(m["loss"])
        if i % 50 == 0:
            print(f"step {i:4d}  mse {float(m['loss']):.4f}")
    dev = resolve_device(device)
    with torch.no_grad():
        ev = domst.evaluate(params, cfg, {k: torch.as_tensor(v)[None].to(dev)
                                          for k, v in test.items()})
    return params, torch.stack(losses).tolist(), float(ev["nse"][0])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # 1. data: pixellated precipitation + distance prior + discharge labels
    train, test = data()
    # 2. model: Pix-Con -> partitioned multihead CNN -> stacked LSTM (+P)
    cfg = get_config("domst")
    params = domst.init(cfg, torch.Generator().manual_seed(0), 1, device=dev)
    print(f"params: {sum(v.numel() for v in params.values()):,}")
    # 3. train, 4. evaluate with the paper's metric (Nash–Sutcliffe)
    _, losses, nse = train_single(cfg, params, train, test, device=dev)
    print(f"test NSE = {nse:.3f}  (1.0 = perfect, 0.0 = predicting the mean)")
    return {"losses": losses, "nse": nse}


if __name__ == "__main__":
    main()
