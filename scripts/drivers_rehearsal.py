#!/usr/bin/env python3
"""CPU rehearsal of ``chip_smoke.py`` phase 17's launch counts.

    PYTHONPATH=src python scripts/drivers_rehearsal.py [--width 128] [--watersheds 2] [--shapes]

Runs phase 17's drivers on the CPU, each kernel's plain version under a
counter (the wrappers call it where the card launches the kernel), so the
counts are the launches of the card's run: ``train_flood_torch`` at 400
days and 6 epochs on 2 watersheds (a stacked step launches the same
kernels whatever the watershed count), ``quickstart_torch`` at its
defaults, ``train_lm_torch --full`` for ``chip_smoke.DRIVER_LM_STEPS``
steps at mamba2-130m's full depth and a narrow width (``--width``: the
launches a step follow the layers, not the width), ``serve_lm_torch`` and
``ci_smoke_torch``'s four checks at their own (smoke) configs. The served
runs are bf16 as on the card, where another rounding may move a stream and
so a spec run's count. It prints each driver's counts and CPU seconds,
then one JSON line. ``--shapes`` adds, for each kernel, the distinct
shapes and dtypes of its tensor arguments and its other keyword
arguments, the shapes ``chip_smoke.py`` holds each kernel to its plain
version at (``--watersheds 23`` gives train_flood's own).
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for sub in ("", "src", "examples", "scripts"):
    sys.path.insert(0, str(ROOT / sub))

import chip_smoke as cs  # noqa: E402

REFS = {"pixcon": "pixcon_gate_ref", "lstm_cell": "lstm_cell_ref",
        "paged_attn": "paged_attention_ref", "conv1d": "causal_conv1d_ref",
        "ssd_chunk": "ssd_chunk_ref", "local_attn": "local_attention_ref"}


class Counted:
    """A kernel's plain version that counts its calls and records the
    shapes it was called at."""

    def __init__(self, fn):
        self.fn, self.calls, self.shapes = fn, 0, set()

    def __call__(self, *a, **kw):
        import torch
        self.calls += 1
        args = list(enumerate(a)) + sorted(kw.items())
        self.shapes.add(str(
            [(k, tuple(v.shape), str(v.dtype).split(".")[-1])
             if isinstance(v, torch.Tensor) else (k, v) for k, v in args
             if v is not None]))
        return self.fn(*a, **kw)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--watersheds", type=int, default=2)
    ap.add_argument("--shapes", action="store_true",
                    help="also record each kernel's argument shapes")
    args = ap.parse_args()
    import torch
    torch.manual_seed(0)
    counters = {}
    for name, ref in REFS.items():
        ops = importlib.import_module(f"repro_torch.kernels.{name}.ops")
        counters[name] = Counted(getattr(ops, ref))
        setattr(ops, ref, counters[name])

    import ci_smoke_torch
    import quickstart_torch
    import serve_lm_torch
    import train_flood_torch
    import train_lm_torch
    real_config = train_lm_torch.get_config

    def narrow(arch):                    # an SSM: the width is d_model alone
        return real_config(arch).replace(d_model=args.width)
    train_lm_torch.get_config = narrow
    cpu = ["--device", "cpu"]
    runs = {
        "train_flood": lambda: train_flood_torch.main(
            ["--watersheds", str(args.watersheds)] + cpu),
        "quickstart": lambda: quickstart_torch.main(cpu),
        "train_lm": lambda: train_lm_torch.main(
            ["--full", "--steps", str(cs.DRIVER_LM_STEPS)] + cpu),
        "serve_lm": lambda: serve_lm_torch.main(cpu),
        "ci_smoke": lambda: [ci_smoke_torch.main(
            cpu + [cmd] + (["--out-dir", str(ROOT / "build" / "obs")]
                           if cmd == "obs" else []),
            run=ci_smoke_torch.run_in_process)
            for cmd in ci_smoke_torch.CHECKS],
    }
    out = {}
    for name, run in runs.items():
        for c in counters.values():
            c.calls, c.shapes = 0, set()
        t0 = time.perf_counter()
        run()
        out[name] = {"launches": {k: c.calls for k, c in counters.items()},
                     "cpu_s": round(time.perf_counter() - t0, 1)}
        if args.shapes:
            out[name]["shapes"] = {k: sorted(c.shapes)
                                   for k, c in counters.items() if c.shapes}
        print(f"== {name}: {out[name]}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
