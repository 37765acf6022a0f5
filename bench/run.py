"""Run one cell of the benchmark of ``repro_torch`` once, on the card.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: builds the cell's job from the seed (the
set-up: data, weights, the port's kernels, its first steps), times the
port's training step for ``--seconds`` seconds, with ``--trace 1`` then
profiles a few more steps, holds the first steps to the plain reference,
and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, last, ``checks``
(each number compared, with its limit), which also close standard error.

It exits non-zero, printing no result, without CUDA or with fewer cards
than the cell asks for, and if JAX or the JAX package is loaded once the
window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench-cache"     # fixed: a second run finds it
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")

    from bench import harness
    cell = harness.find_cell(args.workload)
    if importlib.util.find_spec("repro_torch") is None:
        print("bench: the port (src/repro_torch) is not in this checkout; "
              "no result", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("bench: CUDA is not available; no result", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"bench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present; no result",
              file=sys.stderr)
        return 2
    print(f"bench: {args.workload} seed {args.seed}, card: {card_line()}",
          file=sys.stderr)
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    if out["loaded"]:
        print(f"bench: loaded once the window closed: {out['loaded']}; "
              "no result", file=sys.stderr)
        return 3
    for k, limit in out["limits"].items():
        print(f"check {k}: {out['numbers'][k]!r} limit {limit!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
