"""The readings that bound a cell's limits from above: the plain
reference put in the program's place with a fault, held to the plain
reference by the same comparison as a run's.

    python3 bench/control.py --workload <name> --seeds 11 12 13 [--out F]

For each seed: the reference in float32 (the truth), then the control
(the reference in the configuration's ``control_precision``, the nearest
precision below the one it states) and each fault a training step can
have (``half_batch``: the loss over half the batch; ``altered_answer``:
an answer altered where it is produced), each compared with the truth.
One JSON line a reading; ``--out`` also writes them all to F. A state
left unchanged reads 1 in ``grad`` and ``change`` by construction and
is not run. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

FAULTS = ("half_batch", "altered_answer")


def readings(cell, seed: int, device) -> list:
    """The control's and the faults' numbers for one seed."""
    from bench import harness
    ref = harness.driver(cell["traffic"]["driver"]).Reference(
        cell["config"], cell["traffic"], seed, device)
    t0 = time.perf_counter()
    truth = ref.run("fp32")
    out = [{"seed": seed, "variant": "reference",
            "seconds": time.perf_counter() - t0}]
    variants = [("control", cell["config"]["control_precision"], None)] + \
        [(f, "fp32", f) for f in FAULTS]
    for name, precision, fault in variants:
        t0 = time.perf_counter()
        numbers = harness.compare(ref.run(precision, fault), truth)
        out.append({"seed": seed, "variant": name, "precision": precision,
                    "seconds": time.perf_counter() - t0, **numbers})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    from bench import harness
    if not torch.cuda.is_available():
        print("control: CUDA is not available", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload)
    rows = []
    for seed in args.seeds:
        for row in readings(cell, seed, torch.device("cuda", 0)):
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
