#!/usr/bin/env python3
"""The dry run's records as one markdown table.

    python3 scripts/dryrun_table.py [DIR]

Reads ``DIR`` (default ``results/dryrun_torch``), where
``python -m repro_torch.launch.dryrun --all`` writes one JSON record a
run and a ``.fail`` file (the run's last error output) a failed run, and
prints a row for every arch of ``matrix()``, a column a shape, each
cell the (16, 16) mesh's run, then the (2, 16, 16) one's: rank 0's bytes (its params, optimizer moments and cache
together, then its batch, in MiB), its TFLOP, its collectives and the
MiB it sends in them; or the failure's last line. These are counts of
one step's program on a fake world, not times on a device.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import INPUT_SHAPES  # noqa: E402
from repro_torch.launch.dryrun import matrix  # noqa: E402


def _mb(n) -> str:
    return f"{n / 2 ** 20:,.1f}"


def _failure(path: Path) -> str:
    lines = [ln for ln in path.read_text().splitlines()
             if ln.strip() and ("Error" in ln or "failed" in ln)]
    last = lines[-1] if lines else "(no error line)"
    last = last.replace("[rank0]:", "").strip()
    return last[:90].replace("|", "/")


def _cell(out: Path, name: str) -> str:
    """One run: state + batch MiB, TFLOP, collectives / MiB sent; or its
    failure."""
    rec = out / f"{name}.json"
    if rec.exists():
        r = json.loads(rec.read_text())
        b, c = r["rank0_bytes"], r["collectives"]
        state = b["params"] + b.get("opt", 0) + b.get("cache", 0)
        return (f"{_mb(state)} + {_mb(b['batch'])}; "
                f"{r['rank0_flops'] / 1e12:,.3f}; "
                f"{c['total_count']} / {_mb(c['total_send_bytes'])}")
    if (out / f"{name}.fail").exists():
        return "failed: " + _failure(out / f"{name}.fail")
    return "not run"


def rows(out: Path):
    shapes = list(INPUT_SHAPES)
    yield "| arch | " + " | ".join(shapes) + " |"
    yield "|" + "---|" * (1 + len(shapes))
    pairs = matrix()
    for arch in dict.fromkeys(a for a, _ in pairs):
        cells = [" ‖ ".join(_cell(out, f"{arch}__{s}__{mesh}")
                            for mesh in ("pod", "multipod"))
                 if (arch, s) in pairs else "-" for s in shapes]
        yield f"| {arch} | " + " | ".join(cells) + " |"


def main() -> None:
    out = Path(sys.argv[1]) if len(sys.argv) > 1 else \
        ROOT / "results" / "dryrun_torch"
    for row in rows(out):
        print(row)


if __name__ == "__main__":
    main()
