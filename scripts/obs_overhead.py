#!/usr/bin/env python3
"""What the training spans cost, and the step's split by phase, on a card.

    python3 scripts/obs_overhead.py [--cells CELL ...] [--steps N]
        [--free N] [--seed S] [--out FILE]

For each benchmark cell named (by default ``mamba2-130m.train-4k``:
``Engine.for_lm`` on mamba2-130m, 16 x 4,096 tokens, bf16, block remat;
and the pending ``domst.ipd-paper23``: stacked Dom-ST, 23 x 64 windows),
builds the cell's job as ``bench/run.py`` does (``harness.find_cell``,
the driver's ``setup``: weights and data from the seed, the loader
prefetching, the checked and warm-up steps), then, in one process:

  * ``N`` steps with recording off and ``N`` with it on
    (``obs.profiler.recording``; no profiler open), in turns (off, on,
    on, off, ...), each step synchronised before and after and timed on
    the host clock: the cost of recording, in ms a step;
  * the spans the "on" steps recorded (``engine.*``, ``loader.*``):
    host and device ms a step of each phase;
  * ``--free`` more steps with recording on and no synchronisation
    between them, as the benchmark's window runs them, and their split;
  * the cell's ``trace_steps`` under ``torch.profiler`` (every thread,
    as ``bench/harness.py::traced_window`` times them otherwise): the
    device's idle gaps by what the step's thread was in when each began,
    the longest gaps, and how much of the idle time the loader's worker
    spent in ``loader.host_batch`` or ``loader.place``;
  * the host cost of one span alone, recording off and on (with its
    two CUDA events), over many spans.

Prints one JSON line per cell with the card's name and power limit, and
writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from contextlib import nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

CELLS = ("mamba2-130m.train-4k", "domst.ipd-paper23")
PHASES = ("engine.step", "engine.forward", "engine.backward",
          "engine.optimizer", "loader.wait", "loader.host_batch",
          "loader.place")


def _sums(snap: dict) -> dict:
    """(count, sum) of every histogram of a registry snapshot, and the
    value of every counter."""
    return {k: ((v["count"], v["sum"]) if isinstance(v, dict) else v)
            for k, v in snap.items()}


def _split(before: dict, after: dict, steps: int) -> dict:
    """Each phase's host and device ms a step between two snapshots."""
    out = {}
    for name in PHASES:
        row = {}
        for kind, key in (("host_ms", f"{name}_s"),
                          ("device_ms", f"{name}_device_s")):
            n1, s1 = after.get(key, (0, 0.0))
            n0, s0 = before.get(key, (0, 0.0))
            if n1 > n0:
                row[kind] = (s1 - s0) * 1e3 / steps
                row[f"{kind}_spans"] = n1 - n0
        if row:
            out[name] = row
    return out


def _overlap(a: list, b: list) -> float:
    """Nanoseconds where two sorted unions of intervals meet."""
    out, j = 0, 0
    for x0, x1 in a:
        while j < len(b) and b[j][1] <= x0:
            j += 1
        k = j
        while k < len(b) and b[k][0] < x1:
            out += min(x1, b[k][1]) - max(x0, b[k][0])
            k += 1
    return out


def idle_gaps(job, dev, steps: int) -> dict:
    """The device's idle gaps over ``steps`` traced steps."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile, record_function
    from bench import harness
    spans = harness.Spans(annotate=True)
    harness.sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        with record_function("bench.traced"):
            for _ in range(steps):
                job.step(spans)
            harness.sync(dev)
    events = harness._kineto_events(prof)
    red = harness.reduce_trace(events, top=12)
    _, _, w0, w1, main = next(e for e in events
                              if not e[1] and e[0] == "bench.traced")
    busy = harness._union([(max(a, w0), min(b, w1)) for _, d, a, b, _
                           in events if d and b > w0 and a < w1])
    gaps, at = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    worker = harness._union([(a, b) for n, d, a, b, t in events
                             if not d and t != main and n in (
                                 "loader.host_batch", "loader.place")])
    host = sorted((a, -b, n) for n, d, a, b, t in events
                  if not d and t == main and n != "bench.traced")
    labels = harness._doing(host, [a for a, _ in gaps])
    longest = sorted(zip(gaps, labels), key=lambda g: g[0][0] - g[0][1])
    return {"steps": steps, "window_s": red["window_s"],
            "busy_s": red["busy_s"],
            "idle_s": sum(b - a for a, b in gaps) * 1e-9,
            "idle_with_worker_s": _overlap(gaps, worker) * 1e-9,
            "idle_gaps": red["idle_gaps"],
            "longest_gaps": [[lab, (b - a) * 1e-9, (a - w0) * 1e-9]
                             for (a, b), lab in longest[:8]]}


def span_cost_us(dev, n: int = 5000) -> dict:
    """Host microseconds of one empty span, recording off and on."""
    from bench import harness
    from repro_torch.obs import MetricRegistry, profiler
    reg = MetricRegistry()

    def loop():
        t = time.perf_counter()
        for _ in range(n):
            with profiler.span("obs_overhead.empty", reg, dev):
                pass
        return (time.perf_counter() - t) / n * 1e6
    off = loop()
    with profiler.recording():
        on = loop()
    harness.sync(dev)
    reg.flush()
    return {"off_us": off, "on_us": on, "spans": n}


def measure(name: str, seed: int, steps: int, free: int, dev) -> dict:
    from bench import harness
    from repro_torch.obs import profiler
    from repro_torch.obs import registry as obs_registry
    cell = harness.find_cell(name)
    t0 = time.perf_counter()
    job = harness.driver(cell["traffic"]["driver"]).setup(
        cell["config"], cell["traffic"], seed, dev)
    setup_s = time.perf_counter() - t0
    reg = obs_registry.default()
    spans = harness.Spans()
    kernels = {k: v for k, v in _sums(reg.snapshot()).items()
               if k.startswith("kernels.")}

    times = {False: [], True: []}
    split0 = _sums(reg.snapshot())
    for i in range(steps):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            with profiler.recording() if on else nullcontext():
                harness.sync(dev)
                t = time.perf_counter()
                job.step(spans)
                harness.sync(dev)
                times[on].append((time.perf_counter() - t) * 1e3)
    split1 = _sums(reg.snapshot())

    with profiler.recording():
        harness.sync(dev)
        t = time.perf_counter()
        for _ in range(free):
            job.step(spans)
        harness.sync(dev)
        free_ms = (time.perf_counter() - t) * 1e3 / max(free, 1)
    split2 = _sums(reg.snapshot())
    gaps = idle_gaps(job, dev, cell["traffic"]["trace_steps"])
    job.finish()

    off, on = times[False], times[True]
    cost = statistics.median(on) - statistics.median(off)
    diffs = [b - a for a, b in zip(off, on)]
    return {
        "cell": name, "seed": seed, "setup_s": setup_s,
        "steps_each": steps, "kernels": kernels,
        "off_ms": off, "on_ms": on,
        "median_off_ms": statistics.median(off),
        "median_on_ms": statistics.median(on),
        "cost_ms": cost,
        "cost_share": cost / statistics.median(off),
        "mean_pair_diff_ms": statistics.fmean(diffs),
        "split_synchronised": _split(split0, split1, steps),
        "free_steps": free, "free_ms_a_step": free_ms,
        "split_free": _split(split1, split2, max(free, 1)),
        "traced": gaps, "span_cost": span_cost_us(dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="+", default=list(CELLS))
    ap.add_argument("--steps", type=int, default=20,
                    help="steps with recording off, and as many with it on")
    ap.add_argument("--free", type=int, default=8,
                    help="unsynchronised steps with recording on, after")
    ap.add_argument("--seed", type=int, default=3900000001)
    ap.add_argument("--out", default="build/obs_overhead.json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("obs_overhead: no CUDA card; nothing measured", file=sys.stderr)
        return 2
    from bench.run import card_line
    card = card_line()
    rows = []
    for i, name in enumerate(args.cells):
        row = {"card": card, "torch": torch.__version__,
               **measure(name, args.seed + i, args.steps, args.free,
                          torch.device("cuda", 0))}
        print(json.dumps(row), flush=True)
        rows.append(row)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
