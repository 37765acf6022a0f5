"""What every cell's run shares: finding the cell's files, the timed
window and its spans, the traced window and its reduction to device
busy time, kernel times and idle gaps, the per-metric readers, the check
that decides ``correct``, and the result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json`` (or in
``bench/pending.json``, see ``with_pending``): a configuration
(``configs[].file``, a JSON file under ``bench/configs/``) under a traffic
mix (``bench/traffic/<traffic>.json``), whose ``driver`` names the module
under ``bench/drivers/`` that builds the port's timed path for it. Each
metric is read by ``bench/metrics/<metric name>.py``. So a new cell, a
new traffic mix or a new metric is a new file, and nothing here changes.

A driver's ``setup(config, traffic, seed, device)`` returns a job:

  * ``units``, ``work_per_step``: what a step completes (windows, tokens);
  * ``step(spans)``: one step of the timed path, recording its spans;
  * ``program_readings()``: what the check compares, read from the
    program's own state during set-up (its first steps);
  * ``losses``: the loss tensors of the steps taken since set-up;
  * ``finish()``: frees the program's state and stops its threads;
  * ``reference(precision, fault)``: the same readings from the plain
    reference, on the same inputs and weights, made again from the seed.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# -- the cell's files ----------------------------------------------------------
def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def with_pending(spec: Mapping) -> Dict[str, Any]:
    """``spec`` with the entries of ``bench/pending.json`` added: cells
    measured and checked, but not admitted (``PERF.md`` says why), with
    their configurations and metrics. The check runs only the cells of
    ``BENCHMARK.json``; a pending cell runs by its name all the same."""
    pending = load_json(BENCH / "pending.json")
    return {**spec, **{k: list(spec[k]) + pending[k] for k in pending}}


def find_cell(name: str, spec: Optional[Mapping] = None) -> Dict[str, Any]:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``spec``), with its
    configuration, traffic, and the metrics it reports: the end-to-end
    metrics that list it or list no cells, and the per-layer metrics that
    list it, or list no cells and move an end-to-end metric it reports."""
    spec = spec or with_pending(load_json(ROOT / "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    config = {c["name"]: c for c in spec["configs"]}[cell["config"]]

    def applies(m):
        return name in m.get("workloads", [name])
    e2e = [m for m in spec["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if applies(m)
             and ("workloads" in m or m["moves"] in names)]
    return {"name": name, "chips": cell["chips"],
            "config": load_json(ROOT / config["file"]),
            "traffic": load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
            "end_to_end": e2e, "per_layer": layer}


def reader(metric: str):
    """The ``read(ctx)`` function of ``bench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    return importlib.import_module(f"bench.drivers.{name}")


# -- spans -------------------------------------------------------------------
class Spans:
    """Host time and count of each named span. With ``annotate`` each
    span is also a profiler range, ``bench.<name>``, so that the traced
    window can say what the host was doing while the device idled."""

    def __init__(self, annotate: bool = False):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.annotate = annotate

    @contextmanager
    def __call__(self, name: str):
        if self.annotate:
            import torch
            rng = torch.profiler.record_function(f"bench.{name}")
        else:
            rng = nullcontext()
        t0 = time.perf_counter()
        with rng:
            yield
        self.total[name] += time.perf_counter() - t0
        self.count[name] += 1

    def mean_ms(self, name: str) -> Optional[float]:
        n = self.count.get(name, 0)
        return self.total[name] / n * 1e3 if n else None


def log(what: str) -> None:
    """A line on standard error: what set-up or the run has reached, and
    when (seconds since the process started timing)."""
    print(f"bench: {what} at {time.perf_counter() - T0[0]:.2f} s",
          file=sys.stderr, flush=True)


T0 = [time.perf_counter()]      # reset to the process's start by ``run``


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# -- the timed window ----------------------------------------------------------
def run_window(job, seconds: float, device) -> Dict[str, Any]:
    """Steps of the timed path until ``seconds`` have passed on the host
    clock, then a wait for the device: every step's work over all of that
    time. The device's peak memory is read over the window alone."""
    import torch
    cuda = torch.device(device).type == "cuda"
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    spans = Spans()
    first = len(job.losses)
    t0 = time.perf_counter()
    steps = 0
    while True:
        job.step(spans)
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    losses = job.losses[first:]
    failed = sum(int(not bool(torch.isfinite(x).all())) for x in losses)
    return {"steps": steps, "seconds": elapsed,
            "work": steps * job.work_per_step, "peak_bytes": int(peak),
            "spans": spans, "failed": failed}


# -- the traced window ---------------------------------------------------------
def traced_window(job, steps: int, device) -> Dict[str, Any]:
    """``steps`` steps under ``torch.profiler`` (host and device), reduced
    in memory to what the readers and the breakdown need."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync(device)
    spans = Spans(annotate=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("bench.traced"):
            for _ in range(steps):
                job.step(spans)
            sync(device)
    return reduce_trace(_kineto_events(prof))


def _kineto_events(prof) -> List[Tuple[str, bool, int, int, int]]:
    """(name, on the device, start ns, end ns, host thread) of every
    event the profiler recorded."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() != DeviceType.CPU
        if dev and (e.is_user_annotation() or e.name().startswith("bench.")):
            continue            # a host range mirrored on the device's row
        start = int(e.start_ns())
        out.append((e.name(), dev, start, start + int(e.duration_ns()),
                    int(e.start_thread_id())))
    return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce_trace(events: List[Tuple[str, bool, int, int, int]],
                 top: int = 10) -> Dict[str, Any]:
    """The traced window (the ``bench.traced`` range) reduced to: its
    length; the union of device activity in it (busy); each device
    operation's count and time; the ``top`` operations by time; and the
    idle gaps of the device summed by what the main thread was doing when
    each began (its innermost ``bench.`` span and innermost operation)."""
    win = [e for e in events if not e[1] and e[0] == "bench.traced"]
    if not win:
        return {}
    _, _, w0, w1, main = win[0]
    dev = [(n, max(a, w0), min(b, w1)) for n, d, a, b, _ in events
           if d and b > w0 and a < w1]
    busy = _union([(a, b) for _, a, b in dev if b > a])
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for n, a, b in dev:
        by_name[n][0] += 1
        by_name[n][1] += (b - a) * 1e-9
    gaps, at = [], w0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if w1 > at:
        gaps.append((at, w1))
    host = sorted((a, -b, n) for n, d, a, b, t in events
                  if not d and t == main and n != "bench.traced")
    idle: Dict[str, float] = defaultdict(float)
    for (a, b), label in zip(gaps, _doing(host, [a for a, _ in gaps])):
        idle[label] += (b - a) * 1e-9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"window_s": (w1 - w0) * 1e-9,
            "busy_s": sum(b - a for a, b in busy) * 1e-9,
            "device": {n: (c, s) for n, (c, s) in by_name.items()},
            "device_ops": [[n[:120], s] for n, (c, s) in ops[:top]],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])[:top]}


def _doing(host: List[Tuple[int, int, str]], times: List[int]) -> List[str]:
    """What the main thread was in at each of the sorted ``times``: its
    innermost ``bench.`` range and its innermost operation. ``host`` is
    its ranges as (start, -end, name), sorted: they nest, so one sweep
    with a stack of the open ranges finds them."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            a, nb, n = host[i]
            while stack and stack[-1][1] <= a:
                stack.pop()
            stack.append((a, -nb, n))
            i += 1
        open_ = [n for _, b, n in stack if b > t]
        op = open_[-1] if open_ else "no host op"
        span = next((n[len("bench."):] for n in reversed(open_)
                     if n.startswith("bench.")), "outside")
        out.append(f"{span}: {op}"[:120])
    return out


def kernel_time(trace: Mapping, symbol: str) -> Optional[Tuple[int, float]]:
    """(launches, device seconds) of the device operations whose name holds
    ``symbol`` in the traced window; None where there were none."""
    hits = [v for n, v in (trace or {}).get("device", {}).items()
            if symbol in n]
    if not hits:
        return None
    return sum(c for c, _ in hits), sum(s for _, s in hits)


# -- the check -----------------------------------------------------------------
def compare(prog: Mapping, ref: Mapping,
            skip_below: float = 1e-3) -> Dict[str, float]:
    """The numbers a cell's check may compare; its traffic file's
    ``limits`` name the ones it does. A leaf is a tensor of the program's
    state, replicas and all (a stacked Dom-ST leaf holds every
    watershed's copy), and a step's loss is the replicas' mean.

    * ``loss``: the largest relative gap of a step's loss;
      ``loss_first``: the first step's, before any update;
    * ``grad``: the largest gap between the norms of a leaf's first
      clipped gradient, over the larger of the reference's norm of that
      leaf and of its median leaf; ``grad_median``: the median leaf's;
    * ``change``, ``change_median``: the same for the norm of the params'
      change over the checked steps, leaving out the leaves whose
      reference gradient is under ``skip_below`` of the median leaf's
      (moved by round-off alone under Adam)."""
    lp = np.asarray(prog["loss"]).mean(axis=1)
    lr = np.asarray(ref["loss"]).mean(axis=1)
    loss = np.abs(lp - lr) / np.maximum(np.abs(lr), 1e-30)
    keys = sorted(ref["grad"])

    def norms(r, what):
        return np.array([np.sqrt(np.sum(np.square(r[what][k])))
                         for k in keys])
    gr, gp = norms(ref, "grad"), norms(prog, "grad")
    grad = np.abs(gp - gr) / np.maximum(gr, np.median(gr))
    moved = gr >= skip_below * np.median(gr)
    cr, cp = norms(ref, "change"), norms(prog, "change")
    change = (np.abs(cp - cr) / np.maximum(cr, np.median(cr)))[moved]
    return {"loss": float(loss.max()), "loss_first": float(loss[0]),
            "grad": float(grad.max()), "grad_median": float(np.median(grad)),
            "change": float(change.max()),
            "change_median": float(np.median(change))}


# -- one run ---------------------------------------------------------------------
def run(cell: Mapping, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Dict[str, Any]:
    """Set-up, the timed window, the traced window (``trace``), the check;
    returns the result line's fields and the numbers compared."""
    import torch
    T0[0] = t_start
    job = driver(cell["traffic"]["driver"]).setup(
        cell["config"], cell["traffic"], seed, device)
    setup_s = time.perf_counter() - t_start
    log("set-up done; the timed window starts")
    window = run_window(job, seconds, device)
    log(f"the timed window closed after {window['steps']} steps; "
        + ", ".join(f"{k} {window['spans'].mean_ms(k):.2f} ms a step"
                    for k in sorted(window["spans"].total)))
    tr = (traced_window(job, cell["traffic"]["trace_steps"], device)
          if trace else None)
    if trace:
        log("the traced window is reduced")
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)}
                    & set(FORBIDDEN))
    prog = job.program_readings()
    job.finish()
    ref = job.reference("fp32", None)
    log("the reference's steps are done")
    numbers = compare(prog, ref)
    limits = cell["traffic"]["limits"]
    correct = all(numbers[k] <= limits[k] for k in limits)
    for k, v in numbers.items():
        log(f"reading {k} {v!r}")
    ctx = Context(cell, job, window, setup_s, tr)
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = torch.device(device)
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": int(cell["chips"]),
        "memory_peak_bytes": window["peak_bytes"]}
    out = {"correct": bool(correct), "attempted": window["steps"],
           "failed": window["failed"], "metrics": metrics,
           "device": device_info}
    if tr:
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in limits}
    return {"result": out, "loaded": loaded, "numbers": numbers,
            "limits": limits}


class Context:
    """What a metric's reader reads: the cell's configuration and traffic,
    the timed window (steps, seconds, work, peak memory, spans), the
    set-up time and the traced window's reduction (or None)."""

    def __init__(self, cell, job, window, setup_s, trace):
        self.config = cell["config"]
        self.traffic = cell["traffic"]
        self.units = job.units
        self.window = window
        self.spans = window["spans"]
        self.setup_s = setup_s
        self.trace = trace

    def kernel(self, symbol: str):
        return kernel_time(self.trace, symbol)

    def rate(self) -> float:
        return self.window["work"] / self.window["seconds"]


def idle_share(ctx: Context) -> Optional[float]:
    t = ctx.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline(ctx: Context, symbol: str, least_per_launch: float
             ) -> Optional[float]:
    """Least time of the launches of ``symbol`` in the traced window over
    their device time, in %."""
    k = ctx.kernel(symbol)
    if k is None or k[1] <= 0:
        return None
    return 100.0 * k[0] * least_per_launch / k[1]
