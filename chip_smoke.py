#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on a failed check:

1. the card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel of the Dom-ST forecast path from ``src/repro_torch/
   kernels/csrc``, timed (one ``nvcc`` per source, all at once);
2. each kernel against its plain PyTorch version on the card, at the
   forecast's shapes and at a ragged shape (Pix-Con also with
   ``normalize=False`` and a temperature other than 1), 1e-5 abs in fp32;
   the time of a launch, of the plain version and, for the LSTM step, of
   ``torch.lstm_cell`` (a yardstick only: the port never calls it);
3. the port's main path: the Forecaster at full width (the ``domst``
   config, 23 watersheds, 400 days, 74 held-out days), params from the
   port's init with a fixed seed. With the launch counts set to 0 it runs
   through the kernels; then the same forward runs with the plain
   versions. Every NSE must be finite, the NSE must agree within 1e-4 and
   qhat within 1e-3, and the counts must read 74 and 4440. A pixel rank
   that differs between the kernel's and the plain Pix-Con weights is
   printed and fails the run. A small forecast (2 watersheds, 150 days)
   is held against the CPU run of the port. The median of 7 warm calls
   gives ``wall_s`` and ``forecasts_per_s``; a CUDA graph of the forecast,
   replayed, gives the device time with the host out of the way, and so
   the card's idle share within each timed call (CUDA events around it);
   a profiled repeat gives the device time by kernel; the serve CLI runs
   the same forecast;
4. one JSON line listing every ported kernel with its error, times, bound
   and launches, then the line with the card's name and power limit;
5. the last line, ``{"ok": true, "device": {...}}``.

It needs one card. Without CUDA, or run from a directory that does not
hold the repository's ``src/repro_torch``, it exits non-zero and prints no
result. It imports nothing of JAX and nothing of the reference package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM, data sheet (dense): HBM rate and float32 rate outside
# the tensor cores (the kernels do fp32 FMAs on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

ATOL_KERNEL = 1e-5
ATOL_NSE = 1e-4
ATOL_QHAT = 1e-3
WATERSHEDS, DAYS, SEED = 23, 400, 0
TIMED_CALLS = 7      # warm forecasts timed; the median is reported


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time for the work on the card: bytes moved once over HBM, or
    operations over the fp32 peak, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean time of one call on the card, by CUDA events over many calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return float((a - b).abs().max())


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------
def pixcon_inputs(g, dev, R, B, T, P, F=4, Hp=32):
    import torch
    def rn(*shape, s=1.0):
        return (torch.randn(shape, generator=g) * s).to(dev)
    return dict(x=rn(R, B, T, P).abs(), feats=rn(R, B, P, F),
                w1=rn(R, F, Hp, s=0.5), b1=rn(R, Hp, s=0.1),
                w2=rn(R, Hp, s=0.2), b2=rn(R, 1, s=0.1))


def pixcon_work(R, B, T, P, F=4, Hp=32) -> tuple[float, float]:
    """Bytes (each input read once, each output written once) and fp32
    operations of one Pix-Con gate; tanh, exp and a division count as one."""
    nbytes = 4 * (2 * R * B * T * P + R * B * P * F + R * (F * Hp + 2 * Hp + 1)
                  + R * B * P)
    per_pixel = Hp * (2 * F + 1 + 1 + 2) + 1 + 1 + 3 + 2
    return nbytes, R * B * (P * per_pixel + T * P)


def lstm_inputs(g, dev, R, B, D, H):
    import torch
    def rn(*shape, s=1.0):
        return (torch.randn(shape, generator=g) * s).to(dev)
    return dict(x=rn(R, B, D), h=rn(R, B, H), c=rn(R, B, H),
                wx=rn(R, D, 4, H, s=D ** -0.5), wh=rn(R, H, 4, H, s=H ** -0.5),
                b=rn(R, 4, H, s=0.1))


def lstm_work(R, B, D, H) -> tuple[float, float]:
    """Bytes and fp32 operations of one LSTM step (every replica's weights
    read once); sigmoid and tanh count as one operation each."""
    nbytes = 4 * (R * B * D + 4 * R * B * H + R * 4 * H * (D + H + 1))
    return nbytes, R * B * H * (4 * 2 * (D + H) + 4 * 2 + 5 + 5)


def check_pixcon(g, dev) -> dict:
    import torch
    from repro_torch.kernels.pixcon.ops import pixcon_gate
    from repro_torch.kernels.pixcon.ref import pixcon_gate_ref
    err = 0.0
    cases = [((WATERSHEDS, 1, 30, 64), True, 1.0),
             ((WATERSHEDS, 1, 30, 64), False, 2.5),
             ((3, 5, 17, 48), True, 1.0),
             ((3, 5, 17, 48), False, 0.7)]
    for shape, normalize, temp in cases:
        a = pixcon_inputs(g, dev, *shape)
        out, w = pixcon_gate(**a, normalize=normalize, temperature=temp)
        torch.cuda.synchronize()
        ref_out, ref_w = pixcon_gate_ref(**a, normalize=normalize,
                                         temperature=temp)
        e = max(max_err(out, ref_out), max_err(w, ref_w))
        print(f"  pixcon {shape} normalize={normalize} T={temp}: "
              f"max_abs_err={e:.3e}")
        check(e <= ATOL_KERNEL, f"pixcon {shape}: error {e} > {ATOL_KERNEL}")
        err = max(err, e)
    shape = (WATERSHEDS, 1, 30, 64)
    a = pixcon_inputs(g, dev, *shape)
    ms = time_ms(lambda: pixcon_gate(**a))
    plain_ms = time_ms(lambda: pixcon_gate_ref(**a))
    b_ms, b_by = bound_ms(*pixcon_work(*shape))
    print(f"  pixcon {shape}: kernel {ms * 1e3:.2f} us, plain "
          f"{plain_ms * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us ({b_by})")
    return {"name": "pixcon", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/pixcon.cu",
            "replaces": "src/repro/kernels/pixcon/kernel.py:23",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": "R=23 B=1 T=30 P=64 F=4 Hp=32"}


def check_lstm(g, dev) -> dict:
    import torch
    from repro_torch.kernels.lstm_cell.ops import lstm_cell_fused
    from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref
    err = 0.0
    main_shapes = [(WATERSHEDS, 1, 128, 64), (WATERSHEDS, 1, 64, 64)]
    for shape in main_shapes + [(3, 5, 48, 160), (1, WATERSHEDS, 128, 64)]:
        a = lstm_inputs(g, dev, *shape)
        h, c = lstm_cell_fused(**a)
        torch.cuda.synchronize()
        ref_h, ref_c = lstm_cell_ref(**a)
        e = max(max_err(h, ref_h), max_err(c, ref_c))
        print(f"  lstm_cell (R,B,D,H)={shape}: max_abs_err={e:.3e}")
        check(e <= ATOL_KERNEL, f"lstm_cell {shape}: error {e} > {ATOL_KERNEL}")
        err = max(err, e)
    # Times per launch, averaged over the two layers' shapes: the forecast
    # launches each equally often (74 days x 30 steps).
    ms, plain_ms, b_ms, lib_ms, lib_shape_ms = [], [], [], [], []
    for R, B, D, H in main_shapes:
        a = lstm_inputs(g, dev, R, B, D, H)
        ms.append(time_ms(lambda: lstm_cell_fused(**a)))
        plain_ms.append(time_ms(lambda: lstm_cell_ref(**a)))
        nbytes, ops = lstm_work(R, B, D, H)
        b_ms.append(bound_ms(nbytes, ops))
        # yardstick: torch.lstm_cell computes the step for ONE weight set,
        # so it runs the single-replica shape R=1, B=23 (+1 folded into
        # the forget slice of b_hh); our kernel is timed there too
        one = lstm_inputs(g, dev, 1, R * B, D, H)
        w_ih = one["wx"][0].reshape(D, 4 * H).t().contiguous()
        w_hh = one["wh"][0].reshape(H, 4 * H).t().contiguous()
        b_ih = one["b"][0].reshape(4 * H).contiguous()
        b_hh = torch.zeros(4 * H, device=dev)
        b_hh[H:2 * H] = 1.0
        x1, h1, c1 = one["x"][0], one["h"][0], one["c"][0]
        lh, lc = torch.lstm_cell(x1, (h1, c1), w_ih, w_hh, b_ih, b_hh)
        kh, kc = lstm_cell_fused(**one)
        e = max(max_err(lh, kh[0]), max_err(lc, kc[0]))
        check(e <= ATOL_KERNEL, f"torch.lstm_cell disagrees with the kernel: {e}")
        lib_ms.append(time_ms(
            lambda: torch.lstm_cell(x1, (h1, c1), w_ih, w_hh, b_ih, b_hh)))
        lib_shape_ms.append(time_ms(lambda: lstm_cell_fused(**one)))
        print(f"  lstm_cell (R,B,D,H)={(R, B, D, H)}: kernel "
              f"{ms[-1] * 1e3:.2f} us, plain {plain_ms[-1] * 1e3:.2f} us, "
              f"bound {b_ms[-1][0] * 1e3:.3f} us ({b_ms[-1][1]}); at R=1 B=23: "
              f"torch.lstm_cell {lib_ms[-1] * 1e3:.2f} us, kernel "
              f"{lib_shape_ms[-1] * 1e3:.2f} us (agree to {e:.1e})")

    def mean(v):
        return sum(v) / len(v)
    return {"name": "lstm_cell", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lstm_cell.cu",
            "replaces": "src/repro/kernels/lstm_cell/kernel.py:18",
            "max_abs_err": err, "ms": mean(ms), "plain_ms": mean(plain_ms),
            "bound_ms": mean([b for b, _ in b_ms]),
            "bound_by": b_ms[0][1], "library_ms": mean(lib_ms),
            "shape": "R=23 B=1 H=64, D=128 and D=64 (mean of the two layers)",
            "library_shape": "torch.lstm_cell at R=1 B=23",
            "ms_at_library_shape": mean(lib_shape_ms)}


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------
def rank_flips(params, cfg, placed) -> tuple[int, float, float, int]:
    """Rows whose pixel ranking differs between the kernel's and the plain
    Pix-Con weights, the largest weight difference, the smallest non-zero
    gap between two neighbouring ranked weights (how near a tie came) and
    the number of exact ties."""
    import torch
    from repro_torch.core.domst import subtree
    from repro_torch.core.pixcon import pixel_features
    from repro_torch.kernels.pixcon.ops import pixcon_gate
    from repro_torch.kernels.pixcon.ref import pixcon_gate_ref
    pc = cfg.domst.pixcon
    p = subtree(params, "pixcon")
    flips, werr, gap, ties = 0, 0.0, float("inf"), 0
    with torch.inference_mode():
        for n in range(placed["precip"].shape[0]):
            x = placed["precip"][n].unsqueeze(1)
            f = pixel_features(x, placed["dist"][n].unsqueeze(1),
                               placed["target_day"][n].unsqueeze(1))
            args = (x, f, p["w1"], p["b1"], p["w2"], p["b2"])
            kw = dict(temperature=pc.temperature, normalize=pc.normalize)
            _, wk = pixcon_gate(*args, **kw)
            _, wp = pixcon_gate_ref(*args, **kw)
            ok = torch.argsort(-wk, dim=-1, stable=True)
            op = torch.argsort(-wp, dim=-1, stable=True)
            bad = (ok != op).any(dim=-1)
            if bad.any():
                print(f"  rank flip on day {n}, watersheds "
                      f"{bad.flatten().nonzero().flatten().tolist()}")
            flips += int(bad.sum())
            werr = max(werr, max_err(wk, wp))
            srt = torch.sort(wp, dim=-1, descending=True).values
            gaps = srt[..., :-1] - srt[..., 1:]
            ties += int((gaps == 0).sum())
            gap = min(gap, float(gaps[gaps > 0].min()))
    return flips, werr, gap, ties


def timed_call(fc, params, placed) -> tuple[float, float]:
    """One warm forecast: its host wall time, ended by a synchronize, and
    its device span, between CUDA events recorded before and after it."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    fc.forecast(params, placed)
    end.record()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, start.elapsed_time(end) * 1e-3


def graph_device_s(fc, params, placed, reference) -> float:
    """Device time of one forecast's work with the host out of the way: the
    forecast captured once into a CUDA graph and replayed, timed by CUDA
    events (median of 5 replays). Nodes of a graph still leave a small gap
    between them, so this bounds from above the time the card is busy in
    an eager forecast. The replay must give the eager forecast's qhat."""
    import torch
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fc.forecast(params, placed)
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) * 1e-3)
    err = max_err(out["qhat"], reference["qhat"])
    print(f"  CUDA graph replay of the forecast: {sorted(times)} s, "
          f"qhat vs eager {err:.3e}")
    check(err <= ATOL_QHAT, f"graph replay qhat differs by {err}")
    return sorted(times)[len(times) // 2]


def device_breakdown(fc, params, placed) -> dict:
    """Device time by kernel over one warm forecast, from torch.profiler:
    the rows of kernels that ran on the card (None where the profiler saw
    no device activity: not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fc.forecast(params, placed)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    return {"wall_s": wall,
            "device_busy_s": sum(r[0] for r in rows) * 1e-6 if rows else None,
            "by_kernel": [{"kernel": k[:60], "device_ms": us * 1e-3,
                           "calls": c} for us, k, c in rows[:8]]}


def main_path(dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import domst
    from repro_torch.data.pipeline import make_domst_windows, stacked_test_batch
    from repro_torch.kernels.lstm_cell.ops import lstm_cell_fused
    from repro_torch.kernels.pixcon.ops import pixcon_gate
    from repro_torch.serve.forecast import Forecaster

    cfg = get_config("domst")
    held = stacked_test_batch(make_domst_windows(WATERSHEDS, DAYS))
    params = domst.init(cfg, torch.Generator().manual_seed(SEED), WATERSHEDS)
    fc = Forecaster(cfg, device=dev)
    params = fc.place_params(params)
    placed = fc.place_batch(held)
    W, N = held["discharge"].shape

    pixcon_gate.launches = 0
    lstm_cell_fused.launches = 0
    t0 = time.perf_counter()
    res = fc.forecast(params, placed)
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    launches = {"pixcon": pixcon_gate.launches,
                "lstm_cell": lstm_cell_fused.launches}
    print(f"  forecaster {W} watersheds x {N} days: launches {launches}, "
          f"first call {first_wall:.3f} s")
    want = {"pixcon": N, "lstm_cell": N * cfg.domst.lstm_layers
            * cfg.domst.window_days}
    check(launches == want, f"launch counts {launches} != {want}")

    plain = Forecaster(cfg, device=dev, ops=domst.PLAIN).forecast(params, placed)
    torch.cuda.synchronize()
    check(pixcon_gate.launches == N and lstm_cell_fused.launches == want["lstm_cell"],
          "the plain run launched a kernel")
    qk, qp = res["qhat"], plain["qhat"]
    check(tuple(qk.shape) == (W, N), f"qhat shape {tuple(qk.shape)}")
    check(bool(torch.isfinite(qk).all()), "non-finite qhat")
    check(bool(torch.isfinite(res["nse"]).all()), f"non-finite NSE {res['nse']}")
    flips, werr, gap, ties = rank_flips(params, cfg, placed)
    print(f"  pixcon weights kernel vs plain: max_abs_err={werr:.3e}, "
          f"rank flips {flips}, nearest non-tie gap {gap:.3e}, exact ties {ties}")
    check(flips == 0, f"{flips} rows rank pixels differently (near-tie flip)")
    nse_err = max_err(res["nse"], plain["nse"])
    q_err = max_err(qk, qp)
    print(f"  kernels vs plain: max |dNSE|={nse_err:.3e}, max |dqhat|={q_err:.3e}")
    check(nse_err <= ATOL_NSE, f"NSE differs by {nse_err} > {ATOL_NSE}")
    check(q_err <= ATOL_QHAT, f"qhat differs by {q_err} > {ATOL_QHAT}")

    # a small forecast against the port on the CPU (plain versions there)
    small = stacked_test_batch(make_domst_windows(2, 150))
    sp = domst.init(cfg, torch.Generator().manual_seed(SEED + 1), 2)
    on_card = Forecaster(cfg, device=dev)(sp, small)
    on_cpu = Forecaster(cfg, device="cpu")(sp, small)
    small_err = max_err(on_card["qhat"].cpu(), on_cpu["qhat"])
    print(f"  2 x 150 forecast, card vs CPU: max |dqhat|={small_err:.3e}")
    check(small_err <= 1e-4, f"card and CPU forecasts differ by {small_err}")

    calls = [timed_call(fc, params, placed) for _ in range(TIMED_CALLS)]
    walls = sorted(w for w, _ in calls)
    wall = walls[len(walls) // 2]
    busy = graph_device_s(fc, params, placed, res)
    # idle share of each timed call: its device span less the graph's
    # device time, over the span (a lower bound: the graph's time is an
    # upper bound on the busy time)
    idle = sorted(1 - busy / span for _, span in calls)
    plain_fc = Forecaster(cfg, device=dev, ops=domst.PLAIN)
    plain_walls = sorted(timed_call(plain_fc, params, placed)[0]
                         for _ in range(3))
    plain_wall = plain_walls[1]
    prof = device_breakdown(fc, params, placed)
    nses = res["nse"].cpu().numpy()
    out = {"arch": cfg.name, "watersheds": W, "horizon_days": N,
           "mean_nse": float(np.mean(nses)), "nse_min": float(nses.min()),
           "wall_s": wall, "forecasts_per_s": W * N / wall,
           "wall_s_sorted": walls,
           "device_span_s_by_call": [span for _, span in calls],
           "graph_device_s": busy,
           "device_idle_share": idle[len(idle) // 2],
           "device_idle_share_sorted": idle,
           "plain_wall_s": plain_wall,
           "plain_wall_s_sorted": plain_walls, "first_call_wall_s": first_wall,
           "launches": launches,
           "profiled_device_busy_s": prof["device_busy_s"],
           "profiled_wall_s": prof["wall_s"],
           "device_time_by_kernel": prof["by_kernel"]}
    print("  " + json.dumps(out))

    # the same forecast through the command-line entry point (same seed,
    # so the same params): its NSE must be this run's
    from repro_torch.launch.serve import main as serve_main
    cli = serve_main(["--arch", "domst", "--watersheds", str(WATERSHEDS),
                      "--days", str(DAYS), "--seed", str(SEED)])
    cli_err = float(np.abs(np.asarray(cli["nse"]) - nses).max())
    check(cli["device"] == torch.cuda.get_device_name(dev) and cli_err <= ATOL_NSE,
          f"serve CLI NSE differs by {cli_err} (device {cli['device']})")

    device_ms = {}
    for name, kernel in (("pixcon", "pixcon_gate_kernel"),
                         ("lstm_cell", "lstm_cell_kernel")):
        hit = [r for r in prof["by_kernel"] if r["kernel"].startswith(kernel)]
        device_ms[name] = hit[0]["device_ms"] / hit[0]["calls"] if hit else None
    return launches, device_ms


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from the "
              "root of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(f"[1] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = build.build()
    print(f"[1] built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")

    g = torch.Generator().manual_seed(1234)
    print("[2] kernels against their plain versions")
    kernels = [check_pixcon(g, dev), check_lstm(g, dev)]
    print("[3] main path: Forecaster, domst, 23 watersheds x 400 days")
    launches, device_ms = main_path(dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["device_ms_per_launch_on_main_path"] = device_ms[k["name"]]
        check(k["launches"] > 0, f"{k['name']} was not launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
