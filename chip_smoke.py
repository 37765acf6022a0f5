#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on a failed check:

1. the card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel of the port's paths from ``src/repro_torch/
   kernels/csrc``, timed (one ``nvcc`` per source, all at once);
2. each kernel against its plain PyTorch version on the card, at its
   main path's shapes and at ragged ones, 1e-5 abs in fp32: Pix-Con (also
   ``normalize=False`` and a temperature other than 1), the LSTM step, and
   paged attention (decode, verify and a 128-token prefill chunk of
   qwen2-1.5b, in bf16 within 2e-2 as well, plus small shapes with a
   window, a softcap, unassigned pages and an empty row); the time of a
   launch, of the plain version and of one PyTorch call computing the
   same function where there is one (``torch.lstm_cell``;
   ``scaled_dot_product_attention`` over K/V gathered beforehand, the
   gather timed apart) — yardsticks only: the port never calls them;
3. the Dom-ST main path: the Forecaster at full width (the ``domst``
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
4. the LM main path: qwen2-1.5b at full width, random weights from the
   port's init (seed 0), 8 requests on 4 slots (prompts of 512/510/508/
   506 tokens, 64 new tokens each, 16-token pages) served in bf16 through
   the port's Scheduler three times — whole-prompt prefill, 128-token
   prefill chunks, ``spec_k=3`` with the n-gram drafter — each with the
   launch counts set to 0 just before and read just after (paged_attn
   must be > 0, the Dom-ST kernels 0), printing tok/s, decode tok/s,
   TTFT p50 and, from a profiled repeat, the device time by kernel. Then
   the kernel against its plain version end to end: one bf16
   ``decode_step_paged`` on the admitted state (logits within 2^-5 of
   their largest magnitude) and the share of equal tokens in bf16
   streams; in fp32, one decode step's logits, kernel against plain and
   plain on the card against plain on the CPU (how far two correct
   float32 runs of this chaotic random model part), every launch of the
   three served runs held against the plain version on the same inputs
   (within 2e-3 of the output's largest magnitude), and the greedy
   streams, kernel against plain, equal in all three modes on the same
   weights with the attention projections rescaled to unit variance;
5. one JSON line listing every ported kernel with its error, times, bound
   and launches, then the line with the card's name and power limit;
6. the last line, ``{"ok": true, "device": {...}}``.

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
T_START = time.perf_counter()
SRC = ROOT / "src"

# NVIDIA H100 SXM, data sheet (dense): HBM rate and float32 rate outside
# the tensor cores (the kernels do fp32 FMAs on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12       # tensor cores, dense

ATOL_KERNEL = 1e-5
ATOL_NSE = 1e-4
ATOL_QHAT = 1e-3
WATERSHEDS, DAYS, SEED = 23, 400, 0
TIMED_CALLS = 7      # warm forecasts timed; the median is reported

# LM serving: qwen2-1.5b at full width, 8 requests on 4 slots, prompts of
# 512/510/508/506 tokens, 64 new tokens each, 16-token pages
LM_REQUESTS, LM_SLOTS, LM_PROMPT, LM_GEN, LM_SEED = 8, 4, 512, 64, 0
LM_MAX_LEN = LM_PROMPT + LM_GEN
LM_CHUNK, LM_SPEC_K = 128, 3
ATOL_PAGED_BF16 = 2e-2   # one bf16 ulp at |out| < 4: a score rounds the other way
REL_LOGITS_BF16 = 2 ** -5  # of the largest |logit|: a few bf16 ulps over 28 layers
# fp32 paged attention on the main path's activations, of the output's
# largest |value|: scores there reach ~1e3, where a float32 ulp is ~1e-4,
# and a softmax weight moves by the score's rounding
REL_PAGED_F32 = 2e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def stamp(what: str) -> None:
    print(f"  ({what}: at {time.perf_counter() - T_START:.0f} s)")


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """Least time for the work on the card: bytes moved once over HBM, or
    operations over the peak rate of their type (fp32 outside the tensor
    cores unless given), whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
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


def device_breakdown(fn, top: int = 8, host: bool = True) -> dict:
    """Device time by kernel over one call of ``fn``, from torch.profiler:
    the rows of kernels that ran on the card (None where the profiler saw
    no device activity: not measured). ``host=False`` records the device
    activity alone, which keeps a long run's trace small."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    return {"wall_s": wall,
            "device_busy_s": sum(r[0] for r in rows) * 1e-6 if rows else None,
            "by_kernel": [{"kernel": k[:60], "device_ms": us * 1e-3,
                           "calls": c} for us, k, c in rows[:top]]}


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
    prof = device_breakdown(lambda: fc.forecast(params, placed))
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


# ---------------------------------------------------------------------------
# Phase 2 (paged attention) and phase 4: LM serving of qwen2-1.5b
# ---------------------------------------------------------------------------
def paged_inputs(g, dev, dtype, B, T, Hq, Hkv, D, ps, n, lens, qpos_end=None):
    """A shuffled page pool with ``lens[b]`` cached tokens in slot b (page
    rows of ``n`` entries, -1 past the assigned ones) and queries at the
    last T positions, or at the T positions ending at ``qpos_end[b]``."""
    import torch
    need = [-(-l // ps) for l in lens]
    P = sum(need) + 2
    perm = iter(torch.randperm(P, generator=g).tolist())
    pos = torch.full((P, ps), -1, dtype=torch.int32)
    rows = torch.full((B, n), -1, dtype=torch.int32)
    for b, l in enumerate(lens):
        for j in range(need[b]):
            p = next(perm)
            rows[b, j] = p
            fill = min(ps, l - j * ps)
            pos[p, :fill] = torch.arange(j * ps, j * ps + fill)
    ends = qpos_end or [max(l, T) for l in lens]
    qpos = torch.stack([torch.arange(e - T, e) for e in ends]).to(torch.int32)

    def rn(*shape):
        return torch.randn(shape, generator=g).to(dev, dtype)
    return dict(q=rn(B, T, Hq, D), k_pool=rn(P, ps, Hkv, D),
                v_pool=rn(P, ps, Hkv, D), pos_pool=pos.to(dev),
                page_rows=rows.to(dev), qpos=qpos.to(dev))


def gathered_mask(a, window=0):
    """K/V gathered from the pool into (B, Hkv, L, D) and the boolean mask
    (B, 1, T, L) of attendable keys: the inputs a library attention call
    needs, and what the kernel reads through the page table instead."""
    import torch
    rows = a["page_rows"]
    B, n = rows.shape
    ps = a["pos_pool"].shape[1]
    ok = rows >= 0
    safe = rows.clamp(min=0).long()
    k = a["k_pool"][safe].flatten(1, 2).transpose(1, 2)
    v = a["v_pool"][safe].flatten(1, 2).transpose(1, 2)
    kp = torch.where(ok[:, :, None], a["pos_pool"][safe], -1).reshape(B, n * ps)
    qp = a["qpos"][:, :, None]
    mask = (kp[:, None, :] >= 0) & (kp[:, None, :] <= qp)
    if window:
        mask = mask & (qp - kp[:, None, :] < window)
    return k, v, mask[:, None]


def paged_work(a) -> tuple[float, float]:
    """Bytes the function must move (the assigned pages' K/V rows of
    every KV head and their positions, q, out, the page rows and query
    positions, each once) and its operations (q.k and p.v over the keys
    each query row can attend to: 4 operations a key and dim)."""
    import torch
    B, T, Hq, D = a["q"].shape
    ps, Hkv = a["k_pool"].shape[1], a["k_pool"].shape[2]
    esize = a["q"].element_size()
    pages = int((a["page_rows"] >= 0).sum())
    nbytes = (pages * ps * (2 * Hkv * D * esize + 4) + 2 * a["q"].numel() * esize
              + 4 * (a["page_rows"].numel() + a["qpos"].numel()))
    _, _, mask = gathered_mask(a)
    keys = int(mask.sum()) * Hq            # attendable (row, key) pairs
    return nbytes, 4.0 * keys * D


def check_paged_attn(g, dev) -> dict:
    """The paged-attention kernel against its plain version at the LM main
    path's three shapes (decode T=1 and verify T=4 over 4 slots, a
    128-token prefill chunk of one slot; qwen2-1.5b's 12 query heads on 2
    KV heads, D=128, 16-token pages, 36 pages a slot) in bf16 and fp32,
    and at small shapes with a window, a softcap, unassigned pages and an
    empty row; then times at the main shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attn.ops import paged_attention_fused
    from repro_torch.kernels.paged_attn.ref import paged_attention_ref
    Hq, Hkv, D, PS, N = 12, 2, 128, 16, LM_MAX_LEN // 16
    mid = [LM_PROMPT + LM_GEN // 2 - 2 * i for i in range(4)]   # mid-decode
    main = {"decode": dict(B=4, T=1, lens=mid),
            "verify": dict(B=4, T=LM_SPEC_K + 1, lens=mid),
            "chunk": dict(B=1, T=LM_CHUNK, lens=[3 * LM_CHUNK],
                          qpos_end=[3 * LM_CHUNK])}
    small = [dict(B=3, T=7, Hq=4, Hkv=1, D=64, ps=4, n=6, lens=[13, 0, 9],
                  window=5, softcap=50.0),
             dict(B=2, T=3, Hq=8, Hkv=2, D=128, ps=16, n=3, lens=[20, 33],
                  window=0, softcap=30.0)]
    err = {"float32": 0.0, "bfloat16": 0.0}
    for dtype, atol in ((torch.float32, ATOL_KERNEL),
                        (torch.bfloat16, ATOL_PAGED_BF16)):
        # the main shapes, and the chunk's T over 4 slots as well
        wide = dict(B=4, T=LM_CHUNK, lens=mid)
        cases = [(name, dict(Hq=Hq, Hkv=Hkv, D=D, ps=PS, n=N, window=0,
                             softcap=0.0, **c))
                 for name, c in [*main.items(), ("chunk_4slots", wide)]]
        cases += [(f"small{i}", c) for i, c in enumerate(small)]
        for name, c in cases:
            kw = dict(window=c["window"], softcap=c["softcap"])
            a = paged_inputs(g, dev, dtype, c["B"], c["T"], c["Hq"], c["Hkv"],
                             c["D"], c["ps"], c["n"], c["lens"],
                             c.get("qpos_end"))
            out = paged_attention_fused(**a, **kw)
            torch.cuda.synchronize()
            e = max_err(out.float(), paged_attention_ref(**a, **kw).float())
            tag = str(dtype).split(".")[-1]
            print(f"  paged_attn {name} {tag} B={c['B']} T={c['T']} "
                  f"Hq={c['Hq']} Hkv={c['Hkv']} D={c['D']} ps={c['ps']}: "
                  f"max_abs_err={e:.3e}")
            check(e <= atol, f"paged_attn {name} {tag}: error {e} > {atol}")
            if 0 in c["lens"]:
                check(not out[c["lens"].index(0)].any(), "empty row not 0")
            err[tag] = max(err[tag], e)

    # times at the main shapes: kernel, plain version, and the library's
    # attention over K/V gathered beforehand with the same boolean mask
    shapes = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, c in main.items():
            a = paged_inputs(g, dev, dtype, c["B"], c["T"], Hq, Hkv, D, PS,
                             N, c["lens"], c.get("qpos_end"))
            ms = time_ms(lambda: paged_attention_fused(**a))
            plain_ms = time_ms(lambda: paged_attention_ref(**a), iters=50)
            gather_ms = time_ms(lambda: gathered_mask(a), iters=50)
            k, v, mask = gathered_mask(a)
            q = a["q"].transpose(1, 2)

            def lib():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                      enable_gqa=True)
            lib_err = max_err(lib().transpose(1, 2).float(),
                              paged_attention_fused(**a).float())
            lib_ms = time_ms(lib)
            # bf16 inputs: the tensor cores' bf16 rate; fp32: the CUDA cores'
            b_ms, b_by = bound_ms(*paged_work(a), BF16_OPS_PER_S
                                  if dtype == torch.bfloat16 else FP32_OPS_PER_S)
            tag = str(dtype).split(".")[-1]
            row = {"shape": name, "dtype": tag, "B": c["B"], "T": c["T"],
                   "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "gather_ms": gather_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library_vs_kernel_err": lib_err}
            shapes.append(row)
            print(f"  paged_attn {name} {tag}: kernel {ms * 1e3:.2f} us, plain "
                  f"{plain_ms * 1e3:.2f} us, sdpa {lib_ms * 1e3:.2f} us "
                  f"(+ gather {gather_ms * 1e3:.2f} us; agrees to "
                  f"{lib_err:.1e}), bound {b_ms * 1e3:.3f} us ({b_by})")
    head = shapes[0]                       # bf16 decode, the most launched
    return {"name": "paged_attn", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
            "replaces": "src/repro/kernels/paged_attn/kernel.py:38",
            "max_abs_err": max(err.values()), "max_abs_err_by_dtype": err,
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": "bf16 decode: B=4 T=1 Hq=12 Hkv=2 D=128 ps=16, 36-page "
                     "rows, 34 pages assigned",
            "library": "torch.nn.functional.scaled_dot_product_attention "
                       "(enable_gqa) on K/V gathered beforehand, gather "
                       "timed apart",
            "by_shape": shapes}


def lm_requests(vocab: int) -> list:
    """The launcher's synthetic queue (``make_requests``): LM_REQUESTS
    prompts of 512, 510, 508 and 506 tokens (``--ragged``), LM_GEN new
    tokens each."""
    from types import SimpleNamespace
    from repro_torch.launch.serve import make_requests
    return make_requests(SimpleNamespace(vocab_size=vocab), SimpleNamespace(
        requests=LM_REQUESTS, prompt_len=LM_PROMPT, ragged=True, gen=LM_GEN,
        seed=LM_SEED))


def serve_once(cfg, dev, params, dtype, mode: dict, ops=None,
               profile: bool = False) -> dict:
    """One served run of the queue through the port's Scheduler with the
    launch counts set to 0 just before and read just after. Returns the
    streams, the stats, tok/s, decode tok/s, TTFT p50 and the launches."""
    import torch
    from repro_torch.kernels.lstm_cell.ops import lstm_cell_fused
    from repro_torch.kernels.paged_attn.ops import paged_attention_fused
    from repro_torch.kernels.pixcon.ops import pixcon_gate
    from repro_torch.models import transformer as tfm
    from repro_torch.obs import Tracer, derive_request_metrics, percentiles
    from repro_torch.serve import InferenceEngine, NgramDrafter, Scheduler
    eng = InferenceEngine(cfg, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                          page_size=16, dtype=dtype, device=dev,
                          prefill_chunk=mode.get("prefill_chunk", 0),
                          ops=ops or tfm.KERNELS)
    tracer = Tracer()
    sched = Scheduler(eng, eng.init_state(params), tracer=tracer,
                      spec_k=mode.get("spec_k", 0),
                      drafter=NgramDrafter() if mode.get("spec_k") else None)
    reqs = lm_requests(cfg.vocab_size)
    torch.cuda.synchronize()
    pixcon_gate.launches = lstm_cell_fused.launches = 0
    paged_attention_fused.launches = 0
    t0 = time.perf_counter()
    gen = sched.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"pixcon": pixcon_gate.launches,
                "lstm_cell": lstm_cell_fused.launches,
                "paged_attn": paged_attention_fused.launches}
    st = dict(sched.stats)
    ttft = [m["ttft_s"] for m in derive_request_metrics(tracer.events()).values()]
    out = {"gen": gen, "stats": st, "wall_s": wall,
           "tok_per_s": sum(len(g) for g in gen.values()) / wall,
           "decode_tok_per_s": st["decode_tokens"] / max(st["decode_s"], 1e-9),
           "prefill_tok_per_s": st["prefill_tokens"] / max(st["prefill_s"], 1e-9),
           "ttft_p50_s": percentiles(ttft)["p50"],
           "ttft_p99_s": percentiles(ttft)["p99"],
           "accepted_tok_per_step": st["decode_tokens"]
           / max(st["decode_slot_steps"], 1),
           "launches": launches}
    if profile:
        sched2 = Scheduler(eng, eng.init_state(params),
                           spec_k=mode.get("spec_k", 0),
                           drafter=NgramDrafter() if mode.get("spec_k") else None)
        out["profile"] = device_breakdown(
            lambda: sched2.run(lm_requests(cfg.vocab_size)), top=10,
            host=False)
    return out


def same_tokens(a: dict, b: dict) -> float:
    """Share of positions where two runs' streams hold the same token."""
    tot = same = 0
    for rid in a:
        for x, y in zip(a[rid], b[rid]):
            tot += 1
            same += int(x == y)
    return same / max(tot, 1)


def first_parting(a: dict, b: dict) -> dict:
    """Per request, the first position where two runs' streams differ
    (None where they agree throughout)."""
    out = {}
    for rid in a:
        diff = [i for i, (x, y) in enumerate(zip(a[rid], b[rid])) if x != y]
        out[rid] = diff[0] if diff else None
    return out


def decode_logits_check(cfg, dev, params, dtype, cpu_control=False) -> dict:
    """Admit LM_SLOTS requests by whole-prompt prefill, then run one
    decode_step_paged through the kernel and one through the plain
    version on copies of the same state. Returns the logits' largest
    difference over their largest magnitude, whether each slot's argmax
    agrees, and each slot's gap between its two largest logits. With
    ``cpu_control``, the plain version also runs on the CPU from the same
    state: the difference two correct float32 runs show at this width."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import InferenceEngine
    eng = InferenceEngine(cfg, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                          page_size=16, dtype=dtype, device=dev)
    state = eng.init_state(params)
    reqs = lm_requests(cfg.vocab_size)[:LM_SLOTS]
    for s, r in enumerate(reqs):
        pages = list(range(s * eng.pages_per_slot, (s + 1) * eng.pages_per_slot))
        state = eng.assign_pages(state, s, pages)
        state, _ = eng.insert(state, {"tokens": r.prompt[None]}, s)

    def step(p, cache, ops, d):
        act = torch.ones(LM_SLOTS, dtype=torch.bool, device=d)
        with torch.inference_mode():
            lg, _ = tfm.decode_step_paged(
                p, cfg, {"tokens": state.last_tok[:, None].to(d)},
                [type(c)(*(t.to(d, copy=True) for t in c)) for c in cache],
                state.positions.to(d), state.page_table.to(d), act,
                dtype=dtype, ops=ops)
        return lg.float().cpu()
    kern = step(state.params, state.cache, tfm.KERNELS, dev)
    plain = step(state.params, state.cache, tfm.PLAIN, dev)
    scale = float(plain.abs().max())
    top2 = plain.topk(2, dim=-1).values
    out = {"rel_err": max_err(kern, plain) / scale,
           "argmax_equal": (kern.argmax(-1) == plain.argmax(-1)).tolist(),
           "top2_gap": (top2[:, 0] - top2[:, 1]).tolist(), "scale": scale}
    if cpu_control:
        cpu = step(tfm.cast_params(state.params, dtype, torch.device("cpu")),
                   state.cache, tfm.PLAIN, torch.device("cpu"))
        out["cpu_rel_err"] = max_err(cpu, plain) / scale
        out["cpu_argmax_equal"] = (cpu.argmax(-1) == plain.argmax(-1)).tolist()
    return out


class CheckedAttn:
    """Paged attention that runs the kernel and its plain version on the
    same inputs, keeps the largest difference over the output's largest
    magnitude, and returns the plain result. Its launches serve only the
    comparison; the main path's counts come from the runs above."""

    def __init__(self):
        self.calls, self.max_rel = 0, 0.0

    def __call__(self, *args, **kw):
        from repro_torch.kernels.paged_attn.ops import paged_attention_fused
        from repro_torch.kernels.paged_attn.ref import paged_attention_ref
        ker = paged_attention_fused(*args, **kw)
        out = paged_attention_ref(*args, **kw)
        scale = max(float(out.abs().max()), 1e-30)
        self.max_rel = max(self.max_rel, max_err(ker.float(), out.float()) / scale)
        self.calls += 1
        return out


def well_conditioned(cfg, params):
    """The params with wq, wk, wv scaled to std 1/sqrt(d_model) and wo to
    1/sqrt(Hq*D): unit-variance projections. The reference's law (std
    1/sqrt(shape[-2])) gives wq std 1/sqrt(Hq) and attention scores with a
    spread in the hundreds."""
    d, hq, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    out = dict(params, layers=[])
    for lp in params["layers"]:
        a = dict(lp["attn"], wq=lp["attn"]["wq"] * (hq / d) ** 0.5,
                 wk=lp["attn"]["wk"] * (hkv / d) ** 0.5,
                 wv=lp["attn"]["wv"] * (hkv / d) ** 0.5,
                 wo=lp["attn"]["wo"] / hq ** 0.5)
        out["layers"].append(dict(lp, attn=a))
    return out


def lm_main_path(dev) -> dict:
    """qwen2-1.5b at full width, random weights from the port's init (seed
    0), served through the port's Scheduler in bf16 in three modes; then
    the kernel's run held against the plain version's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    cfg = get_config("qwen2-1.5b")
    t0 = time.perf_counter()
    p32 = tfm.init(cfg, torch.Generator(device=dev).manual_seed(LM_SEED))
    pbf = tfm.cast_params(p32, torch.bfloat16, dev)
    torch.cuda.synchronize()
    nparams = sum(t.numel() for t in _leaves(p32))
    print(f"  qwen2-1.5b params: {nparams / 1e9:.3f} B, init "
          f"{time.perf_counter() - t0:.1f} s")
    modes = {"whole": {}, "chunked": {"prefill_chunk": LM_CHUNK},
             "spec": {"spec_k": LM_SPEC_K}}
    serve_once(cfg, dev, pbf, torch.bfloat16, {"prefill_chunk": LM_CHUNK})
    runs, total = {}, 0
    for name, mode in modes.items():
        r = serve_once(cfg, dev, pbf, torch.bfloat16, mode, profile=True)
        total += r["launches"]["paged_attn"]
        n_tok = sum(len(x) for x in r["gen"].values())
        check(n_tok == LM_REQUESTS * LM_GEN, f"{name}: {n_tok} tokens")
        check(all(0 <= t < cfg.vocab_size for x in r["gen"].values() for t in x),
              f"{name}: token outside the vocab")
        check(r["launches"]["paged_attn"] > 0, f"{name}: paged_attn not launched")
        check(r["launches"]["pixcon"] == r["launches"]["lstm_cell"] == 0,
              f"{name}: a Dom-ST kernel ran on the LM path")
        prof = r.pop("profile")
        rows = prof["by_kernel"]
        r["profiled_wall_s"] = prof["wall_s"]
        r["profiled_device_busy_s"] = prof["device_busy_s"]
        r["device_time_by_kernel"] = rows
        runs[name] = r
        print(f"  {name} bf16: {r['tok_per_s']:.1f} tok/s, decode "
              f"{r['decode_tok_per_s']:.1f} tok/s, prefill "
              f"{r['prefill_tok_per_s']:.1f} tok/s, TTFT p50 "
              f"{r['ttft_p50_s']:.4f} s, wall {r['wall_s']:.3f} s, paged_attn "
              f"launches {r['launches']['paged_attn']}, accepted/step "
              f"{r['accepted_tok_per_step']:.3f}, stats "
              f"{ {k: r['stats'][k] for k in ('prefill_chunks', 'decode_steps', 'spec_proposed', 'spec_accepted')} }")
        busy = prof["device_busy_s"]
        print(f"    profiled repeat: wall {prof['wall_s']:.3f} s, device busy "
              f"{'not measured' if busy is None else f'{busy:.3f} s'}; "
              "top kernels:")
        for row in rows:
            print(f"      {row['device_ms']:9.2f} ms {row['calls']:7d}x "
                  f"{row['kernel']}")
    # streams are a pure function of (prompt, params): in bf16 the modes
    # round differently, so only the share of equal tokens is printed
    for name in ("chunked", "spec"):
        print(f"  bf16 streams, {name} vs whole: "
              f"{same_tokens(runs[name]['gen'], runs['whole']['gen']):.3f} equal")

    stamp("bf16 served runs done")
    # the kernel against the plain version, end to end on the card
    bf = decode_logits_check(cfg, dev, pbf, torch.bfloat16)
    rel = bf["rel_err"]
    print(f"  bf16 decode_step_paged logits, kernel vs plain: "
          f"{rel:.3e} of the largest |logit| (tolerance {REL_LOGITS_BF16}); "
          f"argmax equal {bf['argmax_equal']}")
    check(rel <= REL_LOGITS_BF16, f"bf16 decode logits differ by {rel}")
    bf_plain = serve_once(cfg, dev, pbf, torch.bfloat16, modes["whole"],
                          ops=tfm.PLAIN)
    check(bf_plain["launches"]["paged_attn"] == 0, "the plain run launched")
    share = same_tokens(runs["whole"]["gen"], bf_plain["gen"])
    print(f"  bf16 whole-prefill streams, kernel vs plain: {share:.3f} equal")
    del pbf
    # fp32 on the main path's weights: the reference's init law makes the
    # 28-layer model chaotic (attention scores in the hundreds), so two
    # correct float32 runs part within a few tokens; the CPU control shows
    # by how much. Each launch is held against the plain version instead.
    stamp("bf16 checks done")
    f32_logits = decode_logits_check(cfg, dev, p32, torch.float32,
                                     cpu_control=True)
    stamp("fp32 logits and CPU control done")
    print(f"  fp32 decode_step_paged logits: kernel vs plain "
          f"{f32_logits['rel_err']:.3e}, plain on the card vs on the CPU "
          f"{f32_logits['cpu_rel_err']:.3e} of the largest |logit| "
          f"({f32_logits['scale']:.3f}); argmax equal kernel/plain "
          f"{f32_logits['argmax_equal']}, card/CPU "
          f"{f32_logits['cpu_argmax_equal']}")
    f32 = {}
    for name, mode in modes.items():
        checked = CheckedAttn()
        serve_once(cfg, dev, p32, torch.float32, mode,
                   ops=tfm.KernelOps(checked))
        f32[name] = {"checked_launches": checked.calls,
                     "max_rel_err": checked.max_rel}
        print(f"  {name} fp32, every launch held against the plain version: "
              f"{checked.calls} launches, max error {checked.max_rel:.3e} of "
              f"the output's largest |value| (tolerance {REL_PAGED_F32})")
        check(checked.calls > 0 and checked.max_rel <= REL_PAGED_F32,
              f"fp32 {name}: kernel differs from plain by {checked.max_rel}")

    # fp32 greedy streams, kernel against plain, at full width on the same
    # weights with the attention projections rescaled to unit-variance
    # outputs, where float32 runs are reproducible
    stamp("fp32 per-launch checks done")
    well = well_conditioned(cfg, p32)
    del p32
    for name, mode in modes.items():
        k = serve_once(cfg, dev, well, torch.float32, mode)
        p = serve_once(cfg, dev, well, torch.float32, mode, ops=tfm.PLAIN)
        check(k["launches"]["paged_attn"] > 0 and
              p["launches"]["paged_attn"] == 0, "launch counts")
        same = k["gen"] == p["gen"]
        f32[name].update({"kernel_tok_per_s": k["tok_per_s"],
                          "plain_tok_per_s": p["tok_per_s"],
                          "streams_equal": same,
                          "equal_share": same_tokens(k["gen"], p["gen"]),
                          "first_parting": first_parting(k["gen"], p["gen"])})
        print(f"  {name} fp32, rescaled weights: kernel {k['tok_per_s']:.1f} "
              f"tok/s, plain {p['tok_per_s']:.1f} tok/s, greedy streams "
              f"equal: {same} (first parting {f32[name]['first_parting']})")
        check(same, f"fp32 {name}: kernel and plain streams differ")
    keep = ("prefill_chunks", "decode_steps", "decode_tokens",
            "prefill_tokens", "spec_steps", "spec_proposed", "spec_accepted")
    summary = {name: {**{k: v for k, v in r.items()
                         if k not in ("gen", "stats")},
                      **{k: r["stats"][k] for k in keep}}
               for name, r in runs.items()}
    print("  " + json.dumps({"lm": summary, "fp32": f32,
                             "fp32_logits": f32_logits,
                             "bf16_logits_rel_err": rel,
                             "bf16_kernel_vs_plain_equal_share": share}))
    return {"paged_attn": total,
            "by_mode": {n: r["launches"]["paged_attn"] for n, r in runs.items()}}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


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
    print(f"[2] kernels against their plain versions (at {time.perf_counter() - T_START:.0f} s)")
    kernels = [check_pixcon(g, dev), check_lstm(g, dev), check_paged_attn(g, dev)]
    print(f"[3] main path: Forecaster, domst, 23 watersheds x 400 days (at {time.perf_counter() - T_START:.0f} s)")
    launches, device_ms = main_path(dev)
    print(f"[4] main path: paged LM serving, qwen2-1.5b, 8 requests x 64 tokens (at {time.perf_counter() - T_START:.0f} s)")
    lm = lm_main_path(dev)
    launches["paged_attn"] = lm["paged_attn"]
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["name"] in device_ms:
            k["device_ms_per_launch_on_main_path"] = device_ms[k["name"]]
        check(k["launches"] > 0, f"{k['name']} was not launched on the main path")
    kernels[-1]["launches_by_mode"] = lm["by_mode"]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
