#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on a failed check:

1. the card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel of the port's paths from ``src/repro_torch/
   kernels/csrc``, timed (one ``nvcc`` per source, all six at once), with
   the registers and spills ``ptxas -v`` reports; a spill store in a bf16,
   D=256 instantiation of the two attention kernels (local attention on
   the tensor cores, paged attention and its merge) or in any
   instantiation of the SSD chunk's bf16 (tensor-core) kernel fails the
   run;
2. each kernel against its plain PyTorch version on the card, at its
   main path's shapes and at ragged ones, 1e-5 abs in fp32 (bf16 within
   2e-2, one bf16 ulp at |out| < 4; the SSD chunk's bf16 y within one
   bf16 ulp at every magnitude, ``RTOL_BF16_ULP``, with the share of its
   elements that differ from the plain output at all): Pix-Con (also
   ``normalize=False``, a temperature other than 1, and near ties: pixels
   whose features differ in one last bit, ``w`` to the bit and the same
   ranking; and the training shapes R=23 B=32, R=23 B=8, R=1 B=32),
   the LSTM step (also the same training shapes, H not a multiple
   of its 8-unit tile, D=1, and D+H that walks the weight ring), paged
   attention
   (decode, verify and a 128-token prefill chunk of qwen2-1.5b, plus small
   shapes with a window, a softcap, unassigned pages and an empty row),
   the causal conv1d (mamba2-130m's and recurrentgemma-2b's prefill and
   step shapes, C not a multiple of 128 or of the 8-channel vector, S=1
   and S=2 with a tail, S > 2,048, S < K-1, an input viewed at an odd
   storage offset, at a decode size and at a size the 16-byte path would
   take, which must go the scalar path; K=5; the new tail it writes to the
   bit), the SSD chunk (mamba2-130m's 512-token prefill, Q in {5, 200,
   256}, and the bf16 kernel's tile edges: Q from 1 to 256 on each side
   of 16 and 64, N in {16, 20, 128}, P in {24, 64}, 2 batch rows of 2
   chunks, in both dtypes) and local attention (recurrentgemma-2b's
   2,560- and 600-token
   prefills, S not a tile multiple, non-causal, Hkv = Hq and MQA); the
   time of a launch, of the plain version and of one PyTorch call
   computing the same function where there is one (``torch.lstm_cell``;
   ``scaled_dot_product_attention`` over K/V gathered beforehand, the
   gather timed apart, or with a boolean band mask; ``F.conv1d`` with
   ``groups=C``, SiLU timed apart) — yardsticks only: the port never
   calls them — beside the bound; for each timed paged-attention shape,
   the split of the page rows over blocks (pages a split, splits,
   blocks); and for Pix-Con, the LSTM step, conv1d and the SSD chunk,
   beside each timed shape, the host time of a call (``host_us``) and the
   device time of a launch (``device_us``, torch.profiler);
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
4. Dom-ST training at full width: the ``domst`` config, 23 watersheds,
   400 days (296 training windows each, 9 steps an epoch at batch 32),
   5 epochs = 45 stacked AdamW steps from the port's init with a fixed
   seed, through the train CLI's loop (``Engine``, ``ShardedLoader``
   with prefetch 2). With the launch counts set to 0 it must launch 45
   Pix-Con and 2,700 LSTM-step kernels (the backward launches none: it
   runs autograd through the plain versions); every loss must be finite
   and the last epoch's mean loss below the first's; the held-out NSE
   by watershed is printed before and after, with the median
   synchronised step time and windows/s. A repeat of 3 steps gives the
   device span (CUDA events), the device busy time and time by kernel
   (torch.profiler) and so the idle share. Kernels against plain: the
   same pixel permutations, every gradient leaf within 1e-4 of its
   largest |grad|, then 5 steps each with losses within 1e-4 relative;
   ``accum_steps=4`` gives one batch's SGD update (the step's momentum
   buffer, the clipped gradient) within 1e-5 of each leaf's largest
   |update|. The train CLI then runs the same training
   (its launches: the 45 steps' and one held-out forward's) and saves
   its checkpoint, which the serve CLI restores into the ``Forecaster``:
   its forecast of the 74 held-out days must give eval_step's NSE within
   1e-4. Last, the train CLI's sequential mode (3 watersheds, 1 epoch, one
   replica each; launch counts checked alike);
5. the LM main path: qwen2-1.5b at full width, random weights from the
   port's init (seed 0), 8 requests on 4 slots (prompts of 512/510/508/
   506 tokens, 64 new tokens each, 16-token pages) served in bf16 through
   the port's Scheduler three times — whole-prompt prefill, 128-token
   prefill chunks, ``spec_k=3`` with the n-gram drafter — each with the
   launch counts set to 0 just before and read just after (paged_attn
   must be > 0, every other kernel 0), printing tok/s, decode tok/s, TTFT
   p50 and, from a profiled repeat of whole prefill, the device time by
   kernel. Then the kernel against its plain version end to end: one bf16
   ``decode_step_paged`` on the admitted state (logits within 2^-5 of
   their largest magnitude) and the share of equal tokens in bf16
   streams; in fp32, one decode step's logits, kernel against plain and
   plain on the card against plain on the CPU (how far two correct
   float32 runs of this chaotic random model part), every launch of the
   three served runs held against the plain version on the same inputs
   (within 2e-3 of the output's largest magnitude), and the greedy
   streams, kernel against plain, equal in all three modes on the same
   weights with the attention projections rescaled to unit variance;
6. recurrentgemma-2b at full width (26 layers, d 2,560, vocab 256,000,
   random weights from the port's init, seed 0, bf16, 16-token pages) on
   4 slots: whole-prompt prefill of prompts of 2,560/2,300/600/512 tokens
   (past the 2,048-token window), and 128-token chunks and ``spec_k=3``
   on prompts of 512/510/508/506 tokens, 32 new tokens each; launch
   counts per mode (whole and spec, which admits each prompt whole:
   local_attn, conv1d, paged_attn > 0; chunked: conv1d, paged_attn > 0,
   local_attn 0; ssd_chunk and the Dom-ST kernels 0), tok/s, decode tok/s, TTFT p50/p99, the device time
   by kernel of a profiled repeat of whole prefill; then the kernels
   against their plain versions: one bf16 decode step's logits on the
   admitted state (2^-5), every launch of an fp32 whole-prefill run held
   against the plain versions (2e-3), and fp32 greedy streams, kernels
   against plain, equal on the weights with rescaled attention
   projections (on the main path's weights printed);
7. mamba2-130m at full width (24 layers, d 768, state 128, chunk 256):
   qwen2-1.5b's queue in the three modes (whole and spec: ssd_chunk and
   conv1d > 0; chunked: ssd_chunk 0; every mode: paged_attn 0), the same measurements and checks, its
   profiled repeat one wave of 4 requests x 32 tokens;
8. one JSON line listing every ported kernel with its error, times, bound
   and launches (by model and mode; Pix-Con and the LSTM step by path,
   forecast and training, with their times at the training shapes), then
   the line with the card's name and power limit;
9. the last line, ``{"ok": true, "device": {...}}``.

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
# Dom-ST training: the train CLI's defaults (AdamW, batch 32 a watershed)
# over 5 epochs of 296 training windows a watershed, 9 steps an epoch
TRAIN_EPOCHS, TRAIN_BATCH, TRAIN_SEQ_WATERSHEDS = 5, 32, 3
# kernel shapes of training: stacked, accumulated (4 microbatches of 8),
# sequential (one replica)
TRAIN_RB = ((WATERSHEDS, TRAIN_BATCH), (WATERSHEDS, TRAIN_BATCH // 4),
            (1, TRAIN_BATCH))
# gradients through the kernels against the plain run's, of each leaf's
# largest |grad|; the losses of 5 steps, relative; accumulation against
# one batch, of each leaf's largest |update| (one unclipped SGD step's
# direction), and of the gradient norms, relative
GRAD_REL, LOSS_REL, ACCUM_REL = 1e-4, 1e-4, 1e-5
PROFILE_STEPS = 3

# LM serving: qwen2-1.5b at full width, 8 requests on 4 slots, prompts of
# 512/510/508/506 tokens, 64 new tokens each, 16-token pages
LM_REQUESTS, LM_SLOTS, LM_PROMPT, LM_GEN, LM_SEED = 8, 4, 512, 64, 0
LM_LENS = [LM_PROMPT - (i % 4) * 2 for i in range(LM_REQUESTS)]
LM_MAX_LEN = LM_PROMPT + LM_GEN
LM_CHUNK, LM_SPEC_K = 128, 3
# The recurrent models' queues on 4 slots, by mode, and the queue of the
# profiled repeat of whole prefill. recurrentgemma-2b: whole prefill with
# prompts past its 2,048-token window (local_attn's band, the ring-to-pages
# fill and paged_attn's window all do real work); chunked prefill and
# speculative verify step each recurrent layer through a prompt's tokens,
# so they take 512-token prompts. mamba2-130m: qwen2-1.5b's queue in all
# three modes; its profiled repeat is one wave (4 requests, 32 tokens):
# the profiler's post-processing of the whole queue's ~150,000 launches
# would cost about a minute.
RG_STEP_LENS = LM_LENS[:4]
RECURRENT_RUNS = {
    "recurrentgemma-2b": {
        "lens": {"whole": [2560, 2300, 600, 512], "chunked": RG_STEP_LENS,
                 "spec": RG_STEP_LENS},
        "gen": 32, "profile": ([2560, 2300, 600, 512], 32)},
    "mamba2-130m": {
        "lens": {"whole": LM_LENS, "chunked": LM_LENS, "spec": LM_LENS},
        "gen": LM_GEN, "profile": (LM_LENS[:4], 32)},
}
# bf16 outputs: one bf16 ulp at |out| < 4, where a float32 result (or a
# score rounded through bf16) that differs in its last bit rounds the other way
ATOL_BF16 = 2e-2
# The SSD chunk's bf16 y (|y| reaches ~140): one bf16 ulp at every magnitude.
# bf16 keeps 8 significant bits, so an ulp is 2^-7 of its binade's lower
# edge, between 2^-8 and 2^-7 of |y|; below |y| = 4 the 2e-2 floor holds.
# A tensor-core product sums in another order than the plain version, so a
# y near a bf16 rounding boundary lands on the neighbouring value.
RTOL_BF16_ULP = 2 ** -7
# The SSD chunk's float32 y at its tile edges (Q from 1 to 256): the plain
# version's C @ B^T is a batched matmul whose summation order depends on
# the shape (at Q=1 it is another than at the model's Q=256, where the
# kernel agrees to the bit), and |y| reaches ~150, where one float32 ulp
# is ~1.5e-5. So 1e-5 plus 2^-22 of |y| (two to four float32 ulps); the
# main-path and ragged cases keep 1e-5.
RTOL_F32_EDGE = 2 ** -22
REL_LOGITS_BF16 = 2 ** -5  # of the largest |logit|: a few bf16 ulps over the layers
# fp32 kernels on the main path's activations, of the output's largest
# |value|: attention scores there reach ~1e3, where a float32 ulp is
# ~1e-4, and a softmax weight moves by the score's rounding
REL_F32 = 2e-3
# The speculative mode's weights: unit-variance attention projections and
# every layer's output projection scaled by DAMP (see ``damped``). Each
# layer then adds ~1e-3 a channel to a residual stream whose embedding is
# ~2e-2 a channel (std 0.02 without an embedding scale, qwen2 and mamba2;
# ~1 with one, recurrentgemma). Under the init law alone an attention
# layer adds ~1e2 a channel (``well_conditioned``), too much to damp.
DAMP, DAMPED = 1e-3, ("wo", "w_down", "w_out")


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


def time_in_turns(fns, rounds: int = 5, iters: int = 200) -> list:
    """Median time of one call of each of ``fns`` (``time_ms``), timed in
    turns over ``rounds`` rounds: the host's load drifts within a run, and
    calls whose time is the host's are compared only side by side."""
    runs = [[] for _ in fns]
    for _ in range(rounds):
        for r, fn in zip(runs, fns):
            r.append(time_ms(fn, iters=iters))
    return [sorted(r)[len(r) // 2] for r in runs]


def max_err(a, b) -> float:
    return float((a - b).abs().max())


# ---------------------------------------------------------------------------
# Host time of a wrapper call
# ---------------------------------------------------------------------------
# calls timed by the host clock, no synchronise inside: 5 runs of 200 (a
# kernel that takes longer on the card than its call on the host falls
# only ~200 launches behind, short of filling the launch queue)
HOST_CALLS, HOST_RUNS = 200, 5


def host_us(fn, calls: int = HOST_CALLS, repeats: int = HOST_RUNS) -> float:
    """Host time of one call of ``fn`` in microseconds: the host clock over
    ``calls`` calls with no synchronise inside (the card runs behind),
    median of ``repeats`` runs."""
    import torch
    for _ in range(20):
        fn()
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return sorted(runs)[len(runs) // 2]


def launch_device_us(fn, symbol: str, n: int = 50) -> float | None:
    """Device time of one launch of ``fn``'s kernel (torch.profiler over
    ``n`` calls; every kernel whose name holds ``symbol``)."""
    prof = device_breakdown(lambda: [fn() for _ in range(n)], top=64,
                            host=False)
    rows = [r for r in prof["by_kernel"] if symbol in r["kernel"]]
    return sum(r["device_ms"] for r in rows) * 1e3 / n if rows else None


def conv_args(g, dev, dtype, B, S, C, K, tail) -> dict:
    return dict(x=rn(g, dev, B, S, C).to(dtype),
                w=rn(g, dev, K, C, s=0.5).to(dtype),
                b=rn(g, dev, C, s=0.1).to(dtype),
                tail=rn(g, dev, B, K - 1, C).to(dtype) if tail else None)


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


def pixcon_near_ties(g, dev, R, B, T, P):
    """Pix-Con inputs whose pixels come in pairs: the second of a pair has
    the first's features with one of them moved by one float32 ulp, so the
    two gate weights lie a few ulp apart or tie."""
    import torch
    a = pixcon_inputs(g, dev, R, B, T, P)
    f = a["feats"]
    moved = f[:, :, 0::2].clone()
    k = (torch.arange(moved.shape[2], device=dev) % f.shape[-1]).view(1, 1, -1, 1)
    k = k.expand(R, B, -1, 1)
    col = moved.gather(-1, k)
    moved.scatter_(-1, k, torch.nextafter(col, torch.full_like(col, float("inf"))))
    f[:, :, 1::2] = moved[:, :, :P // 2]
    return a


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
    cases += [((R, B, 30, 64), True, 1.0) for R, B in TRAIN_RB]
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
    # near ties: pixels in pairs whose features differ in one last bit; w
    # to the bit and the same ranking (P=50 takes the scalar write path)
    for shape in ((WATERSHEDS, 1, 30, 64), (3, 2, 7, 50)):
        a = pixcon_near_ties(g, dev, *shape)
        out, w = pixcon_gate(**a)
        torch.cuda.synchronize()
        ref_out, ref_w = pixcon_gate_ref(**a)
        e = max(max_err(out, ref_out), max_err(w, ref_w))
        same_rank = torch.equal(torch.argsort(-w, dim=-1, stable=True),
                                torch.argsort(-ref_w, dim=-1, stable=True))
        srt = torch.sort(ref_w, dim=-1, descending=True).values
        gaps = srt[..., :-1] - srt[..., 1:]
        print(f"  pixcon near ties {shape}: max_abs_err={e:.3e}, same "
              f"ranking {same_rank}, smallest gap "
              f"{float(gaps[gaps > 0].min()):.3e}, exact ties "
              f"{int((gaps == 0).sum())}")
        check(e == 0 and same_rank, f"pixcon near ties {shape}: error {e}, "
              f"same ranking {same_rank}")
    shape = (WATERSHEDS, 1, 30, 64)
    a = pixcon_inputs(g, dev, *shape)
    ms = time_ms(lambda: pixcon_gate(**a))
    call_host_us = host_us(lambda: pixcon_gate(**a))
    device_us = launch_device_us(lambda: pixcon_gate(**a), "pixcon_gate_kernel")
    plain_ms = time_ms(lambda: pixcon_gate_ref(**a))
    b_ms, b_by = bound_ms(*pixcon_work(*shape))
    print(f"  pixcon {shape}: kernel {ms * 1e3:.2f} us (host "
          f"{call_host_us:.2f} us a call, device {device_us} us a launch), "
          f"plain {plain_ms * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us ({b_by})")
    tshape = (*TRAIN_RB[0], 30, 64)
    t = pixcon_inputs(g, dev, *tshape)
    t_b_ms, t_b_by = bound_ms(*pixcon_work(*tshape))
    training = {"shape": "R=23 B=32 T=30 P=64 F=4 Hp=32",
                "ms": time_ms(lambda: pixcon_gate(**t)),
                "device_us": launch_device_us(lambda: pixcon_gate(**t),
                                              "pixcon_gate_kernel"),
                "plain_ms": time_ms(lambda: pixcon_gate_ref(**t)),
                "bound_ms": t_b_ms, "bound_by": t_b_by}
    print(f"  pixcon {tshape} (training): kernel {training['ms'] * 1e3:.2f} "
          f"us (device {training['device_us']} us a launch), plain "
          f"{training['plain_ms'] * 1e3:.2f} us, bound {t_b_ms * 1e3:.3f} us "
          f"({t_b_by})")
    return {"name": "pixcon", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/pixcon.cu",
            "replaces": "src/repro/kernels/pixcon/kernel.py:23",
            "max_abs_err": err, "ms": ms, "host_us": call_host_us,
            "device_us": device_us, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": "R=23 B=1 T=30 P=64 F=4 Hp=32",
            "library": "none: no one PyTorch call computes it",
            "training": training}


def check_lstm(g, dev) -> dict:
    import torch
    from repro_torch.kernels.lstm_cell.ops import lstm_cell_fused
    from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref
    from repro_torch.kernels.lstm_cell import ops as lstm_ops
    err = 0.0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    main_shapes = [(WATERSHEDS, 1, 128, 64), (WATERSHEDS, 1, 64, 64)]
    # beside them: several examples a block, H not a multiple of the unit
    # tile, D = 1, and a K that walks the weight tile through the ring
    train_shapes = [(R, B, D, 64) for R, B in TRAIN_RB for D in (128, 64)]
    for shape in main_shapes + train_shapes + [
            (3, 5, 48, 160), (1, WATERSHEDS, 128, 64), (4, 2, 7, 50),
            (5, 3, 1, 64), (2, 3, 4000, 64)]:
        a = lstm_inputs(g, dev, *shape)
        h, c = lstm_cell_fused(**a)
        torch.cuda.synchronize()
        ref_h, ref_c = lstm_cell_ref(**a)
        e = max(max_err(h, ref_h), max_err(c, ref_c))
        p = lstm_ops.plan_lstm(*shape, sms)
        print(f"  lstm_cell (R,B,D,H)={shape}: max_abs_err={e:.3e}, "
              f"{p.blocks} blocks of {p.bt} x {p.ju}, {p.stages} stage(s) "
              f"of {p.rows} rows, {p.smem} B shared memory")
        check(e <= ATOL_KERNEL, f"lstm_cell {shape}: error {e} > {ATOL_KERNEL}")
        err = max(err, e)
    # Times per launch, averaged over the two layers' shapes: the forecast
    # launches each equally often (74 days x 30 steps).
    ms, plain_ms, b_ms, lib_ms, lib_shape_ms, hosts, devs = ([] for _ in range(7))
    for R, B, D, H in main_shapes:
        a = lstm_inputs(g, dev, R, B, D, H)
        ms.append(time_ms(lambda: lstm_cell_fused(**a)))
        hosts.append(host_us(lambda: lstm_cell_fused(**a)))
        devs.append(launch_device_us(lambda: lstm_cell_fused(**a),
                                     "lstm_cell_kernel"))
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
        lib_t, kernel_t = time_in_turns([
            lambda: torch.lstm_cell(x1, (h1, c1), w_ih, w_hh, b_ih, b_hh),
            lambda: lstm_cell_fused(**one)])
        lib_ms.append(lib_t)
        lib_shape_ms.append(kernel_t)
        print(f"  lstm_cell (R,B,D,H)={(R, B, D, H)}: kernel "
              f"{ms[-1] * 1e3:.2f} us (host {hosts[-1]:.2f} us a call, "
              f"device {devs[-1]} us a launch), "
              f"plain {plain_ms[-1] * 1e3:.2f} us, "
              f"bound {b_ms[-1][0] * 1e3:.3f} us ({b_ms[-1][1]}); at R=1 B=23: "
              f"torch.lstm_cell {lib_ms[-1] * 1e3:.2f} us, kernel "
              f"{lib_shape_ms[-1] * 1e3:.2f} us (agree to {e:.1e})")

    def mean(v):
        return sum(v) / len(v)
    # the training shapes of the stacked run's two layers, timed alike
    t_ms, t_dev, t_plain, t_bound = [], [], [], []
    for R, B, D, H in train_shapes[:2]:
        a = lstm_inputs(g, dev, R, B, D, H)
        t_ms.append(time_ms(lambda: lstm_cell_fused(**a)))
        t_dev.append(launch_device_us(lambda: lstm_cell_fused(**a),
                                      "lstm_cell_kernel"))
        t_plain.append(time_ms(lambda: lstm_cell_ref(**a)))
        t_bound.append(bound_ms(*lstm_work(R, B, D, H)))
        print(f"  lstm_cell (R,B,D,H)={(R, B, D, H)} (training): kernel "
              f"{t_ms[-1] * 1e3:.2f} us (device {t_dev[-1]} us a launch), "
              f"plain {t_plain[-1] * 1e3:.2f} us, bound "
              f"{t_bound[-1][0] * 1e3:.3f} us ({t_bound[-1][1]})")
    training = {"shape": "R=23 B=32 H=64, D=128 and D=64 (mean of the two "
                         "layers)",
                "ms": mean(t_ms), "device_us_by_layer": t_dev,
                "plain_ms": mean(t_plain),
                "bound_ms": mean([b for b, _ in t_bound]),
                "bound_by": t_bound[0][1]}
    return {"name": "lstm_cell", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lstm_cell.cu",
            "replaces": "src/repro/kernels/lstm_cell/kernel.py:18",
            "max_abs_err": err, "ms": mean(ms), "host_us": mean(hosts),
            "device_us_by_layer": devs, "plain_ms": mean(plain_ms),
            "bound_ms": mean([b for b, _ in b_ms]),
            "bound_by": b_ms[0][1], "library_ms": mean(lib_ms),
            "shape": "R=23 B=1 H=64, D=128 and D=64 (mean of the two layers)",
            "library_shape": "torch.lstm_cell at R=1 B=23",
            "ms_at_library_shape": mean(lib_shape_ms), "training": training}


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
    the ``top`` rows of kernels that ran on the card, then any row of the
    port's kernels below them (None where the profiler saw no device
    activity: not measured). ``host=False`` records the device activity
    alone, which keeps a long run's trace small."""
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
    # the top rows, and every row of the port's kernels below them (a
    # kernel's time per launch adds up all of its symbols)
    ours = [r for r in rows[top:]
            if any(sym in r[1] for syms in KERNEL_SYMBOLS.values()
                   for sym in syms)]
    return {"wall_s": wall,
            "device_busy_s": sum(r[0] for r in rows) * 1e-6 if rows else None,
            "by_kernel": [{"kernel": k[:60], "device_ms": us * 1e-3,
                           "calls": c} for us, k, c in rows[:top] + ours]}


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

    per_launch = device_ms_per_launch(prof)
    return launches, {k: per_launch.get(k) for k in launches}


# ---------------------------------------------------------------------------
# Phase 4: Dom-ST training
# ---------------------------------------------------------------------------
def pixel_orders(cfg, params, batch, ops):
    """The partitioner's pixel permutation of ``batch`` under ``ops``."""
    import torch
    from repro_torch.core.domst import subtree
    from repro_torch.core.partitioner import partition_pixels
    from repro_torch.core.pixcon import pixcon_block
    with torch.no_grad():
        x, w = pixcon_block(subtree(params, "pixcon"), cfg.domst.pixcon,
                            batch["precip"], batch["dist"],
                            batch["target_day"], gate=ops.pixcon_gate)
        return partition_pixels(x, w, cfg.domst.num_heads)[1]


def leaf_rel_err(got: dict, want: dict) -> tuple[float, str]:
    """The largest |got - want| of a leaf over that leaf's largest |want|,
    and the leaf."""
    worst, at = 0.0, ""
    for k, w in want.items():
        scale = float(w.abs().max())
        e = max_err(got[k], w) / scale if scale > 0 else float("inf")
        if e > worst:
            worst, at = e, k
    return worst, at


def train_main_path(dev) -> dict:
    """Dom-ST training at full width: the train CLI's loop through the
    library, counted and timed; a profiled repeat; kernels against plain
    through the gradient; accumulation; the train CLI in both modes; and
    the hand-off of its checkpoint to the serve CLI."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core import domst
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.data.pipeline import (
        InputPipeline, StackedSource, make_domst_windows, stacked_test_batch,
        train_split)
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    from repro_torch.train import Engine, accumulate_grads

    cfg = get_config("domst")
    windows = make_domst_windows(WATERSHEDS, DAYS)
    ip = InputPipeline([train_split(w) for w in windows],
                       batch_size=TRAIN_BATCH, seed=SEED)
    source = StackedSource(ip)
    spe = source.steps_per_epoch
    n_steps = TRAIN_EPOCHS * spe
    # the CLI's TrainConfig at its defaults (lr 1e-3, 100-step horizon)
    tc = TrainConfig(learning_rate=1e-3, total_steps=100, warmup_steps=50,
                     seed=SEED)
    engine = Engine.for_domst(cfg, tc, stacked=True, device=dev)
    state0 = engine.init_state(domst.init(
        cfg, torch.Generator().manual_seed(SEED), WATERSHEDS))
    held = engine.place_batch(stacked_test_batch(windows))
    nse_before = engine.eval_step(state0, held)["nse"].cpu().numpy()
    print(f"  {WATERSHEDS} watersheds x {len(windows[0].discharge)} windows, "
          f"{spe} steps an epoch, {n_steps} steps; held-out NSE before "
          f"training: {np.round(nse_before, 4).tolist()}")

    # the CLI's loop (stacked, prefetch 2), each step synchronised
    loader = ShardedLoader(source, engine, prefetch=2, num_steps=n_steps)
    state, losses, step_s = state0, [], []
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    for batch in loader:
        state, m = engine.step(state, batch)
        losses.append(m["loss"])
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_s.append(now - t)
        t = now
    launches = read_launches()
    want = {name: 0 for name in launches}
    want.update(pixcon=n_steps,
                lstm_cell=n_steps * cfg.domst.lstm_layers * cfg.domst.window_days)
    print(f"  training launches {launches}")
    check(launches == want, f"training launch counts {launches} != {want}")
    check(loader.cursor == int(state.step) == n_steps,
          f"cursor {loader.cursor}, step {int(state.step)}")
    losses = torch.stack(losses)                            # (steps, W)
    check(bool(torch.isfinite(losses).all()), "a non-finite training loss")
    epoch_loss = losses.reshape(TRAIN_EPOCHS, spe, -1).mean(dim=(1, 2)).tolist()
    print(f"  mean loss by epoch {np.round(epoch_loss, 5).tolist()}")
    check(epoch_loss[-1] < epoch_loss[0], f"loss did not fall: {epoch_loss}")
    nse_after = engine.eval_step(state, held)["nse"].cpu().numpy()
    check(bool(np.isfinite(nse_after).all()), f"non-finite NSE {nse_after}")
    print(f"  held-out NSE after training: {np.round(nse_after, 4).tolist()}")
    steps_sorted = sorted(step_s[1:])          # the first step builds plans
    step_p50 = steps_sorted[len(steps_sorted) // 2]
    print(f"  step (synchronised) median {step_p50:.4f} s, "
          f"{WATERSHEDS * TRAIN_BATCH / step_p50:.1f} windows/s")

    # device busy and idle share of a few steps, and device time by kernel
    batches = [engine.place_batch(source.host_batch(i))
               for i in range(PROFILE_STEPS)]

    def steps():
        st = state0
        for b in batches:
            st, _ = engine.step(st, b)
        return st
    steps()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    steps()
    end.record()
    torch.cuda.synchronize()
    span_s = start.elapsed_time(end) * 1e-3
    wall_s = time.perf_counter() - t0
    prof = device_breakdown(steps, top=16)
    busy = prof["device_busy_s"]
    idle = None if busy is None else 1 - busy / span_s
    print(f"  {PROFILE_STEPS} steps: wall {wall_s:.4f} s, device span "
          f"{span_s:.4f} s, profiled device busy {busy} s, idle share {idle}")
    for r in prof["by_kernel"]:
        print(f"    {r['device_ms']:9.3f} ms  {r['calls']:6d}  {r['kernel']}")
    per_launch = device_ms_per_launch(prof)
    device_ms = {k: per_launch.get(k) for k in ("pixcon", "lstm_cell")}

    # kernels against plain through the gradient, then over 5 steps
    plain = Engine.for_domst(cfg, tc, stacked=True, device=dev, ops=domst.PLAIN)
    b0 = batches[0]
    ok = pixel_orders(cfg, state0.params, b0, domst.KERNELS)
    op = pixel_orders(cfg, state0.params, b0, domst.PLAIN)
    flips = (ok != op).any(dim=-1)
    if flips.any():
        print(f"  rank flip in (watershed, example) "
              f"{flips.nonzero().tolist()}")
    check(not flips.any(), f"{int(flips.sum())} rows rank pixels differently")
    gk, lk, _ = accumulate_grads(engine.loss_fn, state0.params, b0, 1)
    gp, lp, _ = accumulate_grads(plain.loss_fn, state0.params, b0, 1)
    check(all(bool(g.abs().max() > 0) for g in gk.values()),
          "a leaf got no gradient through the kernels")
    grad_err, grad_leaf = leaf_rel_err(gk, gp)
    print(f"  gradients, kernels vs plain: worst leaf {grad_leaf} "
          f"{grad_err:.3e} of its largest |grad| ({len(gk)} leaves)")
    check(grad_err <= GRAD_REL, f"gradient of {grad_leaf} differs by "
          f"{grad_err} of its scale > {GRAD_REL}")
    sk, sp, loss_err = state0, state0, 0.0
    for i in range(5):
        b = engine.place_batch(source.host_batch(i))
        sk, mk = engine.step(sk, b)
        sp, mp = plain.step(sp, b)
        loss_err = max(loss_err, float(((mk["loss"] - mp["loss"]).abs()
                                        / mp["loss"].abs()).max()))
    print(f"  5 steps, kernels vs plain: losses within {loss_err:.3e} relative")
    check(loss_err <= LOSS_REL, f"losses differ by {loss_err} > {LOSS_REL}")

    # accumulation: 4 microbatches of 8 give one batch of 32's update. One
    # SGD step with the clip off: its update is -lr x the momentum buffer,
    # which after one step is the averaged gradient itself (Adam's first
    # step, lr x sign(grad), would hide the gradients; a clip would rescale
    # a gradient that is wrong as a whole to the same norm). The buffer is
    # compared, not the new params: an update of ~2e-5 added to a weight of
    # ~0.1 keeps only the bits above the weight's ulp (~1e-8), ~1e-3 of the
    # update. The gradient norms are compared too.
    sgd = dataclasses.replace(tc, optimizer="sgd", grad_clip=0.0)
    upd, gnorm = {}, {}
    for A in (1, 4):
        e = Engine.for_domst(cfg, sgd, stacked=True, accum_steps=A, device=dev)
        st, m = e.step(e.init_state(state0.params), b0)
        upd[A], gnorm[A] = st.opt_state.mu, m["grad_norm"]
    accum_err, accum_leaf = leaf_rel_err(upd[4], upd[1])
    norm_err = float(((gnorm[4] - gnorm[1]).abs() / gnorm[1]).max())
    print(f"  accum_steps=4 vs 1: worst leaf {accum_leaf} {accum_err:.3e} of "
          f"its largest |update|; gradient norms within {norm_err:.3e} "
          f"relative")
    check(accum_err <= ACCUM_REL, f"accumulated update of {accum_leaf} "
          f"differs by {accum_err} > {ACCUM_REL}")
    check(norm_err <= ACCUM_REL, f"accumulated gradient norm differs by "
          f"{norm_err} > {ACCUM_REL}")

    # the train CLI, stacked, with its checkpoint; then the serve CLI on it
    ckpt = ROOT / "build" / "chip_smoke" / "domst_train.npz"
    reset_launches()
    cli = train_main(["--arch", "domst", "--watersheds", str(WATERSHEDS),
                      "--days", str(DAYS), "--epochs", str(TRAIN_EPOCHS),
                      "--batch-size", str(TRAIN_BATCH), "--seed", str(SEED),
                      "--ckpt", str(ckpt)])
    cli_launches = read_launches()
    # its 45 steps, then one held-out evaluation (one forward)
    cli_want = dict(want, pixcon=want["pixcon"] + 1,
                    lstm_cell=want["lstm_cell"] + cfg.domst.lstm_layers
                    * cfg.domst.window_days)
    print(f"  train CLI: launches {cli_launches}, step_p50_s "
          f"{cli['step_p50_s']}, NSE vs the loop's "
          f"{float(np.abs(np.asarray(cli['nse']) - nse_after).max()):.3e}")
    check(cli_launches == cli_want, f"train CLI launches {cli_launches} != "
          f"{cli_want}")
    check(cli["device"] == torch.cuda.get_device_name(dev)
          and np.isfinite(cli["nse"]).all(), f"train CLI: {cli}")
    served = serve_main(["--arch", "domst", "--watersheds", str(WATERSHEDS),
                         "--days", str(DAYS), "--seed", str(SEED),
                         "--ckpt", str(ckpt)])
    handoff_err = float(np.abs(np.asarray(served["nse"])
                               - np.asarray(cli["nse"])).max())
    print(f"  serve CLI from the checkpoint, {served['horizon_days']} days: "
          f"NSE vs eval_step's {handoff_err:.3e}")
    check(served["restored"] and served["horizon_days"] == held["discharge"]
          .shape[1] and handoff_err <= ATOL_NSE,
          f"hand-off NSE differs by {handoff_err} > {ATOL_NSE}")

    # sequential mode: one replica a watershed, each with its evaluation
    reset_launches()
    seq = train_main(["--arch", "domst", "--mode", "sequential",
                      "--watersheds", str(TRAIN_SEQ_WATERSHEDS), "--days",
                      str(DAYS), "--epochs", "1", "--batch-size",
                      str(TRAIN_BATCH), "--seed", str(SEED)])
    seq_launches = read_launches()
    seq_forwards = TRAIN_SEQ_WATERSHEDS * (spe + 1)
    seq_want = dict(want, pixcon=seq_forwards, lstm_cell=seq_forwards
                    * cfg.domst.lstm_layers * cfg.domst.window_days)
    print(f"  sequential CLI: launches {seq_launches}, NSE {seq['nse']}")
    check(seq_launches == seq_want, f"sequential launches {seq_launches} != "
          f"{seq_want}")
    check(len(seq["nse"]) == TRAIN_SEQ_WATERSHEDS
          and np.isfinite(seq["nse"]).all(), f"sequential NSE {seq['nse']}")

    out = {"watersheds": WATERSHEDS, "batch": TRAIN_BATCH, "steps": n_steps,
           "launches": launches, "step_s_median": step_p50,
           "step_s_sorted": steps_sorted,
           "windows_per_s": WATERSHEDS * TRAIN_BATCH / step_p50,
           "cli_step_p50_s": cli["step_p50_s"],
           "cli_step_p99_s": cli["step_p99_s"],
           "cli_loader_wait_s": cli["loader_wait_s"],
           "epoch_mean_loss": epoch_loss,
           "nse_before": nse_before.tolist(), "nse_after": nse_after.tolist(),
           "profiled_steps": PROFILE_STEPS, "profiled_wall_s": wall_s,
           "device_span_s": span_s, "device_busy_s": busy,
           "device_idle_share": idle,
           "device_time_by_kernel": prof["by_kernel"],
           "grad_rel_err": grad_err, "loss_rel_err": loss_err,
           "accum_rel_err": accum_err, "handoff_nse_err": handoff_err,
           "cli_launches": cli_launches, "sequential_launches": seq_launches}
    print("  " + json.dumps(out))
    return {"launches": launches, "device_ms": device_ms}


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


def paged_work(a, window=0) -> tuple[float, float]:
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
    _, _, mask = gathered_mask(a, window)
    keys = int(mask.sum()) * Hq            # attendable (row, key) pairs
    return nbytes, 4.0 * keys * D


def check_paged_attn(g, dev) -> dict:
    """The paged-attention kernel against its plain version at the LM main
    paths' shapes in bf16 and fp32: decode T=1 and verify T=4 over 4
    slots, a 128-token prefill chunk of one slot, for qwen2-1.5b (12 query
    heads on 2 KV heads, D=128, no window, 36 pages a slot) and for
    recurrentgemma-2b's local layers (10 on 1, D=256, window 2,048, 162
    pages a slot), all with 16-token pages; and at small shapes with a
    window, a softcap, unassigned pages and an empty row. Then times at
    the main shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attn.ops import (
        grid_of, paged_attention_fused, sm_count)
    from repro_torch.kernels.paged_attn.ref import paged_attention_ref
    Hq, Hkv, D, PS, N = 12, 2, 128, 16, LM_MAX_LEN // 16
    mid = [LM_PROMPT + LM_GEN // 2 - 2 * i for i in range(4)]   # mid-decode
    qwen = dict(Hq=Hq, Hkv=Hkv, D=D, ps=PS, n=N, window=0, softcap=0.0)
    main = {"decode": dict(B=4, T=1, lens=mid, **qwen),
            "verify": dict(B=4, T=LM_SPEC_K + 1, lens=mid, **qwen),
            "chunk": dict(B=1, T=LM_CHUNK, lens=[3 * LM_CHUNK],
                          qpos_end=[3 * LM_CHUNK], **qwen)}
    # recurrentgemma-2b's local layers: 10 query heads on 1 KV head, D=256,
    # a 2,048-token window, page rows as long as its whole-prefill queue's
    # (2,560 + 32 tokens); mid-decode past the window, and a 128-token
    # chunk ending at 2,560, where the window masks the first 512 keys
    rg_whole = RECURRENT_RUNS["recurrentgemma-2b"]["lens"]["whole"]
    rg_gen = RECURRENT_RUNS["recurrentgemma-2b"]["gen"]
    rg = dict(Hq=10, Hkv=1, D=256, ps=16, window=2048, softcap=0.0,
              n=-(-(max(rg_whole) + rg_gen) // 16))
    rg_mid = [n + rg_gen // 2 for n in rg_whole]
    main.update({
        "rg_decode": dict(B=4, T=1, lens=rg_mid, **rg),
        "rg_verify": dict(B=4, T=LM_SPEC_K + 1, lens=rg_mid, **rg),
        "rg_chunk": dict(B=1, T=LM_CHUNK, lens=[max(rg_whole)],
                         qpos_end=[max(rg_whole)], **rg)})
    small = [dict(B=3, T=7, Hq=4, Hkv=1, D=64, ps=4, n=6, lens=[13, 0, 9],
                  window=5, softcap=50.0),
             dict(B=2, T=3, Hq=8, Hkv=2, D=128, ps=16, n=3, lens=[20, 33],
                  window=0, softcap=30.0)]
    err = {"float32": 0.0, "bfloat16": 0.0}
    for dtype, atol in ((torch.float32, ATOL_KERNEL),
                        (torch.bfloat16, ATOL_BF16)):
        # the main shapes, and the chunk's T over 4 slots as well
        wide = dict(B=4, T=LM_CHUNK, lens=mid, **qwen)
        cases = [*main.items(), ("chunk_4slots", wide)]
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
            kw = dict(window=c["window"])
            a = paged_inputs(g, dev, dtype, c["B"], c["T"], c["Hq"], c["Hkv"],
                             c["D"], c["ps"], c["n"], c["lens"],
                             c.get("qpos_end"))
            ms = time_ms(lambda: paged_attention_fused(**a, **kw))
            plain_ms = time_ms(lambda: paged_attention_ref(**a, **kw),
                               iters=50)
            gather_ms = time_ms(lambda: gathered_mask(a, **kw), iters=50)
            k, v, mask = gathered_mask(a, **kw)
            q = a["q"].transpose(1, 2)

            def lib():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                      enable_gqa=True)
            lib_err = max_err(lib().transpose(1, 2).float(),
                              paged_attention_fused(**a, **kw).float())
            lib_ms = time_ms(lib)
            # bf16 inputs: the tensor cores' bf16 rate; fp32: the CUDA cores'
            b_ms, b_by = bound_ms(*paged_work(a, **kw), BF16_OPS_PER_S
                                  if dtype == torch.bfloat16 else FP32_OPS_PER_S)
            tag = str(dtype).split(".")[-1]
            pps, splits, blocks = grid_of(c["B"], c["T"], c["Hq"], c["Hkv"],
                                          c["n"], sm_count(dev.index))
            row = {"shape": name, "dtype": tag, "B": c["B"], "T": c["T"],
                   "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "gather_ms": gather_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library_vs_kernel_err": lib_err,
                   "pages_per_split": pps, "splits": splits, "blocks": blocks}
            shapes.append(row)
            print(f"  paged_attn {name} {tag}: kernel {ms * 1e3:.2f} us, plain "
                  f"{plain_ms * 1e3:.2f} us, sdpa {lib_ms * 1e3:.2f} us "
                  f"(+ gather {gather_ms * 1e3:.2f} us; agrees to "
                  f"{lib_err:.1e}), bound {b_ms * 1e3:.3f} us ({b_by}); "
                  f"{splits} split(s) of {pps} of {c['n']} pages, {blocks} "
                  f"blocks{' + merge' if splits > 1 else ''}")
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


# ---------------------------------------------------------------------------
# Phase 2: conv1d, ssd_chunk and local attention
# ---------------------------------------------------------------------------
def rn(g, dev, *shape, s=1.0):
    import torch
    return (torch.randn(shape, generator=g) * s).to(dev)


def check_kernel_case(name, tag, out, ref, atol) -> float:
    """Largest abs difference over the output(s), printed and checked."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    e = max(max_err(o.float(), r.float()) for o, r in zip(outs, refs))
    print(f"  {name} {tag}: max_abs_err={e:.3e}")
    check(e <= atol, f"{name} {tag}: error {e} > {atol}")
    return e


def conv1d_work(B, S, C, K, esize, silu) -> tuple[float, float]:
    """Bytes (x, w, b read once, y written once) and fp32 operations (K
    multiplies and adds, the bias, and SiLU's exp, add, divide, multiply)
    of one causal conv."""
    nbytes = esize * (2 * B * S * C + K * C + C)
    return nbytes, B * S * C * (2 * K + 1 + (4 if silu else 0))


def check_conv1d(g, dev) -> dict:
    """The conv1d kernel against its plain version at the main path's
    shapes (mamba2-130m's 512-token prefill layer with SiLU, C=1,792;
    recurrentgemma-2b's 2,560-token prefill layer without, C=2,560; a
    4-slot decode step with a tail) and ragged ones (C not a multiple of
    128 or of the 8-channel vector, S=1 and S=2 with a tail, S > 2,048,
    S < K-1, an input that is a view at an odd storage offset, at a decode
    size and at one the 16-byte path would take, K=5 read without the
    register window), fp32 and bf16, the new tail to the bit; an input off
    16-byte alignment must take the scalar path (``plan_conv``); then
    times, beside ``F.conv1d(groups=C)`` on the left-padded input."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.conv1d import ops as conv_ops
    from repro_torch.kernels.conv1d.ops import causal_conv1d
    from repro_torch.kernels.conv1d.ref import causal_conv1d_ref
    # name, B, S, C, K, activation, tail, storage offset of x
    cases = [("mamba2_prefill", 1, 512, 1792, 4, "silu", False, 0),
             ("rg_prefill", 1, 2560, 2560, 4, "none", False, 0),
             ("mamba2_decode", 4, 1, 1792, 4, "silu", True, 0),
             ("rg_verify", 4, 4, 2560, 4, "none", True, 0),
             ("ragged_c", 2, 37, 130, 4, "silu", True, 0),
             ("c_1794", 1, 64, 1794, 4, "silu", True, 0),
             ("long_s", 1, 3000, 200, 4, "none", False, 0),
             ("s_3000", 1, 3000, 1792, 4, "silu", False, 0),
             ("s_below_k", 3, 2, 96, 4, "silu", True, 0),
             ("odd_offset", 2, 1, 1792, 4, "silu", True, 1),
             ("odd_offset_wide", 1, 128, 1792, 4, "silu", True, 1),
             ("k5", 2, 19, 512, 5, "silu", True, 0)]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err = {"float32": 0.0, "bfloat16": 0.0}
    for dtype, atol in ((torch.float32, ATOL_KERNEL),
                        (torch.bfloat16, ATOL_BF16)):
        tag = str(dtype).split(".")[-1]
        for name, B, S, C, K, act, tail, off in cases:
            a = conv_args(g, dev, dtype, B, S, C, K, tail)
            a["x"] = torch.cat([a["x"].flatten()[:off],
                                a["x"].flatten()])[off:].view(B, S, C)
            y, new_tail = causal_conv1d(**a, activation=act)
            torch.cuda.synchronize()
            ref_y, ref_tail = causal_conv1d_ref(**a, activation=act)
            what = f"{name} {tag} B={B} S={S} C={C} K={K} {act}"
            err[tag] = max(err[tag], check_kernel_case("conv1d", what, y,
                                                       ref_y, atol))
            check_kernel_case("conv1d", what + " new tail", new_tail,
                              ref_tail, 0.0)
            ptrs = [a["x"].data_ptr(), 0 if a["tail"] is None
                    else a["tail"].data_ptr(), a["w"].data_ptr(),
                    a["b"].data_ptr(), y.data_ptr(), new_tail.data_ptr()]
            p = conv_ops.plan_conv(B, S, C, a["x"].element_size(),
                                   all(q % 16 == 0 for q in ptrs), sms)
            print(f"    {'vector' if p.vector else 'scalar'} path, runs of "
                  f"{p.run}, {p.blocks} blocks")
            if off * a["x"].element_size() % 16:
                check(not p.vector, f"conv1d {what}: an input off 16-byte "
                      "alignment was planned on the vector path")
    shapes = []
    for name, B, S, C, K, act, tail, _ in cases[:4]:
        for dtype in (torch.bfloat16, torch.float32):
            a = conv_args(g, dev, dtype, B, S, C, K, tail)
            call = lambda: causal_conv1d(**a, activation=act)  # noqa: E731
            plain_ms = time_ms(lambda: causal_conv1d_ref(**a, activation=act),
                               iters=50)
            # the library's depthwise conv over the left-padded (B, C, S+K-1)
            # input; SiLU timed apart; kernel and library timed in turns
            pad = a["tail"] if tail else torch.zeros_like(a["x"][:, :K - 1])
            xp = torch.cat([pad, a["x"]], 1).transpose(1, 2).contiguous()
            wl = a["w"].t().contiguous()[:, None, :]
            lib = lambda: F.conv1d(xp, wl, a["b"], groups=C)  # noqa: E731
            ms, lib_ms, lib_silu_ms = time_in_turns(
                [call, lib, lambda: F.silu(lib())])
            silu_ms = lib_silu_ms - lib_ms if act == "silu" else 0.0
            call_host_us = host_us(call)
            device_us = launch_device_us(call, "conv1d_kernel")
            ref_y = causal_conv1d(**a, activation="none")[0].float()
            lib_err = max_err(lib().transpose(1, 2).float(), ref_y)
            esize = a["x"].element_size()
            b_ms, b_by = bound_ms(*conv1d_work(B, S, C, K, esize,
                                               act == "silu"))
            tag = str(dtype).split(".")[-1]
            shapes.append({"shape": name, "dtype": tag, "B": B, "S": S,
                           "C": C, "ms": ms, "host_us": call_host_us,
                           "device_us": device_us,
                           "plain_ms": plain_ms,
                           "library_ms": lib_ms, "library_silu_ms": silu_ms,
                           "bound_ms": b_ms, "bound_by": b_by,
                           "library_vs_kernel_err": lib_err})
            print(f"  conv1d {name} {tag}: kernel {ms * 1e3:.2f} us (host "
                  f"{call_host_us:.2f} us a call, device {device_us} us a "
                  "launch), plain "
                  f"{plain_ms * 1e3:.2f} us, F.conv1d {lib_ms * 1e3:.2f} us "
                  f"(+ SiLU {silu_ms * 1e3:.2f} us; agrees to {lib_err:.1e}),"
                  f" bound {b_ms * 1e3:.3f} us ({b_by})")
    head = shapes[0]                       # bf16 mamba2-130m prefill layer
    return {"name": "conv1d", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/conv1d.cu",
            "replaces": "src/repro/kernels/conv1d/kernel.py:25",
            "max_abs_err": max(err.values()), "max_abs_err_by_dtype": err,
            "ms": head["ms"], "host_us": head["host_us"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": "bf16 mamba2-130m prefill layer: B=1 S=512 C=1792 K=4 "
                     "SiLU",
            "library": "torch.nn.functional.conv1d(groups=C) on the "
                       "left-padded (B,C,S+K-1) input, SiLU timed apart",
            "by_shape": shapes}


def ssd_inputs(g, dev, dtype, B, nc, Q, H, N, P) -> dict:
    """Model-like SSD inputs: C and B after the conv's SiLU, xdt = x * dt
    with dt = softplus(.), and the within-chunk cumsum of dt * A with
    A = -exp(U(-1, 1))."""
    import torch
    import torch.nn.functional as F
    dt = F.softplus(rn(g, dev, B, nc, Q, H))
    A = -torch.exp(torch.rand(H, generator=g) * 2 - 1).to(dev)
    dA = (dt * A).permute(0, 1, 3, 2)
    return dict(Cc=F.silu(rn(g, dev, B, nc, Q, H, N)).to(dtype),
                Bc=F.silu(rn(g, dev, B, nc, Q, H, N)).to(dtype),
                xdt=(rn(g, dev, B, nc, Q, H, P) * dt[..., None]).to(dtype),
                dA_cs=torch.cumsum(dA, dim=-1).contiguous())


def ssd_work(B, nc, Q, H, N, P, esize) -> tuple[float, float]:
    """Bytes (C, B, xdt, dA read once, y and the float32 state written
    once) and operations: per (chunk, head), C.B (2N), the decay (3) and
    the P.xdt product (2P) over the Q(Q+1)/2 causal pairs, and the state's
    2PN per row plus its decay (N + 2)."""
    nbytes = (esize * B * nc * Q * H * (2 * N + 2 * P) + 4 * B * nc * H * Q
              + 4 * B * nc * H * P * N)
    pairs = Q * (Q + 1) / 2
    ops = B * nc * H * (pairs * (2 * N + 3 + 2 * P) + Q * (2 * P * N + N + 2))
    return nbytes, ops


def check_bf16_ulp(what, out, ref) -> dict:
    """The SSD chunk's bf16 y held to one bf16 ulp at every magnitude
    (``RTOL_BF16_ULP``): the largest difference, the share of elements that
    differ from the plain bf16 output at all, and how many differ by more
    than 2^-8 of |y| (half an ulp at the bottom of a binade) for the
    record."""
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    bad = int((d > ATOL_BF16 + RTOL_BF16_ULP * r).sum())
    out_ = {"max_abs_err": float(d.max()) if d.numel() else 0.0,
            "differing_share": float((out != ref).float().mean())
            if d.numel() else 0.0,
            "over_2^-8": int((d > ATOL_BF16 + 2 ** -8 * r).sum())}
    check(bad == 0, f"{what}: {bad} elements beyond one bf16 ulp")
    return out_


def check_ssd_chunk(g, dev) -> dict:
    """The SSD-chunk kernel against its plain version at mamba2-130m's
    whole-prompt prefill shape (2 chunks of Q=256, H=24, N=128, P=64), at
    ragged chunk lengths (a short prompt makes Q = S), and at the bf16
    kernel's tile edges: Q in {1, 15, 16, 17, 63, 64, 65, 129, 200, 256}
    (16-row warp tiles, 64-row query and key tiles), N in {16, 20, 128} (20
    takes element loads), P in {24, 64}, 2 batch rows of 2 chunks; fp32
    and bf16. y within 1e-5 in fp32 and one bf16 ulp in bf16, the float32
    state within 1e-5 in both. Then times. No one PyTorch call computes the
    function."""
    import torch
    from repro_torch.kernels.ssd_chunk.ops import ssd_chunk_fused
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref
    cases = [("mamba2_prefill", 1, 2, 256, 24, 128, 64),
             ("q5", 1, 1, 5, 24, 128, 64),
             ("q200", 2, 1, 200, 24, 128, 64),
             ("q256_batch2", 2, 3, 256, 4, 128, 64),
             ("smoke", 1, 3, 8, 4, 16, 32)]
    edges = [(f"edge_q{Q}_n{N}_p{P}", 2, 2, Q, 3, N, P)
             for N in (16, 20, 128) for P in (24, 64)
             for Q in (1, 15, 16, 17, 63, 64, 65, 129, 200, 256)]
    err = {"float32": 0.0, "bfloat16": 0.0}
    bf16_y = {"max_abs_err": 0.0, "differing_share_max": 0.0,
              "differing_share_main": None, "over_2^-8": 0}
    # fp32 tile edges: the largest of each case's largest |dy| over eps |y|
    # at that element, with |dy|, |y| and the case
    f32_ulps = (0.0, 0.0, 0.0, "")
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        for name, B, nc, Q, H, N, P in cases + edges:
            a = ssd_inputs(g, dev, dtype, B, nc, Q, H, N, P)
            y, st = ssd_chunk_fused(**a)
            torch.cuda.synchronize()
            ry, rst = ssd_chunk_ref(**a)
            quiet = name.startswith("edge")
            e_st = max_err(st, rst)
            check(e_st <= ATOL_KERNEL, f"ssd_chunk {name} {tag} state: error "
                  f"{e_st} > {ATOL_KERNEL}")
            if dtype == torch.float32:
                e = max_err(y, ry)
                rtol = RTOL_F32_EDGE if quiet else 0.0
                ok = bool(((y - ry).abs() <= ATOL_KERNEL + rtol * ry.abs()).all())
                check(ok, f"ssd_chunk {name} {tag} y: error {e} beyond "
                      f"{ATOL_KERNEL} + {rtol} |y|")
                d = (y - ry).abs().flatten()
                k = int(d.argmax())
                at = float(ry.abs().flatten()[k])   # |y| where it differs most
                ulps = float(d[k]) / (torch.finfo(torch.float32).eps
                                      * max(at, 1e-30))
                if quiet and ulps > f32_ulps[0]:
                    f32_ulps = (ulps, float(d[k]), at, name)
                line = f"y max_abs_err={e:.3e}"
            else:
                u = check_bf16_ulp(f"ssd_chunk {name} {tag} y", y, ry)
                e = u["max_abs_err"]
                bf16_y["max_abs_err"] = max(bf16_y["max_abs_err"], e)
                bf16_y["differing_share_max"] = max(
                    bf16_y["differing_share_max"], u["differing_share"])
                bf16_y["over_2^-8"] += u["over_2^-8"]
                if name == "mamba2_prefill":
                    bf16_y["differing_share_main"] = u["differing_share"]
                line = (f"y max_abs_err={e:.3e}, {u['differing_share']:.3%} "
                        f"of y differ, {u['over_2^-8']} by more than 2^-8")
            if not quiet:
                print(f"  ssd_chunk {name} {tag}: {line}, state "
                      f"max_abs_err={e_st:.3e}")
            check(bool(torch.isfinite(y.float()).all() and
                       torch.isfinite(st).all()), f"ssd_chunk {name}: not finite")
            err[tag] = max(err[tag], e, e_st)
        print(f"  ssd_chunk {len(edges)} tile-edge cases {tag}: max error "
              f"{err[tag]:.3e} (y and state)" + (
                  f"; fp32 y: at most {f32_ulps[0]:.2f} eps of |y| "
                  f"({f32_ulps[1]:.3e} at |y| = {f32_ulps[2]:.3f}, "
                  f"{f32_ulps[3]})"
                  if dtype == torch.float32 else ""))
    print(f"  ssd_chunk bf16 y over every case: {bf16_y}")
    shapes = []
    for dtype in (torch.bfloat16, torch.float32):
        name, B, nc, Q, H, N, P = cases[0]
        a = ssd_inputs(g, dev, dtype, B, nc, Q, H, N, P)
        call = lambda: ssd_chunk_fused(**a)  # noqa: E731
        ms = time_ms(call)
        call_host_us = host_us(call)
        device_us = launch_device_us(call, "ssd_chunk_mma_kernel"
                                     if dtype == torch.bfloat16
                                     else "ssd_chunk_kernel")
        plain_ms = time_ms(lambda: ssd_chunk_ref(**a), iters=50)
        b_ms, b_by = bound_ms(*ssd_work(B, nc, Q, H, N, P,
                                        a["xdt"].element_size()),
                              BF16_OPS_PER_S if dtype == torch.bfloat16
                              else FP32_OPS_PER_S)
        tag = str(dtype).split(".")[-1]
        shapes.append({"shape": name, "dtype": tag, "ms": ms,
                       "host_us": call_host_us, "device_us": device_us,
                       "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": b_by})
        print(f"  ssd_chunk {name} {tag}: kernel {ms * 1e3:.2f} us (host "
              f"{call_host_us:.2f} us a call, device {device_us} us a "
              f"launch), plain {plain_ms * 1e3:.2f} us, bound "
              f"{b_ms * 1e3:.3f} us ({b_by})")
    head = shapes[0]
    return {"name": "ssd_chunk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
            "replaces": "src/repro/kernels/ssd_chunk/kernel.py:22",
            "max_abs_err": max(err.values()), "max_abs_err_by_dtype": err,
            "bf16_y": bf16_y, "f32_edge_y_eps": f32_ulps[0],
            "ms": head["ms"], "host_us": head["host_us"],
            "device_us": head["device_us"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None,
            "shape": "bf16 mamba2-130m 512-token prefill layer: B=1 nc=2 "
                     "Q=256 H=24 N=128 P=64",
            "library": "none: no one PyTorch call computes it",
            "by_shape": shapes}


def band_mask(S, window, causal, dev):
    """(S, S) bool: key j attendable from query i."""
    import torch
    i = torch.arange(S, device=dev)[:, None]
    j = torch.arange(S, device=dev)[None, :]
    delta = i - j
    mask = delta < window
    return mask & (delta >= 0) if causal else mask & (-delta < window)


def local_work(B, S, Hq, Hkv, D, window, causal, esize) -> tuple[float, float]:
    """Bytes (q, k, v read once, out written once) and operations: q.k and
    p.v over the attendable (query, key) pairs, 4 a pair and dim."""
    pairs = int(band_mask(S, window, causal, "cpu").sum())
    nbytes = esize * B * S * D * (2 * Hq + 2 * Hkv)
    return nbytes, 4.0 * B * Hq * pairs * D


def check_local_attn(g, dev) -> dict:
    """The local-attention kernel against its plain version at
    recurrentgemma-2b's prefill shapes (10 query heads on 1 KV head,
    D=256, window 2,048; S=2,560 and S=600 < window) and ragged ones (S not
    a tile multiple, non-causal, Hkv = Hq, MQA, D=64 and 128), fp32 and
    bf16; then times beside ``scaled_dot_product_attention`` with a boolean
    band mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.local_attn.ops import local_attention_fused
    from repro_torch.kernels.local_attn.ref import local_attention_ref
    cases = [("rg_prefill_2560", 1, 2560, 10, 1, 256, 2048, True),
             ("rg_prefill_600", 1, 600, 10, 1, 256, 2048, True),
             ("ragged_gqa", 1, 77, 8, 2, 128, 33, True),
             ("noncausal_mqa", 2, 77, 8, 1, 128, 33, False),
             ("noncausal_nogroup", 2, 100, 4, 4, 64, 16, False),
             ("window_ge_s", 1, 50, 4, 1, 64, 64, False)]
    err = {"float32": 0.0, "bfloat16": 0.0}
    for dtype, atol in ((torch.float32, ATOL_KERNEL),
                        (torch.bfloat16, ATOL_BF16)):
        tag = str(dtype).split(".")[-1]
        for name, B, S, Hq, Hkv, D, window, causal in cases:
            a = dict(q=rn(g, dev, B, S, Hq, D).to(dtype),
                     k=rn(g, dev, B, S, Hkv, D).to(dtype),
                     v=rn(g, dev, B, S, Hkv, D).to(dtype))
            out = local_attention_fused(**a, window=window, causal=causal)
            torch.cuda.synchronize()
            ref = local_attention_ref(**a, window=window, causal=causal)
            err[tag] = max(err[tag], check_kernel_case(
                "local_attn", f"{name} {tag} S={S} Hq={Hq} Hkv={Hkv} D={D} "
                f"window={window} causal={causal}", out, ref, atol))
    shapes = []
    for name, B, S, Hq, Hkv, D, window, causal in cases[:2]:
        for dtype in (torch.bfloat16, torch.float32):
            a = dict(q=rn(g, dev, B, S, Hq, D).to(dtype),
                     k=rn(g, dev, B, S, Hkv, D).to(dtype),
                     v=rn(g, dev, B, S, Hkv, D).to(dtype))
            kw = dict(window=window, causal=causal)
            ms = time_ms(lambda: local_attention_fused(**a, **kw), iters=20,
                         warmup=3)
            plain_ms = time_ms(lambda: local_attention_ref(**a, **kw),
                               iters=5, warmup=1)
            q, k, v = (t.transpose(1, 2) for t in (a["q"], a["k"], a["v"]))
            mask = band_mask(S, window, causal, dev)
            lib = lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)
            lib_ms = time_ms(lib, iters=20, warmup=3)
            lib_err = max_err(lib().transpose(1, 2).float(),
                              local_attention_fused(**a, **kw).float())
            b_ms, b_by = bound_ms(*local_work(B, S, Hq, Hkv, D, window,
                                              causal, a["q"].element_size()),
                                  BF16_OPS_PER_S if dtype == torch.bfloat16
                                  else FP32_OPS_PER_S)
            tag = str(dtype).split(".")[-1]
            shapes.append({"shape": name, "dtype": tag, "S": S, "ms": ms,
                           "plain_ms": plain_ms, "library_ms": lib_ms,
                           "bound_ms": b_ms, "bound_by": b_by,
                           "library_vs_kernel_err": lib_err})
            print(f"  local_attn {name} {tag}: kernel {ms * 1e3:.2f} us, plain "
                  f"{plain_ms * 1e3:.2f} us, sdpa {lib_ms * 1e3:.2f} us "
                  f"(agrees to {lib_err:.1e}), bound {b_ms * 1e3:.3f} us "
                  f"({b_by})")
    head = shapes[0]                       # bf16, the longest prompt
    return {"name": "local_attn", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/local_attn.cu",
            "replaces": "src/repro/kernels/local_attn/kernel.py:26",
            "max_abs_err": max(err.values()), "max_abs_err_by_dtype": err,
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": "bf16 recurrentgemma-2b prefill layer: B=1 S=2560 "
                     "Hq=10 Hkv=1 D=256 window=2048 causal",
            "library": "torch.nn.functional.scaled_dot_product_attention "
                       "(enable_gqa) with a boolean band mask",
            "by_shape": shapes}


def requests_of(vocab: int, lens, gen: int) -> list:
    """A synthetic queue drawn as the launcher's ``make_requests`` draws
    it (one seeded generator, prompts in order): prompts of ``lens``
    tokens, ``gen`` new tokens each."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(LM_SEED)
    return [Request(rid=i, max_new=gen,
                    prompt=rng.integers(0, vocab, n).astype(np.int32))
            for i, n in enumerate(lens)]


def kernel_wrappers() -> dict:
    """Every ported kernel's wrapper, by name: each counts its launches."""
    from repro_torch.kernels.conv1d.ops import causal_conv1d
    from repro_torch.kernels.local_attn.ops import local_attention_fused
    from repro_torch.kernels.lstm_cell.ops import lstm_cell_fused
    from repro_torch.kernels.paged_attn.ops import paged_attention_fused
    from repro_torch.kernels.pixcon.ops import pixcon_gate
    from repro_torch.kernels.ssd_chunk.ops import ssd_chunk_fused
    return {"pixcon": pixcon_gate, "lstm_cell": lstm_cell_fused,
            "paged_attn": paged_attention_fused, "conv1d": causal_conv1d,
            "ssd_chunk": ssd_chunk_fused, "local_attn": local_attention_fused}


def reset_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def serve_once(cfg, dev, params, dtype, mode: dict, reqs: list, ops=None,
               profile_reqs: list | None = None) -> dict:
    """One served run of ``reqs`` through the port's Scheduler on 4 slots
    with the launch counts set to 0 just before and read just after.
    Returns the streams, the stats, tok/s, decode tok/s, TTFT p50/p99 and
    the launches; with ``profile_reqs``, also the device time by kernel
    of a profiled run of that queue on the same engine."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.obs import Tracer, derive_request_metrics, percentiles
    from repro_torch.serve import InferenceEngine, NgramDrafter, Scheduler
    max_len = max(len(r.prompt) + r.max_new for r in reqs)
    eng = InferenceEngine(cfg, slots=LM_SLOTS, max_len=max_len,
                          page_size=16, dtype=dtype, device=dev,
                          prefill_chunk=mode.get("prefill_chunk", 0),
                          ops=ops or tfm.KERNELS)

    def sched_of(tracer=None):
        return Scheduler(eng, eng.init_state(params), tracer=tracer,
                         spec_k=mode.get("spec_k", 0),
                         drafter=NgramDrafter() if mode.get("spec_k") else None)
    tracer = Tracer()
    sched = sched_of(tracer)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    gen = sched.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
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
    if profile_reqs is not None:
        sched2 = sched_of()
        out["profile"] = device_breakdown(lambda: sched2.run(profile_reqs),
                                          top=25, host=False)
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


def decode_logits_check(cfg, dev, params, dtype, reqs, cpu_control=False) -> dict:
    """Admit the first LM_SLOTS requests of ``reqs`` by whole-prompt
    prefill, then run one decode_step_paged through the kernels and one
    through the plain versions on copies of the same state. Returns the
    logits' largest difference over their largest magnitude, whether each
    slot's argmax agrees, and each slot's gap between its two largest
    logits, over the real vocab (the padded columns read -1e30). With
    ``cpu_control``, the plain versions also run on the CPU
    from the same state: the difference two correct float32 runs show at
    this width."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import InferenceEngine
    reqs = reqs[:LM_SLOTS]
    eng = InferenceEngine(cfg, slots=LM_SLOTS,
                          max_len=max(len(r.prompt) + r.max_new for r in reqs),
                          page_size=16, dtype=dtype, device=dev)
    state = eng.init_state(params)
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
        return lg[:, :cfg.vocab_size].float().cpu()   # not the -1e30 padding
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


class Checked:
    """A kernel's wrapper that runs the kernel and its plain version on the
    same inputs, keeps the largest difference over the output's largest
    magnitude (each output of a tuple apart), and returns the plain
    result. Its launches serve only the comparison; the main path's counts
    come from the served runs."""

    def __init__(self, kernel, plain):
        self.kernel, self.plain = kernel, plain
        self.calls, self.max_rel = 0, 0.0

    def __call__(self, *args, **kw):
        ker = self.kernel(*args, **kw)
        out = self.plain(*args, **kw)
        pairs = zip(ker, out) if isinstance(out, tuple) else [(ker, out)]
        for k, o in pairs:
            scale = max(float(o.abs().max()), 1e-30) if o.numel() else 1.0
            self.max_rel = max(self.max_rel, max_err(k.float(), o.float())
                               / scale if o.numel() else 0.0)
        self.calls += 1
        return out


def checked_ops():
    """KernelOps whose every kernel is held against its plain version."""
    from repro_torch.models import transformer as tfm
    return tfm.KernelOps(*(Checked(k, p) for k, p in zip(tfm.KERNELS,
                                                        tfm.PLAIN)))


def well_conditioned(cfg, params):
    """The params with wq, wk, wv scaled to std 1/sqrt(d_model) and wo to
    1/sqrt(Hq*D) in every attention layer: unit-variance projections. The
    reference's law (std 1/sqrt(shape[-2])) gives wq std 1/sqrt(Hq) and
    attention scores with a spread in the hundreds. Layers without
    attention are left as they are."""
    d, hq, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    out = dict(params, layers=[])
    for lp in params["layers"]:
        if "attn" in lp:
            a = dict(lp["attn"], wq=lp["attn"]["wq"] * (hq / d) ** 0.5,
                     wk=lp["attn"]["wk"] * (hkv / d) ** 0.5,
                     wv=lp["attn"]["wv"] * (hkv / d) ** 0.5,
                     wo=lp["attn"]["wo"] / hq ** 0.5)
            lp = dict(lp, attn=a)
        out["layers"].append(lp)
    return out


def damped(cfg, params):
    """The params rescaled as ``well_conditioned`` does, then with every
    layer's output projection (``wo``, ``w_down``, ``w_out``) scaled by
    DAMP: the residual stream then carries the token's embedding almost
    alone, and with tied embeddings the greedy model repeats its last
    token. The n-gram drafter's drafts are then accepted, so a verify step
    keeps some and rolls the rest back. The speculative mode runs on
    these."""
    def walk(t):
        return {k: v * DAMP if k in DAMPED else
                walk(v) if isinstance(v, dict) else v for k, v in t.items()}
    well = well_conditioned(cfg, params)
    return dict(well, layers=[walk(lp) for lp in well["layers"]])


def check_spec(arch, name, r) -> None:
    """A speculative run verified drafts and accepted some of them."""
    if name != "spec":
        return
    st = r["stats"]
    check(st["spec_steps"] > 0 and st["spec_accepted"] > 0,
          f"{arch} {name}: {st['spec_steps']} verify steps, "
          f"{st['spec_accepted']} of {st['spec_proposed']} drafts accepted")


def print_run(arch, name, r) -> None:
    print(f"  {arch} {name} bf16: {r['tok_per_s']:.1f} tok/s, decode "
          f"{r['decode_tok_per_s']:.1f} tok/s, prefill "
          f"{r['prefill_tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{r['ttft_p50_s']:.4f} s p99 {r['ttft_p99_s']:.4f} s, wall "
          f"{r['wall_s']:.3f} s, launches "
          f"{ {k: v for k, v in r['launches'].items() if v} }, accepted/step "
          f"{r['accepted_tok_per_step']:.3f}, stats "
          f"{ {k: r['stats'][k] for k in ('prefill_chunks', 'decode_steps', 'spec_steps', 'spec_proposed', 'spec_accepted')} }")
    prof = r.get("profile")
    if prof:
        busy = prof["device_busy_s"]
        print(f"    profiled repeat: wall {prof['wall_s']:.3f} s, device busy "
              f"{'not measured' if busy is None else f'{busy:.3f} s'}; "
              "top kernels, then the port's kernels below them:")
        ours = lambda k: any(s in k for syms in KERNEL_SYMBOLS.values()
                             for s in syms)
        for i, row in enumerate(prof["by_kernel"]):
            if i < 12 or ours(row["kernel"]):
                print(f"      {row['device_ms']:9.2f} ms {row['calls']:7d}x "
                      f"{row['kernel']}")


# the device-side names of each kernel's launch: paged_attn launches its
# merge as well where a call splits the page rows, and the bf16 kernels of
# ssd_chunk and local_attn (tensor cores) are others than their fp32 ones
KERNEL_SYMBOLS = {"pixcon": ("pixcon_gate_kernel",),
                  "lstm_cell": ("lstm_cell_kernel",),
                  "paged_attn": ("paged_attn_kernel", "paged_attn_merge_kernel"),
                  "conv1d": ("conv1d_kernel",),
                  "ssd_chunk": ("ssd_chunk_kernel", "ssd_chunk_mma_kernel"),
                  "local_attn": ("local_attn_kernel", "local_attn_mma_kernel")}


def device_ms_per_launch(prof: dict) -> dict:
    """Device time of one launch of each port kernel in a profiled run: its
    kernels' device time over their launches (None: not in the profile's
    top rows). A launch runs each symbol once (ssd_chunk's two kernels) or
    not at all (paged_attn's merge), and a symbol's instantiations are
    alternatives (conv1d's vector and scalar paths): the launches are the
    most calls any one symbol has over all its instantiations."""
    out = {}
    for name, syms in KERNEL_SYMBOLS.items():
        calls = [sum(r["calls"] for r in prof["by_kernel"] if sym in r["kernel"])
                 for sym in syms]
        rows = [r for r in prof["by_kernel"]
                if any(sym in r["kernel"] for sym in syms)]
        if rows:
            out[name] = sum(r["device_ms"] for r in rows) / max(calls)
    return out


def run_summary(runs: dict) -> dict:
    keep = ("prefill_chunks", "decode_steps", "decode_tokens",
            "prefill_tokens", "spec_steps", "spec_proposed", "spec_accepted")
    out = {}
    for name, r in runs.items():
        row = {k: v for k, v in r.items() if k not in ("gen", "stats", "profile")}
        row.update({k: r["stats"][k] for k in keep})
        if r.get("profile"):
            row["profiled_wall_s"] = r["profile"]["wall_s"]
            row["profiled_device_busy_s"] = r["profile"]["device_busy_s"]
            row["device_time_by_kernel"] = r["profile"]["by_kernel"]
        out[name] = row
    return out


def check_tokens(cfg, name, r, reqs) -> None:
    """Every request of the (fresh) queue ``reqs`` got its tokens, all in
    the vocab."""
    n_tok = sum(len(x) for x in r["gen"].values())
    want = sum(q.max_new for q in reqs)
    check(n_tok == want, f"{cfg.name} {name}: {n_tok} tokens, not {want}")
    check(all(0 <= t < cfg.vocab_size for x in r["gen"].values() for t in x),
          f"{cfg.name} {name}: token outside the vocab")


def lm_main_path(dev) -> dict:
    """qwen2-1.5b at full width, random weights from the port's init (seed
    0), served through the port's Scheduler in bf16 in three modes (the
    speculative one on the damped weights, so that drafts are accepted);
    then the kernel's run held against the plain version's."""
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
    reqs = lambda: requests_of(cfg.vocab_size, LM_LENS, LM_GEN)
    modes = {"whole": {}, "chunked": {"prefill_chunk": LM_CHUNK},
             "spec": {"spec_k": LM_SPEC_K}}
    serve_once(cfg, dev, pbf, torch.bfloat16, {"prefill_chunk": LM_CHUNK},
               reqs())
    runs = {}
    for name, mode in modes.items():
        # the profiled repeat only for whole prefill: the profiler's
        # post-processing was most of this phase's time
        r = serve_once(cfg, dev, damped(cfg, pbf) if name == "spec" else pbf,
                       torch.bfloat16, mode, reqs(),
                       profile_reqs=reqs() if name == "whole" else None)
        check_tokens(cfg, name, r, reqs())
        check_spec(cfg.name, name, r)
        check(r["launches"]["paged_attn"] > 0, f"{name}: paged_attn not launched")
        check(all(r["launches"][k] == 0 for k in
                  ("pixcon", "lstm_cell", "conv1d", "ssd_chunk", "local_attn")),
              f"{name}: a kernel of another path ran: {r['launches']}")
        runs[name] = r
        print_run("qwen2-1.5b", name, r)
    # streams are a pure function of (prompt, params): in bf16 the modes
    # round differently, so only the share of equal tokens is printed
    print(f"  bf16 streams, chunked vs whole: "
          f"{same_tokens(runs['chunked']['gen'], runs['whole']['gen']):.3f} "
          "equal")

    stamp("bf16 served runs done")
    # the kernel against the plain version, end to end on the card
    bf = decode_logits_check(cfg, dev, pbf, torch.bfloat16, reqs())
    rel = bf["rel_err"]
    print(f"  bf16 decode_step_paged logits, kernel vs plain: "
          f"{rel:.3e} of the largest |logit| (tolerance {REL_LOGITS_BF16}); "
          f"argmax equal {bf['argmax_equal']}")
    check(rel <= REL_LOGITS_BF16, f"bf16 decode logits differ by {rel}")
    bf_plain = serve_once(cfg, dev, pbf, torch.bfloat16, modes["whole"],
                          reqs(), ops=tfm.PLAIN)
    check(not any(bf_plain["launches"].values()), "the plain run launched")
    share = same_tokens(runs["whole"]["gen"], bf_plain["gen"])
    print(f"  bf16 whole-prefill streams, kernel vs plain: {share:.3f} equal")
    del pbf
    # fp32 on the main path's weights: the reference's init law makes the
    # 28-layer model chaotic (attention scores in the hundreds), so two
    # correct float32 runs part within a few tokens; the CPU control shows
    # by how much. Each launch is held against the plain version instead.
    stamp("bf16 checks done")
    f32_logits = decode_logits_check(cfg, dev, p32, torch.float32, reqs(),
                                     cpu_control=True)
    stamp("fp32 logits and CPU control done")
    print(f"  fp32 decode_step_paged logits: kernel vs plain "
          f"{f32_logits['rel_err']:.3e}, plain on the card vs on the CPU "
          f"{f32_logits['cpu_rel_err']:.3e} of the largest |logit| "
          f"({f32_logits['scale']:.3f}); argmax equal kernel/plain "
          f"{f32_logits['argmax_equal']}, card/CPU "
          f"{f32_logits['cpu_argmax_equal']}")
    f32 = {}
    d32 = damped(cfg, p32)
    for name, mode in modes.items():
        ops = checked_ops()
        r = serve_once(cfg, dev, d32 if name == "spec" else p32,
                       torch.float32, mode, reqs(), ops=ops)
        check_spec(cfg.name, name, r)
        checked = ops.paged_attn
        f32[name] = {"checked_launches": checked.calls,
                     "max_rel_err": checked.max_rel}
        print(f"  {name} fp32, every launch held against the plain version: "
              f"{checked.calls} launches, max error {checked.max_rel:.3e} of "
              f"the output's largest |value| (tolerance {REL_F32})")
        check(checked.calls > 0 and checked.max_rel <= REL_F32,
              f"fp32 {name}: kernel differs from plain by {checked.max_rel}")

    # fp32 greedy streams, kernel against plain, at full width on the same
    # weights with the attention projections rescaled to unit-variance
    # outputs, where float32 runs are reproducible (the spec mode on its
    # damped weights)
    stamp("fp32 per-launch checks done")
    well = well_conditioned(cfg, p32)
    del p32
    for name, mode in modes.items():
        w = d32 if name == "spec" else well
        k = serve_once(cfg, dev, w, torch.float32, mode, reqs())
        p = serve_once(cfg, dev, w, torch.float32, mode, reqs(),
                       ops=tfm.PLAIN)
        check_spec(cfg.name, name, k)
        check(k["launches"]["paged_attn"] > 0 and
              not any(p["launches"].values()), "launch counts")
        same = k["gen"] == p["gen"]
        f32[name].update({"kernel_tok_per_s": k["tok_per_s"],
                          "plain_tok_per_s": p["tok_per_s"],
                          "streams_equal": same,
                          "equal_share": same_tokens(k["gen"], p["gen"]),
                          "first_parting": first_parting(k["gen"], p["gen"])})
        print(f"  {name} fp32, {'damped' if name == 'spec' else 'rescaled'} "
              f"weights: kernel {k['tok_per_s']:.1f} "
              f"tok/s, plain {p['tok_per_s']:.1f} tok/s, greedy streams "
              f"equal: {same} (first parting {f32[name]['first_parting']})")
        check(same, f"fp32 {name}: kernel and plain streams differ")
    print("  " + json.dumps({"lm": run_summary(runs), "fp32": f32,
                             "fp32_logits": f32_logits,
                             "bf16_logits_rel_err": rel,
                             "bf16_kernel_vs_plain_equal_share": share}))
    return {"launches": {n: r["launches"] for n, r in runs.items()},
            "profile": runs["whole"]["profile"]}


# What each served mode of a recurrent model must launch (> 0) and must not
# (== 0): the Dom-ST kernels never; ssd_chunk only in a mamba2 whole-prompt
# prefill, local_attn only in a recurrentgemma one — which the spec mode
# runs too, since it admits each prompt whole — and neither with 128-token
# chunks; paged_attn never in mamba2 (no attention layer).
RECURRENT_LAUNCHES = {
    "recurrentgemma-2b": {
        "whole": ({"local_attn", "conv1d", "paged_attn"},
                  {"ssd_chunk", "pixcon", "lstm_cell"}),
        "chunked": ({"conv1d", "paged_attn"},
                    {"local_attn", "ssd_chunk", "pixcon", "lstm_cell"}),
        "spec": ({"local_attn", "conv1d", "paged_attn"},
                 {"ssd_chunk", "pixcon", "lstm_cell"})},
    "mamba2-130m": {
        "whole": ({"ssd_chunk", "conv1d"},
                  {"paged_attn", "local_attn", "pixcon", "lstm_cell"}),
        "chunked": ({"conv1d"},
                    {"paged_attn", "local_attn", "ssd_chunk", "pixcon",
                     "lstm_cell"}),
        "spec": ({"ssd_chunk", "conv1d"},
                 {"paged_attn", "local_attn", "pixcon", "lstm_cell"})},
}


def recurrent_main_path(arch: str, dev) -> dict:
    """``arch`` (recurrentgemma-2b or mamba2-130m) at full width, random
    weights from the port's init (seed 0), served through the port's
    Scheduler in bf16 in three modes, each with the launch counts set to 0
    just before and read just after, the whole-prefill mode profiled once.
    The speculative mode runs on the damped weights, so that drafts are
    accepted and verify rolls the recurrent state back. Then the kernels
    against their plain versions end to end: one bf16 decode step's logits
    on the admitted state, every launch of one fp32 served run per mode
    side by side with the plain versions, and the fp32 greedy streams in
    every mode, kernels against plain versions."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    spec = RECURRENT_RUNS[arch]
    cfg = get_config(arch)
    t0 = time.perf_counter()
    p32 = tfm.init(cfg, torch.Generator(device=dev).manual_seed(LM_SEED))
    pbf = tfm.cast_params(p32, torch.bfloat16, dev)
    torch.cuda.synchronize()
    nparams = sum(t.numel() for t in _leaves(p32))
    print(f"  {arch} params: {nparams / 1e9:.3f} B, {cfg.num_layers} layers, "
          f"init {time.perf_counter() - t0:.1f} s")
    def queue(name):            # a fresh queue: the scheduler consumes it
        return requests_of(cfg.vocab_size, spec["lens"][name], spec["gen"])
    modes = {"whole": {}, "chunked": {"prefill_chunk": LM_CHUNK},
             "spec": {"spec_k": LM_SPEC_K}}
    # warm-up: the kernels load and the allocator settles
    serve_once(cfg, dev, damped(cfg, pbf), torch.bfloat16,
               {"spec_k": LM_SPEC_K},
               requests_of(cfg.vocab_size, spec["lens"]["whole"][:2], 4))
    runs = {}
    for name, mode in modes.items():
        reqs = queue(name)
        prof = requests_of(cfg.vocab_size, *spec["profile"]) \
            if name == "whole" else None
        r = serve_once(cfg, dev, damped(cfg, pbf) if name == "spec" else pbf,
                       torch.bfloat16, mode, reqs, profile_reqs=prof)
        check_tokens(cfg, name, r, queue(name))
        check_spec(arch, name, r)
        need, never = RECURRENT_LAUNCHES[arch][name]
        for k in need:
            check(r["launches"][k] > 0, f"{arch} {name}: {k} not launched")
        for k in never:
            check(r["launches"][k] == 0,
                  f"{arch} {name}: {k} launched {r['launches'][k]} times")
        runs[name] = r
        print_run(arch, name, r)
    if spec["lens"]["chunked"] == spec["lens"]["whole"]:
        print(f"  bf16 streams, chunked vs whole: "
              f"{same_tokens(runs['chunked']['gen'], runs['whole']['gen']):.3f}"
              " equal")
    stamp(f"{arch} bf16 served runs done")

    bf = decode_logits_check(cfg, dev, pbf, torch.bfloat16, queue("whole"))
    rel = bf["rel_err"]
    print(f"  {arch} bf16 decode_step_paged logits, kernels vs plain: "
          f"{rel:.3e} of the largest |logit| (tolerance {REL_LOGITS_BF16}); "
          f"argmax equal {bf['argmax_equal']}")
    check(rel <= REL_LOGITS_BF16, f"{arch} bf16 decode logits differ by {rel}")
    del pbf

    # fp32: every launch of one served run per mode held against the plain
    # versions on the same inputs, on the weights of that mode's bf16 run
    d32 = damped(cfg, p32)
    f32 = {"checked": {}, "streams": {}}
    for name, mode in modes.items():
        ops = checked_ops()
        r = serve_once(cfg, dev, d32 if name == "spec" else p32,
                       torch.float32, mode, queue(name), ops=ops)
        check_spec(arch, name, r)
        rows = {k: {"launches": c.calls, "max_rel_err": c.max_rel}
                for k, c in zip(tfm.KernelOps._fields, ops)}
        f32["checked"][name] = rows
        for k, c in ((k, c) for k, c in rows.items() if c["launches"]):
            print(f"  {arch} {name} fp32, {k}: {c['launches']} launches held "
                  f"against the plain version, max error "
                  f"{c['max_rel_err']:.3e} of the output's largest |value| "
                  f"(tolerance {REL_F32})")
            check(c["max_rel_err"] <= REL_F32,
                  f"{arch} {name} fp32 {k}: kernel differs from plain by "
                  f"{c['max_rel_err']}")
        for k in RECURRENT_LAUNCHES[arch][name][0]:
            check(rows[k]["launches"] > 0, f"{arch} {name} fp32: {k} never "
                  "checked")
    stamp(f"{arch} fp32 per-launch checks done")

    # fp32 greedy streams, kernels against plain versions: whole prefill on
    # the main path's weights (printed: attention makes them chaotic), and
    # every mode on reproducible weights (checked): the attention
    # projections rescaled to unit variance (mamba2 has no attention
    # layer, so there they are the main path's weights), the spec mode on
    # its damped weights
    has_attn = any("attn" in lp for lp in p32["layers"])
    well = well_conditioned(cfg, p32)
    tag = "rescaled weights" if has_attn else "main weights"
    streams = [("whole", "main weights", p32)] if has_attn else []
    streams += [("whole", tag, well), ("chunked", tag, well),
                ("spec", "damped weights", d32)]
    for name, tag, params in streams:
        k = serve_once(cfg, dev, params, torch.float32, modes[name],
                       queue(name))
        p = serve_once(cfg, dev, params, torch.float32, modes[name],
                       queue(name), ops=tfm.PLAIN)
        check_spec(arch, name, k)
        check(not any(p["launches"].values()), "the plain run launched")
        row = {"kernel_tok_per_s": k["tok_per_s"],
               "plain_tok_per_s": p["tok_per_s"],
               "streams_equal": k["gen"] == p["gen"],
               "equal_share": same_tokens(k["gen"], p["gen"]),
               "first_parting": first_parting(k["gen"], p["gen"])}
        f32["streams"][f"{name}, {tag}"] = row
        print(f"  {arch} {name} fp32, {tag}: kernel {k['tok_per_s']:.1f} "
              f"tok/s, plain {p['tok_per_s']:.1f} tok/s, greedy streams "
              f"equal: {row['streams_equal']} (first parting "
              f"{row['first_parting']})")
        if (name, tag) != ("whole", "main weights") or not has_attn:
            check(row["streams_equal"],
                  f"{arch} {name} fp32 ({tag}): kernel and plain streams "
                  "differ")
    print("  " + json.dumps({arch: run_summary(runs), "fp32": f32,
                             "bf16_logits": bf}))
    return {"launches": {n: r["launches"] for n, r in runs.items()},
            "profile": runs["whole"]["profile"]}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# instantiations that must not spill, by library: a part of the mangled
# name ptxas reports; the two attention kernels at bf16, D=256, and every
# instantiation of the SSD chunk's bf16 kernel (one per k-step count)
BF16_D256 = "I13__nv_bfloat16Li256E"      # template arguments <bf16, 256, ...>
NO_SPILL = {"local_attn": ("local_attn_mma_kernel" + BF16_D256,),
            "paged_attn": ("paged_attn_kernel" + BF16_D256,
                           "paged_attn_merge_kernel" + BF16_D256),
            "ssd_chunk": ("ssd_chunk_mma_kernel",)}


def ptxas_spills(log: str) -> dict:
    """Bytes of spill stores by function, from a ``-Xptxas -v`` log."""
    import re
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn is not None:
            out[fn] = int(m.group(1))
    return out


def check_spills(libs: dict) -> None:
    """Fail the run on any spill store in an instantiation named in
    ``NO_SPILL``, and if the log names none of one's instantiations."""
    for lib, kernels in NO_SPILL.items():
        log = libs[lib].with_suffix(".log")
        spills = ptxas_spills(log.read_text() if log.exists() else "")
        for kernel in kernels:
            found = {fn: b for fn, b in spills.items() if kernel in fn}
            check(bool(found), f"{lib}: no ptxas report for {kernel}")
            for fn, nbytes in found.items():
                print(f"    {lib}: {fn}: {nbytes} bytes spill stores")
                check(nbytes == 0, f"{fn} spills {nbytes} bytes")


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
    check_spills(libs)

    g = torch.Generator().manual_seed(1234)
    print(f"[2] kernels against their plain versions (at {time.perf_counter() - T_START:.0f} s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = [check_pixcon(g, dev), check_lstm(g, dev), check_paged_attn(g, dev),
               check_conv1d(g, dev), check_ssd_chunk(g, dev),
               check_local_attn(g, dev)]
    print(f"[3] main path: Forecaster, domst, 23 watersheds x 400 days (at {time.perf_counter() - T_START:.0f} s)")
    launches, device_ms = main_path(dev)
    print(f"[4] main path: Dom-ST training, domst, 23 watersheds x 400 days, {TRAIN_EPOCHS} epochs (at {time.perf_counter() - T_START:.0f} s)")
    train = train_main_path(dev)
    by_path = {name: {"forecast": c, "training": train["launches"][name]}
               for name, c in launches.items()}
    launches = {name: sum(c.values()) for name, c in by_path.items()}
    by_model = {}
    print(f"[5] main path: paged LM serving, qwen2-1.5b, 8 requests x 64 tokens (at {time.perf_counter() - T_START:.0f} s)")
    by_model["qwen2-1.5b"] = lm_main_path(dev)
    for n, arch in ((6, "recurrentgemma-2b"), (7, "mamba2-130m")):
        print(f"[{n}] main path: paged serving, {arch} (at {time.perf_counter() - T_START:.0f} s)")
        by_model[arch] = recurrent_main_path(arch, dev)
    for res in by_model.values():
        for counts in res["launches"].values():
            for name, c in counts.items():
                if name not in ("pixcon", "lstm_cell"):
                    launches[name] = launches.get(name, 0) + c
    for k in kernels:
        k["launches"] = launches[k["name"]]
        check(k["launches"] > 0, f"{k['name']} was not launched on the main path")
        if k["name"] in device_ms:
            k["device_ms_per_launch_on_main_path"] = device_ms[k["name"]]
            k["launches_by_path"] = by_path[k["name"]]
            k["training"]["device_ms_per_launch_on_main_path"] = \
                train["device_ms"][k["name"]]
            continue
        k["launches_by_mode"] = {
            arch: {mode: c[k["name"]] for mode, c in res["launches"].items()}
            for arch, res in by_model.items()
            if any(c[k["name"]] for c in res["launches"].values())}
        k["device_ms_per_launch_on_main_path"] = {
            arch: device_ms_per_launch(res["profile"]).get(k["name"])
            for arch, res in by_model.items() if arch in k["launches_by_mode"]}
    print(f"[8] all phases passed in {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
