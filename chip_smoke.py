#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on a failed check:

1. the card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel of the port's paths from ``src/repro_torch/
   kernels/csrc``, timed (one ``nvcc`` per source, all six at once), with
   the registers and spills ``ptxas -v`` reports; a spill store in a bf16,
   D=256 instantiation of the two attention kernels (local attention on
   the tensor cores, without and with the softcap; paged attention and
   its merge) or in any
   instantiation of the SSD chunk's bf16 (tensor-core) kernel fails the
   run;
2. each kernel against its plain PyTorch version on the card, at its
   main path's shapes and at ragged ones, 1e-5 abs in fp32 (bf16 within
   2e-2, one bf16 ulp at |out| < 4; the SSD chunk's bf16 y within one
   bf16 ulp at every magnitude, ``RTOL_BF16_ULP``, with the share of its
   elements that differ from the plain output at all): Pix-Con (also
   ``normalize=False``, a temperature other than 1, and near ties: pixels
   whose features differ in one last bit, ``w`` to the bit and the same
   ranking; the training shapes R=23 B=32, R=23 B=8, R=1 B=32; and
   phase 17's drivers' R=23 B=64 and B=74, R=1 B=64 and B=67),
   the LSTM step (also the same training and drivers' shapes, the
   drivers' with D=32 too, H not a multiple
   of its 8-unit tile, D=1, and D+H that walks the weight ring), paged
   attention
   (decode, verify and a 128-token prefill chunk of qwen2-1.5b and of
   recurrentgemma-2b's local layers, gemma2-2b's decode with its softcap
   of 50 on a local and a global layer, llama3.2-3b's (G=3) and olmo-1b's
   (G=1) decode, qwen3-moe-30b-a3b's decode and verify (G=8),
   deepseek-moe-16b's decode (G=1 on 16 KV heads) and internvl2-2b's
   decode and verify (G=2, 50-page rows), plus small shapes with
   a window, a softcap, unassigned pages and an empty row, and phase
   17's served drivers' smoke shapes: 4 query heads on 1, 2 and 4, D=64,
   8- and 16-token pages),
   the causal conv1d (mamba2-130m's and recurrentgemma-2b's prefill and
   step shapes, the drivers' mamba2-130m training step B=8 S=256 and
   their served smoke chunks and verify steps, C not
   a multiple of 128 or of the 8-channel vector, S=1
   and S=2 with a tail, S > 2,048, S < K-1, an input viewed at an odd
   storage offset, at a decode size and at a size the 16-byte path would
   take, which must go the scalar path; K=5; the new tail it writes to the
   bit), the SSD chunk (mamba2-130m's 512-token prefill and the
   drivers' training step, 8 rows of one 256-row chunk, Q in {5, 200,
   256}, and the bf16 kernel's tile edges: Q from 1 to 256 on each side
   of 16 and 64, N in {16, 20, 128}, P in {24, 64}, 2 batch rows of 2
   chunks, in both dtypes) and local attention (recurrentgemma-2b's
   2,560- and 600-token prefills, S not a tile multiple, non-causal,
   Hkv = Hq and MQA, all without a softcap; gemma2-2b's 4,608- and
   1,024-token prefills and two ragged shapes with its softcap of 50,
   q scaled so that the cap moves the output and v halved so that every
   output stays under 4, as ``ATOL_BF16`` assumes); the time of a launch, of
   the plain version and of one PyTorch call computing the same function
   where there is one (``torch.lstm_cell``;
   ``scaled_dot_product_attention`` over K/V gathered beforehand, the
   gather timed apart, or with a boolean band mask, where there is no
   softcap; with gemma2's softcap, in bf16, ``flex_attention`` compiled
   with the cap as its score_mod, the same way; ``F.conv1d`` with
   ``groups=C``, SiLU timed apart) —
   yardsticks only: the port never calls them — beside the bound; for
   each timed paged-attention shape, the split of the page rows over
   blocks (pages a split, splits, blocks); and for Pix-Con, the LSTM
   step, conv1d, the SSD chunk, local attention and gemma2's paged
   attention, beside each timed shape, the host time of a call
   (``host_us``) and the device time of a launch (``device_us``,
   torch.profiler); local attention with the softcap is timed in turns
   with the same shape without it. Then the autograd Functions of conv1d,
   the SSD chunk and local attention (``check_training_functions``) at
   the LM training shapes (recurrentgemma-2b B=2 S=2,560; mamba2-130m B=8
   S=1,024) and at gemma2-2b's softcap shape, in both dtypes: the
   forward's outputs at the kernels' own tolerances, and, as a check of
   the Function's wiring, the gradients of every input within 1e-4 of
   its scale of autograd through the plain version (the backward
   recomputes it), one launch in the forward and none in the backward;
   the bf16 forward launch timed there beside its device time, the plain
   version's time and the bound;
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
   kernel. Then the kernel against its plain version end to end: one
   bf16 ``decode_step_paged`` on the admitted state (logits within 2^-5
   of their largest magnitude) and the share of equal tokens in bf16
   streams; in fp32, one decode step's logits, kernel against plain and
   plain on the card against plain on the CPU (how far two correct
   float32 runs of this chaotic random model part), every launch of
   three served runs held against the plain version on the same inputs
   (within 2e-3 of the output's largest magnitude), and the greedy
   streams, kernel against plain, equal in all three modes on the same
   weights with the attention projections rescaled to unit variance.
   The profiled repeat and the bf16 streams against plain serve one
   wave of the queue (its first 4 requests, 32 new tokens);
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
   qwen2-1.5b's queue cut to one wave (4 requests x 32 new tokens) in the
   three modes (whole and spec: ssd_chunk and conv1d > 0; chunked:
   ssd_chunk 0; every mode: paged_attn 0), the same measurements and
   checks, its profiled repeat the same wave;
8. gemma2-2b at full width and depth (26 layers alternating local and
   global, d 2,304, 8 heads on 4 of 256, vocab 256,000, attention
   softcap 50, final softcap 30, sandwich norms; 2.614 B params, cast to
   bf16 from a float32 init that is freed at once): whole prefill of
   prompts of 4,608/4,300/1,024/512 tokens (two past the 4,096-token
   window), 128-token chunks and ``spec_k=3`` on 512/510/508/506, 32 new
   tokens each; local_attn exactly once a local layer a request in whole
   prefill and spec (13 x 4 = 52), 0 with chunks; paged_attn > 0; the
   other four kernels 0; the same measurements and checks as phase 6
   (the spec run's damped weights also scale the sandwich norms after
   each damped projection);
9. llama3.2-3b (d 3,072, 24 heads on 8; depth cut to 14 of its 28
   layers, ``DENSE_DEPTH``) and olmo-1b (16 layers, d 2,048, 16 heads on
   16, LayerNorm without affine parameters) at full width: whole prefill of qwen2-1.5b's queue cut to 4 requests
   x 32 new tokens (paged_attn > 0, every other kernel 0), tok/s, and one
   bf16 decode step's logits, kernel against plain: printed on the main
   path's weights, with plain on the card against plain on the CPU (the
   init law makes both models chaotic in bf16), and held within 2^-5 on
   the weights with unit-variance attention projections; then every
   launch of an fp32 whole-prefill run held against the plain version
   (2e-3);
10. the serving policies at full width (16-token pages, 128-token
   chunks, 4 slots; ``POLICY_CASES``) and half depth (``POL_DEPTH``:
   qwen2-1.5b 14 of 28 layers, recurrentgemma-2b 13 of 26, the host tier
   scaled to hold as many pages): qwen2-1.5b in bf16 on 4
   shared-prefix families x 4 requests (a 1,024-token system prompt,
   64-192-token tails, 32 new tokens) cold, off device-tier prefix hits
   (an ample pool; >= 12 hits and 12 x 1,024 hit tokens) and off
   host-tier hits (a pool of two requests on 2 slots, 256 MiB of host
   tier; >= 1 host hit, >= 64 pages spilled and restored), preemption
   against defer-only on phase 5's 8 x 512 queue (a pool of three
   requests: >= 1 preemption, restores = preemptions, the defer-only run
   deferred), then the family queue cut to 2 x 2, 16 new tokens, sampled
   (temperature 0.8, top-k 50, top-p 0.95, repetition penalty 1.1, a
   seed a request) whole, chunked, with spec_k=3, preempted and off
   prefix hits, and greedy with spec_k=3 and the model drafting for
   itself (on the damped weights, beside the same queue without it).
   Each run with its launch counts (paged_attn > 0, conv1d > 0 for
   recurrentgemma-2b, the others 0), tok/s, decode tok/s, TTFT p50/p99
   and, for the host-tier and preemption runs, the host time of each
   swap_out, swap_in, spill_page and restore_pages call; bf16 streams'
   share of equal tokens. Then the same runs in fp32 on the rescaled
   weights and the cut queues, and recurrentgemma-2b in fp32 on them:
   the cut family queue cold and off host-tier hits on a pool of one
   request (the recurrent snapshots resume it), and preemption against
   defer-only on phase 6's 512-token queue cut to 16 new tokens. In
   fp32 every launch of the host-hit and preempted runs is held against
   the plain version (2e-3; paged_attn, and conv1d for
   recurrentgemma-2b, on shared prefix pages, rows scattered by swap-in
   and host restore, chunks resuming at offset 1,024, tails restored
   from snapshots), the hit, host-hit and preempted streams must equal
   the cold and defer-only ones, every sampled run must print one
   digest, and the model drafter's stream must equal the cold one with
   every draft accepted;
11. mixture-of-experts serving (``moe_main_path``): qwen3-moe-30b-a3b at
   full width and depth (48 layers, d 2,048, 32 heads on 4 of 128 with QK
   norm, 128 experts top 8 of 768, vocab 151,936; 30.5 B params, drawn
   leaf by leaf in bf16: 61 GB) on one wave (prompts of 512/510/508/506
   tokens, 32 new each) whole, in 128-token chunks and, last, with
   ``spec_k=3`` on weights damped in place (an untied model gets its
   embedding as its unembedding, so that it repeats itself): launch
   counts (paged_attn > 0, the others 0), tok/s, decode tok/s, TTFT
   p50/p99, the decode step against its device floor (every routed
   expert read once), the peak memory, a profiled repeat of whole prefill
   with 8 new tokens, and the bf16 streams of kernel against plain with
   their first parting and the routing flips between the two runs
   (``Routes``); then the same model at 4 of its 48 layers in fp32, in
   the three modes: every paged_attn launch held against the plain
   version (2e-3) and the greedy streams equal to the plain run's, on
   rescaled weights (spec damped); then deepseek-moe-16b at full width
   and depth (28 layers, the first dense, 64 experts top 6 and 2 shared,
   16 heads on 16; 32.75 GB) by whole prefill of the wave, and one bf16
   decode step's logits, kernel against plain, printed on the main
   weights and held within 2^-5 on the rescaled ones;
12. LM training (``lm_training_main_path``, ``LM_TRAIN``):
   recurrentgemma-2b (2 x 2,560 tokens, past its window) and mamba2-130m
   (8 x 1,024, four SSD chunks) at full width and depth, 5 AdamW steps
   each through the train CLI's ``train_lm`` (block remat, bf16
   activations, float32 params and moments, the step donated), params
   from the port's init (seed 0): launches equal to the prediction
   (recurrentgemma 34 conv1d and 16 local_attn a step, mamba2 48 conv1d
   and 48 ssd_chunk), losses finite, the peak memory, the median step
   and tokens/s; on the live state every leaf's gradient finite and
   non-zero, one step timed (CUDA events: its device span) and one
   profiled (device busy time over that span, time by kernel); mamba2's
   checkpoint, and one request served greedily through
   ``InferenceEngine.from_train_state``, its serving params equal to the
   bit and its tokens equal to those of an engine built from that
   checkpoint; then at full width, reduced
   depth (recurrentgemma one (R, R, L) repetition, mamba2 two layers) and
   float32, the loss within 1e-5 and every gradient leaf within 1e-4 of
   its scale, kernels against ``transformer.PLAIN``;
13. the front ends and the contribution gate (``frontend_main_path``):
   internvl2-2b at full width and depth (24 layers, d 2,048, 16 heads on
   8, vocab 92,553; 1.9 B params in bf16) served on one wave of four
   requests, each an image of 256 patch embeddings drawn N(0, 1) and
   512/510/508/506 text tokens, 32 new, whole, in 128-token chunks (a
   request with patches is admitted whole: none is chunked) and, on
   damped weights, with ``spec_k=3``: paged_attn launches equal to the
   CPU rehearsal's prediction (``VLM_LAUNCHES``), no other kernel, tok/s,
   decode tok/s, TTFT p50/p99, a profiled repeat of whole prefill; one
   bf16 decode step's logits, kernel against plain (held within 2^-5 on
   rescaled weights), and moved by more than that by other images under
   the same prompts; at 6 of its 24 layers in fp32, with the contribution
   gate off and on, in every mode every launch held against the plain
   version (2e-3) and the greedy streams, kernel against plain, equal;
   then hubert-xlarge (48 layers, d 1,280, non-causal; 4 x 1,024 frames)
   and internvl2-2b (2 x 1,024 positions, 256 of them patches) trained 3
   steps each at full width and depth through the train CLI's
   ``train_lm``: no kernel launched, losses finite, the peak memory, the
   median step and positions/s, every leaf's gradient finite and
   non-zero (``frontend`` included), one step timed and one profiled,
   and the train CLI at 2 layers in float32 with the kernels' ops and
   the plain ones: losses within 1e-5;
14. distribution on a 1x1 mesh (``distribution_main_path``): a world-1
   NCCL group started by ``launch.mesh.make_host_mesh()``, destroyed at
   phase 16's end (the mesh's trained mamba2 is served there); the stacked Dom-ST engine (23 watersheds, float32)
   for one epoch of 9 steps and the forecast of the 74 held-out days,
   then mamba2-130m at full width and depth (8 x 1,024, bf16, block
   remat) with the FSDP rule variant for 3 steps, each on the mesh and on
   one device from the same state: launches on the mesh as phases 3, 4
   and 12 count them (a Dom-ST step 1 Pix-Con and 60 LSTM, a forecast 74
   and 4,440, a mamba2 step 48 conv1d and 48 SSD chunk), Dom-ST's params,
   moments, losses and forecast within 1e-6 of their scale of the
   one-device run's, mamba2's bf16 losses finite and its losses, params
   and moments within 1e-6 of their scale of the one-device run's (the
   1x1 mesh runs the same operations), the step times on and off the
   mesh printed; phase 2 also times the
   library calls at the training shapes (``library_at_training_shapes``:
   ``torch.lstm_cell`` at 23 x 32 rows, ``F.conv1d(groups=C)`` at both
   LM training shapes, SDPA with a band mask at recurrentgemma-2b's);
15. serving on the 1x1 mesh (``serving_mesh_main_path``): qwen2-1.5b at
   full width and depth in bf16, one wave in three modes on and off the
   mesh: launches as ``scripts/serve_mesh_rehearsal.py`` predicts, equal
   on and off the mesh, streams equal; float32 at 6 layers, every launch
   on the mesh against plain, the contiguous engine against the paged;
16. more archs on the 1x1 mesh (``serving_mesh_archs_main_path``):
   mamba2-130m in three modes and deepseek-moe-16b whole at full width
   and depth in bf16 (the conv1d, SSD-chunk and paged-attention kernels
   on local blocks, the MoE layers through ``moe_block_sharded``), each
   held to phases 7 and 11's one-device runs of the same seed and queue:
   launches as ``serve_mesh_rehearsal.py --phase 16`` predicts, streams
   equal, decode steps timed on and off the mesh; float32 at 6 and 3
   layers, every launch on the mesh against plain and the streams equal
   to one device's; then phase 14's trained mamba2-130m adopted on its
   mesh by ``InferenceEngine.from_train_state``, its streams and
   launches equal to the one-device engine's on the gathered state;
17. the user-facing drivers (``drivers_main_path``), each ``main()`` with
   its own launch counts: ``examples/train_flood_torch.py`` at its
   defaults (all 23 watersheds x 400 days, 6 epochs of stacked steps
   through ``Engine`` and ``ShardedLoader``, Dom-ST then the Singlehead
   ablation; the held-out NSE per watershed of both and Dom-ST's share of
   wins printed, the share not gated), ``quickstart_torch.py`` (300 steps
   through the seed-era ``domst.make_train_step``), ``train_lm_torch.py
   --full`` (mamba2-130m, 8 x 256, ``DRIVER_LM_STEPS`` steps),
   ``serve_lm_torch.py`` (five families at their smoke configs through
   ``serve(args)``, then the shared-prefix workload) and
   ``scripts/ci_smoke_torch.py``'s four checks in-process with their own
   assertions; every loss and NSE finite, both variants' and the
   quickstart's losses falling, each driver's launches as
   ``scripts/drivers_rehearsal.py`` counts them (``DRIVER_LAUNCHES``: the
   training drivers' exactly, the served ones' more than 0; serve_lm's
   demo admits every prompt in 8-token chunks, so it launches no
   local_attn or ssd_chunk), the wall time of each printed;
18. one JSON line listing every ported kernel with its error, times, bound
   and launches (by model and mode; by path: Pix-Con and the LSTM step in
   the forecast and training, on and off the mesh, with their times at
   the training shapes, and every kernel in phase 17's drivers; conv1d,
   the SSD chunk and local attention with their training shapes), then
   the line with the card's name and power limit;
19. the last line, ``{"ok": true, "device": {...}}``.

It needs one card. ``torch.compile`` (the flex_attention yardstick)
keeps its caches under ``build/`` and compiles in this process. Without CUDA, or run from a directory that does not
hold the repository's ``src/repro_torch``, it exits non-zero and prints no
result. It imports nothing of JAX and nothing of the reference package.
"""
from __future__ import annotations

import json
import os
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
# kernel shapes of the drivers (phase 17, scripts/drivers_rehearsal.py
# --shapes): train_flood's stacked step and held-out forward (74 test
# windows a watershed), the quickstart's step and test forward (67)
DRIVER_RB = ((WATERSHEDS, 64), (WATERSHEDS, 74), (1, 64), (1, 67))
# phase 2 draws the drivers' shapes' inputs from a generator of this seed,
# so that every other check draws what it drew before they were added
DRIVER_SEED = 1717
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
# its float32 per-launch and stream checks at a quarter of its 28 layers
# (the bf16 runs, the logits checks and the width are whole): the cut
# that pays for phases 15 and 16
LM_F32_DEPTH = 7
# The served models' queues on 4 slots, by mode, and the queue of the
# profiled repeat of whole prefill. recurrentgemma-2b and gemma2-2b: whole
# prefill with prompts past their window (2,048 and 4,096 tokens:
# local_attn's band, the ring-to-pages fill and paged_attn's window all do
# real work); chunked prefill and speculative verify take 512-token prompts
# (a recurrent layer steps through every token of a chunk). mamba2-130m:
# qwen2-1.5b's queue cut to one wave (4 requests, 32 tokens) in all three
# modes, and so its profiled repeat: its 24 layers make ~150,000 launches
# on the whole queue a mode, and the script's time went to phase 10.
STEP_LENS = LM_LENS[:4]
SERVED_RUNS = {
    "recurrentgemma-2b": {
        "lens": {"whole": [2560, 2300, 600, 512], "chunked": STEP_LENS,
                 "spec": STEP_LENS},
        "gen": 32, "profile": ([2560, 2300, 600, 512], 32)},
    "mamba2-130m": {
        "lens": {"whole": STEP_LENS, "chunked": STEP_LENS, "spec": STEP_LENS},
        "gen": 32, "profile": (STEP_LENS, 32)},
    "gemma2-2b": {
        "lens": {"whole": [4608, 4300, 1024, 512], "chunked": STEP_LENS,
                 "spec": STEP_LENS},
        "gen": 32, "profile": ([4608, 4300, 1024, 512], 32)},
}
# Their float32 checks (every launch against plain, the greedy streams)
# at about a quarter of their depth, each layer kind kept (two of
# recurrentgemma's (R, R, L) repetitions, three of gemma2's (L, G)):
# with phase 5's, the cut that pays for phases 15 and 16
SERVED_F32_DEPTH = {"recurrentgemma-2b": 6, "mamba2-130m": 6,
                    "gemma2-2b": 6}
# Phase 10, the serving policies: shared-prefix families (a 1,024-token
# system prompt and a 64-192-token tail each), 4 families x 4 requests
# with 32 new tokens for qwen2-1.5b in bf16, else cut to 2 x 2 with 16;
# the host tier 256 MiB
POL_PREFIX, POL_TAIL, POL_FAMILIES, POL_PER_FAMILY = 1024, (64, 192), 4, 4
POL_GEN, POL_GEN_CUT, POL_HOST_BYTES = 32, 16, 256 << 20
# and at half depth, to keep the whole run near half its 1,200 s limit
# (561.0 s on PR 21's run 4, 761.4 s on its slower final proof); the host
# tier is scaled with the page blob (``page_bytes``), so that it holds as
# many pages as at full depth
POL_DEPTH = {"qwen2-1.5b": 14, "recurrentgemma-2b": 13}
# The other dense decoders at full width, whole prefill only, on
# qwen2-1.5b's queue cut to one wave (4 requests, 32 new tokens each);
# llama3.2-3b at half its depth, to keep the script's time for phase 10
DENSE_ARCHS, DENSE_LENS, DENSE_GEN = ("llama3.2-3b", "olmo-1b"), STEP_LENS, 32
DENSE_DEPTH = {"llama3.2-3b": 14}
# Phase 13, the front ends and the contribution gate: internvl2-2b at full
# width and depth in bf16 on one wave (4 requests, each an image of 256
# patches drawn N(0, 1) from the seed and 512/510/508/506 text tokens, 32
# new), whole, in 128-token chunks (a request with patches is admitted
# whole) and with spec_k=3 (damped weights); its fp32 checks at 6 of its
# 24 layers, the gate off and on. paged_attn launches by mode, from a CPU
# rehearsal at full depth (``scripts/frontend_rehearsal.py``): 24 layers
# x 31 decode steps, whole and chunked alike; the spec run's verify and
# decode steps. hubert-xlarge (4 x 1,024 frames) and internvl2-2b (2 x
# 1,024 positions: 256 patches + 768 text) trained 3 steps each at full
# width and depth, launching no kernel; the float32 kernel-against-plain
# run through the train CLI at ``check_layers``.
VLM_ARCH, VLM_PATCHES, VLM_LENS, VLM_GEN = "internvl2-2b", 256, STEP_LENS, 32
VLM_F32_DEPTH = 6
VLM_LAUNCHES = {"whole": 24 * 31, "chunked": 24 * 31, "spec": 24 * 16}
FE_TRAIN = {
    "hubert-xlarge": {"batch": 4, "seq": 1024, "steps": 3, "check_layers": 2},
    "internvl2-2b": {"batch": 2, "seq": 1024, "steps": 3, "check_layers": 2},
}
# Phase 11, mixture-of-experts serving: qwen3-moe-30b-a3b at full width and
# depth (48 layers, 30.5 B params, 61 GB in bf16) on one wave (4 requests
# of 512/510/508/506 tokens, 32 new each) in three modes, its profiled
# repeat the wave with 8 new tokens; the same model at 4 of its 48 layers
# in float32 for the per-launch and stream checks; deepseek-moe-16b at full
# width and depth by whole prefill of the same wave
MOE_LENS, MOE_GEN, MOE_PROFILE_GEN, MOE_F32_DEPTH = STEP_LENS, 32, 8, 4
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
DAMPED_NORMS = ("post_norm1", "post_norm2")


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
    gd = torch.Generator().manual_seed(DRIVER_SEED)
    cases = [(*c, g) for c in cases] + [
        ((R, B, 30, 64), True, 1.0, gd) for R, B in DRIVER_RB]
    for shape, normalize, temp, gen in cases:
        a = pixcon_inputs(gen, dev, *shape)
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
    # the drivers' (Singlehead's first layer takes D=32)
    driver_shapes = [(R, B, D, 64) for R, B in DRIVER_RB
                     for D in (128, 64, 32)]
    gd = torch.Generator().manual_seed(DRIVER_SEED)
    for shape, gen in [(s, g) for s in main_shapes + train_shapes] + [
            (s, gd) for s in driver_shapes] + [(s, g) for s in [
            (3, 5, 48, 160), (1, WATERSHEDS, 128, 64), (4, 2, 7, 50),
            (5, 3, 1, 64), (2, 3, 4000, 64)]]:
        a = lstm_inputs(gen, dev, *shape)
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
    # donate=False throughout: state0 is stepped again by the profiled
    # repeat, the plain engine and the accumulation check below
    engine = Engine.for_domst(cfg, tc, stacked=True, donate=False, device=dev)
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
    plain = Engine.for_domst(cfg, tc, stacked=True, donate=False, device=dev,
                             ops=domst.PLAIN)
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
        e = Engine.for_domst(cfg, sgd, stacked=True, accum_steps=A,
                             donate=False, device=dev)
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
    """Bytes the function must move (the K/V rows of every KV head and the
    positions of each page holding a key some query of its slot can
    attend to, q, out, the page rows and query positions, each once: a
    window leaves a slot's older pages unread) and its operations (q.k
    and p.v over the keys each query row can attend to: 4 operations a
    key and dim)."""
    B, T, Hq, D = a["q"].shape
    ps, Hkv = a["k_pool"].shape[1], a["k_pool"].shape[2]
    esize = a["q"].element_size()
    _, _, mask = gathered_mask(a, window)                # (B, 1, T, n * ps)
    pages = int(mask.any(2).reshape(B, -1, ps).any(-1).sum())
    nbytes = (pages * ps * (2 * Hkv * D * esize + 4) + 2 * a["q"].numel() * esize
              + 4 * (a["page_rows"].numel() + a["qpos"].numel()))
    keys = int(mask.sum()) * Hq            # attendable (row, key) pairs
    return nbytes, 4.0 * keys * D


def check_paged_attn(g, dev) -> dict:
    """The paged-attention kernel against its plain version at the LM main
    paths' shapes in bf16 and fp32: decode T=1 and verify T=4 over 4
    slots, a 128-token prefill chunk of one slot, for qwen2-1.5b (12 query
    heads on 2 KV heads, D=128, no window, 36 pages a slot) and for
    recurrentgemma-2b's local layers (10 on 1, D=256, window 2,048, 162
    pages a slot), all with 16-token pages; gemma2-2b's decode (8 on 4,
    D=256, softcap 50, a local layer's window of 4,096 and a global
    layer's none, 290 pages a slot); llama3.2-3b's (24 on 8) and olmo-1b's
    (16 on 16) decode, D=128; qwen3-moe-30b-a3b's decode and verify (32
    on 4) and deepseek-moe-16b's decode (16 on 16), D=128; internvl2-2b's
    decode and verify (16 on 8), D=128, 50-page rows; and at small shapes
    with a window, a softcap, unassigned pages and an empty row. Then
    times at the main shapes, with the host time of a call and the device
    time of a launch at gemma2's, llama3.2's, olmo's, the MoE decoders'
    and internvl2's."""
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
    rg_whole = SERVED_RUNS["recurrentgemma-2b"]["lens"]["whole"]
    rg_gen = SERVED_RUNS["recurrentgemma-2b"]["gen"]
    rg = dict(Hq=10, Hkv=1, D=256, ps=16, window=2048, softcap=0.0,
              n=-(-(max(rg_whole) + rg_gen) // 16))
    rg_mid = [n + rg_gen // 2 for n in rg_whole]
    main.update({
        "rg_decode": dict(B=4, T=1, lens=rg_mid, **rg),
        "rg_verify": dict(B=4, T=LM_SPEC_K + 1, lens=rg_mid, **rg),
        "rg_chunk": dict(B=1, T=LM_CHUNK, lens=[max(rg_whole)],
                         qpos_end=[max(rg_whole)], **rg)})
    # gemma2-2b's decode, mid-way through its whole-prefill queue's new
    # tokens: 8 query heads on 4 KV heads, D=256, the attention softcap
    # of 50; a local layer (window 4,096) and a global one
    g2_whole = SERVED_RUNS["gemma2-2b"]["lens"]["whole"]
    g2_gen = SERVED_RUNS["gemma2-2b"]["gen"]
    g2 = dict(Hq=8, Hkv=4, D=256, ps=16, softcap=50.0,
              n=-(-(max(g2_whole) + g2_gen) // 16))
    g2_mid = [n + g2_gen // 2 for n in g2_whole]
    main.update({
        "g2_decode_local": dict(B=4, T=1, lens=g2_mid, window=4096, **g2),
        "g2_decode_global": dict(B=4, T=1, lens=g2_mid, window=0, **g2)})
    # llama3.2-3b's (24 query heads on 8, G=3) and olmo-1b's (16 on 16,
    # G=1: one query row of the kernel's 16-row tile a (b, h)) decode, D=128,
    # mid-way through phase 9's queue
    dense = dict(D=128, ps=16, window=0, softcap=0.0,
                 n=-(-(max(DENSE_LENS) + DENSE_GEN) // 16))
    dense_mid = [n + DENSE_GEN // 2 for n in DENSE_LENS]
    main.update({
        "l32_decode": dict(B=4, T=1, lens=dense_mid, Hq=24, Hkv=8, **dense),
        "olmo_decode": dict(B=4, T=1, lens=dense_mid, Hq=16, Hkv=16, **dense)})
    # the MoE decoders, mid-way through phase 11's wave: qwen3-moe-30b-a3b
    # (32 query heads on 4, G=8: 8 query rows a (slot, KV head) in decode,
    # 32 in verify) and deepseek-moe-16b (16 on 16, G=1), D=128
    moe_attn = dict(D=128, ps=16, window=0, softcap=0.0,
                    n=-(-(max(MOE_LENS) + MOE_GEN) // 16))
    moe_mid = [n + MOE_GEN // 2 for n in MOE_LENS]
    main.update({
        "q3_decode": dict(B=4, T=1, lens=moe_mid, Hq=32, Hkv=4, **moe_attn),
        "q3_verify": dict(B=4, T=LM_SPEC_K + 1, lens=moe_mid, Hq=32, Hkv=4,
                          **moe_attn),
        "ds_decode": dict(B=4, T=1, lens=moe_mid, Hq=16, Hkv=16,
                          **moe_attn)})
    # internvl2-2b, mid-way through phase 13's wave: 16 query heads on 8
    # (G=2), D=128, rows of (256 patches + 512 text + 32 new) / 16 = 50
    # pages, the image's positions cached before the text's
    iv = dict(Hq=16, Hkv=8, D=128, ps=16, window=0, softcap=0.0,
              n=-(-(VLM_PATCHES + max(VLM_LENS) + VLM_GEN) // 16))
    iv_mid = [VLM_PATCHES + n + VLM_GEN // 2 for n in VLM_LENS]
    main.update({
        "iv_decode": dict(B=4, T=1, lens=iv_mid, **iv),
        "iv_verify": dict(B=4, T=LM_SPEC_K + 1, lens=iv_mid, **iv)})
    # internvl2's shapes draw from a generator of their own: the inputs
    # that every later check of phase 2 draws from ``g`` stay those of the
    # runs before these shapes were added
    g_iv = torch.Generator().manual_seed(2222)
    gd = torch.Generator().manual_seed(DRIVER_SEED)

    def gen_of(name):
        return (g_iv if name.startswith("iv_") else
                gd if name.startswith("drivers_") else g)
    small = [dict(B=3, T=7, Hq=4, Hkv=1, D=64, ps=4, n=6, lens=[13, 0, 9],
                  window=5, softcap=50.0),
             dict(B=2, T=3, Hq=8, Hkv=2, D=128, ps=16, n=3, lens=[20, 33],
                  window=0, softcap=30.0)]
    # phase 17's served drivers at their smoke configs (4 query heads,
    # D=64): serve_lm's 8-token pages, decode and verify on 3 slots with
    # recurrentgemma's window of 16 or gemma2's softcap of 50, an 8-token
    # chunk; ci_smoke's 16-token pages
    drivers = {
        "drivers_decode": dict(B=3, T=1, Hq=4, Hkv=1, D=64, ps=8, n=6,
                               lens=[20, 13, 41], window=16, softcap=0.0),
        "drivers_verify": dict(B=3, T=4, Hq=4, Hkv=2, D=64, ps=8, n=4,
                               lens=[12, 30, 25], window=16, softcap=50.0),
        "drivers_chunk": dict(B=1, T=8, Hq=4, Hkv=4, D=64, ps=8, n=6,
                              lens=[40], window=0, softcap=0.0),
        "drivers_ci": dict(B=2, T=5, Hq=4, Hkv=1, D=64, ps=16, n=2,
                           lens=[9, 20], window=0, softcap=0.0)}
    err = {"float32": 0.0, "bfloat16": 0.0}
    for dtype, atol in ((torch.float32, ATOL_KERNEL),
                        (torch.bfloat16, ATOL_BF16)):
        # the main shapes, and the chunk's T over 4 slots as well
        wide = dict(B=4, T=LM_CHUNK, lens=mid, **qwen)
        cases = [*main.items(), ("chunk_4slots", wide)]
        cases += [(f"small{i}", c) for i, c in enumerate(small)]
        cases += list(drivers.items())
        for name, c in cases:
            kw = dict(window=c["window"], softcap=c["softcap"])
            a = paged_inputs(gen_of(name), dev, dtype, c["B"], c["T"], c["Hq"],
                             c["Hkv"], c["D"], c["ps"], c["n"], c["lens"],
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
    # (SDPA; with a softcap, which SDPA cannot take, flex_attention in
    # bf16); with the host time of a call and the device time of a launch
    # at gemma2's, llama3.2's and olmo's
    shapes = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, c in main.items():
            win = dict(window=c["window"])
            kw = dict(win, softcap=c["softcap"])
            a = paged_inputs(gen_of(name), dev, dtype, c["B"], c["T"], c["Hq"],
                             c["Hkv"], c["D"], c["ps"], c["n"], c["lens"],
                             c.get("qpos_end"))
            call = lambda: paged_attention_fused(**a, **kw)
            ms = time_ms(call)
            plain_ms = time_ms(lambda: paged_attention_ref(**a, **kw),
                               iters=50)
            gather_ms = lib_ms = lib_err = None
            cap = c["softcap"]
            if not cap or dtype == torch.bfloat16:
                gather_ms = time_ms(lambda: gathered_mask(a, **win), iters=50)
                k, v, mask = gathered_mask(a, **win)
                q = a["q"].transpose(1, 2)
                if cap:
                    lib = flex_softcap(q.contiguous(), k.contiguous(),
                                       v.contiguous(), cap,
                                       lambda b, h, qi, kj: mask[b, 0, qi, kj])
                else:
                    def lib():
                        return F.scaled_dot_product_attention(
                            q, k, v, attn_mask=mask, enable_gqa=True)
                lib_err = max_err(lib().transpose(1, 2).float(),
                                  call().float())
                lib_ms = time_ms(lib)
            host = dev_us = None
            if name.startswith(("g2_", "l32_", "olmo_", "q3_", "ds_", "iv_")):
                host = host_us(call)
                dev_us = launch_device_us(call, "paged_attn", n=20)
            # bf16 inputs: the tensor cores' bf16 rate; fp32: the CUDA cores'
            b_ms, b_by = bound_ms(*paged_work(a, **win), BF16_OPS_PER_S
                                  if dtype == torch.bfloat16 else FP32_OPS_PER_S)
            tag = str(dtype).split(".")[-1]
            pps, splits, blocks = grid_of(c["B"], c["T"], c["Hq"], c["Hkv"],
                                          c["n"], sm_count(dev.index))
            row = {"shape": name, "dtype": tag, "B": c["B"], "T": c["T"],
                   "softcap": c["softcap"], "window": c["window"],
                   "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "gather_ms": gather_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library_vs_kernel_err": lib_err, "host_us": host,
                   "device_us": dev_us,
                   "pages_per_split": pps, "splits": splits, "blocks": blocks}
            shapes.append(row)
            lib_note = ("flex_attention timed in bf16 only" if lib_ms is None
                        else f"{'flex_attention' if cap else 'sdpa'} "
                        f"{lib_ms * 1e3:.2f} us (+ gather "
                        f"{gather_ms * 1e3:.2f} us; agrees to {lib_err:.1e})")
            host_note = "" if host is None else (
                f"; host {host:.2f} us a call, device "
                f"{'not measured' if dev_us is None else f'{dev_us:.2f} us'}"
                " a launch")
            print(f"  paged_attn {name} {tag}: kernel {ms * 1e3:.2f} us, plain "
                  f"{plain_ms * 1e3:.2f} us, {lib_note}, bound "
                  f"{b_ms * 1e3:.3f} us ({b_by}); {splits} split(s) of {pps} "
                  f"of {c['n']} pages, {blocks} blocks"
                  f"{' + merge' if splits > 1 else ''}{host_note}")
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
                       "timed apart; with a softcap, flex_attention "
                       "(torch.compile) with the cap as its score_mod",
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
    4-slot decode step with a tail; the drivers' mamba2-130m training
    step, B=8 S=256, and their served smoke chunk and verify steps) and
    ragged ones (C not a multiple of
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
             ("k5", 2, 19, 512, 5, "silu", True, 0),
             # phase 17's: train_lm --full (a mamba2-130m step, 8 x 256);
             # serve_lm's smoke mamba2 and recurrentgemma, a chunk and
             # a verify on 3 slots
             ("drivers_train_lm", 8, 256, 1792, 4, "silu", False, 0),
             ("drivers_mamba2_chunk", 1, 8, 544, 4, "silu", True, 0),
             ("drivers_mamba2_verify", 3, 4, 544, 4, "silu", True, 0),
             ("drivers_rg_verify", 3, 4, 256, 4, "none", True, 0)]
    gd = torch.Generator().manual_seed(DRIVER_SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err = {"float32": 0.0, "bfloat16": 0.0}
    for dtype, atol in ((torch.float32, ATOL_KERNEL),
                        (torch.bfloat16, ATOL_BF16)):
        tag = str(dtype).split(".")[-1]
        for name, B, S, C, K, act, tail, off in cases:
            a = conv_args(gd if name.startswith("drivers_") else g, dev,
                          dtype, B, S, C, K, tail)
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
    whole-prompt prefill shape (2 chunks of Q=256, H=24, N=128, P=64) and
    the drivers' training step (8 rows of one chunk), at
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
             ("smoke", 1, 3, 8, 4, 16, 32),
             # phase 17's train_lm --full: a mamba2-130m step, 8 x 256
             ("drivers_train_lm", 8, 1, 256, 24, 128, 64)]
    gd = torch.Generator().manual_seed(DRIVER_SEED)
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
            a = ssd_inputs(gd if name.startswith("drivers_") else g, dev,
                           dtype, B, nc, Q, H, N, P)
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


def band_mod(window, causal):
    """Whether key ``kj`` is attendable from query ``qi`` in the band (the
    signature of flex_attention's ``mask_mod``)."""
    def mod(b, h, qi, kj):
        delta = qi - kj
        mask = delta < window
        return mask & (delta >= 0) if causal else mask & (-delta < window)
    return mod


def band_mask(S, window, causal, dev):
    """(S, S) bool: key j attendable from query i."""
    import torch
    i = torch.arange(S, device=dev)[:, None]
    j = torch.arange(S, device=dev)[None, :]
    return band_mod(window, causal)(None, None, i, j)


_FLEX = {}


def flex_softcap(q, k, v, cap, mask_mod):
    """The library yardstick where SDPA takes no score modifier: one call
    of ``torch.nn.attention.flex_attention``, compiled once a shape by
    ``torch.compile`` into a fused kernel, with the softcap
    ``cap * tanh(s / cap)`` as its ``score_mod`` (after the 1/sqrt(D)
    scale, as the kernels apply it) and the keys of ``mask_mod`` as its
    block mask. q (B, Hq, Tq, D), k and v (B, Hkv, L, D), GQA. Returns the
    call, with its block mask built beforehand; it is timed and compared
    only, the port never calls it."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    if "fn" not in _FLEX:
        _FLEX["fn"] = torch.compile(flex_attention, dynamic=False)
    if cap not in _FLEX:       # one score_mod a cap: no recompile for it
        _FLEX[cap] = lambda s, b, h, qi, kj: cap * torch.tanh(s / cap)
    fn, score_mod = _FLEX["fn"], _FLEX[cap]
    block = create_block_mask(mask_mod, q.shape[0], None, q.shape[2],
                              k.shape[2], device=q.device)
    return lambda: fn(q, k, v, score_mod=score_mod, block_mask=block,
                      enable_gqa=True)


def local_work(B, S, Hq, Hkv, D, window, causal, esize) -> tuple[float, float]:
    """Bytes (q, k, v read once, out written once) and operations: q.k and
    p.v over the attendable (query, key) pairs, 4 a pair and dim."""
    pairs = int(band_mask(S, window, causal, "cpu").sum())
    nbytes = esize * B * S * D * (2 * Hq + 2 * Hkv)
    return nbytes, 4.0 * B * Hq * pairs * D


# Softcap cases: q scaled by LOCAL_CAP_Q_SCALE, so the scores spread ~4
# and reach ~20, where gemma2's cap of 50 moves an output by up to ~0.15
# (a spread of 1 leaves it within ~1e-2 of the uncapped one). Attention
# that peaked makes an output nearly one entry of v, and unit-normal v
# entries pass 4, where a bf16 ulp is 2^-5 > ATOL_BF16: two correct
# roundings of a float32 result near a midpoint part by it. So v is
# scaled by LOCAL_CAP_V_SCALE: every |out| stays under ~3, within
# ATOL_BF16's premise of one bf16 ulp at |out| < 4.
LOCAL_CAP_Q_SCALE, LOCAL_CAP_V_SCALE = 4.0, 0.5


def check_local_attn(g, dev) -> dict:
    """The local-attention kernel against its plain version at
    recurrentgemma-2b's prefill shapes (10 query heads on 1 KV head,
    D=256, window 2,048; S=2,560 and S=600 < window) and ragged ones (S not
    a tile multiple, non-causal, Hkv = Hq, MQA, D=64 and 128), fp32 and
    bf16, with no softcap; then with gemma2-2b's softcap of 50 at its
    prefill shapes (8 query heads on 4, D=256, window 4,096; S=4,608 past
    the window and S=1,024) and a ragged S. Then times beside
    ``scaled_dot_product_attention`` with a boolean band mask where there
    is no softcap (SDPA takes no score modifier) and, with the softcap in
    bf16, beside a compiled ``flex_attention`` with the cap as its
    score_mod; with the host time of a call and the device time of a
    launch."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.local_attn.ops import local_attention_fused
    from repro_torch.kernels.local_attn.ref import local_attention_ref
    cases = [("rg_prefill_2560", 1, 2560, 10, 1, 256, 2048, True, 0.0),
             ("rg_prefill_600", 1, 600, 10, 1, 256, 2048, True, 0.0),
             ("ragged_gqa", 1, 77, 8, 2, 128, 33, True, 0.0),
             ("noncausal_mqa", 2, 77, 8, 1, 128, 33, False, 0.0),
             ("noncausal_nogroup", 2, 100, 4, 4, 64, 16, False, 0.0),
             ("window_ge_s", 1, 50, 4, 1, 64, 64, False, 0.0),
             ("g2_prefill_4608_cap", 1, 4608, 8, 4, 256, 4096, True, 50.0),
             ("g2_prefill_1024_cap", 1, 1024, 8, 4, 256, 4096, True, 50.0),
             ("ragged_gqa_cap", 2, 77, 8, 2, 128, 33, True, 50.0),
             ("noncausal_mqa_cap", 2, 77, 8, 1, 64, 33, False, 50.0)]

    def inputs(B, S, Hq, Hkv, D, cap, dtype):
        qs, vs = (LOCAL_CAP_Q_SCALE, LOCAL_CAP_V_SCALE) if cap else (1.0, 1.0)
        return dict(q=rn(g, dev, B, S, Hq, D, s=qs).to(dtype),
                    k=rn(g, dev, B, S, Hkv, D).to(dtype),
                    v=rn(g, dev, B, S, Hkv, D, s=vs).to(dtype))
    err = {"float32": 0.0, "bfloat16": 0.0}
    for dtype, atol in ((torch.float32, ATOL_KERNEL),
                        (torch.bfloat16, ATOL_BF16)):
        tag = str(dtype).split(".")[-1]
        for name, B, S, Hq, Hkv, D, window, causal, cap in cases:
            a = inputs(B, S, Hq, Hkv, D, cap, dtype)
            kw = dict(window=window, causal=causal, softcap=cap)
            out = local_attention_fused(**a, **kw)
            torch.cuda.synchronize()
            ref = local_attention_ref(**a, **kw)
            err[tag] = max(err[tag], check_kernel_case(
                "local_attn", f"{name} {tag} S={S} Hq={Hq} Hkv={Hkv} D={D} "
                f"window={window} causal={causal} softcap={cap}", out, ref,
                atol))
            if cap:
                moved = max_err(ref.float(), local_attention_ref(
                    **a, window=window, causal=causal).float())
                print(f"    the softcap moves the plain output by {moved:.3e}")
    shapes = []
    timed = [c for c in cases if c[0].startswith(("rg_", "g2_"))]
    for name, B, S, Hq, Hkv, D, window, causal, cap in timed:
        for dtype in (torch.bfloat16, torch.float32):
            a = inputs(B, S, Hq, Hkv, D, cap, dtype)
            kw = dict(window=window, causal=causal, softcap=cap)
            call = lambda: local_attention_fused(**a, **kw)
            ms = time_ms(call, iters=20, warmup=3)
            plain_ms = time_ms(lambda: local_attention_ref(**a, **kw),
                               iters=5, warmup=1)
            host = host_us(call, calls=20, repeats=3)
            dev_us = launch_device_us(call, "local_attn", n=10)
            b_ms, b_by = bound_ms(*local_work(B, S, Hq, Hkv, D, window,
                                              causal, a["q"].element_size()),
                                  BF16_OPS_PER_S if dtype == torch.bfloat16
                                  else FP32_OPS_PER_S)
            tag = str(dtype).split(".")[-1]
            row = {"shape": name, "dtype": tag, "S": S, "Hq": Hq, "Hkv": Hkv,
                   "softcap": cap, "ms": ms, "plain_ms": plain_ms,
                   "host_us": host, "device_us": dev_us, "bound_ms": b_ms,
                   "bound_by": b_by, "library_ms": None}
            lib_note = "flex_attention timed in bf16 only"
            if cap:
                # the same shape without the cap, in turns with it
                off = dict(kw, softcap=0.0)
                row["ms"], row["no_softcap_ms"] = time_in_turns(
                    [call, lambda: local_attention_fused(**a, **off)],
                    rounds=3, iters=20)
                ms = row["ms"]
            if not cap or dtype == torch.bfloat16:
                q, k, v = (t.transpose(1, 2).contiguous()
                           for t in (a["q"], a["k"], a["v"]))
                if cap:
                    lib = flex_softcap(q, k, v, cap, band_mod(window, causal))
                    what = "flex_attention"
                else:
                    mask = band_mask(S, window, causal, dev)
                    lib = lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, enable_gqa=True)
                    what = "sdpa"
                row["library_ms"] = time_ms(lib, iters=20, warmup=3)
                row["library_vs_kernel_err"] = max_err(
                    lib().transpose(1, 2).float(), call().float())
                lib_note = (f"{what} {row['library_ms'] * 1e3:.2f} us (agrees "
                            f"to {row['library_vs_kernel_err']:.1e})")
            shapes.append(row)
            extra = (f", without the cap {row['no_softcap_ms'] * 1e3:.2f} us"
                     if cap else "")
            print(f"  local_attn {name} {tag}: kernel {ms * 1e3:.2f} us{extra}, "
                  f"plain {plain_ms * 1e3:.2f} us, {lib_note}, bound "
                  f"{b_ms * 1e3:.3f} us ({b_by}); host {host:.2f} us a call, "
                  f"device {'not measured' if dev_us is None else f'{dev_us:.2f} us'}"
                  " a launch")
    head = next(r for r in shapes if r["shape"] == "g2_prefill_4608_cap"
                and r["dtype"] == "bfloat16")
    return {"name": "local_attn", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/local_attn.cu",
            "replaces": "src/repro/kernels/local_attn/kernel.py:26",
            "max_abs_err": max(err.values()), "max_abs_err_by_dtype": err,
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": "bf16 gemma2-2b prefill layer: B=1 S=4608 Hq=8 Hkv=4 "
                     "D=256 window=4096 causal softcap=50",
            "library": "flex_attention (torch.compile, enable_gqa) with the "
                       "softcap as its score_mod and the band as its block "
                       "mask; SDPA with a boolean band mask at the shapes "
                       "without a softcap, in by_shape",
            "by_shape": shapes}


# ---------------------------------------------------------------------------
# Phase 2, training shapes: the library calls beside the kernels
# ---------------------------------------------------------------------------
def library_at_training_shapes(dev, kernels: list) -> None:
    """The library call's time at the training shapes, timed in turns with
    the kernel, into each kernel's ``training_library`` entry: the LSTM
    step at R x B = 23 x 32 rows (``torch.lstm_cell``, one weight set; the
    kernel at R=23, B=32, both layers' D); the conv1d at mamba2-130m's
    (B=8, S=1,024, C=1,792, SiLU) and recurrentgemma-2b's (B=2, S=2,560,
    C=2,560) layers in bf16 (``F.conv1d(groups=C)`` on the left-padded
    input, SiLU timed apart); local attention at recurrentgemma-2b's B=2,
    S=2,560 (10 query heads on 1, D=256, window 2,048) in bf16 (SDPA with a
    boolean band mask, ``enable_gqa``). Inputs from a generator of their
    own, so phase 2's shared draws stay as they were."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.conv1d.ops import causal_conv1d
    from repro_torch.kernels.local_attn.ops import local_attention_fused
    from repro_torch.kernels.lstm_cell.ops import lstm_cell_fused
    g = torch.Generator().manual_seed(4321)
    by = {k["name"]: k for k in kernels}
    rows = []
    for D in (128, 64):
        H, R, B = 64, WATERSHEDS, TRAIN_BATCH
        a = lstm_inputs(g, dev, R, B, D, H)
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
        check(e <= ATOL_KERNEL, f"torch.lstm_cell at {R * B} rows: {e}")
        kernel_t, lib_t = time_in_turns([
            lambda: lstm_cell_fused(**a),
            lambda: torch.lstm_cell(x1, (h1, c1), w_ih, w_hh, b_ih, b_hh)])
        rows.append({"D": D, "ms": kernel_t, "library_ms": lib_t,
                     "library_vs_kernel_err": e})
        print(f"  lstm_cell training R=23 B=32 D={D}: kernel "
              f"{kernel_t * 1e3:.2f} us, torch.lstm_cell at {R * B} rows "
              f"{lib_t * 1e3:.2f} us (agrees to {e:.1e})")
    by["lstm_cell"]["training_library"] = {
        "library": "torch.lstm_cell at R*B = 736 rows, one weight set",
        "ms": sum(r["ms"] for r in rows) / 2,
        "library_ms": sum(r["library_ms"] for r in rows) / 2, "by_layer": rows}
    rows = []
    for name, B, S, C, act in (("mamba2-130m", 8, 1024, 1792, "silu"),
                               ("recurrentgemma-2b", 2, 2560, 2560, "none")):
        a = conv_args(g, dev, torch.bfloat16, B, S, C, 4, False)
        xp = torch.cat([torch.zeros_like(a["x"][:, :3]), a["x"]],
                       1).transpose(1, 2).contiguous()
        wl = a["w"].t().contiguous()[:, None, :]
        lib = lambda: F.conv1d(xp, wl, a["b"], groups=C)  # noqa: E731
        ms, lib_ms, lib_silu_ms = time_in_turns(
            [lambda: causal_conv1d(**a, activation=act), lib,
             lambda: F.silu(lib())])
        e = max_err(lib().transpose(1, 2).float(),
                    causal_conv1d(**a, activation="none")[0].float())
        check(e <= ATOL_BF16, f"F.conv1d disagrees at {name}'s shape: {e}")
        silu_ms = lib_silu_ms - lib_ms if act == "silu" else 0.0
        rows.append({"arch": name, "B": B, "S": S, "C": C, "activation": act,
                     "ms": ms, "library_ms": lib_ms,
                     "library_silu_ms": silu_ms, "library_vs_kernel_err": e})
        print(f"  conv1d training {name} bf16 B={B} S={S} C={C} {act}: "
              f"kernel {ms * 1e3:.2f} us, F.conv1d {lib_ms * 1e3:.2f} us "
              f"(+ SiLU {silu_ms * 1e3:.2f} us; agrees to {e:.1e})")
    by["conv1d"]["training_library"] = {
        "library": "F.conv1d(groups=C) on the left-padded input, SiLU "
                   "timed apart", "by_shape": rows}
    B, S, Hq, Hkv, D, window = 2, 2560, 10, 1, 256, 2048
    q, k, v = (rn(g, dev, B, S, H, D).to(torch.bfloat16)
               for H in (Hq, Hkv, Hkv))
    kw = dict(window=window, causal=True, softcap=0.0)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = band_mask(S, window, True, dev)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=True)
    ms, lib_ms = time_in_turns(
        [lambda: local_attention_fused(q, k, v, **kw), lib], rounds=3,
        iters=20)
    e = max_err(lib().transpose(1, 2).float(),
                local_attention_fused(q, k, v, **kw).float())
    check(e <= ATOL_BF16, f"SDPA disagrees at recurrentgemma's shape: {e}")
    print(f"  local_attn training recurrentgemma-2b bf16 B=2 S=2560: kernel "
          f"{ms * 1e3:.2f} us, SDPA (band mask) {lib_ms * 1e3:.2f} us "
          f"(agrees to {e:.1e})")
    by["local_attn"]["training_library"] = {
        "library": "SDPA with a boolean band mask, enable_gqa",
        "shape": "bf16 recurrentgemma-2b B=2 S=2560 Hq=10 Hkv=1 D=256 "
                 "window=2048", "ms": ms, "library_ms": lib_ms,
        "library_vs_kernel_err": e}


# ---------------------------------------------------------------------------
# Phase 2, training: the conv1d, SSD-chunk and local-attention Functions
# ---------------------------------------------------------------------------
def function_errs(fn, plain, inputs: dict, kw: dict, n_diff: int,
                  fwd_err) -> tuple[float, float]:
    """(forward error, gradient error) of a kernel's autograd Function
    against its plain version on ``inputs``. The forward error is
    ``fwd_err(outputs, plain outputs)``, which checks them. The gradient
    error is the largest difference, over the inputs, between the
    gradients of a random linear function of the first ``n_diff`` outputs
    through the Function and through the plain version, each over that
    gradient's largest |value|. The backward recomputes the plain version,
    so that error checks the Function's wiring (every input gets its own
    gradient) and not the kernel. The Function's forward must launch the
    kernel once and its backward none."""
    import torch
    grads, outputs = [], []
    for f in (fn, plain):
        leaves = {k: v.clone().requires_grad_() for k, v in inputs.items()}
        before = fn.launches
        outs = f(**leaves, **kw)
        outs = outs if isinstance(outs, tuple) else (outs,)
        g = torch.Generator().manual_seed(5)
        loss = sum((o.float() * torch.randn(o.shape, generator=g).to(o.device)
                    ).sum() for o in outs[:n_diff])
        fwd = fn.launches - before
        loss.backward()
        check(fwd == (1 if f is fn else 0) and fn.launches - before == fwd,
              f"{fn.__name__}: {fwd} forward launches, "
              f"{fn.launches - before - fwd} in the backward")
        grads.append({k: v.grad.float() for k, v in leaves.items()})
        outputs.append([o.detach() for o in outs])
    worst = 0.0
    for k, want in grads[1].items():
        scale = float(want.abs().max())
        check(scale > 0 and bool(torch.isfinite(grads[0][k]).all()),
              f"{fn.__name__}: no gradient to {k}")
        worst = max(worst, max_err(grads[0][k], want) / scale)
    return fwd_err(*outputs), worst


def check_training_functions(g, dev, kernels: list) -> None:
    """Each new autograd Function (conv1d, SSD chunk, local attention)
    held against its plain version at the LM training shapes
    (recurrentgemma-2b B=2 S=2,560; mamba2-130m B=8 S=1,024) and, for
    local attention, at gemma2-2b's softcap shape, in both dtypes: the
    forward's outputs at the tolerances of ``check_conv1d``,
    ``check_ssd_chunk`` and ``check_local_attn`` (1e-5 in float32; 2e-2,
    or one bf16 ulp for the SSD chunk's y, in bf16; conv1d's new tail to
    the bit, the SSD chunk's float32 states within 1e-5), and the
    gradients through the Function against autograd through the plain
    version, a check of its wiring (``function_errs``). Then the bf16
    forward launch timed at those shapes, with its device time, the plain
    version's time and the bound, into each kernel's ``training``
    entry."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.conv1d.ops import causal_conv1d
    from repro_torch.kernels.conv1d.ref import causal_conv1d_ref
    from repro_torch.kernels.local_attn.ops import local_attention_fused
    from repro_torch.kernels.local_attn.ref import local_attention_ref
    from repro_torch.kernels.ssd_chunk.ops import ssd_chunk_fused
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref

    def conv(dtype, B, S, C, act):
        return (dict(x=rn(g, dev, B, S, C).to(dtype),
                     w=rn(g, dev, 4, C, s=0.5).to(dtype),
                     b=rn(g, dev, C, s=0.1).to(dtype)), {"activation": act})

    def ssd(dtype, B, nc, Q, H, N, P):
        return ssd_inputs(g, dev, dtype, B, nc, Q, H, N, P), {}

    def local(dtype, B, S, Hq, Hkv, D, window, cap):
        qs, vs = (LOCAL_CAP_Q_SCALE, LOCAL_CAP_V_SCALE) if cap else (1.0, 1.0)
        return (dict(q=rn(g, dev, B, S, Hq, D, s=qs).to(dtype),
                     k=rn(g, dev, B, S, Hkv, D).to(dtype),
                     v=rn(g, dev, B, S, Hkv, D, s=vs).to(dtype)),
                dict(window=window, softcap=cap))
    # name, (wrapper, plain, differentiable outputs, kernel symbol), make,
    # shape, work(shape, esize) -> (bytes, operations)
    cases = [
        ("conv1d", "rg_train B=2 S=2560 C=2560", conv, (2, 2560, 2560, "none"),
         lambda B, S, C, act, e: conv1d_work(B, S, C, 4, e, act == "silu")),
        ("conv1d", "mamba2_train B=8 S=1024 C=1792 SiLU", conv,
         (8, 1024, 1792, "silu"),
         lambda B, S, C, act, e: conv1d_work(B, S, C, 4, e, act == "silu")),
        ("ssd_chunk", "mamba2_train B=8 nc=4 Q=256 H=24 N=128 P=64", ssd,
         (8, 4, 256, 24, 128, 64),
         lambda B, nc, Q, H, N, P, e: ssd_work(B, nc, Q, H, N, P, e)),
        ("local_attn", "rg_train B=2 S=2560 Hq=10 Hkv=1 D=256 window=2048",
         local, (2, 2560, 10, 1, 256, 2048, 0.0),
         lambda B, S, Hq, Hkv, D, w, cap, e: local_work(B, S, Hq, Hkv, D, w,
                                                         True, e)),
        ("local_attn", "g2_softcap B=1 S=4608 Hq=8 Hkv=4 D=256 window=4096 "
         "softcap=50", local, (1, 4608, 8, 4, 256, 4096, 50.0),
         lambda B, S, Hq, Hkv, D, w, cap, e: local_work(B, S, Hq, Hkv, D, w,
                                                         True, e))]
    fns = {"conv1d": (causal_conv1d, causal_conv1d_ref, 1, "conv1d_kernel"),
           "ssd_chunk": (ssd_chunk_fused, ssd_chunk_ref, 2,
                         "ssd_chunk_mma_kernel"),
           "local_attn": (local_attention_fused, local_attention_ref, 1,
                          "local_attn_mma_kernel")}

    def fwd_err(name, what, dtype):
        f32 = dtype == torch.float32

        def err(outs, refs):
            if name == "ssd_chunk":
                check_kernel_case(name, what + " states", outs[1], refs[1],
                                  ATOL_KERNEL)
                if not f32:
                    return check_bf16_ulp(f"{name} {what} y", outs[0],
                                          refs[0])["max_abs_err"]
            if name == "conv1d":
                check_kernel_case(name, what + " new tail", outs[1], refs[1],
                                  0.0)
            return check_kernel_case(name, what, outs[0], refs[0],
                                     ATOL_KERNEL if f32 else ATOL_BF16)
        return err
    by_name = {k["name"]: k for k in kernels}
    for name, what, make, shape, work in cases:
        fn, plain, n_diff, symbol = fns[name]
        errs, fwd = {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).split(".")[-1]
            a, kw = make(dtype, *shape)
            fwd[tag], errs[tag] = function_errs(
                fn, plain, a, kw, n_diff,
                fwd_err(name, f"{what} {tag} Function forward", dtype))
        print(f"  {name} {what}: gradients through the Function vs plain "
              f"(wiring), worst input {max(errs.values()):.3e} of its scale "
              f"{errs}")
        check(max(errs.values()) <= GRAD_REL, f"{name} {what}: gradient "
              f"differs by {errs} of its scale > {GRAD_REL}")
        a, kw = make(torch.bfloat16, *shape)
        call = lambda: fn(**a, **kw)  # noqa: E731
        ms = time_ms(call, iters=20, warmup=3)
        dev_us = launch_device_us(call, symbol, n=10)
        plain_ms = time_ms(lambda: plain(**a, **kw), iters=5, warmup=1)
        b_ms, b_by = bound_ms(*work(*shape, 2), BF16_OPS_PER_S
                              if name != "conv1d" else FP32_OPS_PER_S)
        print(f"    bf16 forward launch {ms * 1e3:.2f} us (device "
              f"{'not measured' if dev_us is None else f'{dev_us:.2f} us'}), "
              f"plain {plain_ms * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us "
              f"({b_by})")
        by_name[name].setdefault("training", {"by_shape": []})["by_shape"].append(
            {"shape": what, "dtype": "bfloat16", "ms": ms, "device_us": dev_us,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "forward_max_abs_err": fwd, "grad_rel_err": errs})


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


def request_len(r) -> int:
    """Positions a request takes in its slot: its image's patches, its
    prompt and its new tokens (the scheduler's ``_total_len``)."""
    patches = r.extras["patches"].shape[0] if "patches" in r.extras else 0
    return patches + len(r.prompt) + r.max_new


def request_inputs(r) -> dict:
    """A request's whole-prompt insert inputs: tokens, and its extras
    (a VLM's patches), each with a leading batch axis of 1."""
    import numpy as np
    return {"tokens": r.prompt[None],
            **{k: np.asarray(v)[None] for k, v in r.extras.items()}}


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


def time_hooks(eng, times: dict) -> None:
    """Time each call of the engine's swap and host-tier hooks (host
    clock, the card synchronised before and after) into ``times``."""
    import torch
    for name in ("swap_out", "swap_in", "spill_page", "restore_pages"):
        def timed(*a, _fn=getattr(eng, name), _name=name, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            times.setdefault(_name, []).append(time.perf_counter() - t)
            return out
        setattr(eng, name, timed)


def serve_once(cfg, dev, params, dtype, mode: dict, reqs: list, ops=None,
               profile_reqs: list | None = None) -> dict:
    """One served run of ``reqs`` through the port's Scheduler on 4 slots
    with the launch counts set to 0 just before and read just after.
    ``mode`` holds the engine's and scheduler's options: ``mesh`` (the
    engine's and a model drafter's), ``paged`` (False: the contiguous
    cache), ``slots``, ``prefill_chunk``,
    ``spec_k`` (with the n-gram drafter, or ``drafter="model"``: the
    served model drafting for itself on its own engine, catching up in
    chunks of ``prefill_chunk`` tokens), ``num_pages``,
    ``prefix_cache``, ``preempt``, ``host_cache_bytes``; ``time_hooks``
    times each swap and host-tier call; ``adopt`` (a training engine and
    its state): the engine and its state by
    ``InferenceEngine.from_train_state`` on the training engine's device
    or mesh, ``params`` unused. Returns the streams, their
    digest, the stats, tok/s, decode tok/s, TTFT p50/p99 and the
    launches; with ``profile_reqs``, also the device time by kernel of a
    profiled run of that queue on the same engine."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.obs import Tracer, derive_request_metrics, percentiles
    from repro_torch.serve import (
        InferenceEngine, ModelDrafter, NgramDrafter, Scheduler, stream_digest,
    )
    max_len = max(request_len(r) for r in reqs)
    spec_k, slots = mode.get("spec_k", 0), mode.get("slots", LM_SLOTS)
    mesh = mode.get("mesh")
    kw = dict(slots=slots, max_len=max_len, paged=mode.get("paged", True),
              page_size=16, dtype=dtype,
              prefill_chunk=mode.get("prefill_chunk", 0),
              num_pages=mode.get("num_pages"), ops=ops or tfm.KERNELS)
    adopted = None
    if mode.get("adopt"):
        eng, adopted = InferenceEngine.from_train_state(*mode["adopt"], **kw)
        mesh = eng.mesh
    else:
        eng = InferenceEngine(cfg, mesh=mesh, device=dev, **kw)

    def drafter():
        if not spec_k:
            return None
        if mode.get("drafter") == "model":
            return ModelDrafter(cfg, params=params, mesh=mesh, slots=slots,
                                max_len=max_len + spec_k, page_size=16,
                                catch_up_chunk=mode.get("prefill_chunk")
                                or 16, dtype=dtype, device=dev)
        return NgramDrafter()

    def sched_of(tracer=None):
        nonlocal adopted
        state, adopted = adopted or eng.init_state(params), None
        return Scheduler(eng, state, tracer=tracer,
                         spec_k=spec_k, drafter=drafter(),
                         prefix_cache=mode.get("prefix_cache", False),
                         preempt=mode.get("preempt", False),
                         host_cache_bytes=mode.get("host_cache_bytes", 0))
    hook_s: dict = {}
    if mode.get("time_hooks"):
        time_hooks(eng, hook_s)
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
           "stream_digest": stream_digest(gen),
           "tok_per_s": sum(len(g) for g in gen.values()) / wall,
           "decode_tok_per_s": st["decode_tokens"] / max(st["decode_s"], 1e-9),
           "prefill_tok_per_s": st["prefill_tokens"] / max(st["prefill_s"], 1e-9),
           "ttft_p50_s": percentiles(ttft)["p50"],
           "ttft_p99_s": percentiles(ttft)["p99"],
           "accepted_tok_per_step": st["decode_tokens"]
           / max(st["decode_slot_steps"], 1),
           "launches": launches}
    if hook_s:
        out["hook_ms"] = {k: 1e3 * sum(v) / len(v) for k, v in hook_s.items()}
        out["hook_calls"] = {k: len(v) for k, v in hook_s.items()}
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


def decode_logits_check(cfg, dev, params, dtype, reqs, cpu_control=False,
                        pin_routes=False, keep_logits=False) -> dict:
    """Admit the first LM_SLOTS requests of ``reqs`` by whole-prompt
    prefill, then run one decode_step_paged through the kernels and one
    through the plain versions on copies of the same state. Returns the
    logits' largest difference over their largest magnitude, whether each
    slot's argmax agrees, and each slot's gap between its two largest
    logits, over the real vocab (the padded columns read -1e30). With
    ``cpu_control``, the plain versions also run on the CPU
    from the same state: the difference two correct float32 runs show at
    this width. With ``pin_routes`` (a MoE model), the routing flips
    between the two steps are counted, and the plain step runs once more
    on the kernel step's routing (``Routes(replay=...)``): its logits'
    difference from the kernel's (``pinned_rel_err``) is the kernel's
    rounding alone, without an expert chosen otherwise at a near-tie. A
    request's patches go in with its prompt. With ``keep_logits``,
    ``logits`` holds the kernel step's (slots, vocab) float32 logits on
    the host."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import InferenceEngine
    reqs = reqs[:LM_SLOTS]
    eng = InferenceEngine(cfg, slots=LM_SLOTS,
                          max_len=max(request_len(r) for r in reqs),
                          page_size=16, dtype=dtype, device=dev)
    state = eng.init_state(params)
    for s, r in enumerate(reqs):
        pages = list(range(s * eng.pages_per_slot, (s + 1) * eng.pages_per_slot))
        state = eng.assign_pages(state, s, pages)
        state, _ = eng.insert(state, request_inputs(r), s)

    def step(p, cache, ops, d):
        act = torch.ones(LM_SLOTS, dtype=torch.bool, device=d)
        with torch.inference_mode():
            lg, _ = tfm.decode_step_paged(
                p, cfg, {"tokens": state.last_tok[:, None].to(d)},
                [type(c)(*(t.to(d, copy=True) for t in c)) for c in cache],
                state.positions.to(d), state.page_table.to(d), act,
                dtype=dtype, ops=ops)
        return lg[:, :cfg.vocab_size].float().cpu()   # not the -1e30 padding
    with Routes() as kernel_routes:
        kern = step(state.params, state.cache, tfm.KERNELS, dev)
    with Routes() as plain_routes:
        plain = step(state.params, state.cache, tfm.PLAIN, dev)
    scale = float(plain.abs().max())
    top2 = plain.topk(2, dim=-1).values
    out = {"rel_err": max_err(kern, plain) / scale,
           "argmax_equal": (kern.argmax(-1) == plain.argmax(-1)).tolist(),
           "top2_gap": (top2[:, 0] - top2[:, 1]).tolist(), "scale": scale}
    if keep_logits:
        out["logits"] = kern
    if pin_routes:
        out["routing_flips"] = routing_flips(
            kernel_routes.calls, plain_routes.calls,
            cfg.num_layers - cfg.first_k_dense)
        with Routes(replay=kernel_routes.calls):
            pinned = step(state.params, state.cache, tfm.PLAIN, dev)
        out["pinned_rel_err"] = max_err(kern, pinned) / float(
            pinned.abs().max())
        out["pinned_argmax_equal"] = (kern.argmax(-1)
                                      == pinned.argmax(-1)).tolist()
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


def half_depth(cfg, params, layers: int):
    """``cfg`` and ``params`` cut to their first ``layers`` layers (a
    uniform stack: the cut keeps the width and every layer's kind)."""
    return (cfg.replace(num_layers=layers),
            dict(params, layers=params["layers"][:layers]))


def _scaled(t, factor, in_place: bool):
    return t.mul_(factor) if in_place else t * factor


def well_conditioned(cfg, params, in_place: bool = False):
    """The params with wq, wk, wv scaled to std 1/sqrt(d_model) and wo to
    1/sqrt(Hq*D) in every attention layer: unit-variance projections. The
    reference's law (std 1/sqrt(shape[-2])) gives wq std 1/sqrt(Hq) and
    attention scores with a spread in the hundreds. Layers without
    attention are left as they are. ``in_place`` scales the leaves of
    ``params`` itself (a model that fills the card has no room for a
    second copy) and returns it."""
    d, hq, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    out = dict(params, layers=[])
    for lp in params["layers"]:
        if "attn" in lp:
            factors = {"wq": (hq / d) ** 0.5, "wk": (hkv / d) ** 0.5,
                       "wv": (hkv / d) ** 0.5, "wo": hq ** -0.5}
            a = dict(lp["attn"], **{k: _scaled(lp["attn"][k], f, in_place)
                                    for k, f in factors.items()})
            lp = dict(lp, attn=a)
        out["layers"].append(lp)
    return params if in_place else out


def damped(cfg, params, in_place: bool = False):
    """The params rescaled as ``well_conditioned`` does, then with every
    layer's output projection (``wo``, ``w_down``, ``w_out``; a MoE
    layer's experts and shared experts alike) scaled by DAMP, and so the
    scale of each sandwich norm after them (gemma2's
    ``post_norm1/post_norm2``, which would otherwise normalise the damping
    away): the residual stream then carries the token's embedding almost
    alone. With tied embeddings the greedy model then repeats its last
    token; an untied model (qwen3-moe, deepseek-moe) gets its embedding
    table, transposed, as its unembedding, so that it repeats too. The
    n-gram drafter's drafts are then accepted, so a verify step keeps
    some and rolls the rest back. The speculative mode runs on these.
    ``in_place`` scales and copies into ``params`` itself and returns it
    (qwen3-moe's expert ``w_down`` alone are 19.3 GB in bf16)."""
    def walk(t, damp=False):
        return {k: _scaled(v, DAMP, in_place) if damp or k in DAMPED else
                walk(v, k in DAMPED_NORMS) if isinstance(v, dict) else v
                for k, v in t.items()}
    well = well_conditioned(cfg, params, in_place)
    out = dict(well, layers=[walk(lp) for lp in well["layers"]])
    if "unembed" in params["embed"]:
        table = params["embed"]["embedding"].t()
        out["embed"] = dict(params["embed"], unembed=params["embed"][
            "unembed"].copy_(table) if in_place else table.contiguous())
    return params if in_place else out


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
    # one wave of the queue (its first 4 requests, 32 new tokens): the
    # profiled repeat and the bf16 streams against plain serve it
    wave = lambda: requests_of(cfg.vocab_size, STEP_LENS, 32)
    modes = {"whole": {}, "chunked": {"prefill_chunk": LM_CHUNK},
             "spec": {"spec_k": LM_SPEC_K}}
    serve_once(cfg, dev, pbf, torch.bfloat16, {"prefill_chunk": LM_CHUNK},
               requests_of(cfg.vocab_size, LM_LENS[:2], 4))      # warm-up
    runs = {}
    for name, mode in modes.items():
        # the profiled repeat only for whole prefill, on one wave: the
        # profiler's post-processing of the whole queue's launches took
        # most of this phase's time
        r = serve_once(cfg, dev, damped(cfg, pbf) if name == "spec" else pbf,
                       torch.bfloat16, mode, reqs(),
                       profile_reqs=wave() if name == "whole" else None)
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
                          wave(), ops=tfm.PLAIN)
    check(not any(bf_plain["launches"].values()), "the plain run launched")
    # the wave is the queue's first 4 requests, served in the same batch
    # for its 32 steps: held against the kernel run's first 32 tokens
    share = same_tokens(bf_plain["gen"], runs["whole"]["gen"])
    print(f"  bf16 whole-prefill streams (one wave), kernel vs plain: "
          f"{share:.3f} equal")
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
    # the per-launch and stream checks at LM_F32_DEPTH of the 28 layers
    # (width, queue and modes whole), to pay for phases 15 and 16
    cfg, p32 = half_depth(cfg, p32, LM_F32_DEPTH)
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
        print(f"  {name} fp32 ({cfg.num_layers} layers), every launch held "
              f"against the plain version: {checked.calls} launches, max "
              f"error {checked.max_rel:.3e} of the output's largest |value| "
              f"(tolerance {REL_F32})")
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
        print(f"  {name} fp32 ({cfg.num_layers} layers), "
              f"{'damped' if name == 'spec' else 'rescaled'} "
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


# What each served mode of a model must launch (> 0) and must not (== 0):
# the Dom-ST kernels never; ssd_chunk only in a mamba2 whole-prompt
# prefill, local_attn only in a recurrentgemma or gemma2 one — which the
# spec mode runs too, since it admits each prompt whole — and neither with
# 128-token chunks; paged_attn never in mamba2 (no attention layer). A
# whole-prompt prefill launches local_attn once a local layer a request
# (``local_launches``).
_DOMST = {"pixcon", "lstm_cell"}
SERVED_LAUNCHES = {
    "recurrentgemma-2b": {
        "whole": ({"local_attn", "conv1d", "paged_attn"},
                  {"ssd_chunk"} | _DOMST),
        "chunked": ({"conv1d", "paged_attn"},
                    {"local_attn", "ssd_chunk"} | _DOMST),
        "spec": ({"local_attn", "conv1d", "paged_attn"},
                 {"ssd_chunk"} | _DOMST)},
    "mamba2-130m": {
        "whole": ({"ssd_chunk", "conv1d"},
                  {"paged_attn", "local_attn"} | _DOMST),
        "chunked": ({"conv1d"},
                    {"paged_attn", "local_attn", "ssd_chunk"} | _DOMST),
        "spec": ({"ssd_chunk", "conv1d"},
                 {"paged_attn", "local_attn"} | _DOMST)},
    "gemma2-2b": {
        "whole": ({"local_attn", "paged_attn"},
                  {"conv1d", "ssd_chunk"} | _DOMST),
        "chunked": ({"paged_attn"},
                    {"local_attn", "conv1d", "ssd_chunk"} | _DOMST),
        "spec": ({"local_attn", "paged_attn"},
                 {"conv1d", "ssd_chunk"} | _DOMST)},
}


def local_launches(cfg, name: str, reqs: list) -> int:
    """local_attn launches a served run must make: one a local layer a
    request where prompts are admitted whole, none with chunks."""
    from repro_torch.configs import ATTN_LOCAL
    if name == "chunked":
        return 0
    return sum(k == ATTN_LOCAL for k in cfg.layer_kinds()) * len(reqs)


def init_params(cfg, dev, dtype=None):
    """The port's init of ``cfg`` on the card from LM_SEED, in float32 or
    in ``dtype`` as ``cast_params`` casts it, each leaf cast as it is drawn
    (the same bits as casting a float32 tree, which for qwen3-moe-30b-a3b
    would take 122 GB)."""
    import torch
    from repro_torch.models import transformer as tfm
    return tfm.init(cfg, torch.Generator(device=dev).manual_seed(LM_SEED),
                    dtype=dtype or torch.float32)


def served_main_path(arch: str, dev) -> dict:
    """``arch`` (recurrentgemma-2b, mamba2-130m or gemma2-2b) at full
    width, random weights from the port's init (seed 0), served through
    the port's Scheduler in bf16 in three modes, each with the launch
    counts set to 0 just before and read just after, the whole-prefill
    mode profiled once. The speculative mode runs on the damped weights,
    so that drafts are accepted and verify rolls recurrent state back.
    Then the kernels against their plain versions end to end: one bf16
    decode step's logits on the admitted state, every launch of one fp32
    served run per mode side by side with the plain versions, and the fp32
    greedy streams in every mode, kernels against plain versions. The
    bf16 weights are cast from a float32 init that is freed at once; the
    fp32 checks draw the same init again."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    spec = SERVED_RUNS[arch]
    cfg = get_config(arch)
    t0 = time.perf_counter()
    pbf = init_params(cfg, dev, torch.bfloat16)
    torch.cuda.synchronize()
    nparams = sum(t.numel() for t in _leaves(pbf))
    print(f"  {arch} params: {nparams / 1e9:.3f} B, {cfg.num_layers} layers, "
          f"d {cfg.d_model}, vocab {cfg.vocab_size}, init "
          f"{time.perf_counter() - t0:.1f} s")
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
        need, never = SERVED_LAUNCHES[arch][name]
        for k in need:
            check(r["launches"][k] > 0, f"{arch} {name}: {k} not launched")
        for k in never:
            check(r["launches"][k] == 0,
                  f"{arch} {name}: {k} launched {r['launches'][k]} times")
        local = local_launches(cfg, name, reqs)
        check(r["launches"]["local_attn"] == local,
              f"{arch} {name}: local_attn launched "
              f"{r['launches']['local_attn']} times, not {local}")
        runs[name] = r
        print_run(arch, name, r)
    if arch in MESH_ARCHS:        # phase 16 holds its mesh runs to these
        ONE_DEVICE_RUNS[arch] = {n: runs[n] for n in MESH_ARCHS[arch]}
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
    torch.cuda.empty_cache()

    # fp32: every launch of one served run per mode held against the plain
    # versions on the same inputs, on the weights of that mode's bf16 run;
    # at SERVED_F32_DEPTH of the layers (width, queues and modes whole)
    p32 = init_params(cfg, dev)
    cfg, p32 = half_depth(cfg, p32, SERVED_F32_DEPTH[arch])
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
            print(f"  {arch} {name} fp32 ({cfg.num_layers} layers), {k}: "
                  f"{c['launches']} launches held "
                  f"against the plain version, max error "
                  f"{c['max_rel_err']:.3e} of the output's largest |value| "
                  f"(tolerance {REL_F32})")
            check(c["max_rel_err"] <= REL_F32,
                  f"{arch} {name} fp32 {k}: kernel differs from plain by "
                  f"{c['max_rel_err']}")
        for k in SERVED_LAUNCHES[arch][name][0]:
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
        print(f"  {arch} {name} fp32 ({cfg.num_layers} layers), {tag}: "
              f"kernel {k['tok_per_s']:.1f} "
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


def dense_main_path(arch: str, dev) -> dict:
    """``arch`` (llama3.2-3b or olmo-1b) at full width, random weights from
    the port's init (seed 0), served in bf16 by whole-prompt prefill with
    the launch counts set to 0 just before and read just after
    (paged_attn > 0, every other kernel 0); then one bf16 decode step's
    logits, kernel against plain, on the admitted state. Under the init
    law these two models are chaotic in bf16: one decode step's logits,
    plain on the card against plain on the CPU, part by more than the
    largest logit (printed, with the kernel's), so the check within
    2^-5 runs on the weights with the attention projections rescaled to
    unit variance (``well_conditioned``), where two correct runs agree.
    Last, every launch of an fp32 whole-prefill run, on the main path's
    weights drawn again in float32, held against the plain version."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    cfg = get_config(arch)
    if arch in DENSE_DEPTH:
        cfg = cfg.replace(num_layers=DENSE_DEPTH[arch])
    t0 = time.perf_counter()
    pbf = init_params(cfg, dev, torch.bfloat16)
    torch.cuda.synchronize()
    nparams = sum(t.numel() for t in _leaves(pbf))
    print(f"  {arch} params: {nparams / 1e9:.3f} B, {cfg.num_layers} layers, "
          f"d {cfg.d_model}, {cfg.num_heads} heads on {cfg.num_kv_heads}, "
          f"vocab {cfg.vocab_size}, init {time.perf_counter() - t0:.1f} s")
    reqs = lambda: requests_of(cfg.vocab_size, DENSE_LENS, DENSE_GEN)
    serve_once(cfg, dev, pbf, torch.bfloat16, {}, reqs()[:2])   # warm-up
    r = serve_once(cfg, dev, pbf, torch.bfloat16, {}, reqs())
    check_tokens(cfg, "whole", r, reqs())
    check(r["launches"]["paged_attn"] > 0, f"{arch}: paged_attn not launched")
    check(all(v == 0 for k, v in r["launches"].items() if k != "paged_attn"),
          f"{arch}: a kernel of another path ran: {r['launches']}")
    print_run(arch, "whole", r)
    logits = {}
    for tag, p in (("main weights", pbf),
                   ("rescaled weights", well_conditioned(cfg, pbf))):
        bf = decode_logits_check(cfg, dev, p, torch.bfloat16, reqs(),
                                 cpu_control=True)
        logits[tag] = bf
        print(f"  {arch} bf16 decode_step_paged logits, {tag}: kernel vs "
              f"plain {bf['rel_err']:.3e}, plain on the card vs on the CPU "
              f"{bf['cpu_rel_err']:.3e} of the largest |logit| (tolerance "
              f"{REL_LOGITS_BF16} on the rescaled weights); argmax equal "
              f"{bf['argmax_equal']}, card/CPU {bf['cpu_argmax_equal']}")
    rel = logits["rescaled weights"]["rel_err"]
    check(rel <= REL_LOGITS_BF16, f"{arch} bf16 decode logits differ by {rel}")
    del pbf
    torch.cuda.empty_cache()

    # fp32: every launch of one whole-prefill run held against the plain
    # version on the same inputs, on the main path's weights
    p32 = init_params(cfg, dev)
    ops = checked_ops()
    serve_once(cfg, dev, p32, torch.float32, {}, reqs(), ops=ops)
    checked = {k: {"launches": c.calls, "max_rel_err": c.max_rel}
               for k, c in zip(tfm.KernelOps._fields, ops) if c.calls}
    for k, c in checked.items():
        print(f"  {arch} whole fp32, {k}: {c['launches']} launches held "
              f"against the plain version, max error {c['max_rel_err']:.3e} "
              f"of the output's largest |value| (tolerance {REL_F32})")
        check(c["max_rel_err"] <= REL_F32, f"{arch} whole fp32 {k}: kernel "
              f"differs from plain by {c['max_rel_err']}")
    check("paged_attn" in checked, f"{arch} whole fp32: paged_attn never "
          "checked")
    del p32
    torch.cuda.empty_cache()
    print("  " + json.dumps({arch: run_summary({"whole": r}),
                             "bf16_logits": logits, "fp32": checked}))
    return {"launches": {"whole": r["launches"]}, "profile": None}


# ---------------------------------------------------------------------------
# Phase 10: serving policies at full width
# ---------------------------------------------------------------------------
POLICY_KEYS = ("prefix_lookups", "prefix_hits", "prefix_hit_tokens",
               "cow_pages", "host_hits", "host_hit_tokens",
               "host_spilled_pages", "host_restored_pages",
               "host_evicted_pages", "preemptions", "restores",
               "deferred_admissions", "max_defer_cycles")
SAMPLED = {"temperature": 0.8, "top_k": 50, "top_p": 0.95, "rep_penalty": 1.1}


def family_queue(vocab: int, families: int, per_family: int, gen: int,
                 prefix: int = POL_PREFIX, sampled: bool = False) -> list:
    """Shared-prefix families (request i of family i % families): each a
    ``prefix``-token system prompt and a ragged seeded tail of
    POL_TAIL tokens, ``gen`` new tokens each; ``sampled``: SAMPLED with
    one seed a request, else greedy."""
    import numpy as np
    from repro_torch.serve import Request, SamplingParams
    rng = np.random.default_rng(LM_SEED)
    pres = [rng.integers(0, vocab, prefix) for _ in range(families)]
    out = []
    for i in range(families * per_family):
        tail = rng.integers(0, vocab, int(rng.integers(*POL_TAIL) + 1))
        sp = SamplingParams(**SAMPLED, seed=1000 + i) if sampled \
            else SamplingParams()
        out.append(Request(rid=i, max_new=gen, sampling=sp,
                           prompt=np.concatenate([pres[i % families], tail])
                           .astype(np.int32)))
    return out


def request_pages(reqs: list) -> int:
    """Pages of the largest request of ``reqs`` (claimed at admission)."""
    return max(-(-(len(r.prompt) + r.max_new) // 16) for r in reqs)


def print_policy_run(arch, name, r) -> None:
    st = r["stats"]
    hooks = r.get("hook_ms", {})
    print(f"  {arch} {name}: {r['tok_per_s']:.1f} tok/s, decode "
          f"{r['decode_tok_per_s']:.1f} tok/s, TTFT p50 {r['ttft_p50_s']:.4f}"
          f" s p99 {r['ttft_p99_s']:.4f} s, wall {r['wall_s']:.3f} s, "
          f"launches { {k: v for k, v in r['launches'].items() if v} }, "
          f"digest {r['stream_digest']}, stats "
          f"{ {k: st[k] for k in POLICY_KEYS + ('prefill_chunks', 'spec_proposed', 'spec_accepted') if st[k]} }"
          + (f", host ms a call "
             f"{ {k: round(v, 3) for k, v in hooks.items()} } over "
             f"{r['hook_calls']} calls" if hooks else ""))


def check_launches(arch, name, r, need, never) -> None:
    for k in need:
        check(r["launches"][k] > 0, f"{arch} {name}: {k} not launched")
    for k in never:
        check(r["launches"][k] == 0,
              f"{arch} {name}: {k} launched {r['launches'][k]} times")


def compare_streams(arch, what, got, want, exact: bool) -> dict:
    """Equal streams where ``exact`` (fp32), else the share of equal
    tokens and the first parting (bf16), printed."""
    same = got["gen"] == want["gen"]
    row = {"equal": same, "equal_share": same_tokens(got["gen"], want["gen"]),
           "first_parting": first_parting(got["gen"], want["gen"])}
    print(f"  {arch} {what}: streams equal {same}, share "
          f"{row['equal_share']:.3f}, first parting {row['first_parting']}")
    if exact:
        check(same, f"{arch} {what}: streams differ")
    return row


def policy_runs(cfg, dev, params, spec_params, dtype, case: dict,
                checked: bool, host_bytes: int) -> dict:
    """Serve one model's policy runs for ``case`` (a POLICY_CASES entry):
    greedy cold, off device-tier hits on an ample pool, off host-tier hits
    on the tight pool (hooks timed), defer-only and preempt on the
    preemption queue (hooks timed); where ``sampled``, the sampled family
    queue whole, chunked, with spec_k=3, preempted and off prefix hits;
    then spec_k=3 with the model drafting for itself, on ``spec_params``
    (bf16: the damped weights, on which drafts are accepted), beside the
    same queue without speculation where ``spec_params`` are not
    ``params``. Each run with its own launch counts; where ``checked``
    (fp32), the host-hit and preempt runs hold every launch against the
    plain version (``checked_ops``: the run then takes the plain
    results), its calls and largest error under ``checked``. The host
    tier holds ``host_bytes``."""
    v = cfg.vocab_size
    fams, per, gen = case["families"], case["per_family"], case["gen"]
    queues = {
        "family": lambda: family_queue(v, fams, per, gen),
        "cut": lambda: family_queue(v, 2, 2, POL_GEN_CUT),
        "sampled": lambda: family_queue(v, 2, 2, POL_GEN_CUT, sampled=True),
        "preempt": lambda: requests_of(v, case["preempt_lens"],
                                       case["preempt_gen"])}
    fam_pages = request_pages(queues["family"]())
    cut_pages = request_pages(queues["cut"]())
    chunk = {"prefill_chunk": LM_CHUNK}
    # the prefix-cache runs take no more slots than their pool holds
    # requests: a request that waits for pages rather than a slot is
    # planned again every cycle, and the copied scheduler's plan walks the
    # prompt's pages once for each length it tries, on the host
    hits = dict(chunk, prefix_cache=True,
                num_pages=case["device_pool"] * fam_pages,
                slots=min(case["device_pool"], LM_SLOTS))
    pre = dict(chunk, num_pages=case["preempt_pool"]
               * request_pages(queues["preempt"]()))
    plan = [("cold", "family", chunk)]
    if case["device_pool"]:
        plan.append(("device hits", "family", hits))
    plan += [
        ("host hits", "family", dict(
            chunk, prefix_cache=True, num_pages=case["tight"] * fam_pages,
            slots=case["tight"], host_cache_bytes=host_bytes,
            time_hooks=True, checked=checked)),
        ("defer-only", "preempt", pre),
        ("preempt", "preempt", dict(pre, preempt=True, time_hooks=True,
                                    checked=checked)),
    ]
    if case["sampled"]:     # on the cut family queue
        plan += [
            ("sampled whole", "sampled", {}),
            ("sampled chunked", "sampled", chunk),
            ("sampled spec", "sampled", dict(chunk, spec_k=LM_SPEC_K)),
            ("sampled preempt", "sampled", dict(
                chunk, num_pages=2 * cut_pages, preempt=True)),
            ("sampled prefix hits", "sampled", dict(
                chunk, prefix_cache=True, num_pages=2 * cut_pages, slots=2)),
        ]
        if spec_params is not params:
            plan.append(("cut", "cut", dict(chunk, spec=True)))
        plan.append(("model drafter", "cut", dict(
            chunk, spec_k=LM_SPEC_K, drafter="model", spec=True)))
    runs = {}
    for name, q, mode in plan:
        ops = checked_ops() if mode.get("checked") else None
        r = serve_once(cfg, dev, spec_params if mode.get("spec") else params,
                       dtype, mode, queues[q](), ops=ops)
        check_tokens(cfg, name, r, queues[q]())
        if ops:
            r["checked"] = {k: {"calls": c.calls, "max_rel_err": c.max_rel}
                            for k, c in ops._asdict().items() if c.calls}
        runs[name] = r
    return runs


def policy_checks(arch, runs: dict, full: bool, exact: bool) -> None:
    """The policy counts each run must show: the full queues' thresholds
    where ``full``, the cut queues' (hits, spills, preemptions) else.
    The checked runs' launches within REL_F32 of the plain version's
    (paged_attn checked in each, conv1d too for recurrentgemma-2b); where
    ``exact`` (fp32), the model drafter (the served model drafting for
    itself, whose chunked catch-up and verify agree in float32) proposes
    and has every draft accepted."""
    hits = 12 if full else 1
    for name in ("device hits", "host hits"):
        st = runs.get(name, {}).get("stats")
        check(st is None or (st["prefix_hits"] >= hits and
                             st["prefix_hit_tokens"] >= hits * POL_PREFIX),
              f"{arch} {name}: {st and st['prefix_hits']} hits, "
              f"{st and st['prefix_hit_tokens']} tokens")
    st = runs["host hits"]["stats"]
    least = 64 if full else 1
    check(st["host_hits"] >= 1 and st["host_spilled_pages"] >= least
          and st["host_restored_pages"] >= least,
          f"{arch} host hits: {st['host_hits']} hits, "
          f"{st['host_spilled_pages']} spilled, "
          f"{st['host_restored_pages']} restored pages")
    st, base = runs["preempt"]["stats"], runs["defer-only"]["stats"]
    check(st["preemptions"] >= 1 and st["restores"] == st["preemptions"]
          and base["deferred_admissions"] > 0,
          f"{arch} preempt: {st['preemptions']} preemptions, "
          f"{st['restores']} restores, defer-only deferred "
          f"{base['deferred_admissions']}")
    for name, r in runs.items():
        if "checked" not in r:
            continue
        c = r["checked"]
        print(f"  {arch} {name}, every launch held against the plain "
              f"version: " + ", ".join(
                  f"{k} {v['calls']} launches, max error "
                  f"{v['max_rel_err']:.3e}" for k, v in c.items())
              + f" of the output's largest |value| (tolerance {REL_F32})")
        for k in POLICY_LAUNCHES[arch][0]:
            check(k in c, f"{arch} {name}: no {k} launch was checked")
        check(all(v["max_rel_err"] <= REL_F32 for v in c.values()),
              f"{arch} {name}: a kernel differs from plain: {c}")
    drafted = runs.get("model drafter", {}).get("stats")
    if drafted and exact:
        check(drafted["spec_proposed"] > 0 and
              drafted["spec_accepted"] == drafted["spec_proposed"],
              f"{arch} model drafter: {drafted['spec_accepted']} of "
              f"{drafted['spec_proposed']} drafts accepted")
    if "sampled preempt" in runs:
        st = runs["sampled preempt"]["stats"]
        check(st["preemptions"] >= 1, f"{arch} sampled preempt: no preemption")
        st = runs["sampled prefix hits"]["stats"]
        check(st["prefix_hits"] >= 1, f"{arch} sampled prefix hits: none")


def policy_streams(arch, runs: dict, exact: bool) -> dict:
    """Streams that must agree: the hits and host hits with cold,
    preempt with defer-only, every sampled run (digest) with sampled
    whole, the model drafter's with the cut queue's on its weights."""
    out = {}
    base = "cut" if "cut" in runs else "cold"
    for a, b in (("device hits", "cold"), ("host hits", "cold"),
                 ("preempt", "defer-only"), ("model drafter", base)):
        if a in runs:
            out[f"{a} vs {b}"] = compare_streams(arch, f"{a} vs {b}",
                                                 runs[a], runs[b], exact)
    digests = {n: r["stream_digest"] for n, r in runs.items()
               if n.startswith("sampled")}
    if digests:
        print(f"  {arch} sampled digests: {digests}")
        out["sampled_digests"] = digests
        if exact:
            check(len(set(digests.values())) == 1,
                  f"{arch} sampled digests differ: {digests}")
    return out


def page_bytes(cfg) -> int:
    """Bytes of one page's blob (every layer's k, v and pos rows) in
    bf16."""
    from repro_torch.configs import ATTN_GLOBAL, ATTN_LOCAL
    attn = sum(k in (ATTN_GLOBAL, ATTN_LOCAL) for k in cfg.layer_kinds())
    return attn * 16 * (2 * cfg.num_kv_heads * cfg.resolved_head_dim() * 2 + 4)


# Phase 10's runs by model and dtype: the family queue (families x
# per_family, gen new tokens), the preemption queue, and the pools in
# requests of the family queue: ``device_pool`` for the device-tier hits
# (the full queue's: every family's cached prefix beside 4 active
# requests; a cut queue's: 2, so that a family's second request is
# admitted after its first and hits it), ``tight`` for the host tier
# (each cross-family admission then reclaims, and so spills, another
# family's cached prefix), ``preempt_pool`` for preemption (in requests
# of the preemption queue); then whether the sampled and model-drafter
# runs are served (on the cut queue, in both dtypes). fp32 serves the cut
# queues. recurrentgemma-2b takes no device-tier run (``device_pool`` 0):
# its host-tier run resumes from the recurrent snapshots as well; it is
# served in fp32 alone (a bf16 run of the same cut queues holds nothing:
# its streams part between tiers, which fp32 holds equal).
_CUT = dict(families=2, per_family=2, gen=POL_GEN_CUT, preempt_lens=STEP_LENS,
            preempt_gen=POL_GEN_CUT, device_pool=2, tight=1, preempt_pool=2)
POLICY_CASES = {
    ("qwen2-1.5b", "bf16"): dict(
        families=POL_FAMILIES, per_family=POL_PER_FAMILY, gen=POL_GEN,
        preempt_lens=LM_LENS, preempt_gen=LM_GEN,
        device_pool=POL_FAMILIES + LM_SLOTS, tight=2, preempt_pool=3,
        sampled=True),
    ("qwen2-1.5b", "fp32"): dict(_CUT, sampled=True),
    ("recurrentgemma-2b", "fp32"): dict(_CUT, device_pool=0, sampled=False),
}
# what every phase-10 run must launch (> 0) and must not (0): 128-token
# chunks admit every greedy prompt, so local_attn stays 0
POLICY_LAUNCHES = {
    "qwen2-1.5b": ({"paged_attn"},
                   {"conv1d", "ssd_chunk", "local_attn"} | _DOMST),
    "recurrentgemma-2b": ({"paged_attn", "conv1d"},
                          {"ssd_chunk", "local_attn"} | _DOMST),
}


def policy_main_path(dev) -> dict:
    """Phase 10: the serving policies at full width and half depth
    (``POL_DEPTH``; 16-token pages, 4 slots, 128-token chunks; weights
    from the port's init, seed 0), by POLICY_CASES. qwen2-1.5b in bf16
    on 4 shared-prefix families x 4 requests (a 1,024-token prefix,
    64-192-token tails, 32 new tokens): cold, off device-tier prefix hits, off host-tier hits, preemption
    against defer-only on phase 5's 8 x 512 queue, then on the cut family
    queue (2 x 2, 16 new tokens) sampled whole, chunked, with spec_k=3,
    preempted and off prefix hits, and spec_k=3 with the model drafting
    for itself. Launch counts, the stats thresholds, tok/s, TTFT by tier
    and the hooks' host time a call; bf16 streams' share of equal tokens.
    Then the same in fp32 on the rescaled weights and the cut queues, and
    recurrentgemma-2b in fp32 on the cut family queue cold and off
    host-tier hits, and preemption against defer-only on phase 6's
    512-token queue: each launch of the host-hit and preempted runs held
    against the plain version, the streams equal, the sampled digests
    one, every self-draft accepted."""
    import torch
    from repro_torch.configs import get_config
    out = {"launches": {}}
    for (arch, tag), case in POLICY_CASES.items():
        full = get_config(arch)
        cfg = full.replace(num_layers=POL_DEPTH.get(arch, full.num_layers))
        host_bytes = POL_HOST_BYTES * page_bytes(cfg) // page_bytes(full)
        first = arch not in out
        dtype = torch.bfloat16 if tag == "bf16" else torch.float32
        params = init_params(cfg, dev, dtype if tag == "bf16" else None)
        if tag == "fp32":
            params = well_conditioned(cfg, params)
        if first:   # warm-up: the model's first calls, the hooks'
            warm = requests_of(cfg.vocab_size, [300, 290, 280], 4)
            serve_once(cfg, dev, params, dtype, dict(
                prefill_chunk=LM_CHUNK, prefix_cache=True, preempt=True,
                num_pages=request_pages(warm),
                host_cache_bytes=host_bytes), warm)
        stamp(f"{arch} {tag} params ready")
        spec_params = damped(cfg, params) if tag == "bf16" else params
        exact = tag == "fp32"
        runs = policy_runs(cfg, dev, params, spec_params, dtype, case,
                           checked=exact, host_bytes=host_bytes)
        need, never = POLICY_LAUNCHES[arch]
        for name, r in runs.items():
            check_launches(arch, f"{tag} {name}", r, need, never)
            print_policy_run(arch, f"{tag} {name}", r)
        policy_checks(arch, runs, full=(arch, tag) == ("qwen2-1.5b", "bf16"),
                      exact=exact)
        streams = policy_streams(arch, runs, exact=exact)
        out.setdefault(arch, {})[tag] = {
            "runs": run_summary(runs), "streams": streams,
            "stats": {n: {k: r["stats"][k] for k in POLICY_KEYS}
                      for n, r in runs.items()}}
        if first:   # the main path's counts: the model's first dtype's
            out["launches"].update({f"{arch} {n}": r["launches"]
                                    for n, r in runs.items()
                                    if "checked" not in r})
            print(f"  {arch} ({cfg.num_layers} of {full.num_layers} "
                  f"layers) page blob: {page_bytes(cfg)} bytes a page in "
                  f"bf16, host tier {host_bytes} bytes")
        del params, spec_params
        torch.cuda.empty_cache()
        stamp(f"{arch} {tag} policy runs done")
    print("  " + json.dumps({k: v for k, v in out.items()
                             if k != "launches"}))
    return {"launches": out["launches"], "profile": None}


# ---------------------------------------------------------------------------
# Phase 11: mixture-of-experts serving at full width
# ---------------------------------------------------------------------------
# every MoE mode: paged_attn, and no other kernel (both models attend
# globally; the expert products are PyTorch's bmm, as the reference's einsum)
MOE_LAUNCHES = ({"paged_attn"}, {"conv1d", "ssd_chunk", "local_attn"} | _DOMST)


class Routes:
    """Inside ``with``: every routing of ``models.moe.route`` (its top-k
    experts, (B, S, K), left on the card), call by call. With ``replay``
    (an earlier run's ``calls``), call i takes that run's experts of call
    i instead of its own top-k, weighted by its own probabilities there,
    renormalised as ``route`` does: the run follows the earlier routing."""

    def __init__(self, replay: list | None = None):
        self.replay = replay

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.calls, self._real = [], moe.route

        def route(router_w, x, m):
            probs, idx, w = self._real(router_w, x, m)
            if self.replay is not None:
                idx = self.replay[len(self.calls)]
                w = probs.gather(-1, idx)
                w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
            self.calls.append(idx)
            return probs, idx, w
        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self._real


def routing_flips(a: list, b: list, layers: int) -> dict:
    """Tokens whose set of experts differs between two runs' routings, call
    by call, over the calls the two runs share in shape (one schedule makes
    the same calls in the same order), and where the first fell (model
    call, MoE layer)."""
    flips, first, shared = 0, None, 0
    for i, (x, y) in enumerate(zip(a, b)):
        if x.shape != y.shape:
            break
        shared += 1
        bad = int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
        if bad and first is None:
            first = {"model_call": i // layers, "layer": i % layers}
        flips += bad
    return {"calls": shared, "flipped_tokens": flips, "first": first}


def expert_bytes(params) -> int:
    """Bytes of the routed experts' weights: what one decode step reads,
    since its dispatch runs every expert at capacity 1."""
    return sum(lp["ffn"][k].numel() * lp["ffn"][k].element_size()
               for lp in params["layers"] if "router" in lp.get("ffn", {})
               for k in ("w_gate", "w_up", "w_down"))


def moe_main_path(dev) -> dict:
    """Phase 11. qwen3-moe-30b-a3b at full width and depth, random weights
    from the port's init (seed 0) drawn leaf by leaf in bf16, served on one
    wave in three modes, each with the launch counts set to 0 just before
    and read just after (paged_attn > 0, every other kernel 0): whole
    prefill (its routings recorded), a profiled repeat of it with 8 new
    tokens, the same run through the plain versions (the bf16 streams,
    kernel against plain, their first parting and the routing flips
    between the two), 128-token chunks, and last ``spec_k=3`` on the
    weights damped in place. Then the same model at 4 of its 48 layers in
    float32: in each mode every launch held against the plain version
    (``checked_ops``, which serves the plain results) and the kernels'
    greedy streams equal to that run's, on the rescaled weights (spec on
    the damped ones). Then deepseek-moe-16b at full width and depth by
    whole prefill of the wave, and one bf16 decode step's logits, kernel
    against plain, with the routing flips between the two steps, and
    against plain on the kernel step's routing: printed on the main
    weights, the latter held within 2^-5 on the rescaled ones (a flipped
    expert at a near-tie moves a token's FFN output by a whole expert's
    share, which no rounding tolerance can hold)."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import InferenceEngine, Scheduler
    bf16 = torch.bfloat16
    modes = {"whole": {}, "chunked": {"prefill_chunk": LM_CHUNK},
             "spec": {"spec_k": LM_SPEC_K}}
    out = {}

    def free():
        # engines and schedulers hold their params in reference cycles:
        # collect them before the card's memory is reused
        gc.collect()
        torch.cuda.empty_cache()
    free()
    print(f"  allocated at the start: {torch.cuda.memory_allocated() / 1e9:.2f}"
          " GB")

    def load(arch, depth=None, dtype=bf16):
        cfg = get_config(arch)
        if depth:
            cfg = cfg.replace(num_layers=depth)
        t0 = time.perf_counter()
        params = init_params(cfg, dev, dtype)
        torch.cuda.synchronize()
        nparams = sum(t.numel() for t in _leaves(params))
        gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
        print(f"  {arch} params: {nparams / 1e9:.3f} B ({gb:.2f} GB in "
              f"{str(dtype).split('.')[-1]}), {cfg.num_layers} layers, d "
              f"{cfg.d_model}, {cfg.num_heads} heads on {cfg.num_kv_heads}, "
              f"{cfg.moe.num_experts} experts top {cfg.moe.top_k}, vocab "
              f"{cfg.vocab_size}, init {time.perf_counter() - t0:.1f} s")
        return cfg, params

    def wave(cfg, gen=MOE_GEN):
        return requests_of(cfg.vocab_size, MOE_LENS, gen)

    def served(cfg, params, name, **kw):
        r = serve_once(cfg, dev, params, bf16, modes[name], wave(cfg), **kw)
        check_tokens(cfg, name, r, wave(cfg))
        check_spec(cfg.name, name, r)
        check_launches(cfg.name, name, r, *MOE_LAUNCHES)
        print_run(cfg.name, name, r)
        return r

    # qwen3-moe-30b-a3b, bf16, 48 layers
    torch.cuda.reset_peak_memory_stats()
    cfg, pbf = load("qwen3-moe-30b-a3b")
    layers = cfg.num_layers - cfg.first_k_dense
    serve_once(cfg, dev, pbf, bf16, {"prefill_chunk": LM_CHUNK},
               requests_of(cfg.vocab_size, MOE_LENS[:2], 4))    # warm-up
    runs = {}
    with Routes() as kernel_routes:
        runs["whole"] = served(cfg, pbf, "whole")
    eng = InferenceEngine(cfg, slots=LM_SLOTS, max_len=max(MOE_LENS)
                          + MOE_PROFILE_GEN, page_size=16, dtype=bf16,
                          device=dev)
    sched = Scheduler(eng, eng.init_state(pbf))
    prof = device_breakdown(lambda: sched.run(wave(cfg, MOE_PROFILE_GEN)),
                            top=25, host=False)
    del eng, sched
    runs["whole"]["profile"] = prof
    busy = prof["device_busy_s"]
    print(f"    profiled repeat ({len(MOE_LENS)} x {MOE_PROFILE_GEN} new "
          f"tokens): wall {prof['wall_s']:.3f} s, device busy "
          f"{'not measured' if busy is None else f'{busy:.3f} s'}")
    for row in prof["by_kernel"][:12]:
        print(f"      {row['device_ms']:9.2f} ms {row['calls']:7d}x "
              f"{row['kernel']}")
    with Routes() as plain_routes:
        plain = serve_once(cfg, dev, pbf, bf16, modes["whole"], wave(cfg),
                           ops=tfm.PLAIN)
    check(not any(plain["launches"].values()), "the plain run launched")
    flips = routing_flips(kernel_routes.calls, plain_routes.calls, layers)
    del kernel_routes, plain_routes
    streams = {"equal_share": same_tokens(runs["whole"]["gen"], plain["gen"]),
               "first_parting": first_parting(runs["whole"]["gen"],
                                              plain["gen"]),
               "routing_flips": flips}
    print(f"  {cfg.name} bf16 whole-prefill streams, kernel vs plain: "
          f"{streams['equal_share']:.3f} equal, first parting by request "
          f"{streams['first_parting']}; routing flips between the two runs: "
          f"{flips['flipped_tokens']} tokens over {flips['calls']} MoE calls, "
          f"the first at {flips['first']}")
    stamp(f"{cfg.name} whole prefill, profile and plain run done")
    runs["chunked"] = served(cfg, pbf, "chunked")
    damped(cfg, pbf, in_place=True)             # the spec mode runs last
    runs["spec"] = served(cfg, pbf, "spec")
    peak = torch.cuda.max_memory_allocated()
    step = {n: r["stats"]["decode_s"] / max(r["stats"]["decode_steps"], 1)
            for n, r in runs.items()}
    floor_ms = expert_bytes(pbf) / HBM_BYTES_PER_S * 1e3
    print(f"  {cfg.name}: peak memory {peak / 1e9:.2f} GB "
          f"(max_memory_allocated); decode step (host clock, whole / "
          f"chunked / spec) {' / '.join(f'{v * 1e3:.2f}' for v in step.values())}"
          f" ms against a {floor_ms:.2f} ms device floor (the routed "
          "experts' weights once over HBM)")
    del pbf
    free()
    stamp(f"{cfg.name} bf16 served runs done")

    # the same model at 4 of 48 layers in float32: each launch against the
    # plain version, and the kernels' streams against the checked run's
    # (which serves the plain results); rescaled weights, spec damped
    f32 = {}
    for name in modes:
        cfg4, p32 = load("qwen3-moe-30b-a3b", MOE_F32_DEPTH, torch.float32)
        if name == "spec":
            damped(cfg4, p32, in_place=True)
        else:
            well_conditioned(cfg4, p32, in_place=True)
        ops = checked_ops()
        with Routes() as plain_routes:
            chk = serve_once(cfg4, dev, p32, torch.float32, modes[name],
                             wave(cfg4), ops=ops)
        with Routes() as kernel_routes:
            ker = serve_once(cfg4, dev, p32, torch.float32, modes[name],
                             wave(cfg4))
        for r in (chk, ker):
            check_spec(cfg4.name, name, r)
        check_launches(cfg4.name, f"{name} fp32", ker, *MOE_LAUNCHES)
        rows = {k: {"launches": c.calls, "max_rel_err": c.max_rel}
                for k, c in zip(tfm.KernelOps._fields, ops)}
        c = rows["paged_attn"]
        check(all(v["launches"] == 0 for k, v in rows.items()
                  if k != "paged_attn"), f"fp32 {name}: {rows}")
        f32[name] = {"checked": c, "streams_equal": ker["gen"] == chk["gen"],
                     "first_parting": first_parting(ker["gen"], chk["gen"]),
                     "routing_flips": routing_flips(
                         kernel_routes.calls, plain_routes.calls,
                         MOE_F32_DEPTH),
                     "kernel_tok_per_s": ker["tok_per_s"],
                     "plain_tok_per_s": chk["tok_per_s"]}
        print(f"  {cfg.name} ({MOE_F32_DEPTH} layers) {name} fp32: "
              f"{c['launches']} paged_attn launches held against the plain "
              f"version, max error {c['max_rel_err']:.3e} of the output's "
              f"largest |value| (tolerance {REL_F32}); greedy streams equal: "
              f"{f32[name]['streams_equal']} (first parting "
              f"{f32[name]['first_parting']}); routing flips "
              f"{f32[name]['routing_flips']['flipped_tokens']}")
        check(c["launches"] > 0 and c["max_rel_err"] <= REL_F32,
              f"fp32 {name}: kernel differs from plain by {c['max_rel_err']}")
        check(f32[name]["streams_equal"],
              f"fp32 {name}: kernel and plain streams differ")
        del p32
        free()
    stamp(f"{cfg.name} fp32 checks done")
    print("  " + json.dumps({cfg.name: run_summary(runs), "fp32": f32,
                             "bf16_streams": streams, "peak_gb": peak / 1e9,
                             "decode_step_ms": {k: v * 1e3
                                                for k, v in step.items()},
                             "decode_floor_ms": floor_ms}))
    out[cfg.name] = {"launches": {n: r["launches"] for n, r in runs.items()},
                     "profile": prof}

    # deepseek-moe-16b, bf16, 28 layers (the first dense), whole prefill
    cfg, pbf = load("deepseek-moe-16b")
    serve_once(cfg, dev, pbf, bf16, {}, requests_of(cfg.vocab_size,
                                                    MOE_LENS[:2], 4))
    r = served(cfg, pbf, "whole")
    ONE_DEVICE_RUNS[cfg.name] = {"whole": r}     # phase 16's yardstick
    logits = {}
    for tag in ("main weights", "rescaled weights"):
        if tag == "rescaled weights":
            well_conditioned(cfg, pbf, in_place=True)
        bf = decode_logits_check(cfg, dev, pbf, bf16, wave(cfg),
                                 pin_routes=True)
        logits[tag] = bf
        print(f"  {cfg.name} bf16 decode_step_paged logits, {tag}: kernel vs "
              f"plain {bf['rel_err']:.3e} of the largest |logit|, argmax "
              f"equal {bf['argmax_equal']}, with "
              f"{bf['routing_flips']['flipped_tokens']} routing flips between "
              f"the two steps (first {bf['routing_flips']['first']}); plain "
              f"on the kernel step's routing {bf['pinned_rel_err']:.3e}, "
              f"argmax equal {bf['pinned_argmax_equal']} (tolerance "
              f"{REL_LOGITS_BF16} on the rescaled weights)")
    rel = logits["rescaled weights"]["pinned_rel_err"]
    check(rel <= REL_LOGITS_BF16, f"{cfg.name} bf16 decode logits differ by "
          f"{rel} on one routing")
    del pbf
    free()
    print("  " + json.dumps({cfg.name: run_summary({"whole": r}),
                             "bf16_logits": logits}))
    out[cfg.name] = {"launches": {"whole": r["launches"]}, "profile": None}
    return out


# ---------------------------------------------------------------------------
# Phase 12: LM training
# ---------------------------------------------------------------------------
# recurrentgemma-2b past its 2,048-token window and mamba2-130m over four
# 256-token SSD chunks, at full width and depth, through the train CLI's
# ``train_lm`` (block remat, bf16 activations, float32 params and AdamW,
# the step donated). Launches a step, from a CPU rehearsal of the step at
# full depth: the forward, plus the rematted pattern repetitions again in
# the backward (recurrentgemma: 8 x (R, R, L) rematted and an (R, R)
# suffix that is not; mamba2: 24 x (S)); the backward through the plain
# versions launches none. ``check_layers``: the depth of the float32
# kernel-against-plain gradient check (one repetition of the pattern).
LM_TRAIN = {
    "recurrentgemma-2b": {"batch": 2, "seq": 2560, "steps": 5,
                          "check_layers": 3,
                          "per_step": {"conv1d": 18 + 16, "local_attn": 8 + 8}},
    "mamba2-130m": {"batch": 8, "seq": 1024, "steps": 5, "check_layers": 2,
                    "per_step": {"conv1d": 24 + 24, "ssd_chunk": 24 + 24}},
}
# the hand-off: one request served greedily from the live trained state
# and from its checkpoint
HANDOFF_PROMPT, HANDOFF_GEN = 64, 16


def lm_grad_check(arch: str, spec: dict, dev) -> dict:
    """``lm_loss`` at full width and ``spec["check_layers"]`` layers, in
    float32 with block remat, on the main path's batch shape and weights
    from the port's init: the loss and every gradient leaf through the
    kernels' Functions against autograd through ``transformer.PLAIN``;
    every leaf's gradient through the kernels finite and non-zero."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.convert import flatten, unflatten
    from repro_torch.data.tokens import synthetic_token_batch
    from repro_torch.models import transformer as tfm
    cfg = get_config(arch).replace(num_layers=spec["check_layers"])
    params = init_params(cfg, dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synthetic_token_batch(
        cfg, spec["batch"], spec["seq"], seed=SEED).items()}
    like = tfm.model_params(cfg, lambda *a: None)
    losses, grads = [], []
    for ops in (tfm.KERNELS, tfm.PLAIN):
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in flatten(params).items()}
        loss, _ = tfm.lm_loss(unflatten(leaves, like), cfg, batch,
                              dtype=torch.float32, remat=True, ops=ops)
        g = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        grads.append(dict(zip(leaves, g)))
        del loss, g, leaves
    bad = [k for k, v in grads[0].items()
           if not (bool(torch.isfinite(v).all()) and float(v.abs().max()) > 0)]
    err, leaf = leaf_rel_err(grads[0], grads[1])
    loss_err = abs(losses[0] - losses[1]) / abs(losses[1])
    return {"layers": spec["check_layers"], "loss": losses[0], "loss_rel_err": loss_err, "grad_rel_err": err,
            "worst_leaf": leaf, "leaves": len(grads[0]), "bad_leaves": bad}


def time_one_step(eng, holder: list, batch, host: bool = True) -> dict:
    """Three more steps of ``eng`` on ``batch`` from the state in
    ``holder[0]`` (replaced by each step's, as the step is donated): a
    warm one, one timed by the host clock and CUDA events (its device
    span) and one profiled (device busy time over that span, time by
    kernel; ``host=False`` traces the device alone), printed."""
    import torch

    def one_step():
        holder[0], _ = eng.step(holder[0], batch)
    one_step()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    one_step()
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    span_s = start.elapsed_time(end) * 1e-3
    prof = device_breakdown(one_step, top=16, host=host)
    busy = prof["device_busy_s"]
    share = None if busy is None else busy / span_s
    print(f"  one step: wall {wall_s:.4f} s, device span {span_s:.4f} s; "
          f"a profiled step: device busy {busy} s (wall {prof['wall_s']:.4f}"
          f" s under the profiler), busy share of the span {share}")
    for r in prof["by_kernel"]:
        print(f"    {r['device_ms']:9.3f} ms  {r['calls']:6d}  {r['kernel']}")
    return {"prof": prof, "step_wall_s": wall_s, "step_device_span_s": span_s,
            "device_busy_share": share}


def lm_training_main_path(dev) -> dict:
    """recurrentgemma-2b and mamba2-130m trained at full width and depth
    through the train CLI's ``train_lm`` (``LM_TRAIN``), each with the
    launch counts set to 0 just before and read just after: they must
    equal the prediction. Then, on the live state: every leaf's gradient
    finite and non-zero (a gradient dropped through ctypes would leave the
    weights below a kernel with none), one step timed by CUDA events and
    one profiled (its device busy time over that step's span, time by
    kernel); for mamba2-130m the hand-off, one request served greedily
    through ``InferenceEngine.from_train_state`` and through an engine
    built from the saved checkpoint, their params and tokens equal. Last, the float32 gradients at
    reduced depth, kernels against plain (``lm_grad_check``)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.data.tokens import TokenSource
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import InferenceEngine, Request, Scheduler
    from repro_torch.train import accumulate_grads
    out = {}
    for arch, spec in LM_TRAIN.items():
        gc.collect()
        torch.cuda.empty_cache()
        B, S, n = spec["batch"], spec["seq"], spec["steps"]
        argv = ["--arch", arch, "--batch-size", str(B), "--seq-len", str(S),
                "--steps", str(n), "--seed", str(SEED)]
        ckpt = ROOT / "build" / "chip_smoke" / f"{arch}_train.npz"
        if arch == "mamba2-130m":
            argv += ["--ckpt", str(ckpt)]
        print(f"  python -m repro_torch.launch.train {' '.join(argv)}")
        torch.cuda.synchronize()
        reset_launches()
        rec, eng, state = train_cli.train_lm(train_cli.parse_args(argv))
        launches = read_launches()
        want = {name: 0 for name in launches}
        want.update({k: v * n for k, v in spec["per_step"].items()})
        print(f"  {arch}: {rec['params'] / 1e9:.3f} B params, {n} steps of "
              f"{B} x {S} tokens: loss {rec['first_loss']:.4f} -> "
              f"{rec['last_loss']:.4f}, step p50 {rec['step_p50_s']:.4f} s "
              f"({B * S / rec['step_p50_s']:.1f} tokens/s), peak memory "
              f"{rec['peak_memory_bytes'] / 1e9:.3f} GB; launches {launches}")
        check(launches == want, f"{arch} training launches {launches} != "
              f"predicted {want}")
        check(rec["steps"] == n and bool(np.isfinite(
            [rec["first_loss"], rec["last_loss"]]).all()),
            f"{arch}: steps {rec['steps']}, losses {rec['first_loss']} "
            f"{rec['last_loss']}")
        source = TokenSource(eng.cfg, B, S, seed=SEED)
        batch = eng.place_batch(source.host_batch(n))
        grads, loss, _ = accumulate_grads(eng.loss_fn, state.params, batch, 1)
        bad = [k for k, v in grads.items()
               if not (bool(torch.isfinite(v).all())
                       and float(v.abs().max()) > 0)]
        print(f"  every leaf's gradient at full depth: {len(grads) - len(bad)}"
              f" of {len(grads)} finite and non-zero (loss {float(loss):.4f})")
        check(not bad and bool(torch.isfinite(loss).all()),
              f"{arch}: leaves without a finite non-zero gradient: {bad[:8]}")
        del grads, loss
        holder = [state]
        timing = time_one_step(eng, holder, batch)
        res = {"launches": {"train": launches}, "profile": timing.pop("prof"),
               "record": {k: v for k, v in rec.items()},
               "tokens_per_s": B * S / rec["step_p50_s"], **timing}
        if arch == "mamba2-130m":
            rng = np.random.default_rng(SEED)
            prompt = rng.integers(0, eng.cfg.vocab_size,
                                  HANDOFF_PROMPT).astype(np.int32)
            kw = dict(slots=1, max_len=HANDOFF_PROMPT + HANDOFF_GEN,
                      page_size=16)

            def serve(engine, st):
                return Scheduler(engine, st).run([Request(
                    rid=0, prompt=prompt, max_new=HANDOFF_GEN)])[0]
            live_eng, live_st = InferenceEngine.from_train_state(
                eng, holder[0], **kw)
            cold = InferenceEngine(eng.cfg, device=dev, **kw)
            cold_st = cold.init_state(cold.restore_params(
                str(ckpt), init_params(eng.cfg, dev, cold.dtype)))
            same = all(torch.equal(a, b) for a, b in zip(
                _leaves(live_st.params), _leaves(cold_st.params)))
            live, saved = serve(live_eng, live_st), serve(cold, cold_st)
            print(f"  hand-off: serving params from_train_state and from the "
                  f"checkpoint equal to the bit: {same}; streams {live} and "
                  f"{saved}")
            check(same and len(live) == HANDOFF_GEN
                  and list(live) == list(saved),
                  f"{arch} hand-off: params equal {same}, the live state's "
                  f"stream {live}, the checkpoint's {saved}")
            res["handoff_tokens"] = list(map(int, live))
        del state, holder, eng, batch
        gc.collect()
        torch.cuda.empty_cache()
        c = lm_grad_check(arch, spec, dev)
        print(f"  float32, {c['layers']} layers: loss {c['loss']:.6f} within "
              f"{c['loss_rel_err']:.3e}, worst leaf {c['worst_leaf']} "
              f"{c['grad_rel_err']:.3e} of its largest |grad| ({c['leaves']} "
              "leaves)")
        check(not c["bad_leaves"], f"{arch}: leaves without a finite non-zero "
              f"gradient through the kernels: {c['bad_leaves']}")
        check(c["loss_rel_err"] <= 1e-5 and c["grad_rel_err"] <= GRAD_REL,
              f"{arch} float32 gradients, kernels vs plain: loss "
              f"{c['loss_rel_err']}, worst leaf {c['worst_leaf']} "
              f"{c['grad_rel_err']} > {GRAD_REL}")
        res["grad_check"] = c
        print("  " + json.dumps({arch: {k: v for k, v in res.items()
                                        if k != "profile"}}))
        out[f"{arch} training"] = res
    return out


# ---------------------------------------------------------------------------
# Phase 13: the front ends and the contribution gate
# ---------------------------------------------------------------------------
def vlm_requests_of(cfg, lens, gen: int, image_seed: int = LM_SEED) -> list:
    """``requests_of``'s queue, each request with its image: (num_patches,
    frontend_dim) patch embeddings drawn N(0, 1), from ``image_seed`` + 1
    (another seed, the same prompts and another image)."""
    import numpy as np
    rng = np.random.default_rng(image_seed + 1)
    reqs = requests_of(cfg.vocab_size, lens, gen)
    for r in reqs:
        r.extras = {"patches": rng.normal(size=(
            cfg.num_patches, cfg.frontend_dim)).astype(np.float32)}
    return reqs


def train_cli_plain_check(arch: str, spec: dict) -> dict:
    """The train CLI's ``train_lm`` at full width, ``spec["check_layers"]``
    layers and float32 activations, 2 steps from the same seed through the
    kernels and through ``transformer.PLAIN`` (its config's depth and its
    engine's dtype and ops patched in): the losses, and each run's
    launches."""
    from unittest import mock

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as tfm
    from repro_torch.train import Engine
    argv = ["--arch", arch, "--batch-size", str(spec["batch"]), "--seq-len",
            str(spec["seq"]), "--steps", "2", "--seed", str(SEED)]

    def run(ops):
        class Float32Engine:
            @staticmethod
            def for_lm(cfg, tc, **kw):
                return Engine.for_lm(cfg, tc, dtype=torch.float32, ops=ops,
                                     **kw)
        cut = lambda a: get_config(a).replace(num_layers=spec["check_layers"])
        with mock.patch.object(train_cli, "get_config", cut), \
                mock.patch.object(train_cli, "Engine", Float32Engine):
            reset_launches()
            rec = train_cli.train_lm(train_cli.parse_args(argv))[0]
            return rec, read_launches()
    (k, k_launches), (p, p_launches) = run(tfm.KERNELS), run(tfm.PLAIN)
    rel = max(abs(k[n] - p[n]) / abs(p[n]) for n in ("first_loss",
                                                      "last_loss"))
    return {"layers": spec["check_layers"], "losses": [k["first_loss"],
                                                       k["last_loss"]],
            "plain_losses": [p["first_loss"], p["last_loss"]],
            "loss_rel_err": rel, "launches": k_launches,
            "plain_launches": p_launches}


def frontend_main_path(dev) -> dict:
    """Phase 13. internvl2-2b at full width and depth (random weights from
    the port's init, seed 0, bf16) served on one wave of requests with
    images in three modes, each with the launch counts set to 0 just
    before and read just after: paged_attn as predicted
    (``VLM_LAUNCHES``), every other kernel 0, no request chunked; the
    whole-prefill mode profiled once; the spec mode on the damped weights.
    Then one bf16 decode step's logits, kernel against plain (printed on
    the main weights, held within 2^-5 on the rescaled ones), and against
    the same step on other images (the image must move the logits). Then
    at 6 of the 24 layers in float32, the gate off and on: in each mode
    every launch held against the plain version (``checked_ops``, which
    serves the plain results) and the kernel run's greedy stream equal to
    that run's (rescaled weights; spec damped). Last, hubert-xlarge and
    internvl2-2b trained at full width and depth through the train CLI's
    ``train_lm`` (``FE_TRAIN``): no kernel launched, losses finite, every
    leaf's gradient finite and non-zero (``frontend`` included; hubert's
    token embedding, which the audio stub never reads, has none, as in
    the reference), one step timed and one profiled; and the CLI at
    reduced depth in float32, kernels against plain
    (``train_cli_plain_check``)."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenSource
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as tfm
    from repro_torch.train import accumulate_grads
    bf16 = torch.bfloat16
    modes = {"whole": {}, "chunked": {"prefill_chunk": LM_CHUNK},
             "spec": {"spec_k": LM_SPEC_K}}
    out = {}

    def free():
        gc.collect()
        torch.cuda.empty_cache()
    free()
    stamp("phase 13 starts")
    cfg = get_config(VLM_ARCH)
    t0 = time.perf_counter()
    pbf = init_params(cfg, dev, bf16)
    torch.cuda.synchronize()
    nparams = sum(t.numel() for t in _leaves(pbf))
    print(f"  {cfg.name} params: {nparams / 1e9:.3f} B, {cfg.num_layers} "
          f"layers, d {cfg.d_model}, {cfg.num_heads} heads on "
          f"{cfg.num_kv_heads}, vocab {cfg.vocab_size}, {cfg.num_patches} "
          f"patches of {cfg.frontend_dim}, init "
          f"{time.perf_counter() - t0:.1f} s")

    def wave(image_seed=LM_SEED, c=cfg):
        return vlm_requests_of(c, VLM_LENS, VLM_GEN, image_seed)
    serve_once(cfg, dev, pbf, bf16, {"spec_k": LM_SPEC_K},
               vlm_requests_of(cfg, VLM_LENS[:2], 4))            # warm-up
    runs = {}
    for name, mode in modes.items():
        r = serve_once(cfg, dev, damped(cfg, pbf) if name == "spec" else pbf,
                       bf16, mode, wave(),
                       profile_reqs=wave() if name == "whole" else None)
        check_tokens(cfg, name, r, wave())
        check_spec(cfg.name, name, r)
        got, want = r["launches"], VLM_LAUNCHES[name]
        check(got["paged_attn"] == want and not any(
            v for k, v in got.items() if k != "paged_attn"),
            f"{cfg.name} {name}: launches {got}, paged_attn predicted {want}")
        check(r["stats"]["prefill_chunks"] == 0,
              f"{cfg.name} {name}: a request with patches was chunked")
        runs[name] = r
        print_run(cfg.name, name, r)
    stamp(f"{cfg.name} bf16 served runs done")

    well = well_conditioned(cfg, pbf)
    logits = {}
    for tag, p in (("main weights", pbf), ("rescaled weights", well)):
        logits[tag] = decode_logits_check(cfg, dev, p, bf16, wave(),
                                          keep_logits=True)
        print(f"  {cfg.name} bf16 decode_step_paged logits, {tag}: kernel "
              f"vs plain {logits[tag]['rel_err']:.3e} of the largest "
              f"|logit| (tolerance {REL_LOGITS_BF16} on the rescaled "
              f"weights); argmax equal {logits[tag]['argmax_equal']}")
    rel = logits["rescaled weights"]["rel_err"]
    check(rel <= REL_LOGITS_BF16, f"{cfg.name} bf16 decode logits differ by "
          f"{rel}")
    other = decode_logits_check(cfg, dev, well, bf16, wave(LM_SEED + 10),
                                keep_logits=True)["logits"]
    first = logits["rescaled weights"]["logits"]
    image_moves = max_err(first, other) / float(first.abs().max())
    for bf in logits.values():
        del bf["logits"]
    print(f"  {cfg.name}: other images, the same prompts: the first decode "
          f"step's logits move by {image_moves:.3e} of the largest |logit|")
    check(image_moves > REL_LOGITS_BF16, f"{cfg.name}: the image moves the "
          f"logits by {image_moves} only")
    del pbf, well
    free()
    stamp(f"{cfg.name} bf16 checks done")

    # fp32 at 6 layers, the gate off and on: each launch against the plain
    # version, and the kernels' streams against the checked run's (which
    # serves the plain results); rescaled weights, spec damped
    f32 = {}
    for gate in (False, True):
        cfg6 = cfg.replace(num_layers=VLM_F32_DEPTH, contribution_gate=gate)
        p32 = init_params(cfg6, dev)
        weights = {"rescaled": well_conditioned(cfg6, p32),
                   "damped": damped(cfg6, p32)}
        del p32
        for name, mode in modes.items():
            tag = "damped" if name == "spec" else "rescaled"
            ops = checked_ops()
            chk = serve_once(cfg6, dev, weights[tag], torch.float32, mode,
                             wave(c=cfg6), ops=ops)
            ker = serve_once(cfg6, dev, weights[tag], torch.float32, mode,
                             wave(c=cfg6))
            for r in (chk, ker):
                check_spec(cfg6.name, name, r)
            rows = {k: {"launches": c.calls, "max_rel_err": c.max_rel}
                    for k, c in zip(tfm.KernelOps._fields, ops)}
            c = rows["paged_attn"]
            key = f"{name}, gate {'on' if gate else 'off'}"
            f32[key] = {"checked": c, "streams_equal": ker["gen"] == chk["gen"],
                        "first_parting": first_parting(ker["gen"], chk["gen"]),
                        "kernel_launches": ker["launches"]["paged_attn"],
                        "kernel_tok_per_s": ker["tok_per_s"],
                        "plain_tok_per_s": chk["tok_per_s"]}
            print(f"  {cfg.name} ({VLM_F32_DEPTH} layers) {key} fp32, {tag} "
                  f"weights: {c['launches']} paged_attn launches held against "
                  f"the plain version, max error {c['max_rel_err']:.3e} of the "
                  f"output's largest |value| (tolerance {REL_F32}); greedy "
                  f"streams equal: {f32[key]['streams_equal']} (first "
                  f"parting {f32[key]['first_parting']})")
            check(all(v["launches"] == 0 for k, v in rows.items()
                      if k != "paged_attn"), f"fp32 {key}: {rows}")
            check(not any(v for k, v in ker["launches"].items()
                          if k != "paged_attn")
                  and ker["launches"]["paged_attn"] > 0,
                  f"fp32 {key}: launches {ker['launches']}")
            check(c["launches"] > 0 and c["max_rel_err"] <= REL_F32,
                  f"fp32 {key}: kernel differs from plain by "
                  f"{c['max_rel_err']}")
            check(f32[key]["streams_equal"],
                  f"fp32 {key}: kernel and plain streams differ")
        del weights
        free()
    stamp(f"{cfg.name} fp32 checks done")
    print("  " + json.dumps({cfg.name: run_summary(runs), "fp32": f32,
                             "bf16_logits": logits,
                             "image_moves_logits": image_moves}))
    out[cfg.name] = {"launches": {n: r["launches"] for n, r in runs.items()},
                     "profile": runs["whole"]["profile"]}

    for arch, spec in FE_TRAIN.items():
        free()
        B, S, n = spec["batch"], spec["seq"], spec["steps"]
        argv = ["--arch", arch, "--batch-size", str(B), "--seq-len", str(S),
                "--steps", str(n), "--seed", str(SEED)]
        print(f"  python -m repro_torch.launch.train {' '.join(argv)}")
        torch.cuda.synchronize()
        reset_launches()
        rec, eng, state = train_cli.train_lm(train_cli.parse_args(argv))
        launches = read_launches()
        print(f"  {arch}: {rec['params'] / 1e9:.3f} B params, {n} steps of "
              f"{B} x {S} positions: loss {rec['first_loss']:.4f} -> "
              f"{rec['last_loss']:.4f}, step p50 {rec['step_p50_s']:.4f} s "
              f"({B * S / rec['step_p50_s']:.1f} positions/s), peak memory "
              f"{(rec['peak_memory_bytes'] or 0) / 1e9:.3f} GB; launches "
              f"{launches}")
        check(not any(launches.values()), f"{arch} training launched "
              f"{launches}: its path has no kernel")
        check(rec["steps"] == n and bool(np.isfinite(
            [rec["first_loss"], rec["last_loss"]]).all()),
            f"{arch}: steps {rec['steps']}, losses {rec['first_loss']} "
            f"{rec['last_loss']}")
        batch = eng.place_batch(TokenSource(eng.cfg, B, S,
                                            seed=SEED).host_batch(n))
        grads, loss, _ = accumulate_grads(eng.loss_fn, state.params, batch, 1)
        unread = {"embed/embedding"} if eng.cfg.frontend == "audio_stub" \
            else set()
        bad = [k for k, v in grads.items() if k not in unread and not (
            bool(torch.isfinite(v).all()) and float(v.abs().max()) > 0)]
        front = [k for k in grads if k.startswith("frontend/")]
        print(f"  every leaf's gradient at full depth: "
              f"{len(grads) - len(bad) - len(unread)} of "
              f"{len(grads) - len(unread)} finite and non-zero, {front} "
              f"among them (loss {float(loss):.4f}); unread, zero: "
              f"{sorted(unread)}")
        check(not bad and front and bool(torch.isfinite(loss).all()) and all(
            not grads[k].any() for k in unread),
            f"{arch}: leaves without a finite non-zero gradient: {bad[:8]}")
        del grads, loss
        holder = [state]
        del state
        stamp(f"{arch} trained, gradients checked")
        timing = time_one_step(eng, holder, batch, host=False)
        res = {"launches": {"train": launches}, "profile": timing.pop("prof"),
               "record": dict(rec), "positions_per_s": B * S / rec["step_p50_s"],
               **timing}
        del holder, eng, batch
        free()
        stamp(f"{arch} step timed and profiled")
        c = train_cli_plain_check(arch, spec)
        print(f"  train CLI, float32, {c['layers']} layers: losses "
              f"{c['losses']} through the kernels' ops, {c['plain_losses']} "
              f"through the plain ones, within {c['loss_rel_err']:.3e}; "
              f"launches {c['launches']} and {c['plain_launches']}")
        check(c["loss_rel_err"] <= 1e-5 and not any(c["launches"].values())
              and not any(c["plain_launches"].values()),
              f"{arch} float32 train CLI, kernels vs plain: {c}")
        res["cli_float32_check"] = c
        print("  " + json.dumps({arch: {k: v for k, v in res.items()
                                        if k != "profile"}}))
        out[f"{arch} training"] = res
        stamp(f"{arch} training done")
    return out


# ---------------------------------------------------------------------------
# Phase 14: distribution on a 1x1 mesh
# ---------------------------------------------------------------------------
# One epoch of the stacked Dom-ST run (9 steps) and the forecast, then
# mamba2-130m at full width and depth with the FSDP rule variant, each on
# the host mesh (a world-1 NCCL group started by ``make_host_mesh``) and
# on one device from the same state. Launches as phases 3, 4 and 12 count
# them: a Dom-ST step 1 Pix-Con and 2 x 30 LSTM, a forecast of the 74
# held-out days 74 and 4,440; a mamba2-130m step 48 conv1d and 48 SSD
# chunk.
MESH_DOMST_STEPS, MESH_REL = 9, 1e-6
MESH_LM = {"arch": "mamba2-130m", "batch": 8, "seq": 1024, "steps": 3}


def _state_rel_err(a, b) -> tuple[float, str]:
    """The largest leaf error of host state ``a`` against ``b`` (params and
    both moments), over the leaf's largest |value|."""
    worst, where = 0.0, ""
    for tree in ("params", "mu", "nu"):
        ta = a.params if tree == "params" else getattr(a.opt_state, tree)
        tb = b.params if tree == "params" else getattr(b.opt_state, tree)
        for k, v in tb.items():
            scale = float(v.abs().max()) or 1.0
            e = float((ta[k] - v).abs().max()) / scale
            if e > worst:
                worst, where = e, f"{tree}/{k}"
    return worst, where


def distribution_main_path(dev) -> dict:
    """Phase 14. The stacked Dom-ST engine (23 watersheds, float32) for
    ``MESH_DOMST_STEPS`` steps and the ``Forecaster`` on the 74 held-out
    days, then ``Engine.for_lm`` on mamba2-130m (bf16 activations, block
    remat, ``fsdp=True``) for 3 steps: each on the 1x1 mesh and on one
    device from the same state, the launch counts set to 0 just before
    each run on the mesh and read just after. Dom-ST's params and moments
    and the forecast, and mamba2's losses, params and moments, within
    ``MESH_REL`` of their scale of the one-device run's; mamba2's losses
    finite. Step
    times on and off the mesh are printed: the mesh's cost is DTensor's
    dispatch on the host."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.convert import flatten, unflatten
    from repro_torch.core import domst
    from repro_torch.data.pipeline import (
        InputPipeline, StackedSource, make_domst_windows, stacked_test_batch,
        train_split)
    from repro_torch.data.tokens import TokenSource
    from repro_torch.distributed.sharding import full_host
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.forecast import Forecaster
    from repro_torch.train import Engine

    mesh = make_host_mesh()
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1
          and tuple(mesh.shape) == (1, 1),
          f"host mesh: backend {dist.get_backend()}, world "
          f"{dist.get_world_size()}, shape {tuple(mesh.shape)}")
    print(f"  host mesh {tuple(mesh.shape)} {mesh.mesh_dim_names}, "
          f"{dist.get_backend()} world of {dist.get_world_size()}")
    out = {}
    try:
        # -- Dom-ST stacked training ------------------------------------
        cfg = get_config("domst")
        windows = make_domst_windows(WATERSHEDS, DAYS)
        ip = InputPipeline([train_split(w) for w in windows],
                           batch_size=TRAIN_BATCH, seed=SEED)
        source = StackedSource(ip)
        tc = TrainConfig(learning_rate=1e-3, total_steps=100,
                         warmup_steps=50, seed=SEED)
        init = domst.init(cfg, torch.Generator().manual_seed(SEED),
                          WATERSHEDS)
        host_batches = [source.host_batch(i) for i in range(MESH_DOMST_STEPS)]
        runs = {}
        for name, m in (("one device", None), ("1x1 mesh", mesh)):
            eng = Engine.for_domst(cfg, tc, stacked=True, device=dev, mesh=m)
            state = eng.init_state({k: v.clone() for k, v in init.items()})
            batches = [eng.place_batch(b) for b in host_batches]
            torch.cuda.synchronize()
            reset_launches()
            losses, step_s = [], []
            for b in batches:
                t = time.perf_counter()
                state, mets = eng.step(state, b)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t)
                losses.append(full_host(mets["loss"]))
            runs[name] = {"host": eng.host_state(state), "losses": losses,
                          "step_s": step_s, "launches": read_launches()}
        want = {n: 0 for n in runs["1x1 mesh"]["launches"]}
        want.update(pixcon=MESH_DOMST_STEPS, lstm_cell=MESH_DOMST_STEPS
                    * cfg.domst.lstm_layers * cfg.domst.window_days)
        for name, r in runs.items():
            p50 = sorted(r["step_s"][1:])[len(r["step_s"][1:]) // 2]
            r["step_p50_s"] = p50
            print(f"  domst stacked, {name}: {MESH_DOMST_STEPS} steps, step "
                  f"(synchronised) median {p50:.4f} s, first "
                  f"{r['step_s'][0]:.4f} s; launches {r['launches']}")
            check(r["launches"] == want,
                  f"domst {name} launches {r['launches']} != {want}")
        losses = np.stack(runs["1x1 mesh"]["losses"])
        check(bool(np.isfinite(losses).all()), "a non-finite loss on the mesh")
        loss_err = float(np.abs(losses - np.stack(
            runs["one device"]["losses"])).max() / np.abs(losses).max())
        err, leaf = _state_rel_err(runs["1x1 mesh"]["host"],
                                   runs["one device"]["host"])
        print(f"  domst mesh vs one device after {MESH_DOMST_STEPS} steps: "
              f"losses within {loss_err:.3e}, worst leaf {leaf} "
              f"{err:.3e} of its scale")
        check(loss_err <= MESH_REL and err <= MESH_REL,
              f"domst on the mesh: losses {loss_err}, {leaf} {err} > "
              f"{MESH_REL}")
        out["domst training"] = {
            "launches": runs["1x1 mesh"]["launches"],
            "step_p50_s": {n: r["step_p50_s"] for n, r in runs.items()},
            "step_s": {n: r["step_s"] for n, r in runs.items()},
            "loss_rel_err": loss_err, "state_rel_err": err}

        # -- the forecast ------------------------------------------------
        held = stacked_test_batch(windows)
        trained = runs["one device"]["host"].params
        fcs = {}
        for name, fc in (("one device", Forecaster(cfg, device=dev)),
                         ("1x1 mesh", Forecaster(cfg, mesh=mesh))):
            params, placed = fc.place_params(trained), fc.place_batch(held)
            fc.forecast(params, placed)                  # warm
            torch.cuda.synchronize()
            reset_launches()
            t = time.perf_counter()
            res = fc.forecast(params, placed)
            torch.cuda.synchronize()
            fcs[name] = {"wall_s": time.perf_counter() - t,
                         "launches": read_launches(),
                         "res": {k: v.cpu() for k, v in res.items()}}
        N = held["discharge"].shape[1]
        want = {n: 0 for n in fcs["1x1 mesh"]["launches"]}
        want.update(pixcon=N, lstm_cell=N * cfg.domst.lstm_layers
                    * cfg.domst.window_days)
        for name, r in fcs.items():
            print(f"  forecast {WATERSHEDS} x {N} days, {name}: "
                  f"{r['wall_s']:.4f} s, launches {r['launches']}")
            check(r["launches"] == want,
                  f"forecast {name} launches {r['launches']} != {want}")
        a, b = fcs["1x1 mesh"]["res"], fcs["one device"]["res"]
        q_err = float((a["qhat"] - b["qhat"]).abs().max()
                      / b["qhat"].abs().max())
        nse_err = float((a["nse"] - b["nse"]).abs().max())
        print(f"  forecast mesh vs one device: qhat within {q_err:.3e} of "
              f"its scale, NSE within {nse_err:.3e}")
        check(bool(torch.isfinite(a["qhat"]).all()) and q_err <= MESH_REL
              and nse_err <= MESH_REL,
              f"forecast on the mesh: qhat {q_err}, NSE {nse_err}")
        out["domst forecast"] = {"launches": fcs["1x1 mesh"]["launches"],
                                 "wall_s": {n: r["wall_s"]
                                            for n, r in fcs.items()},
                                 "qhat_rel_err": q_err, "nse_err": nse_err}
        del runs, fcs

        # -- mamba2-130m, FSDP rules ------------------------------------
        spec = MESH_LM
        lcfg = get_config(spec["arch"])
        ltc = TrainConfig(learning_rate=1e-3, total_steps=spec["steps"],
                          warmup_steps=1, remat="block", seed=SEED,
                          fsdp=True)
        tree = tfm.init(lcfg, torch.Generator(device=dev).manual_seed(SEED))
        like = tfm.model_params(lcfg, lambda *a: None)
        src = TokenSource(lcfg, spec["batch"], spec["seq"], seed=SEED)
        lm = {}
        for name, m in (("one device", None), ("1x1 mesh", mesh)):
            eng = Engine.for_lm(lcfg, ltc, device=dev, mesh=m)
            state = eng.init_state(unflatten(
                {k: v.clone() for k, v in flatten(tree).items()}, like))
            batches = [eng.place_batch(src.host_batch(i))
                       for i in range(spec["steps"])]
            torch.cuda.synchronize()
            reset_launches()
            losses, step_s = [], []
            for b in batches:
                t = time.perf_counter()
                state, mets = eng.step(state, b)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t)
                losses.append(float(full_host(mets["loss"])))
            lm[name] = {"losses": losses, "step_s": step_s,
                        "launches": read_launches(),
                        "host": eng.host_state(state)}
            if m is not None:       # phase 16 serves it from the mesh
                HANDOFF.update(engine=eng, state=state,
                               host=lm[name]["host"])
            del eng, state, batches
            torch.cuda.empty_cache()
        want = {n: 0 for n in lm["1x1 mesh"]["launches"]}
        want.update({k: v * spec["steps"] for k, v in
                     LM_TRAIN[spec["arch"]]["per_step"].items()})
        for name, r in lm.items():
            print(f"  {spec['arch']} fsdp rules, {name}: losses "
                  f"{np.round(r['losses'], 4).tolist()}, steps "
                  f"{np.round(r['step_s'], 4).tolist()} s; launches "
                  f"{r['launches']}")
            check(r["launches"] == want,
                  f"{spec['arch']} {name} launches {r['launches']} != {want}")
            check(bool(np.isfinite(r["losses"]).all()),
                  f"{spec['arch']} {name}: a non-finite loss {r['losses']}")
        l_err = max(abs(x - y) / abs(y) for x, y in zip(
            lm["1x1 mesh"]["losses"], lm["one device"]["losses"]))
        s_err, leaf = _state_rel_err(lm["1x1 mesh"]["host"],
                                     lm["one device"]["host"])
        print(f"  {spec['arch']} mesh vs one device: losses within "
              f"{l_err:.3e}, worst leaf {leaf} {s_err:.3e} of its scale")
        check(l_err <= MESH_REL and s_err <= MESH_REL,
              f"{spec['arch']} on the mesh: losses {l_err}, {leaf} "
              f"{s_err} > {MESH_REL}")
        out[f"{spec['arch']} training on a 1x1 mesh"] = {
            "launches": {"train": lm["1x1 mesh"]["launches"]},
            "profile": None,
            "step_s": {n: r["step_s"] for n, r in lm.items()},
            "losses": {n: r["losses"] for n, r in lm.items()},
            "loss_rel_err": l_err, "state_rel_err": s_err}
        del lm
    except BaseException:
        dist.destroy_process_group()
        raise
    # the world stays up: phase 16 serves the trained mamba2 on this mesh
    print("  " + json.dumps({k: {kk: vv for kk, vv in v.items()
                                 if kk != "profile"}
                             for k, v in out.items()}))
    return out


# ---------------------------------------------------------------------------
# Phase 15: serving on a 1x1 mesh
# ---------------------------------------------------------------------------
# qwen2-1.5b at full width and depth in bf16 on one wave (4 requests of
# 512/510/508/506 tokens, 32 new each), whole, in 128-token chunks and with
# spec_k=3 (damped weights), through InferenceEngine(mesh=) on the host
# mesh and on one device from the same params; then float32 at 6 of its
# layers: every launch on the mesh held against the plain version, and
# the contiguous engine (page_size=0) against the paged one on the mesh.
# paged_attn launches by mode, from ``scripts/serve_mesh_rehearsal.py``
# (the same queue at full depth on the CPU, on one device and on a 1x1
# mesh alike): 28 layers x 31 decode steps whole; x (43 decode steps + 16
# chunks) chunked; x 16 steps (15 verify, 1 decode) spec.
MESH_SERVE_ARCH, MESH_SERVE_F32_DEPTH = "qwen2-1.5b", 6
MESH_SERVE_LAUNCHES = {"whole": 28 * 31, "chunked": 28 * 59,
                       "spec": 28 * 16}


def serving_mesh_main_path(dev) -> dict:
    """Phase 15. ``InferenceEngine(mesh=make_host_mesh())`` serving
    qwen2-1.5b (random weights from the port's init, seed 0) at full
    width and depth in bf16, in three modes, against the one-device engine
    from the same params: the launch counts set to 0 just before each run
    and read just after, equal on and off the mesh and to the rehearsal's;
    the greedy streams equal (the 1x1 mesh runs the same operations on
    whole tensors); tok/s, decode tok/s and TTFT on and off the mesh.
    Then float32 at ``MESH_SERVE_F32_DEPTH`` layers on the mesh: every
    paged-attention launch held against the plain version (``REL_F32``),
    and the contiguous engine's greedy streams (rescaled weights) equal to
    the paged engine's."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tfm

    mesh = make_host_mesh()
    check(dist.get_world_size() == 1 and tuple(mesh.shape) == (1, 1),
          f"host mesh: world {dist.get_world_size()}, shape "
          f"{tuple(mesh.shape)}")
    cfg = get_config(MESH_SERVE_ARCH)
    out = {"launches": {}, "profile": None}
    try:
        p32 = tfm.init(cfg, torch.Generator(device=dev).manual_seed(LM_SEED))
        pbf = tfm.cast_params(p32, torch.bfloat16, dev)
        wave = lambda: requests_of(cfg.vocab_size, STEP_LENS, 32)
        modes = {"whole": {}, "chunked": {"prefill_chunk": LM_CHUNK},
                 "spec": {"spec_k": LM_SPEC_K}}
        serve_once(cfg, dev, pbf, torch.bfloat16, {"mesh": mesh},
                   requests_of(cfg.vocab_size, STEP_LENS[:1], 2))  # warm-up
        runs = {}
        for name, mode in modes.items():
            params = damped(cfg, pbf) if name == "spec" else pbf
            pair = {}
            for where, m in (("one device", None), ("1x1 mesh", mesh)):
                r = serve_once(cfg, dev, params, torch.bfloat16,
                               dict(mode, mesh=m), wave())
                check_tokens(cfg, f"{name} {where}", r, wave())
                check_spec(cfg.name, name, r)
                pair[where] = r
                print_run(f"{cfg.name} ({where})", name, r)
            a, b = pair["1x1 mesh"], pair["one device"]
            want = {k: 0 for k in a["launches"]}
            want["paged_attn"] = MESH_SERVE_LAUNCHES[name]
            check(a["launches"] == b["launches"] == want,
                  f"{name}: launches on the mesh {a['launches']}, one device "
                  f"{b['launches']}, predicted {want}")
            same = a["gen"] == b["gen"]
            print(f"  {name} bf16: streams on the mesh equal one device's: "
                  f"{same} (first parting {first_parting(a['gen'], b['gen'])})")
            check(same, f"{name} bf16: the mesh's streams differ")
            runs[name] = pair
            out["launches"][name] = a["launches"]
        del pbf
        stamp("phase 15 bf16 runs done")

        cfg6, p6 = half_depth(cfg, p32, MESH_SERVE_F32_DEPTH)
        del p32
        f32 = {}
        d6 = damped(cfg6, p6)
        for name, mode in modes.items():
            ops = checked_ops()
            serve_once(cfg6, dev, d6 if name == "spec" else p6,
                       torch.float32, dict(mode, mesh=mesh), wave(), ops=ops)
            c = ops.paged_attn
            f32[name] = {"checked_launches": c.calls, "max_rel_err": c.max_rel}
            print(f"  {name} fp32 ({MESH_SERVE_F32_DEPTH} layers) on the "
                  f"mesh, every launch held against the plain version: "
                  f"{c.calls} launches, max error {c.max_rel:.3e} of the "
                  f"output's largest |value| (tolerance {REL_F32})")
            check(c.calls > 0 and c.max_rel <= REL_F32,
                  f"fp32 {name} on the mesh: kernel differs from plain by "
                  f"{c.max_rel}")
        well = well_conditioned(cfg6, p6)
        paged = serve_once(cfg6, dev, well, torch.float32, {"mesh": mesh},
                           wave())
        contiguous = serve_once(cfg6, dev, well, torch.float32,
                                {"mesh": mesh, "paged": False}, wave())
        same = contiguous["gen"] == paged["gen"]
        print(f"  fp32 ({MESH_SERVE_F32_DEPTH} layers, rescaled weights) on "
              f"the mesh: contiguous (page_size=0) streams equal paged: "
              f"{same} (first parting "
              f"{first_parting(contiguous['gen'], paged['gen'])}); "
              f"contiguous {contiguous['tok_per_s']:.1f} tok/s, launches "
              f"{ {k: v for k, v in contiguous['launches'].items() if v} }")
        check(same, "fp32 on the mesh: contiguous and paged streams differ")
        check(not any(contiguous["launches"].values()),
              f"the contiguous engine launched {contiguous['launches']}")
        out["mesh serving"] = {
            name: {where: {k: r[k] for k in ("tok_per_s", "decode_tok_per_s",
                                             "ttft_p50_s", "ttft_p99_s",
                                             "wall_s")}
                   for where, r in pair.items()}
            for name, pair in runs.items()}
        out["fp32"] = f32
    except BaseException:
        dist.destroy_process_group()
        raise
    print("  " + json.dumps({k: v for k, v in out.items() if k != "profile"}))
    return out


# ---------------------------------------------------------------------------
# Phase 16: mamba2, MoE and an adopted training state served on a 1x1 mesh
# ---------------------------------------------------------------------------
# mamba2-130m at full width and depth on phase 7's wave (4 requests of
# 512/510/508/506 tokens, 32 new), whole / in 128-token chunks / spec_k=3
# (damped weights), and deepseek-moe-16b at full width and depth on phase
# 11's wave, whole, through InferenceEngine(mesh=) on the host mesh; each
# held to the one-device run of phases 7 and 11 (the same seed and queue:
# ``ONE_DEVICE_RUNS``, not run again). Then phase 14's mamba2-130m,
# trained with the FSDP rules on the 1x1 mesh (``HANDOFF``), adopted by
# ``InferenceEngine.from_train_state`` on that mesh and served one wave
# whole, against the same state served from ``host_state`` on one device.
# Launches a run, from ``scripts/serve_mesh_rehearsal.py --phase 16`` (the
# same queues at full depth on the CPU, on one device and on a 1x1 mesh
# alike): mamba2, 24 layers x (4 prompts + 31 decode steps) conv1d and 24
# x 4 ssd_chunk whole; 24 x (16 chunks + 43 decode steps) conv1d chunked;
# 24 x (4 + 16 steps) conv1d and 24 x 4 ssd_chunk spec; deepseek-moe, 28
# layers x 31 decode steps paged_attn. float32 at ``MESH_ARCHS_F32_DEPTH``
# layers, every layer kind kept (deepseek-moe: its dense first layer and
# two MoE layers): every launch on the mesh held against the plain version,
# and the greedy streams on the mesh equal one device's.
MESH_ARCHS = {"mamba2-130m": ("whole", "chunked", "spec"),
              "deepseek-moe-16b": ("whole",)}
MESH_ARCHS_LAUNCHES = {
    "mamba2-130m": {"whole": {"conv1d": 24 * 35, "ssd_chunk": 24 * 4},
                    "chunked": {"conv1d": 24 * 59},
                    "spec": {"conv1d": 24 * 20, "ssd_chunk": 24 * 4}},
    "deepseek-moe-16b": {"whole": {"paged_attn": 28 * 31}}}
MESH_ARCHS_F32_DEPTH = {"mamba2-130m": 6, "deepseek-moe-16b": 3}
ONE_DEVICE_RUNS: dict = {}    # arch -> mode -> run, from phases 7 and 11
HANDOFF: dict = {}            # phase 14's mamba2 engine and state on the mesh


def decode_step_ms(r) -> float:
    """A served run's mean decode step, host clock, in ms."""
    return 1e3 * r["stats"]["decode_s"] / max(r["stats"]["decode_steps"], 1)


def mesh_against_one(arch, name, r, one, want_launches) -> dict:
    """Check a bf16 run on the mesh against the one-device run of the same
    queue: launches (and the rehearsal's), streams; print both runs."""
    want = {k: 0 for k in r["launches"]}
    want.update(want_launches)
    check(r["launches"] == one["launches"] == want,
          f"{arch} {name}: launches on the mesh {r['launches']}, one device "
          f"{one['launches']}, predicted {want}")
    share = same_tokens(r["gen"], one["gen"])
    print(f"  {arch} {name} bf16: streams on the mesh equal one device's: "
          f"{r['gen'] == one['gen']} ({share:.4f} of the tokens equal; first "
          f"parting {first_parting(r['gen'], one['gen'])}); decode step "
          f"{decode_step_ms(r):.2f} ms on the mesh, {decode_step_ms(one):.2f} "
          f"ms on one device")
    check(r["gen"] == one["gen"], f"{arch} {name} bf16: the mesh's streams "
          "differ from one device's")
    return {"streams_equal_share": share, "launches": r["launches"],
            **{f"{k} ({where})": x[k] for where, x in (("1x1 mesh", r),
                                                     ("one device", one))
               for k in ("tok_per_s", "decode_tok_per_s", "ttft_p50_s",
                         "ttft_p99_s", "wall_s")},
            "decode_step_ms (1x1 mesh)": decode_step_ms(r),
            "decode_step_ms (one device)": decode_step_ms(one)}


def f32_on_mesh(cfg, dev, params, name, mode, reqs_of, mesh) -> dict:
    """float32 on the mesh: every launch held against the plain version,
    then the kernels' greedy streams on the mesh against one device's."""
    import torch
    from repro_torch.models import transformer as tfm
    ops = checked_ops()
    serve_once(cfg, dev, params, torch.float32, dict(mode, mesh=mesh),
               reqs_of(), ops=ops)
    rows = {k: {"launches": c.calls, "max_rel_err": c.max_rel}
            for k, c in zip(tfm.KernelOps._fields, ops) if c.calls}
    for k, c in rows.items():
        print(f"  {cfg.name} {name} fp32 ({cfg.num_layers} layers) on the "
              f"mesh, {k}: {c['launches']} launches held against the plain "
              f"version, max error {c['max_rel_err']:.3e} of the output's "
              f"largest |value| (tolerance {REL_F32})")
        check(c["max_rel_err"] <= REL_F32, f"{cfg.name} {name} fp32 {k} on "
              f"the mesh: kernel differs from plain by {c['max_rel_err']}")
    check(bool(rows), f"{cfg.name} {name} fp32: no launch checked")
    a = serve_once(cfg, dev, params, torch.float32, dict(mode, mesh=mesh),
                   reqs_of())
    b = serve_once(cfg, dev, params, torch.float32, mode, reqs_of())
    print(f"  {cfg.name} {name} fp32 ({cfg.num_layers} layers): greedy "
          f"streams on the mesh equal one device's: {a['gen'] == b['gen']} "
          f"(first parting {first_parting(a['gen'], b['gen'])}), launches "
          f"{ {k: v for k, v in a['launches'].items() if v} } on the mesh, "
          f"{ {k: v for k, v in b['launches'].items() if v} } on one device")
    check(a["gen"] == b["gen"] and a["launches"] == b["launches"],
          f"{cfg.name} {name} fp32: the mesh's streams or launches differ")
    return {"checked": rows, "streams_equal": True}


def serving_mesh_archs_main_path(dev) -> dict:
    """Phase 16. mamba2-130m (three modes) and deepseek-moe-16b (whole)
    at full width and depth in bf16 through ``InferenceEngine(mesh=
    make_host_mesh())``, random weights from the port's init (seed 0):
    the conv1d, SSD-chunk and paged-attention kernels on local blocks
    (``distributed/kernels.py``), the MoE layers through
    ``moe_block_sharded``; launch counts (set to 0 just before each run
    and read just after) equal to the one-device runs' of phases 7 and 11
    and to the rehearsal's, streams equal, decode steps timed beside one
    device's. Then float32 at ``MESH_ARCHS_F32_DEPTH`` layers. Then phase
    14's trained mamba2-130m adopted on its mesh by ``from_train_state``:
    its streams and launches equal the one-device engine's on the
    gathered ``host_state``."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.convert import unflatten
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tfm
    bf16 = torch.bfloat16
    modes = {"whole": {}, "chunked": {"prefill_chunk": LM_CHUNK},
             "spec": {"spec_k": LM_SPEC_K}}
    mesh = make_host_mesh()
    check(dist.get_world_size() == 1 and tuple(mesh.shape) == (1, 1),
          f"host mesh: world {dist.get_world_size()}, shape "
          f"{tuple(mesh.shape)}")
    out = {}
    try:
        for arch, names in MESH_ARCHS.items():
            cfg = get_config(arch)
            lens = SERVED_RUNS[arch]["lens"] if arch in SERVED_RUNS else \
                {n: MOE_LENS for n in names}
            gen = SERVED_RUNS[arch]["gen"] if arch in SERVED_RUNS else MOE_GEN

            def queue(name, c=cfg, lens=lens, gen=gen):
                return requests_of(c.vocab_size, lens[name], gen)
            pbf = init_params(cfg, dev, bf16)
            serve_once(cfg, dev, pbf, bf16, {"mesh": mesh},
                       requests_of(cfg.vocab_size, STEP_LENS[:1], 2))  # warm-up
            res = {"launches": {}, "profile": None, "runs": {}}
            for name in names:
                params = damped(cfg, pbf) if name == "spec" else pbf
                r = serve_once(cfg, dev, params, bf16,
                               dict(modes[name], mesh=mesh), queue(name))
                check_tokens(cfg, name, r, queue(name))
                check_spec(arch, name, r)
                print_run(f"{arch} (1x1 mesh)", name, r)
                res["runs"][name] = mesh_against_one(
                    arch, name, r, ONE_DEVICE_RUNS[arch][name],
                    MESH_ARCHS_LAUNCHES[arch][name])
                res["launches"][name] = r["launches"]
            del pbf, params
            torch.cuda.empty_cache()
            stamp(f"phase 16 {arch} bf16 runs done")

            # float32 at reduced depth, every layer kind kept
            cfg_f = cfg.replace(num_layers=MESH_ARCHS_F32_DEPTH[arch])
            p32 = init_params(cfg_f, dev)
            has_attn = any("attn" in lp for lp in p32["layers"])
            main = well_conditioned(cfg_f, p32) if has_attn else p32
            res["fp32"] = {}
            for name in names:
                params = damped(cfg_f, p32) if name == "spec" else main
                res["fp32"][name] = f32_on_mesh(
                    cfg_f, dev, params, name, modes[name],
                    lambda c=cfg_f, n=name: requests_of(
                        c.vocab_size, lens[n], gen), mesh)
            del p32, main, params
            torch.cuda.empty_cache()
            out[f"{arch} on a 1x1 mesh"] = res
            stamp(f"phase 16 {arch} done")

        # -- phase 14's trained mamba2-130m, adopted on its mesh ----------
        arch = MESH_LM["arch"]
        cfg = get_config(arch)
        eng, state, host = (HANDOFF.pop(k) for k in ("engine", "state",
                                                       "host"))
        reqs = lambda: requests_of(cfg.vocab_size, STEP_LENS, 32)
        adopted = serve_once(cfg, dev, None, bf16,
                             {"adopt": (eng, state)}, reqs())
        check_tokens(cfg, "adopted", adopted, reqs())
        del eng, state
        like = tfm.model_params(cfg, lambda *a: None)
        tree = unflatten({k: v[0] for k, v in host.params.items()}, like)
        one = serve_once(cfg, dev, tree, bf16, {}, reqs())
        print_run(f"{arch} (adopted on the 1x1 mesh)", "whole", adopted)
        row = mesh_against_one(f"{arch} trained (fsdp rules)", "whole",
                               adopted, one, MESH_ARCHS_LAUNCHES[arch]["whole"])
        del host, tree
        torch.cuda.empty_cache()
        out[f"{arch} adopted on a 1x1 mesh"] = {
            "launches": {"whole": adopted["launches"]}, "profile": None,
            "runs": {"whole": row}}
    finally:
        dist.destroy_process_group()
    print("  " + json.dumps({k: {kk: vv for kk, vv in v.items()
                                 if kk != "profile"} for k, v in out.items()}))
    return out


# phase 17: the drivers' main() at their defaults (train_lm at its full
# config, cut to DRIVER_LM_STEPS steps), and each one's launches, from
# scripts/drivers_rehearsal.py: exact for the three training drivers (a
# Dom-ST step 1 Pix-Con, with Pix-Con, and 60 LSTM steps, 24 steps a
# variant and one held-out forward; the quickstart 300 steps and one; a
# mamba2 step 48 conv1d and 48 SSD chunks under remat); the served
# drivers' counts follow their streams (spec acceptance), so None: more
# than 0. A kernel not named: 0. serve_lm's demo admits every prompt in
# 8-token chunks, so no whole prefill, no local_attn or ssd_chunk launch.
DRIVER_LM_STEPS = 20
DRIVER_LAUNCHES = {"train_flood": {"pixcon": 25, "lstm_cell": 3000},
                   "quickstart": {"pixcon": 301, "lstm_cell": 18060},
                   "train_lm": {"conv1d": 48 * DRIVER_LM_STEPS,
                                "ssd_chunk": 48 * DRIVER_LM_STEPS},
                   "serve_lm": {"paged_attn": None, "conv1d": None},
                   "ci_smoke": {"paged_attn": None}}


def losses_fall(what: str, losses) -> None:
    """Every loss finite, and the mean of the last quarter of the steps
    (at least one) below the first step's, over the replicas."""
    import numpy as np
    a = np.asarray(losses, dtype=np.float64)
    a = a.reshape(len(a), -1).mean(axis=1)
    check(bool(np.isfinite(a).all()), f"{what}: a loss is not finite")
    tail = a[-max(len(a) // 4, 1):].mean()
    print(f"    {what}: loss {a[0]:.4f} at the first step, {tail:.4f} over "
          f"the last {max(len(a) // 4, 1)}")
    check(tail < a[0], f"{what}: losses did not fall ({a[0]} -> {tail})")


def drivers_main_path(dev) -> dict:
    """Phase 17. The user-facing drivers' ``main()`` on the card, each
    with the launch counts set to 0 just before it and read just after:
    ``examples/train_flood_torch.py`` at its defaults (23 watersheds x 400
    days, 6 epochs, Dom-ST then Singlehead; the per-watershed NSE and
    Dom-ST's share of wins printed, the share not gated),
    ``quickstart_torch.py`` at its defaults (300 steps through
    ``domst.make_train_step``), ``train_lm_torch.py --full`` for
    ``DRIVER_LM_STEPS`` steps, ``serve_lm_torch.py`` (five families and
    the shared-prefix workload), then ``scripts/ci_smoke_torch.py``'s four
    checks in-process with their own assertions. Every loss and NSE
    finite, both variants' training losses and the quickstart's falling,
    the launches as ``DRIVER_LAUNCHES`` has them."""
    import numpy as np
    for sub in ("examples", "scripts"):
        if str(ROOT / sub) not in sys.path:
            sys.path.insert(0, str(ROOT / sub))
    import ci_smoke_torch
    import quickstart_torch
    import serve_lm_torch
    import train_flood_torch
    import train_lm_torch
    obs_dir = ROOT / "build" / "chip_smoke" / "obs"
    runs = {
        "train_flood": lambda: train_flood_torch.main([]),
        "quickstart": lambda: quickstart_torch.main([]),
        "train_lm": lambda: train_lm_torch.main(
            ["--full", "--steps", str(DRIVER_LM_STEPS)]),
        "serve_lm": lambda: serve_lm_torch.main([]),
        "ci_smoke": lambda: {cmd: ci_smoke_torch.main(
            ["--device", "cuda", cmd]
            + (["--out-dir", str(obs_dir)] if cmd == "obs" else []),
            run=ci_smoke_torch.run_in_process)
            for cmd in ci_smoke_torch.CHECKS},
    }
    out = {"launches": {}, "wall_s": {}}
    for name, run in runs.items():
        reset_launches()
        t0 = time.perf_counter()
        res = run()
        out["wall_s"][name] = round(time.perf_counter() - t0, 3)
        got = out["launches"][name] = read_launches()
        print(f"  {name}: {out['wall_s'][name]} s, launches {got}")
        for k, c in got.items():
            want = DRIVER_LAUNCHES[name].get(k, 0)
            check(c > 0 if want is None else c == want,
                  f"{name}: {c} {k} launches, want "
                  f"{'> 0' if want is None else want}")
        out[name] = res
    flood = out["train_flood"]
    for variant in ("domst", "domst-singlehead"):
        nse = np.asarray(flood[variant]["nse"])
        check(len(nse) == WATERSHEDS and bool(np.isfinite(nse).all()),
              f"train_flood {variant}: NSE {nse}")
        losses_fall(f"train_flood {variant}", flood[variant]["losses"])
    q = out["quickstart"]
    check(bool(np.isfinite(q["nse"])), f"quickstart: NSE {q['nse']}")
    losses_fall("quickstart", q["losses"])
    lm = out["train_lm"]["losses"]
    check(len(lm) == DRIVER_LM_STEPS and bool(np.isfinite(lm).all()),
          f"train_lm: losses {lm}")
    for part in out["serve_lm"].values():
        for arch, r in part.items():
            check(r["tokens"] > 0 and r["device"] != "cpu",
                  f"serve_lm {arch}: {r['tokens']} tokens on {r['device']}")
    summary = {
        "wall_s": out["wall_s"], "launches": out["launches"],
        "nse": {v: [round(x, 6) for x in flood[v]["nse"]]
                for v in ("domst", "domst-singlehead")},
        "domst_win_share": flood["win_share"],
        "quickstart_nse": round(q["nse"], 6),
        "train_lm_loss": [round(lm[0], 4), round(lm[-1], 4)],
        "prefix_hit_tokens": {a: r["prefix_hit_tokens"] for a, r in
                              out["serve_lm"]["shared_prefix"].items()},
        "ci_smoke": out["ci_smoke"]}
    print("  " + json.dumps(summary))
    return out


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
# name ptxas reports; the two attention kernels at bf16, D=256 (local
# attention without and with the softcap), and every instantiation of the
# SSD chunk's bf16 kernel (one per k-step count)
BF16_D256 = "I13__nv_bfloat16Li256E"      # template arguments <bf16, 256, ...>
NO_SPILL = {"local_attn": tuple("local_attn_mma_kernel" + BF16_D256 + cap
                               for cap in ("Lb0E", "Lb1E")),
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
    # torch.compile's caches inside the checkout, and no compile workers
    for var, path in (("TORCHINDUCTOR_CACHE_DIR", "build/inductor"),
                      ("TRITON_CACHE_DIR", "build/triton")):
        os.environ.setdefault(var, str(ROOT / path))
    os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
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
    check_training_functions(g, dev, kernels)
    library_at_training_shapes(dev, kernels)
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
    for n, arch in ((6, "recurrentgemma-2b"), (7, "mamba2-130m"),
                    (8, "gemma2-2b")):
        print(f"[{n}] main path: paged serving, {arch} (at {time.perf_counter() - T_START:.0f} s)")
        by_model[arch] = served_main_path(arch, dev)
    for arch in DENSE_ARCHS:
        print(f"[9] main path: paged serving, {arch}, whole prefill (at {time.perf_counter() - T_START:.0f} s)")
        by_model[arch] = dense_main_path(arch, dev)
    print(f"[10] main path: serving policies, qwen2-1.5b and recurrentgemma-2b (at {time.perf_counter() - T_START:.0f} s)")
    by_model["policies"] = policy_main_path(dev)
    print(f"[11] main path: MoE serving, qwen3-moe-30b-a3b and deepseek-moe-16b (at {time.perf_counter() - T_START:.0f} s)")
    by_model.update(moe_main_path(dev))
    print(f"[12] main path: LM training, recurrentgemma-2b and mamba2-130m (at {time.perf_counter() - T_START:.0f} s)")
    by_model.update(lm_training_main_path(dev))
    print(f"[13] main path: front ends and the contribution gate, internvl2-2b served, hubert-xlarge and internvl2-2b trained (at {time.perf_counter() - T_START:.0f} s)")
    by_model.update(frontend_main_path(dev))
    print(f"[14] distribution on a 1x1 mesh: domst stacked training and the forecast, mamba2-130m with FSDP rules (at {time.perf_counter() - T_START:.0f} s)")
    mesh = distribution_main_path(dev)
    for name, path in (("pixcon", "training"), ("lstm_cell", "training")):
        by_path[name]["mesh_training"] = \
            mesh["domst training"]["launches"][name]
        by_path[name]["mesh_forecast"] = \
            mesh["domst forecast"]["launches"][name]
        launches[name] += (mesh["domst training"]["launches"][name]
                           + mesh["domst forecast"]["launches"][name])
    by_model.update({k: v for k, v in mesh.items()
                     if not k.startswith("domst")})
    print(f"[15] serving on a 1x1 mesh: qwen2-1.5b, one wave in three modes, on and off the mesh (at {time.perf_counter() - T_START:.0f} s)")
    by_model["qwen2-1.5b on a 1x1 mesh"] = {
        k: v for k, v in serving_mesh_main_path(dev).items()
        if k in ("launches", "profile")}
    print(f"[16] serving on a 1x1 mesh: mamba2-130m in three modes, deepseek-moe-16b whole, and phase 14's trained mamba2-130m adopted by from_train_state (at {time.perf_counter() - T_START:.0f} s)")
    by_model.update({k: {kk: v[kk] for kk in ("launches", "profile")}
                     for k, v in serving_mesh_archs_main_path(dev).items()})
    print(f"[17] the drivers: train_flood (Dom-ST and Singlehead, 23 watersheds x 400 days), quickstart, train_lm --full, serve_lm, ci_smoke_torch (at {time.perf_counter() - T_START:.0f} s)")
    drivers = drivers_main_path(dev)["launches"]
    for res in by_model.values():
        for counts in res["launches"].values():
            for name, c in counts.items():
                if name not in ("pixcon", "lstm_cell"):
                    launches[name] = launches.get(name, 0) + c
    for k in kernels:
        by_driver = {d: c[k["name"]] for d, c in drivers.items()
                     if c[k["name"]]}
        k["launches"] = launches[k["name"]] + sum(by_driver.values())
        check(k["launches"] > 0, f"{k['name']} was not launched on the main path")
        k.setdefault("launches_by_path", {})["drivers"] = by_driver
        if k["name"] in device_ms:
            k["device_ms_per_launch_on_main_path"] = device_ms[k["name"]]
            k["launches_by_path"].update(by_path[k["name"]])
            k["training"]["device_ms_per_launch_on_main_path"] = \
                train["device_ms"][k["name"]]
            continue
        k["launches_by_mode"] = {
            arch: {mode: c[k["name"]] for mode, c in res["launches"].items()}
            for arch, res in by_model.items()
            if any(c[k["name"]] for c in res["launches"].values())}
        k["device_ms_per_launch_on_main_path"] = {
            arch: device_ms_per_launch(res["profile"]).get(k["name"])
            for arch, res in by_model.items()
            if arch in k["launches_by_mode"] and res["profile"]}
    print(f"[18] all phases passed in {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
