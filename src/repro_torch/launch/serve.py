"""Serving launcher: the Dom-ST forecast and paged LM serving.

Two modes, as in the reference's ``repro/launch/serve.py``:

  * ``--arch domst*`` — the stacked multi-watershed params, from the
    port's own init or the ``params`` subtree of a checkpoint that either
    package's training launcher wrote (``--ckpt``, stacked mode; optimizer
    moments are never loaded), roll forward day by day over the held-out forcing
    windows through :class:`Forecaster`, reporting per-watershed NSE
    against observed discharge;
  * a decoder — dense (``--arch qwen2-1.5b``), RG-LRU/local-attention
    hybrid (``--arch recurrentgemma-2b``) or SSM (``--arch mamba2-130m``),
    ``--smoke`` for the reduced variant — continuous batching over the paged
    :class:`InferenceEngine` through the :class:`Scheduler`: one
    whole-prompt prefill per request (or ``--prefill-chunk N`` tokens at a
    time, interleaved with decode steps), one fused all-slot decode step
    per token, or with ``--spec-k K`` one verify step over K drafts from
    the n-gram drafter. Params come from the port's init (``--seed``);
    greedy decoding only. It prints the reference's JSON keys that this
    slice fills, and the device.

Runs on the card unless ``--device cpu`` is given; without a card it
raises.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch domst
  PYTHONPATH=src python -m repro_torch.launch.serve --arch domst \\
      --watersheds 2 --days 150 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch domst \\
      --ckpt run.npz      # written by repro_torch.launch.train --ckpt
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --requests 8 --prompt-len 512 --ragged --gen 64 --prefill-chunk 128
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-2b --requests 4 --prompt-len 512 --ragged --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
      --smoke --device cpu --prefill-chunk 3 --spec-k 3
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.checkpoint import restore_subtree
from repro_torch.configs import get_config, list_configs, smoke_variant
from repro_torch.core import domst
from repro_torch.data.pipeline import make_domst_windows, stacked_test_batch
from repro_torch.device import device_name
from repro_torch.models import transformer as tfm
from repro_torch.obs import (
    MetricRegistry, Tracer, derive_request_metrics, percentiles,
)
from repro_torch.serve import (
    InferenceEngine, NgramDrafter, Request, Scheduler, stream_digest,
)
from repro_torch.serve.forecast import Forecaster


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_domst(args) -> dict:
    cfg = get_config(args.arch)
    fc = Forecaster(cfg, device=args.device)
    windows = make_domst_windows(args.watersheds, args.days)
    params = domst.init(cfg, torch.Generator().manual_seed(args.seed),
                        len(windows))
    if args.ckpt:
        # params subtree of the full training state either trainer saved
        params = restore_subtree(args.ckpt, params, prefix="params")
    held = stacked_test_batch(windows)
    params = fc.place_params(params)
    placed = fc.place_batch(held)
    fc.forecast(params, placed)          # warm-up: builds and loads kernels
    _sync(fc.device)
    t0 = time.perf_counter()
    res = fc.forecast(params, placed)
    _sync(fc.device)
    wall = time.perf_counter() - t0
    nses = [round(float(x), 6) for x in res["nse"].cpu().numpy()]
    horizon = int(held["discharge"].shape[1])
    out = {"arch": cfg.name, "watersheds": len(windows),
           "horizon_days": horizon, "restored": bool(args.ckpt),
           "nse": nses, "mean_nse": round(float(np.mean(nses)), 6),
           "wall_s": round(wall, 3),
           "forecasts_per_s": round(len(windows) * horizon / wall, 1),
           "device": device_name(fc.device)}
    print(json.dumps(out))
    return out


def make_requests(cfg, args) -> list:
    """Deterministic synthetic request queue (ragged lengths if asked),
    drawn as the reference's launcher draws it."""
    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        n = args.prompt_len
        if args.ragged:
            n = max(4, args.prompt_len - (i % 4) * 2)
        reqs.append(Request(
            rid=i, max_new=args.gen,
            prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32)))
    return reqs


def serve_lm(args) -> dict:
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    reqs = make_requests(cfg, args)
    max_len = args.max_len or max(len(r.prompt) + r.max_new for r in reqs)
    engine = InferenceEngine(cfg, slots=args.batch_size, max_len=max_len,
                             page_size=args.page_size,
                             num_pages=args.num_pages or None,
                             prefill_chunk=args.prefill_chunk,
                             device=args.device)
    gen = torch.Generator(device=engine.device).manual_seed(args.seed)
    state = engine.init_state(tfm.init(cfg, gen))
    registry, tracer = MetricRegistry(), Tracer()
    sched = Scheduler(engine, state,
                      eos_id=args.eos if args.eos >= 0 else None,
                      spec_k=args.spec_k,
                      drafter=NgramDrafter() if args.spec_k else None,
                      registry=registry, tracer=tracer)
    _sync(engine.device)
    t0 = time.perf_counter()
    generated = sched.run(reqs)
    _sync(engine.device)
    wall = time.perf_counter() - t0
    total_tokens = sum(len(g) for g in generated.values())
    st = sched.stats
    ttft = [m["ttft_s"] for m in derive_request_metrics(tracer.events()).values()]
    ttft_pct = percentiles(ttft) if ttft else {"p50": 0.0, "p99": 0.0}
    gap_p99 = sched.decode_gaps.quantile(99) \
        if sched.decode_gaps.count else 0.0
    out = {"arch": cfg.name, "requests": len(generated),
           "tokens": total_tokens, "wall_s": round(wall, 3),
           "tok_per_s": round(total_tokens / wall, 1),
           "prefill_tok_per_s": round(
               st["prefill_tokens"] / max(st["prefill_s"], 1e-9), 1),
           "decode_tok_per_s": round(
               st["decode_tokens"] / max(st["decode_s"], 1e-9), 1),
           "paged": True, "page_size": engine.page_size,
           "num_pages": engine.num_pages,
           "prefill_chunk": engine.prefill_chunk,
           "prefill_chunks": st["prefill_chunks"],
           "spec_k": args.spec_k,
           "drafter": "ngram" if args.spec_k else None,
           "spec_steps": st["spec_steps"],
           "spec_proposed": st["spec_proposed"],
           "spec_accepted": st["spec_accepted"],
           "accepted_tok_per_step": round(
               st["decode_tokens"] / max(st["decode_slot_steps"], 1), 3),
           "stream_digest": stream_digest(generated),
           "ttft_p50_s": round(ttft_pct["p50"], 6),
           "ttft_p99_s": round(ttft_pct["p99"], 6),
           "decode_gap_p99_s": round(gap_p99, 6),
           "max_decode_gap_s": round(st["max_decode_gap_s"], 6),
           "device": device_name(engine.device)}
    print(json.dumps(out))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    help=f"one of {', '.join(list_configs())}")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    ap.add_argument("--seed", type=int, default=0)
    dom = ap.add_argument_group("Dom-ST forecast")
    dom.add_argument("--ckpt", default="",
                     help="npz checkpoint whose 'params/...' entries to serve")
    dom.add_argument("--watersheds", type=int, default=23)
    dom.add_argument("--days", type=int, default=400)
    lm = ap.add_argument_group("LM serving")
    lm.add_argument("--smoke", action="store_true",
                    help="the arch's reduced smoke-test variant")
    lm.add_argument("--requests", type=int, default=8)
    lm.add_argument("--batch-size", type=int, default=4,
                    help="decode slots (continuous-batching width)")
    lm.add_argument("--prompt-len", type=int, default=24)
    lm.add_argument("--gen", type=int, default=16)
    lm.add_argument("--ragged", action="store_true",
                    help="vary prompt lengths across the request queue")
    lm.add_argument("--max-len", type=int, default=0,
                    help="cache length (0 = longest prompt + gen)")
    lm.add_argument("--page-size", type=int, default=16,
                    help="paged KV cache page size in tokens")
    lm.add_argument("--num-pages", type=int, default=0,
                    help="page-pool size (0 = slots * ceil(max_len/page))")
    lm.add_argument("--prefill-chunk", type=int, default=0,
                    help="insert prompts this many tokens at a time, "
                         "interleaved with decode steps (0 = whole prompt)")
    lm.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: verify up to K n-gram "
                         "drafts per slot per step (0 = off); greedy "
                         "streams are the same either way")
    lm.add_argument("--eos", type=int, default=-1,
                    help="token id ending a request early (-1 = off)")
    args = ap.parse_args(argv)
    if args.arch.startswith("domst"):
        return serve_domst(args)
    if args.arch not in list_configs():
        ap.error(f"--arch {args.arch}: not ported yet (ROADMAP Queue A); "
                 f"the port serves {', '.join(list_configs())}")
    return serve_lm(args)


if __name__ == "__main__":
    main()
