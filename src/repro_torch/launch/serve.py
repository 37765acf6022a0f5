"""Serving launcher: the Dom-ST forecast and paged LM serving.

Two modes, as in the reference's ``repro/launch/serve.py``:

  * ``--arch domst*`` — the stacked multi-watershed params, from the
    port's own init or the ``params`` subtree of a checkpoint that either
    package's training launcher wrote (``--ckpt``, stacked mode; optimizer
    moments are never loaded), roll forward day by day over the held-out forcing
    windows through :class:`Forecaster`, reporting per-watershed NSE
    against observed discharge;
  * a decoder — dense (``--arch qwen2-1.5b``, ``llama3.2-3b``,
    ``olmo-1b``, or ``gemma2-2b`` / ``gemma2-2b-localonly`` with their
    local layers and softcaps), mixture-of-experts (``--arch
    qwen3-moe-30b-a3b`` with QK norm, ``deepseek-moe-16b`` with shared
    experts and a dense first layer), RG-LRU/local-attention hybrid
    (``--arch recurrentgemma-2b``), SSM (``--arch mamba2-130m``) or the
    VLM (``--arch internvl2-2b``: each request brings its image as
    zero patch embeddings, as the reference's launcher sends them, and
    the cache length counts them), ``--smoke`` for the reduced variant —
    continuous batching over the paged
    :class:`InferenceEngine` through the :class:`Scheduler`: one
    whole-prompt prefill per request (or ``--prefill-chunk N`` tokens at a
    time, interleaved with decode steps), one fused all-slot decode step
    per token, or with ``--spec-k K`` one verify step over K drafts from
    the n-gram drafter or a draft model (``--drafter model``,
    ``--draft-config``, ``--draft-ckpt``). ``--prefix-cache`` serves
    shared prompt prefixes (``--shared-prefix N``) from cached pages,
    ``--host-cache-mb`` spills reclaimed cached pages to host memory and
    brings them back on a later hit, ``--preempt`` swaps a slot out to
    host memory under page pressure instead of deferring admission.
    ``--temperature/--top-k/--top-p/--rep-penalty/--sample-seed`` sample
    each request under its own seed (``--queue file.json`` sets them per
    request); the reference's PRNG, so the streams are its own. Params
    come from the port's init (``--seed``) or the ``params`` subtree of
    the reference's TrainState npz (``--ckpt``). It prints the first 12
    tokens of the first two requests (``req N: [...]...``, the lines the
    serve smoke checks compare), then one line of the reference's JSON
    keys, ``stream_digest`` among them, and the device;
    ``--trace-out``, ``--metrics-out`` and ``--profile-dir`` write the
    request spans, the metric registry and a ``torch.profiler`` trace.
    ``--arch hubert-xlarge`` exits with the reference's message: an
    encoder has no decode path.

Runs on the card unless ``--device cpu`` is given; without a card it
raises. ``serve(args)`` is the reference's dispatcher for callers that
build ``args`` themselves (``examples/serve_lm_torch.py``).

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
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch qwen3-moe-30b-a3b --smoke --device cpu --spec-k 3
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-2b \\
      --requests 4 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --smoke --device cpu --shared-prefix 16 \\
      --prefix-cache --preempt --temperature 0.8 --top-p 0.9 --spec-k 3
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
    MetricRegistry, Tracer, derive_request_metrics, percentiles, profiler,
)
from repro_torch.serve import (
    InferenceEngine, ModelDrafter, NgramDrafter, Request, SamplingParams,
    Scheduler, stream_digest,
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
    with profiler.profile(args.profile_dir):
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


def _sampling(args, rid: int, over: dict = None) -> SamplingParams:
    """Per-request sampling config: the CLI flags are the defaults, a
    queue entry may override any field. Request ``rid`` draws with seed
    ``--sample-seed + rid``, so one flag reproduces the whole run."""
    over = over or {}
    return SamplingParams(
        temperature=float(over.get("temperature", args.temperature)),
        top_k=int(over.get("top_k", args.top_k)),
        top_p=float(over.get("top_p", args.top_p)),
        rep_penalty=float(over.get("rep_penalty", args.rep_penalty)),
        seed=int(over.get("seed", args.sample_seed + rid)))


def load_queue(args) -> list:
    """``--queue file.json``: a JSON list of request dicts, each with
    ``prompt`` (token ids) and optionally ``max_new`` and any
    :class:`SamplingParams` field; unset fields take the CLI flags."""
    with open(args.queue) as f:
        entries = json.load(f)
    if not isinstance(entries, list):
        raise SystemExit(f"--queue {args.queue}: expected a JSON list")
    reqs = []
    for i, e in enumerate(entries):
        if "prompt" not in e:
            raise SystemExit(f"--queue entry {i}: missing 'prompt'")
        reqs.append(Request(
            rid=i, max_new=int(e.get("max_new", args.gen)),
            prompt=np.asarray(e["prompt"], np.int32),
            sampling=_sampling(args, i, e)))
    return reqs


def make_requests(cfg, args) -> list:
    """Deterministic synthetic request queue (ragged lengths if asked),
    drawn as the reference's launcher draws it. ``--shared-prefix N``
    makes the first N tokens of every prompt the same — the
    shared-system-prompt traffic the prefix cache serves."""
    if args.queue:
        return load_queue(args)
    rng = np.random.default_rng(args.seed)
    sp = max(0, min(args.shared_prefix, args.prompt_len - 1))
    prefix = rng.integers(0, cfg.vocab_size, sp).astype(np.int32)
    reqs = []
    for i in range(args.requests):
        n = args.prompt_len
        if args.ragged:
            n = max(4, args.prompt_len - (i % 4) * 2)
        extras = {}
        if cfg.family == "vlm":
            extras["patches"] = np.zeros(
                (cfg.num_patches, cfg.frontend_dim), np.float32)
        tail = rng.integers(0, cfg.vocab_size,
                            max(1, n - sp)).astype(np.int32)
        reqs.append(Request(
            rid=i, max_new=args.gen, extras=extras,
            prompt=np.concatenate([prefix, tail]) if sp else tail,
            sampling=_sampling(args, i)))
    return reqs


def make_drafter(args, cfg, engine):
    """The ``--drafter`` policy: prompt lookup, or a second model (by
    default the target's own config) on its own paged engine."""
    if not engine.paged:
        raise SystemExit("--spec-k > 0 requires the paged cache "
                         "(--page-size > 0); --spec-k 0 on the contiguous "
                         "layout is the parity baseline")
    if args.drafter == "ngram":
        return NgramDrafter()
    draft_cfg = get_config(args.draft_config or args.arch)
    if args.smoke:
        draft_cfg = smoke_variant(draft_cfg)
    if draft_cfg.vocab_size != cfg.vocab_size:
        raise SystemExit(
            f"draft model {draft_cfg.name} (vocab {draft_cfg.vocab_size}) "
            f"must share the target vocab ({cfg.vocab_size})")
    kw = dict(slots=engine.slots, max_len=engine.max_len + args.spec_k,
              page_size=engine.page_size, dtype=engine.dtype,
              seed=args.seed + 1, device=engine.device)
    if args.draft_ckpt:
        return ModelDrafter.from_checkpoint(draft_cfg, args.draft_ckpt, **kw)
    return ModelDrafter(draft_cfg, **kw)


def serve_lm(args) -> dict:
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if not cfg.supports_decode():
        raise SystemExit(f"{cfg.name} is encoder-only; no decode path")
    if args.host_cache_mb and not args.prefix_cache:
        raise SystemExit("--host-cache-mb is a spill tier FOR the prefix "
                         "cache; it requires --prefix-cache")
    reqs = make_requests(cfg, args)
    max_len = args.max_len or max(
        len(r.prompt) + r.max_new + (cfg.num_patches or 0) for r in reqs)
    engine = InferenceEngine(cfg, slots=args.batch_size, max_len=max_len,
                             paged=args.page_size > 0,
                             page_size=args.page_size or 16,
                             num_pages=args.num_pages or None,
                             prefill_chunk=args.prefill_chunk,
                             device=args.device)
    # drawn leaf by leaf in the engine's dtype: qwen3-moe-30b-a3b's float32
    # tree (122 GB) would not fit on one card
    params = tfm.init(cfg, torch.Generator(
        device=engine.device).manual_seed(args.seed), dtype=engine.dtype)
    if args.ckpt:
        params = engine.restore_params(args.ckpt, params)
    state = engine.init_state(params)
    drafter = make_drafter(args, cfg, engine) if args.spec_k else None
    if (args.prefix_cache or args.preempt) and not engine.paged:
        raise SystemExit("--prefix-cache/--preempt are page-pool policies; "
                         "they require the paged cache (--page-size > 0)")
    registry, tracer = MetricRegistry(), Tracer()
    sched = Scheduler(engine, state,
                      eos_id=args.eos if args.eos >= 0 else None,
                      spec_k=args.spec_k, drafter=drafter,
                      prefix_cache=args.prefix_cache, preempt=args.preempt,
                      host_cache_bytes=int(args.host_cache_mb * 2 ** 20),
                      registry=registry, tracer=tracer)
    _sync(engine.device)
    t0 = time.perf_counter()
    with profiler.profile(args.profile_dir):
        generated = sched.run(reqs)
        _sync(engine.device)
    wall = time.perf_counter() - t0
    total_tokens = sum(len(g) for g in generated.values())
    st = sched.stats
    ttft = [m["ttft_s"] for m in derive_request_metrics(tracer.events()).values()]
    ttft_pct = percentiles(ttft) if ttft else {"p50": 0.0, "p99": 0.0}
    gap_p99 = sched.decode_gaps.quantile(99) \
        if sched.decode_gaps.count else 0.0
    registry.gauge("serve.tok_per_s").set(total_tokens / wall)
    registry.gauge("serve.wall_s").set(wall)
    out = {"arch": cfg.name, "requests": len(generated),
           "tokens": total_tokens, "wall_s": round(wall, 3),
           "tok_per_s": round(total_tokens / wall, 1),
           "prefill_tok_per_s": round(
               st["prefill_tokens"] / max(st["prefill_s"], 1e-9), 1),
           "decode_tok_per_s": round(
               st["decode_tokens"] / max(st["decode_s"], 1e-9), 1),
           "paged": engine.paged, "page_size": engine.page_size,
           "num_pages": engine.num_pages,
           "prefill_chunk": engine.prefill_chunk,
           "prefill_chunks": st["prefill_chunks"],
           "spec_k": args.spec_k,
           "drafter": args.drafter if args.spec_k else None,
           "spec_steps": st["spec_steps"],
           "spec_proposed": st["spec_proposed"],
           "spec_accepted": st["spec_accepted"],
           # per slot-step: 1.0 is one token a fused step a slot
           "accepted_tok_per_step": round(
               st["decode_tokens"] / max(st["decode_slot_steps"], 1), 3),
           "sampled_requests": sum(
               1 for r in reqs if not r.sampling.greedy),
           "temperature": args.temperature, "top_k": args.top_k,
           "top_p": args.top_p, "rep_penalty": args.rep_penalty,
           "sample_seed": args.sample_seed,
           # two runs of the same (queue, params, seeds) print the same
           # digest, whatever the mode or policy
           "stream_digest": stream_digest(generated),
           "prefix_cache": args.prefix_cache, "preempt": args.preempt,
           "shared_prefix": args.shared_prefix,
           "prefix_hits": st["prefix_hits"],
           "prefix_hit_tokens": st["prefix_hit_tokens"],
           "prefix_hit_rate": round(
               st["prefix_hit_tokens"] / max(
                   st["prefix_hit_tokens"] + st["prefill_tokens"], 1), 3),
           "prefill_skipped_pct": round(
               100.0 * st["prefix_hit_tokens"]
               / max(sum(len(r.prompt) for r in reqs), 1), 2),
           "host_cache_mb": args.host_cache_mb,
           "host_hits": st["host_hits"],
           "host_hit_tokens": st["host_hit_tokens"],
           "host_restored_pages": st["host_restored_pages"],
           "host_spilled_pages": st["host_spilled_pages"],
           "host_evicted_pages": st["host_evicted_pages"],
           "cow_pages": st["cow_pages"],
           "preemptions": st["preemptions"], "restores": st["restores"],
           "deferred_admissions": st["deferred_admissions"],
           "max_defer_cycles": st["max_defer_cycles"],
           "ttft_p50_s": round(ttft_pct["p50"], 6),
           "ttft_p99_s": round(ttft_pct["p99"], 6),
           "decode_gap_p99_s": round(gap_p99, 6),
           "max_decode_gap_s": round(st["max_decode_gap_s"], 6),
           "device": device_name(engine.device)}
    for r in reqs[:2]:                   # before the JSON, which ends the run
        print(f"req {r.rid}: {[int(t) for t in r.generated[:12]]}...")
    print(json.dumps(out))
    if args.trace_out:
        tracer.save(args.trace_out)
    if args.metrics_out:
        registry.dump_jsonl(args.metrics_out)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True,
                    help=f"one of {', '.join(list_configs())}")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default="",
                    help="npz checkpoint whose 'params/...' entries to serve "
                         "(Dom-ST: either trainer's; LM: the reference's "
                         "TrainState layout)")
    ap.add_argument("--profile-dir", default="",
                    help="open a torch.profiler window around the run and "
                         "write its trace to DIR/trace.json; the engine's "
                         "steps are annotated")
    dom = ap.add_argument_group("Dom-ST forecast")
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
    lm.add_argument("--shared-prefix", type=int, default=0,
                    help="make the first N prompt tokens the same across "
                         "the queue (the shared-system-prompt workload the "
                         "prefix cache serves)")
    lm.add_argument("--queue", default="",
                    help="JSON file with the request queue: a list of "
                         "{prompt: [ids], max_new?, temperature?, top_k?, "
                         "top_p?, rep_penalty?, seed?}")
    lm.add_argument("--max-len", type=int, default=0,
                    help="cache length (0 = longest prompt + gen)")
    lm.add_argument("--page-size", type=int, default=16,
                    help="paged KV cache page size in tokens (0 = the "
                         "contiguous slot-major cache, the parity baseline)")
    lm.add_argument("--num-pages", type=int, default=0,
                    help="page-pool size (0 = slots * ceil(max_len/page))")
    lm.add_argument("--prefill-chunk", type=int, default=0,
                    help="insert prompts this many tokens at a time, "
                         "interleaved with decode steps (0 = whole prompt)")
    lm.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: verify up to K drafts per "
                         "slot per step (0 = off); streams are the same "
                         "either way")
    lm.add_argument("--drafter", choices=("ngram", "model"), default="ngram",
                    help="draft policy: prompt lookup, or a second model "
                         "(--draft-config) on its own paged engine")
    lm.add_argument("--draft-config", default="",
                    help="arch of the --drafter model (default: --arch; "
                         "must share the target vocab)")
    lm.add_argument("--draft-ckpt", default="",
                    help="TrainState .npz for the draft model's params "
                         "(params subtree only, like --ckpt)")
    lm.add_argument("--prefix-cache", action="store_true",
                    help="refcounted radix prefix cache over the page pool: "
                         "admissions map cached shared-prefix pages and "
                         "resume prefill at the divergence point")
    lm.add_argument("--host-cache-mb", type=float, default=0.0,
                    help="host-memory spill tier for the prefix cache, in "
                         "MiB (0 = off; requires --prefix-cache)")
    lm.add_argument("--preempt", action="store_true",
                    help="page-aware preemption: on page exhaustion swap "
                         "the youngest slot's pages to host and restore "
                         "them later, instead of deferring admission")
    lm.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    lm.add_argument("--top-k", type=int, default=0,
                    help="keep the k most likely tokens (0 = off)")
    lm.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling: keep the smallest mass >= p "
                         "(1.0 = off)")
    lm.add_argument("--rep-penalty", type=float, default=1.0,
                    help="repetition penalty on seen tokens (1.0 = off)")
    lm.add_argument("--sample-seed", type=int, default=0,
                    help="request i draws with seed sample-seed + i")
    lm.add_argument("--eos", type=int, default=-1,
                    help="token id ending a request early (-1 = off)")
    lm.add_argument("--trace-out", default="",
                    help="write the request-lifecycle spans as Chrome "
                         "trace-event JSON")
    lm.add_argument("--metrics-out", default="",
                    help="dump the metric registry as JSONL")
    return ap


def _dispatch(args: argparse.Namespace) -> dict:
    if args.arch.startswith("domst"):
        return serve_domst(args)
    return serve_lm(args)


def serve(args) -> dict:
    """The reference's dispatcher: ``args.arch`` starting with ``domst``
    goes to the forecast, anything else to LM serving. ``args`` may be any
    object with the CLI's fields (the reference's examples pass a plain
    class); a field it lacks takes the CLI's default (``device``:
    ``"cuda"``)."""
    defaults = vars(build_parser().parse_args(["--arch", args.arch]))
    return _dispatch(argparse.Namespace(**{k: getattr(args, k, v)
                                           for k, v in defaults.items()}))


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if not args.arch.startswith("domst") and args.arch not in list_configs():
        ap.error(f"--arch {args.arch}: unknown; one of "
                 f"{', '.join(list_configs())}")
    return _dispatch(args)


if __name__ == "__main__":
    main()
