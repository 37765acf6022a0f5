"""Training launcher: Dom-ST multi-watershed training and LM training
on one device, or on the reference's production mesh.

The reference's ``repro/launch/train.py``, through the port's engine
(``repro_torch/train/``) fed by the prefetching loader
(``repro_torch/data/loader.py``, the paper's I.P. in Fig. 2a):

  * ``--mode stacked`` (IP-D) — one replica per watershed on a leading
    axis, all updated by one step;
  * ``--mode sequential`` — one watershed at a time, each its own state;
  * any LM arch (``--smoke`` for its reduced variant) —
    ``Engine.for_lm`` on the synthetic token stream
    (``data/tokens.py::TokenSource``), AdamW with block remat as the
    reference's ``train_lm`` sets it, bf16 activations over float32
    params and moments, the step donated (updated in place). On the card
    the conv1d, SSD-chunk and local-attention kernels run the forward and
    autograd through their plain versions the backward. It prints the
    reference's step lines, the peak device memory
    (``torch.cuda.max_memory_allocated``) and the reference's final JSON
    record. hubert-xlarge trains on frames (the audio stub, an encoder
    with no causal mask) and internvl2-2b on patches before the text
    (the vision stub): ``--seq-len`` counts every position, so
    internvl2-2b's text is ``--seq-len`` less its 256 patches long, and a
    ``--seq-len`` that leaves no text is refused.

On the card each step's forward runs the Pix-Con and LSTM-step kernels
and its backward runs autograd through their plain versions. Every
``--eval-interval`` steps the engine evaluates the live state on the
held-out tail of every watershed (per-watershed NSE).

``--ckpt``/``--resume`` round-trip the full training state (params,
optimizer moments, step counter, rng leaf) in the reference's npz layout,
so either package resumes or serves the other's checkpoint. The restored
step counter is the loader's stream cursor, so a resumed run continues
the batch stream where it stopped, mid-epoch included. The same file is
the hand-off into serving: ``repro_torch.launch.serve --ckpt`` restores
its params.

``--mesh host`` (the default) is the one-device path. ``--mesh pod`` or
``multipod`` lays the reference's (16, 16) ("data", "model") or
(2, 16, 16) ("pod", "data", "model") mesh over a ``torchrun`` world of
256 or 512 ranks (``launch/mesh.py``; it raises on a smaller world): the
engine places the state and the batches by the rule table, the
watersheds on the data axes, and every rank prints the same record.

It prints the reference's per-epoch lines and final JSON record, plus the
device. Runs on the card unless ``--device cpu`` is given; without a card
it raises. ``--profile-dir DIR`` writes a ``torch.profiler`` trace of
the run to ``DIR/trace.json``. A run records into a registry of its own
(the process's default while it runs, so the engine, its loader and the
kernel builds record there too), with the spans switched on
(``obs.profiler.recording``): ``--metrics-out`` dumps it.

  PYTHONPATH=src python -m repro_torch.launch.train --arch domst
  PYTHONPATH=src python -m repro_torch.launch.train --arch domst \\
      --watersheds 2 --days 150 --epochs 1 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch domst \\
      --mode stacked --accum-steps 4 --ckpt run.npz
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --smoke --steps 3 --batch-size 4 --seq-len 32 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch recurrentgemma-2b --batch-size 2 --seq-len 2560 --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch hubert-xlarge \\
      --batch-size 4 --seq-len 1024 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-2b \\
      --smoke --steps 3 --batch-size 2 --seq-len 24 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs import (
    TrainConfig, get_config, list_configs, smoke_variant,
)
from repro_torch.convert import flatten
from repro_torch.core import domst
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.pipeline import (
    InputPipeline, StackedSource, WatershedSource, make_domst_windows,
    stacked_test_batch, train_split, train_test_split,
)
from repro_torch.data.tokens import TokenSource, synthetic_token_batch
from repro_torch.device import device_name
from repro_torch.distributed.sharding import full_host
from repro_torch.metrics import Meter
from repro_torch.models import transformer as tfm
from repro_torch.obs import MetricRegistry, profiler
from repro_torch.obs import registry as obs_registry
from repro_torch.train import Engine

# the held-out batch's seed offset, the reference's
EVAL_SEED_OFFSET = 2**31


def _recorded(train):
    """``train(args, registry)`` as ``train(args)``, with a new registry
    as the process's default and the spans recording for the run."""
    @functools.wraps(train)
    def run(args):
        registry = MetricRegistry()
        with obs_registry.as_default(registry), profiler.recording():
            return train(args, registry)
    return run


def _timed(loader, registry: MetricRegistry):
    """Iterate ``loader`` while measuring, per step, the wall clock of the
    loop body (``train.step_s``: dispatch plus whatever sync the body
    does). The wait for each batch is the loader's own
    ``loader.wait_s``: nonzero means the step outran the prefetch."""
    step_h = registry.histogram("train.step_s")
    for batch in loader:
        t = time.perf_counter()
        yield batch
        step_h.record(time.perf_counter() - t)


def _train_metrics(registry: MetricRegistry) -> dict:
    """Step-timing summary for the result JSON (empty before any step)."""
    step_h = registry.histogram("train.step_s")
    wait_h = registry.histogram("loader.wait_s")
    if not step_h.count:
        return {}
    return {"step_p50_s": round(step_h.quantile(50), 6),
            "step_p99_s": round(step_h.quantile(99), 6),
            "loader_wait_p99_s": round(wait_h.quantile(99), 6),
            "loader_wait_s": round(wait_h.sum, 6)}


def _make_mesh(name: str, device: str):
    """``--mesh``: None for ``host`` (one device); the production mesh over
    the ``torchrun`` world (its process group started from the launcher's
    environment) for ``pod`` / ``multipod``."""
    if name == "host":
        return None
    from repro_torch.launch.mesh import make_production_mesh
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not torch.distributed.is_initialized():
        torch.distributed.init_process_group(
            "nccl" if torch.device(device).type == "cuda" else "gloo")
    return make_production_mesh(multi_pod=name == "multipod", device=device)


def _init(cfg, seed: int, replicas: int) -> domst.Params:
    return domst.init(cfg, torch.Generator().manual_seed(seed), replicas)


@_recorded
def train_domst(args, registry) -> dict:
    cfg = get_config(args.arch)
    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps or 2000,
                     warmup_steps=50, grad_accum=args.accum_steps,
                     seed=args.seed)
    windows = make_domst_windows(args.watersheds, args.days)
    # train only on the leading split; the tail that eval_step scores
    # (stacked_test_batch / train_test_split) stays held out
    ip = InputPipeline([train_split(w) for w in windows],
                       batch_size=args.batch_size, seed=args.seed)
    meter = Meter(registry=registry, prefix="train.")
    t0 = time.perf_counter()        # wall_s: from here, as before recording

    mesh = _make_mesh(args.mesh, args.device)

    def engine_for(tc, stacked):
        return Engine.for_domst(cfg, tc, stacked=stacked, device=args.device,
                                mesh=mesh)

    if args.mode == "stacked":          # IP-D: all watersheds per step
        engine = engine_for(tc, True)
        state = engine.init_state(_init(cfg, args.seed, len(windows)))
        start = 0
        if args.resume:
            state = engine.restore(args.resume, state)
            start = int(state.step)
            # continue the run, don't replay it: the loader cursor picks
            # the shuffled stream back up at the restored step (mid-epoch
            # included) and the schedule horizon extends past it (else
            # post-warmup LR decays to 0 immediately)
            tc = dataclasses.replace(tc, total_steps=start + tc.total_steps)
            engine = engine_for(tc, True)
        source = StackedSource(ip)
        spe = source.steps_per_epoch
        held_out = engine.place_batch(stacked_test_batch(windows))
        loader = ShardedLoader(source, engine, prefetch=args.prefetch,
                               start_step=start,
                               num_steps=args.epochs * spe)
        for batch in _timed(loader, registry):
            state, m = engine.step(state, batch)
            step = loader.cursor
            if args.eval_interval and step % args.eval_interval == 0:
                ev = engine.eval_step(state, held_out)
                print(f"step {step} eval mean NSE "
                      f"{float(np.mean(full_host(ev['nse']))):.4f}", flush=True)
            if step % spe == 0:         # epoch boundary
                meter.update(loss=float(np.mean(full_host(m["loss"]))))
                print(f"epoch {step // spe - 1} mean loss "
                      f"{meter.last('loss'):.4f} "
                      f"({time.perf_counter() - t0:.1f}s)", flush=True)
        ev = engine.eval_step(state, held_out)
        nses = [float(x) for x in full_host(ev["nse"])]
    else:                               # sequential: one watershed at a time
        if args.resume or args.ckpt:
            raise SystemExit(
                "--ckpt/--resume are not supported with --mode sequential "
                "(that mode trains one TrainState per watershed); use "
                "--mode stacked to checkpoint or resume a run")
        engine = engine_for(tc, False)
        nses = []
        for w, tw in zip(windows, ip.windows):   # tw: the train split of w
            state = engine.init_state(
                _init(cfg, args.seed * 1_000_003 + w.watershed_id, 1))
            source = WatershedSource(ip, tw)
            loader = ShardedLoader(
                source, engine, prefetch=args.prefetch,
                num_steps=args.epochs * source.steps_per_epoch)
            for batch in _timed(loader, registry):
                state, m = engine.step(state, batch)
            _, te = train_test_split(w)
            ev = engine.eval_step(state, engine.place_batch(te))
            nses.append(float(full_host(ev["nse"])))
            print(f"watershed {w.watershed_id} loss "
                  f"{float(full_host(m['loss'])):.4f} "
                  f"nse {nses[-1]:.4f} ({time.perf_counter() - t0:.1f}s)",
                  flush=True)

    result = {"arch": args.arch, "mode": args.mode,
              "accum_steps": args.accum_steps, "prefetch": args.prefetch,
              "mean_nse": float(np.mean(nses)), "nse": nses,
              "wall_s": time.perf_counter() - t0, **_train_metrics(registry),
              "device": device_name(engine.device)}
    print(json.dumps(result, indent=2))
    if args.metrics_out:
        registry.dump_jsonl(args.metrics_out)
    if args.ckpt:                       # stacked only (guarded above)
        engine.save(args.ckpt, state)   # the full multi-replica state
        print("saved", args.ckpt)
    return result


@_recorded
def train_lm(args, registry):
    """LM training as the reference's ``train_lm``; returns (the printed
    record, the engine, the final state): the live state is the
    train-to-serve hand-off (``InferenceEngine.from_train_state``)."""
    if args.arch not in list_configs():
        raise SystemExit(f"--arch {args.arch}: unknown; one of "
                         f"{', '.join(list_configs())}")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if args.seq_len <= cfg.num_patches:
        raise SystemExit(
            f"--seq-len {args.seq_len} leaves no text after {cfg.name}'s "
            f"{cfg.num_patches} image patches: it counts the patches too")
    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1), remat="block",
                     grad_accum=args.accum_steps, seed=args.seed)
    mesh = _make_mesh(args.mesh, args.device)
    engine = Engine.for_lm(cfg, tc, device=args.device, mesh=mesh)
    dev = engine.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = tfm.init(cfg, torch.Generator(device=dev).manual_seed(args.seed))
    n_params = sum(t.numel() for t in flatten(params).values())
    print(f"{cfg.name}: {n_params / 1e6:.1f}M params", flush=True)
    state = engine.init_state(params)
    del params
    start = 0
    if args.resume:
        state = engine.restore(args.resume, state)
        start = int(state.step)
        # continue, don't replay: the loader resumes the token stream at
        # the restored step and the schedule horizon extends past it
        tc = dataclasses.replace(tc, total_steps=start + args.steps)
        engine = Engine.for_lm(cfg, tc, device=dev, mesh=mesh)

    source = TokenSource(cfg, args.batch_size, args.seq_len, seed=args.seed)
    if args.eval_interval:
        held_out = engine.place_batch(synthetic_token_batch(
            cfg, args.batch_size, args.seq_len,
            seed=args.seed + EVAL_SEED_OFFSET))
    loader = ShardedLoader(source, engine, prefetch=args.prefetch,
                           start_step=start, num_steps=args.steps)
    meter = Meter(registry=registry, prefix="train.")
    t0 = time.perf_counter()        # wall_s: from here, as before recording
    losses = []
    for batch in _timed(loader, registry):
        state, m = engine.step(state, batch)
        losses.append(float(full_host(m["loss"])))
        i = loader.cursor - start - 1
        if args.eval_interval and loader.cursor % args.eval_interval == 0:
            ev = engine.eval_step(state, held_out)
            print(f"step {loader.cursor} eval loss "
                  f"{float(full_host(ev['loss'])):.4f}", flush=True)
        if i % max(args.steps // 10, 1) == 0:
            print(f"step {i:5d} loss {losses[-1]:.4f} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    print("peak memory " + (f"{peak / 1e9:.3f} GB (max_memory_allocated)"
                            if peak is not None else "not measured (cpu)"),
          flush=True)
    result = {"arch": cfg.name, "first_loss": losses[0],
              "last_loss": losses[-1], "steps": int(state.step),
              "prefetch": args.prefetch, "wall_s": time.perf_counter() - t0,
              **_train_metrics(registry), "params": n_params,
              "tokens_per_step": args.batch_size * args.seq_len,
              "peak_memory_bytes": peak, "device": device_name(dev)}
    print(json.dumps(result))
    if args.metrics_out:
        registry.dump_jsonl(args.metrics_out)
    if args.ckpt:
        engine.save(args.ckpt, state)
        print("saved", args.ckpt)
    return result, engine, state


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="an LM arch's reduced variant (configs/smoke.py)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    ap.add_argument("--steps", type=int, default=100,
                    help="the learning-rate schedule's horizon in steps")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=128,
                    help="LM positions a sequence: tokens, audio frames, "
                         "or a VLM's image patches and text tokens")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--watersheds", type=int, default=23)
    ap.add_argument("--days", type=int, default=400)
    ap.add_argument("--mode", choices=("stacked", "sequential"),
                    default="stacked")
    ap.add_argument("--mesh", choices=("host", "pod", "multipod"),
                    default="host",
                    help="host: one device; pod/multipod: the production "
                         "(16, 16) / (2, 16, 16) mesh over a torchrun world "
                         "of 256 / 512 ranks")
    ap.add_argument("--accum-steps", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="loader prefetch depth (batches placed on the "
                         "device ahead of the step; 0 = synchronous)")
    ap.add_argument("--eval-interval", type=int, default=0,
                    help="run Engine.eval_step on the held-out windows "
                         "every N steps (0 = final eval only)")
    ap.add_argument("--ckpt", default="",
                    help="save the full training state here after training")
    ap.add_argument("--resume", default="",
                    help="restore a training-state checkpoint before "
                         "training (the loader resumes the batch stream at "
                         "its step)")
    ap.add_argument("--metrics-out", default="",
                    help="dump the metric registry as JSONL (the loop "
                         "body's train.step_s, the engine.* and loader.* "
                         "spans and counters, kernels.* where a build ran, "
                         "metered loss)")
    ap.add_argument("--profile-dir", default="",
                    help="open a torch.profiler window around the run and "
                         "write its trace to DIR/trace.json")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train as the arguments say; returns the printed record."""
    args = parse_args(argv)
    with profiler.profile(args.profile_dir):
        if args.arch.startswith("domst"):
            return train_domst(args)
        return train_lm(args)[0]


if __name__ == "__main__":
    main()
