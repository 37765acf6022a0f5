"""Training launcher: Dom-ST multi-watershed training on one device.

The reference's ``repro/launch/train.py`` in its Dom-ST modes, through
the port's engine (``repro_torch/train/``) fed by the prefetching loader
(``repro_torch/data/loader.py``, the paper's I.P. in Fig. 2a):

  * ``--mode stacked`` (IP-D) — one replica per watershed on a leading
    axis, all updated by one step;
  * ``--mode sequential`` — one watershed at a time, each its own state.

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

It prints the reference's per-epoch lines and final JSON record, plus the
device. Runs on the card unless ``--device cpu`` is given; without a card
it raises. LM training is not ported yet (ROADMAP Queue A).

  PYTHONPATH=src python -m repro_torch.launch.train --arch domst
  PYTHONPATH=src python -m repro_torch.launch.train --arch domst \\
      --watersheds 2 --days 150 --epochs 1 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch domst \\
      --mode stacked --accum-steps 4 --ckpt run.npz
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import TrainConfig, get_config
from repro_torch.core import domst
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.pipeline import (
    InputPipeline, StackedSource, WatershedSource, make_domst_windows,
    stacked_test_batch, train_split, train_test_split,
)
from repro_torch.device import device_name
from repro_torch.metrics import Meter
from repro_torch.obs import MetricRegistry
from repro_torch.train import Engine


def _timed(loader, registry: MetricRegistry):
    """Iterate ``loader`` while measuring, per step, the host-side wait for
    the next batch (``train.loader_wait_s``: nonzero means the step outran
    the prefetch) and the wall clock of the loop body (``train.step_s``:
    dispatch plus whatever sync the body does). The last wait also lands
    in the ``train.loader_wait_last_s`` gauge."""
    wait_h = registry.histogram("train.loader_wait_s")
    step_h = registry.histogram("train.step_s")
    wait_g = registry.gauge("train.loader_wait_last_s")
    it = iter(loader)
    while True:
        t = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            return
        now = time.perf_counter()
        wait_h.record(now - t)
        wait_g.set(now - t)
        yield batch
        step_h.record(time.perf_counter() - now)


def _train_metrics(registry: MetricRegistry) -> dict:
    """Step-timing summary for the result JSON (empty before any step)."""
    step_h = registry.histogram("train.step_s")
    wait_h = registry.histogram("train.loader_wait_s")
    if not step_h.count:
        return {}
    return {"step_p50_s": round(step_h.quantile(50), 6),
            "step_p99_s": round(step_h.quantile(99), 6),
            "loader_wait_p99_s": round(wait_h.quantile(99), 6),
            "loader_wait_s": round(wait_h.sum, 6)}


def _init(cfg, seed: int, replicas: int) -> domst.Params:
    return domst.init(cfg, torch.Generator().manual_seed(seed), replicas)


def train_domst(args) -> dict:
    cfg = get_config(args.arch)
    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps or 2000,
                     warmup_steps=50, grad_accum=args.accum_steps,
                     seed=args.seed)
    windows = make_domst_windows(args.watersheds, args.days)
    # train only on the leading split; the tail that eval_step scores
    # (stacked_test_batch / train_test_split) stays held out
    ip = InputPipeline([train_split(w) for w in windows],
                       batch_size=args.batch_size, seed=args.seed)
    registry = MetricRegistry()
    meter = Meter(registry=registry, prefix="train.")

    def engine_for(tc, stacked):
        return Engine.for_domst(cfg, tc, stacked=stacked, device=args.device)

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
                      f"{float(torch.mean(ev['nse'])):.4f}", flush=True)
            if step % spe == 0:         # epoch boundary
                meter.update(loss=float(torch.mean(m["loss"])))
                print(f"epoch {step // spe - 1} mean loss "
                      f"{meter.last('loss'):.4f} "
                      f"({meter.elapsed():.1f}s)", flush=True)
        ev = engine.eval_step(state, held_out)
        nses = [float(x) for x in ev["nse"].cpu().numpy()]
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
            nses.append(float(ev["nse"]))
            print(f"watershed {w.watershed_id} loss {float(m['loss']):.4f} "
                  f"nse {nses[-1]:.4f} ({meter.elapsed():.1f}s)", flush=True)

    result = {"arch": args.arch, "mode": args.mode,
              "accum_steps": args.accum_steps, "prefetch": args.prefetch,
              "mean_nse": float(np.mean(nses)), "nse": nses,
              "wall_s": meter.elapsed(), **_train_metrics(registry),
              "device": device_name(engine.device)}
    print(json.dumps(result, indent=2))
    if args.metrics_out:
        registry.dump_jsonl(args.metrics_out)
    if args.ckpt:                       # stacked only (guarded above)
        engine.save(args.ckpt, state)   # the full multi-replica state
        print("saved", args.ckpt)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    ap.add_argument("--steps", type=int, default=100,
                    help="the learning-rate schedule's horizon in steps")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--watersheds", type=int, default=23)
    ap.add_argument("--days", type=int, default=400)
    ap.add_argument("--mode", choices=("stacked", "sequential"),
                    default="stacked")
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
                    help="dump the metric registry as JSONL (per-step "
                         "timing histogram train.step_s, loader-wait "
                         "histogram/gauge, metered loss)")
    args = ap.parse_args(argv)
    if not args.arch.startswith("domst"):
        raise NotImplementedError(
            f"--arch {args.arch}: LM training is not ported yet (ROADMAP "
            "Queue A); the port trains the Dom-ST variants")
    return train_domst(args)


if __name__ == "__main__":
    main()
