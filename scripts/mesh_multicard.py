#!/usr/bin/env python3
"""The port's mesh paths across the cards of one host, over NCCL, each
against the one-device run from the same state on the same card.

    python3 scripts/mesh_multicard.py [CARDS [CASE ...]]

CARDS defaults to 4; CASE names the cases to run (``domst``, ``lm``,
``moe``), all of them by default.

One process a card (a world of CARDS ranks on a ``TCPStore`` at
127.0.0.1), the kernels built once beforehand. Cases:

* ``domst`` stacked, 24 watersheds x 400 days (the full config; 24 so
  that the watershed axis divides 4), one epoch of 9 steps on
  (CARDS, 1) and on (CARDS/2, 2): launches a step, collectives a step
  (``CommDebugMode``: none on (CARDS, 1), where the watersheds share
  nothing), the state after 9 steps within 1e-5 of its scale of one
  device's (a rank's products see its block of watersheds, not all 24,
  and may sum in another order), and the synchronised step time on and
  off the mesh;
* mamba2-130m at full width and depth, 8 x 1,024 tokens, bf16, block
  remat, the FSDP rules, 3 steps on (CARDS/2, 2): launches, collectives,
  losses against one device's (bf16: 1e-2 relative), step times;
* qwen3-moe-30b-a3b at smoke size (4 experts), float32, expert parallel
  on (1, CARDS): losses against one device's within 1e-4 relative.

Rank 0 prints one JSON line last; a failed check exits non-zero.
"""
from __future__ import annotations

import json
import os
import socket
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

DOMST_R, DOMST_DAYS, DOMST_STEPS, BATCH = 24, 400, 9, 32
LM = {"arch": "mamba2-130m", "batch": 8, "seq": 1024, "steps": 3}
MOE = {"arch": "qwen3-moe-30b-a3b", "batch": 4, "seq": 64, "steps": 3}


def _median(v):
    v = sorted(v)
    return v[len(v) // 2]


def _sync_steps(eng, state, batches):
    import torch
    from repro_torch.distributed.sharding import full_host
    losses, times = [], []
    for b in batches:
        t = time.perf_counter()
        state, m = eng.step(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(full_host(m["loss"]))
    return state, losses, times


def _comms(eng, state, batch):
    from torch.distributed.tensor.debug import CommDebugMode
    with CommDebugMode() as cm:
        state, _ = eng.step(state, batch)
    counts = {str(k): v for k, v in cm.get_comm_counts().items()}
    return state, cm.get_total_counts(), counts


def domst_case(mesh_shape, dev):
    import numpy as np
    import torch
    from chip_smoke import _state_rel_err, read_launches, reset_launches
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core import domst
    from repro_torch.data.pipeline import (
        InputPipeline, StackedSource, make_domst_windows, train_split)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import Engine
    mesh = make_mesh(mesh_shape, ("data", "model"))
    cfg = get_config("domst")
    windows = make_domst_windows(DOMST_R, DOMST_DAYS)
    source = StackedSource(InputPipeline([train_split(w) for w in windows],
                                         batch_size=BATCH, seed=0))
    tc = TrainConfig(learning_rate=1e-3, total_steps=100, warmup_steps=50)
    init = domst.init(cfg, torch.Generator().manual_seed(0), DOMST_R)
    host = [source.host_batch(i) for i in range(DOMST_STEPS)]
    out = {}
    for name, m in (("one device", None), ("mesh", mesh)):
        eng = Engine.for_domst(cfg, tc, stacked=True, device=dev, mesh=m,
                               donate=False)
        state = eng.init_state({k: v.clone() for k, v in init.items()})
        batches = [eng.place_batch(b) for b in host]
        torch.cuda.synchronize()
        reset_launches()
        state, losses, times = _sync_steps(eng, state, batches)
        out[name] = {"launches": read_launches(), "losses": losses,
                     "step_s": times, "host": eng.host_state(state)}
        if m is not None:
            _, total, by_op = _comms(eng, state, batches[0])
            out[name].update(comms=total, comms_by_op=by_op)
    err, leaf = _state_rel_err(out["mesh"]["host"], out["one device"]["host"])
    loss_err = float(np.abs(np.stack(out["mesh"]["losses"])
                            - np.stack(out["one device"]["losses"])).max())
    res = {"mesh": list(mesh_shape), "state_rel_err": err, "worst_leaf": leaf,
           "loss_abs_err": loss_err,
           "launches": out["mesh"]["launches"],
           "comms_a_step": out["mesh"]["comms"],
           "comms_by_op": out["mesh"]["comms_by_op"],
           "step_p50_s": {n: _median(r["step_s"][1:]) for n, r in out.items()}}
    want = cfg.domst.lstm_layers * cfg.domst.window_days * DOMST_STEPS
    ok = (out["mesh"]["launches"]["pixcon"] == DOMST_STEPS
          and out["mesh"]["launches"]["lstm_cell"] == want
          and err <= 1e-5
          and (out["mesh"]["comms"] == 0) == (mesh_shape[1] == 1))
    return res, ok


def lm_case(spec, mesh_shape, dev, dtype, fsdp, rel):
    import numpy as np
    import torch
    from chip_smoke import read_launches, reset_launches
    from repro_torch.configs import TrainConfig, get_config, smoke_variant
    from repro_torch.convert import flatten, unflatten
    from repro_torch.data.tokens import TokenSource
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.train import Engine
    mesh = make_mesh(mesh_shape, ("data", "model"))
    cfg = get_config(spec["arch"])
    if dtype == torch.float32:
        cfg = smoke_variant(cfg)
    tc = TrainConfig(learning_rate=1e-3, total_steps=spec["steps"],
                     warmup_steps=1, remat="block", fsdp=fsdp)
    tree = tfm.init(cfg, torch.Generator(device=dev).manual_seed(0))
    like = tfm.model_params(cfg, lambda *a: None)
    src = TokenSource(cfg, spec["batch"], spec["seq"], seed=0)
    out = {}
    for name, m in (("one device", None), ("mesh", mesh)):
        eng = Engine.for_lm(cfg, tc, device=dev, mesh=m, dtype=dtype)
        state = eng.init_state(unflatten(
            {k: v.clone() for k, v in flatten(tree).items()}, like))
        batches = [eng.place_batch(src.host_batch(i))
                   for i in range(spec["steps"])]
        torch.cuda.synchronize()
        reset_launches()
        state, losses, times = _sync_steps(eng, state, batches)
        out[name] = {"launches": read_launches(),
                     "losses": [float(x) for x in losses], "step_s": times}
        if m is not None:
            _, total, by_op = _comms(eng, state, batches[0])
            out[name].update(comms=total, comms_by_op=by_op)
        del eng, state, batches
        torch.cuda.empty_cache()
    l_err = max(abs(a - b) / abs(b) for a, b in zip(
        out["mesh"]["losses"], out["one device"]["losses"]))
    res = {"arch": cfg.name, "mesh": list(mesh_shape), "fsdp": fsdp,
           "dtype": str(dtype).split(".")[-1], "loss_rel_err": l_err,
           "losses": out["mesh"]["losses"],
           "launches": out["mesh"]["launches"],
           "comms_a_step": out["mesh"]["comms"],
           "comms_by_op": out["mesh"]["comms_by_op"],
           "step_s": {n: r["step_s"] for n, r in out.items()}}
    ok = (l_err <= rel and bool(np.isfinite(out["mesh"]["losses"]).all())
          and out["mesh"]["launches"] == out["one device"]["launches"])
    return res, ok


def worker(rank: int, world: int, port: int, only=()) -> None:
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    from repro_torch.device import resolve_device
    resolve_device(dev)
    store = dist.TCPStore("127.0.0.1", port, world, is_master=rank == 0)
    dist.init_process_group("nccl", store=store, rank=rank, world_size=world)
    results, failed = {}, []
    try:
        cases = [
            ("domst", (world, 1), lambda s: domst_case(s, dev)),
            ("domst", (world // 2, 2), lambda s: domst_case(s, dev)),
            ("lm", (world // 2, 2), lambda s: lm_case(
                LM, s, dev, torch.bfloat16, True, 1e-2)),
            ("moe", (1, world), lambda s: lm_case(
                MOE, s, dev, torch.float32, False, 1e-4)),
        ]
        for name, shape, run in cases:
            if only and name not in only:
                continue
            t = time.perf_counter()
            res, ok = run(shape)
            res["wall_s"] = time.perf_counter() - t
            key = f"{name} {shape[0]}x{shape[1]}"
            results[key] = res
            if not ok:
                failed.append(key)
            if rank == 0:
                print(f"{key}: {'ok' if ok else 'FAILED'} "
                      f"{json.dumps(res)}", flush=True)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(json.dumps({"cards": world,
                          "card": torch.cuda.get_device_name(0),
                          "results": results, "failed": failed}))
    if failed:
        sys.exit(1)


def main() -> int:
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("mesh_multicard: no CUDA device", file=sys.stderr)
        return 2
    world = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    if torch.cuda.device_count() < world or world % 2:
        print(f"mesh_multicard: needs an even number of cards, at most "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    build.build()
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    only = tuple(sys.argv[2:])
    procs = [ctx.Process(target=worker, args=(r, world, port, only))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    return max(p.exitcode or 0 for p in procs)


if __name__ == "__main__":
    sys.exit(main())
