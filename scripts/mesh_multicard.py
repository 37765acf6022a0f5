#!/usr/bin/env python3
"""The port's mesh paths across the cards of one host, over NCCL, each
against the one-device run from the same state on the same card.

    python3 scripts/mesh_multicard.py [CARDS [CASE ...]]

CARDS defaults to 4; CASE names the cases to run (``domst``, ``lm``,
``moe``, ``serve``, ``serve_moe``), all of them by default.

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
  losses against one device's (bf16: 1e-2 relative), step times, and
  the bytes each rank's card holds for the state after ``init_state``
  (``torch.cuda.memory_allocated`` before and after), on and off the
  mesh;
* qwen3-moe-30b-a3b at smoke size (4 experts), float32, expert parallel
  on (1, CARDS): losses against one device's within 1e-4 relative;
* ``serve``: qwen2-1.5b at full width through ``InferenceEngine(mesh=)``
  on (CARDS/2, 2), where its 2 KV heads split over "model", and on
  (1, CARDS), where they cannot and a page's offsets split instead (the
  ``cache_seq`` branch): float32 at 6 layers (rescaled weights) serving
  chip_smoke's wave (4 x ~512 tokens, 32 new), the greedy streams and
  launches equal to one device's; float32 at full depth, one decode
  step's logits within 1e-4 of their scale of one device's on the
  rescaled weights, and on the init law's printed beside one card's own
  kernel-vs-plain gap there (two correct float32 runs of the init law's
  28 layers part by tenths of the scale); bf16 at full depth, one decode
  step's logits within 2^-5 of one device's on the rescaled weights (the
  init law's printed), the collectives of a decode step
  (counts and bytes each rank sends, ``launch/dryrun.py::RankCounter``)
  and the decode step's time on and off the mesh;
* ``serve_moe``: deepseek-moe-16b at full width served expert parallel
  on (1, CARDS) (its 64 experts split over "model", ``moe_block_sharded``:
  one all-reduce of the experts' outputs a MoE layer): float32 at 4
  layers (the dense first layer and 3 MoE layers; rescaled weights), the
  wave's greedy streams and launches equal to one device's; one decode
  step's logits on the rescaled weights, on one card and on the mesh
  following the card's routing (``chip_smoke.Routes`` replayed), the
  step fed the card's first tokens: float32 at full depth within
  F32_FULL_REL of their scale, bf16 at 4, 8, 16 and 28 layers within
  2^-5, beside one card's plain-vs-kernel gap at 28 (the mesh's own
  routing's logits, its routing flips and whether its own first tokens
  were the card's printed too); bf16 at
  full depth on the init law's weights, the wave served whole on and off
  the mesh (the share of equal tokens printed), then the collectives of a
  decode step (with the port's frames that called each) and its time on
  and off the mesh.

Rank 0 prints one JSON line last; a failed check exits non-zero.
"""
from __future__ import annotations

import json
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
SERVE = {"arch": "qwen2-1.5b", "f32_depth": 6, "decode_steps": 8}
SERVE_MOE = {"arch": "deepseek-moe-16b", "f32_depth": 4, "decode_steps": 8,
             "bf16_depths": (4, 8, 16, 28)}
F32_FULL_REL = 1e-4     # float32 decode logits at full depth, of their scale


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
    import torch.distributed as dist
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
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        state = eng.init_state(unflatten(
            {k: v.clone() for k, v in flatten(tree).items()}, like))
        torch.cuda.synchronize()
        # the bytes the state holds on this card: a rank's share on a mesh
        held = [None] * dist.get_world_size()
        dist.all_gather_object(held, torch.cuda.memory_allocated(dev) - before)
        batches = [eng.place_batch(src.host_batch(i))
                   for i in range(spec["steps"])]
        torch.cuda.synchronize()
        reset_launches()
        state, losses, times = _sync_steps(eng, state, batches)
        out[name] = {"launches": read_launches(),
                     "losses": [float(x) for x in losses], "step_s": times,
                     "state_bytes_by_rank": held}
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
           "step_s": {n: r["step_s"] for n, r in out.items()},
           "state_bytes_by_rank": {n: r["state_bytes_by_rank"]
                                   for n, r in out.items()}}
    ok = (l_err <= rel and bool(np.isfinite(out["mesh"]["losses"]).all())
          and out["mesh"]["launches"] == out["one device"]["launches"])
    return res, ok


def _decode_logits(eng, state, tokens=None):
    """One paged decode step's float32 logits over the real vocab, whole,
    from ``state`` (which the step advances), fed each slot's last token
    or ``tokens``."""
    import torch
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as tfm
    if tokens is None:
        tokens = shd.full(state.last_tok)
    with torch.no_grad(), eng._context():
        act = torch.ones(eng.slots, dtype=torch.bool, device=eng.device)
        lg, _ = tfm.decode_step_paged(
            state.params, eng.cfg,
            {"tokens": eng._batch_input(tokens[:, None])},
            state.cache, shd.full(state.positions),
            shd.full(state.page_table), act, dtype=eng.dtype, ops=eng.ops)
        return shd.full(lg)[:, :eng.cfg.vocab_size].float().cpu()


def _wave_state(cfg, params, dtype, mesh, dev, extra_len=0, ops=None):
    """An engine on ``mesh`` (None: one card) and its state with
    chip_smoke's wave inserted whole, a request a slot, room for
    ``extra_len`` more tokens."""
    from chip_smoke import STEP_LENS, request_inputs, request_len, requests_of
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import InferenceEngine
    reqs = requests_of(cfg.vocab_size, STEP_LENS, 32)
    eng = InferenceEngine(cfg, mesh=mesh, slots=len(reqs),
                          max_len=max(request_len(r) for r in reqs)
                          + extra_len + 1, page_size=16, dtype=dtype,
                          device=dev, ops=ops or tfm.KERNELS)
    state = eng.init_state(params)
    for s, r in enumerate(reqs):
        state = eng.assign_pages(state, s, list(range(
            s * eng.pages_per_slot, (s + 1) * eng.pages_per_slot)))
        state, _ = eng.insert(state, request_inputs(r), s)
    return eng, state


def _rel_argmax(a, b):
    """|a - b|'s largest entry over b's largest |entry|, and whether each
    row's argmax agrees."""
    return (float((a - b).abs().max() / b.abs().max()),
            (a.argmax(-1) == b.argmax(-1)).tolist())


def serve_case(mesh_shape, dev):
    import torch
    from chip_smoke import (
        REL_LOGITS_BF16, STEP_LENS, first_parting, half_depth, requests_of,
        serve_once, well_conditioned)
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tfm
    mesh = make_mesh(mesh_shape, ("data", "model"))
    cfg = get_config(SERVE["arch"])
    p32 = tfm.init(cfg, torch.Generator(device=dev).manual_seed(0))
    wave = lambda: requests_of(cfg.vocab_size, STEP_LENS, 32)
    cfg6, p6 = half_depth(cfg, p32, SERVE["f32_depth"])
    well = well_conditioned(cfg6, p6)
    f32 = {where: serve_once(cfg6, dev, well, torch.float32, {"mesh": m},
                             wave())
           for where, m in (("one device", None), ("mesh", mesh))}
    del well, p6
    # float32 at full depth: one decode step's logits on and off the mesh,
    # on the rescaled weights (held within F32_FULL_REL) and on the init
    # law's (printed), beside one card's own kernel-vs-plain gap on the
    # init law's: how far two correct float32 runs of the 28 layers part
    f32_full = {}
    for kind, params in (("rescaled", well_conditioned(cfg, p32)),
                         ("init", p32)):
        for where, m, ops in (("one device", None, None),
                              ("mesh", mesh, None),
                              ("plain", None, tfm.PLAIN)):
            if kind == "rescaled" and where == "plain":
                continue
            eng, state = _wave_state(cfg, params, torch.float32, m, dev,
                                     ops=ops)
            f32_full[kind, where] = _decode_logits(eng, state)
            del eng, state
            torch.cuda.empty_cache()
        del params
    pbf = tfm.cast_params(p32, torch.bfloat16, dev)
    del p32
    bf = {}
    # the init law's weights make the 28-layer model chaotic in bf16 (a
    # rank's partial sums round otherwise than one card's whole ones and
    # the difference grows layer by layer): their logits are printed, the
    # rescaled weights' (unit-variance attention projections) are held
    for kind, params in (("init", pbf),
                         ("rescaled", well_conditioned(cfg, pbf))):
        for where, m in (("one device", None), ("mesh", mesh)):
            eng, state = _wave_state(cfg, params, torch.bfloat16, m, dev,
                                     extra_len=SERVE["decode_steps"])
            rec = {"logits": _decode_logits(eng, state)}
            if kind == "init":
                rec.update(_decode_times(eng, state, SERVE["decode_steps"]))
            bf[kind, where] = rec
            del eng, state
            torch.cuda.empty_cache()

    def logits_err(kind):
        return _rel_argmax(bf[kind, "mesh"]["logits"],
                           bf[kind, "one device"]["logits"])
    rel, argmax = logits_err("rescaled")
    rel_init, argmax_init = logits_err("init")
    f32_rel = {kind: _rel_argmax(f32_full[kind, "mesh"],
                                 f32_full[kind, "one device"])
               for kind in ("rescaled", "init")}
    f32_plain = _rel_argmax(f32_full["init", "plain"],
                            f32_full["init", "one device"])
    same = f32["mesh"]["gen"] == f32["one device"]["gen"]
    run = {w: bf["init", w] for w in ("one device", "mesh")}
    res = {"arch": cfg.name, "mesh": list(mesh_shape),
           "f32_layers": SERVE["f32_depth"], "f32_streams_equal": same,
           "f32_first_parting": first_parting(f32["mesh"]["gen"],
                                              f32["one device"]["gen"]),
           "f32_launches": {w: r["launches"] for w, r in f32.items()},
           "f32_tok_per_s": {w: r["tok_per_s"] for w, r in f32.items()},
           "f32_full_depth_logits_rel_err": {
               k: v[0] for k, v in f32_rel.items()},
           "f32_full_depth_argmax_equal": {
               k: v[1] for k, v in f32_rel.items()},
           "f32_full_depth_init_kernel_vs_plain_one_device": {
               "rel_err": f32_plain[0], "argmax_equal": f32_plain[1]},
           "bf16_decode_logits_rel_err": rel, "bf16_argmax_equal": argmax,
           "bf16_init_weights_logits_rel_err": rel_init,
           "bf16_init_weights_argmax_equal": argmax_init,
           "decode_step_p50_s": {w: _median(r["decode_step_s"][1:])
                                 for w, r in run.items()},
           "decode_step_s": {w: r["decode_step_s"] for w, r in run.items()},
           "comms_a_step": run["mesh"]["comms_a_step"],
           "comms_by_op": run["mesh"]["comms_by_op"],
           "send_bytes_a_step": run["mesh"]["send_bytes_a_step"]}
    ok = (same and rel <= REL_LOGITS_BF16
          and f32_rel["rescaled"][0] <= F32_FULL_REL
          and f32["mesh"]["launches"] == f32["one device"]["launches"]
          and f32["mesh"]["launches"]["paged_attn"] > 0)
    return res, ok


def _decode_times(eng, state, steps):
    """Synchronised host times of ``steps`` decode steps, then one more
    step's collectives on a mesh: counts by op, bytes each rank sends,
    and counts by op, local block shape and the port's three innermost
    frames that called it (``_comm_sites``)."""
    import torch
    from repro_torch.launch.dryrun import RankCounter
    from torch.distributed.tensor.debug import CommDebugMode
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, _ = eng.decode(state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    rec = {"decode_step_s": times}
    if eng.mesh is not None:
        counter = RankCounter()
        with counter, CommDebugMode() as cm, _comm_sites() as sites:
            eng.decode(state)
        rec.update(comms_a_step=int(cm.get_total_counts()),
                   comms_by_op={str(k): v for k, v in
                                cm.get_comm_counts().items()},
                   send_bytes_a_step=dict(counter.bytes),
                   comm_sites=dict(sites.sites.most_common()))
    return rec


def _comm_sites():
    """A dispatch mode that counts, in its ``sites`` Counter, the
    collectives dispatched inside it by op, local block shape and the
    port's three innermost frames above the call (``repro_torch`` files
    only)."""
    import collections
    import traceback
    from torch.utils._python_dispatch import TorchDispatchMode

    class Sites(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.sites = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if "c10d" in func.namespace:
                frames = [f for f in traceback.extract_stack()
                          if "repro_torch" in f.filename][-3:]
                where = " < ".join(f"{Path(f.filename).name}:{f.lineno}"
                                   for f in reversed(frames))
                shape = tuple(getattr(args[0], "shape", ()))
                self.sites[f"{func.__name__} {shape} {where}"] += 1
            return func(*args, **(kwargs or {}))
    return Sites()


def _logits_same_routing(cfg, params, dtype, mesh, dev, plain=False):
    """One decode step's logits of chip_smoke's wave (``_wave_state``,
    ``_decode_logits``) on one card, on ``mesh`` with its own routing, and
    on ``mesh`` following the card's routing (``chip_smoke.Routes``
    replayed call by call): |mesh - card|'s largest over the card's
    largest |logit| and the argmax agreement of both mesh runs, and the
    tokens whose experts the mesh's own routing changed. Every decode
    step is fed the card's first tokens (a near-tie in a prefill's logits
    would otherwise feed the step another token); whether each run's own
    first tokens were the card's is printed. ``plain``: also the plain
    ops on the same card and routing against the kernels, how far two
    correct runs of one card part."""
    import torch
    from chip_smoke import Routes, routing_flips
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as tfm
    out, routes, first = {}, {}, {}
    runs = [("one device", None, None, None), ("mesh", mesh, None, None),
            ("mesh, same routing", mesh, "one device", None)]
    if plain:
        runs.append(("plain, same routing", None, "one device", tfm.PLAIN))
    for where, m, replay, ops in runs:
        with Routes(replay=routes[replay].calls if replay else None) as r:
            eng, state = _wave_state(cfg, params, dtype, m, dev, ops=ops)
            first[where] = shd.full(state.last_tok).clone()
            out[where] = _decode_logits(eng, state, first["one device"])
        routes[where] = r
        del eng, state
        torch.cuda.empty_cache()
    res = {"same_routing": _rel_argmax(out["mesh, same routing"],
                                       out["one device"]),
           "own_routing": _rel_argmax(out["mesh"], out["one device"]),
           "routing_flips": routing_flips(
               routes["one device"].calls, routes["mesh"].calls,
               cfg.num_layers - cfg.first_k_dense),
           "first_tokens_equal": {
               w: (t == first["one device"]).tolist()
               for w, t in first.items() if w != "one device"}}
    if plain:
        res["plain_vs_kernels_one_device"] = _rel_argmax(
            out["plain, same routing"], out["one device"])
    return res


def serve_moe_case(mesh_shape, dev):
    import torch
    from chip_smoke import (
        REL_LOGITS_BF16, STEP_LENS, first_parting, half_depth, requests_of,
        same_tokens, serve_once, well_conditioned)
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import InferenceEngine
    mesh = make_mesh(mesh_shape, ("data", "model"))
    cfg = get_config(SERVE_MOE["arch"])
    wave = lambda: requests_of(cfg.vocab_size, STEP_LENS, 32)
    sharded = {"calls": 0}
    real = moe.moe_block_sharded

    def counted(*a, **k):
        sharded["calls"] += 1
        return real(*a, **k)
    moe.moe_block_sharded = counted
    try:
        cfg4 = cfg.replace(num_layers=SERVE_MOE["f32_depth"])
        p4 = tfm.init(cfg4, torch.Generator(device=dev).manual_seed(0))
        well = well_conditioned(cfg4, p4)
        eng = InferenceEngine(cfg4, mesh=mesh, slots=4, max_len=16,
                              page_size=16, dtype=torch.float32, device=dev)
        experts = str(tuple(eng.init_state(well).params["layers"][1]["ffn"][
            "w_gate"].placements))
        del eng
        f32 = {}
        for where, m in (("one device", None), ("mesh", mesh)):
            sharded["calls"] = 0
            f32[where] = serve_once(cfg4, dev, well, torch.float32,
                                    {"mesh": m}, wave())
            f32[where]["sharded_calls"] = sharded["calls"]
        del p4, well
        torch.cuda.empty_cache()
        # float32 at full depth on the rescaled weights (the card holds
        # them once: both engines use the same tensors, the mesh's blocks
        # views of them): one decode step's logits on and off the mesh
        p32 = well_conditioned(cfg, tfm.init(
            cfg, torch.Generator(device=dev).manual_seed(0)), in_place=True)
        f32_full = _logits_same_routing(cfg, p32, torch.float32, mesh, dev)
        del p32
        torch.cuda.empty_cache()
        pbf = tfm.init(cfg, torch.Generator(device=dev).manual_seed(0),
                       dtype=torch.bfloat16)
        # bf16 on the rescaled weights: the logits at 4, 8, 16 and all 28
        # layers (with one card's plain-vs-kernel gap at 28); the init
        # law's wave served and timed
        bf_logits = {}
        for depth in SERVE_MOE["bf16_depths"]:
            cfg_d, p_d = half_depth(cfg, pbf, depth)
            bf_logits[depth] = _logits_same_routing(
                cfg_d, well_conditioned(cfg_d, p_d), torch.bfloat16, mesh,
                dev, plain=depth == cfg.num_layers)
        bf = {}
        for where, m in (("one device", None), ("mesh", mesh)):
            r = serve_once(cfg, dev, pbf, torch.bfloat16, {"mesh": m},
                           wave())
            eng, state = _wave_state(cfg, pbf, torch.bfloat16, m, dev,
                                     extra_len=SERVE_MOE["decode_steps"] + 1)
            bf[where] = {"run": r, **_decode_times(
                eng, state, SERVE_MOE["decode_steps"])}
            del eng, state
            torch.cuda.empty_cache()
    finally:
        moe.moe_block_sharded = real
    same = f32["mesh"]["gen"] == f32["one device"]["gen"]
    res = {"arch": cfg.name, "mesh": list(mesh_shape),
           "expert_placements": experts,
           "f32_layers": SERVE_MOE["f32_depth"], "f32_streams_equal": same,
           "f32_first_parting": first_parting(f32["mesh"]["gen"],
                                              f32["one device"]["gen"]),
           "f32_launches": {w: r["launches"] for w, r in f32.items()},
           "f32_sharded_moe_calls": {w: r["sharded_calls"]
                                     for w, r in f32.items()},
           "bf16_equal_token_share": same_tokens(
               bf["mesh"]["run"]["gen"], bf["one device"]["run"]["gen"]),
           "bf16_first_parting": first_parting(
               bf["mesh"]["run"]["gen"], bf["one device"]["run"]["gen"]),
           "bf16_tok_per_s": {w: r["run"]["tok_per_s"]
                              for w, r in bf.items()},
           "bf16_launches": {w: r["run"]["launches"] for w, r in bf.items()},
           "decode_step_p50_s": {w: _median(r["decode_step_s"][1:])
                                 for w, r in bf.items()},
           "decode_step_s": {w: r["decode_step_s"] for w, r in bf.items()},
           "comms_a_step": bf["mesh"]["comms_a_step"],
           "comms_by_op": bf["mesh"]["comms_by_op"],
           "send_bytes_a_step": bf["mesh"]["send_bytes_a_step"],
           "comm_sites": bf["mesh"]["comm_sites"],
           "f32_full_depth_logits": f32_full,
           "bf16_rescaled_logits": bf_logits}
    ok = (same and f32["mesh"]["launches"] == f32["one device"]["launches"]
          and f32_full["same_routing"][0] <= F32_FULL_REL
          and all(r["same_routing"][0] <= REL_LOGITS_BF16
                  for r in bf_logits.values())
          and f32["mesh"]["launches"]["paged_attn"] > 0
          and f32["mesh"]["sharded_calls"] > 0
          and f32["one device"]["sharded_calls"] == 0
          and bf["mesh"]["run"]["launches"]
          == bf["one device"]["run"]["launches"])
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
            ("serve", (world // 2, 2), lambda s: serve_case(s, dev)),
            ("serve", (1, world), lambda s: serve_case(s, dev)),
            ("serve_moe", (1, world), lambda s: serve_moe_case(s, dev)),
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
        import subprocess
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.split("\n")
        print(json.dumps({"cards": world,
                          "card": torch.cuda.get_device_name(0),
                          "name_power_limit": [x for x in smi if x][:world],
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
