"""Spawns gloo ranks on the CPU for the port's mesh tests (not a test
module; ``test_torch_distributed.py`` uses it).

``spawn(case, world, tmp_path, **kw)`` starts ``world`` processes, each
of which joins a gloo group through a ``FileStore`` under ``tmp_path``,
runs ``case(rank, world, **kw)`` (a function of this module, which
imports only the port) and pickles what it returns. The parent joins
them with a deadline: past it every rank is killed and the test fails.
A rank that raises fails the test with its traceback. Rank-side code
imports neither jax nor the reference: the tests compute the reference's
side in their own process.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import time
import traceback
from pathlib import Path


LIMIT_S = 120


def _worker(case: str, rank: int, world: int, root: str, kw: dict):
    out = Path(root) / f"rank{rank}.pkl"
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        store = dist.FileStore(str(Path(root) / "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
        try:
            result = ("ok", globals()[case](rank, world, **kw))
        finally:
            dist.destroy_process_group()
    except BaseException:                       # noqa: BLE001
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)


def spawn(case: str, world: int, tmp_path, limit_s: float = LIMIT_S, **kw):
    """``case`` on ``world`` gloo ranks -> the list of what each returned."""
    root = Path(tmp_path) / f"{case}-{world}-{time.monotonic_ns()}"
    root.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    env_src = str(Path(__file__).resolve().parents[1] / "src")
    os.environ["PYTHONPATH"] = env_src + os.pathsep + os.environ.get(
        "PYTHONPATH", "")
    procs = [ctx.Process(target=_worker, args=(case, r, world, str(root), kw))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + limit_s
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0))
    late = [p for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if late:
        raise AssertionError(f"{case} on {world} ranks passed its "
                             f"{limit_s:.0f} s limit; the ranks were killed")
    results = []
    for r in range(world):
        path = root / f"rank{r}.pkl"
        if not path.exists():
            raise AssertionError(f"rank {r} of {case} left no result "
                                 f"(exit code {procs[r].exitcode})")
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            raise AssertionError(f"rank {r} of {case} raised:\n{value}")
        results.append(value)
    return results


# ---------------------------------------------------------------------------
# Rank-side cases
# ---------------------------------------------------------------------------
def _mesh(shape, names=("data", "model")):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, names, device="cpu")


def _host(mets):
    from repro_torch.distributed.sharding import full_host
    return {k: full_host(v) for k, v in mets.items()}


def domst_steps(rank, world, *, mesh_shape, cfg_name, params, batches, tc,
                count_comms=False):
    """Stacked Dom-ST steps on a mesh from the given host params and
    batches: (per-step host metrics, final host params and moments,
    collectives counted in the last step when ``count_comms``)."""
    import torch
    from repro_torch.configs import TrainConfig, get_config, smoke_variant
    from repro_torch.train import Engine
    cfg = smoke_variant(get_config(cfg_name))
    eng = Engine.for_domst(cfg, TrainConfig(**tc), stacked=True,
                           device="cpu", mesh=_mesh(mesh_shape))
    state = eng.init_state({k: torch.from_numpy(v) for k, v in params.items()})
    mets, comms = [], None
    for i, b in enumerate(batches):
        placed = eng.place_batch(b)
        if count_comms and i == len(batches) - 1:
            from torch.distributed.tensor.debug import CommDebugMode
            with CommDebugMode() as cm:
                state, m = eng.step(state, placed)
            comms = cm.get_total_counts()
        else:
            state, m = eng.step(state, placed)
        mets.append(_host(m))
    host = eng.host_state(state)
    return {"mets": mets, "comms": comms,
            "params": {k: v.numpy() for k, v in host.params.items()},
            "mu": {k: v.numpy() for k, v in host.opt_state.mu.items()},
            "nu": {k: v.numpy() for k, v in host.opt_state.nu.items()},
            "placements": {k: str(v.placements)
                           for k, v in state.params.items()}}


def lm_run(rank, world, *, mesh_shape, cfg_name, params, batches, tc,
           names=("data", "model"), accum=1):
    """LM training (float32) on a mesh from the given host params (the
    flat per-layer dict): the loss and every gradient leaf of the first
    batch on the fresh state, then one step a batch of ``accum``
    microbatches: per-step host metrics, final host params and first
    moments, each param's placements."""
    import torch
    from repro_torch.configs import TrainConfig, get_config, smoke_variant
    from repro_torch.convert import unflatten
    from repro_torch.distributed.sharding import full_host
    from repro_torch.models import transformer as tfm
    from repro_torch.train import Engine, accumulate_grads
    cfg = smoke_variant(get_config(cfg_name))
    eng = Engine.for_lm(cfg, TrainConfig(**tc), device="cpu",
                        dtype=torch.float32, mesh=_mesh(mesh_shape, names),
                        accum_steps=accum)
    tree = unflatten({k: torch.from_numpy(v.copy()) for k, v in params.items()},
                     tfm.model_params(cfg, lambda *a: None))
    state = eng.init_state(tree)
    with eng._context():
        grads, loss, _ = accumulate_grads(
            eng.loss_fn, state.params, eng.place_batch(batches[0]), 1,
            eng._loss_placements(state))
    out = {"loss0": full_host(loss)[0],
           "grads": {k: full_host(g)[0] for k, g in grads.items()},
           "placements": {k: str(v.placements)
                          for k, v in state.params.items()},
           "moment_placements": {
               k: (str(state.opt_state.mu[k].placements),
                   str(state.opt_state.nu[k].placements))
               for k in state.params},
           "step_placements": str(state.opt_state.step.placements)}
    mets = []
    for b in batches:
        state, m = eng.step(state, eng.place_batch(b))
        mets.append(_host(m))
    host = eng.host_state(state)
    out.update(mets=mets,
               params={k: v.numpy()[0] for k, v in host.params.items()},
               mu={k: v.numpy()[0] for k, v in host.opt_state.mu.items()})
    return out


def domst_checkpoint(rank, world, *, mesh_shape, cfg_name, params, batches,
                     tc, path):
    """Dom-ST stacked steps on a mesh, saved to ``path`` after the first
    batch, then restored by a fresh engine and stepped on the rest: the
    restored state's and the final state's host params and moments."""
    import torch
    from repro_torch.configs import TrainConfig, get_config, smoke_variant
    from repro_torch.train import Engine
    cfg = smoke_variant(get_config(cfg_name))
    mesh = _mesh(mesh_shape)

    def engine():
        return Engine.for_domst(cfg, TrainConfig(**tc), stacked=True,
                                device="cpu", mesh=mesh)
    eng = engine()
    state = eng.init_state({k: torch.from_numpy(v.copy())
                            for k, v in params.items()})
    state, _ = eng.step(state, eng.place_batch(batches[0]))
    eng.save(path, state)
    fresh = engine()
    example = fresh.init_state({k: torch.zeros(v.shape)
                                for k, v in params.items()})
    state = fresh.restore(path, example)
    restored = fresh.host_state(state)
    for b in batches[1:]:
        state, _ = fresh.step(state, fresh.place_batch(b))
    final = fresh.host_state(state)

    def arrays(st):
        return {"params": {k: v.numpy() for k, v in st.params.items()},
                "mu": {k: v.numpy() for k, v in st.opt_state.mu.items()},
                "nu": {k: v.numpy() for k, v in st.opt_state.nu.items()},
                "opt_step": st.opt_state.step.numpy(),
                "step": int(st.step)}
    return {"restored": arrays(restored), "final": arrays(final),
            "placements": str(state.params["temporal/lstm0/wx"].placements)}


def forecast(rank, world, *, mesh_shape, params, held):
    """The Forecaster on a mesh: its gathered qhat, nse and mse."""
    from repro_torch.configs import get_config
    from repro_torch.serve.forecast import Forecaster
    fc = Forecaster(get_config("domst"), mesh=_mesh(mesh_shape))
    return {k: v.numpy() for k, v in fc(params, held).items()}


def local_attention_cases(rank, world, *, cases):
    """``distributed.kernels.local_attention`` on a (1, world) mesh with
    the query heads split and the KV heads split or whole, against the
    plain version on the full tensors: outputs and q/k/v gradients
    (max abs error), and the KV placement the adapter took."""
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed import kernels as dk
    from repro_torch.distributed.sharding import distribute
    from repro_torch.kernels.local_attn.ref import local_attention_ref
    mesh = _mesh((1, world))
    out = []
    for Hq, Hkv, kv_split in cases:
        g = torch.Generator().manual_seed(Hq * 10 + Hkv)
        q, k, v = (torch.randn(2, 12, H, 8, generator=g)
                   for H in (Hq, Hkv, Hkv))
        w = torch.randn(2, 12, Hq, 8, generator=g)
        kw = dict(window=5, causal=True, softcap=0.0)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        (local_attention_ref(*leaves, **kw) * w).sum().backward()
        want = [local_attention_ref(q, k, v, **kw)] + [t.grad for t in leaves]
        pq = (Replicate(), Shard(2))
        pk = (Replicate(), Shard(2)) if kv_split else (Replicate(), Replicate())
        dq, dk_, dv = (distribute(t, mesh, p).requires_grad_()
                       for t, p in ((q, pq), (k, pk), (v, pk)))
        o = dk.local_attention(local_attention_ref, dq, dk_, dv, **kw)
        (o.full_tensor() * w).sum().backward()
        got = [o.full_tensor()] + [t.grad.full_tensor() for t in (dq, dk_, dv)]
        out.append({"err": [float((a - b).abs().max())
                            for a, b in zip(got, want)],
                    "out_placements": str(o.placements)})
    return out


class ScriptedDrafter:
    """Proposes a known stream's next ``j`` tokens, then a wrong one: each
    verify step accepts min(j, k) drafts (the reference's test drafter)."""

    def __init__(self, truth, vocab, j):
        self.truth = truth              # {prompt bytes: the stream}
        self.vocab, self.j = vocab, j

    def propose(self, wants):
        import numpy as np
        out = {}
        for slot, (ctx, k) in wants.items():
            ctx = np.asarray(ctx, np.int32)
            for pb, cont in self.truth.items():
                p = np.frombuffer(pb, np.int32)
                if len(ctx) >= len(p) and (ctx[:len(p)] == p).all():
                    n_gen = len(ctx) - len(p)
                    good = list(cont[n_gen:n_gen + min(self.j, k)])
                    if len(good) < k:
                        nxt = cont[n_gen + len(good)] \
                            if n_gen + len(good) < len(cont) else 0
                        good.append((nxt + 1) % self.vocab)
                    out[slot] = np.asarray(good[:k], np.int32)
                    break
        return out

    def release(self, slot):
        pass


def _placement_strs(tree, key=""):
    """{'/'-joined path: str(placements)} of a state's DTensor leaves."""
    from repro_torch.distributed.sharding import is_distributed
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = (zip(tree._fields, tree) if hasattr(tree, "_fields")
                 else enumerate(tree))
    else:
        return {key: str(tuple(tree.placements))} \
            if is_distributed(tree) else {}
    out = {}
    for k, v in items:
        out.update(_placement_strs(v, f"{key}/{k}" if key else str(k)))
    return out


def record_decode_logits(eng) -> list:
    """Make ``eng`` append each decode step's logits of the active slots
    (float32 numpy, (active slots, V)) to the returned list, read where
    the step hands them to the sampler."""
    seen = []
    sample_all = eng._sample_all

    def spy(state, logits, active, *args):
        seen.append(logits[active].float().cpu().numpy())
        return sample_all(state, logits, active, *args)
    eng._sample_all = spy
    return seen


def smoke_cfg(arch, changes=None):
    """The smoke config of ``arch`` with ``changes`` (config fields; a
    ``moe`` entry is a dict of the MoE config's fields)."""
    import dataclasses
    from repro_torch.configs import get_config, smoke_variant
    cfg = smoke_variant(get_config(arch))
    changes = dict(changes or {})
    if "moe" in changes:
        changes["moe"] = dataclasses.replace(cfg.moe, **changes["moe"])
    return cfg.replace(**changes) if changes else cfg


def _tree_of(a):
    """A numpy tree as torch tensors (copies)."""
    import numpy as np
    import torch
    if isinstance(a, dict):
        return {k: _tree_of(v) for k, v in a.items()}
    if isinstance(a, list):
        return [_tree_of(v) for v in a]
    return torch.from_numpy(np.array(a))


def _request_list(requests):
    """``Request`` objects of (prompt, max_new, sampling dict or None[,
    extras]) tuples."""
    import numpy as np
    from repro_torch.serve import Request, SamplingParams
    return [Request(rid=i, prompt=np.asarray(r[0], np.int32), max_new=r[1],
                    sampling=SamplingParams(**r[2]) if r[2]
                    else SamplingParams(),
                    extras={k: np.array(v) for k, v in
                            (r[3] if len(r) > 3 else {}).items()})
            for i, r in enumerate(requests)]


def serve_runs(rank, world, *, mesh_shape, runs):
    """Serve each run's queue on one mesh (``serve_all``)."""
    return serve_all(runs, mesh_shape)


def serve_all(runs, mesh_shape=None):
    """Serve each run's queue on the mesh of ``mesh_shape``, or on one
    device without one: ``runs`` a list of dicts with ``arch`` (smoke
    config, changed by ``cfg``: ``smoke_cfg``), ``params`` (the port's
    per-layer tree as numpy), ``engine`` and ``sched`` options,
    ``requests`` ((prompt, max_new, sampling dict or None[, extras such
    as a VLM's patches]) each) and ``drafter``: None, ``("script", j, run
    index whose streams are the truth)``, ``("model",)`` (the target's
    own config and params, on the mesh) or ``("ngram",)``. Returns each
    run's streams, scheduler counts and decode steps' logits
    (``record_decode_logits``), and the placements of every DTensor leaf
    of its state."""
    import numpy as np
    import torch
    from repro_torch.serve import (
        InferenceEngine, ModelDrafter, NgramDrafter, Scheduler,
    )
    mesh = _mesh(mesh_shape) if mesh_shape else None
    out = []
    calls = _count_local_calls() if mesh is not None else {}
    for run in runs:
        calls.clear()
        cfg = smoke_cfg(run["arch"], run.get("cfg"))
        dtype = getattr(torch, run.get("dtype", "float32"))
        eng = InferenceEngine(cfg, mesh=mesh, device="cpu", dtype=dtype,
                              **run["engine"])
        state = eng.init_state(_tree_of(run["params"]))
        logits = record_decode_logits(eng)
        drafter = None
        kind = run.get("drafter")
        if kind and kind[0] == "script":
            truth = out[kind[2]]["streams"]
            drafter = ScriptedDrafter(
                {np.asarray(r[0], np.int32).tobytes(): truth[i]
                 for i, r in enumerate(run["requests"])},
                cfg.vocab_size, kind[1])
        elif kind and kind[0] == "model":
            drafter = ModelDrafter(cfg, _tree_of(run["params"]), mesh=mesh,
                                   slots=eng.slots, max_len=eng.max_len,
                                   page_size=4, catch_up_chunk=4,
                                   dtype=dtype, device="cpu")
        elif kind and kind[0] == "ngram":
            drafter = NgramDrafter()
        sched = Scheduler(eng, state, drafter=drafter, **run["sched"])
        streams = sched.run(_request_list(run["requests"]))
        out.append({"streams": {k: [int(t) for t in v]
                                for k, v in streams.items()},
                    "stats": dict(sched.stats),
                    "decode_logits": logits,
                    "local_calls": dict(calls),
                    "placements": _placement_strs(state._asdict())})
    return out


def _count_local_calls():
    """Count the calls of the kernels on local blocks
    (``distributed/kernels.py``) and of the expert-parallel MoE block, by
    name, in the returned dict (patched for the process)."""
    from collections import Counter
    from repro_torch.distributed import kernels as dk
    from repro_torch.models import moe
    calls = Counter()

    def counted(mod, name):
        fn = getattr(mod, name)

        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        setattr(mod, name, run)
    for name in ("conv1d", "ssd_chunked", "ssm_recurrence",
                 "local_attention", "paged_attention", "attend_masked"):
        counted(dk, name)
    counted(moe, "moe_block_sharded")
    return calls


def handoff_runs(rank, world, *, mesh_shape, arch, params, batches, tc,
                 engine, requests, path, spec_k=3):
    """Training to serving on one mesh: an LM engine (float32, ``tc``,
    with or without ``fsdp``) trained a step a batch from the given host
    params, then served by ``InferenceEngine.from_train_state`` on the
    same mesh (``DTensor.full_tensor`` and ``Engine.host_state`` refused
    while it adopts the params), and by the same engine with a
    ``ModelDrafter.from_checkpoint(..., mesh=)`` of the state saved to
    ``path`` drafting ``spec_k`` tokens. Returns the trained params
    (gathered, for the one-device hand-off), both runs' streams and
    counts, the adopted params' placements against the training ones,
    whether each adopted float32 leaf kept the training block's storage,
    and the drafter's placements."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import TrainConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.serve import InferenceEngine, ModelDrafter, Scheduler
    from repro_torch.train import Engine
    cfg = smoke_cfg(arch)
    mesh = _mesh(mesh_shape)
    eng = Engine.for_lm(cfg, TrainConfig(**tc), device="cpu",
                        dtype=torch.float32, mesh=mesh)
    state = eng.init_state(_tree_of(params))
    for b in batches:
        state, _ = eng.step(state, eng.place_batch(b))
    host = eng.host_state(state)
    eng.save(path, state)

    def refuse(*a, **k):
        raise AssertionError("the hand-off went through the host")
    saved = DTensor.full_tensor, Engine.host_state
    DTensor.full_tensor, Engine.host_state = refuse, refuse
    try:
        srv, sstate = InferenceEngine.from_train_state(
            eng, state, dtype=torch.float32, **engine)
    finally:
        DTensor.full_tensor, Engine.host_state = saved
    trained = eng.params_tree(state)
    flat_t, flat_s = _flat_leaves(trained), _flat_leaves(sstate.params)
    shared = {k: flat_s[k].to_local().data_ptr()
              == flat_t[k].to_local().data_ptr() for k in flat_s}
    want = {k: str(tuple(v)) for k, v in _flat_leaves(
        srv.state_shardings(sstate).params).items()}
    got = {k: str(tuple(v.placements)) for k, v in flat_s.items()}
    sched = Scheduler(srv, sstate)
    streams = sched.run(_request_list(requests))
    drafter = ModelDrafter.from_checkpoint(
        cfg, path, mesh=mesh, slots=srv.slots, max_len=srv.max_len,
        page_size=4, catch_up_chunk=4, dtype=torch.float32, device="cpu")
    dparams = _flat_leaves(drafter.state.params)
    dsame = all(shd.is_distributed(v) and str(tuple(v.placements)) == got[k]
                for k, v in dparams.items())
    dvalues = {k: float((shd.full(v) - shd.full(flat_s[k])).abs().max())
               for k, v in dparams.items()}
    srv2, st2 = InferenceEngine.from_train_state(eng, state,
                                                 dtype=torch.float32,
                                                 **engine)
    sched2 = Scheduler(srv2, st2, drafter=drafter, spec_k=spec_k)
    spec = sched2.run(_request_list(requests))
    return {"params": {k: v.numpy()[0] for k, v in host.params.items()}
            if rank == 0 else None,
            "streams": {k: [int(t) for t in v] for k, v in streams.items()},
            "spec_streams": {k: [int(t) for t in v] for k, v in spec.items()},
            "spec_stats": dict(sched2.stats),
            "placements": got, "want_placements": want,
            "training_placements": {k: str(tuple(v.placements))
                                    for k, v in flat_t.items()},
            "shared": shared, "drafter_placed": dsame,
            "drafter_err": max(dvalues.values())}


def _flat_leaves(tree, key=""):
    """{'/'-joined path: leaf} of a nested dict/list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {key: tree}
    out = {}
    for k, v in items:
        out.update(_flat_leaves(v, f"{key}/{k}" if key else str(k)))
    return out


def _held_bytes(tree: dict, mesh) -> dict:
    """Each DTensor leaf's (bytes of its local block's storage, bytes of
    its full value over its shard count, that count)."""
    import math
    from torch.distributed.tensor import Shard
    out = {}
    for k, v in tree.items():
        ways = math.prod(mesh.size(i) for i, p in enumerate(v.placements)
                         if isinstance(p, Shard))
        out[k] = (v.to_local().untyped_storage().nbytes(),
                  v.numel() * v.element_size() // ways, ways)
    return out


def distribute_storage(rank, world, *, mesh_shape):
    """``distribute``'s local blocks of a first-dim split, a second-dim
    split and a replicated leaf, each from a full value already on the
    device in the target dtype: (storage bytes, own bytes) of each."""
    import torch
    from repro_torch.distributed import sharding as shd
    mesh = _mesh(mesh_shape)
    full = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    out = {}
    for name, pl in (("dim0", (shd.Shard(0), shd.Replicate())),
                     ("dim1", (shd.Replicate(), shd.Shard(1))),
                     ("both", (shd.Shard(0), shd.Shard(1))),
                     ("replicated", (shd.Replicate(), shd.Replicate()))):
        x = shd.distribute(full, mesh, pl, torch.device("cpu"),
                           torch.float32)
        loc = x.to_local()
        out[name] = (loc.untyped_storage().nbytes(),
                     loc.numel() * loc.element_size(),
                     bool(torch.equal(x.full_tensor(), full)))
    return out


def init_state_bytes(rank, world, *, mesh_shape):
    """A stacked Dom-ST engine (4 watersheds) and a mamba2-130m engine with
    the FSDP rules, both at smoke size, after ``init_state`` from full
    params: ``_held_bytes`` of their params and both moments."""
    import torch
    from repro_torch.configs import TrainConfig, get_config, smoke_variant
    from repro_torch.core import domst
    from repro_torch.models import transformer as tfm
    from repro_torch.train import Engine
    mesh = _mesh(mesh_shape)
    g = torch.Generator().manual_seed(0)
    out = {}
    cfg = smoke_variant(get_config("domst"))
    eng = Engine.for_domst(cfg, TrainConfig(), stacked=True, device="cpu",
                           mesh=mesh)
    st = eng.init_state(domst.init(cfg, g, 4))
    lm = smoke_variant(get_config("mamba2-130m"))
    leng = Engine.for_lm(lm, TrainConfig(fsdp=True), device="cpu", mesh=mesh)
    lst = leng.init_state(tfm.init(lm, g))
    for name, s in (("domst", st), ("mamba2", lst)):
        for part, tree in (("params", s.params), ("mu", s.opt_state.mu),
                           ("nu", s.opt_state.nu)):
            out[f"{name} {part}"] = _held_bytes(tree, mesh)
    return out


def seed_steps(rank, world, *, mesh_shape, params, batches, tc):
    """``domst.make_stacked_train_step(mesh=)`` (smoke Dom-ST) from full
    host params and a fresh optimizer state over ``batches``: per-step
    host losses and the final host params."""
    import torch
    from repro_torch.configs import TrainConfig, get_config, smoke_variant
    from repro_torch.core import domst
    from repro_torch.distributed.sharding import full_host
    from repro_torch.optim import make_optimizer
    cfg = smoke_variant(get_config("domst"))
    tc = TrainConfig(**tc)
    step = domst.make_stacked_train_step(cfg, tc, mesh=_mesh(mesh_shape),
                                         device="cpu")
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    opt = make_optimizer(tc)[0](p)
    losses = []
    for b in batches:
        p, opt, m = step(p, opt, b)
        losses.append(full_host(m["loss"]))
    return {"losses": losses, "params": {k: full_host(v) for k, v in p.items()},
            "placements": {k: str(v.placements) for k, v in p.items()}}
