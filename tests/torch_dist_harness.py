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
