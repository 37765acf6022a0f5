"""The serving runs that ``test_torch_serve_mesh_archs.py`` serves on a
gloo mesh and holds to one device, and whose one-device runs
``test_torch_serve_mesh_ref_*.py`` hold to the reference (not a test
module): mamba2-130m and a variant of it whose SSM heads do not divide
the model axis, both MoE decoders at an ample capacity, internvl2-2b with
patches, the host tier, and the training engine's hand-off; the queues,
the params (the reference's init in the port's layout) and ``serve_ref``,
which serves a run's queue through the reference's engine on one device.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

import torch_dist_harness as harness
import torch_serve_parity as parity
from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke_variant
from repro.models import transformer as jtfm
from repro.serve import InferenceEngine as JEngine
from repro.serve import Request as JRequest
from repro.serve import SamplingParams as JSamplingParams
from repro.serve import Scheduler as JScheduler
from repro_torch.convert import params_from_jax

MOE = ["qwen3-moe-30b-a3b", "deepseek-moe-16b"]
MAMBA = "mamba2-130m"
# mamba2 with 3 SSM heads of 32 on 96 inner channels: a model axis of 2
# splits the channels and leaves the heads whole
FEW_HEADS = {"d_model": 48}
AMPLE = {"moe": {"capacity_factor": 4.0}}
VLM = "internvl2-2b"
HOST_ARCHS = ("qwen2-1.5b", "recurrentgemma-2b")
LENS = [8, 5, 7, 6]
PAGED = dict(slots=4, max_len=16, page_size=4, prefill_chunk=3)
WHOLE = dict(slots=4, max_len=16, page_size=4)
CONTIG = dict(slots=4, max_len=16, paged=False)
SPEC = ({"spec_k": 3}, ("script", 2, None))
HOST_ENGINE = dict(slots=1, max_len=28, page_size=8, prefill_chunk=6,
                   num_pages=4)
HOST_SCHED = dict(prefix_cache=True, host_cache_bytes=64 << 20)
TC = dict(learning_rate=1e-3, total_steps=10, warmup_steps=1, eps=1e-4)


def jcfg(arch, changes=None):
    """The reference's smoke config of ``arch`` with ``changes`` (as
    ``torch_dist_harness.smoke_cfg`` changes the port's)."""
    cfg = j_smoke_variant(j_get_config(arch))
    changes = dict(changes or {})
    if "moe" in changes:
        changes["moe"] = dataclasses.replace(cfg.moe, **changes["moe"])
    return cfg.replace(**changes) if changes else cfg


def jtree(arch, changes=None, kind="init"):
    """The reference's init of the (changed) smoke config, as numpy;
    ``kind="damped"``: the layers' output projections scaled by 0.1
    (``torch_serve_parity.params``)."""
    if not changes:
        return parity.params(arch, kind)
    return jax.tree.map(np.asarray, jtfm.init(jcfg(arch, changes),
                                              jax.random.key(0)))


def port_tree(arch, changes=None, kind="init"):
    """``jtree`` in the port's layout, as numpy."""
    tree = params_from_jax(jtree(arch, changes, kind))

    def host(t):
        if isinstance(t, dict):
            return {k: host(v) for k, v in t.items()}
        if isinstance(t, list):
            return [host(v) for v in t]
        return t.numpy()
    return host(tree)


def queue(arch, changes=None, patches=False, lens=LENS, gen=8):
    cfg = harness.smoke_cfg(arch, changes)
    rng = np.random.default_rng(0)
    out = []
    for n in lens:
        p = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        extras = {"patches": rng.normal(size=(cfg.num_patches,
                                              cfg.frontend_dim))
                  .astype(np.float32)} if patches else {}
        out.append((p, gen, None, extras))
    return out


def family_queue(arch):
    """Request i of family i % 2 (16-token prefixes, 8-token tails): on a
    pool that fits one request each admission spills the other family's
    cached pages, and the family's next request restores them."""
    cfg = harness.smoke_cfg(arch)
    rng = np.random.default_rng(0)
    pres = [rng.integers(0, cfg.vocab_size, 16) for _ in range(2)]
    return [(np.concatenate([pres[i % 2], rng.integers(0, cfg.vocab_size, 8)])
             .astype(np.int32), 4, None) for i in range(4)]


def mesh_runs(names=None, float64=True):
    """(keys, runs) of the (2, 2) cases whose key starts with one of
    ``names`` (all by default), with or without the float64 ones; a
    scripted drafter's truth is the run of the key it names."""
    keys, runs = [], []

    def add(key, **run):
        if names is not None and key[0] not in names:
            return
        if run.get("dtype") == "float64" and not float64:
            return
        if run.get("drafter") and run["drafter"][0] == "script":
            run["drafter"] = ("script", 2, keys.index(run["drafter"][2]))
        keys.append(key)
        runs.append(run)
    for name, changes in ((MAMBA, None), ("few-heads", FEW_HEADS)):
        tree, q = port_tree(MAMBA, changes), queue(MAMBA, changes)
        base = dict(arch=MAMBA, cfg=changes, params=tree, requests=q)
        add((name, "contiguous"), engine=CONTIG, sched={}, **base)
        add((name, "paged"), engine=PAGED, sched={}, **base)
        add((name, "spec"), engine=WHOLE, sched=SPEC[0],
            drafter=("script", 2, (name, "contiguous")), **base)
        for kind, eng in (("contiguous", CONTIG), ("paged", PAGED)):
            add((name, f"{kind} float64"), engine=eng, sched={},
                dtype="float64", **base)
    for arch in MOE:
        base = dict(arch=arch, cfg=AMPLE, params=port_tree(arch),
                    requests=queue(arch))
        add((arch, "whole"), engine=WHOLE, sched={}, **base)
        add((arch, "paged"), engine=PAGED, sched={}, **base)
        add((arch, "spec"), engine=WHOLE, sched=SPEC[0],
            drafter=("script", 2, (arch, "whole")), **base)
    for gate in (False, True):
        changes = {"contribution_gate": gate}
        base = dict(arch=VLM, cfg=changes, params=port_tree(VLM, changes),
                    requests=queue(VLM, changes, patches=True))
        eng = dict(slots=4, max_len=24, page_size=4)
        add((VLM, f"gate {gate}"), engine=dict(eng, prefill_chunk=3),
            sched={}, **base)
        add((VLM, f"gate {gate} spec"), engine=eng, sched=SPEC[0],
            drafter=("script", 2, (VLM, f"gate {gate}")), **base)
    for arch in HOST_ARCHS:
        add((arch, "host tier"), arch=arch, params=port_tree(arch),
            requests=family_queue(arch), engine=HOST_ENGINE,
            sched=HOST_SCHED)
    return keys, runs


def on_mesh(tmp_path_factory):
    """(keys, runs, {key: rank 0's result}) of every (2, 2) case of
    ``mesh_runs``, every rank's streams equal."""
    keys, runs = mesh_runs()
    got = harness.spawn("serve_runs", 4, tmp_path_factory.mktemp("mesh"),
                        limit_s=300, mesh_shape=(2, 2), runs=runs)
    for r in got[1:]:
        assert [x["streams"] for x in r] == [x["streams"] for x in got[0]]
    return keys, runs, dict(zip(keys, got[0]))


def serve_ref(run, tree=None, truth=None):
    """A float32 run of ``mesh_runs`` served through the reference's paged
    (or contiguous) engine and scheduler on one device, from ``tree`` (the
    reference's layout; the run's arch and config changes' init by
    default); a scripted drafter's truth is ``truth`` (the reference's
    own streams of the run it names). Returns (streams, stats)."""
    cfg = jcfg(run["arch"], run.get("cfg"))
    if tree is None:
        tree = jtree(run["arch"], run.get("cfg"))
    engine = dict(run["engine"])
    paged = engine.pop("paged", True)
    eng = JEngine(cfg, mesh=parity._mesh(), dtype=jnp.float32, paged=paged,
                  **engine)
    state = eng.init_state(jax.tree.map(jnp.array, tree))
    drafter = None
    if run.get("drafter"):
        assert run["drafter"][0] == "script", run["drafter"]
        drafter = harness.ScriptedDrafter(
            {np.asarray(r[0], np.int32).tobytes(): truth[i]
             for i, r in enumerate(run["requests"])},
            cfg.vocab_size, run["drafter"][1])
    sched = JScheduler(eng, state, drafter=drafter, **run["sched"])
    specs = [parity.spec(r[0], r[1], r[3] if len(r) > 3 else None)
             for r in run["requests"]]
    out = sched.run(parity._requests(specs, JRequest, JSamplingParams))
    return ({k: [int(t) for t in v] for k, v in out.items()},
            dict(sched.stats))


def handoff(fsdp, tmp_path_factory):
    """The (2, 2) training engine's hand-off (``handoff_runs``) of
    mamba2-130m, with or without FSDP: rank 0's result, every rank's
    streams equal."""
    cfg = harness.smoke_cfg(MAMBA)
    from repro_torch.data.tokens import synthetic_token_batch
    tmp = tmp_path_factory.mktemp("handoff")
    batches = [synthetic_token_batch(cfg, 4, 16, seed=s) for s in range(2)]
    got = harness.spawn(
        "handoff_runs", 4, tmp, limit_s=240, mesh_shape=(2, 2),
        arch=MAMBA, params=port_tree(MAMBA), batches=batches,
        tc=dict(TC, fsdp=fsdp, remat="block" if fsdp else "none"),
        engine=WHOLE, requests=queue(MAMBA), path=str(tmp / "ck.npz"))
    for r in got[1:]:
        assert r["streams"] == got[0]["streams"]
    return got[0]
