"""Shared by the served-slice parity tests of the recurrent and SSM archs
(``test_torch_serve_mamba2.py``, ``test_torch_serve_recurrentgemma.py``):
the reference's paged ``InferenceEngine`` and ``Scheduler`` against the
port's, on the CPU at smoke size, from the same params.

The reference runs on a 1x1 mesh with Auto axes (jax 0.9 rejects its
default explicit-sharding mesh), with its Pallas paged-attention kernel
in interpret mode (``REPRO_PAGED_ATTN=1``, set by the tests). The queue:
prompts of 20, 5, 18 and 6 tokens (20 is longer than the smoke window of
16, so a local layer's ring keeps only the window and the pages get the
ring's positions), 2 slots, max_len 32, 4-token pages, 4 new tokens each
(8 on the damped params).

Two params: the reference's init (``init``), and the same with every
layer's output projection scaled by 0.1 (``damped``): the residual stream
then carries the token's embedding, the model repeats itself now and
then, and the n-gram drafter's drafts are accepted in part, so a verify
step rolls recurrent state back to a snapshot other than the last.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import AxisType

from repro.configs import get_config as j_get_config
from repro.configs import smoke_variant as j_smoke_variant
from repro.models import transformer as jtfm
from repro.serve import InferenceEngine as JEngine
from repro.serve import NgramDrafter as JNgram
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro_torch.configs import get_config, smoke_variant
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as tfm
from repro_torch.serve import (
    InferenceEngine, NgramDrafter, Request, Scheduler,
)

LENS = [20, 5, 18, 6]
PS, SLOTS, MAX_LEN, GEN = 4, 2, 32, 4
REL_BF16 = 3e-2       # test_torch_serve_lm.py's bf16 logits tolerance
MODES = [{}, {"prefill_chunk": 3}, {"spec_k": 3}]
MODE_IDS = ["whole", "chunked", "spec3"]
STAT_KEYS = ("prefill_chunks", "spec_proposed", "spec_accepted",
             "decode_steps", "decode_tokens", "prefill_tokens")


def cfgs(arch):
    return j_smoke_variant(j_get_config(arch)), smoke_variant(get_config(arch))


def params(arch, kind="init"):
    """The reference's init of the smoke config, as numpy, or ``damped``:
    the same with the layers' output projections scaled by 0.1."""
    tree = jax.tree.map(np.asarray, jtfm.init(cfgs(arch)[0],
                                              jax.random.key(0)))
    if kind == "init":
        return tree

    def damp(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        return a * np.float32(0.1) if name in ("w_out", "wo", "w_down") else a
    return jax.tree_util.tree_map_with_path(damp, tree)


def prompts(vocab):
    """Prompts of LENS tokens, drawn from a seed."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in LENS]


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def check_served(arch, kind, mode):
    """Serve the queue through both engines in float32 in ``mode``: the
    greedy streams and the scheduler's counts must be equal, and no
    kernel may launch on the CPU."""
    tree = params(arch, kind)
    gen = GEN if kind == "init" else 2 * GEN
    prompt_list = prompts(cfgs(arch)[1].vocab_size)
    before = [f.launches for f in tfm.KERNELS]
    want, want_stats = serve_ref(arch, tree, prompt_list, gen=gen, **mode)
    got, got_stats = serve_port(arch, tree, prompt_list, gen=gen, **mode)
    assert got == want
    for key in STAT_KEYS:
        assert got_stats[key] == want_stats[key], key
    if mode.get("prefill_chunk"):
        assert got_stats["prefill_chunks"] > 0
    if mode.get("spec_k") and kind == "damped":
        # drafts accepted in part: verify rolled back to inner snapshots
        assert 0 < got_stats["spec_accepted"] < got_stats["spec_proposed"]
    assert [f.launches for f in tfm.KERNELS] == before   # CPU: plain versions


def serve_ref(arch, tree, prompt_list, *, gen=GEN, prefill_chunk=0,
              spec_k=0):
    jcfg, _ = cfgs(arch)
    eng = JEngine(jcfg, mesh=_mesh(), slots=SLOTS, dtype=jnp.float32,
                  max_len=MAX_LEN, paged=True, page_size=PS,
                  prefill_chunk=prefill_chunk)
    state = eng.init_state(jax.tree.map(jnp.array, tree))
    sched = JScheduler(eng, state, spec_k=spec_k,
                       drafter=JNgram() if spec_k else None)
    out = sched.run([JRequest(rid=i, max_new=gen, prompt=p)
                     for i, p in enumerate(prompt_list)])
    return out, dict(sched.stats)


def serve_port(arch, tree, prompt_list, *, gen=GEN, prefill_chunk=0,
               spec_k=0):
    _, cfg = cfgs(arch)
    eng = InferenceEngine(cfg, slots=SLOTS, dtype=torch.float32,
                          max_len=MAX_LEN, page_size=PS,
                          prefill_chunk=prefill_chunk, device="cpu")
    sched = Scheduler(eng, eng.init_state(params_from_jax(tree)),
                      spec_k=spec_k, drafter=NgramDrafter() if spec_k else None)
    out = sched.run([Request(rid=i, max_new=gen, prompt=p)
                     for i, p in enumerate(prompt_list)])
    return out, dict(sched.stats)


def first_decode_logits_bf16(arch, tree):
    """Both slots admitted by whole-prompt prefill in bfloat16 (the first
    prompt longer than the window), then one fused decode step, in both
    frameworks. Returns (port logits, reference logits) as float32."""
    jcfg, cfg = cfgs(arch)
    prompt_list = prompts(cfg.vocab_size)[:SLOTS]
    table = np.arange(SLOTS * MAX_LEN // PS, dtype=np.int32).reshape(SLOTS, -1)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = tfm.cast_params(params_from_jax(tree), torch.bfloat16)
    n_pages = table.size
    jc = jtfm.init_paged_cache(jcfg, SLOTS, n_pages, PS, dtype=jnp.bfloat16)
    tc = tfm.init_paged_cache(cfg, SLOTS, n_pages, PS, dtype=torch.bfloat16)
    last = []
    for s, p in enumerate(prompt_list):
        jl, ring = jtfm.prefill(jp, jcfg, {"tokens": jnp.asarray(p[None])},
                                MAX_LEN, dtype=jnp.bfloat16)
        jc = jtfm.scatter_prefill_paged(jcfg, jc, ring,
                                        jnp.asarray(table[s]), s)
        _, tring = tfm.prefill(tp, cfg, {"tokens": torch.tensor(p[None])},
                               MAX_LEN, dtype=torch.bfloat16)
        tfm.scatter_prefill_paged(cfg, tc, tring, torch.tensor(table[s]), s)
        last.append(int(np.argmax(np.asarray(jl)[0])))
    toks = np.array(last, np.int32)[:, None]
    pos = np.array([len(p) for p in prompt_list], np.int32)
    act = np.ones(SLOTS, bool)
    jl, _ = jtfm.decode_step_paged(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                   jc, jnp.asarray(pos), jnp.asarray(table),
                                   jnp.asarray(act), dtype=jnp.bfloat16)
    tl, _ = tfm.decode_step_paged(tp, cfg, {"tokens": torch.tensor(toks)}, tc,
                                  torch.tensor(pos), torch.tensor(table),
                                  torch.tensor(act), dtype=torch.bfloat16)
    return tl.float().numpy(), np.asarray(jl, np.float32)
