"""The port's served slice — ``InferenceEngine`` and ``Scheduler`` over the
paged pool — against the reference's, on the CPU at smoke size, and the
port's copies of the reference's host modules against the originals.

The reference engine runs on a 1x1 mesh with Auto axes (jax 0.9 rejects
its default explicit-sharding mesh), in float32, with its Pallas
paged-attention kernel in interpret mode (``REPRO_PAGED_ATTN=1``). The
queue mirrors ``tests/test_kernels_paged_attn.py::_serve``: prompt lengths
[8, 5, 7, 6], 2 slots, max_len 16, page size 4, 4 new tokens. Greedy
streams must be EQUAL in float32 under whole prefill, chunked prefill
(3 tokens a chunk) and ``spec_k=3`` with the n-gram drafter, and so must
the scheduler's chunk and speculation counts. In bfloat16 the first decode
step's logits are held within 3e-2 of their largest magnitude (a few
bfloat16 ulps: the two frameworks round at different places).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_variant as j_smoke_variant  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.obs import registry as jregistry  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.serve import InferenceEngine as JEngine  # noqa: E402
from repro.serve import NgramDrafter as JNgram  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import Scheduler as JScheduler  # noqa: E402
from repro.serve import sampling as jsampling  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.paged_attn.ops import paged_attention_fused  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.obs import registry, trace  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    InferenceEngine, NgramDrafter, Request, SamplingParams, Scheduler,
    sampling,
)

torch.set_num_threads(1)
SRC = Path(__file__).resolve().parents[1] / "src"
ARCH = "qwen2-1.5b"
LENS = [8, 5, 7, 6]
PS, SLOTS, MAX_LEN, GEN = 4, 2, 16, 4
REL_BF16 = 3e-2

_CFG = {}


def _cfgs():
    if not _CFG:
        _CFG["j"] = j_smoke_variant(j_get_config(ARCH))
        _CFG["t"] = smoke_variant(get_config(ARCH))
    return _CFG["j"], _CFG["t"]


def _params(kind):
    """The reference's init (``init``), or its tree with every leaf
    redrawn from numpy (``noisy``: biases and norm scales non-trivial)."""
    jcfg, _ = _cfgs()
    tree = jax.tree.map(np.asarray, jtfm.init(jcfg, jax.random.key(0)))
    if kind == "init":
        return tree
    rng = np.random.default_rng(1)

    def redraw(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            return (1 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        if name in ("bq", "bk", "bv"):
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        if name == "embedding":
            return (rng.normal(size=a.shape) * a.std()).astype(np.float32)
        fan_in = int(np.prod(a.shape[1:-1])) if name == "wo" else a.shape[1]
        return (rng.normal(size=a.shape) / fan_in ** 0.5).astype(np.float32)
    return jax.tree_util.tree_map_with_path(redraw, tree)


def _prompts(queue, vocab):
    """``random``: the reference test's queue; ``motif``: prompts cut from
    one repeated 3-token motif, so the n-gram drafter has drafts to offer
    and the verify path accepts some."""
    rng = np.random.default_rng(0)
    if queue == "random":
        return [rng.integers(0, vocab, n).astype(np.int32) for n in LENS]
    motif = rng.integers(0, vocab, 3)
    return [np.resize(np.roll(motif, i), n).astype(np.int32)
            for i, n in enumerate(LENS)]


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _serve_ref(tree, prompts, *, prefill_chunk=0, spec_k=0):
    jcfg, _ = _cfgs()
    eng = JEngine(jcfg, mesh=_mesh(), slots=SLOTS, dtype=jnp.float32,
                  max_len=MAX_LEN, paged=True, page_size=PS,
                  prefill_chunk=prefill_chunk)
    # the reference donates its state: hand it its own copy
    state = eng.init_state(jax.tree.map(jnp.array, tree))
    sched = JScheduler(eng, state, spec_k=spec_k,
                       drafter=JNgram() if spec_k else None)
    out = sched.run([JRequest(rid=i, max_new=GEN, prompt=p)
                     for i, p in enumerate(prompts)])
    return out, dict(sched.stats)


def _serve_port(tree, prompts, *, prefill_chunk=0, spec_k=0):
    _, cfg = _cfgs()
    eng = InferenceEngine(cfg, slots=SLOTS, dtype=torch.float32,
                          max_len=MAX_LEN, page_size=PS,
                          prefill_chunk=prefill_chunk, device="cpu")
    sched = Scheduler(eng, eng.init_state(params_from_jax(tree)),
                      spec_k=spec_k, drafter=NgramDrafter() if spec_k else None)
    out = sched.run([Request(rid=i, max_new=GEN, prompt=p)
                     for i, p in enumerate(prompts)])
    return out, dict(sched.stats)


@pytest.mark.parametrize("mode", [{}, {"prefill_chunk": 3}, {"spec_k": 3}],
                         ids=["whole", "chunked", "spec3"])
@pytest.mark.parametrize("params,queue", [("init", "random"),
                                          ("noisy", "random"),
                                          ("noisy", "motif")])
def test_served_streams_equal_reference(monkeypatch, params, queue, mode):
    monkeypatch.setenv("REPRO_PAGED_ATTN", "1")
    tree = _params(params)
    prompts = _prompts(queue, _cfgs()[1].vocab_size)
    launches = paged_attention_fused.launches
    want, want_stats = _serve_ref(tree, prompts, **mode)
    got, got_stats = _serve_port(tree, prompts, **mode)
    assert got == want
    for key in ("prefill_chunks", "spec_proposed", "spec_accepted",
                "decode_steps", "decode_tokens", "prefill_tokens"):
        assert got_stats[key] == want_stats[key], key
    if mode.get("prefill_chunk"):
        assert got_stats["prefill_chunks"] > 0
    if mode.get("spec_k") and queue == "motif":
        assert got_stats["spec_proposed"] > 0 and got_stats["spec_accepted"] > 0
    assert paged_attention_fused.launches == launches   # CPU: plain version


def test_first_decode_step_logits_bf16(monkeypatch):
    """Both slots admitted by whole-prompt prefill in bfloat16, then one
    fused decode step: logits within 3e-2 of their largest magnitude."""
    monkeypatch.setenv("REPRO_PAGED_ATTN", "1")
    jcfg, cfg = _cfgs()
    tree = _params("noisy")
    prompts = _prompts("random", cfg.vocab_size)[:SLOTS]
    table = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    bf = dict(dtype=jnp.bfloat16), dict(dtype=torch.bfloat16)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = tfm.cast_params(params_from_jax(tree), torch.bfloat16)
    jc = jtfm.init_paged_cache(jcfg, SLOTS, 8, PS, dtype=jnp.bfloat16)
    tc = tfm.init_paged_cache(cfg, SLOTS, 8, PS, dtype=torch.bfloat16)
    last = []
    for s, p in enumerate(prompts):
        jl, ring = jtfm.prefill(jp, jcfg, {"tokens": jnp.asarray(p[None])},
                                MAX_LEN, **bf[0])
        jc = jtfm.scatter_prefill_paged(jcfg, jc, ring,
                                        jnp.asarray(table[s]), s)
        tl, tring = tfm.prefill(tp, cfg, {"tokens": torch.tensor(p[None])},
                                MAX_LEN, **bf[1])
        tfm.scatter_prefill_paged(cfg, tc, tring, torch.tensor(table[s]), s)
        last.append(int(np.argmax(np.asarray(jl)[0])))
    toks = np.array(last, np.int32)[:, None]
    pos = np.array([len(p) for p in prompts], np.int32)
    act = np.ones(SLOTS, bool)
    jl, _ = jtfm.decode_step_paged(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                   jc, jnp.asarray(pos), jnp.asarray(table),
                                   jnp.asarray(act), **bf[0])
    tl, _ = tfm.decode_step_paged(tp, cfg, {"tokens": torch.tensor(toks)}, tc,
                                  torch.tensor(pos), torch.tensor(table),
                                  torch.tensor(act), **bf[1])
    want = np.asarray(jl, np.float32)
    err = np.abs(tl.float().numpy() - want).max()
    assert err <= REL_BF16 * np.abs(want).max(), (err, np.abs(want).max())


def test_engine_hooks_not_ported_raise():
    _, cfg = _cfgs()
    eng = InferenceEngine(cfg, slots=SLOTS, dtype=torch.float32,
                          max_len=MAX_LEN, page_size=PS, device="cpu")
    state = eng.init_state(tfm.init(cfg, torch.Generator().manual_seed(0)))
    assert eng.has_recurrent_state is False
    for call in (lambda: eng.copy_pages(state, [0], [1]),
                 lambda: eng.swap_out(state, 0, [0]),
                 lambda: eng.spill_page(state, 0),
                 lambda: eng.set_sampling(state, 0,
                                          SamplingParams(temperature=0.7))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    assert eng.set_sampling(state, 0, SamplingParams()) is state


# ---------------------------------------------------------------------------
# The copies of the reference's host modules
# ---------------------------------------------------------------------------
def test_sampling_copies():
    rng = np.random.default_rng(2)
    gen = {int(r): rng.integers(0, 500, int(rng.integers(1, 9))).tolist()
           for r in rng.permutation(6)}
    assert sampling.stream_digest(gen) == jsampling.stream_digest(gen)
    ctx = rng.integers(-3, 520, 40)
    np.testing.assert_array_equal(sampling.presence_row(ctx, 512),
                                  jsampling.presence_row(ctx, 512))
    for kw in ({}, {"temperature": 0.5, "top_k": 3, "top_p": 0.9}):
        assert SamplingParams(**kw).greedy == \
            jsampling.SamplingParams(**kw).greedy
    for bad in ({"top_k": -1}, {"top_p": 0.0}, {"rep_penalty": 0.0}):
        with pytest.raises(ValueError):
            SamplingParams(**bad).validate()
        with pytest.raises(ValueError):
            jsampling.SamplingParams(**bad).validate()


def test_ngram_drafter_copy():
    rng = np.random.default_rng(3)
    port, ref = NgramDrafter(), JNgram()
    for trial in range(20):
        wants = {s: (rng.integers(0, 6, int(rng.integers(1, 40))),
                     int(rng.integers(1, 5))) for s in range(3)}
        got, want = port.propose(wants), ref.propose(wants)
        assert got.keys() == want.keys()
        for s in got:
            np.testing.assert_array_equal(got[s], want[s])


def test_registry_copy():
    rng = np.random.default_rng(4)
    regs = [registry.MetricRegistry(), jregistry.MetricRegistry()]
    vals = rng.exponential(1.0, 700)
    for reg in regs:
        h = reg.histogram("serve.gap_s", exact_max=256)   # decimates
        for v in vals:
            h.record(float(v))
        g = reg.group("sched.run", {"a": 0, "b": 0.0})
        g["a"] += 3
        g["b"] = 1.5
        reg.series("serve.ttft_s")[7] = 0.25
        reg.counter("c").inc(2)
        reg.gauge("g").set(4.0)
    assert regs[0].snapshot() == regs[1].snapshot()
    assert registry.percentiles(vals) == jregistry.percentiles(vals)


def test_tracer_copy():
    tracers = [trace.Tracer(), jtrace.Tracer()]
    for tr in tracers:
        tr._t0 = 100.0
        run = tr.begin("run", at=100.0)
        for rid, (a, b, c) in enumerate([(100.1, 100.4, 100.9),
                                         (100.2, 100.5, 101.0)]):
            q = tr.begin("queued", tid=f"rid{rid}", at=100.0, rid=rid)
            tr.end(q, at=a)
            p = tr.begin("prefill", tid=f"rid{rid}", at=a, rid=rid)
            tr.end(p, at=b)
            d = tr.begin("decode", tid=f"rid{rid}", at=b, rid=rid)
            tr.end(d, at=c)
            tr.instant("finish", tid=f"rid{rid}", at=c, rid=rid, tokens=4)
        tr.end(run, at=101.0)
    evs = [tr.events() for tr in tracers]
    assert evs[0] == evs[1]
    assert trace.derive_request_metrics(evs[0]) == \
        jtrace.derive_request_metrics(evs[1])
    assert trace.span_coverage(evs[0]) == jtrace.span_coverage(evs[1])
    assert json.dumps(tracers[0].to_chrome()) == \
        json.dumps(tracers[1].to_chrome())


def test_lm_serve_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--requests", "4", "--prompt-len",
         "12", "--ragged", "--gen", "6", "--prefill-chunk", "5",
         "--spec-k", "3"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["device"] == "cpu" and res["requests"] == 4
    assert res["tokens"] == 4 * 6 and res["prefill_chunks"] > 0
    for key in ("tok_per_s", "prefill_tok_per_s", "decode_tok_per_s",
                "ttft_p50_s", "ttft_p99_s", "accepted_tok_per_step",
                "stream_digest"):
        assert key in res, key
