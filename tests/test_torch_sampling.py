"""The port's sampler (``repro_torch/serve/sampling.py``) against the
reference's, and sampled streams through the port's engine against the
reference's ``Scheduler``, on the CPU at smoke size in float32 (the
harness is in ``torch_serve_parity.py``).

The reference keys each draw with JAX's threefry2x32; the port computes
the same cipher in int64 tensor arithmetic. ``base_key`` and ``fold_in``
must equal JAX's to the bit, and so must the random words of a draw
under the configuration ``jax_threefry_partitionable`` (the test reads
it); the Gumbel noise is held within 1e-6 (``log`` may round in another
last bit), and ``draw`` must give the reference's token for token over a
grid of temperature, top-k, top-p, repetition penalty and presence.
Sampled streams must equal the reference's whole, chunked, with
``spec_k=3``, preempted and off prefix hits; the cases mirror
``tests/test_serve_sampling.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_serve_parity as parity  # noqa: E402
from repro.serve import NgramDrafter as JNgram  # noqa: E402
from repro.serve import sampling as jsampling  # noqa: E402
from repro_torch.serve import NgramDrafter, sampling  # noqa: E402

torch.set_num_threads(1)
GEN = 6
LENS = [8, 5, 7, 6]
#: the reference's heterogeneous workload: temps, filters, seeds, a greedy row
MIXED = [dict(temperature=0.8, top_p=0.9, seed=11),
         dict(),
         dict(temperature=1.0, top_k=40, rep_penalty=1.3, seed=12),
         dict(temperature=0.6, top_k=8, top_p=0.95, seed=13)]
PAGED = dict(slots=2, max_len=16, page_size=4)


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("REPRO_PAGED_ATTN", "1")


def _keys(seeds):
    return torch.tensor(np.stack([sampling.base_key(s) for s in seeds])
                        .astype(np.int64))


# ---------------------------------------------------------------------------
# The PRNG and draw(), to the bit
# ---------------------------------------------------------------------------
def test_base_key_and_fold_in_match_reference():
    seeds = [0, 1, 7, 11, 2 ** 31 - 1, 2 ** 31 + 5, 2 ** 32 - 1, -1, -5]
    positions = [0, 1, 2, 17, 1000, 65535, 2 ** 31 - 1]
    for seed in seeds:
        want_key = jsampling.base_key(seed)
        got_key = sampling.base_key(seed)
        assert got_key.dtype == want_key.dtype
        np.testing.assert_array_equal(got_key, want_key)
        got = sampling.fold_in(_keys([seed] * len(positions)),
                               torch.tensor(positions, dtype=torch.int32))
        for pos, g in zip(positions, got.numpy()):
            want = np.asarray(jax.random.fold_in(jnp.asarray(want_key), pos))
            np.testing.assert_array_equal(g.astype(np.uint32), want)


def test_random_bits_follow_the_threefry_partitionable_config():
    """The port lays its words out as ``jax_threefry_partitionable=True``
    does; the test reads that config: where it is on (jax 0.9.0), JAX's
    own bits are the port's; where off, they differ, and JAX gives the
    port's under the config switched on."""
    key = np.asarray(jax.random.fold_in(jax.random.PRNGKey(3), 7))
    got = sampling.random_bits(torch.tensor(key.astype(np.int64))[None],
                               5000).numpy()[0].astype(np.uint32)
    on = bool(jax.config.jax_threefry_partitionable)
    want = np.asarray(jax.random.bits(jnp.asarray(key), (5000,)))
    assert np.array_equal(got, want) == on
    with jax.threefry_partitionable(True):
        want = np.asarray(jax.random.bits(jnp.asarray(key), (5000,)))
    np.testing.assert_array_equal(got, want)
    with jax.threefry_partitionable(True):
        g = np.asarray(jax.random.gumbel(jnp.asarray(key), (5000,)))
    port = sampling.gumbel(torch.tensor(key.astype(np.int64))[None],
                           5000).numpy()[0]
    assert np.abs(port - g).max() <= 1e-6


def _draw_both(logits, **kw):
    """``draw`` through both packages on the same inputs (numpy)."""
    want = np.asarray(jsampling.draw(
        jnp.asarray(logits), **{k: jnp.asarray(v) for k, v in kw.items()}))
    tkw = {k: torch.tensor(v.astype(np.int64) if k == "keys" else v)
           for k, v in kw.items()}
    got = sampling.draw(torch.tensor(logits), **tkw).numpy()
    return got, want


def _grid_args(rng, S, V):
    return dict(
        keys=np.stack([sampling.base_key(int(s))
                       for s in rng.integers(0, 10 ** 6, S)]),
        positions=rng.integers(0, 4096, S).astype(np.int32),
        temperature=rng.choice([0.2, 0.6, 0.8, 1.0, 1.7], S).astype(np.float32),
        top_k=rng.choice([0, 1, 3, 40, V], S).astype(np.int32),
        top_p=rng.choice([1.0, 0.95, 0.9, 0.5, 1e-6], S).astype(np.float32),
        rep_penalty=rng.choice([1.0, 1.1, 1.3, 0.7], S).astype(np.float32),
        presence=rng.random((S, V)) < 0.2)


@pytest.mark.parametrize("V", [32, 512, 4099])
def test_draw_matches_reference_token_for_token(V):
    rng = np.random.default_rng(V)
    S = 16
    for trial in range(6):
        logits = (rng.normal(0, 1 + trial, (S, V))).astype(np.float32)
        got, want = _draw_both(logits, **_grid_args(rng, S, V))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32


def _default_args(S, V, **over):
    kw = dict(keys=np.tile(sampling.base_key(0)[None], (S, 1)),
              positions=np.zeros((S,), np.int32),
              temperature=np.ones((S,), np.float32),
              top_k=np.zeros((S,), np.int32),
              top_p=np.ones((S,), np.float32),
              rep_penalty=np.ones((S,), np.float32),
              presence=np.zeros((S, V), bool))
    kw.update(over)
    return kw


def test_draw_top_k_one_and_tiny_top_p_are_argmax():
    """test_serve_sampling.py:73 and :81."""
    logits = np.random.default_rng(0).normal(0, 3, (4, 32)).astype(np.float32)
    for pos in (0, 7, 100):
        got, want = _draw_both(logits, **_default_args(
            4, 32, top_k=np.ones((4,), np.int32),
            positions=np.full((4,), pos, np.int32)))
        assert (got == logits.argmax(-1)).all() and (got == want).all()
    got, want = _draw_both(logits, **_default_args(
        4, 32, top_p=np.full((4,), 1e-6, np.float32)))
    assert (got == logits.argmax(-1)).all() and (got == want).all()


def test_draw_top_k_restricts_support():
    """test_serve_sampling.py:88."""
    logits = np.random.default_rng(2).normal(0, 1, (64, 32)).astype(np.float32)
    got, want = _draw_both(logits, **_default_args(
        64, 32, top_k=np.full((64,), 3, np.int32),
        positions=np.arange(64, dtype=np.int32)))
    np.testing.assert_array_equal(got, want)
    for i, t in enumerate(got):
        assert int(t) in np.argsort(-logits[i])[:3], i
    assert len(set(got.tolist())) > 1


def test_draw_rep_penalty_flips_present_winner():
    """test_serve_sampling.py:98: with top_k=1 the draw is the
    post-penalty argmax; penalty 1.0 is the off switch."""
    logits = np.full((1, 8), -5.0, np.float32)
    logits[0, 2], logits[0, 5] = 2.0, 1.9
    presence = np.zeros((1, 8), bool)
    presence[0, 2] = True
    got, want = _draw_both(logits, **_default_args(
        1, 8, top_k=np.ones((1,), np.int32), presence=presence,
        rep_penalty=np.full((1,), 2.0, np.float32)))
    assert got[0] == want[0] == 5
    got, want = _draw_both(logits, **_default_args(
        1, 8, top_k=np.ones((1,), np.int32), presence=presence))
    assert got[0] == want[0] == 2


def test_draw_position_folds_decorrelate():
    """test_serve_sampling.py:117: uniform logits, one base key: the
    positional fold gives different draws across positions and the same
    on replay."""
    logits = np.zeros((64, 32), np.float32)
    kw = _default_args(64, 32, positions=np.arange(64, dtype=np.int32))
    a, want = _draw_both(logits, **kw)
    b, _ = _draw_both(logits, **kw)
    assert (a == b).all() and (a == want).all()
    assert len(set(a.tolist())) > 4


# ---------------------------------------------------------------------------
# Sampled streams through the engine, against the reference's Scheduler
# ---------------------------------------------------------------------------
def _specs(arch, params=None, lens=LENS, gen=GEN, seed=0):
    rng = np.random.default_rng(seed)
    v = parity.cfgs(arch)[1].vocab_size
    return [parity.spec(rng.integers(0, v, n), gen,
                        **(params[i % len(params)] if params else {}))
            for i, n in enumerate(lens)]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-2b",
                                  "recurrentgemma-2b"])
def test_temp_zero_equals_greedy(arch):
    """test_serve_sampling.py:153: temperature 0 (any seed) is the
    argmax path."""
    tree = parity.params(arch)
    ref, _ = parity.serve_both(arch, tree, _specs(arch), engine_kw=PAGED)
    zero, _ = parity.serve_both(
        arch, tree, _specs(arch, [dict(temperature=0.0, seed=99)]),
        engine_kw=PAGED)
    assert zero == ref


def test_sampled_streams_match_reference_whole_and_chunked():
    """test_serve_sampling.py:170–232: the mixed queue's streams equal the
    reference's, replay the same, move with the seed where they sample
    (the greedy row stays), equal their solo runs and the reference's
    contiguous layout, and do not change with 3-token chunks."""
    arch = "olmo-1b"
    tree = parity.params(arch)
    a, _ = parity.serve_both(arch, tree, _specs(arch, MIXED),
                             engine_kw=PAGED)
    b, _ = parity.serve_port_queue(arch, tree, _specs(arch, MIXED),
                                   engine_kw=PAGED)
    assert a == b
    bumped = [dict(p, seed=p["seed"] + 1) if p else p for p in MIXED]
    c, _ = parity.serve_port_queue(arch, tree, _specs(arch, bumped),
                                   engine_kw=PAGED)
    assert any(c[r] != a[r] for r in (0, 2, 3)) and c[1] == a[1]
    greedy, _ = parity.serve_port_queue(arch, tree, _specs(arch),
                                        engine_kw=PAGED)
    assert a[1] == greedy[1] and a[0] != greedy[0]
    specs = _specs(arch, MIXED)
    for i in (0, 2):
        solo, _ = parity.serve_port_queue(arch, tree, [specs[i]],
                                          engine_kw=dict(PAGED, slots=1))
        assert solo[0] == a[i], i
    jcfg, _ = parity.cfgs(arch)
    jeng = parity.JEngine(jcfg, mesh=parity._mesh(), slots=2, max_len=16,
                          dtype=jnp.float32)
    jsched = parity.JScheduler(
        jeng, jeng.init_state(jax.tree.map(jnp.array, tree)))
    contiguous = jsched.run(parity._requests(
        specs, parity.JRequest, parity.JSamplingParams))
    assert contiguous == a
    chunked, st = parity.serve_both(arch, tree, _specs(arch, MIXED),
                                    engine_kw=dict(PAGED, prefill_chunk=3))
    assert chunked == a and st["prefill_chunks"] >= 2 * len(LENS)


@pytest.mark.parametrize("arch", ["olmo-1b", "recurrentgemma-2b"])
def test_sampled_spec_matches_reference(arch):
    """test_serve_sampling.py:250: sampled streams with spec_k=3 and the
    n-gram drafter equal the spec_k=0 run and the reference's."""
    tree = parity.params(arch)
    ref, _ = parity.serve_both(arch, tree, _specs(arch, MIXED),
                               engine_kw=PAGED)
    got, _ = parity.serve_both(arch, tree, _specs(arch, MIXED),
                               engine_kw=PAGED, sched_kw={"spec_k": 3},
                               drafters=(JNgram(), NgramDrafter()))
    assert got == ref


def test_sampled_spec_accepts_correct_drafts():
    """test_serve_sampling.py:266: an oracle drafter proposing the true
    sampled continuation sees every draft accepted — the verify path's
    draws are the decode path's."""
    arch = "olmo-1b"
    tree = parity.params(arch)
    params = [dict(temperature=0.8, top_p=0.9, seed=21)]
    specs = _specs(arch, params)
    ref, _ = parity.serve_port_queue(arch, tree, specs, engine_kw=PAGED)

    class Oracle:
        def propose(self, wants):
            out = {}
            for slot, (ctx, k) in wants.items():
                ctx = np.asarray(ctx, np.int32)
                for rid, q in enumerate(specs):
                    p = q["prompt"]
                    if len(ctx) >= len(p) and (ctx[:len(p)] == p).all():
                        n = len(ctx) - len(p)
                        cont = ref[rid][n:n + k]
                        if cont:
                            out[slot] = np.asarray(cont, np.int32)
                        break
            return out

        def release(self, slot):
            pass

    got, st = parity.serve_port_queue(arch, tree, specs, engine_kw=PAGED,
                                      sched_kw={"spec_k": 3},
                                      drafter=Oracle())
    assert got == ref
    assert st["spec_accepted"] == st["spec_proposed"] > 0, st


class _AheadDrafter:
    """Proposes each slot's true continuation one token ahead (the tokens
    drawn at the positions after the next): the first draft is rejected
    where the stream does not repeat, and the rejected drafts are tokens
    the stream draws later — folded into presence early, the repetition
    penalty would move those later draws."""

    def __init__(self, specs, streams):
        self.specs, self.streams = specs, streams

    def propose(self, wants):
        out = {}
        for slot, (ctx, k) in wants.items():
            ctx = np.asarray(ctx, np.int32)
            for rid, q in enumerate(self.specs):
                p = q["prompt"]
                if len(ctx) >= len(p) and (ctx[:len(p)] == p).all():
                    n = len(ctx) - len(p)
                    cont = self.streams[rid][n + 1:n + 1 + k]
                    if cont:
                        out[slot] = np.asarray(cont, np.int32)
                    break
        return out

    def release(self, slot):
        pass


def test_sampled_verify_folds_only_consumed_inputs():
    """Rejected drafts never reach the repetition mask: with a drafter
    whose rejected drafts are the stream's later tokens and a strong
    penalty, spec_k=3 gives the non-speculative stream, as the
    reference's verify does."""
    arch = "olmo-1b"
    tree = parity.params(arch)
    params = [dict(temperature=1.0, top_k=8, rep_penalty=3.0, seed=60 + i)
              for i in range(4)]
    specs = _specs(arch, params, gen=10)
    ref, _ = parity.serve_port_queue(arch, tree, specs,
                                     engine_kw=dict(PAGED, max_len=20))
    drafters = (_AheadDrafter(specs, ref), _AheadDrafter(specs, ref))
    got, st = parity.serve_both(arch, tree, specs,
                                engine_kw=dict(PAGED, max_len=20),
                                sched_kw={"spec_k": 3}, drafters=drafters)
    assert got == ref
    assert st["spec_proposed"] > st["spec_accepted"]


def test_sampled_preemption_matches_reference():
    """test_serve_sampling.py:298: the swap blob carries the sampling rows
    and presence; the preempted run's streams equal the deferred run's
    and the reference's."""
    arch = "olmo-1b"
    tree = parity.params(arch)
    v = parity.cfgs(arch)[1].vocab_size
    params = [dict(temperature=0.9, top_p=0.9, seed=31),
              dict(temperature=0.7, top_k=16, seed=32)]
    specs = [parity.spec(np.random.default_rng(7 + i).integers(0, v, 10 + i),
                         4 + 2 * i, **params[i % 2]) for i in range(3)]
    kw = dict(slots=2, max_len=24, page_size=8, num_pages=4)
    ref, base = parity.serve_both(arch, tree, specs, engine_kw=kw)
    got, st = parity.serve_both(arch, tree, specs, engine_kw=kw,
                                sched_kw={"preempt": True})
    assert got == ref
    assert base["deferred_admissions"] > 0
    assert st["preemptions"] >= 1 and st["restores"] >= 1


def test_sampled_prefix_cache_hit_matches_reference():
    """test_serve_sampling.py:313: a sampled request resuming past cached
    pages draws at the positions a cold prefill would."""
    arch = "qwen2-1.5b"
    tree = parity.params(arch)
    v = parity.cfgs(arch)[1].vocab_size
    rng = np.random.default_rng(5)
    pre = rng.integers(0, v, 24)
    specs = [parity.spec(np.concatenate([pre, rng.integers(0, v, t)]), 4,
                         temperature=0.8, top_p=0.9, seed=41 + i)
             for i, t in enumerate([4, 4, 6])]
    kw = dict(slots=2, max_len=48, page_size=8, prefill_chunk=6)
    ref, _ = parity.serve_both(arch, tree, specs, engine_kw=kw)
    got, st = parity.serve_both(arch, tree, specs, engine_kw=kw,
                                sched_kw={"prefix_cache": True})
    assert got == ref
    assert st["prefix_hits"] >= 1 and st["prefix_hit_tokens"] >= 24


def test_sampled_recurrent_host_tier_and_preemption():
    """recurrentgemma-2b sampled off host-tier hits and under preemption,
    against the reference: the snapshot and the swap blob carry the
    recurrent rows, the sampling rows and presence."""
    arch = "recurrentgemma-2b"
    tree = parity.params(arch)
    v = parity.cfgs(arch)[1].vocab_size
    rng = np.random.default_rng(0)
    pres = [rng.integers(0, v, 16) for _ in range(2)]
    specs = [parity.spec(np.concatenate([pres[i % 2], rng.integers(0, v, 8)]),
                         4, temperature=0.8, top_k=50, top_p=0.95,
                         rep_penalty=1.1, seed=50 + i) for i in range(4)]
    kw = dict(slots=1, max_len=28, page_size=8, prefill_chunk=6, num_pages=4)
    cold, _ = parity.serve_both(arch, tree, specs, engine_kw=kw)
    host, st = parity.serve_both(arch, tree, specs, engine_kw=kw,
                                 sched_kw={"prefix_cache": True,
                                           "host_cache_bytes": 64 << 20})
    assert host == cold and st["host_hits"] >= 2
    pkw = dict(slots=2, max_len=28, page_size=8, num_pages=6)
    base, bst = parity.serve_both(arch, tree, specs, engine_kw=pkw)
    got, pst = parity.serve_both(arch, tree, specs, engine_kw=pkw,
                                 sched_kw={"preempt": True})
    assert got == base == cold
    assert bst["deferred_admissions"] > 0 and pst["preemptions"] >= 1
