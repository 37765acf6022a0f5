"""The port's serving policies — prefix cache, copy-on-write, preemption,
the host tier — and the engine hooks under them, against the reference's,
on the CPU at smoke size in float32 (the harness and its reference setup
are in ``torch_serve_parity.py``).

Each policy case mirrors a case of ``tests/test_serve.py`` and serves the
same queue through the reference's ``Scheduler`` and the port's: the
streams must be equal, and so must the scheduler's counts key by key
(``POLICY_KEYS``: prefix hits and hit tokens, CoW pages, preemptions,
restores, deferred admissions, host hits, spilled and restored pages).
The hooks are held one by one against the reference's: a swap blob's and
a spilled page's layout (leaf order, shapes, dtypes, ``None`` placement,
also at full width) and contents (within 1e-5 of each leaf's largest
magnitude), a swap-out into other page ids followed by one decode step
(logits within 1e-5 of the un-swapped state's), a spill and restore, a
copy-on-write, and recurrentgemma-2b's slot snapshots.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_serve_parity as parity  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import Scheduler as JScheduler  # noqa: E402
from repro.serve.state import gather_page_rows as j_gather_page_rows  # noqa: E402
from repro.serve.state import gather_slot_rows as j_gather_slot_rows  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serve import Request, Scheduler  # noqa: E402
from repro_torch.serve.state import (  # noqa: E402
    cache_leaves, gather_page_rows, gather_slot_rows,
)

torch.set_num_threads(1)
TOL = 1e-5
ARCHS3 = ["qwen2-1.5b", "gemma2-2b", "recurrentgemma-2b"]


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("REPRO_PAGED_ATTN", "1")


def _vocab(arch):
    return parity.cfgs(arch)[1].vocab_size


def _shared_prefix_specs(arch, shared, tails, gen=4, seed=0):
    rng = np.random.default_rng(seed)
    v = _vocab(arch)
    pre = rng.integers(0, v, shared)
    return [parity.spec(np.concatenate([pre, rng.integers(0, v, t)]), gen)
            for t in tails]


def _family_specs(arch, families, per_family, prefix_len, tail_len, gen=4):
    """Request i of family i % families: on a pool that fits one request,
    each admission reclaims the other family's cached pages."""
    rng = np.random.default_rng(0)
    v = _vocab(arch)
    pres = [rng.integers(0, v, prefix_len) for _ in range(families)]
    return [parity.spec(np.concatenate([pres[i % families],
                                        rng.integers(0, v, tail_len)]), gen)
            for i in range(families * per_family)]


# ---------------------------------------------------------------------------
# The policies, port against reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS3)
def test_prefix_cache_hit_matches_reference(arch):
    """test_serve.py:248: streams off prefix-cache hits equal the cold
    run's and the reference's; on the hybrid the resume replays the
    registered recurrent snapshot."""
    tree = parity.params(arch)
    specs = _shared_prefix_specs(arch, 24, [4, 4, 6])
    kw = dict(slots=2, max_len=48, page_size=8, prefill_chunk=6)
    cold, _ = parity.serve_both(arch, tree, specs, engine_kw=kw)
    hit, st = parity.serve_both(arch, tree, specs, engine_kw=kw,
                                sched_kw={"prefix_cache": True})
    assert hit == cold
    assert st["prefix_hits"] >= 1 and st["prefix_hit_tokens"] >= 24


def test_prefix_cache_exact_match_copy_on_write():
    """test_serve.py:268: a prompt fully covered by cached pages re-inserts
    its last token into a private copy-on-write page, in both packages."""
    arch = "qwen2-1.5b"
    tree = parity.params(arch)
    p = np.random.default_rng(5).integers(0, _vocab(arch), 16).astype(np.int32)
    kw = dict(slots=2, max_len=32, page_size=8)
    runs = []
    for make, sched_of, req in (
            (parity.ref_engine, JScheduler, JRequest),
            (parity.port_engine, Scheduler, Request)):
        eng, state = make(arch, tree, **kw)
        sched = sched_of(eng, state, prefix_cache=True)
        cold = sched.run([req(rid=0, prompt=p.copy(), max_new=4)])
        warm = sched.run([req(rid=1, prompt=p.copy(), max_new=4)])
        assert warm[1] == cold[0]
        assert sched.stats["cow_pages"] == 1
        assert sched.stats["prefix_hit_tokens"] == len(p) - 1
        assert sched.lifetime_stats["prefix_lookups"] == 2
        runs.append((cold, warm, dict(sched.stats)))
    assert runs[0][:2] == runs[1][:2]
    for key in parity.POLICY_KEYS:
        assert runs[0][2][key] == runs[1][2][key], key


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "recurrentgemma-2b"])
def test_preemption_matches_reference(arch):
    """test_serve.py:290: under page pressure the preempting run swaps the
    youngest slot to host and restores it; streams equal the defer-only
    run's, the hybrid's recurrent rows travelling in the blob."""
    tree = parity.params(arch)
    v = _vocab(arch)
    specs = [parity.spec(np.random.default_rng(7 + i).integers(0, v, 10 + i),
                         4 + 2 * i) for i in range(3)]
    kw = dict(slots=2, max_len=24, page_size=8, num_pages=4)
    base, bst = parity.serve_both(arch, tree, specs, engine_kw=kw)
    got, st = parity.serve_both(arch, tree, specs, engine_kw=kw,
                                sched_kw={"preempt": True})
    assert got == base
    assert bst["deferred_admissions"] > 0
    assert st["preemptions"] >= 1 and st["restores"] == st["preemptions"]


@pytest.mark.parametrize("arch", ARCHS3)
def test_host_tier_matches_reference(arch):
    """test_serve.py:417: cold, device-hit and host-hit streams are equal;
    the tight pool spills each family's prefix and restores it for the
    family's next request."""
    tree = parity.params(arch)
    specs = _family_specs(arch, 2, 2, 16, 8)
    kw = dict(slots=1, max_len=28, page_size=8, prefill_chunk=6)
    cold, _ = parity.serve_both(arch, tree, specs,
                                engine_kw=dict(kw, num_pages=4))
    dev, dst = parity.serve_both(arch, tree, specs,
                                 engine_kw=dict(kw, num_pages=16),
                                 sched_kw={"prefix_cache": True})
    host, hst = parity.serve_both(arch, tree, specs,
                                  engine_kw=dict(kw, num_pages=4),
                                  sched_kw={"prefix_cache": True,
                                            "host_cache_bytes": 64 << 20})
    assert dev == cold and host == cold
    assert dst["prefix_hits"] >= 2 and dst["host_hits"] == 0
    assert hst["host_hits"] >= 2
    assert hst["host_restored_pages"] >= 4 and hst["host_spilled_pages"] >= 4
    assert hst["prefix_hit_tokens"] >= 32


def test_inflight_registration_matches_reference():
    """test_serve.py:446: a request admitted while a long prompt still
    chunk-prefills hits that prompt's completed pages."""
    arch = "olmo-1b"
    rng = np.random.default_rng(13)
    v = _vocab(arch)
    base = rng.integers(0, v, 32)
    specs = [parity.spec(base, 4), parity.spec(rng.integers(0, v, 4), 3),
             parity.spec(np.concatenate([base[:16], rng.integers(0, v, 4)]),
                         4)]
    tree = parity.params(arch)
    kw = dict(slots=2, max_len=36, page_size=4, prefill_chunk=4, num_pages=24)
    ref, _ = parity.serve_both(arch, tree, specs, engine_kw=kw)
    got, st = parity.serve_both(arch, tree, specs, engine_kw=kw,
                                sched_kw={"prefix_cache": True})
    assert got == ref
    assert st["prefix_hits"] >= 1 and st["prefix_hit_tokens"] >= 8


# ---------------------------------------------------------------------------
# The hooks, one by one, against the reference's
# ---------------------------------------------------------------------------
def _admitted(arch, pages):
    """Both engines (2 slots, 4-token pages, max_len 16) with the two
    prompts of 9 and 6 tokens admitted by whole prefill into ``pages``
    (one row a slot) and one decode step run."""
    tree = parity.params(arch)
    v = _vocab(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, v, n).astype(np.int32) for n in (9, 6)]
    kw = dict(slots=2, max_len=16, page_size=4, num_pages=12)
    out = []
    for make in (parity.ref_engine, parity.port_engine):
        eng, state = make(arch, tree, **kw)
        for s, p in enumerate(prompts):
            state = eng.assign_pages(state, s, pages[s])
            state, _ = eng.insert(state, {"tokens": p[None]}, s)
        state, _ = eng.decode(state)
        out.append((eng, state))
    return out


def _assert_blob_equal(got, want):
    """Leaf order, None placement, shapes, dtypes equal; contents within
    TOL of each leaf's largest magnitude (at least 1): the smoke model's
    keys reach ~20, where a float32 ulp is ~2e-6, and the two frameworks
    round the projections differently."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is None:
            continue
        w = np.asarray(w)
        assert isinstance(g, np.ndarray)
        assert g.shape == w.shape and g.dtype == w.dtype, \
            (g.shape, w.shape, g.dtype, w.dtype)
        scale = max(float(np.abs(w).max()) if w.size else 0.0, 1.0)
        assert float(np.abs(g.astype(np.float64) - w).max()) <= TOL * scale


def _decode_logits(eng, state, act):
    """One decode step's logits on copies of the state's cache."""
    cache = copy.deepcopy(state.cache)
    with torch.inference_mode():
        logits, _ = tfm.decode_step_paged(
            state.params, eng.cfg, {"tokens": state.last_tok[:, None]},
            cache, state.positions, state.page_table,
            torch.tensor(act), dtype=eng.dtype)
    return logits.numpy()


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "recurrentgemma-2b"])
def test_swap_out_in_matches_reference(arch):
    """swap_out's blob equals the reference's; swap_in into other,
    non-contiguous page ids in reverse order, then one decode step: the
    logits within 1e-5 of the un-swapped state's (the same framework: a copy moves no bit), the
    tokens equal."""
    pages = [[0, 1, 2, 3], [4, 5, 6, 7]]
    (jeng, jstate), (eng, state) = _admitted(arch, pages)
    jblob = jeng.swap_out(jstate, 0, pages[0])
    blob = eng.swap_out(state, 0, pages[0])
    _assert_blob_equal(blob["kv"], jblob["kv"])
    _assert_blob_equal(blob["rec"], jblob["rec"])
    for key in ("pos", "last_tok"):
        assert blob[key] == jblob[key]
    for key in ("temp", "top_k", "top_p", "rep"):
        assert blob["samp"][key] == jblob["samp"][key]
    for key in ("key", "presence"):
        assert blob["samp"][key].dtype == jblob["samp"][key].dtype
        np.testing.assert_array_equal(blob["samp"][key], jblob["samp"][key])
    act = np.ones(2, bool)
    want = _decode_logits(eng, state, act)
    state = eng.release_pages(state, 0)
    state = eng.swap_in(state, 0, [11, 9, 8, 10], blob)
    got = _decode_logits(eng, state, act)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    state, toks = eng.decode(state)
    assert (toks == want.argmax(-1)).all()


def test_spill_restore_and_copy_on_write():
    """spill_page's blob equals the reference's; restore_pages into other
    ids brings back every pool row to the bit; copy_pages duplicates
    k, v and pos."""
    arch = "qwen2-1.5b"
    pages = [[0, 1, 2, 3], [4, 5, 6, 7]]
    (jeng, jstate), (eng, state) = _admitted(arch, pages)
    blobs = [eng.spill_page(state, p) for p in pages[0]]
    for p, b in zip(pages[0], blobs):
        _assert_blob_equal(b, jeng.spill_page(jstate, p))
    state = eng.restore_pages(state, [8, 10, 9, 11], blobs)
    pools = [c for c in state.cache if isinstance(c, tfm.PagedKVCache)]
    for pool in pools:
        for t in pool:
            assert torch.equal(t[[8, 10, 9, 11]], t[[0, 1, 2, 3]])
    state = eng.copy_pages(state, [4, 5], [2, 3])
    for pool in pools:
        for t in pool:
            assert torch.equal(t[[2, 3]], t[[4, 5]])


def test_slot_state_roundtrip_recurrentgemma():
    """get_slot_state on the hybrid equals the reference's snapshot; a
    snapshot set into the other slot makes its rows equal."""
    arch = "recurrentgemma-2b"
    pages = [[0, 1, 2, 3], [4, 5, 6, 7]]
    (jeng, jstate), (eng, state) = _admitted(arch, pages)
    snap = eng.get_slot_state(state, 0)
    _assert_blob_equal(snap, jeng.get_slot_state(jstate, 0))
    assert any(r is not None for r in snap)
    state = eng.set_slot_state(state, 1, snap)
    leaves = cache_leaves(eng.cfg)
    _assert_blob_equal(gather_slot_rows(state.cache, leaves, 1), snap)
    assert eng.has_recurrent_state


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "recurrentgemma-2b",
                                  "gemma2-2b", "mamba2-130m"])
def test_blob_layout_matches_reference_at_full_width(arch):
    """At the full configs (recurrentgemma-2b: 8 repetitions of its
    pattern and a suffix; mamba2-130m: no page pool) the page and slot
    blobs have the reference's leaf order, shapes, dtypes and None
    placement, on a 3-page pool."""
    jcfg, cfg = j_get_config(arch), get_config(arch)
    kw = dict(slots=2, num_pages=3, page_size=16)
    jcache = jtfm.init_paged_cache(jcfg, dtype=jnp.float32, **kw)
    cache = tfm.init_paged_cache(cfg, dtype=torch.float32, **kw)
    axes = jtfm.paged_cache_axes(jcfg)
    leaves = cache_leaves(cfg)
    for got, want in (
            (gather_page_rows(cache, leaves, [2, 0]),
             j_gather_page_rows(axes, jcache, [2, 0])),
            (gather_slot_rows(cache, leaves, 1),
             j_gather_slot_rows(axes, jcache, 1))):
        assert [None if g is None else (g.shape, g.dtype) for g in got] == \
            [None if w is None else (w.shape, w.dtype) for w in want]
