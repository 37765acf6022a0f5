"""The port's front ends, encoder and contribution gate against the
reference, on the CPU, in float32, at smoke size (``smoke_variant``: 2
layers, d_model 256; internvl2-2b's vision stub with 8 patches of 64
features, hubert-xlarge's audio stub with 64-feature frames, 4 heads of
64, ``causal=False``).

* both configs, field for field, and their smoke variants;
* ``sinusoidal_positions`` within 1e-6;
* the audio and VLM batches and ``TokenSource``, to the bit;
* the init tree and law through ``lm_params_from_jax``, ``frontend`` and
  ``gate`` included;
* ``embed_inputs`` of both front ends, within 1e-6 of scale;
* internvl2-smoke's paged paths: a whole prefill with patches, a
  text-only prompt in chunks, a decode and a verify step, every logits
  and the pools within 1e-5 of their largest magnitude, with the gate
  off and on; the gate also on qwen2-smoke through the same paths;
* hubert-smoke's forward at ``causal=False`` within 1e-5, and the first
  frame's output moved by the last frame;
* ``lm_loss`` and every gradient leaf against ``jax.value_and_grad`` of
  the reference's, each leaf within 1e-4 of its scale, and 5 steps of
  ``Engine.for_lm`` against the reference's engine at
  ``test_torch_train_lm.py``'s bounds;
* internvl2's served greedy streams and scheduler counts equal to the
  reference's, whole, in chunks (the scheduler admits a request with
  patches whole) and with ``spec_k=3``, and sampled streams (each draw
  keyed by a position that counts the patches); the engine's chunk step
  refusing patches; one bf16 decode step's logits within 3e-2 of their
  largest magnitude, and other images moving them;
* checkpoints crossing packages both ways, and the serve CLI on
  internvl2-smoke (its JSON keys, and its digest equal to the
  reference scheduler's on the launcher's queue) and hubert-smoke (the
  reference's refusal).

Params: the reference's init redrawn from numpy noise (``_noisy``) for
the model paths, where the init law's attention scores in the hundreds
would turn a float32 last-bit difference into 1e-4; the law itself with
rescaled attention projections (``test_torch_train_lm._jparams``) for
the loss and the engine; the law for the served streams. The
reference's paged paths run its Pallas kernel in interpret mode
(``REPRO_PAGED_ATTN=1``) on a 1x1 mesh with Auto axes.
"""
import dataclasses
import json
from argparse import Namespace

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_train_lm as tl  # noqa: E402
import torch_serve_parity as parity  # noqa: E402
from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_variant as j_smoke_variant  # noqa: E402
from repro.core import gating as jgating  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serve import NgramDrafter as JNgram  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    flatten, lm_params_from_jax, lm_params_to_jax, unflatten,
)
from repro_torch.core import gating  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serve import NgramDrafter, stream_digest  # noqa: E402
from repro_torch.train import Engine  # noqa: E402

torch.set_num_threads(1)
ARCHS = ["internvl2-2b", "hubert-xlarge"]
VLM = "internvl2-2b"
REL = 1e-5


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("REPRO_PAGED_ATTN", "1")


def _cfgs(arch, gate=False):
    return (j_smoke_variant(j_get_config(arch)).replace(
                contribution_gate=gate),
            smoke_variant(get_config(arch)).replace(contribution_gate=gate))


def _close_scaled(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _noisy(jcfg, seed=0):
    """The reference's init tree with every leaf redrawn from numpy:
    norm scales 1 + N(0, 0.1), biases N(0, 0.1), the embedding with its
    init's spread, weights with std 1/sqrt(inputs summed) (the scanned
    ``blocks`` leaves carry a leading repetition axis)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jtfm.init(jcfg, jax.random.key(seed)))

    def redraw(path, a):
        keys = [str(getattr(p, "key", p)) for p in path]
        name = keys[-1]
        shape = a.shape[1:] if keys[0] == "blocks" else a.shape
        if name == "scale":
            return (1 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        if name == "embedding":
            return (rng.normal(size=a.shape) * a.std()).astype(np.float32)
        if len(shape) == 1:
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1])) if name == "wo" else shape[0]
        return (rng.normal(size=a.shape) / fan_in ** 0.5).astype(np.float32)
    return jax.tree_util.tree_map_with_path(redraw, tree)


def _patches(cfg, n, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, cfg.num_patches, cfg.frontend_dim)).astype(
        np.float32)


def _shapes(t):
    if isinstance(t, dict):
        return {k: _shapes(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_shapes(v) for v in t]
    return tuple(t.shape)


# ---------------------------------------------------------------------------
# Configs, the position table, batches, init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference_field_for_field(arch):
    for j, t in ((j_get_config(arch), get_config(arch)), _cfgs(arch)):
        assert [f.name for f in dataclasses.fields(t)] == \
            [f.name for f in dataclasses.fields(j)]
        for f in dataclasses.fields(j):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.layer_kinds() == j.layer_kinds()
        assert t.supports_decode() == j.supports_decode()
    assert get_config("hubert-xlarge").causal is False


@pytest.mark.parametrize("seq_len,dim,offset", [(1, 2, 0), (37, 64, 0),
                                                (1024, 1280, 0),
                                                (9, 512, 300)])
def test_sinusoidal_positions_match_reference(seq_len, dim, offset):
    got = layers.sinusoidal_positions(seq_len, dim, offset)
    want = np.asarray(jlayers.sinusoidal_positions(seq_len, dim, offset))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_front_end_batches_bit_equal(arch):
    want_keys = {"hubert-xlarge": ["frames", "loss_mask", "targets"],
                 VLM: ["patches", "targets", "tokens"]}[arch]
    jcfg, cfg = _cfgs(arch)
    for j, t, seq in ((jcfg, cfg, 17), (j_get_config(arch),
                                        get_config(arch), 300)):
        for seed in (0, 7, 2**31 + 3):
            a = jtokens.synthetic_token_batch(j, 3, seq, seed=seed)
            b = tokens.synthetic_token_batch(t, 3, seq, seed=seed)
            assert sorted(a) == sorted(b) == want_keys
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                np.testing.assert_array_equal(a[k], b[k])
    js = jtokens.TokenSource(jcfg, 2, 19, seed=5)
    ts = tokens.TokenSource(cfg, 2, 19, seed=5)
    for step in (0, 1, 13):
        for k, v in js.host_batch(step).items():
            np.testing.assert_array_equal(ts.host_batch(step)[k], v)


@pytest.mark.parametrize("gate", [False, True], ids=["plain", "gated"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_tree_and_law(arch, gate):
    """The reference's tree after conversion, ``frontend`` and ``gate``
    beside the embedding; their weights by the fan-in law, biases 0."""
    jcfg, cfg = _cfgs(arch, gate)
    ref = lm_params_from_jax(jax.tree.map(np.asarray,
                                          jtfm.init(jcfg, jax.random.key(0))))
    port = tfm.init(cfg, torch.Generator().manual_seed(0))
    assert _shapes(port) == _shapes(ref)
    assert ("gate" in port) == gate and "frontend" in port
    groups = [port["frontend"]] + ([port["gate"]] if gate else [])
    for group in groups:
        for name, w in group.items():
            if w.dim() == 1:
                assert not w.any(), name
            else:
                assert abs(w.std().item() * w.shape[-2] ** 0.5 - 1) < 0.15, \
                    name


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_embed_inputs_match_reference(arch):
    jcfg, cfg = _cfgs(arch)
    tree = _noisy(jcfg)
    params = lm_params_from_jax(tree)
    batch = tokens.synthetic_token_batch(cfg, 2, 21, seed=4)
    batch.pop("targets")
    batch.pop("loss_mask", None)
    for dtype, jdt, rel in ((torch.float32, jnp.float32, 1e-6),
                            (torch.bfloat16, jnp.bfloat16, 2 ** -7)):
        want = jtfm.embed_inputs(jax.tree.map(jnp.asarray, tree), jcfg,
                                 {k: jnp.asarray(v) for k, v in batch.items()},
                                 jdt)
        got = tfm.embed_inputs(params, cfg, {k: torch.from_numpy(v) for k, v
                                             in batch.items()}, dtype)
        assert got.dtype == dtype and tuple(got.shape) == want.shape
        _close_scaled(got.float(), np.asarray(want, np.float32), rel)
    if arch == VLM:      # a step without patches embeds the tokens alone
        toks = {"tokens": batch["tokens"]}
        want = jtfm.embed_inputs(jax.tree.map(jnp.asarray, tree), jcfg,
                                 {"tokens": jnp.asarray(toks["tokens"])},
                                 jnp.float32)
        got = tfm.embed_inputs(params, cfg, {"tokens": torch.from_numpy(
            toks["tokens"])}, torch.float32)
        assert tuple(got.shape) == want.shape == (2, 21 - cfg.num_patches,
                                                  cfg.d_model)
        _close_scaled(got, want, 1e-6)


def test_contribution_gate_matches_reference():
    rng = np.random.default_rng(0)
    d = 48
    p = {"w1": rng.normal(size=(d, 64)) / d ** 0.5,
         "b1": 0.1 * rng.normal(size=64), "w2": rng.normal(size=(64, 1)) / 8}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 7, d)).astype(np.float32)
    for temp in (1.0, 0.5):
        want = jgating.contribution_gate({k: jnp.asarray(v) for k, v in
                                          p.items()}, jnp.asarray(x), temp)
        got = gating.contribution_gate({k: torch.from_numpy(v) for k, v in
                                        p.items()}, torch.from_numpy(x), temp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        ratio = got / torch.from_numpy(x)
        assert float(ratio.min()) > 0 and float(ratio.max()) < 2
        assert float(ratio.std()) > 0.05              # the weights differ
    xb = torch.from_numpy(x).bfloat16()
    pb = {k: torch.from_numpy(v) for k, v in p.items()}
    assert gating.contribution_gate(pb, xb).dtype == torch.bfloat16


def _jax_layers(caches):
    blocks = caches["blocks"]
    n_rep = np.asarray(blocks["0"].pos).shape[0]
    return [jax.tree.map(lambda a: np.asarray(a)[r], blocks[i])
            for r in range(n_rep) for i in sorted(blocks, key=int)]


def _close_caches(port, ref):
    for layer, (t, j) in enumerate(zip(port, _jax_layers(ref))):
        P = t.num_pages
        np.testing.assert_array_equal(t.pos[:P].numpy(), j.pos,
                                      err_msg=f"layer {layer} pos")
        _close_scaled(t.k[:P], j.k)
        _close_scaled(t.v[:P], j.v)


def _model_paths(jcfg, cfg, tree, seed=7):
    """Slot 0 admitted by a whole prefill of 20 tokens (after the image's
    patches for the VLM), slot 1 by a text-only 19-token prompt in chunks
    of 8, 8 and 3; then one fused decode step and one verify step of 3
    tokens with slot 1 inactive. Every logits and the pools held to the
    reference's."""
    jp = jax.tree.map(jnp.asarray, tree)
    params = lm_params_from_jax(tree)
    rng = np.random.default_rng(seed)
    P, ps, slots, max_len = 20, 4, 2, 40
    table = rng.permutation(P).astype(np.int32).reshape(slots, -1)
    jc = jtfm.init_paged_cache(jcfg, slots, P, ps, dtype=jnp.float32)
    tc = tfm.init_paged_cache(cfg, slots, P, ps, dtype=torch.float32)
    f32 = dict(dtype=jnp.float32), dict(dtype=torch.float32)

    inputs = {"tokens": rng.integers(0, cfg.vocab_size, (1, 20)).astype(
        np.int32)}
    if cfg.frontend == "vision_stub":
        inputs["patches"] = _patches(cfg, 1)
    n0 = sum(v.shape[1] for v in inputs.values())
    jl, ring = jtfm.prefill(jp, jcfg, {k: jnp.asarray(v) for k, v in
                                       inputs.items()}, max_len, **f32[0])
    tl_, tring = tfm.prefill(params, cfg, {k: torch.from_numpy(v) for k, v in
                                           inputs.items()}, max_len, **f32[1])
    _close_scaled(tl_, jl)
    jc = jtfm.scatter_prefill_paged(jcfg, jc, ring, jnp.asarray(table[0]), 0)
    tfm.scatter_prefill_paged(cfg, tc, tring, torch.tensor(table[0]), 0)
    _close_caches(tc, jc)

    chunk = rng.integers(0, cfg.vocab_size, (1, 19)).astype(np.int32)
    for lo, hi in ((0, 8), (8, 16), (16, 19)):
        jl, jc = jtfm.prefill_chunk(jp, jcfg, {"tokens": jnp.asarray(
            chunk[:, lo:hi])}, jc, jnp.asarray(table[1]), 1, lo, **f32[0])
        tl_, tc = tfm.prefill_chunk(params, cfg, {"tokens": torch.tensor(
            chunk[:, lo:hi])}, tc, torch.tensor(table[1]), 1, lo, **f32[1])
        _close_scaled(tl_, jl)
        _close_caches(tc, jc)

    steps = [("decode", np.array([[11], [12]], np.int32), [n0, 19],
              [True, True]),
             ("verify", rng.integers(0, cfg.vocab_size, (2, 3)).astype(
                 np.int32), [n0 + 1, 20], [True, False])]
    for kind, toks, pos, act in steps:
        fj = jtfm.decode_step_paged if kind == "decode" else \
            jtfm.verify_step_paged
        ft = tfm.decode_step_paged if kind == "decode" else \
            tfm.verify_step_paged
        jl, jc = fj(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc,
                    jnp.asarray(pos, jnp.int32), jnp.asarray(table),
                    jnp.asarray(act), **f32[0])
        tl_, tc = ft(params, cfg, {"tokens": torch.tensor(toks)}, tc,
                     torch.tensor(pos, dtype=torch.int32),
                     torch.tensor(table), torch.tensor(act), **f32[1])
        assert tuple(tl_.shape) == jl.shape
        _close_scaled(tl_, jl)
        _close_caches(tc, jc)


@pytest.mark.parametrize("arch,gate", [(VLM, False), (VLM, True),
                                       ("qwen2-1.5b", True)],
                         ids=["internvl2", "internvl2-gated", "qwen2-gated"])
def test_paths_match_reference(arch, gate):
    jcfg, cfg = _cfgs(arch, gate)
    before = [f.launches for f in tfm.KERNELS]
    _model_paths(jcfg, cfg, _noisy(jcfg))
    assert [f.launches for f in tfm.KERNELS] == before   # CPU: plain versions


def test_gate_moves_the_stream():
    """The gated model's prefill logits differ from the ungated one's on
    the same params: the gate is applied, not skipped."""
    jcfg, cfg = _cfgs("qwen2-1.5b", True)
    params = lm_params_from_jax(_noisy(jcfg))
    inputs = {"tokens": torch.arange(12)[None]}
    gated, _ = tfm.prefill(params, cfg, inputs, 16, dtype=torch.float32)
    plain, _ = tfm.prefill(params, cfg.replace(contribution_gate=False),
                           inputs, 16, dtype=torch.float32)
    assert float((gated - plain).abs().max()) > 1e-3 * float(
        plain.abs().max())


def test_hubert_forward_is_bidirectional_and_matches_reference():
    jcfg, cfg = _cfgs("hubert-xlarge")
    assert not cfg.causal and not cfg.rope
    tree = _noisy(jcfg)
    params = lm_params_from_jax(tree)
    frames = np.random.default_rng(2).normal(
        size=(2, 23, cfg.frontend_dim)).astype(np.float32)
    want, _ = jtfm.forward(jax.tree.map(jnp.asarray, tree), jcfg,
                           {"frames": jnp.asarray(frames)},
                           dtype=jnp.float32)
    got, aux = tfm.forward(params, cfg, {"frames": torch.from_numpy(frames)},
                           dtype=torch.float32)
    assert tuple(got.shape) == want.shape and float(aux) == 0.0
    _close_scaled(got, want)
    moved = frames.copy()
    moved[:, -1] += 1.0
    again, _ = tfm.forward(params, cfg, {"frames": torch.from_numpy(moved)},
                           dtype=torch.float32)
    assert float((again[:, 0] - got[:, 0]).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,gate", [(VLM, False), ("hubert-xlarge", False),
                                       (VLM, True)],
                         ids=["internvl2", "hubert", "internvl2-gated"])
def test_lm_loss_and_grads_match_reference(arch, gate):
    jcfg, cfg = _cfgs(arch, gate)
    jtree = tl._jparams(jcfg)
    batch = tl._batch(cfg)
    jl, jm, jg = tl._ref_loss_and_grads(jcfg, jtree, batch, jnp.float32, True)
    tl_, tm, tg = _port_loss_and_grads(cfg, jtree, batch)
    assert abs(tl_ - jl) <= tl.LOSS_REL * abs(jl), (tl_, jl)
    assert abs(tm["ce"] - jm["ce"]) <= tl.LOSS_REL * abs(jm["ce"])
    assert "frontend" in tg and ("gate" in tg) == gate
    if cfg.frontend == "audio_stub":
        assert not flatten(jg)["embed/embedding"].any()
    tl._leaf_errors(*_comparable(cfg, tg, jg), tl.GRAD_REL)


def _comparable(cfg, got, want, rel=1e-6):
    """The flat leaves of two trees (gradients, params or moments) that
    ``_leaf_errors`` can hold relative to their scale, once two kinds are
    checked here. The audio stub reads frames, never the token embedding:
    where the reference's leaf is zero (its gradient, its moments) the
    port's must be zero too. Without a causal mask every query's scores
    take the same ``q.bk``, which the softmax cancels: the key bias's
    gradient is zero but for rounding, which differs between the
    packages, so those leaves are held within ``rel`` of the tree's
    largest |value| in both."""
    got, want = flatten(got), flatten(want)
    key = "embed/embedding"
    if cfg.frontend == "audio_stub" and not np.asarray(want[key]).any():
        assert not np.asarray(got.pop(key)).any()
        want.pop(key)
    if cfg.causal or not cfg.qkv_bias:
        return got, want
    scale = max(float(np.abs(np.asarray(v, np.float32)).max())
                for v in want.values())
    for k in [k for k in want if k.endswith("attn/bk")]:
        for tree in (got, want):
            a = float(np.abs(np.asarray(tree.pop(k), np.float32)).max())
            assert a <= rel * scale, (k, a, scale)
    return got, want


def _port_loss_and_grads(cfg, jtree, batch):
    """``test_torch_train_lm._port_loss_and_grads`` in float32 with remat,
    a leaf the loss does not read getting a zero gradient."""
    tree = lm_params_from_jax(jtree)
    leaves = flatten(tree)
    for v in leaves.values():
        v.requires_grad_()
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    loss, mets = tfm.lm_loss(tree, cfg, tb, dtype=torch.float32, remat=True,
                             loss_chunk=tl.LOSS_CHUNK)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    grads = [torch.zeros_like(v) if g is None else g
             for v, g in zip(leaves.values(), grads)]
    gtree = unflatten(dict(zip(leaves, grads)),
                      tfm.model_params(cfg, lambda *a: None))
    return float(loss.detach()), \
        {k: float(v.detach()) for k, v in mets.items()}, \
        lm_params_to_jax(gtree, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_steps_match_reference(arch):
    """Five AdamW steps (eps 1e-4, as ``test_torch_train_lm.py``'s): the
    step metrics within 1e-5, every leaf of the params and both moments
    within 1e-4 of its scale (``_comparable``: hubert's unread token
    embedding and its key biases at their rounding floor)."""
    cfg = _cfgs(arch)[1]
    for got, want in tl._engine_steps(arch, 1, steps=5, cfgs=_cfgs(arch),
                                      eps=1e-4):
        tl._leaf_errors(*_comparable(cfg, got, want), tl.STEP_REL)


def test_place_batch_keeps_front_end_inputs_float32():
    for arch in ARCHS:
        _, cfg = _cfgs(arch)
        eng = Engine.for_lm(cfg, tl.TrainConfig(), device="cpu")
        b = eng.place_batch(tl._batch(cfg))
        for k, v in b.items():
            want = torch.int32 if k in ("tokens", "targets") else \
                torch.float32
            assert v.dtype == want and v.shape[0] == 1, (arch, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_crosses_packages(tmp_path, arch):
    """A port state saved and restored by the reference, and a reference
    state restored by the port, leaves equal to the bit, ``frontend``
    included."""
    jcfg, cfg = _cfgs(arch, gate=arch == VLM)
    jtc, tc = tl._tcs()
    jtree = tl._jparams(jcfg)
    eng = Engine.for_lm(cfg, tc, device="cpu", dtype=torch.float32)
    state = eng.init_state(lm_params_from_jax(jtree))
    state, _ = eng.step(state, eng.place_batch(tl._batch(cfg)))
    path = str(tmp_path / "port.npz")
    eng.save(path, state)
    jeng = tl._ref_engine(jcfg, jtc, 1)
    jex = jeng.init_state(jax.random.key(0), jax.tree.map(jnp.asarray, jtree))
    back = jckpt.restore(path, jex)
    for got, mine in ((back.params, state.params),
                      (back.opt_state.mu, state.opt_state.mu)):
        w = flatten(tl._state_ref_layout(eng, mine, cfg))
        g = flatten(jax.tree.map(np.asarray, got))
        assert sorted(g) == sorted(w) and any("frontend" in k for k in w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    jstate, _ = jeng.step(jex, jeng.place_batch(tl._batch(cfg, seed=5)))
    jpath = str(tmp_path / "ref.npz")
    jeng.save(jpath, jstate)
    ex = eng.init_state(tfm.init(cfg, torch.Generator().manual_seed(9)))
    got = eng.restore(jpath, ex)
    for mine, want in ((got.params, jstate.params),
                       (got.opt_state.nu, jstate.opt_state.nu)):
        g = flatten(tl._state_ref_layout(eng, mine, cfg))
        w = flatten(jax.tree.map(np.asarray, want))
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def _vlm_queue(cfg, gen=parity.GEN):
    """The harness's prompts, each with its own image's patches."""
    pats = _patches(cfg, len(parity.LENS))
    return [parity.spec(p, gen, extras={"patches": pats[i]})
            for i, p in enumerate(parity.prompts(cfg.vocab_size))]


@pytest.mark.parametrize("mode", parity.MODES, ids=parity.MODE_IDS)
def test_served_streams_equal_reference(mode):
    """The reference's init law; ``spec_k=3`` with twice the tokens on
    params where the model repeats its last token (``_repeating``), so
    that the n-gram drafter's drafts are verified and accepted."""
    _, cfg = _cfgs(VLM)
    spec_k = mode.get("spec_k", 0)
    tree = _repeating(parity.params(VLM)) if spec_k else parity.params(VLM)
    gen = 2 * parity.GEN if spec_k else parity.GEN
    kw = dict(slots=parity.SLOTS, max_len=40, page_size=parity.PS,
              prefill_chunk=mode.get("prefill_chunk", 0))
    drafters = (JNgram(), NgramDrafter()) if spec_k else (None, None)
    got, st = parity.serve_both(VLM, tree, _vlm_queue(cfg, gen),
                                engine_kw=kw, sched_kw={"spec_k": spec_k},
                                drafters=drafters)
    assert sum(len(g) for g in got.values()) == gen * len(parity.LENS)
    # a request with patches is admitted whole; its patches are prefilled
    assert st["prefill_chunks"] == 0
    assert st["prefill_tokens"] == sum(parity.LENS) + len(parity.LENS) * \
        cfg.num_patches
    if spec_k:
        assert st["spec_steps"] > 0 and st["spec_accepted"] > 0


def _repeating(tree):
    """The init with every layer's output projection scaled by 1e-3 and
    the embedding table, transposed, as the unembedding: the residual
    stream carries the token's embedding almost alone, so the greedy
    model repeats its last token."""
    def damp(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        return a * np.float32(1e-3) if name in ("wo", "w_down") else a
    out = jax.tree_util.tree_map_with_path(damp, tree)
    out["embed"] = dict(out["embed"],
                        unembed=np.ascontiguousarray(
                            out["embed"]["embedding"].T))
    return out


def test_sampled_streams_equal_reference():
    """Sampled requests with images: each draw is keyed by its absolute
    stream position, which counts the patches (the first token's is
    P + L), so the streams equal the reference's only if both count
    alike."""
    _, cfg = _cfgs(VLM)
    queue = [dict(q, sampling=dict(temperature=0.8, top_k=50, top_p=0.95,
                                   rep_penalty=1.1, seed=7 + i))
             for i, q in enumerate(_vlm_queue(cfg))]
    got, _ = parity.serve_both(VLM, parity.params(VLM), queue,
                               engine_kw=dict(slots=parity.SLOTS, max_len=40,
                                              page_size=parity.PS))
    assert sum(len(g) for g in got.values()) == parity.GEN * len(queue)


def test_insert_chunk_takes_no_patches():
    """The scheduler admits a request with patches whole; the engine's
    chunk step refuses patches rather than dropping them."""
    _, cfg = _cfgs(VLM)
    eng, state = parity.port_engine(VLM, parity.params(VLM), slots=1,
                                    max_len=24, page_size=4)
    eng.assign_pages(state, 0, list(range(eng.pages_per_slot)))
    inputs = {"tokens": np.zeros((1, 4), np.int32),
              "patches": _patches(cfg, 1)}
    with pytest.raises(ValueError, match="patches"):
        eng.insert_chunk(state, inputs, 0, 0)
    state, tok = eng.insert(state, inputs, 0)
    assert int(state.positions[0]) == 4 + cfg.num_patches


def test_served_image_reaches_the_stream():
    """Other patches, other first-decode logits (a different image must
    reach the output)."""
    jcfg, cfg = _cfgs(VLM)
    tree = _noisy(jcfg)
    a, _ = parity.first_decode_logits_bf16(
        VLM, tree, _patches(cfg, parity.SLOTS), jcfg_cfg=(jcfg, cfg))
    b, _ = parity.first_decode_logits_bf16(
        VLM, tree, _patches(cfg, parity.SLOTS, seed=4), jcfg_cfg=(jcfg, cfg))
    assert float(np.abs(a - b).max()) > 1e-2 * float(np.abs(a).max())


@pytest.mark.parametrize("gate", [False, True], ids=["plain", "gated"])
def test_first_decode_step_logits_bf16(gate):
    jcfg, cfg = _cfgs(VLM, gate)
    got, want = parity.first_decode_logits_bf16(
        VLM, _noisy(jcfg), _patches(cfg, parity.SLOTS), jcfg_cfg=(jcfg, cfg))
    err = np.abs(got - want).max()
    assert err <= parity.REL_BF16 * np.abs(want).max(), \
        (err, np.abs(want).max())


def _serve_cli(argv, capsys, monkeypatch):
    real = tserve.InferenceEngine
    monkeypatch.setattr(tserve, "InferenceEngine", lambda *a, **kw: real(
        *a, **dict(kw, dtype=torch.float32)))
    out = tserve.main(argv)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    return out


def test_serve_cli_internvl2(tmp_path, capsys, monkeypatch):
    """The launcher serves internvl2-smoke with zero patches a request and
    the patches in the cache length; its keys are the LM launcher's, and
    its digest the reference scheduler's on its own queue and params."""
    jcfg, cfg = _cfgs(VLM)
    jparams = jtfm.init(jcfg, jax.random.key(5))
    path = tmp_path / "state.npz"
    jckpt.save(str(path), {"params": jparams, "step": jnp.zeros((), jnp.int32),
                           "opt_state": {"mu": jparams}})
    base = ["--smoke", "--device", "cpu", "--requests", "3", "--batch-size",
            "2", "--prompt-len", "12", "--ragged", "--gen", "4",
            "--page-size", "4"]
    out = _serve_cli(["--arch", VLM, "--ckpt", str(path)] + base, capsys,
                     monkeypatch)
    text = _serve_cli(["--arch", "qwen2-1.5b"] + base, capsys, monkeypatch)
    assert sorted(out) == sorted(text)
    assert out["arch"] == "internvl2-2b-smoke" and out["tokens"] == 12
    ns = Namespace(queue="", seed=0, shared_prefix=0, prompt_len=12,
                   requests=3, ragged=True, gen=4, temperature=0.0, top_k=0,
                   top_p=1.0, rep_penalty=1.0, sample_seed=0)
    reqs = tserve.make_requests(cfg, ns)
    assert all(r.extras["patches"].shape == (8, 64) and
               not r.extras["patches"].any() for r in reqs)
    specs = [parity.spec(r.prompt, r.max_new, extras=r.extras) for r in reqs]
    max_len = max(len(r.prompt) + r.max_new for r in reqs) + cfg.num_patches
    want, _ = parity.serve_ref_queue(
        VLM, jax.tree.map(np.asarray, jparams), specs,
        engine_kw=dict(slots=2, max_len=max_len, page_size=4))
    assert out["stream_digest"] == stream_digest(want)


def test_serve_cli_refuses_the_encoder():
    with pytest.raises(SystemExit, match="encoder-only; no decode path"):
        tserve.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])
