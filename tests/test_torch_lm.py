"""The port's dense-decoder modules against the reference's, on the CPU,
at smoke size (``smoke_variant(qwen2-1.5b)``: 2 layers, d_model 256, 4/1
heads, head_dim 64, vocab 512).

Inputs and every parameter leaf (biases and norm scales included) come
from numpy noise and go to both packages; the model's params are carried
across by ``params_from_jax``. The reference's paged paths run its Pallas
kernel in interpret mode (``REPRO_PAGED_ATTN=1``). Tolerances, float32
(sums taken in another order): single layers within 1e-5 absolute and
relative; the model's logits and the caches' k/v within 1e-5 of the
largest magnitude in each; the caches' positions equal exactly.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_variant as j_smoke_variant  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.paged_attn.ops import paged_attention_fused  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-5
RTOL = 1e-5
REL = 1e-5
ARCH = "qwen2-1.5b"


def _cfgs(**over):
    return (j_smoke_variant(j_get_config(ARCH)).replace(**over),
            smoke_variant(get_config(ARCH)).replace(**over))


def _noisy_params(jcfg, seed=0):
    """The reference's init tree with every leaf redrawn from numpy:
    biases N(0, 0.1) and norm scales 1 + N(0, 0.1), so that the bias and
    scale paths are exercised, the embedding with its init's spread, and
    the projections with std 1/sqrt(inputs summed). The reference's own
    law (std 1/sqrt(shape[-2]), so 1/sqrt(Hq) for ``wq``) gives attention
    scores in the hundreds at these widths, which turn a float32 last-bit
    difference into a 1e-4 one; the served-stream tests keep that law."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jtfm.init(jcfg, jax.random.key(seed)))

    def redraw(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            return (1 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        if name in ("bq", "bk", "bv", "bias"):
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        if name == "embedding":
            return (rng.normal(size=a.shape) * a.std()).astype(np.float32)
        # block leaves carry the leading repetition axis: (R, d, ...) or,
        # for wo, (R, Hq, D, d)
        fan_in = int(np.prod(a.shape[1:-1])) if name == "wo" else a.shape[1]
        return (rng.normal(size=a.shape) / fan_in ** 0.5).astype(np.float32)
    return jax.tree_util.tree_map_with_path(redraw, tree)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a)).to(dtype)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=RTOL)


def _close_scaled(got, want, rel=REL):
    """Within ``rel`` of the largest magnitude in ``want``: deep in the
    stack the activations reach the hundreds, and a float32 sum taken in
    another order differs by a few ulp of that scale."""
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_apply_norm(kind):
    rng = np.random.default_rng(1)
    x = rng.normal(2, 3, (2, 5, 32)).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.normal(size=32)).astype(np.float32),
         "bias": (0.1 * rng.normal(size=32)).astype(np.float32)}
    want = jlayers.apply_norm(p, kind, jnp.asarray(x))
    got = layers.apply_norm({k: _t(v) for k, v in p.items()}, kind, _t(x))
    _close(got, want)
    # bfloat16 activations, float32 scales: within one bfloat16 ulp
    want = jlayers.apply_norm(p, kind, jnp.asarray(x, jnp.bfloat16))
    got = layers.apply_norm({k: _t(v) for k, v in p.items()}, kind,
                            _t(x, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2 ** -7,
                               atol=0)


def test_rope_freqs_and_apply_rope():
    np.testing.assert_array_equal(layers.rope_freqs(64, 1e6),
                                  jlayers.rope_freqs(64, 1e6))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 5, 64)).astype(np.float32)
    pos = rng.integers(0, 600, (2, 1, 5)).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    _close(layers.apply_rope(_t(x), torch.tensor(pos), 1e6), want)


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_embed_unembed_with_padded_vocab(cap):
    rng = np.random.default_rng(3)
    vocab, pv, d = 500, 512, 32
    table = (0.02 * rng.normal(size=(pv, d))).astype(np.float32)
    toks = rng.integers(0, vocab, (2, 7)).astype(np.int32)
    for scale in (False, True):
        want = jlayers.embed({"embedding": jnp.asarray(table)},
                             jnp.asarray(toks), scale=scale, d_model=d,
                             dtype=jnp.float32)
        got = layers.embed({"embedding": _t(table)}, torch.tensor(toks),
                           scale=scale, d_model=d, dtype=torch.float32)
        _close(got, want)
    x = rng.normal(size=(2, 7, d)).astype(np.float32)
    want = jlayers.unembed({"embedding": jnp.asarray(table)}, jnp.asarray(x),
                           tie=True, cap=cap, real_vocab=vocab)
    got = layers.unembed({"embedding": _t(table)}, _t(x), tie=True, cap=cap,
                         real_vocab=vocab)
    assert got.dtype == torch.float32 and got.shape == (2, 7, pv)
    assert (got[..., vocab:] == -1e30).all()
    _close(got, want)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_block(act):
    rng = np.random.default_rng(4)
    d, f = 32, 48
    p = {"w_gate": rng.normal(size=(d, f)) / d ** 0.5,
         "w_up": rng.normal(size=(d, f)) / d ** 0.5,
         "w_down": rng.normal(size=(f, d)) / f ** 0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    want = jmlp.mlp_block(p, act, jnp.asarray(x))
    _close(mlp.mlp_block({k: _t(v) for k, v in p.items()}, act, _t(x)), want)


def test_qkv_project_and_out_project():
    jcfg, cfg = _cfgs()
    lp = _noisy_params(jcfg)["blocks"]["0"]["attn"]
    p = {k: _t(np.asarray(v)[0]) for k, v in lp.items()}
    jp = {k: jnp.asarray(np.asarray(v)[0]) for k, v in lp.items()}
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    pos = rng.integers(0, 40, (2, 6)).astype(np.int32)
    want = jattn.qkv_project(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = attn.qkv_project(p, cfg, _t(x), torch.tensor(pos))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)
    o = rng.normal(size=(2, 6, cfg.num_heads, 64)).astype(np.float32)
    _close(attn.out_project(p, _t(o)), jattn.out_project(jp, jnp.asarray(o)))


@pytest.mark.parametrize("causal,softcap,blocks", [
    (True, 0.0, (1024, 1024)), (True, 50.0, (8, 4)), (False, 0.0, (8, 4))])
def test_flash_attention(causal, softcap, blocks):
    rng = np.random.default_rng(6)
    q = rng.normal(size=(2, 13, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 13, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 13, 2, 16)).astype(np.float32)
    kw = dict(causal=causal, softcap_val=softcap, block_k=blocks[0],
              block_q=blocks[1])
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), **kw)
    _close(attn.flash_attention(_t(q), _t(k), _t(v), **kw), want)


def test_init_matches_reference_tree_and_law():
    """Same leaves and shapes as the reference after conversion; the same
    init law (std 1/sqrt(shape[-2]), 0.02 for the embedding, zero biases,
    unit scales), not the same bits."""
    jcfg, cfg = _cfgs()
    ref = params_from_jax(jax.tree.map(np.asarray,
                                       jtfm.init(jcfg, jax.random.key(0))))
    port = tfm.init(cfg, torch.Generator().manual_seed(0))

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)
    assert shapes(port) == shapes(ref)
    assert len(port["layers"]) == cfg.num_layers
    for lp in port["layers"]:
        assert not lp["attn"]["bq"].any() and (lp["norm1"]["scale"] == 1).all()
        for name, fan_in in (("wq", cfg.num_heads), ("wk", cfg.num_kv_heads),
                             ("wo", 64)):
            std = lp["attn"][name].std().item()
            assert abs(std * fan_in ** 0.5 - 1) < 0.1, name
    assert abs(port["embed"]["embedding"].std().item() / 0.02 - 1) < 0.1


# ---------------------------------------------------------------------------
# The model: prefill, chunked prefill, paged decode and verify
# ---------------------------------------------------------------------------
def _jax_layers(caches):
    """The reference's paged cache tree as one PagedKVCache per layer."""
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


def test_prefill_chunk_decode_verify_match_reference(monkeypatch):
    monkeypatch.setenv("REPRO_PAGED_ATTN", "1")
    jcfg, cfg = _cfgs()
    jp = jax.tree.map(jnp.asarray, _noisy_params(jcfg))
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(7)
    P, ps, slots, max_len = 8, 4, 2, 16
    table = np.array([[3, 0, 6, -1], [5, 2, 7, 1]], np.int32)
    jc = jtfm.init_paged_cache(jcfg, slots, P, ps, dtype=jnp.float32)
    tc = tfm.init_paged_cache(cfg, slots, P, ps, dtype=torch.float32)
    f32 = dict(dtype=jnp.float32), dict(dtype=torch.float32)

    # slot 0: whole-prompt prefill, scattered into its pages
    prompt = rng.integers(0, cfg.vocab_size, (1, 6)).astype(np.int32)
    jl, ring = jtfm.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt)},
                            max_len, **f32[0])
    tl, tring = tfm.prefill(params, cfg, {"tokens": torch.tensor(prompt)},
                            max_len, **f32[1])
    _close_scaled(tl, jl)
    jc = jtfm.scatter_prefill_paged(jcfg, jc, ring, jnp.asarray(table[0]), 0)
    tfm.scatter_prefill_paged(cfg, tc, tring, torch.tensor(table[0]), 0)
    _close_caches(tc, jc)

    # slot 1: a prompt in two chunks (5 tokens, then 2)
    chunk = rng.integers(0, cfg.vocab_size, (1, 7)).astype(np.int32)
    for lo, hi in ((0, 5), (5, 7)):
        jl, jc = jtfm.prefill_chunk(jp, jcfg, {"tokens": jnp.asarray(
            chunk[:, lo:hi])}, jc, jnp.asarray(table[1]), 1, lo, **f32[0])
        tl, tc = tfm.prefill_chunk(params, cfg, {"tokens": torch.tensor(
            chunk[:, lo:hi])}, tc, torch.tensor(table[1]), 1, lo, **f32[1])
        _close_scaled(tl, jl)
        _close_caches(tc, jc)

    # one fused decode step over both slots, then a verify step with slot 1
    # inactive (its writes must go nowhere)
    launches = paged_attention_fused.launches
    steps = [("decode", np.array([[11], [12]], np.int32), [6, 7],
              [True, True]),
             ("verify", rng.integers(0, 512, (2, 3)).astype(np.int32),
              [7, 8], [True, False])]
    for kind, toks, pos, act in steps:
        fj = jtfm.decode_step_paged if kind == "decode" else jtfm.verify_step_paged
        ft = tfm.decode_step_paged if kind == "decode" else tfm.verify_step_paged
        jl, jc = fj(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc,
                    jnp.asarray(pos, jnp.int32), jnp.asarray(table),
                    jnp.asarray(act), **f32[0])
        tl, tc = ft(params, cfg, {"tokens": torch.tensor(toks)}, tc,
                    torch.tensor(pos, dtype=torch.int32), torch.tensor(table),
                    torch.tensor(act), **f32[1])
        assert tuple(tl.shape) == jl.shape
        _close_scaled(tl, jl)
        _close_caches(tc, jc)
    assert paged_attention_fused.launches == launches   # CPU: plain version


def test_unported_kinds_raise():
    jcfg, cfg = _cfgs()
    for over in (dict(layer_pattern=("global", "recurrent")),
                 dict(moe=object()), dict(frontend="vision_stub")):
        with pytest.raises(NotImplementedError):
            tfm.init(cfg.replace(**over), torch.Generator().manual_seed(0))
