"""The port's other dense decoders — gemma2-2b (local/global alternation,
attention and final-logit softcaps, sandwich norms, GELU, sqrt(d)
embedding scale), gemma2-2b-localonly, llama3.2-3b (GQA 24 on 8) and
olmo-1b (MHA, LayerNorm with no affine parameters) — against the
reference, on the CPU, in float32, at smoke size (``smoke_variant``: 2
layers, d_model 256, window 16, so a 20-token prompt crosses a local
layer's window).

* the configs, field for field;
* the init tree and law, through ``lm_params_from_jax`` (the sandwich
  norms' ``post_norm1/post_norm2`` leaves, and the norm-less
  ``nonparam_ln`` layers, of the reference's scanned blocks);
* prefill, chunked prefill, decode and verify logits and the page pools,
  within 1e-5 of their largest magnitude (``test_torch_lm.py``'s
  tolerance; the caches' positions exactly), on params redrawn from numpy
  noise as ``test_torch_lm.py`` draws them;
* the greedy streams and the scheduler's counts of the reference's
  paged engine and the port's, equal in whole, chunked and ``spec_k=3``
  modes (``torch_serve_parity.py``), and one bf16 decode step's logits
  within 3e-2 of their largest magnitude (``test_torch_serve_lm.py``'s);
* gemma2 with scores and logits past both softcaps, so that both caps
  bind: the port still agrees within 1e-5.

The reference's paged paths run its Pallas kernel in interpret mode
(``REPRO_PAGED_ATTN=1``) on a 1x1 mesh with Auto axes.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_serve_parity as parity  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

torch.set_num_threads(1)
ARCHS = ["gemma2-2b", "gemma2-2b-localonly", "llama3.2-3b", "olmo-1b"]
REL = 1e-5


def _close_scaled(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _noisy_params(jcfg, seed=0):
    """The reference's init tree with every leaf redrawn from numpy, as in
    ``test_torch_lm.py``: norm scales 1 + N(0, 0.1), the embedding with
    its init's spread, projections with std 1/sqrt(inputs summed)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jtfm.init(jcfg, jax.random.key(seed)))

    def redraw(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            return (1 + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        if name == "embedding":
            return (rng.normal(size=a.shape) * a.std()).astype(np.float32)
        # block leaves carry the leading repetition axis
        fan_in = int(np.prod(a.shape[1:-1])) if name == "wo" else a.shape[1]
        return (rng.normal(size=a.shape) / fan_in ** 0.5).astype(np.float32)
    return jax.tree_util.tree_map_with_path(redraw, tree)


def _shapes(t):
    if isinstance(t, dict):
        return {k: _shapes(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_shapes(v) for v in t]
    return tuple(t.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference_field_for_field(arch):
    j, t = j_get_config(arch), get_config(arch)
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(j):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.layer_kinds() == j.layer_kinds()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_tree_and_law(arch):
    """The same leaves and shapes as the reference's scanned tree after
    conversion (sandwich norms included, no norm leaves for
    ``nonparam_ln``), and the same init law, not the same bits."""
    jcfg, cfg = parity.cfgs(arch)
    ref = lm_params_from_jax(jax.tree.map(np.asarray,
                                          jtfm.init(jcfg, jax.random.key(0))))
    port = tfm.init(cfg, torch.Generator().manual_seed(0))
    assert _shapes(port) == _shapes(ref)
    assert len(port["layers"]) == cfg.num_layers
    norms = ("norm1", "norm2") + (("post_norm1", "post_norm2")
                                  if cfg.post_norms else ())
    for lp in port["layers"]:
        assert sorted(lp) == sorted(norms + ("attn", "ffn"))
        for n in norms:
            if cfg.norm == "nonparam_ln":
                assert lp[n] == {}
            else:
                assert (lp[n]["scale"] == 1).all()
        for name in ("wq", "wk", "wv", "wo"):
            # the reference's fan-in rule: std 1/sqrt(shape[-2])
            w = lp["attn"][name]
            assert abs(w.std().item() * w.shape[-2] ** 0.5 - 1) < 0.1, name
    if cfg.norm == "nonparam_ln":
        assert port["final_norm"] == {}
    else:
        assert (port["final_norm"]["scale"] == 1).all()
    assert abs(port["embed"]["embedding"].std().item() / 0.02 - 1) < 0.1


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
    """Slot 0 admitted by a whole 20-token prefill (past the window of
    16), slot 1 by a 19-token prompt in chunks of 8, 8 and 3; then one
    fused decode step and one verify step of 3 tokens with slot 1
    inactive. Every logits and the pools are held to the reference's.
    Returns the port's whole-prefill logits."""
    jp = jax.tree.map(jnp.asarray, tree)
    params = lm_params_from_jax(tree)
    rng = np.random.default_rng(seed)
    P, ps, slots, max_len = 16, 4, 2, 32
    table = rng.permutation(P).astype(np.int32).reshape(slots, -1)
    jc = jtfm.init_paged_cache(jcfg, slots, P, ps, dtype=jnp.float32)
    tc = tfm.init_paged_cache(cfg, slots, P, ps, dtype=torch.float32)
    f32 = dict(dtype=jnp.float32), dict(dtype=torch.float32)

    prompt = rng.integers(0, cfg.vocab_size, (1, 20)).astype(np.int32)
    jl, ring = jtfm.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt)},
                            max_len, **f32[0])
    tl, tring = tfm.prefill(params, cfg, {"tokens": torch.tensor(prompt)},
                            max_len, **f32[1])
    _close_scaled(tl, jl)
    first = tl
    jc = jtfm.scatter_prefill_paged(jcfg, jc, ring, jnp.asarray(table[0]), 0)
    tfm.scatter_prefill_paged(cfg, tc, tring, torch.tensor(table[0]), 0)
    _close_caches(tc, jc)

    chunk = rng.integers(0, cfg.vocab_size, (1, 19)).astype(np.int32)
    for lo, hi in ((0, 8), (8, 16), (16, 19)):
        jl, jc = jtfm.prefill_chunk(jp, jcfg, {"tokens": jnp.asarray(
            chunk[:, lo:hi])}, jc, jnp.asarray(table[1]), 1, lo, **f32[0])
        tl, tc = tfm.prefill_chunk(params, cfg, {"tokens": torch.tensor(
            chunk[:, lo:hi])}, tc, torch.tensor(table[1]), 1, lo, **f32[1])
        _close_scaled(tl, jl)
        _close_caches(tc, jc)

    steps = [("decode", np.array([[11], [12]], np.int32), [20, 19],
              [True, True]),
             ("verify", rng.integers(0, cfg.vocab_size, (2, 3)).astype(
                 np.int32), [21, 20], [True, False])]
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
    return first


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_decode_verify_match_reference(monkeypatch, arch):
    monkeypatch.setenv("REPRO_PAGED_ATTN", "1")
    jcfg, cfg = parity.cfgs(arch)
    before = [f.launches for f in tfm.KERNELS]
    _model_paths(jcfg, cfg, _noisy_params(jcfg))
    assert [f.launches for f in tfm.KERNELS] == before   # CPU: plain versions


def test_gemma2_with_both_softcaps_binding(monkeypatch):
    """gemma2 with the query projections scaled by 18 (the first layer's
    scores reach ~66, past the attention softcap of 50) and the final
    norm's scale by 40 (logits reach ~38 before the final softcap of 30):
    the port agrees with the reference in every path, within 1e-5 of the
    largest |logit| as elsewhere. (Scaled harder, by 30 and 100, both
    frameworks' attention turns so peaky that their float32 sums part by
    ~1.3e-3 absolute, with the caps on or off alike.)"""
    monkeypatch.setenv("REPRO_PAGED_ATTN", "1")
    jcfg, cfg = parity.cfgs("gemma2-2b")
    tree = _noisy_params(jcfg, seed=3)
    for blk in tree["blocks"].values():
        blk["attn"]["wq"] = blk["attn"]["wq"] * np.float32(18)
    tree["final_norm"]["scale"] = tree["final_norm"]["scale"] * np.float32(40)
    capped = _model_paths(jcfg, cfg, tree)
    assert float(capped.abs().max()) <= cfg.logit_softcap

    # the caps bind: the first layer's scores and the logits before the
    # final cap pass their caps
    params = lm_params_from_jax(tree)
    prompt = {"tokens": torch.tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, 20)).astype(np.int32))}
    pre_cap, _ = tfm.prefill(params, cfg.replace(logit_softcap=0.0), prompt,
                             32, dtype=torch.float32)
    assert float(pre_cap[:, :cfg.vocab_size].abs().max()) > cfg.logit_softcap
    layer = params["layers"][0]
    x = tfm.embed_inputs(params, cfg, prompt, torch.float32)
    h = layers.apply_norm(layer["norm1"], cfg.norm, x)
    q, k, _ = attention.qkv_project(layer["attn"], cfg, h,
                                    torch.arange(20)[None])
    k = k.repeat_interleave(cfg.num_heads // cfg.num_kv_heads, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    causal = torch.ones(20, 20, dtype=torch.bool).tril()
    assert float(scores[..., causal].abs().max()) > cfg.attn_softcap


@pytest.mark.parametrize("mode", parity.MODES, ids=parity.MODE_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_served_streams_equal_reference(monkeypatch, arch, mode):
    monkeypatch.setenv("REPRO_PAGED_ATTN", "1")
    parity.check_served(arch, "init", mode)


@pytest.mark.parametrize("arch", ARCHS)
def test_first_decode_step_logits_bf16(monkeypatch, arch):
    """On the noisy params, as ``test_torch_serve_lm.py`` holds qwen2: the
    reference's init law puts attention scores in the hundreds at these
    widths, where the reference rounds each score through bfloat16 (an
    ulp of 0.5 to 1) and the port keeps it in float32, so the two parted
    by ~0.2 of the largest logit for llama3.2 (whose float32 runs agree
    above)."""
    monkeypatch.setenv("REPRO_PAGED_ATTN", "1")
    jcfg, _ = parity.cfgs(arch)
    got, want = parity.first_decode_logits_bf16(arch, _noisy_params(jcfg))
    err = np.abs(got - want).max()
    assert err <= parity.REL_BF16 * np.abs(want).max(), (err, np.abs(want).max())
