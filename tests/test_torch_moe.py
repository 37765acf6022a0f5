"""The port's mixture-of-experts block and QK norm against the reference,
on the CPU, in float32, at smoke size (``smoke_variant``: 4 experts, top
2, expert hidden 64; deepseek-moe with one shared expert of 64 and a
dense first layer; qwen3-moe with QK-RMSNorm).

* the configs, field for field (the two ``MoEConfig`` classes differ, so
  their fields are compared);
* the init tree (router, stacked experts, shared expert, ``q_norm`` /
  ``k_norm``) after ``lm_params_from_jax``, and its law;
* ``capacity``, ``route``, ``dispatch_indices`` (against the reference's
  ``_dispatch_indices`` on every row), ``load_balance_loss`` and
  ``moe_block`` at the default capacity, where tokens are dropped, and
  at an ample one, where none are: indices equal, values within 1e-5
  (sums taken in another order); equal router probabilities keep the
  lower expert first, as ``jax.lax.top_k`` does;
* QK norm in ``qkv_project``, after the bias and before rope;
* the greedy streams at an ample capacity (the default's are in
  ``test_torch_serve_moe.py``): each mode of the port equal to the same
  mode of the reference.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_serve_parity as parity  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models import attention, moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

torch.set_num_threads(1)
ARCHS = ["qwen3-moe-30b-a3b", "deepseek-moe-16b"]
ATOL = RTOL = 1e-5
AMPLE = 8.0          # the reference's own tests' capacity without drops


def _factor(cfg, factor):
    return cfg.replace(moe=dataclasses.replace(cfg.moe,
                                               capacity_factor=factor))


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=ATOL,
                               rtol=RTOL)


def _moe_params(arch):
    """The last layer's MoE FFN of the reference's init, as numpy and as
    the port's tensors."""
    jcfg, _ = parity.cfgs(arch)
    tree = jax.tree.map(np.asarray, jtfm.init(jcfg, jax.random.key(0)))
    lp = lm_params_from_jax(tree)["layers"][-1]["ffn"]
    return jax.tree.map(lambda t: t.numpy(), lp), lp


def _x(cfg, B=3, S=20, seed=0, toward=None):
    """Unit-normal tokens; with ``toward`` (a router column), each also
    moves along it, so most tokens pick that expert and it overflows."""
    x = np.random.default_rng(seed).normal(size=(B, S, cfg.d_model))
    if toward is not None:
        x = x + 0.3 * cfg.d_model ** 0.5 * toward / np.linalg.norm(toward)
    return x.astype(np.float32)


def _shapes(t):
    if isinstance(t, dict):
        return {k: _shapes(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_shapes(v) for v in t]
    return tuple(t.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference_field_for_field(arch):
    for j, t in ((j_get_config(arch), get_config(arch)), parity.cfgs(arch)):
        assert [f.name for f in dataclasses.fields(t)] == \
            [f.name for f in dataclasses.fields(j)]
        for f in dataclasses.fields(j):
            if f.name != "moe":
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert dataclasses.asdict(t.moe) == dataclasses.asdict(j.moe)
        assert [f.name for f in dataclasses.fields(t.moe)] == \
            [f.name for f in dataclasses.fields(j.moe)]
        assert t.layer_kinds() == j.layer_kinds()
        assert [ffn for _, ffn in tfm.layer_plan(t)] == \
            ["dense"] * t.first_k_dense + ["moe"] * (t.num_layers
                                                     - t.first_k_dense)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_tree_and_law(arch):
    """The reference's leaves and shapes after conversion (the dense
    prefix layer, the stacked experts, the shared expert, QK norms), and
    its law: router std 0.02, experts std 1/sqrt(shape[-2]), norms 1. In
    bf16 the router and the norms stay float32, as ``cast_params`` keeps
    them."""
    jcfg, cfg = parity.cfgs(arch)
    ref = lm_params_from_jax(jax.tree.map(np.asarray,
                                          jtfm.init(jcfg, jax.random.key(0))))
    port = tfm.init(cfg, torch.Generator().manual_seed(0))
    assert _shapes(port) == _shapes(ref)
    for lp in port["layers"][cfg.first_k_dense:]:
        ffn = lp["ffn"]
        assert sorted(ffn) == sorted(["router", "w_gate", "w_up", "w_down"]
                                     + (["shared"] if cfg.moe.num_shared
                                        else []))
        assert abs(ffn["router"].std().item() / 0.02 - 1) < 0.1
        for name in ("w_gate", "w_up", "w_down"):
            w = ffn[name]
            assert abs(w.std().item() * w.shape[-2] ** 0.5 - 1) < 0.1, name
        if cfg.qk_norm:
            for n in ("q_norm", "k_norm"):
                assert (lp["attn"][n]["scale"] == 1).all()
                assert lp["attn"][n]["scale"].shape == (cfg.head_dim,)
    bf = tfm.init(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    cast = tfm.cast_params(port, torch.bfloat16)
    for a, b in zip(_leaves(bf), _leaves(cast)):
        assert a[0] == b[0] and a[1].dtype == b[1].dtype, a[0]
        assert torch.equal(a[1], b[1]), a[0]
    assert bf["layers"][-1]["ffn"]["router"].dtype == torch.float32
    assert bf["layers"][-1]["ffn"]["w_up"].dtype == torch.bfloat16


def _leaves(tree, key=""):
    """(path, leaf) of a port tree in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves(tree[k], f"{key}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{key}/{i}")]
    return [(key, tree)]


def test_capacity_equals_reference():
    pairs = [(get_config(a).moe, j_get_config(a).moe) for a in ARCHS]
    pairs += [(parity.cfgs(a)[1].moe, parity.cfgs(a)[0].moe) for a in ARCHS]
    for S in (1, 3, 4, 5, 20, 128, 509, 512, 4608):
        for factor in (1.0, 1.25, 2.0, AMPLE):
            for m, jm in pairs:
                assert moe.capacity(S, m, factor) == \
                    jmoe.capacity(S, jm, factor), (S, factor)


@pytest.mark.parametrize("factor", [1.25, AMPLE], ids=["default", "ample"])
@pytest.mark.parametrize("arch", ARCHS)
def test_route_dispatch_loss_and_block_match_reference(arch, factor):
    jcfg, cfg = (_factor(c, factor) for c in parity.cfgs(arch))
    npp, tp = _moe_params(arch)
    x = _x(cfg, toward=npp["router"][:, 2])
    probs, idx, w = jmoe.route(jnp.asarray(npp["router"]), jnp.asarray(x),
                               jcfg.moe)
    tprobs, tidx, tw = moe.route(tp["router"], _t(x), cfg.moe)
    _close(tprobs, probs)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    _close(tw, w)
    _close(moe.load_balance_loss(tprobs, tidx, cfg.moe),
           jmoe.load_balance_loss(probs, idx, jcfg.moe))

    cap = moe.capacity(x.shape[1], cfg.moe, factor)
    want = jax.vmap(lambda ti: jmoe._dispatch_indices(ti, jcfg.moe, cap))(idx)
    got = moe.dispatch_indices(_t(idx).long(), cfg.moe, cap)
    for g, j, name in zip(got, want, ("idx", "valid", "keep", "slot")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j), err_msg=name)
    keep = got[2]
    assert bool(keep.all()) == (factor == AMPLE)     # drops at the default

    y, aux = jmoe.moe_block(jax.tree.map(jnp.asarray, npp), jcfg,
                            jnp.asarray(x))
    ty, taux = moe.moe_block(tp, cfg, _t(x))
    _close(ty, y)
    _close(taux, aux)


def test_top_k_keeps_the_lower_expert_first_on_ties():
    rows = np.array([[0.25, 0.25, 0.25, 0.25],
                     [0.1, 0.4, 0.1, 0.4],
                     [0.3, 0.2, 0.3, 0.2],
                     [0.0, 0.5, 0.0, 0.5]], np.float32)
    for k in (1, 2, 3):
        v, i = jax.lax.top_k(jnp.asarray(rows), k)
        tv, ti = moe.top_k(_t(rows), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(i))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(v))


@pytest.mark.parametrize("arch", ARCHS)
def test_block_with_tied_router_columns_matches_reference(arch):
    """Experts 1 and 3 share their router column, so every token's
    probabilities tie between them: the flattened assignment stream, and
    so the drops at the default capacity, follow the lower expert first."""
    jcfg, cfg = parity.cfgs(arch)
    npp, tp = _moe_params(arch)
    npp = dict(npp, router=npp["router"].copy())
    npp["router"][:, 3] = npp["router"][:, 1]
    tp = dict(tp, router=_t(npp["router"]))
    x = _x(cfg, seed=1)
    probs, idx, _ = jmoe.route(jnp.asarray(npp["router"]), jnp.asarray(x),
                               jcfg.moe)
    tprobs, tidx, _ = moe.route(tp["router"], _t(x), cfg.moe)
    probs = np.asarray(probs)
    assert (probs[..., 1] == probs[..., 3]).all()
    both = (np.asarray(idx) == 1).any(-1) & (np.asarray(idx) == 3).any(-1)
    assert both.sum() > 0                     # some tokens pick both
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    y, _ = jmoe.moe_block(jax.tree.map(jnp.asarray, npp), jcfg,
                          jnp.asarray(x))
    _close(moe.moe_block(tp, cfg, _t(x))[0], y)


@pytest.mark.parametrize("bias", [False, True], ids=["qwen3", "with_bias"])
def test_qk_norm_in_qkv_project(bias):
    """qwen3's QK-RMSNorm over each head's D channels, after the bias and
    before rope, with norm scales and biases drawn from numpy noise."""
    jcfg, cfg = (c.replace(qkv_bias=bias)
                 for c in parity.cfgs("qwen3-moe-30b-a3b"))
    assert cfg.qk_norm
    rng = np.random.default_rng(2)
    d, hq, hkv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.head_dim)
    p = {"wq": rng.normal(size=(d, hq, dh)) / d ** 0.5,
         "wk": rng.normal(size=(d, hkv, dh)) / d ** 0.5,
         "wv": rng.normal(size=(d, hkv, dh)) / d ** 0.5,
         "q_norm": {"scale": 1 + 0.1 * rng.normal(size=(dh,))},
         "k_norm": {"scale": 1 + 0.1 * rng.normal(size=(dh,))}}
    if bias:
        p.update(bq=rng.normal(size=(hq, dh)), bk=rng.normal(size=(hkv, dh)),
                 bv=rng.normal(size=(hkv, dh)))
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
    x = _x(cfg, B=2, S=7)
    pos = np.tile(np.arange(3, 10, dtype=np.int32), (2, 1))
    want = jattn.qkv_project(jax.tree.map(jnp.asarray, p), jcfg,
                             jnp.asarray(x), jnp.asarray(pos))
    got = attention.qkv_project(jax.tree.map(_t, p), cfg, _t(x), _t(pos))
    for g, w in zip(got, want):
        _close(g, w)
    # the norm binds: without it q differs
    plain = attention.qkv_project(jax.tree.map(_t, p),
                                  cfg.replace(qk_norm=False), _t(x), _t(pos))
    assert not torch.allclose(plain[0], got[0], atol=1e-3)


@pytest.mark.parametrize("mode", parity.MODES, ids=parity.MODE_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_served_streams_equal_reference_at_ample_capacity(monkeypatch, arch,
                                                          mode):
    """At a capacity where no token is dropped, each mode's greedy streams
    and scheduler counts equal the reference's in the same mode."""
    monkeypatch.setenv("REPRO_PAGED_ATTN", "1")
    real = parity.cfgs
    monkeypatch.setattr(parity, "cfgs", lambda a: tuple(
        _factor(c, AMPLE) for c in real(a)))
    assert parity.cfgs(arch)[1].moe.capacity_factor == AMPLE
    parity.check_served(arch, "init", mode)
