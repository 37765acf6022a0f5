"""The port's Mamba-2 and RG-LRU blocks (``repro_torch.models.ssm``,
``repro_torch.models.rglru``) on the CPU in float32, where the conv1d and
SSD-chunk wrappers compute their plain versions, against the reference's
``repro.models.ssm`` and ``repro.models.rglru`` from the same params (the
reference's init at smoke size, carried across as numpy).

Covered: the whole-prompt blocks with their final state (the reference's
``return_state=True``), with S not a multiple of the SSD chunk and S
below it; the one-token decode steps from a non-zero state;
``ssd_chunked`` itself; and, within the port, a prefill followed by a
decode roll-out against a longer prefill, and the multi-token step (the
chunk and verify paths) against that many one-token steps, with its
per-token snapshots. Tolerance: 1e-4 of the largest magnitude of the
compared output (float32 sums taken in another order, through two
projections and a norm).
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_variant as j_smoke_variant  # noqa: E402
from repro.distributed.sharding import ParamFactory  # noqa: E402
from repro.models import rglru as j_rglru  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.models import rglru, ssm  # noqa: E402

torch.set_num_threads(1)
REL = 1e-4


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _setup(arch, sub):
    """(reference cfg, port cfg, reference params, port params) of one
    block of ``arch``'s smoke variant."""
    jcfg = j_smoke_variant(j_get_config(arch))
    cfg = smoke_variant(get_config(arch))
    mk = ParamFactory(jax.random.key(3), mode="init")
    jp = (j_ssm.ssm_params if sub == "ssm" else j_rglru.rglru_params)(mk, jcfg)
    # non-trivial biases and skip so every leaf matters
    rng = np.random.default_rng(3)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(
            0.1 * rng.normal(size=a.shape), a.dtype)
        if str(getattr(path[-1], "key", "")) in ("dt_bias", "conv_b", "ba",
                                                 "bi", "D") else a, jp)
    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a, np.float32)), jp)
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_reference(arch, smoke):
    """The port's copies of the two configs and their smoke variants equal
    the reference's field for field, sub-configs included."""
    j, t = j_get_config(arch), get_config(arch)
    if smoke:
        j, t = j_smoke_variant(j), smoke_variant(t)
    for field in vars(j):
        jv, tv = getattr(j, field), getattr(t, field)
        if field in ("ssm", "rglru") and jv is not None:
            assert vars(tv) == vars(jv), field
            assert type(tv).__name__ == type(jv).__name__
        else:
            assert tv == jv, field
    if t.ssm is not None:
        assert (t.ssm.d_inner(t.d_model), t.ssm.num_heads(t.d_model)) == \
            (j.ssm.d_inner(j.d_model), j.ssm.num_heads(j.d_model))


def _x(seed, B, S, d):
    return np.random.default_rng(seed).normal(0, 1, (B, S, d)).astype(np.float32)


def _state(shapes, seed):
    """A non-zero state: one float32 array per shape."""
    rng = np.random.default_rng(seed)
    return [(0.5 * rng.normal(size=s)).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("S", [5, 8, 21])
def test_ssm_block_matches_reference(S):
    jcfg, cfg, jp, tp = _setup("mamba2-130m", "ssm")
    x = _x(S, 2, S, cfg.d_model)
    want, wst = j_ssm.ssm_block(jp, jcfg, jnp.asarray(x), return_state=True)
    got, st = ssm.ssm_block(tp, cfg, torch.tensor(x))
    _close(got, want)
    _close(st.h, wst.h)
    _close(st.conv, wst.conv)


@pytest.mark.parametrize("S,chunk", [(21, 8), (5, 8), (16, 8)])
def test_ssd_chunked_matches_reference(S, chunk):
    rng = np.random.default_rng(S)
    B, H, P, G, N = 2, 4, 8, 1, 16
    xh = rng.normal(0, 1, (B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(0, 1, (B, S, H)))).astype(np.float32)
    A = -np.exp(rng.uniform(-1, 1, H)).astype(np.float32)
    Bm = rng.normal(0, 1, (B, S, G, N)).astype(np.float32)
    Cm = rng.normal(0, 1, (B, S, G, N)).astype(np.float32)
    D = rng.normal(1, 0.1, H).astype(np.float32)
    want_y, want_h = j_ssm.ssd_chunked(*map(jnp.asarray, (xh, dt, A, Bm, Cm, D)),
                                       chunk)
    got_y, got_h = ssm.ssd_chunked(*map(torch.tensor, (xh, dt, A, Bm, Cm, D)),
                                   chunk)
    _close(got_y, want_y)
    _close(got_h, want_h)


def test_ssm_decode_step_matches_reference():
    jcfg, cfg, jp, tp = _setup("mamba2-130m", "ssm")
    B = 3
    fresh = ssm.init_ssm_state(cfg, B)
    h, conv = _state([fresh.h.shape, fresh.conv.shape], 5)
    x = _x(9, B, 1, cfg.d_model)
    want, wst = j_ssm.ssm_decode_step(
        jp, jcfg, jnp.asarray(x), j_ssm.SSMState(jnp.asarray(h), jnp.asarray(conv)))
    got, st = ssm.ssm_decode_step(
        tp, cfg, torch.tensor(x), ssm.SSMState(torch.tensor(h), torch.tensor(conv)))
    _close(got, want)
    _close(st.h, wst.h)
    _close(st.conv, wst.conv)


@pytest.mark.parametrize("S", [1, 7, 20])
def test_rglru_block_matches_reference(S):
    jcfg, cfg, jp, tp = _setup("recurrentgemma-2b", "rec")
    x = _x(S, 2, S, cfg.d_model)
    want, wst = j_rglru.rglru_block(jp, jcfg, jnp.asarray(x), return_state=True)
    got, st = rglru.rglru_block(tp, cfg, torch.tensor(x))
    _close(got, want)
    _close(st.h, wst.h)
    _close(st.conv, wst.conv)


def test_rglru_decode_step_matches_reference():
    jcfg, cfg, jp, tp = _setup("recurrentgemma-2b", "rec")
    B = 3
    fresh = rglru.init_rglru_state(cfg, B)
    h, conv = _state([fresh.h.shape, fresh.conv.shape], 6)
    x = _x(10, B, 1, cfg.d_model)
    want, wst = j_rglru.rglru_decode_step(
        jp, jcfg, jnp.asarray(x),
        j_rglru.RGLRUState(jnp.asarray(h), jnp.asarray(conv)))
    got, st = rglru.rglru_decode_step(
        tp, cfg, torch.tensor(x),
        rglru.RGLRUState(torch.tensor(h), torch.tensor(conv)))
    _close(got, want)
    _close(st.h, wst.h)
    _close(st.conv, wst.conv)


def test_linear_scan_matches_a_loop():
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.uniform(0.5, 1.0, (2, 37, 5)).astype(np.float32))
    b = torch.tensor(rng.normal(0, 1, (2, 37, 5)).astype(np.float32))
    h, want = torch.zeros(2, 5), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(rglru.linear_scan(a, b), torch.stack(want, 1),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch,sub", [("mamba2-130m", "ssm"),
                                      ("recurrentgemma-2b", "rec")])
def test_rollout_and_multitoken_steps(arch, sub):
    """Prefill S tokens, then T more: one at a time (decode), and all T in
    one multi-token step (chunked prefill), and with snapshots (verify):
    each equals the prefill of all S+T tokens."""
    _, cfg, _, tp = _setup(arch, sub)
    mod = ssm if sub == "ssm" else rglru
    block = ssm.ssm_block if sub == "ssm" else rglru.rglru_block
    steps = ssm.ssm_steps if sub == "ssm" else rglru.rglru_steps
    decode = ssm.ssm_decode_step if sub == "ssm" else rglru.rglru_decode_step
    S, T = 11, 6
    x = torch.tensor(_x(1, 2, S + T, cfg.d_model))
    full, full_st = block(tp, cfg, x)
    _, st = block(tp, cfg, x[:, :S])
    outs, seq_states = [], []
    cur = st
    for t in range(T):
        o, cur = decode(tp, cfg, x[:, S + t:S + t + 1], cur)
        outs.append(o)
        seq_states.append(cur)
    _close(torch.cat(outs, 1), full[:, S:].numpy())
    for a, b in zip(cur, full_st):
        _close(a, b.numpy())
    multi, last = steps(tp, cfg, x[:, S:], st)
    _close(multi, torch.cat(outs, 1).numpy(), rel=1e-5)
    snap_out, snaps = steps(tp, cfg, x[:, S:], st, snapshots=True)
    torch.testing.assert_close(snap_out, multi)
    for t, one in enumerate(seq_states):
        for a, b in zip(snaps, one):
            _close(a[t], b.numpy(), rel=1e-5)
    for a, b in zip(last, cur):
        _close(a, b.numpy(), rel=1e-5)
    assert isinstance(last, (mod.SSMState if sub == "ssm" else mod.RGLRUState))


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b"])
def test_convert_carries_every_leaf(arch):
    """``convert.params_from_jax`` unstacks the reference's ``blocks`` into
    one dict per layer with the ``rec``/``ssm`` subtrees (and the nested
    ``ssm/out_norm``), leaf for leaf with the port's own init; a tree with
    a top-level key the port does not know raises instead of dropping it."""
    from repro.models import transformer as jtfm
    from repro_torch.convert import flatten, params_from_jax
    from repro_torch.models import transformer as tfm
    jcfg = j_smoke_variant(j_get_config(arch))
    cfg = smoke_variant(get_config(arch))
    tree = jax.tree.map(np.asarray, jtfm.init(jcfg, jax.random.key(0)))
    got = params_from_jax(tree)
    own = tfm.init(cfg, torch.Generator().manual_seed(0))
    assert len(got["layers"]) == len(own["layers"]) == cfg.num_layers
    for g, o in zip(got["layers"], own["layers"]):
        fg, fo = flatten(g), flatten(o)
        assert fg.keys() == fo.keys()
        assert all(fg[k].shape == fo[k].shape for k in fg)
    n_ref = sum(np.asarray(a).size for a in jax.tree.leaves(tree))
    n_got = sum(t.numel() for lp in got["layers"] for t in flatten(lp).values())
    n_got += sum(t.numel() for k in ("embed", "final_norm")
                 for t in flatten(got[k]).values())
    assert n_got == n_ref                      # nothing dropped
    with pytest.raises(ValueError, match="mystery"):
        params_from_jax(dict(tree, mystery={"w": np.zeros(2, np.float32)}))
    gated = params_from_jax(dict(tree, gate={"w1": np.ones(2, np.float32)}))
    assert torch.equal(gated["gate"]["w1"], torch.ones(2))
