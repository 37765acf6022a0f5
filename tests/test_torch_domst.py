"""Port's Dom-ST forward, loss and eval against the reference's
``jax.jit(domst.forward)`` (no mesh), for all three variants, from the
reference's own init carried across by ``params_from_jax``. fp32; atol
1e-4 on qhat (30 LSTM steps x 2 layers, summed in another order). The
pixel permutations are compared first, so a rank flip shows as a flip."""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import domst as jdomst  # noqa: E402
from repro.core.partitioner import partition_pixels as j_partition  # noqa: E402
from repro.core.pixcon import pixcon_block as j_pixcon_block  # noqa: E402
from repro.core.spatial import spatial_block as j_spatial_block  # noqa: E402
from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import domst  # noqa: E402
from repro_torch.core.partitioner import partition_pixels, static_partition  # noqa: E402
from repro_torch.core.pixcon import pixcon_block  # noqa: E402
from repro_torch.core.spatial import spatial_block  # noqa: E402
from repro_torch.kernels.lstm_cell.ops import lstm_cell_fused  # noqa: E402
from repro_torch.kernels.pixcon.ops import pixcon_gate  # noqa: E402

torch.set_num_threads(1)
VARIANTS = ("domst", "domst-singlehead", "domst-singlehead-p")
ATOL = 1e-4


def _batch(seed, B=6, T=30, P=64):
    rng = np.random.default_rng(seed)
    return {"precip": rng.gamma(0.8, 1.0, (B, T, P)).astype(np.float32),
            "dist": np.broadcast_to(rng.uniform(0, 1, P), (B, P)).astype(np.float32),
            "target_day": rng.gamma(0.8, 1.0, (B, P)).astype(np.float32),
            "discharge": rng.normal(0, 1, (B,)).astype(np.float32)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_configs_match_reference():
    assert list_configs() == sorted(VARIANTS + (
        "gemma2-2b", "gemma2-2b-localonly", "llama3.2-3b", "mamba2-130m",
        "olmo-1b", "qwen2-1.5b", "recurrentgemma-2b"))
    for name in VARIANTS:
        j, t = j_get_config(name), get_config(name)
        assert (t.name, t.family, t.causal) == (j.name, j.family, j.causal)
        for field in ("num_pixels", "window_days", "num_heads", "cnn_channels",
                      "kernel_size", "lstm_hidden", "lstm_layers", "mlp_hidden",
                      "use_pixcon", "use_target_day"):
            assert getattr(t.domst, field) == getattr(j.domst, field), field
        assert vars(t.domst.pixcon) == vars(j.domst.pixcon)


@pytest.mark.parametrize("name", VARIANTS)
def test_init_matches_reference_shapes_and_scales(name):
    """Same leaves, shapes and init law as the reference (not its bits)."""
    cfg = get_config(name)
    R = 8
    jp = params_from_jax(_np_tree(jdomst.init_stacked(
        j_get_config(name), jax.random.key(0), R)))
    tp = domst.init(cfg, torch.Generator().manual_seed(0), R)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    for k, (shape, kind) in domst.param_shapes(cfg).items():
        if kind == "zeros":
            assert not tp[k].any() and not jp[k].any(), k
        else:
            std = (shape[-2] if len(shape) >= 2 else shape[-1]) ** -0.5
            for p in (tp, jp):
                assert abs(p[k].std().item() / std - 1) < 0.25, k


@pytest.mark.parametrize("name", VARIANTS)
def test_forward_matches_reference(name):
    jcfg, cfg = j_get_config(name), get_config(name)
    jparams = jdomst.init(jcfg, jax.random.key(1))
    params = params_from_jax(_np_tree(jparams))
    b = _batch(2)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    dc = cfg.domst
    # the partition permutation first: a rank flip must show as a flip
    if dc.use_pixcon:
        jx, jw = j_pixcon_block(jparams["pixcon"], jcfg.domst.pixcon,
                                jb["precip"], jb["dist"], jb["target_day"])
        jparts, jorder = j_partition(jx, jw, dc.num_heads)
        sub = domst.subtree({k: v[None] for k, v in params.items()}, "pixcon")
        x, w = pixcon_block(sub, dc.pixcon, tb["precip"][None],
                            tb["dist"][None], tb["target_day"][None])
        parts, order = partition_pixels(x, w, dc.num_heads)
        np.testing.assert_array_equal(order[0].numpy(), np.asarray(jorder))
        np.testing.assert_allclose(parts[0].numpy(), np.asarray(jparts), atol=1e-5)
        feats = spatial_block(domst.subtree({k: v[None] for k, v in params.items()},
                                            "spatial"), dc, parts)
        jfeats = j_spatial_block(jparams["spatial"], jcfg.domst, jparts)
        np.testing.assert_allclose(feats[0].numpy(), np.asarray(jfeats), atol=1e-4)
    want = jax.jit(jdomst.forward, static_argnums=1)(jparams, jcfg, jb)
    got = domst.forward_single(params, cfg, tb)
    assert got.shape == (6,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    jloss, jm = jdomst.loss_fn(jparams, jcfg, jb)
    loss, m = domst.loss_fn({k: v[None] for k, v in params.items()}, cfg,
                            {k: v[None] for k, v in tb.items()})
    np.testing.assert_allclose(loss.numpy()[0], float(jloss), atol=ATOL)
    np.testing.assert_allclose(m["mae"].numpy()[0], float(jm["mae"]), atol=ATOL)
    jev = jdomst.eval_metrics(jparams, jcfg, jb)
    ev = domst.eval_metrics({k: v[None] for k, v in params.items()}, cfg,
                            {k: v[None] for k, v in tb.items()})
    for k in ("nse", "mse"):
        np.testing.assert_allclose(ev[k].numpy()[0], float(jev[k]), atol=ATOL)


def test_stacked_forward_matches_vmapped_reference():
    """Leading replica axis == the reference's vmap over watersheds."""
    jcfg, cfg = j_get_config("domst"), get_config("domst")
    R = 3
    jparams = jdomst.init_stacked(jcfg, jax.random.key(2), R)
    params = params_from_jax(_np_tree(jparams))
    bs = [_batch(10 + r, B=4) for r in range(R)]
    b = {k: np.stack([x[k] for x in bs]) for k in bs[0]}
    want = jax.jit(jax.vmap(lambda p, x: jdomst.forward(p, jcfg, x)))(
        jparams, {k: jnp.asarray(v) for k, v in b.items()})
    before = (pixcon_gate.launches, lstm_cell_fused.launches)
    ev = domst.evaluate(params, cfg, {k: torch.from_numpy(v) for k, v in b.items()})
    assert ev["qhat"].shape == (R, 4) and ev["nse"].shape == (R,)
    np.testing.assert_allclose(ev["qhat"].numpy(), np.asarray(want), atol=ATOL)
    assert (pixcon_gate.launches, lstm_cell_fused.launches) == before == (0, 0)


def test_static_partition_matches_raster_blocks():
    x = torch.arange(2 * 3 * 8, dtype=torch.float32).reshape(1, 2, 3, 8)
    parts = static_partition(x, 4)
    assert parts.shape == (1, 2, 4, 3, 2)
    np.testing.assert_array_equal(parts[0, 1, 2].numpy(), x[0, 1, :, 4:6].numpy())


def test_partition_ties_keep_pixel_order():
    """Equal weights rank by pixel index, as the reference's stable sort."""
    w = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5]])
    x = torch.zeros(1, 2, 6)
    _, order = partition_pixels(x, w, 2)
    want = np.asarray(jnp.argsort(-jnp.asarray(w.numpy()), axis=-1))
    np.testing.assert_array_equal(order.numpy(), want)
    assert order.tolist() == [[1, 3, 0, 2, 5, 4]]


@pytest.mark.parametrize("use_target_day", [True, False])
def test_temporal_block_matches_reference(use_target_day):
    from repro.core.temporal import temporal_block as j_temporal_block
    from repro_torch.core.temporal import temporal_block
    jcfg = j_get_config("domst")
    dc = get_config("domst").domst
    jdc = jcfg.domst
    if not use_target_day:
        import dataclasses
        dc = dataclasses.replace(dc, use_target_day=False)
        jdc = dataclasses.replace(jdc, use_target_day=False)
    jp = jdomst.init(jcfg.replace(domst=jdc), jax.random.key(5))["temporal"]
    tp = {k[len("temporal/"):]: v[None] for k, v in
          params_from_jax({"temporal": _np_tree(jp)}).items()}
    rng = np.random.default_rng(5)
    feats = rng.normal(0, 1, (3, 30, 128)).astype(np.float32)
    tday = rng.gamma(1.0, 1.0, (3, 64)).astype(np.float32)
    want = j_temporal_block(jp, jdc, jnp.asarray(feats), jnp.asarray(tday))
    got = temporal_block(tp, dc, torch.from_numpy(feats)[None],
                         torch.from_numpy(tday)[None])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=ATOL)


def test_nse_matches_reference_including_constant_observations():
    from repro.metrics.nse import nse as j_nse
    from repro_torch.metrics.nse import nse
    rng = np.random.default_rng(6)
    sim = rng.normal(0, 1, (4, 50)).astype(np.float32)
    obs = rng.normal(0, 1, (4, 50)).astype(np.float32)
    obs[3] = 0.5                       # zero variance: the 1e-12 clamp
    got = nse(torch.from_numpy(sim), torch.from_numpy(obs)).numpy()
    want = [float(j_nse(jnp.asarray(s), jnp.asarray(o))) for s, o in zip(sim, obs)]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_params_from_jax_keeps_key_paths_and_repacks():
    from repro.checkpoint.checkpoint import _path_str
    jparams = jdomst.init_stacked(j_get_config("domst"), jax.random.key(4), 2)
    leaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    paths = {_path_str(p): np.asarray(v) for p, v in leaves}
    params = params_from_jax(_np_tree(jparams))
    assert set(params) == set(paths)
    for k, v in params.items():
        np.testing.assert_array_equal(v.numpy().reshape(-1), paths[k].reshape(-1))
    assert params["pixcon/w2"].shape == (2, 32)
    assert params["temporal/lstm0/wx"].shape == (2, 128, 4, 64)
    assert params["temporal/lstm1/b"].shape == (2, 4, 64)
    assert params["temporal/fc2"].shape == (2, 64, 1)
