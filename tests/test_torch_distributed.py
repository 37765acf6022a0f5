"""The port's distribution layer on gloo ranks (CPU), against the
reference, which computes the same math whatever its mesh: its engines
run on a 1x1 mesh with ``AxisType.Auto`` axes (this jax rejects the
reference's own host mesh) or with no mesh. Rank-side code is in
``torch_dist_harness.py``; every spawned case has its own limit of
120 s, past which its ranks are killed and the test fails. Float32
throughout (gloo's bfloat16 coverage is thin).

* Dom-ST stacked (IP-D), R=4 and R=3 (the watershed axis divides the
  data axis or replicates), on data=2 x model=2 and data=4: three AdamW
  steps, the step metrics and every param and moment within 1e-5 of
  their scale; at data=4 with R=4, ``CommDebugMode`` counts no collective
  in a step (the watersheds share nothing).
* The ``Forecaster`` on data=2: qhat within 1e-3, NSE within 1e-4.
* qwen2-1.5b, mamba2-130m and recurrentgemma-2b at smoke size on
  data=2 x model=2, with and without FSDP (with FSDP, block remat too);
  qwen3-moe-30b-a3b and
  deepseek-moe-16b (4 experts, top 2, the default capacity: tokens drop)
  expert-parallel on model=2: the loss and every gradient leaf of a batch
  against ``jax.value_and_grad`` of the reference's ``lm_loss``, then
  three steps against the reference's engine: the step metrics and every
  param and first moment within 1e-4 of their scale (AdamW eps 1e-4, as
  ``test_torch_train_lm.py`` holds the one-device engine); both moments
  placed as their params, the step count whole.
* hubert-xlarge (smoke) at data=2 with two microbatches a step, held
  as the LM cases against the reference's engine at ``accum_steps=2``:
  each microbatch's loss is a mean over its own masked frames, so the
  ranks' slices must make up the reference's microbatches.
* A stacked checkpoint saved from data=4 equal to the bit to the one the
  one-device engine writes after the same step, restored on the mesh and
  stepped on, equal to the bit to the one-device run.
* Local attention with the query heads split: KV heads split alike,
  whole with each rank's queries in one KV group (the rank slices it),
  and whole otherwise (the queries are gathered), against the plain
  version: outputs and gradients within 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

import torch_dist_harness as harness  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_variant as j_smoke_variant  # noqa: E402
from repro.core import domst as jdomst  # noqa: E402
from repro.data.pipeline import make_domst_windows as j_windows  # noqa: E402
from repro.data.pipeline import stacked_test_batch as j_stacked  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serve.forecast import Forecaster as JForecaster  # noqa: E402
from repro.train import Engine as JEngine  # noqa: E402
from repro_torch.configs import TrainConfig, get_config, smoke_variant  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    flatten, lm_params_to_jax, params_from_jax, unflatten,
)
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.train import Engine  # noqa: E402
from test_torch_frontends import _comparable  # noqa: E402
from test_torch_train_lm import _batch, _jparams, _leaf_errors  # noqa: E402

torch.set_num_threads(1)
TC = dict(learning_rate=1e-3, total_steps=10, warmup_steps=1, eps=1e-4)
DOMST_REL, LM_REL = 1e-5, 1e-4


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _close(got, want, rel, what):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rel * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# Dom-ST
# ---------------------------------------------------------------------------
def _domst_case(R, seed=0, steps=3, B=4):
    jcfg = j_smoke_variant(j_get_config("domst"))
    dc = jcfg.domst
    jparams = jdomst.init_stacked(jcfg, jax.random.key(seed), R)
    params = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, jparams)).items()}
    rng = np.random.default_rng(seed)
    T, P = dc.window_days, dc.num_pixels
    batches = [{"precip": rng.random((R, B, T, P), np.float32),
                "dist": rng.random((R, B, P), np.float32),
                "target_day": rng.random((R, B, P), np.float32),
                "discharge": rng.random((R, B), np.float32)}
               for _ in range(steps)]
    return jcfg, jparams, params, batches


def _ref_domst(jcfg, jparams, batches):
    eng = JEngine.for_domst(jcfg, JTrainConfig(**TC), mesh=_auto_mesh(),
                            stacked=True, donate=False)
    st = eng.init_state(jax.random.key(0), jparams)
    mets = []
    for b in batches:
        st, m = eng.step(st, eng.place_batch(b))
        mets.append({k: np.asarray(v) for k, v in m.items()})
    flat = {k: np.asarray(v) for k, v in flatten(
        jax.tree.map(np.asarray, st.params)).items()}
    mu = {k: np.asarray(v) for k, v in flatten(
        jax.tree.map(np.asarray, st.opt_state.mu)).items()}
    return mets, flat, mu


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1)], ids=str)
@pytest.mark.parametrize("R", [4, 3])
def test_domst_stacked_on_mesh_matches_reference(R, mesh_shape, tmp_path):
    from repro_torch.convert import from_port_layout
    jcfg, jparams, params, batches = _domst_case(R)
    got = harness.spawn("domst_steps", 4, tmp_path, mesh_shape=mesh_shape,
                        cfg_name="domst", params=params, batches=batches,
                        tc=TC, count_comms=True)
    mets, want, want_mu = _ref_domst(jcfg, jparams, batches)
    for r in got[1:]:                         # every rank gathers the same
        for k in r["params"]:
            np.testing.assert_array_equal(r["params"][k], got[0]["params"][k])
    g = got[0]
    for step, (a, b) in enumerate(zip(g["mets"], mets)):
        for k in ("loss", "mse", "grad_norm", "lr"):
            _close(a[k], b[k], DOMST_REL, (step, k))
    for k, w in want.items():
        _close(from_port_layout(k, g["params"][k]), w, DOMST_REL, k)
        _close(from_port_layout(k, g["mu"][k]), want_mu[k], DOMST_REL, k)
    # the watershed axis on "data" where it divides, else whole
    lead = "Shard(dim=0)" if R % mesh_shape[0] == 0 else "Replicate()"
    assert g["placements"]["temporal/lstm0/wx"].startswith("(" + lead)
    if mesh_shape == (4, 1) and R == 4:
        assert g["comms"] == 0                # IP-D: nothing crosses ranks
    else:
        assert g["comms"] > 0


def test_domst_checkpoint_from_mesh_equals_one_device_file(tmp_path):
    """data=4, R=4: no collective, so the mesh's steps are the one-device
    engine's to the bit; the gathered file equals its file to the bit,
    and a restore on the mesh resumes to the same bits."""
    _, _, params, batches = _domst_case(4, seed=2)
    path = str(tmp_path / "mesh.npz")
    got = harness.spawn("domst_checkpoint", 4, tmp_path, mesh_shape=(4, 1),
                        cfg_name="domst", params=params, batches=batches,
                        tc=TC, path=path)[0]
    cfg = smoke_variant(get_config("domst"))
    eng = Engine.for_domst(cfg, TrainConfig(**TC), stacked=True, device="cpu")
    state = eng.init_state({k: torch.from_numpy(v.copy())
                            for k, v in params.items()})
    state, _ = eng.step(state, eng.place_batch(batches[0]))
    ref_path = str(tmp_path / "one.npz")
    eng.save(ref_path, state)
    with np.load(path) as a, np.load(ref_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k, v in state.params.items():
        np.testing.assert_array_equal(got["restored"]["params"][k], v.numpy())
    for b in batches[1:]:
        state, _ = eng.step(state, eng.place_batch(b))
    for k, v in state.params.items():
        np.testing.assert_array_equal(got["final"]["params"][k], v.numpy())
        np.testing.assert_array_equal(got["final"]["nu"][k],
                                      state.opt_state.nu[k].numpy())
    np.testing.assert_array_equal(got["final"]["opt_step"],
                                  state.opt_state.step.numpy())
    assert got["final"]["step"] == int(state.step) == len(batches)


def test_forecaster_on_data_mesh_matches_reference(tmp_path):
    W, DAYS = 4, 120
    jcfg = j_get_config("domst")
    held = j_stacked(j_windows(W, DAYS))
    jparams = jdomst.init_stacked(jcfg, jax.random.key(3), W)
    want = {k: np.asarray(v) for k, v in JForecaster(
        jcfg, explicit_shardings=False)(jparams, held).items()}
    params = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, jparams)).items()}
    got = harness.spawn("forecast", 2, tmp_path, mesh_shape=(2, 1),
                        params=params,
                        held={k: np.asarray(v) for k, v in held.items()})
    for r in got:
        assert r["qhat"].shape == want["qhat"].shape
        np.testing.assert_allclose(r["qhat"], want["qhat"], atol=1e-3)
        np.testing.assert_allclose(r["nse"], want["nse"], atol=1e-4)
        assert np.all(np.isfinite(r["nse"]))


# ---------------------------------------------------------------------------
# LM training
# ---------------------------------------------------------------------------
def _ref_lm(jcfg, jtree, batches, accum=1):
    """The reference's loss and grads of the first batch, then its engine's
    three steps of ``accum`` microbatches (no mesh; float32 ``lm_loss``)."""
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    (loss, _), grads = jax.value_and_grad(
        lambda p: jtfm.lm_loss(p, jcfg, jb, dtype=jnp.float32),
        has_aux=True)(jtree)
    eng = JEngine(lambda p, b: jtfm.lm_loss(p, jcfg, b, dtype=jnp.float32),
                  JTrainConfig(**TC),
                  cfg=jcfg, explicit_shardings=False, accum_steps=accum)
    st = eng.init_state(jax.random.key(0), jax.tree.map(jnp.asarray, jtree))
    mets = []
    for b in batches:
        st, m = eng.step(st, {k: jnp.asarray(v) for k, v in b.items()})
        mets.append({k: float(v) for k, v in m.items()})
    return (float(loss), jax.tree.map(np.asarray, grads), mets,
            jax.tree.map(np.asarray, st.params),
            jax.tree.map(np.asarray, st.opt_state.mu))


def _lm_case(arch, mesh_shape, fsdp, tmp_path, accum=1):
    jcfg = j_smoke_variant(j_get_config(arch))
    cfg = smoke_variant(get_config(arch))
    jtree = _jparams(jcfg)
    params = {k: v.numpy() for k, v in flatten(params_from_jax(jtree)).items()}
    batches = [_batch(cfg, seed=s, b=4, s=24) for s in range(3)]
    got = harness.spawn("lm_run", mesh_shape[0] * mesh_shape[1], tmp_path,
                        mesh_shape=mesh_shape, cfg_name=arch, params=params,
                        batches=batches,
                        tc={**TC, "fsdp": fsdp,
                            "remat": "block" if fsdp else "none"},
                        accum=accum)[0]
    loss, grads, mets, want_p, want_mu = _ref_lm(jcfg, jtree, batches, accum)
    like = tfm.model_params(cfg, lambda *a: None)

    def held(flat, want):
        # hubert's unread token embedding and its key biases at their
        # rounding floor (``_comparable``)
        return _comparable(cfg, lm_params_to_jax(unflatten(flat, like), cfg),
                           want)
    _close(got["loss0"], loss, 1e-5, "loss")
    _leaf_errors(*held(got["grads"], grads), LM_REL)
    for step, (a, b) in enumerate(zip(got["mets"], mets)):
        for k in ("loss", "ce", "grad_norm", "lr"):
            _close(a[k], b[k], LM_REL, (step, k))
    _leaf_errors(*held(got["params"], want_p), LM_REL)
    _leaf_errors(*held(got["mu"], want_mu), LM_REL)
    # both moments take their param's placements; the step count is whole
    for k, pl in got["placements"].items():
        assert got["moment_placements"][k] == (pl, pl), k
    assert got["step_placements"] == "(Replicate(), Replicate())"
    return got


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-130m",
                                  "recurrentgemma-2b"])
def test_lm_training_on_mesh_matches_reference(arch, fsdp, tmp_path):
    got = _lm_case(arch, (2, 2), fsdp, tmp_path)
    pl = got["placements"]
    # the embedding's vocab on "model"; with FSDP its embed dim on "data"
    assert pl["embed/embedding"] == (
        "(Shard(dim=2), Shard(dim=1))" if fsdp
        else "(Replicate(), Shard(dim=1))")


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-moe-16b"])
def test_moe_expert_parallel_matches_reference(arch, tmp_path):
    cfg = smoke_variant(get_config(arch))
    assert cfg.moe.num_experts == 4 and cfg.moe.capacity_factor <= 1.25
    got = _lm_case(arch, (1, 2), False, tmp_path)
    # the last layer's FFN is a MoE one (deepseek's first is dense): its
    # experts on "model"
    assert got["placements"]["layers/1/ffn/w_gate"] == \
        "(Replicate(), Shard(dim=1))"


def test_accumulation_on_data_mesh_matches_reference(tmp_path):
    """hubert-xlarge (smoke) at data=2 with two microbatches a step. Each
    microbatch's loss is a mean over its own masked frames (~8% of them),
    so the ranks' local slices must make up the reference's contiguous
    microbatches, not any equal share of the rows."""
    cfg = smoke_variant(get_config("hubert-xlarge"))
    assert cfg.frontend == "audio_stub" and not cfg.causal
    _lm_case("hubert-xlarge", (2, 1), False, tmp_path, accum=2)


def test_local_attention_head_splits(tmp_path):
    cases = [(4, 2, True), (4, 1, False), (6, 3, False)]
    got = harness.spawn("local_attention_cases", 2, tmp_path, cases=cases)[0]
    for (Hq, Hkv, _), r in zip(cases, got):
        assert max(r["err"]) <= 1e-5, (Hq, Hkv, r)
    # split queries stay split where their KV heads can follow; gathered
    # where they cannot
    assert [r["out_placements"] for r in got] == [
        "(Replicate(), Shard(dim=2))", "(Replicate(), Shard(dim=2))",
        "(Replicate(), Replicate())"]


def test_engine_without_mesh_is_unchanged():
    """``mesh=None``: plain tensors, no rules, and the step runs outside
    any sharding context."""
    from repro_torch.distributed import sharding as shd
    cfg = smoke_variant(get_config("domst"))
    eng = Engine.for_domst(cfg, TrainConfig(**TC), stacked=True, device="cpu")
    assert eng.mesh is None and not hasattr(eng, "rules")
    from repro_torch.core import domst
    state = eng.init_state(domst.init(cfg, torch.Generator().manual_seed(0), 2))
    assert all(type(v) is torch.Tensor for v in state.params.values())
    assert shd.current() is None
