"""The port's seed-era API against the reference's, on the CPU:
``domst.make_train_step`` / ``make_stacked_train_step`` (thin veneers over
``Engine.for_domst(..., donate=False)`` and ``Engine.wrap``) and
``launch.serve.serve(args)``, the reference's dispatcher.

Params start from the reference's init, carried across by
``params_from_jax``; the reference's steps run with no mesh (its makers
pin no shardings then). Tolerances as ``test_torch_train_domst.py``:
losses, params and both optimizer moments over 5 steps ``rtol=1e-4,
atol=1e-6``. The caller's params and optimizer state are left as they
were. ``serve(args)`` takes a plain object with only the reference's
fields: the forecast's NSE within 1e-4 of the reference's
(``test_torch_forecast.py``'s tolerance) and the LM streams' digest equal,
both from the same reference-layout checkpoint (the reference serves on a
1x1 mesh with Auto axes, in float32 like the port's engine here: jax 0.9
rejects its default mesh). On a (2, 1) gloo mesh the stacked step splits
the watersheds over "data" and equals the one-device step.
"""
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

import repro.launch.serve as jserve  # noqa: E402
from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_variant as j_smoke_variant  # noqa: E402
from repro.core import domst as jdomst  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro.serve import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serve.forecast import Forecaster as JForecaster  # noqa: E402
from repro_torch.configs import TrainConfig, get_config, smoke_variant  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import domst  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.train import Engine, TrainState  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-6)
STEPS = 5


def _tcs(**kw):
    kw = {"learning_rate": 1e-3, "total_steps": 10, "warmup_steps": 1, **kw}
    return JTrainConfig(**kw), TrainConfig(**kw)


def _batch(seed, dc, lead=(), B=8):
    rng = np.random.default_rng(seed)
    T, P = dc.window_days, dc.num_pixels
    return {"precip": rng.gamma(0.8, 1.0, lead + (B, T, P)).astype(np.float32),
            "dist": rng.uniform(0, 1, lead + (B, P)).astype(np.float32),
            "target_day": rng.gamma(0.8, 1.0, lead + (B, P)).astype(np.float32),
            "discharge": rng.normal(0, 1, lead + (B,)).astype(np.float32)}


def _port(tree, stacked):
    p = params_from_jax(jax.tree.map(np.asarray, tree))
    return p if stacked else {k: v[None] for k, v in p.items()}


def _close(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=f"{what} {k}", **TOL)


@pytest.mark.parametrize("stacked", [False, True], ids=["single", "stacked"])
@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_seed_steps_match_reference(stacked, optimizer):
    name = "domst"
    jcfg = j_smoke_variant(j_get_config(name))
    cfg = smoke_variant(get_config(name))
    jtc, tc = _tcs(optimizer=optimizer)
    W = 3
    if stacked:
        jparams = jdomst.init_stacked(jcfg, jax.random.key(2), W)
        jstep = jdomst.make_stacked_train_step(jcfg, jtc)
        step = domst.make_stacked_train_step(cfg, tc, device="cpu")
    else:
        jparams = jdomst.init(jcfg, jax.random.key(2))
        jstep = jdomst.make_train_step(jcfg, jtc)
        step = domst.make_train_step(cfg, tc, device="cpu")
    jopt = j_make_optimizer(jtc)[0](jparams)
    if stacked:                          # one optimizer state per watershed
        jopt = jax.vmap(j_make_optimizer(jtc)[0])(jparams)
    params = _port(jparams, stacked)
    opt = make_optimizer(tc)[0](params)
    given = ({k: v.clone() for k, v in params.items()},
             {k: v.clone() for k, v in opt.mu.items()}, opt.step.clone())
    first = (params, opt)
    lead = (W,) if stacked else ()
    for i in range(STEPS):
        b = _batch(10 + i, cfg.domst, lead)
        jparams, jopt, jm = jstep(jparams, jopt,
                                  {k: jnp.asarray(v) for k, v in b.items()})
        params, opt, m = step(params, opt, b)
        np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]),
                                   err_msg=f"step {i}", **TOL)
        assert m["loss"].shape == lead
    _close(params, _port(jparams, stacked), "params")
    _close(opt.mu, _port(jopt.mu, stacked), "mu")
    if optimizer == "adamw":
        _close(opt.nu, _port(jopt.nu, stacked), "nu")
    np.testing.assert_array_equal(opt.step.numpy().reshape(-1),
                                  np.asarray(jopt.step).reshape(-1))
    # the caller's first params and optimizer state were never written
    for k, v in given[0].items():
        assert torch.equal(first[0][k], v), k
    for k, v in given[1].items():
        assert torch.equal(first[1].mu[k], v), k
    assert torch.equal(first[1].step, given[2])


def test_wrap_adopts_without_copy_or_donation():
    """``Engine.wrap`` puts the caller's tensors into a TrainState as
    they are (step 0, an rng leaf of the reference's shape); a
    ``donate=False`` step leaves them as they were."""
    cfg = smoke_variant(get_config("domst"))
    _, tc = _tcs()
    eng = Engine.for_domst(cfg, tc, stacked=True, donate=False, device="cpu")
    params = domst.init(cfg, torch.Generator().manual_seed(0), 2)
    opt = make_optimizer(tc)[0](params)
    st = eng.wrap(params, opt)
    assert isinstance(st, TrainState) and int(st.step) == 0
    assert st.rng.shape == (2, 2) and st.rng.dtype == torch.uint32
    assert all(st.params[k] is params[k] for k in params)
    before = {k: v.clone() for k, v in params.items()}
    new, _ = eng.step(st, eng.place_batch(_batch(0, cfg.domst, (2,))))
    assert int(new.step) == 1
    for k in params:
        assert torch.equal(params[k], before[k]), k
        assert not torch.equal(new.params[k], before[k]), k
    single = Engine.for_domst(cfg, tc, donate=False, device="cpu")
    assert single.wrap({k: v[:1] for k, v in params.items()},
                       opt).rng.shape == (2,)


# ---------------------------------------------------------------------------
# serve(args)
# ---------------------------------------------------------------------------
def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


@pytest.fixture
def float32_both(monkeypatch):
    """The reference's launcher on an Auto-axes mesh in float32, the
    port's engine in float32."""
    mesh = _auto_mesh()
    monkeypatch.setattr(jserve, "InferenceEngine", lambda cfg, **kw:
                        JInferenceEngine(cfg, mesh=mesh, dtype=jnp.float32,
                                         **kw))
    monkeypatch.setattr(jserve, "Forecaster",
                        lambda cfg: JForecaster(cfg, mesh=mesh))
    real = tserve.InferenceEngine
    monkeypatch.setattr(tserve, "InferenceEngine", lambda *a, **kw: real(
        *a, **dict(kw, dtype=torch.float32)))


def _ref_fields(**kw):
    """The fields the reference's launcher reads, at its CLI's defaults
    (the port's parser has the same ones, ``device`` aside)."""
    ns = vars(tserve.build_parser().parse_args(["--arch", kw["arch"]]))
    ns.pop("device")
    return {**ns, **kw}


class _Args:
    """An ``args`` object as the reference's examples build one: a plain
    class with only some fields, and no ``device``."""


def _args(**fields):
    a = _Args()
    for k, v in fields.items():
        setattr(a, k, v)
    return a


def test_serve_dispatches_domst(float32_both, tmp_path, capsys):
    jcfg = j_get_config("domst")
    jparams = jdomst.init_stacked(jcfg, jax.random.key(3), 2)
    path = str(tmp_path / "state.npz")
    jckpt.save(path, {"params": jparams})
    fields = dict(arch="domst", watersheds=2, days=120, ckpt=path, seed=0,
                  profile_dir="")
    want = jserve.serve(SimpleNamespace(**fields))
    got = tserve.serve(_args(device="cpu", **fields))
    capsys.readouterr()
    assert got["restored"] and got["device"] == "cpu"
    assert len(got["nse"]) == len(want["nse"]) == 2
    np.testing.assert_allclose(got["nse"], want["nse"], atol=1e-4)


def test_serve_dispatches_lm(float32_both, tmp_path, capsys):
    arch = "qwen2-1.5b"
    jparams = jtfm.init(j_smoke_variant(j_get_config(arch)),
                        jax.random.key(5))
    path = str(tmp_path / "lm.npz")
    jckpt.save(path, {"params": jparams, "step": jnp.zeros((), jnp.int32)})
    fields = _ref_fields(arch=arch, smoke=True, requests=3, batch_size=2,
                         prompt_len=12, ragged=True, gen=4, page_size=8,
                         prefill_chunk=5, spec_k=3, ckpt=path)
    want = jserve.serve(SimpleNamespace(**fields))
    # the port's object carries the reference example's fields only
    keep = ("arch", "smoke", "requests", "batch_size", "prompt_len", "gen",
            "max_len", "page_size", "num_pages", "prefill_chunk", "spec_k",
            "drafter", "draft_config", "draft_ckpt", "eos", "ragged", "ckpt",
            "seed", "prefix_cache", "preempt", "shared_prefix")
    got = tserve.serve(_args(device="cpu", **{k: fields[k] for k in keep}))
    printed = capsys.readouterr().out.splitlines()
    assert got["stream_digest"] == want["stream_digest"]
    assert got["tokens"] == want["tokens"] == 12
    assert got["spec_proposed"] == want["spec_proposed"] > 0
    assert got["prefill_chunks"] == want["prefill_chunks"] > 0
    assert sum(ln.startswith("req ") for ln in printed) == 4   # 2 a run


def test_serve_defaults_to_cuda(monkeypatch):
    """An ``args`` without ``device`` serves on the card: without one it
    raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("domst", "qwen2-1.5b"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tserve.serve(_args(arch=arch, smoke=True, watersheds=1,
                               days=60))


def test_stacked_seed_step_on_a_mesh(tmp_path):
    """``make_stacked_train_step(mesh=)`` on a (2, 1) gloo mesh: the
    watershed axis split over "data", losses and params equal to the
    one-device step's within the stepped tolerance."""
    import torch_dist_harness as harness
    cfg = smoke_variant(get_config("domst"))
    _, tc = _tcs()
    params = domst.init(cfg, torch.Generator().manual_seed(1), 2)
    batches = [_batch(20 + i, cfg.domst, (2,)) for i in range(3)]
    step = domst.make_stacked_train_step(cfg, tc, device="cpu")
    p, opt = params, make_optimizer(tc)[0](params)
    want = []
    for b in batches:
        p, opt, m = step(p, opt, b)
        want.append(m["loss"].numpy())
    got = harness.spawn("seed_steps", 2, tmp_path, mesh_shape=(2, 1),
                        params={k: v.numpy() for k, v in params.items()},
                        batches=batches, tc=dict(learning_rate=1e-3,
                                                 total_steps=10,
                                                 warmup_steps=1))
    for rank in got:
        np.testing.assert_allclose(np.stack(rank["losses"]), np.stack(want),
                                   **TOL)
        _close({k: torch.from_numpy(v) for k, v in rank["params"].items()},
               p, "mesh params")
        assert all("Shard(dim=0)" in s for s in rank["placements"].values())
