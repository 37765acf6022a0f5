"""The port's drivers (``examples/*_torch.py``, ``scripts/ci_smoke_torch.py``)
against the reference's own drivers, on the CPU at small sizes.

Each ported example's functions are fed the reference's params, carried
across by ``convert.py``, and held against the reference example's code
path on the same data:

* ``train_flood_torch.train_stacked`` against ``examples/train_flood.py``'s
  own ``train_stacked`` (its engine built without explicit shardings: jax
  0.9 rejects its default host mesh), 2 watersheds x 150 days, 1 epoch,
  Dom-ST and Singlehead: the held-out NSE per watershed within 1e-4;
* ``quickstart_torch.train_single`` against the quickstart's loop at 5
  steps on the same ``default_rng(0)`` draws: losses and the test NSE
  within 1e-4;
* ``train_lm_torch.train_lm`` at the smoke config for 3 steps, in float32,
  against ``examples/train_lm.py``'s loop on the reference's engine:
  losses within 1e-4 relative;
* ``serve_lm_torch``'s runs from a checkpoint that ``repro.checkpoint.save``
  wrote, with the engines in float32 (as ``test_torch_serve_cli.py`` pins
  them; the reference on a 1x1 Auto mesh), against ``repro.launch.serve``
  given the reference example's ``Args``: stream digests and prefix-hit
  counts equal. The reference example's ``Args`` lacks fields its launcher
  has read since (``queue``, the sampling and telemetry flags, the host
  tier), so the reference is given them at its CLI's defaults.

``ci_smoke_torch``'s four checks run in-process (``run_in_process``) at
the smoke config on the CPU with their own assertions.
"""
import importlib.util
from pathlib import Path
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
from repro.data import generate_all_watersheds as j_all_watersheds  # noqa: E402
from repro.data import generate_watershed as j_watershed  # noqa: E402
from repro.data import make_training_windows as j_windows  # noqa: E402
from repro.data.loader import ShardedLoader as JLoader  # noqa: E402
from repro.data.pipeline import InputPipeline as JPipeline  # noqa: E402
from repro.data.pipeline import train_split as j_train_split  # noqa: E402
from repro.data.pipeline import train_test_split as j_split  # noqa: E402
from repro.data.tokens import TokenSource as JTokenSource  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro.serve import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.train import Engine as JEngine  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    InputPipeline, make_training_windows, train_split,
)
from repro_torch.data.synthetic_hydro import generate_all_watersheds  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


flood = _load(ROOT / "examples" / "train_flood_torch.py", "train_flood_torch")
quick = _load(ROOT / "examples" / "quickstart_torch.py", "quickstart_torch")
lm = _load(ROOT / "examples" / "train_lm_torch.py", "train_lm_torch")
serve_ex = _load(ROOT / "examples" / "serve_lm_torch.py", "serve_lm_torch")
ci = _load(ROOT / "scripts" / "ci_smoke_torch.py", "ci_smoke_torch")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# train_flood: the paper's driver
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["domst", "domst-singlehead"])
def test_train_stacked_matches_reference_example(name, monkeypatch):
    ref = _load(ROOT / "examples" / "train_flood.py", "ref_train_flood")

    class NoMeshEngine(JEngine):
        @classmethod
        def for_domst(cls, *a, **kw):
            return super().for_domst(*a, explicit_shardings=False, **kw)
    monkeypatch.setattr(ref, "Engine", NoMeshEngine)
    W, DAYS = 2, 150
    jwin = [j_windows(w) for w in j_all_watersheds(W, num_days=DAYS).values()]
    want, jsteps = ref.train_stacked(
        name, jwin, JPipeline([j_train_split(w) for w in jwin],
                              batch_size=64), 1)
    params = params_from_jax(_np(jdomst.init_stacked(
        j_get_config(name), jax.random.key(0), W)))
    win = [make_training_windows(w)
           for w in generate_all_watersheds(W, num_days=DAYS).values()]
    got, steps, losses = flood.train_stacked(
        name, win, InputPipeline([train_split(w) for w in win],
                                 batch_size=64), 1,
        device="cpu", params=params)
    assert steps == jsteps >= 1 and losses.shape == (steps, W)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL)


def test_train_flood_main_on_cpu(capsys):
    out = flood.main(["--watersheds", "2", "--days", "150", "--epochs", "1",
                      "--device", "cpu"])
    text = capsys.readouterr().out
    for name in ("domst", "domst-singlehead"):
        assert np.isfinite(out[name]["nse"]).all() and \
            len(out[name]["nse"]) == 2
    assert 0.0 <= out["win_share"] <= 1.0
    assert "watershed  1: Dom-ST NSE" in text and "beats Singlehead" in text


# ---------------------------------------------------------------------------
# quickstart: the seed-era step API
# ---------------------------------------------------------------------------
def test_quickstart_matches_reference_loop(capsys):
    steps = 5
    jcfg = j_get_config("domst")
    jtrain, jtest = j_split(j_windows(j_watershed(0, num_days=365),
                                      window=30))
    jparams = jdomst.init(jcfg, jax.random.key(0))
    tc = JTrainConfig(learning_rate=3e-3, total_steps=300, warmup_steps=10)
    jstep = jdomst.make_train_step(jcfg, tc)
    jopt = j_make_optimizer(tc)[0](jparams)
    rng = np.random.default_rng(0)
    n = len(jtrain["discharge"])
    want = []
    for _ in range(steps):
        sl = rng.integers(0, n, 64)
        batch = {k: jnp.asarray(v[sl]) for k, v in jtrain.items()}
        jparams, jopt, m = jstep(jparams, jopt, batch)
        want.append(float(m["loss"]))
    want_nse = float(jdomst.evaluate(jparams, jcfg, {
        k: jnp.asarray(v) for k, v in jtest.items()})["nse"])

    train, test = quick.data()
    params = {k: v[None] for k, v in params_from_jax(_np(
        jdomst.init(jcfg, jax.random.key(0)))).items()}
    _, losses, nse = quick.train_single(get_config("domst"), params, train,
                                        test, steps=steps, device="cpu")
    capsys.readouterr()
    np.testing.assert_allclose(losses, want, rtol=TOL)
    assert abs(nse - want_nse) <= TOL, (nse, want_nse)


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------
def test_train_lm_matches_reference_loop(capsys):
    arch, steps, batch, seq = "mamba2-130m", 3, 4, 32
    jcfg = j_smoke_variant(j_get_config(arch))
    jtree = _np(jtfm.init(jcfg, jax.random.key(0)))
    tc = JTrainConfig(learning_rate=6e-4, total_steps=steps,
                      warmup_steps=steps // 10, remat="block")
    jeng = JEngine(lambda p, b: jtfm.lm_loss(p, jcfg, b, dtype=jnp.float32,
                                             remat=True),
                   tc, cfg=jcfg, explicit_shardings=False)
    jstate = jeng.init_state(jax.random.key(0),
                             jax.tree.map(jnp.asarray, jtree))
    want = []
    for b in JLoader(JTokenSource(jcfg, batch, seq), jeng, prefetch=2,
                     num_steps=steps):
        jstate, m = jeng.step(jstate, b)
        want.append(float(m["loss"]))
    got = lm.train_lm(smoke_variant(get_config(arch)), params_from_jax(jtree),
                      steps=steps, batch=batch, seq=seq, device="cpu",
                      dtype=torch.float32)
    capsys.readouterr()
    np.testing.assert_allclose(got, want, rtol=TOL)


def test_mid_size_keeps_the_family():
    cfg = lm.mid_size(get_config("mamba2-130m"))
    assert (cfg.num_layers, cfg.vocab_size) == (6, 8192)
    assert cfg.d_model == get_config("mamba2-130m").d_model


# ---------------------------------------------------------------------------
# serve_lm
# ---------------------------------------------------------------------------
@pytest.fixture
def float32_both(monkeypatch):
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    monkeypatch.setattr(jserve, "InferenceEngine", lambda cfg, **kw:
                        JInferenceEngine(cfg, mesh=mesh, dtype=jnp.float32,
                                         **kw))
    real = tserve.InferenceEngine
    monkeypatch.setattr(tserve, "InferenceEngine", lambda *a, **kw: real(
        *a, **dict(kw, dtype=torch.float32)))


def _ref_args(ref_example, port_args):
    """The reference example's ``Args`` with the port's run's overrides,
    and the fields it lacks at the reference CLI's defaults."""
    a = ref_example.Args()
    for k, v in vars(port_args).items():
        if k != "device":
            setattr(a, k, v)
    defaults = vars(tserve.build_parser().parse_args(["--arch", a.arch]))
    return SimpleNamespace(**{k: getattr(a, k, v) for k, v in
                              defaults.items() if k != "device"})


@pytest.mark.parametrize("run,arch", [
    *(("families", a) for a in serve_ex.FAMILIES),
    *(("shared_prefix", a) for a in serve_ex.SHARED_PREFIX)])
def test_serve_lm_runs_match_reference(run, arch, float32_both, tmp_path,
                                       capsys):
    ref = _load(ROOT / "examples" / "serve_lm.py", "ref_serve_lm")
    path = str(tmp_path / "state.npz")
    jckpt.save(path, {"params": jtfm.init(j_smoke_variant(j_get_config(arch)),
                                          jax.random.key(7)),
                      "step": jnp.zeros((), jnp.int32)})
    make = {"families": serve_ex.family_args,
            "shared_prefix": serve_ex.shared_prefix_args}[run]
    a = make(arch, "cpu", path)
    want = jserve.serve(_ref_args(ref, a))
    got = tserve.serve(a)
    capsys.readouterr()
    assert got["stream_digest"] == want["stream_digest"]
    for key in ("tokens", "prefix_hits", "prefix_hit_tokens", "cow_pages",
                "preemptions", "spec_proposed", "spec_accepted",
                "prefill_chunks"):
        assert got[key] == want[key], (key, got[key], want[key])
    if run == "shared_prefix":
        assert got["prefix_hit_tokens"] > 0
    else:
        assert got["spec_proposed"] > 0 and got["prefill_chunks"] > 0


# ---------------------------------------------------------------------------
# ci_smoke_torch, in-process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cmd", ["prefix", "sampling", "host-tier", "obs"])
def test_ci_smoke_checks_in_process(cmd, tmp_path, capsys):
    argv = ["--device", "cpu", cmd]
    if cmd == "obs":
        argv += ["--out-dir", str(tmp_path / "obs")]
    got = ci.main(argv, run=ci.run_in_process)
    said = {"prefix": "prefix-cache parity ok", "sampling":
            "sampled serve reproducible", "host-tier": "host-tier parity ok",
            "obs": "obs smoke ok"}[cmd]
    assert said in capsys.readouterr().out
    assert got
