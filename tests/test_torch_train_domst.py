"""The port's Dom-ST training against the reference's, on the CPU.

Reference steps run with no mesh (``explicit_shardings=False``, or the
``domst.make_*_step`` makers without one): the reference's host mesh is
rejected by this jax. Params start from the reference's init, carried
across by ``params_from_jax``. Tolerances, fp32: gradients and every
stepped quantity (losses, params, both optimizer moments, over 5 steps)
``rtol=1e-4, atol=1e-6``; accumulation against one whole batch
``rtol=atol=1e-5``, as the reference's own test (the microbatch sums run
in another order). Checkpoints and resumed runs compare to the bit. The
pixel permutations are compared before any gradient, so a rank flip
shows as a flip.
"""
import json

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_variant as j_smoke_variant  # noqa: E402
from repro.core import domst as jdomst  # noqa: E402
from repro.core.partitioner import partition_pixels as j_partition  # noqa: E402
from repro.core.pixcon import pixcon_block as j_pixcon_block  # noqa: E402
from repro.optim import clip_by_global_norm as j_clip  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro.optim import make_schedule as j_make_schedule  # noqa: E402
from repro.train import Engine as JEngine  # noqa: E402
from repro_torch.configs import TrainConfig, get_config, smoke_variant  # noqa: E402
from repro_torch.convert import from_port_layout, params_from_jax  # noqa: E402
from repro_torch.core import domst  # noqa: E402
from repro_torch.core.partitioner import partition_pixels  # noqa: E402
from repro_torch.core.pixcon import pixcon_block  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import clip_by_global_norm, make_schedule  # noqa: E402
from repro_torch.train import Engine, accumulate_grads  # noqa: E402

torch.set_num_threads(1)
VARIANTS = ("domst", "domst-singlehead", "domst-singlehead-p")
TOL = dict(rtol=1e-4, atol=1e-6)
STEPS = 5


def _cfgs(name="domst", smoke=True):
    j, t = j_get_config(name), get_config(name)
    return (j_smoke_variant(j), smoke_variant(t)) if smoke else (j, t)


def _tc(**kw):
    kw = {"learning_rate": 1e-3, "total_steps": 10, "warmup_steps": 1, **kw}
    return JTrainConfig(**kw), TrainConfig(**kw)


def _batch(seed, dc, B=8):
    rng = np.random.default_rng(seed)
    T, P = dc.window_days, dc.num_pixels
    return {"precip": rng.gamma(0.8, 1.0, (B, T, P)).astype(np.float32),
            "dist": np.broadcast_to(rng.uniform(0, 1, P), (B, P)).astype(np.float32),
            "target_day": rng.gamma(0.8, 1.0, (B, P)).astype(np.float32),
            "discharge": rng.normal(0, 1, (B,)).astype(np.float32)}


def _stack(bs):
    return {k: np.stack([b[k] for b in bs]) for k in bs[0]}


def _port(tree, stacked):
    """A reference tree (params or a moment) in the port's layout, with the
    replica axis R=1 added in single mode."""
    p = params_from_jax(jax.tree.map(np.asarray, tree))
    return p if stacked else {k: v[None] for k, v in p.items()}


def _close(got, want, what, **tol):
    tol = tol or TOL
    assert got.keys() == want.keys(), what
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(),
                                   err_msg=f"{what} {k}", **tol)


# ---------------------------------------------------------------------------
# Gradients against jax.grad(domst.loss_fn)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", VARIANTS)
def test_gradients_match_reference(name):
    jcfg, cfg = _cfgs(name, smoke=False)
    jparams = jdomst.init(jcfg, jax.random.key(4))
    b = _batch(5, cfg.domst, B=4)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v)[None] for k, v in b.items()}
    params = _port(jparams, stacked=False)
    dc = cfg.domst
    if dc.use_pixcon:                    # the permutation first
        jx, jw = j_pixcon_block(jparams["pixcon"], jcfg.domst.pixcon,
                                jb["precip"], jb["dist"], jb["target_day"])
        _, jorder = j_partition(jx, jw, dc.num_heads)
        x, w = pixcon_block(domst.subtree(params, "pixcon"), dc.pixcon,
                            tb["precip"], tb["dist"], tb["target_day"])
        _, order = partition_pixels(x, w, dc.num_heads)
        np.testing.assert_array_equal(order[0].numpy(), np.asarray(jorder))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, x: jdomst.loss_fn(p, jcfg, x), has_aux=True))(jparams, jb)
    grads, loss, _ = accumulate_grads(
        lambda p, x: domst.loss_fn(p, cfg, x), params, tb, 1)
    np.testing.assert_allclose(loss.numpy()[0], float(jloss), **TOL)
    _close(grads, _port(jgrads, stacked=False), f"{name} grad")
    assert all(bool(g.abs().max() > 0) for g in grads.values())


# ---------------------------------------------------------------------------
# Steps: single mode against make_train_step, stacked against the seed step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_single_steps_match_reference(optimizer):
    jcfg, cfg = _cfgs()
    jtc, tc = _tc(optimizer=optimizer)
    jparams = jdomst.init(jcfg, jax.random.key(6))
    jopt = j_make_optimizer(jtc)[0](jparams)
    jstep = jdomst.make_train_step(jcfg, jtc)
    eng = Engine.for_domst(cfg, tc, device="cpu")
    state = eng.init_state(_port(jparams, stacked=False))
    for i in range(STEPS):
        b = _batch(100 + i, cfg.domst)
        jparams, jopt, jm = jstep(jparams, jopt, b)
        state, m = eng.step(state, eng.place_batch(b))
        assert m["loss"].shape == ()
        np.testing.assert_allclose(m["loss"].numpy(), float(jm["loss"]), **TOL)
        np.testing.assert_allclose(m["grad_norm"].numpy(),
                                   float(jm["grad_norm"]), **TOL)
    _close(state.params, _port(jparams, False), "params")
    _close(state.opt_state.mu, _port(jopt.mu, False), "mu")
    if optimizer == "adamw":
        _close(state.opt_state.nu, _port(jopt.nu, False), "nu")
    else:
        assert state.opt_state.nu == {} and jopt.nu == ()
    assert int(state.step) == STEPS and state.opt_state.step.tolist() == [STEPS]


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_stacked_steps_match_reference(optimizer):
    jcfg, cfg = _cfgs()
    jtc, tc = _tc(optimizer=optimizer)
    R = 3
    jparams = jdomst.init_stacked(jcfg, jax.random.key(7), R)
    jopt = jax.vmap(j_make_optimizer(jtc)[0])(jparams)
    jstep = jdomst.make_reference_stacked_step(jcfg, jtc)
    eng = Engine.for_domst(cfg, tc, stacked=True, device="cpu")
    state = eng.init_state(_port(jparams, stacked=True))
    assert state.rng.shape == (R, 2) and state.rng.dtype == torch.uint32
    for i in range(STEPS):
        b = _stack([_batch(200 + 10 * i + r, cfg.domst) for r in range(R)])
        jparams, jopt, jm = jstep(jparams, jopt, b)
        state, m = eng.step(state, eng.place_batch(b))
        assert m["loss"].shape == (R,)
        for k in ("loss", "grad_norm", "lr", "mae"):
            np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), **TOL)
    _close(state.params, _port(jparams, True), "params")
    _close(state.opt_state.mu, _port(jopt.mu, True), "mu")
    if optimizer == "adamw":
        _close(state.opt_state.nu, _port(jopt.nu, True), "nu")
    np.testing.assert_array_equal(state.opt_state.step.numpy(),
                                  np.asarray(jopt.step))


def test_stacked_step_isolates_watersheds():
    """Replica w's params depend only on watershed w's data."""
    _, cfg = _cfgs()
    _, tc = _tc()
    # both steps start from ``params``: a donating engine would update them
    eng = Engine.for_domst(cfg, tc, stacked=True, donate=False, device="cpu")
    params = domst.init(cfg, torch.Generator().manual_seed(0), 2)
    one = _batch(8, cfg.domst)
    b1 = eng.place_batch(_stack([one, one]))
    b2 = {k: v.clone() for k, v in b1.items()}
    for v in b2.values():
        v[1] += 1.0
    p1 = eng.step(eng.init_state(params), b1)[0].params
    p2 = eng.step(eng.init_state(params), b2)[0].params
    d0 = sum(float((p1[k][0] - p2[k][0]).abs().sum()) for k in p1)
    d1 = sum(float((p1[k][1] - p2[k][1]).abs().sum()) for k in p1)
    assert d0 == 0.0 and d1 > 0.0


# ---------------------------------------------------------------------------
# Gradient accumulation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stacked", [False, True])
def test_accumulation_matches_one_batch_and_reference(stacked):
    """accum_steps=4 gives the update of one whole batch (SGD, so Adam's
    normalisation does not magnify the sums' rounding), and the reference
    engine's accum_steps=4 update. The clip is off, so that a gradient
    scaled as a whole would show: after one step the momentum buffer is the
    averaged gradient itself, and ``grad_norm`` its norm."""
    jcfg, cfg = _cfgs()
    jtc, tc = _tc(optimizer="sgd", learning_rate=1e-2, grad_clip=0.0)
    R = 2 if stacked else 1
    key = jax.random.key(9)
    jparams = (jdomst.init_stacked(jcfg, key, R) if stacked
               else jdomst.init(jcfg, key))
    b = _stack([_batch(300 + r, cfg.domst) for r in range(R)]) if stacked \
        else _batch(300, cfg.domst)
    out = {}
    for A in (1, 4):
        eng = Engine.for_domst(cfg, tc, stacked=stacked, accum_steps=A,
                               device="cpu")
        state, m = eng.step(eng.init_state(_port(jparams, stacked)),
                            eng.place_batch(b))
        out[A] = (state.params, state.opt_state.mu, m)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(out[4][2][k].numpy(), out[1][2][k].numpy(),
                                   rtol=2e-5, err_msg=k)
    _close(out[4][0], out[1][0], "accum 4 vs 1", rtol=1e-5, atol=1e-5)
    _close(out[4][1], out[1][1], "accum 4 vs 1, gradient", rtol=1e-5,
           atol=1e-5)
    jeng = JEngine.for_domst(jcfg, jtc, stacked=stacked, accum_steps=4,
                             explicit_shardings=False)
    jstate, jm = jeng.step(jeng.init_state(jax.random.key(0), jparams), b)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(out[4][2][k].numpy(), np.asarray(jm[k]),
                                   err_msg=k, **TOL)
    _close(out[4][0], _port(jstate.params, stacked), "accum 4 vs reference")
    _close(out[4][1], _port(jstate.opt_state.mu, stacked),
           "accum 4 vs reference, gradient")


def test_accumulation_requires_a_divisible_minibatch():
    _, cfg = _cfgs()
    eng = Engine.for_domst(cfg, TrainConfig(), accum_steps=3, device="cpu")
    state = eng.init_state(domst.init(cfg, torch.Generator().manual_seed(0), 1))
    with pytest.raises(ValueError, match="minibatch dim 8 not divisible by "
                                         "accum_steps=3"):
        eng.step(state, eng.place_batch(_batch(0, cfg.domst)))


# ---------------------------------------------------------------------------
# Optimizer pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup,total", [(0, 10), (1, 10), (4, 9), (50, 40)])
def test_schedules_match_reference(schedule, warmup, total):
    jtc, tc = _tc(schedule=schedule, warmup_steps=warmup, total_steps=total,
                  learning_rate=3e-3)
    steps = np.arange(0, total + 8, dtype=np.int32)
    want = np.asarray(jax.jit(j_make_schedule(jtc))(jnp.asarray(steps)))
    got = make_schedule(tc)(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_is_per_replica(max_norm):
    """The reference vmaps the update, so each replica is clipped by its
    own norm; one replica's gradients are scaled up to be clipped."""
    jcfg, cfg = _cfgs()
    R = 3
    jg = jdomst.init_stacked(jcfg, jax.random.key(11), R)
    jg = jax.tree.map(lambda x: x * jnp.asarray([1.0, 30.0, 0.01]).reshape(
        (R,) + (1,) * (x.ndim - 1)), jg)
    jclipped, jnorm = jax.vmap(lambda g: j_clip(g, max_norm))(jg)
    clipped, norm = clip_by_global_norm(_port(jg, True), max_norm)
    np.testing.assert_allclose(norm.numpy(), np.asarray(jnorm), rtol=1e-6)
    _close(clipped, _port(jclipped, True), "clipped", rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# Checkpoints, both ways, and resumed runs
# ---------------------------------------------------------------------------
def _stacked_run(jcfg, jtc, R=3):
    jeng = JEngine.for_domst(jcfg, jtc, stacked=True, explicit_shardings=False)
    jstate = jeng.init_state(jax.random.key(12),
                             jdomst.init_stacked(jcfg, jax.random.key(12), R))
    return jeng, jstate


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_port_checkpoint_restores_in_reference(tmp_path, optimizer):
    jcfg, cfg = _cfgs()
    jtc, tc = _tc(optimizer=optimizer)
    jeng, jexample = _stacked_run(jcfg, jtc)
    eng = Engine.for_domst(cfg, tc, stacked=True, device="cpu")
    state = eng.init_state(_port(jexample.params, True))
    for i in range(2):
        b = _stack([_batch(400 + 10 * i + r, cfg.domst) for r in range(3)])
        state = eng.step(state, eng.place_batch(b))[0]
    path = str(tmp_path / "port.npz")
    eng.save(path, state)
    with np.load(path) as data:
        n = len(data.files)
    assert n == (57 if optimizer == "adamw" else 39)
    back = jeng.restore(path, jexample)
    _close(state.params, _port(back.params, True), "params", rtol=0, atol=0)
    _close(state.opt_state.mu, _port(back.opt_state.mu, True), "mu",
           rtol=0, atol=0)
    if optimizer == "adamw":
        _close(state.opt_state.nu, _port(back.opt_state.nu, True), "nu",
               rtol=0, atol=0)
    assert int(back.step) == 2
    np.testing.assert_array_equal(np.asarray(back.opt_state.step), [2, 2, 2])
    np.testing.assert_array_equal(np.asarray(back.rng), state.rng.numpy())


@pytest.mark.parametrize("stacked", [False, True])
def test_reference_checkpoint_restores_in_port(tmp_path, stacked):
    jcfg, cfg = _cfgs()
    jtc, tc = _tc()
    if stacked:
        jeng, jstate = _stacked_run(jcfg, jtc)
        b = _stack([_batch(500 + r, cfg.domst) for r in range(3)])
    else:
        jeng = JEngine.for_domst(jcfg, jtc, explicit_shardings=False)
        jstate = jeng.init_state(jax.random.key(13),
                                 jdomst.init(jcfg, jax.random.key(13)))
        b = _batch(500, cfg.domst)
    jstate, _ = jeng.step(jstate, b)
    path = str(tmp_path / "ref.npz")
    jeng.save(path, jstate)
    eng = Engine.for_domst(cfg, tc, stacked=stacked, device="cpu")
    R = 3 if stacked else 1
    example = eng.init_state(domst.init(cfg, torch.Generator().manual_seed(0), R))
    state = eng.restore(path, example)
    _close(state.params, _port(jstate.params, stacked), "params", rtol=0, atol=0)
    _close(state.opt_state.mu, _port(jstate.opt_state.mu, stacked), "mu",
           rtol=0, atol=0)
    _close(state.opt_state.nu, _port(jstate.opt_state.nu, stacked), "nu",
           rtol=0, atol=0)
    assert int(state.step) == 1 and state.opt_state.step.tolist() == [1] * R
    np.testing.assert_array_equal(state.rng.numpy(), np.asarray(jstate.rng))
    # a single-mode save writes the reference's unstacked layout back
    if not stacked:
        out = str(tmp_path / "again.npz")
        eng.save(out, state)
        with np.load(path) as a, np.load(out) as c:
            assert sorted(a.files) == sorted(c.files)
            for k in a.files:
                assert a[k].shape == c[k].shape and a[k].dtype == c[k].dtype, k
                np.testing.assert_array_equal(a[k], c[k], err_msg=k)


def test_from_port_layout_inverts_to_port_layout():
    from repro_torch.convert import to_port_layout
    rng = np.random.default_rng(0)
    for key, shape in [("pixcon/w2", (3, 8, 1)), ("temporal/lstm1/wx", (16, 64)),
                       ("temporal/lstm0/b", (2, 64)), ("spatial/conv_w", (2, 3, 8, 8))]:
        a = rng.normal(size=shape).astype(np.float32)
        np.testing.assert_array_equal(from_port_layout(key, to_port_layout(key, a)), a)


@pytest.mark.parametrize("accum", [1, 2])
def test_resumed_run_equals_uninterrupted_run(tmp_path, accum):
    """2N steps equal N steps, a save, a restore into a fresh state and N
    more, to the bit (the loader cursor resumes at the restored step)."""
    from repro_torch.data.loader import ShardedLoader
    from repro_torch.data.pipeline import (
        InputPipeline, StackedSource, make_domst_windows, train_split)
    _, cfg = _cfgs()
    _, tc = _tc()
    W, N = 2, 3
    windows = [_cut(w, cfg) for w in make_domst_windows(W, 120)]
    ip = InputPipeline([train_split(w) for w in windows], batch_size=8, seed=1)
    source = StackedSource(ip)
    eng = Engine.for_domst(cfg, tc, stacked=True, accum_steps=accum, device="cpu")

    def fresh():
        return eng.init_state(domst.init(cfg, torch.Generator().manual_seed(5), W))

    def run(state, start, n):
        loader = ShardedLoader(source, eng, prefetch=2, start_step=start,
                               num_steps=n)
        for batch in loader:
            state = eng.step(state, batch)[0]
        assert loader.cursor == start + n == int(state.step)
        return state

    whole = run(fresh(), 0, 2 * N)
    path = str(tmp_path / "half.npz")
    eng.save(path, run(fresh(), 0, N))
    resumed = eng.restore(path, fresh())
    resumed = run(resumed, int(resumed.step), N)
    for part in ("params", "mu", "nu"):
        a = whole.params if part == "params" else getattr(whole.opt_state, part)
        b = resumed.params if part == "params" else getattr(resumed.opt_state, part)
        for k in a:
            assert torch.equal(a[k], b[k]), (part, k)
    assert torch.equal(whole.opt_state.step, resumed.opt_state.step)


def _cut(w, cfg):
    """A watershed's windows cut to the smoke variant's pixels and days."""
    import dataclasses
    T, P = cfg.domst.window_days, cfg.domst.num_pixels
    return dataclasses.replace(w, precip=w.precip[:, -T:, :P].copy(),
                               target_day=w.target_day[:, :P].copy(),
                               dist=w.dist[:P].copy())


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------
def test_train_cli_trains_and_hands_off_to_serve(tmp_path, capsys):
    ckpt = str(tmp_path / "run.npz")
    metrics = str(tmp_path / "metrics.jsonl")
    res = ttrain.main(["--arch", "domst", "--watersheds", "2", "--days", "150",
                       "--epochs", "1", "--device", "cpu", "--ckpt", ckpt,
                       "--eval-interval", "1", "--metrics-out", metrics])
    out = capsys.readouterr().out
    assert "epoch 0 mean loss" in out and "step 1 eval mean NSE" in out
    assert len(res["nse"]) == 2 and np.isfinite(res["nse"]).all()
    assert res["device"] == "cpu" and res["step_p50_s"] > 0
    assert {"loader_wait_p99_s", "loader_wait_s", "wall_s"} <= res.keys()
    names = {json.loads(line)["name"] for line in open(metrics)}
    assert {"train.step_s", "loader.wait_s", "train.loss"} <= names
    served = tserve.main(["--arch", "domst", "--watersheds", "2", "--days",
                          "150", "--device", "cpu", "--ckpt", ckpt])
    assert served["restored"]
    np.testing.assert_allclose(served["nse"], res["nse"], atol=1e-4)


def test_train_cli_sequential_mode_and_its_refusals(capsys):
    res = ttrain.main(["--arch", "domst", "--watersheds", "2", "--days", "120",
                       "--epochs", "1", "--mode", "sequential", "--device",
                       "cpu", "--prefetch", "0"])
    out = capsys.readouterr().out
    assert out.count("watershed ") == 2 and np.isfinite(res["nse"]).all()
    with pytest.raises(SystemExit, match="not supported with --mode sequential"):
        ttrain.main(["--arch", "domst", "--mode", "sequential", "--device",
                     "cpu", "--ckpt", "x.npz"])
    # the LM mode: the audio encoder and a decoder each train a step
    enc = ttrain.main(["--arch", "hubert-xlarge", "--smoke", "--steps", "1",
                       "--batch-size", "2", "--seq-len", "8", "--device",
                       "cpu"])
    assert enc["steps"] == 1 and np.isfinite(enc["first_loss"])
    lm = ttrain.main(["--arch", "qwen2-1.5b", "--smoke", "--steps", "1",
                      "--batch-size", "2", "--seq-len", "8", "--device",
                      "cpu"])
    assert lm["steps"] == 1 and np.isfinite(lm["first_loss"])


def test_train_cli_resume_continues_the_run(tmp_path, capsys):
    """One epoch, a checkpoint, ``--resume`` for one more: the same state as
    two epochs straight (the loader resumes at the restored step; within
    the warmup the extended schedule horizon changes no learning rate)."""
    base = ["--arch", "domst", "--watersheds", "2", "--days", "150",
            "--device", "cpu", "--seed", "3"]
    whole, half, again = (str(tmp_path / f"{n}.npz")
                          for n in ("whole", "half", "again"))
    ttrain.main(base + ["--epochs", "2", "--ckpt", whole])
    ttrain.main(base + ["--epochs", "1", "--ckpt", half])
    ttrain.main(base + ["--epochs", "1", "--resume", half, "--ckpt", again])
    capsys.readouterr()
    with np.load(whole) as a, np.load(again) as b:
        assert sorted(a.files) == sorted(b.files)
        assert int(a["step"]) == int(b["step"]) == 6
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
