"""The port's LM training against the reference's, on the CPU, at smoke
size (``smoke_variant``: 2 layers, d_model <= 256, vocab 512; the
recurrent, local and SSM archs' one (R, L), (L, G) and (S, S) patterns).

Params come from the reference's ``init``, the attention projections
rescaled to std 1/sqrt(fan-in) (``_jparams``), and are carried across by
``params_from_jax``; token batches from each package's
``synthetic_token_batch``, which are held equal to the bit. Sequences of
40 tokens run past the smoke window of 16 and span five SSD chunks of 8;
a loss chunk of 16 splits them unevenly.

* ``lm_loss`` and every gradient leaf against ``jax.value_and_grad`` of
  the reference's ``lm_loss``, float32, with block remat on both sides
  (and once without, with a ``loss_mask``): the loss within 1e-5
  relative, each leaf within 1e-4 of its largest |grad| (sums taken in
  another order). Every LM config the port serves: qwen2-1.5b (blockq
  GQA with biases), gemma2-2b (both softcaps, local and global,
  post-norms) and its local-only variant, llama3.2-3b, olmo-1b (a norm
  without parameters), recurrentgemma-2b, mamba2-130m, qwen3-moe-30b-a3b
  and deepseek-moe-16b (the aux term, at the default capacity, where
  tokens are dropped). One bf16 case
  (qwen2-1.5b): the loss within 1e-2 relative, each leaf within 5e-2 of
  its scale (bf16 keeps 8 bits; both sides round through it, in another
  order).
* three AdamW steps of ``Engine.for_lm`` against the reference's
  ``Engine`` (no mesh, ``explicit_shardings=False``: the reference's host
  mesh is rejected by this jax; a float32 ``lm_loss`` with remat), with
  accumulation 1 and 2: losses, gradient norms and learning rates within
  1e-5 relative, each leaf of the params and of both moments within
  1e-4 of its largest |value|, at AdamW eps 1e-4. At the default eps
  1e-8, which the CLI runs, the update of an element whose gradient sits
  at the rounding floor is the sign of that rounding: the metrics and
  both moments are held as at 1e-4 (within 2.8e-5 measured), the params
  within 5e-4 of their scale (1.2e-4 measured) and qwen2's key biases,
  whose gradient is zero but for rounding, within 3e-2 (1.5e-2
  measured).
* checkpoints both ways, leaves bit-equal; a resumed run equal to an
  uninterrupted one to the bit; the CLI with ``--smoke --device cpu``
  and its checkpoint restored by the serve CLI; ``from_train_state``
  serving the same greedy stream as an engine built from the checkpoint.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_variant as j_smoke_variant  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.train import Engine as JEngine  # noqa: E402
from repro_torch.configs import TrainConfig, get_config, smoke_variant  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    flatten, lm_params_to_jax, params_from_jax, unflatten,
)
from repro_torch.data import tokens  # noqa: E402
from repro_torch.data.loader import ShardedLoader  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serve import InferenceEngine, ModelDrafter, Request, Scheduler  # noqa: E402
from repro_torch.train import Engine  # noqa: E402

torch.set_num_threads(1)
ARCHS = ["qwen2-1.5b", "gemma2-2b", "gemma2-2b-localonly", "llama3.2-3b",
         "olmo-1b", "recurrentgemma-2b", "mamba2-130m", "qwen3-moe-30b-a3b",
         "deepseek-moe-16b"]
B, S, LOSS_CHUNK = 2, 40, 16
LOSS_REL, GRAD_REL = 1e-5, 1e-4
BF16_LOSS_REL, BF16_GRAD_REL = 1e-2, 5e-2
STEP_REL = 1e-4
EPS8_PARAM_REL, EPS8_BK_REL = 5e-4, 3e-2


def _cfgs(arch):
    return (j_smoke_variant(j_get_config(arch)),
            smoke_variant(get_config(arch)))


def _jparams(jcfg, seed=0):
    """The reference's init, with the attention projections rescaled to
    std 1/sqrt(fan-in): its law (std 1/sqrt(shape[-2]), so 1/sqrt(Hq) for
    ``wq`` (d, Hq, D)) gives scores in the hundreds at these widths, where
    two correct float32 runs part by ~1e-3 of a gradient's scale (qwen2:
    the port 4.8e-4 and the reference 1.7e-3 from a float64 run)."""
    tree = jax.tree.map(np.asarray, jtfm.init(jcfg, jax.random.key(seed)))

    def rescale(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("wq", "wk", "wv"):        # (..., d, H, D): fan-in d
            return a * np.float32(np.sqrt(a.shape[-2] / a.shape[-3]))
        if name == "wo":                      # (..., Hq, D, d): fan-in Hq*D
            return a / np.float32(np.sqrt(a.shape[-3]))
        return a
    return jax.tree_util.tree_map_with_path(rescale, tree)


def _batch(cfg, seed=1, mask=False, b=B, s=S):
    out = tokens.synthetic_token_batch(cfg, b, s, seed=seed)
    if mask:
        rng = np.random.default_rng(seed)
        out["loss_mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return out


def _ref_loss_and_grads(jcfg, jtree, batch, dtype, remat):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def f(p):
        return jtfm.lm_loss(p, jcfg, jb, dtype=dtype, remat=remat,
                            loss_chunk=LOSS_CHUNK)
    (loss, mets), g = jax.value_and_grad(f, has_aux=True)(jtree)
    return float(loss), {k: float(v) for k, v in mets.items()}, \
        jax.tree.map(np.asarray, g)


def _port_loss_and_grads(cfg, jtree, batch, dtype, remat):
    tree = params_from_jax(jtree)
    leaves = flatten(tree)
    for v in leaves.values():
        v.requires_grad_()
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    loss, mets = tfm.lm_loss(tree, cfg, tb, dtype=dtype, remat=remat,
                             loss_chunk=LOSS_CHUNK)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    gtree = unflatten(dict(zip(leaves, grads)),
                      tfm.model_params(cfg, lambda *a: None))
    return float(loss.detach()), \
        {k: float(v.detach()) for k, v in mets.items()}, \
        lm_params_to_jax(gtree, cfg)


def _leaf_errors(got, want, rel):
    """Every leaf of ``want`` (the reference's layout) against ``got``:
    the same keys, each within ``rel`` of the leaf's largest |value|."""
    g, w = flatten(got), flatten(want)
    assert sorted(g) == sorted(w)
    for k, a in w.items():
        a = np.asarray(a, np.float32)
        scale = float(np.abs(a).max())
        assert scale > 0, f"{k}: no gradient in the reference"
        err = float(np.abs(np.asarray(g[k], np.float32) - a).max())
        assert err <= rel * scale, (k, err, scale)


# ---------------------------------------------------------------------------
# Tokens
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-2b", "mamba2-130m"])
def test_token_batches_bit_equal(arch):
    jcfg, cfg = _cfgs(arch)
    for smoke in (True, False):
        j = jcfg if smoke else j_get_config(arch)
        t = cfg if smoke else get_config(arch)
        for seed in (0, 7, 2**31 + 3):
            a = jtokens.synthetic_token_batch(j, 3, 17, seed=seed)
            b = tokens.synthetic_token_batch(t, 3, 17, seed=seed)
            assert sorted(a) == sorted(b) == ["targets", "tokens"]
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])
    js = jtokens.TokenSource(jcfg, 2, 9, seed=5)
    ts = tokens.TokenSource(cfg, 2, 9, seed=5)
    assert ts.steps_per_epoch is None
    for step in (0, 1, 13):
        for k, v in js.host_batch(step).items():
            np.testing.assert_array_equal(ts.host_batch(step)[k], v)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-2b"])
def test_front_end_batches_raise(arch):
    """The front ends' batches, once refused, now drawn as the
    reference's to the bit: frames, unit targets and the 8% loss mask;
    patches before the text's token pairs."""
    jcfg, cfg = _cfgs(arch)
    for seed in (0, 11):
        a = jtokens.synthetic_token_batch(jcfg, 2, 20, seed=seed)
        b = tokens.synthetic_token_batch(cfg, 2, 20, seed=seed)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# The loss and its gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch):
    jcfg, cfg = _cfgs(arch)
    jtree = _jparams(jcfg)
    batch = _batch(cfg)
    jl, jm, jg = _ref_loss_and_grads(jcfg, jtree, batch, jnp.float32, True)
    tl, tm, tg = _port_loss_and_grads(cfg, jtree, batch, torch.float32, True)
    assert abs(tl - jl) <= LOSS_REL * abs(jl), (tl, jl)
    assert abs(tm["ce"] - jm["ce"]) <= LOSS_REL * abs(jm["ce"])
    if cfg.moe is not None:
        assert jm["aux"] > 0
        assert abs(tm["aux"] - jm["aux"]) <= LOSS_REL * jm["aux"]
    else:
        assert tm["aux"] == jm["aux"] == 0.0
    _leaf_errors(tg, jg, GRAD_REL)


def test_lm_loss_with_a_mask_and_no_remat():
    jcfg, cfg = _cfgs("gemma2-2b")
    jtree = _jparams(jcfg, seed=3)
    batch = _batch(cfg, seed=4, mask=True)
    jl, _, jg = _ref_loss_and_grads(jcfg, jtree, batch, jnp.float32, False)
    tl, _, tg = _port_loss_and_grads(cfg, jtree, batch, torch.float32, False)
    assert abs(tl - jl) <= LOSS_REL * abs(jl), (tl, jl)
    _leaf_errors(tg, jg, GRAD_REL)


def test_lm_loss_bf16():
    jcfg, cfg = _cfgs("qwen2-1.5b")
    jtree = _jparams(jcfg)
    batch = _batch(cfg)
    jl, _, jg = _ref_loss_and_grads(jcfg, jtree, batch, jnp.bfloat16, True)
    tl, _, tg = _port_loss_and_grads(cfg, jtree, batch, torch.bfloat16, True)
    assert abs(tl - jl) <= BF16_LOSS_REL * abs(jl), (tl, jl)
    _leaf_errors(tg, jg, BF16_GRAD_REL)


def test_remat_changes_nothing_but_memory():
    """Block remat and the loss chunks recompute the same values: the
    loss and every gradient equal to the bit with and without."""
    _, cfg = _cfgs("recurrentgemma-2b")
    cfg = cfg.replace(num_layers=5)            # (R, L) x 2, then an R suffix
    params = tfm.init(cfg, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    out = []
    for remat in (False, True):
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in flatten(params).items()}
        tree = unflatten(leaves, tfm.model_params(cfg, lambda *a: None))
        loss, _ = tfm.lm_loss(tree, cfg, batch, dtype=torch.float32,
                              remat=remat, loss_chunk=LOSS_CHUNK)
        out.append((loss, torch.autograd.grad(loss, list(leaves.values()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_training_attention_splits_as_the_reference():
    """A global layer trains through ``blockq_attention`` and prefills
    through ``flash_attention``; both agree with the reference's."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as attn
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 37, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 37, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 37, 2, 16)).astype(np.float32)
    for causal, cap in ((True, 0.0), (True, 5.0), (False, 0.0)):
        want = jattn.blockq_attention(q, k, v, causal=causal,
                                      softcap_val=cap, block_q=16)
        got = attn.blockq_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=causal, softcap_val=cap,
                                    block_q=16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
def _tcs(**kw):
    kw = {"learning_rate": 1e-3, "total_steps": 10, "warmup_steps": 2,
          "remat": "block", **kw}
    return JTrainConfig(**kw), TrainConfig(**kw)


def _ref_engine(jcfg, jtc, accum):
    return JEngine(lambda p, b: jtfm.lm_loss(p, jcfg, b, dtype=jnp.float32,
                                             remat=True),
                   jtc, cfg=jcfg, accum_steps=accum,
                   explicit_shardings=False)


def _state_ref_layout(eng, tree_flat, cfg):
    return lm_params_to_jax(unflatten({k: v[0] for k, v in tree_flat.items()},
                                      tfm.model_params(cfg, lambda *a: None)),
                            cfg)


ENGINE_CASES = [("qwen2-1.5b", 1), ("qwen2-1.5b", 2), ("mamba2-130m", 2),
                ("qwen3-moe-30b-a3b", 1)]


def _engine_steps(arch, accum, steps=3, cfgs=None, **tc_kw):
    """``steps`` steps of the reference's engine and the port's on the
    same batches (``cfgs``: the two configs, if not ``_cfgs(arch)``), the
    step metrics held within LOSS_REL; returns (the port's params, mu, nu
    in the reference's layout, and the reference's)."""
    jcfg, cfg = cfgs or _cfgs(arch)
    jtc, tc = _tcs(**tc_kw)
    jtree = _jparams(jcfg)
    jeng = _ref_engine(jcfg, jtc, accum)
    jstate = jeng.init_state(jax.random.key(0), jax.tree.map(jnp.asarray,
                                                             jtree))
    eng = Engine.for_lm(cfg, tc, accum_steps=accum, device="cpu",
                        dtype=torch.float32)
    state = eng.init_state(params_from_jax(jtree))
    for step in range(steps):
        host = _batch(cfg, seed=step, b=4, s=24)
        jstate, jm = jeng.step(jstate, jeng.place_batch(host))
        state, m = eng.step(state, eng.place_batch(host))
        assert m["loss"].shape == ()
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert abs(float(m[k]) - float(jm[k])) <= \
                LOSS_REL * abs(float(jm[k])), (step, k, m[k], jm[k])
    assert int(state.step) == int(jstate.step) == steps
    assert int(state.opt_state.step[0]) == int(jstate.opt_state.step) == steps
    return [(_state_ref_layout(eng, got, cfg), jax.tree.map(np.asarray, want))
            for got, want in ((state.params, jstate.params),
                              (state.opt_state.mu, jstate.opt_state.mu),
                              (state.opt_state.nu, jstate.opt_state.nu))]


@pytest.mark.parametrize("arch,accum", ENGINE_CASES)
def test_engine_steps_match_reference(arch, accum):
    # eps 1e-4: AdamW's update of an element whose gradient is at the
    # rounding floor (|g| << eps 1e-8's scale) is the sign of its rounding
    for got, want in _engine_steps(arch, accum, eps=1e-4):
        _leaf_errors(got, want, STEP_REL)


@pytest.mark.parametrize("arch,accum", ENGINE_CASES)
def test_engine_steps_match_reference_at_default_eps(arch, accum):
    """The shipped eps 1e-8: the step metrics and both moments as at eps
    1e-4; the params within EPS8_PARAM_REL of their scale, and the key
    biases within EPS8_BK_REL. A key bias adds q.bk to every score of a
    query, which the softmax cancels, so its gradient is zero but for
    rounding, and at eps 1e-8 its update is the sign of that rounding."""
    (p, jp), (mu, jmu), (nu, jnu) = _engine_steps(arch, accum)
    _leaf_errors(mu, jmu, STEP_REL)
    _leaf_errors(nu, jnu, STEP_REL)
    p, jp = flatten(p), flatten(jp)
    for bk, rel in ((False, EPS8_PARAM_REL), (True, EPS8_BK_REL)):
        keys = [k for k in jp if k.endswith("attn/bk") == bk]
        _leaf_errors({k: p[k] for k in keys}, {k: jp[k] for k in keys}, rel)


def test_donated_step_equals_the_undonated_one():
    """``donate`` updates the state's tensors in place, to the same bits
    as ``donate=False``, which leaves the old state as it was."""
    _, cfg = _cfgs("recurrentgemma-2b")
    _, tc = _tcs(weight_decay=0.1)
    params = tfm.init(cfg, torch.Generator().manual_seed(0))
    keep = Engine.for_lm(cfg, tc, donate=False, device="cpu")
    give = Engine.for_lm(cfg, tc, accum_steps=1, device="cpu")
    s_keep = keep.init_state({k: v for k, v in params.items()})
    before = {k: v.clone() for k, v in s_keep.params.items()}
    s_give = give.init_state(unflatten(
        {k: v.clone() for k, v in flatten(params).items()},
        tfm.model_params(cfg, lambda *a: None)))
    batch = keep.place_batch(_batch(cfg))
    n_keep, _ = keep.step(s_keep, batch)
    ptrs = {k: v.data_ptr() for k, v in s_give.params.items()}
    n_give, _ = give.step(s_give, batch)
    for k, v in s_keep.params.items():
        assert torch.equal(v, before[k])
        assert torch.equal(n_keep.params[k], n_give.params[k])
        assert n_give.params[k].data_ptr() == ptrs[k]
        assert torch.equal(n_keep.opt_state.mu[k], n_give.opt_state.mu[k])
        assert torch.equal(n_keep.opt_state.nu[k], n_give.opt_state.nu[k])


def test_place_batch_keeps_tokens_integer():
    _, cfg = _cfgs("qwen2-1.5b")
    eng = Engine.for_lm(cfg, TrainConfig(), device="cpu")
    b = eng.place_batch(_batch(cfg, mask=True))
    assert b["tokens"].dtype == b["targets"].dtype == torch.int32
    assert b["loss_mask"].dtype == torch.float32
    assert b["tokens"].shape == (1, B, S)
    ev = eng.eval_step(eng.init_state(tfm.init(
        cfg, torch.Generator().manual_seed(0))), b)
    assert ev["loss"].shape == () and torch.isfinite(ev["loss"])


# ---------------------------------------------------------------------------
# Checkpoints, resume, the command line and the hand-off to serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "deepseek-moe-16b"])
def test_checkpoint_crosses_packages(tmp_path, arch):
    jcfg, cfg = _cfgs(arch)
    jtc, tc = _tcs()
    jtree = _jparams(jcfg)
    eng = Engine.for_lm(cfg, tc, device="cpu", dtype=torch.float32)
    state = eng.init_state(params_from_jax(jtree))
    state, _ = eng.step(state, eng.place_batch(_batch(cfg)))
    # port -> reference
    path = str(tmp_path / "port.npz")
    eng.save(path, state)
    jeng = _ref_engine(jcfg, jtc, 1)
    jex = jeng.init_state(jax.random.key(0), jax.tree.map(jnp.asarray, jtree))
    back = jckpt.restore(path, jex)
    assert int(back.step) == 1 and int(back.opt_state.step) == 1
    for got, mine in ((back.params, state.params),
                      (back.opt_state.mu, state.opt_state.mu),
                      (back.opt_state.nu, state.opt_state.nu)):
        w = flatten(_state_ref_layout(eng, mine, cfg))
        g = flatten(jax.tree.map(np.asarray, got))
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # reference -> port
    jstate, _ = jeng.step(jex, jeng.place_batch(_batch(cfg, seed=5)))
    jpath = str(tmp_path / "ref.npz")
    jeng.save(jpath, jstate)
    ex = eng.init_state(tfm.init(cfg, torch.Generator().manual_seed(9)))
    got = eng.restore(jpath, ex)
    assert int(got.step) == 1 and got.opt_state.step.tolist() == [1]
    for mine, want in ((got.params, jstate.params),
                       (got.opt_state.mu, jstate.opt_state.mu),
                       (got.opt_state.nu, jstate.opt_state.nu)):
        g = flatten(_state_ref_layout(eng, mine, cfg))
        w = flatten(jax.tree.map(np.asarray, want))
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_resumed_run_equals_the_uninterrupted_one(tmp_path):
    """Four steps straight against two, a checkpoint, a restore into a
    fresh state and two more from the loader's restored cursor."""
    _, cfg = _cfgs("mamba2-130m")
    _, tc = _tcs()
    source = tokens.TokenSource(cfg, 2, 24, seed=3)

    def run(state, eng, start, n):
        for b in ShardedLoader(source, eng, prefetch=2, start_step=start,
                               num_steps=n):
            state, _ = eng.step(state, b)
        return state

    def fresh(eng):
        return eng.init_state(tfm.init(cfg, torch.Generator().manual_seed(0)))
    eng = Engine.for_lm(cfg, tc, device="cpu")
    whole = run(fresh(eng), eng, 0, 4)
    half = run(fresh(eng), eng, 0, 2)
    path = str(tmp_path / "half.npz")
    eng.save(path, half)
    again = eng.restore(path, fresh(eng))
    again = run(again, eng, int(again.step), 2)
    assert int(again.step) == int(whole.step) == 4
    for a, b in ((whole.params, again.params),
                 (whole.opt_state.mu, again.opt_state.mu),
                 (whole.opt_state.nu, again.opt_state.nu)):
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-130m"])
def test_train_cli_smoke_and_serve_from_its_checkpoint(tmp_path, capsys,
                                                       monkeypatch, arch):
    ckpt = str(tmp_path / "run.npz")
    metrics = str(tmp_path / "m.jsonl")
    args = ttrain.parse_args(["--arch", arch, "--smoke", "--steps", "3",
                              "--batch-size", "4", "--seq-len", "24",
                              "--device", "cpu", "--eval-interval", "2",
                              "--accum-steps", "2", "--ckpt", ckpt,
                              "--metrics-out", metrics])
    res, eng, state = ttrain.train_lm(args)
    out = capsys.readouterr().out
    assert "step 2 eval loss" in out and "peak memory" in out
    assert res["steps"] == 3 and res["arch"] == f"{arch}-smoke"
    assert np.isfinite([res["first_loss"], res["last_loss"]]).all()
    assert {"wall_s", "step_p50_s", "prefetch", "device"} <= res.keys()
    # the serve CLI restores exactly the trained params
    restored = []
    real = InferenceEngine.restore_params

    def spy(self, path, example):
        restored.append(real(self, path, example))
        return restored[-1]
    monkeypatch.setattr(InferenceEngine, "restore_params", spy)
    served = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--ckpt", ckpt, "--requests", "2",
                          "--prompt-len", "6", "--gen", "3"])
    assert served["tokens"] == 6 and len(restored) == 1
    want = flatten(eng.params_tree(state))
    got = flatten(restored[0])
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k].float(), want[k].to(got[k].dtype).float()), k
    assert ttrain.main(["--arch", arch, "--smoke", "--steps", "1",
                        "--batch-size", "2", "--seq-len", "8", "--device",
                        "cpu", "--resume", ckpt])["steps"] == 4


@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-2b"])
def test_train_cli_refuses_front_end_archs(arch, capsys):
    """The front-end archs train through the CLI (``--seq-len`` counts
    internvl2's 8 smoke patches too); what the CLI refuses is a
    ``--seq-len`` that leaves no text after the patches."""
    res = ttrain.main(["--arch", arch, "--smoke", "--steps", "2",
                       "--batch-size", "2", "--seq-len", "12", "--device",
                       "cpu"])
    assert res["steps"] == 2 and res["arch"] == f"{arch}-smoke"
    assert np.isfinite([res["first_loss"], res["last_loss"]]).all()
    assert res["tokens_per_step"] == 24
    if arch == "internvl2-2b":
        with pytest.raises(SystemExit, match="leaves no text"):
            ttrain.main(["--arch", arch, "--smoke", "--seq-len", "8",
                         "--device", "cpu"])


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-130m"])
def test_from_train_state_serves_the_checkpoints_stream(tmp_path, arch):
    _, cfg = _cfgs(arch)
    _, tc = _tcs(learning_rate=3e-2)
    eng = Engine.for_lm(cfg, tc, device="cpu")
    state = eng.init_state(tfm.init(cfg, torch.Generator().manual_seed(0)))
    for step in range(3):
        state, _ = eng.step(state, eng.place_batch(_batch(cfg, seed=step)))
    path = str(tmp_path / "trained.npz")
    eng.save(path, state)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (20, 7)]

    def serve(engine, st, drafter=None):
        reqs = [Request(rid=i, prompt=p, max_new=5)
                for i, p in enumerate(prompts)]
        kw = dict(spec_k=2, drafter=drafter) if drafter else {}
        return Scheduler(engine, st, **kw).run(reqs)
    kw = dict(slots=2, max_len=32, page_size=4, dtype=torch.float32)
    live, live_st = InferenceEngine.from_train_state(eng, state, **kw)
    cold = InferenceEngine(cfg, device="cpu", **kw)
    cold_st = cold.init_state(cold.restore_params(
        path, tfm.init(cfg, torch.Generator().manual_seed(5))))
    want = serve(cold, cold_st)
    assert serve(live, live_st) == want
    drafter = ModelDrafter.from_train_state(eng, state, slots=2, max_len=34,
                                            page_size=4, dtype=torch.float32)
    live2, live2_st = InferenceEngine.from_train_state(eng, state, **kw)
    assert serve(live2, live2_st, drafter) == want
