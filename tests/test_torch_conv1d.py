"""The port's causal depthwise conv1d (``repro_torch.kernels.conv1d``) on
the CPU, where its wrapper computes the plain version, against the
reference's Pallas kernel in interpret mode (``causal_conv1d``, which
cuts S > 2,048 into pieces and carries the tail between them), its
oracle ``causal_conv1d_ref``, and the reference's model code that runs
the same conv inline with a carried tail (``ssm._causal_conv``,
``rglru._conv``).

Inputs are made with numpy; w and b are rounded to x's dtype on both
sides, as the model code casts them before the conv. Tolerances: float32
within 2e-6 (the reference's own kernel-vs-oracle bound: both sum the
same products in the same order); bfloat16 within 3e-2 on outputs of
magnitude < 4, one bfloat16 ulp, since a float32 sum that differs in its
last bit can round to the neighbouring bfloat16 value.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.conv1d.ops import causal_conv1d as j_conv  # noqa: E402
from repro.kernels.conv1d.ref import causal_conv1d_ref as j_ref  # noqa: E402
from repro_torch.kernels.conv1d.ops import causal_conv1d  # noqa: E402

torch.set_num_threads(1)
TOL = {"float32": 2e-6, "bfloat16": 3e-2}


def _mk(seed, B, S, C, K, dtype):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, S, C)).astype(np.float32)
    w = rng.normal(0, 0.5, (K, C)).astype(np.float32)
    b = rng.normal(0, 0.1, (C,)).astype(np.float32)
    tail = rng.normal(0, 1, (B, K - 1, C)).astype(np.float32)
    # round through the working dtype once, so both sides see equal values
    to = lambda a: np.asarray(jnp.asarray(a, dtype).astype(jnp.float32))
    return to(x), to(w), to(b), to(tail)


def _t(a, dtype):
    return torch.tensor(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("B,S,C,K", [
    (1, 1, 5, 4), (2, 7, 130, 4), (3, 17, 96, 2), (1, 64, 33, 3),
    (2, 2050, 70, 4),            # > 2,048: the reference's chunked path
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["none", "silu"])
def test_matches_reference_kernel_and_oracle(B, S, C, K, dtype, act):
    x, w, b, _ = _mk(B * S + C + K, B, S, C, K, getattr(jnp, dtype))
    jd = getattr(jnp, dtype)
    before = causal_conv1d.launches
    got, tail = causal_conv1d(_t(x, dtype), _t(w, dtype), _t(b, dtype),
                              activation=act)
    assert causal_conv1d.launches == before           # CPU: plain version
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (B, S, C)
    xj, wj, bj = jnp.asarray(x, jd), jnp.asarray(w, jd), jnp.asarray(b, jd)
    for want in (j_conv(xj, wj, bj, activation=act),
                 j_ref(xj, wj, bj, activation=act)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=TOL[dtype], rtol=0)
    # the new tail: the last K-1 rows of [zeros, x]
    full = np.concatenate([np.zeros((B, K - 1, C), np.float32), x], axis=1)
    np.testing.assert_array_equal(tail.float().numpy(), full[:, S:])


@pytest.mark.parametrize("S", [1, 2, 5])
def test_tail_form_matches_model_code(S):
    """With a carried tail, in float32: y and the new tail equal the
    reference's ``ssm._causal_conv`` (SiLU) and ``rglru._conv`` (none)."""
    from repro.configs import get_config, smoke_variant
    from repro.models import rglru, ssm
    for arch, act in (("mamba2-130m", "silu"), ("recurrentgemma-2b", "none")):
        cfg = smoke_variant(get_config(arch))
        K = (cfg.ssm or cfg.rglru).conv_width
        C = 24
        x, w, b, tail = _mk(S, 2, S, C, K, jnp.float32)
        params = {"conv_w": jnp.asarray(w), "conv_b": jnp.asarray(b)}
        fn = ssm._causal_conv if act == "silu" else rglru._conv
        want, want_tail = fn(params, cfg, jnp.asarray(x),
                             tail=jnp.asarray(tail))
        got, got_tail = causal_conv1d(torch.tensor(x), torch.tensor(w),
                                      torch.tensor(b), activation=act,
                                      tail=torch.tensor(tail))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                                   rtol=0)
        np.testing.assert_array_equal(got_tail.numpy(), np.asarray(want_tail))


def test_rejects_unknown_activation():
    x = torch.zeros(1, 3, 4)
    with pytest.raises(ValueError, match="activation"):
        causal_conv1d(x, torch.zeros(4, 4), torch.zeros(4), activation="gelu")
