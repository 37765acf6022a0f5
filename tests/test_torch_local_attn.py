"""The port's sliding-window attention (``repro_torch.kernels.local_attn``)
on the CPU, where its wrapper computes the plain version, against the
reference's Pallas kernel in interpret mode (``local_attention_fused``,
which pads S to a block multiple and masks the padded keys), its oracle
``local_attention_ref``, and the reference's model code that runs the
same attention inline in plain JAX (``models.attention.local_attention``).

Cases: S not a multiple of any block, window < S and window >= S, causal
and non-causal, GQA (4 query heads on 2 KV heads), MQA (on 1) and no
grouping. The model code is compared in the causal cases only: for
``causal=False`` it reads keys no further than the end of each query's
block and so drops the forward half of the band (the fault the Pallas
kernel's own comment records fixing in the kernel; ROADMAP Queue C). The
softcap (gemma2's 50), which the Pallas kernel lacks, is held against the
model code alone, causal, with scores past the cap. Tolerances: float32
within 3e-5, the reference's own
kernel-vs-model bound (softmax sums taken in another order, and the model
code multiplies by 1/sqrt(D) where the kernel divides); bfloat16 within
3e-2 (one bfloat16 ulp at |out| < 4) against the kernel and its oracle,
which compute in float32 as the port does, and within 6e-2 against the
model code, which rounds scores and softmax weights through bfloat16.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.local_attn.ops import local_attention_fused as j_fused  # noqa: E402
from repro.kernels.local_attn.ref import local_attention_ref as j_ref  # noqa: E402
from repro.models.attention import local_attention as j_model  # noqa: E402
from repro_torch.kernels.local_attn.ops import local_attention_fused  # noqa: E402
from repro_torch.kernels.local_attn.ref import local_attention_ref  # noqa: E402

torch.set_num_threads(1)
TOL = {"float32": 3e-5, "bfloat16": 3e-2}
TOL_MODEL = {"float32": 3e-5, "bfloat16": 6e-2}


def _mk(seed, B, S, Hq, Hkv, D, dtype):
    rng = np.random.default_rng(seed)
    to = lambda a: np.asarray(jnp.asarray(a, dtype).astype(jnp.float32))
    return (to(rng.normal(0, 1, (B, S, Hq, D))),
            to(rng.normal(0, 1, (B, S, Hkv, D))),
            to(rng.normal(0, 1, (B, S, Hkv, D))))


@pytest.mark.parametrize("B,S,Hq,Hkv,D,window", [
    (2, 37, 4, 2, 16, 8),        # GQA, window < S, S unaligned
    (1, 45, 4, 1, 32, 16),       # MQA
    (2, 20, 2, 2, 16, 64),       # window >= S: plain causal attention
    (1, 130, 4, 1, 16, 33),      # several blocks, odd window
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_reference(B, S, Hq, Hkv, D, window, causal, dtype):
    q, k, v = _mk(S + window, B, S, Hq, Hkv, D, getattr(jnp, dtype))
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    before = local_attention_fused.launches
    got = local_attention_fused(torch.tensor(q).to(td), torch.tensor(k).to(td),
                                torch.tensor(v).to(td), window=window,
                                causal=causal)
    assert local_attention_fused.launches == before    # CPU: plain version
    assert got.dtype == td and tuple(got.shape) == q.shape
    got = got.float().numpy()
    qj, kj, vj = (jnp.asarray(a, jd) for a in (q, k, v))
    wants = [(j_fused(qj, kj, vj, window=window, causal=causal, block_q=16),
              TOL[dtype]),
             (j_ref(qj, kj, vj, window=window, causal=causal), TOL[dtype])]
    if causal:
        wants.append((j_model(qj, kj, vj, window=window, causal=True,
                              block_q=16), TOL_MODEL[dtype]))
    for want, tol in wants:
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=0)


def test_rejects_empty_window():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="window"):
        local_attention_fused(q, q, q, window=0)


@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window", [
    (2, 37, 4, 2, 16, 8),        # GQA (G=2), window < S, S unaligned
    (1, 70, 4, 2, 32, 24),       # several blocks past the window
])
def test_softcap_matches_reference_model_code(B, S, Hq, Hkv, D, window,
                                              softcap):
    """The softcap as the reference's model code applies it
    (``local_attention(softcap_val=)``: float32, after the scale, before
    the mask), causal, fp32, with q scaled by 20 so that scores reach
    ~60 and the cap of 50 binds."""
    q, k, v = _mk(S + window + D, B, S, Hq, Hkv, D, jnp.float32)
    q = q * np.float32(20)
    got = local_attention_fused(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), window=window,
                                softcap=softcap).numpy()
    plain = local_attention_ref(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), window=window,
                                softcap=softcap).numpy()
    np.testing.assert_array_equal(got, plain)      # CPU: the plain version
    want = j_model(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   window=window, causal=True, softcap_val=softcap,
                   block_q=16)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL["float32"],
                               rtol=0)
    uncapped = local_attention_ref(torch.tensor(q), torch.tensor(k),
                                   torch.tensor(v), window=window).numpy()
    if softcap:                                    # the cap binds
        assert np.abs(got - uncapped).max() > 1e-2
    else:
        np.testing.assert_array_equal(got, uncapped)
