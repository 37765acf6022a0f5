"""Port's Pix-Con gate: its plain version against the reference's oracle
and Pallas kernel (interpret mode), ``w`` against the reference's
``contribution_weights``. fp32, atol 1e-5: the reference sums in
another order. The kernel itself is held against its plain version on the
card in test_torch_kernels_cuda.py."""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import PixConConfig as JPixConConfig  # noqa: E402
from repro.core.pixcon import contribution_weights as j_contribution_weights  # noqa: E402
from repro.kernels.pixcon.kernel import pixcon_gate_pallas  # noqa: E402
from repro.kernels.pixcon.ref import pixcon_gate_ref as j_pixcon_gate_ref  # noqa: E402
from repro_torch.configs.base import PixConConfig  # noqa: E402
from repro_torch.core.pixcon import (  # noqa: E402
    contribution_weights, pixcon_block, pixel_features,
)
from repro_torch.kernels.pixcon import ops  # noqa: E402
from repro_torch.kernels.pixcon.ref import pixcon_gate_ref  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-5


def _mk(seed, R, B, T, P, F=4, H=32):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(x=rng.normal(0, 1, (R, B, T, P)).astype(f32),
                feats=rng.normal(0, 1, (R, B, P, F)).astype(f32),
                w1=rng.normal(0, 0.5, (R, F, H)).astype(f32),
                b1=rng.normal(0, 0.1, (R, H)).astype(f32),
                w2=rng.normal(0, 0.5, (R, H)).astype(f32),
                b2=rng.normal(0, 0.1, (R, 1)).astype(f32))


def _torch(a):
    return {k: torch.from_numpy(v) for k, v in a.items()}


def _jax_replica(a, r):
    return [jnp.asarray(a[k][r]) for k in ("x", "feats", "w1", "b1", "w2", "b2")]


@pytest.mark.parametrize("R,B,T,P", [(1, 1, 8, 16), (2, 3, 33, 64),
                                     (3, 5, 17, 48), (1, 4, 30, 64)])
@pytest.mark.parametrize("normalize,temperature", [(True, 1.0), (False, 1.0),
                                                   (True, 0.5), (False, 4.0)])
def test_plain_matches_reference_oracle_and_pallas(R, B, T, P, normalize,
                                                   temperature):
    a = _mk(R * 1000 + B * 100 + T + P, R, B, T, P)
    out, w = pixcon_gate_ref(**_torch(a), temperature=temperature,
                             normalize=normalize)
    assert out.shape == (R, B, T, P) and w.shape == (R, B, P)
    for r in range(R):
        args = _jax_replica(a, r)
        want = j_pixcon_gate_ref(*args, temperature=temperature,
                                 normalize=normalize)
        pallas = pixcon_gate_pallas(*args, temperature=temperature,
                                    normalize=normalize, interpret=True)
        np.testing.assert_allclose(out[r].numpy(), np.asarray(want), atol=ATOL)
        np.testing.assert_allclose(out[r].numpy(), np.asarray(pallas), atol=ATOL)


@pytest.mark.parametrize("normalize,temperature", [(True, 1.0), (False, 2.0)])
def test_weights_match_contribution_weights(normalize, temperature):
    rng = np.random.default_rng(7)
    B, T, P, H = 4, 30, 64, 32
    precip = rng.gamma(1.0, 1.0, (B, T, P)).astype(np.float32)
    dist = rng.uniform(0, 1, (B, P)).astype(np.float32)
    tday = rng.gamma(1.0, 1.0, (B, P)).astype(np.float32)
    params = {"w1": rng.normal(0, 0.5, (4, H)).astype(np.float32),
              "b1": rng.normal(0, 0.1, (H,)).astype(np.float32),
              "w2": rng.normal(0, 0.2, (H, 1)).astype(np.float32),
              "b2": rng.normal(0, 0.1, (1,)).astype(np.float32)}
    jpc = JPixConConfig(normalize=normalize, temperature=temperature)
    pc = PixConConfig(normalize=normalize, temperature=temperature)
    want = j_contribution_weights({k: jnp.asarray(v) for k, v in params.items()},
                                  jpc, jnp.asarray(precip), jnp.asarray(dist),
                                  jnp.asarray(tday))
    tp = {k: torch.from_numpy(v)[None] for k, v in params.items()}
    tp["w2"] = tp["w2"][..., 0]
    args = [torch.from_numpy(v)[None] for v in (precip, dist, tday)]
    w = contribution_weights(tp, pc, *args)
    np.testing.assert_allclose(w[0].numpy(), np.asarray(want), atol=ATOL)
    x, w_block = pixcon_block(tp, pc, *args)
    np.testing.assert_array_equal(w_block.numpy(), w.numpy())
    np.testing.assert_allclose(x[0].numpy(), precip * np.asarray(want)[:, None],
                               atol=ATOL)
    assert pixel_features(*args).shape == (1, B, P, 4)


def test_wrapper_uses_plain_version_on_cpu_without_launching():
    a = _torch(_mk(3, 2, 2, 30, 64))
    before = ops.pixcon_gate.launches
    got = ops.pixcon_gate(**a)
    want = pixcon_gate_ref(**a)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert ops.pixcon_gate.launches == before == 0


def test_wrapper_raises_on_device_without_kernel():
    a = {k: v.to("meta") for k, v in _torch(_mk(4, 1, 1, 4, 8)).items()}
    with pytest.raises(ValueError, match="no kernel"):
        ops.pixcon_gate(**a)
