"""The port's SSD intra-chunk step (``repro_torch.kernels.ssd_chunk``) on
the CPU, where its wrapper computes the plain version, against the
reference's Pallas kernel in interpret mode (``ssd_chunk_fused``), its
oracle ``ssd_chunk_ref``, and steps 1-2 of the reference's
``ssm.ssd_chunked`` written out as einsums over the model's segment sums
(as ``tests/test_kernels_ssd.py::test_matches_model_chunk_math`` does).

Inputs are made with numpy: unit-normal C, B and xdt, and a decreasing
log-decay cumsum (dA < 0, as in the model), so the upper triangle's
segment sums are positive and would overflow if exponentiated there.
Chunk lengths 1, 5, 8 and 64 include the ragged ones ``ssd_chunked``
makes for a short prompt. Tolerances: float32 within 1e-4 relative and
absolute, the reference's own kernel-vs-oracle bound (sums over N and Q
of unit-normal products, taken in another order); bfloat16 inputs with
float32 math on both sides, y within 5e-2 (one bfloat16 ulp at |y| < 8)
and the float32 state within 1e-4.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ssd_chunk.ops import ssd_chunk_fused as j_fused  # noqa: E402
from repro.kernels.ssd_chunk.ref import ssd_chunk_ref as j_ref  # noqa: E402
from repro_torch.kernels.ssd_chunk.ops import ssd_chunk_fused  # noqa: E402

torch.set_num_threads(1)


def _mk(seed, B, nc, Q, H, N, P):
    rng = np.random.default_rng(seed)
    Cc = rng.normal(0, 1, (B, nc, Q, H, N)).astype(np.float32)
    Bc = rng.normal(0, 1, (B, nc, Q, H, N)).astype(np.float32)
    xdt = rng.normal(0, 1, (B, nc, Q, H, P)).astype(np.float32)
    da = -rng.uniform(0.01, 0.3, (B, nc, H, Q)).astype(np.float32)
    return Cc, Bc, xdt, da, np.cumsum(da, axis=-1).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("Q", [1, 5, 8, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_reference_kernel_and_oracle(Q, dtype):
    Cc, Bc, xdt, _, dA_cs = _mk(Q, 2, 3, Q, 4, 16, 8)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    before = ssd_chunk_fused.launches
    y, st = ssd_chunk_fused(torch.tensor(Cc).to(td), torch.tensor(Bc).to(td),
                            torch.tensor(xdt).to(td), torch.tensor(dA_cs))
    assert ssd_chunk_fused.launches == before          # CPU: plain version
    assert y.dtype == td and st.dtype == torch.float32
    assert tuple(y.shape) == xdt.shape and tuple(st.shape) == (2, 3, 4, 8, 16)
    assert torch.isfinite(y.float()).all() and torch.isfinite(st).all()
    # the reference kernel's layout: (B*nc, H, Q, .) via its wrapper, and
    # the oracle on the same (B, nc, H, Q, .) views
    args = [jnp.asarray(a, jd) for a in (Cc, Bc, xdt)] + [jnp.asarray(dA_cs)]
    yk, stk = j_fused(*args)
    to_h = lambda a: jnp.swapaxes(a, 2, 3)
    yr, str_ = j_ref(to_h(args[0]), to_h(args[1]), to_h(args[2]), args[3])
    ytol = 1e-4 if dtype == "float32" else 5e-2
    for want_y, want_st in ((yk, stk), (jnp.swapaxes(yr, 2, 3), str_)):
        _close(y, want_y, ytol)
        _close(st, want_st, 1e-4)


def test_matches_model_chunk_math():
    """The wrapper's outputs == the einsums of ``ssm.ssd_chunked``'s
    steps 1-2 in float32, over the model's ``_segsum`` of the raw decay."""
    from repro.models.ssm import _segsum
    Cc, Bc, xdt, da, dA_cs = _mk(7, 2, 3, 8, 4, 16, 8)
    y, st = ssd_chunk_fused(torch.tensor(Cc), torch.tensor(Bc),
                            torch.tensor(xdt), torch.tensor(dA_cs))
    Cj, Bj, xj = jnp.asarray(Cc), jnp.asarray(Bc), jnp.asarray(xdt)
    L = jnp.exp(_segsum(jnp.asarray(da)))
    scores = jnp.einsum("bcqhn,bckhn->bchqk", Cj, Bj)
    y_ref = jnp.einsum("bchqk,bckhp->bcqhp", scores * L, xj)
    cs = jnp.asarray(dA_cs)
    decay = jnp.exp(cs[..., -1:] - cs)
    st_ref = jnp.einsum("bcqhn,bchq,bcqhp->bchpn", Bj, decay, xj)
    _close(y, y_ref, 2e-4)
    _close(st, st_ref, 2e-4)


def test_steep_decay_stays_finite():
    """A chunk whose decay spans hundreds in log space: exp of the upper
    triangle's segment sums would be inf, and inf * 0 NaN; the plain
    version selects them away and stays finite."""
    Cc, Bc, xdt, _, _ = _mk(3, 1, 1, 64, 2, 16, 8)
    dA_cs = np.cumsum(np.full((1, 1, 2, 64), -20.0, np.float32), axis=-1)
    y, st = ssd_chunk_fused(torch.tensor(Cc), torch.tensor(Bc),
                            torch.tensor(xdt), torch.tensor(dA_cs))
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    yk, stk = j_fused(jnp.asarray(Cc), jnp.asarray(Bc), jnp.asarray(xdt),
                      jnp.asarray(dA_cs))
    _close(y, yk, 1e-4)
    _close(st, stk, 1e-4)
