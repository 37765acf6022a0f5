"""Port's fused LSTM step: its plain version against the reference's oracle,
Pallas kernel (interpret mode), jitted wrapper and model cell, through
``pack_weights``.
fp32, atol 1e-5: the gate dots are summed in another order. The kernel
itself is held against its plain version on the card in
test_torch_kernels_cuda.py."""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.temporal import lstm_cell as j_model_cell  # noqa: E402
from repro.kernels.lstm_cell.kernel import lstm_cell_pallas  # noqa: E402
from repro.kernels.lstm_cell.ops import lstm_cell_fused as j_lstm_cell_fused  # noqa: E402
from repro.kernels.lstm_cell.ops import pack_weights as j_pack_weights  # noqa: E402
from repro.kernels.lstm_cell.ref import lstm_cell_ref as j_lstm_cell_ref  # noqa: E402
from repro_torch.core.temporal import lstm_cell  # noqa: E402
from repro_torch.kernels.lstm_cell import ops  # noqa: E402
from repro_torch.kernels.lstm_cell.ops import pack_weights  # noqa: E402
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-5


def _mk(seed, R, B, D, H):
    """Packed (i|f|g|o) weights, as core/temporal.py stores them."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(x=rng.normal(0, 1, (R, B, D)).astype(f32),
                h=rng.normal(0, 1, (R, B, H)).astype(f32),
                c=rng.normal(0, 1, (R, B, H)).astype(f32),
                wx=rng.normal(0, 0.2, (R, D, 4 * H)).astype(f32),
                wh=rng.normal(0, 0.2, (R, H, 4 * H)).astype(f32),
                b=rng.normal(0, 0.1, (R, 4 * H)).astype(f32))


def _packed_torch(a):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    t["wx"], t["wh"], t["b"] = pack_weights(t["wx"], t["wh"], t["b"])
    return t


@pytest.mark.parametrize("R,B,D,H", [(1, 1, 8, 16), (2, 7, 48, 160),
                                     (23, 1, 128, 64), (3, 5, 64, 64),
                                     (1, 16, 32, 64)])
def test_plain_matches_reference_oracle_pallas_and_model_cell(R, B, D, H):
    a = _mk(R + B + D + H, R, B, D, H)
    t = _packed_torch(a)
    h1, c1 = lstm_cell_ref(**t)
    assert h1.shape == c1.shape == (R, B, H)
    for r in range(R):
        wx, wh, b = j_pack_weights(*(jnp.asarray(a[k][r]) for k in ("wx", "wh", "b")))
        np.testing.assert_array_equal(np.asarray(wx), t["wx"][r].numpy())
        np.testing.assert_array_equal(np.asarray(wh), t["wh"][r].numpy())
        np.testing.assert_array_equal(np.asarray(b), t["b"][r].numpy())
        xs = [jnp.asarray(a[k][r]) for k in ("x", "h", "c")]
        for want_h, want_c in (
                j_lstm_cell_ref(*xs, wx, wh, b),
                lstm_cell_pallas(*xs, wx, wh, b, interpret=True),
                j_lstm_cell_fused(*xs, wx, wh, b),
                j_model_cell({k: jnp.asarray(a[k][r]) for k in ("wx", "wh", "b")},
                             *xs)):
            np.testing.assert_allclose(h1[r].numpy(), np.asarray(want_h), atol=ATOL)
            np.testing.assert_allclose(c1[r].numpy(), np.asarray(want_c), atol=ATOL)


def test_model_cell_and_wrapper_use_plain_version_on_cpu_without_launching():
    t = _packed_torch(_mk(1, 2, 3, 40, 64))
    before = ops.lstm_cell_fused.launches
    got = lstm_cell({k: t[k] for k in ("wx", "wh", "b")}, t["x"], t["h"], t["c"])
    want = lstm_cell_ref(**t)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert ops.lstm_cell_fused.launches == before == 0


def test_wrapper_raises_on_device_without_kernel():
    t = {k: v.to("meta") for k, v in _packed_torch(_mk(2, 1, 1, 8, 16)).items()}
    with pytest.raises(ValueError, match="no kernel"):
        ops.lstm_cell_fused(**t)
