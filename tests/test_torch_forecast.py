"""Port's day-by-day Forecaster against the reference's Forecaster
(``explicit_shardings=False``: no mesh), on 2 watersheds x 150 days, from
the reference's stacked init — passed across in memory, and through an
npz the reference's ``checkpoint.save`` wrote and the port's
``restore_subtree`` read. qhat atol 1e-4; per-watershed nse/mse too."""
import json

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import domst as jdomst  # noqa: E402
from repro.data.pipeline import make_domst_windows as j_windows  # noqa: E402
from repro.data.pipeline import stacked_test_batch as j_stacked  # noqa: E402
from repro.serve.forecast import Forecaster as JForecaster  # noqa: E402
from repro_torch.checkpoint import restore_subtree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import domst  # noqa: E402
from repro_torch.kernels.lstm_cell.ops import lstm_cell_fused  # noqa: E402
from repro_torch.kernels.pixcon.ops import pixcon_gate  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serve.forecast import Forecaster  # noqa: E402

torch.set_num_threads(1)
W, DAYS, SEED = 2, 150, 3
ATOL = 1e-4


@pytest.fixture(scope="module")
def reference():
    """The reference's stacked params, held-out batch and forecast."""
    jcfg = j_get_config("domst")
    held = j_stacked(j_windows(W, DAYS))
    jparams = jdomst.init_stacked(jcfg, jax.random.key(SEED), W)
    res = JForecaster(jcfg, explicit_shardings=False)(jparams, held)
    return jparams, held, {k: np.asarray(v) for k, v in res.items()}


def _check(got, want):
    assert got["qhat"].shape == want["qhat"].shape == (W, 24)
    np.testing.assert_allclose(got["qhat"].cpu().numpy(), want["qhat"], atol=ATOL)
    np.testing.assert_allclose(got["nse"].cpu().numpy(), want["nse"], atol=ATOL)
    np.testing.assert_allclose(got["mse"].cpu().numpy(), want["mse"], atol=ATOL)


def test_forecast_matches_reference(reference):
    jparams, held, want = reference
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    before = (pixcon_gate.launches, lstm_cell_fused.launches)
    got = Forecaster(get_config("domst"), device="cpu")(params, held)
    _check(got, want)
    assert np.all(np.isfinite(got["nse"].numpy()))
    assert (pixcon_gate.launches, lstm_cell_fused.launches) == before == (0, 0)


def test_forecast_through_reference_checkpoint(reference, tmp_path):
    jparams, held, want = reference
    path = str(tmp_path / "state.npz")
    jckpt.save(path, {"params": jparams, "step": np.int32(7)})
    cfg = get_config("domst")
    example = domst.init(cfg, torch.Generator().manual_seed(0), W)
    params = restore_subtree(path, example, prefix="params")
    assert params.keys() == example.keys()
    _check(Forecaster(cfg, device="cpu")(params, held), want)

    # a bare params file restores with no prefix
    bare = str(tmp_path / "params.npz")
    jckpt.save(bare, jparams)
    for k, v in restore_subtree(bare, example, prefix="").items():
        np.testing.assert_array_equal(v.numpy(), params[k].numpy())
    with pytest.raises(KeyError, match="missing"):
        restore_subtree(path, example, prefix="opt")


def test_serve_cli_matches_reference(reference, tmp_path, capsys):
    jparams, _, want = reference
    path = str(tmp_path / "state.npz")
    jckpt.save(path, {"params": jparams})
    out = tserve.main(["--arch", "domst", "--watersheds", str(W), "--days",
                       str(DAYS), "--ckpt", path, "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    assert set(out) == {"arch", "watersheds", "horizon_days", "restored", "nse",
                        "mean_nse", "wall_s", "forecasts_per_s", "device"}
    assert (out["arch"], out["watersheds"], out["horizon_days"],
            out["restored"], out["device"]) == ("domst", W, 24, True, "cpu")
    np.testing.assert_allclose(out["nse"], want["nse"], atol=ATOL)
