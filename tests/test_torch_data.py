"""The port's copies of the reference's numpy data modules give the same
arrays, bit for bit."""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import numpy as np  # noqa: E402

from repro.data import pipeline as jpipe  # noqa: E402
from repro.data import synthetic_hydro as jhydro  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.data import synthetic_hydro as thydro  # noqa: E402


@pytest.mark.parametrize("wid,days,grid,seed", [(0, 200, (8, 8), 0),
                                               (5, 120, (6, 8), 3)])
def test_watershed_bit_equal(wid, days, grid, seed):
    j = jhydro.generate_watershed(wid, num_days=days, grid=grid, seed=seed)
    t = thydro.generate_watershed(wid, num_days=days, grid=grid, seed=seed)
    assert (t.watershed_id, t.grid_hw) == (j.watershed_id, j.grid_hw)
    for k in ("precip", "dist", "discharge"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
        assert getattr(t, k).dtype == getattr(j, k).dtype


def test_windows_split_and_stacked_batch_bit_equal():
    jw = jpipe.make_domst_windows(3, 160)
    tw = tpipe.make_domst_windows(3, 160)
    for a, b in zip(jw, tw):
        for k in ("precip", "target_day", "dist", "discharge"):
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
        assert (b.watershed_id, b.q_mean, b.q_std) == (a.watershed_id, a.q_mean, a.q_std)
        for ja, ta in zip(jpipe.train_test_split(a, 0.25),
                          tpipe.train_test_split(b, 0.25)):
            assert ja.keys() == ta.keys()
            for k in ja:
                np.testing.assert_array_equal(ta[k], ja[k])
    js, ts = jpipe.stacked_test_batch(jw), tpipe.stacked_test_batch(tw)
    assert js.keys() == ts.keys()
    for k in js:
        assert ts[k].dtype == js[k].dtype
        np.testing.assert_array_equal(ts[k], js[k])
    assert ts["precip"].shape == (3, 26, 30, 64)
