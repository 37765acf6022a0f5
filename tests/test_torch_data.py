"""The port's copies of the reference's numpy data modules give the same
arrays, bit for bit, and the port's loader yields its source's batches in
order with or without prefetching."""
import pytest

torch = pytest.importorskip("torch")
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


def _pipelines(W=3, days=160, batch_size=16, seed=2):
    jw = [jpipe.train_split(w) for w in jpipe.make_domst_windows(W, days)]
    tw = [tpipe.train_split(w) for w in tpipe.make_domst_windows(W, days)]
    return (jpipe.InputPipeline(jw, batch_size=batch_size, seed=seed),
            tpipe.InputPipeline(tw, batch_size=batch_size, seed=seed))


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("test_frac", [0.2, 0.25])
def test_train_split_bit_equal(test_frac):
    for a, b in zip(jpipe.make_domst_windows(2, 130),
                    tpipe.make_domst_windows(2, 130)):
        ja, ta = jpipe.train_split(a, test_frac), tpipe.train_split(b, test_frac)
        for k in ("precip", "target_day", "dist", "discharge"):
            np.testing.assert_array_equal(getattr(ta, k), getattr(ja, k))
        assert (ta.watershed_id, ta.q_mean, ta.q_std) == \
            (ja.watershed_id, ja.q_mean, ja.q_std)


def test_input_pipeline_bit_equal():
    jip, tip = _pipelines()
    assert tip.steps_per_epoch() == jip.steps_per_epoch() == 6
    for epoch in (0, 1):
        for jb, tb in zip(jip.stacked_batches(epoch), tip.stacked_batches(epoch)):
            _same(jb, tb)
        for jw, tw in zip(jip.windows, tip.windows):
            np.testing.assert_array_equal(tip.epoch_order(tw, epoch),
                                          jip.epoch_order(jw, epoch))
            jbs, tbs = list(jip.batches(jw, epoch)), list(tip.batches(tw, epoch))
            assert len(jbs) == len(tbs) == 6
            for jb, tb in zip(jbs, tbs):
                _same(jb, tb)
    js, ts = jip.shard(1, 2), tip.shard(1, 2)
    assert [w.watershed_id for w in ts.windows] == \
        [w.watershed_id for w in js.windows] == [1]
    assert ts.num_batches(5) == js.num_batches(5) == 1


def test_sources_bit_equal_across_an_epoch_boundary():
    jip, tip = _pipelines()
    jst, tst = jpipe.StackedSource(jip), tpipe.StackedSource(tip)
    assert tst.steps_per_epoch == jst.steps_per_epoch == 6
    for step in (0, 4, 5, 6, 7, 12, 5):          # 5 and 6 straddle epoch 0/1
        _same(jst.host_batch(step), tst.host_batch(step))
    jws = jpipe.WatershedSource(jip, jip.windows[2])
    tws = tpipe.WatershedSource(tip, tip.windows[2])
    for step in (5, 6, 11, 13, 0):
        _same(jws.host_batch(step), tws.host_batch(step))
    # the step-indexed stream is the iterator's, epoch after epoch
    it = [b for e in (0, 1) for b in tip.stacked_batches(e)]
    for step, b in enumerate(it):
        _same(b, tst.host_batch(step))


class _Placer:
    """What the loader needs of an engine: a device and ``place_batch``."""
    device = torch.device("cpu")

    def place_batch(self, batch):
        return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("start,num", [(0, 8), (5, 4)])
def test_loader_prefetch_yields_the_synchronous_batches(start, num):
    from repro_torch.data.loader import DataSource, ShardedLoader
    _, tip = _pipelines()
    source = tpipe.StackedSource(tip)
    assert isinstance(source, DataSource)
    runs = {}
    for prefetch in (0, 2):
        loader = ShardedLoader(source, _Placer(), prefetch=prefetch,
                               start_step=start, num_steps=num)
        got, cursors = [], []
        for b in loader:
            got.append(b)
            cursors.append(loader.cursor)
        assert cursors == list(range(start + 1, start + num + 1))
        runs[prefetch] = got
    assert len(runs[0]) == len(runs[2]) == num
    for a, b in zip(runs[0], runs[2]):
        for k in a:
            assert torch.equal(a[k], b[k])
    for i, b in enumerate(runs[2]):
        _same({k: v.numpy() for k, v in b.items()},
              source.host_batch(start + i))


def test_loader_raises_a_worker_error_and_stops_when_abandoned():
    from repro_torch.data.loader import ShardedLoader

    class Broken:
        steps_per_epoch = None

        def host_batch(self, step):
            if step == 2:
                raise RuntimeError("bad window")
            return {"x": np.full(3, step, np.float32)}

    loader = ShardedLoader(Broken(), _Placer(), prefetch=2)
    seen = []
    with pytest.raises(RuntimeError, match="bad window"):
        for b in loader:
            seen.append(int(b["x"][0]))
    assert seen == [0, 1] and loader.cursor == 2
    endless = ShardedLoader(Broken(), _Placer(), prefetch=2, start_step=3)
    it = iter(endless)
    assert int(next(it)["x"][0]) == 3
    it.close()                       # the worker stops; nothing hangs
    assert endless.cursor == 4
