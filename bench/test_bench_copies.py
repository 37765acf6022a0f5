"""The benchmark's frozen copies equal their originals at small sizes, and
its model FLOP counts match a count by hand."""
import importlib.util
import os

import numpy as np
import pytest

from bench import work
from bench.data import hydro, tokens
from bench.conftest import DOMST, ROOT


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_bench", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,args", [
    ("pixcon_work", (671, 64, 30, 64)), ("pixcon_work", (23, 1, 30, 64)),
    ("lstm_work", (671, 64, 128, 64)), ("lstm_work", (23, 32, 64, 64)),
    ("conv1d_work", (16, 4096, 1792, 4, 2, True)),
    ("conv1d_work", (2, 2560, 2560, 4, 4, False)),
    ("ssd_work", (16, 16, 256, 24, 128, 64, 2)),
    ("ssd_work", (8, 4, 256, 24, 128, 64, 4))])
def test_work_equals_chip_smoke(name, args):
    cs = _chip_smoke()
    assert getattr(work, name)(*args) == getattr(cs, name)(*args)
    for rate in (work.FP32_OPS_PER_S, work.BF16_OPS_PER_S):
        assert work.bound_ms(*getattr(work, name)(*args), rate) == \
            cs.bound_ms(*getattr(cs, name)(*args), rate)
    assert (work.HBM_BYTES_PER_S, work.FP32_OPS_PER_S, work.BF16_OPS_PER_S) \
        == (cs.HBM_BYTES_PER_S, cs.FP32_OPS_PER_S, cs.BF16_OPS_PER_S)


def test_domst_flops_by_hand():
    from bench.harness import find_cell
    dc = find_cell(DOMST)["config"]["model"]["domst"]
    pixcon = 64 * (4 * 32 + 32)
    conv1 = 4 * 30 * 3 * 16 * 32
    conv2 = 4 * 30 * 3 * 32 * 32
    lstm = 30 * (128 + 64) * 256 + 30 * (64 + 64) * 256
    head = (64 + 64) * 64 + 64
    assert work.domst_forward_flops(dc) == \
        2 * (pixcon + conv1 + conv2 + lstm + head) == 6_058_112
    assert work.train_flops(work.domst_forward_flops(dc)) == 18_174_336


def test_mamba2_flops_by_hand():
    from bench.harness import find_cell
    m = find_cell("mamba2-130m.train-4k")["config"]["model"]
    d, di, H, N, P, Q, V = 768, 1536, 24, 128, 64, 256, 50280
    layer = (d * (2 * di + 2 * N + H) + (di + 2 * N) * 4
             + H * ((Q + 1) / 2 * (N + P) + 2 * P * N + P * N / Q) + di * d)
    want = 2 * (24 * layer + d * V)
    assert work.mamba2_forward_flops_per_token(m, 4096) == pytest.approx(
        want, rel=1e-12)
    # about 306 MFLOP a token forward, of which the tied head is a quarter
    assert 3.0e8 < want < 3.1e8


def test_hydro_generator_equals_the_port():
    from repro_torch.data.synthetic_hydro import generate_watershed
    for wid, seed in ((0, 0), (3, 2 ** 31 + 17)):
        ours = hydro.generate_watershed(wid, num_days=150, seed=seed)
        port = generate_watershed(wid, num_days=150, seed=seed)
        for k in ("precip", "dist", "discharge"):
            assert np.array_equal(ours[k], getattr(port, k))


def test_stacked_batches_equal_the_ports_pipeline():
    from repro_torch.data.pipeline import (InputPipeline, StackedSource,
                                           make_training_windows,
                                           train_split)
    from repro_torch.data.synthetic_hydro import WatershedData
    seed, W, batch = 2 ** 31 + 5, 3, 16
    raw = [hydro.generate_watershed(i, num_days=150, seed=seed)
           for i in range(W)]
    windows = [make_training_windows(WatershedData(
        i, r["precip"], r["dist"], r["discharge"], (8, 8)))
        for i, r in enumerate(raw)]
    src = StackedSource(InputPipeline([train_split(w, 0.2) for w in windows],
                                      batch_size=batch, seed=seed))
    steps = [0, 1, 5, 11]               # across epochs
    ours = hydro.stacked_batches(raw, seed=seed, steps=steps, batch=batch,
                                 test_frac=0.2)
    for s, b in zip(steps, ours):
        port = src.host_batch(s)
        assert sorted(b) == sorted(port)
        for k in b:
            assert b[k].dtype == port[k].dtype
            assert np.array_equal(b[k], port[k]), (s, k)


def test_tokens_equal_the_port():
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenSource
    cfg = get_config("mamba2-130m")
    port = TokenSource(cfg, 2, 64, seed=2 ** 31 + 3)
    ours = tokens.TokenStream(cfg.vocab_size, 2, 64, 2 ** 31 + 3)
    for step in (0, 1, 7):
        a, b = ours.host_batch(step), port.host_batch(step)
        for k in ("tokens", "targets"):
            assert np.array_equal(a[k], b[k])
