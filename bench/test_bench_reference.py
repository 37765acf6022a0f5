"""The plain references against the port's CPU path at tiny sizes (a run
of the harness on the CPU), the SSD scan against its recurrence, and the
controls: the reference in the next lower precision, and each fault a
training step can have, fail the cell's comparison."""
import numpy as np
import pytest
import torch

from bench import control, harness
from bench.conftest import DOMST, MAMBA2
from bench.reference import mamba2


def _run(cell, seed=2 ** 31 + 11):
    return harness.run(cell, seed, 0.5, False, torch.device("cpu"), 0.0)


@pytest.mark.parametrize("name", [DOMST, MAMBA2])
def test_reference_matches_the_port_on_the_cpu(tiny_cell, name):
    out = _run(tiny_cell(name))
    res = out["result"]
    assert res["correct"] is True
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(out["limits"])
    for k, v in out["numbers"].items():
        assert v <= 1e-5, (k, v)


@pytest.mark.parametrize("name", [DOMST, MAMBA2])
def test_controls_and_faults_fail_the_comparison(tiny_cell, name):
    cell = tiny_cell(name)
    limits = cell["traffic"]["limits"]
    rows = control.readings(cell, 2 ** 31 + 23, torch.device("cpu"))
    assert [r["variant"] for r in rows] == [
        "reference", "control", "half_batch", "altered_answer"]
    for r in rows[1:]:
        assert any(r[k] > limits[k] for k in limits), r


def test_ssd_scan_equals_its_recurrence():
    g = torch.Generator().manual_seed(0)
    b, S, H, P, G, N = 2, 37, 4, 3, 2, 5
    X = torch.randn(b, S, H, P, generator=g, dtype=torch.float64)
    dt = torch.rand(b, S, H, generator=g, dtype=torch.float64)
    A = -torch.rand(H, generator=g, dtype=torch.float64) - 0.1
    Bm = torch.randn(b, S, G, N, generator=g, dtype=torch.float64)
    Cm = torch.randn(b, S, G, N, generator=g, dtype=torch.float64)
    y = mamba2.ssd(X, dt, A, Bm, Cm, chunk=8)
    Bh, Ch = (t.repeat_interleave(H // G, dim=2) for t in (Bm, Cm))
    h = torch.zeros(b, H, P, N, dtype=torch.float64)
    want = []
    for t in range(S):
        h = h * torch.exp(dt[:, t] * A)[..., None, None] \
            + (X[:, t] * dt[:, t, :, None])[..., None] * Bh[:, t, :, None]
        want.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    assert torch.allclose(y, torch.stack(want, 1), atol=1e-10)


def test_lower_precisions_round_as_stated():
    from bench.reference.precision import round_fp8, round_tf32
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.14159])
    r = round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0          # a tie rounds to even
    assert r[2] == 1.0 + 2 ** -9                # up
    mant = r.view(torch.int32) & 0x1FFF
    assert bool((mant == 0).all())
    y = torch.linspace(-3, 3, 1001)
    q = round_fp8(y)
    assert np.unique(q.numpy()).size < 256 and float((q - y).abs().max()) \
        <= 3 * 2 ** -4
