"""Shared by the benchmark's tests: the card's marker (registered here too,
since this directory is collected on its own) and the cells cut to a size
the CPU runs in seconds, widths and all else as the cell has them."""
import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

DOMST = "domst.ipd-paper23"
MAMBA2 = "mamba2-130m.train-4k"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")


def tiny(name: str) -> dict:
    """The cell ``name`` with its traffic, and an LM's depth and widths, cut
    to a CPU test's size; an LM in float32 there, where its gaps to the
    reference are round-off, so that a fault is what makes a run fail."""
    from bench import harness
    cell = copy.deepcopy(harness.find_cell(name))
    t = cell["traffic"]
    if name == DOMST:
        t.update(watersheds=3, days=120, batch=8, reference_block=2)
    else:
        m = cell["config"]["model"]
        m.update(num_layers=2, d_model=64, vocab_size=300)
        m["ssm"].update(state_dim=16, head_dim=16, chunk_size=16)
        t.update(batch=4, seq=40, reference_rows=2, dtype="float32")
    return cell


@pytest.fixture
def tiny_cell():
    return tiny


@pytest.fixture(autouse=True)
def _few_threads():
    """Two intra-op threads a test: the runs here are tiny, and the test
    workers share the host's cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
