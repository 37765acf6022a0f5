"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests must see the
real single CPU device (the 512-device override is dryrun.py-only)."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax
import numpy as np
import pytest

# hypothesis is a dev-only dependency (requirements-dev.txt): register the
# property-test profiles here, once, so every module shares them.  "ci"
# derandomizes (examples derived from the test function itself, no RNG, no
# example database) so tier-1 is bit-for-bit reproducible on CI; locally the
# default "dev" profile keeps randomized exploration.  Select explicitly
# with HYPOTHESIS_PROFILE=ci|dev.
try:
    from hypothesis import settings as _hyp_settings

    _hyp_settings.register_profile("dev", max_examples=25, deadline=None)
    _hyp_settings.register_profile("ci", max_examples=25, deadline=None,
                                   derandomize=True, print_blob=True)
    _hyp_settings.load_profile(os.environ.get(
        "HYPOTHESIS_PROFILE", "ci" if os.environ.get("CI") else "dev"))
except ImportError:                      # pragma: no cover - optional dep
    pass


def pytest_configure(config):
    # the two slowest 8-device mesh-parity tests carry this marker so a
    # local quick loop can skip them (`pytest -m "not slow"`); tier-1 CI
    # runs everything — the marker documents cost, it never gates coverage
    config.addinivalue_line(
        "markers",
        "slow: slowest mesh-parity tests; deselect locally with "
        '-m "not slow"')
    # port tests of a CUDA kernel, which has no CPU mode: they skip without
    # a card and are run on the GPU with `pytest -m cuda tests/test_torch_*.py`
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips where there is none")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def key():
    return jax.random.key(0)
