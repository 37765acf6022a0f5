"""The port's served slice for recurrentgemma-2b — ``InferenceEngine`` and
``Scheduler`` over slot-major recurrent state and the paged pool —
against the reference's, on the CPU at smoke size (see
``torch_serve_parity.py`` for the queue and the params).

Greedy streams and the scheduler's chunk and speculation counts must be
EQUAL in float32 under whole prefill, chunked prefill (3 tokens a chunk)
and ``spec_k=3`` with the n-gram drafter. In bfloat16 the first decode
step's logits are held within 3e-2 of their largest magnitude, the
tolerance of ``test_torch_serve_lm.py`` (a few bfloat16 ulps: the two
frameworks round at different places, and the port's kernels sum in
float32 where the reference's model code sums in bfloat16).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_serve_parity as parity  # noqa: E402

torch.set_num_threads(1)
ARCH = "recurrentgemma-2b"


@pytest.mark.parametrize("mode", parity.MODES, ids=parity.MODE_IDS)
@pytest.mark.parametrize("kind", ["init", "damped"])
def test_served_streams_equal_reference(monkeypatch, kind, mode):
    monkeypatch.setenv("REPRO_PAGED_ATTN", "1")
    parity.check_served(ARCH, kind, mode)


def test_first_decode_step_logits_bf16(monkeypatch):
    monkeypatch.setenv("REPRO_PAGED_ATTN", "1")
    got, want = parity.first_decode_logits_bf16(ARCH, parity.params(ARCH))
    err = np.abs(got - want).max()
    assert err <= parity.REL_BF16 * np.abs(want).max(), (err, np.abs(want).max())
