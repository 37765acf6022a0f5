"""The port's served mixture-of-experts decoders — qwen3-moe-30b-a3b (QK
norm, 4 experts top 2 at smoke size) and deepseek-moe-16b (a dense first
layer, one shared expert) — against the reference's paged engine and
scheduler, on the CPU at smoke size (see ``torch_serve_parity.py`` for the
queue and the params), at the default capacity factor of 1.25.

The capacity follows each call's shape (a whole prompt, a chunk of 3, a
verify step of 4 tokens a row, one decode token a row), so tokens are
dropped in some calls and the three modes may part from each other; each
mode of the port is held to the SAME mode of the reference: greedy
streams and the scheduler's counts equal in float32, on the init and the
damped params. On the damped params qwen3-moe's n-gram drafter has some
drafts accepted and some rejected; deepseek-moe's proposes none (its
embeddings are untied, so the damped model does not repeat itself), as
the reference's. In bfloat16 the first decode step's logits are held
within 3e-2 of their largest magnitude (``REL_BF16``). The serve CLI runs
both configs with ``--smoke --device cpu`` in its three modes.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_serve_parity as parity  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

torch.set_num_threads(1)
ARCHS = ["qwen3-moe-30b-a3b", "deepseek-moe-16b"]


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("REPRO_PAGED_ATTN", "1")


@pytest.mark.parametrize("mode", parity.MODES, ids=parity.MODE_IDS)
@pytest.mark.parametrize("kind", ["init", "damped"])
@pytest.mark.parametrize("arch", ARCHS)
def test_served_streams_equal_reference(monkeypatch, arch, kind, mode):
    dropped = []
    real = moe.dispatch_indices

    def counted(topk_idx, m, cap):
        out = real(topk_idx, m, cap)
        dropped.append(int((~out[2]).sum()))
        return out
    monkeypatch.setattr(moe, "dispatch_indices", counted)
    tree = parity.params(arch, kind)
    gen = parity.GEN if kind == "init" else 2 * parity.GEN
    prompt_list = parity.prompts(parity.cfgs(arch)[1].vocab_size)
    before = [f.launches for f in tfm.KERNELS]
    want, want_stats = parity.serve_ref(arch, tree, prompt_list, gen=gen,
                                        **mode)
    got, got_stats = parity.serve_port(arch, tree, prompt_list, gen=gen,
                                       **mode)
    assert got == want
    for key in parity.STAT_KEYS:
        assert got_stats[key] == want_stats[key], key
    assert [f.launches for f in tfm.KERNELS] == before   # CPU: plain versions
    if mode.get("prefill_chunk"):
        assert got_stats["prefill_chunks"] > 0
        assert sum(dropped) > 0          # 3-token chunks: capacity 2
    if mode.get("spec_k") and kind == "damped":
        if arch == "qwen3-moe-30b-a3b":
            assert 0 < got_stats["spec_accepted"] < got_stats["spec_proposed"]
        else:
            assert got_stats["spec_proposed"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_first_decode_step_logits_bf16(arch):
    got, want = parity.first_decode_logits_bf16(arch, parity.params(arch))
    err = np.abs(got - want).max()
    assert err <= parity.REL_BF16 * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("mode", [[], ["--prefill-chunk", "5"],
                                  ["--spec-k", "3"]],
                         ids=["whole", "chunked", "spec3"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_smoke_on_cpu(capsys, arch, mode):
    out = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "12", "--ragged",
                       "--gen", "4"] + mode)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    assert out["arch"] == arch + "-smoke"
    assert out["requests"] == 3 and out["tokens"] == 12
    if mode:
        key = "prefill_chunks" if mode[0] == "--prefill-chunk" else "spec_steps"
        assert out[key] > 0
