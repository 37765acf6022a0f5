"""The port's serve CLI (``repro_torch.launch.serve``) in LM mode on the
CPU at smoke size: the policy, sampling, drafter, queue, checkpoint and
telemetry flags, and the train CLI's ``--profile-dir``.

The launcher serves bf16, whose streams part between modes; the tests
build its engines (and so the model drafter's) in float32, where a
queue's stream does not depend on the mode or policy. One sampled queue
(a shared prefix, ragged tails, per-request seeds) is served whole, in
chunks, with ``spec_k=3`` (n-gram and model drafter), with preemption on
a tight pool and off prefix-cache hits, and a forced-spill queue off
host-tier hits: every run of a queue must print the same
``stream_digest``. A reference-layout npz written by ``repro.checkpoint.save`` is served by
``--ckpt`` (and ``--draft-ckpt``), and the digest must equal the
reference ``Scheduler``'s on those params and the launcher's queue.
"""
import json
from argparse import Namespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import torch_serve_parity as parity  # noqa: E402
from repro import checkpoint as jckpt  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.serve import stream_digest  # noqa: E402

torch.set_num_threads(1)
ARCH = "qwen2-1.5b"
BASE = ["--arch", ARCH, "--smoke", "--device", "cpu",
        "--requests", "4", "--batch-size", "2", "--prompt-len", "24",
        "--ragged", "--gen", "6", "--page-size", "8", "--shared-prefix", "16",
        "--temperature", "0.8", "--top-k", "50", "--top-p", "0.95",
        "--rep-penalty", "1.1", "--sample-seed", "7"]


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("REPRO_PAGED_ATTN", "1")


@pytest.fixture(autouse=True)
def _float32_engine(monkeypatch):
    real = tserve.InferenceEngine
    monkeypatch.setattr(tserve, "InferenceEngine", lambda *a, **kw: real(
        *a, **dict(kw, dtype=torch.float32)))


def _serve(extra, capsys):
    out = tserve.main(BASE + extra)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    return out


def test_sampled_digest_equal_across_modes_and_policies(tmp_path, capsys):
    whole = _serve([], capsys)
    assert whole["sampled_requests"] == 4 and whole["tokens"] == 24
    assert whole["device"] == "cpu"
    runs = {
        "chunked": ["--prefill-chunk", "5"],
        "spec": ["--spec-k", "3"],
        "model drafter": ["--spec-k", "3", "--drafter", "model",
                          "--draft-config", ARCH],
        "preempt": ["--preempt", "--num-pages", "7"],
        "prefix": ["--prefix-cache", "--prefill-chunk", "5"],
    }
    got = {name: _serve(extra, capsys) for name, extra in runs.items()}
    for name, out in got.items():
        assert out["stream_digest"] == whole["stream_digest"], name
    assert got["chunked"]["prefill_chunks"] > 0
    assert got["spec"]["spec_steps"] > 0
    assert got["model drafter"]["drafter"] == "model"
    assert got["model drafter"]["spec_proposed"] > 0
    assert got["preempt"]["preemptions"] >= 1
    assert got["preempt"]["restores"] == got["preempt"]["preemptions"]
    assert got["prefix"]["prefix_hits"] >= 1
    assert got["prefix"]["prefix_hit_tokens"] >= 16


def test_host_tier_digest_on_a_forced_spill_queue(tmp_path, capsys):
    """Two alternating prefix families on one slot and a 4-page pool:
    every admission reclaims the other family's cached pages. With
    ``--host-cache-mb`` they spill and come back as hits; the digest is
    the cold run's."""
    rng = np.random.default_rng(0)
    pres = [rng.integers(0, 512, 16).tolist() for _ in range(2)]
    queue = [{"prompt": pres[i % 2] + rng.integers(0, 512, 8).tolist()}
             for i in range(4)]
    qpath = tmp_path / "spill.json"
    qpath.write_text(json.dumps(queue))
    base = ["--queue", str(qpath), "--batch-size", "1", "--num-pages", "4"]
    cold = _serve(base, capsys)
    cached = _serve(base + ["--prefix-cache"], capsys)
    host = _serve(base + ["--prefix-cache", "--host-cache-mb", "8"], capsys)
    assert cold["stream_digest"] == cached["stream_digest"] \
        == host["stream_digest"]
    assert cached["prefix_hit_tokens"] == 0
    assert host["host_hits"] >= 2 and host["host_spilled_pages"] > 0
    assert host["prefill_skipped_pct"] > 0


def test_queue_file_and_telemetry_outputs(tmp_path, capsys):
    """``--queue`` with per-request overrides, and ``--trace-out``,
    ``--metrics-out``, ``--profile-dir`` write their files without moving
    the stream."""
    rng = np.random.default_rng(0)
    queue = [{"prompt": rng.integers(0, 512, 12).tolist(), "max_new": 3,
              "temperature": 0.0},
             {"prompt": rng.integers(0, 512, 9).tolist(), "seed": 99}]
    qpath = tmp_path / "queue.json"
    qpath.write_text(json.dumps(queue))
    plain = _serve(["--queue", str(qpath)], capsys)
    assert plain["requests"] == 2 and plain["tokens"] == 3 + 6
    assert plain["sampled_requests"] == 1
    trace, metrics, prof = (tmp_path / "trace.json", tmp_path / "m.jsonl",
                            tmp_path / "prof")
    out = _serve(["--queue", str(qpath), "--trace-out", str(trace),
                  "--metrics-out", str(metrics), "--profile-dir", str(prof)],
                 capsys)
    assert out["stream_digest"] == plain["stream_digest"]
    assert json.loads(trace.read_text())["traceEvents"]
    names = {json.loads(line)["name"] for line in
             metrics.read_text().splitlines()}
    assert "serve.tok_per_s" in names
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    spans = {e.get("name") for e in events}
    assert {"serve.insert", "serve.decode"} <= spans


def test_host_tier_needs_the_prefix_cache():
    with pytest.raises(SystemExit, match="prefix-cache"):
        tserve.main(BASE + ["--host-cache-mb", "8"])


def test_ckpt_in_the_reference_layout(tmp_path, capsys):
    """``--ckpt`` and ``--draft-ckpt`` restore the params subtree of a
    TrainState npz that ``repro.checkpoint.save`` wrote; the digest
    equals the reference Scheduler's on those params and the launcher's
    own queue (drawn as the reference's launcher draws it)."""
    jcfg, _ = parity.cfgs(ARCH)
    jparams = jtfm.init(jcfg, jax.random.key(5))
    path = tmp_path / "state.npz"
    jckpt.save(str(path), {"params": jparams, "step": jnp.zeros((), jnp.int32),
                           "opt_state": {"mu": jparams}})
    out = _serve(["--ckpt", str(path)], capsys)
    spec = _serve(["--ckpt", str(path), "--spec-k", "3", "--drafter",
                   "model", "--draft-ckpt", str(path)], capsys)
    ns = Namespace(queue="", seed=0, shared_prefix=16, prompt_len=24,
                   requests=4, ragged=True, gen=6, temperature=0.8, top_k=50,
                   top_p=0.95, rep_penalty=1.1, sample_seed=7)
    reqs = tserve.make_requests(parity.cfgs(ARCH)[1], ns)
    specs = [parity.spec(r.prompt, r.max_new,
                         **{k: getattr(r.sampling, k) for k in
                            ("temperature", "top_k", "top_p", "rep_penalty",
                             "seed")}) for r in reqs]
    tree = jax.tree.map(np.asarray, jparams)
    want, _ = parity.serve_ref_queue(
        ARCH, tree, specs, engine_kw=dict(slots=2, max_len=30, page_size=8))
    assert out["stream_digest"] == stream_digest(want)
    assert spec["stream_digest"] == out["stream_digest"]
    assert spec["spec_proposed"] > 0


def test_train_cli_profile_dir(tmp_path, capsys):
    ttrain.main(["--arch", "domst", "--watersheds", "2", "--days", "120",
                 "--epochs", "1", "--device", "cpu", "--profile-dir",
                 str(tmp_path / "prof")])
    capsys.readouterr()
    assert json.loads((tmp_path / "prof" / "trace.json").read_text())[
        "traceEvents"]
