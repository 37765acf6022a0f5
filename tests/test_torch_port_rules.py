"""Rules of the port: it imports neither jax nor anything of ``repro``;
its entry points run on the card unless the caller asks for the CPU, and
raise without one; on the CPU no kernel is launched, and a CUDA tensor
reaching a kernel's wrapper launches the kernel or raises, never the
plain version."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

SRC = Path(__file__).resolve().parents[1] / "src"


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def test_port_imports_no_jax_and_nothing_of_repro():
    code = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
"""
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n = int(out.stdout.split()[0])
    assert n >= 63      # every module of the three slices was imported


def test_forecaster_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.serve.forecast import Forecaster
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Forecaster(get_config("domst"))
    assert Forecaster(get_config("domst"), device="cpu").device.type == "cpu"


def test_serve_cli_without_device_flag_raises_without_cuda():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "domst",
         "--watersheds", "1", "--days", "60"],
        env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert out.stdout == ""


def test_serve_cli_rejects_unported_arch():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma2-2b", "--device", "cpu"],
        env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "not ported" in out.stderr


def test_lm_serve_cli_without_device_flag_raises_without_cuda():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2-1.5b", "--smoke", "--requests", "1", "--gen", "2"],
        env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert out.stdout == ""


def test_lm_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.serve import InferenceEngine
    cfg = smoke_variant(get_config("qwen2-1.5b"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(cfg)
    assert InferenceEngine(cfg, device="cpu").device.type == "cpu"


def test_cpu_forward_launches_no_kernel():
    from repro_torch.configs import get_config
    from repro_torch.core import domst
    from repro_torch.kernels.lstm_cell.ops import lstm_cell_fused
    from repro_torch.kernels.pixcon.ops import pixcon_gate
    cfg = get_config("domst")
    g = torch.Generator().manual_seed(0)
    params = domst.init(cfg, g, 2)
    batch = {"precip": torch.rand(2, 3, 30, 64, generator=g),
             "dist": torch.rand(2, 3, 64, generator=g),
             "target_day": torch.rand(2, 3, 64, generator=g)}
    pixcon_gate.launches = lstm_cell_fused.launches = 0
    q = domst.forward(params, cfg, batch)
    assert q.shape == (2, 3) and torch.isfinite(q).all()
    plain = domst.forward(params, cfg, batch, domst.PLAIN)
    assert torch.equal(q, plain)
    assert pixcon_gate.launches == lstm_cell_fused.launches == 0


class _CudaLike(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what a wrapper sees when a
    CUDA tensor reaches it."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_like(*shape, dtype=torch.float32):
    return torch.randn(shape).to(dtype).as_subclass(_CudaLike)


@pytest.mark.parametrize("name", ["conv1d", "ssd_chunk", "local_attn"])
def test_new_wrappers_raise_on_a_cuda_tensor_without_a_card(monkeypatch,
                                                            name):
    """With no kernel to load (no card, no toolkit), each wrapper raises on
    a CUDA tensor instead of computing its plain version."""
    import importlib
    from repro_torch.kernels import build
    ops = importlib.import_module(f"repro_torch.kernels.{name}.ops")

    def no_kernel(lib):
        raise RuntimeError(f"no CUDA kernel library {lib}")
    monkeypatch.setattr(build, "load", no_kernel)
    ref_name = {"conv1d": "causal_conv1d_ref", "ssd_chunk": "ssd_chunk_ref",
                "local_attn": "local_attention_ref"}[name]

    def plain(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")
    monkeypatch.setattr(ops, ref_name, plain)
    if name == "conv1d":
        fn, args, kw = ops.causal_conv1d, (_cuda_like(2, 5, 8),
                                           _cuda_like(4, 8), _cuda_like(8)), \
            {"activation": "silu"}
    elif name == "ssd_chunk":
        fn, kw = ops.ssd_chunk_fused, {}
        args = (_cuda_like(1, 2, 4, 3, 16), _cuda_like(1, 2, 4, 3, 16),
                _cuda_like(1, 2, 4, 3, 8), _cuda_like(1, 2, 3, 4))
    else:
        fn, kw = ops.local_attention_fused, {"window": 4}
        args = (_cuda_like(1, 6, 4, 64), _cuda_like(1, 6, 2, 64),
                _cuda_like(1, 6, 2, 64))
    before = fn.launches
    with pytest.raises(RuntimeError, match="no CUDA kernel library"):
        fn(*args, **kw)
    assert fn.launches == before


def test_train_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.train import Engine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine.for_domst(get_config("domst"), TrainConfig())
    eng = Engine.for_domst(get_config("domst"), TrainConfig(), device="cpu")
    assert eng.device.type == "cpu"


def test_train_cli_without_device_flag_raises_without_cuda():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "domst",
         "--watersheds", "1", "--days", "60", "--epochs", "1"],
        env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert out.stdout == ""


def test_cpu_training_step_launches_no_kernel():
    """On the CPU a training step runs the plain versions under autograd:
    every leaf gets a gradient, and no kernel is launched."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core import domst
    from repro_torch.kernels.lstm_cell.ops import lstm_cell_fused
    from repro_torch.kernels.pixcon.ops import pixcon_gate
    from repro_torch.train import Engine, accumulate_grads
    cfg = get_config("domst")
    g = torch.Generator().manual_seed(0)
    eng = Engine.for_domst(cfg, TrainConfig(), stacked=True, device="cpu")
    state = eng.init_state(domst.init(cfg, g, 2))
    batch = {"precip": torch.rand(2, 4, 30, 64, generator=g),
             "dist": torch.rand(2, 4, 64, generator=g),
             "target_day": torch.rand(2, 4, 64, generator=g),
             "discharge": torch.rand(2, 4, generator=g)}
    before = (pixcon_gate.launches, lstm_cell_fused.launches)
    grads, _, _ = accumulate_grads(eng.loss_fn, state.params, batch, 1)
    assert all(bool(v.abs().max() > 0) for v in grads.values())
    new, m = eng.step(state, batch)
    assert int(new.step) == 1 and m["loss"].shape == (2,)
    assert (pixcon_gate.launches, lstm_cell_fused.launches) == before
