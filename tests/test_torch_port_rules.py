"""Rules of the port: it imports neither jax nor anything of ``repro``;
its entry points run on the card unless the caller asks for the CPU, and
raise without one; on the CPU no kernel is launched."""
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
    assert n >= 50      # every module of both slices was imported


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
