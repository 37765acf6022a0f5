"""The dry run's training steps at the production meshes, at 2 layers.

Each case runs ``python -m repro_torch.launch.dryrun --arch A --shape
train_4k --layers 2 [--multipod]`` in a subprocess on a fake world of
256 or 512 ranks: the production mesh, the global batch of 256 x 4,096
and every width of the config, the depth cut to 2 layers. The three
cases are the three ways the training step used to fail inside DTensor:

* olmo-1b at (16, 16): a causal RoPE config with as many KV heads as
  query heads, one head a rank; the attention's key gradient came back
  from its local block as a transposed view, and the projection's
  backward could not fold it into (tokens, 128);
* mamba2-130m and internvl2-2b at (2, 16, 16): DTensor split a
  projection's output gradient over the sequence (mamba2's input
  projections, behind the gate's product and the x/B/C concatenation;
  internvl2's image before its text), and the weight gradient then
  contracted a token axis split over "pod" and "data" and strided over
  "model", which DTensor's planner cannot place under fake tensors.

The record must name the training step on the whole world, with a
positive FLOP count, the optimizer moments and collectives.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
LIMIT_S = 240
CASES = [("olmo-1b", False), ("mamba2-130m", True), ("internvl2-2b", True)]


@pytest.mark.parametrize("arch,multipod", CASES,
                         ids=[f"{a}-{'multipod' if m else 'pod'}"
                              for a, m in CASES])
def test_training_step_at_production_mesh(arch, multipod, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", "train_4k", "--layers", "2", "--out", str(tmp_path)]
    if multipod:
        cmd.append("--multipod")
    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=LIMIT_S)
    assert r.returncode == 0, r.stderr[-3000:]
    mesh = "multipod" if multipod else "pod"
    rec = json.loads((tmp_path / f"{arch}__train_4k__{mesh}.json")
                     .read_text())
    assert rec["step_kind"] == "train" and rec["num_layers"] == 2
    assert rec["ranks"] == (512 if multipod else 256)
    assert rec["mesh_shape"] == ([2, 16, 16] if multipod else [16, 16])
    assert rec["rank0_flops"] > 0
    by = rec["rank0_bytes"]
    assert by["params"] > 0 and by["opt"] > 0 and by["batch"] > 0
    # the gradients are reduced over the batch axes
    assert rec["collectives"]["total_count"] > 0
