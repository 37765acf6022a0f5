"""LM training, as ``examples/train_lm_torch.py::train_lm`` trains: one
``Engine.for_lm`` step a batch (block remat, the activations in the
traffic's dtype over float32 params and moments, the state donated),
fed by the port's ``ShardedLoader``; AdamW. The benchmark makes the
weights (``bench/weights.py``) and the token stream
(``bench/data/tokens.py``) from the seed."""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from bench import weights
from bench.data.tokens import TokenStream
from bench.drivers.common import EngineJob
from bench.reference import mamba2


def model_config(cfg: Mapping):
    """The port's ``ModelConfig`` of the configuration file's ``model``."""
    from repro_torch.configs.base import ModelConfig, SSMConfig
    m = dict(cfg["model"])
    m["layer_pattern"] = tuple(m["layer_pattern"])
    return ModelConfig(**{**m, "ssm": SSMConfig(**m["ssm"])})


class Reference:
    """The cell's token stream and weights made from the seed, and the
    plain reference's first steps on them."""

    def __init__(self, cfg: Mapping, traffic: Mapping, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.stream = TokenStream(cfg["model"]["vocab_size"],
                                  traffic["batch"], traffic["seq"], seed)

    def params0(self) -> Dict[str, torch.Tensor]:
        return weights.make(weights.mamba2_leaves(self.cfg["model"]),
                            self.seed, self.device)

    def run(self, precision: str = "fp32",
            fault: Optional[str] = None) -> Dict:
        t = self.traffic
        batches = [{k: torch.from_numpy(v).to(self.device)
                    for k, v in self.stream.host_batch(i).items()}
                   for i in range(t["checked_steps"])]
        m = {**self.cfg["model"], "norm_eps": self.cfg["norm_eps"]}
        return mamba2.train({k: v[None] for k, v in self.params0().items()},
                            batches, m, t["train"], precision=precision,
                            fault=fault, rows=t["reference_rows"])


class LMJob(EngineJob):
    units = "tokens"

    def __init__(self, ref: Reference):
        from repro_torch.configs.base import TrainConfig
        from repro_torch.train import Engine
        t = ref.traffic
        engine = Engine.for_lm(model_config(ref.cfg),
                               TrainConfig(**t["train"]),
                               accum_steps=t["accum_steps"],
                               device=ref.device,
                               dtype=getattr(torch, t["dtype"]))
        state = engine.init_state(weights.nest(ref.params0()))
        super().__init__(engine, state, ref.stream, t, t["batch"] * t["seq"])
        self.reference = ref.run
        self.drive(ref.params0)


def setup(cfg: Mapping, traffic: Mapping, seed: int, device) -> LMJob:
    return LMJob(Reference(cfg, traffic, seed, device))
