"""Dom-ST trained in IP-D (the paper's Fig. 2a), as
``examples/train_flood_torch.py::train_stacked`` trains it: every
watershed's replica stacked on a leading axis and updated by one
``Engine.for_domst(..., stacked=True)`` step, fed by
``ShardedLoader(StackedSource(InputPipeline(...)))``; AdamW.

The benchmark makes the watersheds (``bench/data/hydro.py``) and the
weights (``bench/weights.py``) from the seed; the port windows, splits,
shuffles and batches the watersheds on its own pipeline."""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from bench import weights
from bench.data import hydro
from bench.drivers.common import EngineJob
from bench.harness import log
from bench.reference import domst


def model_config(cfg: Mapping):
    """The port's ``ModelConfig`` of the configuration file's ``model``."""
    from repro_torch.configs.base import (DomSTConfig, ModelConfig,
                                          PixConConfig)
    m = dict(cfg["model"])
    dc = dict(m.pop("domst"))
    dc["pixcon"] = PixConConfig(**dc["pixcon"])
    return ModelConfig(**m, domst=DomSTConfig(**dc))


class Reference:
    """The cell's inputs and weights made from the seed, and the plain
    reference's first steps on them."""

    def __init__(self, cfg: Mapping, traffic: Mapping, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.raw = [hydro.generate_watershed(
            i, num_days=traffic["days"], grid=tuple(traffic["grid"]),
            seed=seed) for i in range(traffic["watersheds"])]

    def params0(self) -> Dict[str, torch.Tensor]:
        return weights.make(weights.domst_leaves(
            self.cfg["model"]["domst"], self.traffic["watersheds"]),
            self.seed, self.device)

    def run(self, precision: str = "fp32",
            fault: Optional[str] = None) -> Dict:
        t = self.traffic
        host = hydro.stacked_batches(
            self.raw, seed=self.seed, steps=range(t["checked_steps"]),
            batch=t["batch"], test_frac=t["test_frac"])
        batches = [{k: torch.from_numpy(v).to(self.device)
                    for k, v in b.items()} for b in host]
        del host
        return domst.train(self.params0(), batches, self.cfg["model"]["domst"],
                           t["train"], precision=precision, fault=fault,
                           block=t["reference_block"])


class DomstJob(EngineJob):
    units = "windows"

    def __init__(self, ref: Reference):
        from repro_torch.configs.base import TrainConfig
        from repro_torch.data.pipeline import (InputPipeline, StackedSource,
                                               make_training_windows,
                                               train_split)
        from repro_torch.data.synthetic_hydro import WatershedData
        from repro_torch.train import Engine
        log("the watersheds are made")
        t, grid = ref.traffic, tuple(ref.traffic["grid"])
        windows = [make_training_windows(WatershedData(
            i, r["precip"], r["dist"], r["discharge"], grid))
            for i, r in enumerate(ref.raw)]
        ip = InputPipeline([train_split(w, t["test_frac"]) for w in windows],
                           batch_size=t["batch"], seed=ref.seed)
        del windows
        log("the port's windows are cut")
        engine = Engine.for_domst(model_config(ref.cfg),
                                  TrainConfig(**t["train"]), stacked=True,
                                  device=ref.device)
        state = engine.init_state(ref.params0())
        super().__init__(engine, state, StackedSource(ip), t,
                         t["watersheds"] * t["batch"])
        self.reference = ref.run
        self.drive(ref.params0)


def setup(cfg: Mapping, traffic: Mapping, seed: int, device) -> DomstJob:
    return DomstJob(Reference(cfg, traffic, seed, device))
